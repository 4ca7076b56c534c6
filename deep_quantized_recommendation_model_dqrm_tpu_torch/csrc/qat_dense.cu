// The dense leaves of a train step, each direction one multi-tensor pass:
// HAWQ's per-tensor weight fake-quant (two kernels: extrema, then scales and
// fake-quant), its straight-through backward (one kernel) and the optimizer
// update in place (one kernel, SGD or classic Adagrad).
//
// These replace no TPU kernel: the JAX package leaves the same per-leaf chain
// (models/dlrm.py `_quant_linear_weights`, ops/quant.py
// `symmetric_quantization_params` and `fake_quant`, optim/sgd.py) to XLA,
// which fuses it inside one jitted step. Eager PyTorch runs it as some 23
// launches a layer (min, max, the scale's abs/maximum/clamp/divide, the
// divide/round/clamp/multiply of the weight and of the bias, the backward's
// multiply and divide, the update's product and difference), each a few
// microseconds over at most a few hundred KB at the paper's widths.
//
// Contracts, in float32, for leaves l (a weight that owns a scale: an MLP
// weight, DCNv2's cross V and W; or a bias that takes its weight's scale):
//   extrema + fake-quant:
//     s_o   = clamp_min(maximum(|min w_o|, |max w_o|), 1e-8) / n_o    (n_o = 2^(b_o - 1) - 1)
//     out_l = clamp(rint(x_l / s_o), -n_l - 1, n_l) * s_o              (o: l's owner, n_l at l's bits)
//     scales[o] = s_o
//   backward: out_l = (g_l * s_o) / s_o
//   update, in place: SGD      p = p - lr g
//                     Adagrad  a = a + g g;  p = p - (lr g) / (sqrt(a) + eps)
// with every operation correctly rounded (the _rn intrinsics, rintf's round
// half to even, no contraction into FMAs), torch.clamp's and
// torch.maximum's NaN propagation and min/max exact in any order: the bits
// of the per-leaf PyTorch ops, on the card and on the CPU.
//
// What bounds them on an H100. At the paper's widths (Kaggle 0.47 M, Terabyte
// 0.76 M floats over 14 leaves) the bytes are 2-3 MB a pass, under a
// microsecond at 3.35 TB/s and resident in the 50 MB L2: the launches, not
// the bytes, bound the per-leaf chain, so each direction is one launch for
// every leaf (two for the forward, whose scales need every block's extrema
// first). At DLRM-DCNv2's (16 M floats over 25 leaves) the bytes bound them:
// the forward reads each weight twice and writes it once (12 bytes an
// element), the backward reads and writes 8, the Adagrad update reads 16
// and writes 8, where the per-leaf chain moved some 140.
//
// Design.
// - The leaves' descriptor is a `__grid_constant__` kernel parameter (at
//   most kMaxLeaves leaves, 16 to 48 bytes each), as K1's: a capture copies
//   it into the graph, so a replay reads no host memory, and the addresses
//   that change from call to call (the gradients autograd hands the
//   backward, the outputs, which a capture takes from the graph's own pool)
//   travel with each launch.
// - A block takes kChunk consecutive elements of one leaf; it finds its leaf
//   by a binary search of the leaves' first blocks (a prefix in the
//   descriptor, all threads reading one word at a time).
// - The extrema kernel writes one (min, max) partial per block of an owner.
//   The fake-quant kernel's blocks each reduce their owner's partials again
//   (at most a few hundred floats from L2), so no third launch and no
//   ticket is needed; the owner's first block stores s_o for the backward.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // elements a block

struct QuantLeaf {
  const float* src;
  long long out;  // the leaf's first element in the output
  int numel;
  int block0;  // the leaf's first block of the fake-quant grid
  int part0;   // its first partial (its first block of the extrema grid)
  int parts;   // its partials: > 0 for an owner, 0 for a bias
  int owner;   // the leaf whose extrema give the scale (itself for a weight)
  float qmin, qmax;  // -n - 1 and n at the leaf's bits
  float qn;          // n at the owner's bits, the scale's divisor
};

struct QuantLeaves {
  int count;
  QuantLeaf l[kMaxLeaves];
};

struct GradLeaf {
  const float* g;
  long long out;
  int numel;
  int block0;
  int slot;  // its scale in the forward's scales
};

struct GradLeaves {
  int count;
  GradLeaf l[kMaxLeaves];
};

struct UpdateLeaf {
  float* p;
  const float* g;
  float* acc;  // null under SGD
  int numel;
  int block0;
};

struct UpdateLeaves {
  int count;
  UpdateLeaf l[kMaxLeaves];
};

// The last leaf whose first block (or partial) is at most b: leaves that
// take no block share their start with the next one, which wins.
template <typename Leaves, typename Start>
__device__ __forceinline__ int find_leaf(const Leaves& d, int b, Start start) {
  int lo = 0, hi = d.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start(d.l[mid]) <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// torch.min / torch.max of a tensor: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float v) { return (v < a || v != v) ? v : a; }
__device__ __forceinline__ float nan_max(float a, float v) { return (v > a || v != v) ? v : a; }

// torch.clamp(v, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clamp_like_torch(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// (min, max) over the block into lo and hi of thread 0, and into sh[0..1]
// for every thread after the call's barrier.
__device__ __forceinline__ void block_extrema(float& lo, float& hi, float* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float wlo[kThreads / 32], whi[kThreads / 32];
  if (lane == 0) { wlo[warp] = lo; whi[warp] = hi; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) { lo = nan_min(lo, wlo[w]); hi = nan_max(hi, whi[w]); }
    sh[0] = lo;
    sh[1] = hi;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) qat_extrema_kernel(
    const __grid_constant__ QuantLeaves d, float* __restrict__ pmin, float* __restrict__ pmax) {
  const int b = blockIdx.x;
  const QuantLeaf& L = d.l[find_leaf(d, b, [](const QuantLeaf& l) { return l.part0; })];
  const long long start = (long long)(b - L.part0) * kChunk;
  const long long end = min(start + kChunk, (long long)L.numel);
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = start + k * kThreads + threadIdx.x;
    if (e < end) {
      const float v = __ldg(L.src + e);
      lo = nan_min(lo, v);
      hi = nan_max(hi, v);
    }
  }
  __shared__ float sh[2];
  block_extrema(lo, hi, sh);
  if (threadIdx.x == 0) { pmin[b] = sh[0]; pmax[b] = sh[1]; }
}

__global__ void __launch_bounds__(kThreads) qat_fake_quant_kernel(
    const __grid_constant__ QuantLeaves d, const float* __restrict__ pmin,
    const float* __restrict__ pmax, float* __restrict__ out, float* __restrict__ scales) {
  const int b = blockIdx.x;
  const int i = find_leaf(d, b, [](const QuantLeaf& l) { return l.block0; });
  const QuantLeaf& L = d.l[i];
  const QuantLeaf& O = d.l[L.owner];
  float lo = INFINITY, hi = -INFINITY;
  for (int p = threadIdx.x; p < O.parts; p += kThreads) {
    lo = nan_min(lo, pmin[O.part0 + p]);
    hi = nan_max(hi, pmax[O.part0 + p]);
  }
  __shared__ float sh[2];
  block_extrema(lo, hi, sh);
  // symmetric_quantization_params: maximum(|min|, |max|), clamp_min(1e-8), / n
  const float m = nan_max(fabsf(sh[0]), fabsf(sh[1]));
  const float eps = static_cast<float>(1e-8);
  const float s = __fdiv_rn(m != m ? m : fmaxf(m, eps), O.qn);
  if (threadIdx.x == 0 && L.owner == i && b == L.block0) scales[i] = s;
  const long long start = (long long)(b - L.block0) * kChunk;
  const long long end = min(start + kChunk, (long long)L.numel);
  float* dst = out + L.out;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = start + k * kThreads + threadIdx.x;
    if (e < end) {
      const float q = clamp_like_torch(rintf(__fdiv_rn(__ldg(L.src + e), s)), L.qmin, L.qmax);
      dst[e] = __fmul_rn(q, s);
    }
  }
}

__global__ void __launch_bounds__(kThreads) qat_ste_backward_kernel(
    const __grid_constant__ GradLeaves d, const float* __restrict__ scales, float* __restrict__ out) {
  const int b = blockIdx.x;
  const GradLeaf& L = d.l[find_leaf(d, b, [](const GradLeaf& l) { return l.block0; })];
  const float s = scales[L.slot];
  const long long start = (long long)(b - L.block0) * kChunk;
  const long long end = min(start + kChunk, (long long)L.numel);
  float* dst = out + L.out;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = start + k * kThreads + threadIdx.x;
    if (e < end) dst[e] = __fdiv_rn(__fmul_rn(__ldg(L.g + e), s), s);
  }
}

template <bool ADAGRAD>
__global__ void __launch_bounds__(kThreads) dense_update_kernel(
    const __grid_constant__ UpdateLeaves d, const float* __restrict__ lr_ptr, float lr_value, float eps) {
  const int b = blockIdx.x;
  const UpdateLeaf& L = d.l[find_leaf(d, b, [](const UpdateLeaf& l) { return l.block0; })];
  const float lr = lr_ptr ? *lr_ptr : lr_value;
  const long long start = (long long)(b - L.block0) * kChunk;
  const long long end = min(start + kChunk, (long long)L.numel);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = start + k * kThreads + threadIdx.x;
    if (e < end) {
      const float g = __ldg(L.g + e);
      const float step = __fmul_rn(lr, g);
      if (ADAGRAD) {
        const float a = __fadd_rn(L.acc[e], __fmul_rn(g, g));
        L.acc[e] = a;
        L.p[e] = __fsub_rn(L.p[e], __fdiv_rn(step, __fadd_rn(__fsqrt_rn(a), eps)));
      } else {
        L.p[e] = __fsub_rn(L.p[e], step);
      }
    }
  }
}

int blocks_of(long long numel) { return (int)((numel + kChunk - 1) / kChunk); }

}  // namespace

extern "C" int dqrm_qat_chunk() { return kChunk; }

extern "C" int dqrm_qat_max_leaves() { return kMaxLeaves; }

// leaves: count records of 6 int64 (src, out offset, numel, owner, bits,
// owner's bits); pmin/pmax: one float per kChunk of every owner; out:
// the fake-quantized leaves, flat; scales: one float per leaf (owners'
// slots written).
extern "C" int dqrm_qat_fake_quant(const long long* leaves, int count, void* pmin, void* pmax,
                                   void* out, void* scales, void* stream_) {
  if (leaves == nullptr || count <= 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  QuantLeaves d = {};
  d.count = count;
  int blocks = 0, parts = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = leaves + 6 * i;
    QuantLeaf& L = d.l[i];
    L.src = reinterpret_cast<const float*>(r[0]);
    L.out = r[1];
    const long long numel = r[2];
    L.owner = (int)r[3];
    const int bits = (int)r[4], owner_bits = (int)r[5];
    if (L.src == nullptr || numel <= 0 || numel > INT32_MAX || L.owner < 0 || L.owner > i ||
        bits < 2 || bits > 32 || owner_bits < 2 || owner_bits > 32 || L.out < 0) {
      return (int)cudaErrorInvalidValue;
    }
    if (L.owner < i && d.l[L.owner].owner != L.owner) return (int)cudaErrorInvalidValue;
    L.numel = (int)numel;
    L.qmax = (float)((1LL << (bits - 1)) - 1);
    L.qmin = (float)(-(1LL << (bits - 1)));
    L.qn = (float)((1LL << (owner_bits - 1)) - 1);
    L.block0 = blocks;
    L.part0 = parts;
    L.parts = L.owner == i ? blocks_of(numel) : 0;
    blocks += blocks_of(numel);
    parts += L.parts;
  }
  if (parts > 0) {
    qat_extrema_kernel<<<parts, kThreads, 0, stream>>>(d, static_cast<float*>(pmin),
                                                       static_cast<float*>(pmax));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  qat_fake_quant_kernel<<<blocks, kThreads, 0, stream>>>(
      d, static_cast<const float*>(pmin), static_cast<const float*>(pmax), static_cast<float*>(out),
      static_cast<float*>(scales));
  return (int)cudaGetLastError();
}

// leaves: count records of 4 int64 (g, out offset, numel, scale slot).
extern "C" int dqrm_qat_ste_backward(const long long* leaves, int count, const void* scales,
                                     void* out, void* stream_) {
  if (leaves == nullptr || count <= 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  GradLeaves d = {};
  d.count = count;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = leaves + 4 * i;
    GradLeaf& L = d.l[i];
    L.g = reinterpret_cast<const float*>(r[0]);
    L.out = r[1];
    if (L.g == nullptr || r[2] <= 0 || r[2] > INT32_MAX || r[3] < 0 || L.out < 0) {
      return (int)cudaErrorInvalidValue;
    }
    L.numel = (int)r[2];
    L.slot = (int)r[3];
    L.block0 = blocks;
    blocks += blocks_of(r[2]);
  }
  qat_ste_backward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_)>>>(
      d, static_cast<const float*>(scales), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// leaves: count records of 4 int64 (p, g, acc or 0, numel); lr from lr_ptr
// (a device float) when it is not null, else lr_value.
extern "C" int dqrm_dense_update(const long long* leaves, int count, int adagrad, const void* lr_ptr,
                                 float lr_value, float eps, void* stream_) {
  if (leaves == nullptr || count <= 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  UpdateLeaves d = {};
  d.count = count;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = leaves + 4 * i;
    UpdateLeaf& L = d.l[i];
    L.p = reinterpret_cast<float*>(r[0]);
    L.g = reinterpret_cast<const float*>(r[1]);
    L.acc = reinterpret_cast<float*>(r[2]);
    if (L.p == nullptr || L.g == nullptr || (adagrad && L.acc == nullptr) || r[3] <= 0 ||
        r[3] > INT32_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    L.numel = (int)r[3];
    L.block0 = blocks;
    blocks += blocks_of(r[3]);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const float* lr = static_cast<const float*>(lr_ptr);
  if (adagrad) {
    dense_update_kernel<true><<<blocks, kThreads, 0, stream>>>(d, lr, lr_value, eps);
  } else {
    dense_update_kernel<false><<<blocks, kThreads, 0, stream>>>(d, lr, lr_value, eps);
  }
  return (int)cudaGetLastError();
}
