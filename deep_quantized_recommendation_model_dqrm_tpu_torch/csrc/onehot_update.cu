// Small-table dense gradient (K1) and small-table weighted pooled lookup (K4).
//
// K1 replaces the TPU kernel `onehot_dense_grad` (kernel `_kernel`) and K4
// the forward of `onehot_pooled_lookup` (`_onehot_pooled_lookup_fwd`, kernel
// `_lookup_kernel`), both in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/onehot_update.py.
//
// Contracts, in float32:
//   K1: out[n, d] = zeros.at[ids].add(vals, mode="drop"): every id in [0, n)
//       adds its row of vals; any other id (-1 padding included) adds nothing.
//   K4: out[b, :] = sum_{p = 0..P-1 in order} w[b, p] * table[idx[b, p], :],
//       where an id outside [0, n) adds nothing.
//
// Why the TPU design is not carried over: on the TPU both were one-hot
// matmuls on the MXU (with a hi/mid/lo bf16 split of the values so the
// products stay exact), because TPU Pallas has no atomics and its scatter
// and row gather were latency-bound. Hopper has float atomics that resolve
// in L2 and reads rows at any address, so both kernels are direct.
//
// What bounds them on an H100: bytes, and at the training shape launch
// overhead. At B = 128, P = 1 over the 18 Kaggle tables with at most 20000
// rows (47,398 rows, d = 16), one step's K1 work is zeroing and writing
// 3.03 MB of gradient and reading 147 KB of vals and 9 KB of ids: about 1 us
// at 3.35 TB/s, well under the 18 launches it takes. K4 at B = 16384, P = 1
// reads 128 KB of ids and weights and writes 1 MB of output per table,
// about 23 MB or 7 us over the 18 tables; the small tables stay in the
// 50 MB L2.
//
// Design. K1: one thread per (r, j), j < d, so a half-warp covers one 64 B
// row of vals for d = 16 and its atomics hit one 64 B row of out. Each
// thread reads its id once and calls `atomicAdd` with its result unused,
// which compiles to a fire-and-forget RED in L2. Duplicate ids are summed in
// an order that changes from run to run: the result equals the sequential
// scatter up to float32 summation order. K4: one thread per (b, j), looping
// over the P ids of bag b in order and keeping the sum in a register until
// its one write. Products and sums use the _rn intrinsics so nvcc does not
// contract them into FMAs; for P = 1 the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dense_grad_kernel(
    const int32_t* __restrict__ ids,  // [R]
    const float* __restrict__ vals,   // [R, d]
    float* __restrict__ out,          // [n, d], zeroed by the caller
    int64_t n, int64_t R, int d) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * d) return;
  const int64_t r = t / d;
  const int j = (int)(t - r * d);
  const int64_t id = __ldg(ids + r);
  if (id < 0 || id >= n) return;
  atomicAdd(out + id * d + j, __ldg(vals + t));
}

__global__ void pooled_lookup_kernel(
    const float* __restrict__ table,  // [n, d]
    const int32_t* __restrict__ idx,  // [B, P]
    const float* __restrict__ w,      // [B, P]
    float* __restrict__ out,          // [B, d]
    int64_t n, int64_t B, int P, int d) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * d) return;
  const int64_t b = t / d;
  const int j = (int)(t - b * d);
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int64_t id = __ldg(idx + b * P + p);
    if (id < 0 || id >= n) continue;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + b * P + p), __ldg(table + id * d + j)));
  }
  out[t] = acc;
}

constexpr int kThreads = 256;

}  // namespace

// Each entry returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int dqrm_onehot_dense_grad(
    const void* ids, const void* vals, void* out, long long n, long long R, int d,
    void* stream) {
  if (n <= 0 || R < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const long long blocks = (R * d + kThreads - 1) / kThreads;
  dense_grad_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(out), n, R, d);
  return (int)cudaGetLastError();
}

extern "C" int dqrm_onehot_pooled_lookup(
    const void* table, const void* idx, const void* w, void* out, long long n,
    long long B, int P, int d, void* stream) {
  if (n <= 0 || B <= 0 || P <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B * d + kThreads - 1) / kThreads;
  pooled_lookup_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), n, B, P, d);
  return (int)cudaGetLastError();
}
