// INT8-weight dequantize + matmul for the serving MLP, on the tensor cores.
//
// Replaces the TPU kernel `int8_linear` (kernel `_int8_linear_kernel`) in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/quant_matmul.py.
//
// Contract: out[m, n] = sum_k x[m, k] * float(w[n, k]) * scale[n] + bias[n],
// then max(., 0) when `relu` is set, float32-accurate: x [M, K] f32
// row-major, w [N, K] int8 row-major, scale and bias [N] f32, out [M, N] f32.
// The plain version dequantizes first (x @ (w * s).T + b); the two differ
// by float32 rounding only.
//
// What bounds it on this card: bytes. The seven Kaggle serving layers at
// B = 16384 move about 235.7 MB of activations in and out (0.070 ms at
// 3.35 TB/s) and do 15.5 GFLOP; run as three bf16 tensor-core passes (below)
// that is 46.6 GFLOP, 0.047 ms at 989 TFLOP/s. The float32 SIMT units alone
// would need 0.232 ms (67 TFLOP/s), which is why this kernel uses the tensor
// cores.
//
// Design. An int8 weight is exact in bf16 (|w| <= 128 needs 8 significant
// bits), so only x has to be split to keep float32 accuracy:
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
// reconstructs x to about 2^-24 relative, and hi*w, mid*w, lo*w are exact
// products. The JAX package uses the same three-pass split on the MXU
// (ops/pallas/onehot_update.py:82-102). The kernel:
// - Weights: a block owns a BN-wide column tile of the output. It converts
//   its int8 weight tile to bf16 into shared memory, in the no-swizzle
//   K-major layout that `wgmma` reads as B: core matrix (g = n / 8,
//   c = k / 8) of 8 rows x 16 bytes at byte offset (g * Kc / 8 + c) * 128,
//   Kc being the tile's depth. A tile of at most 640 (16-padded) columns
//   keeps a 128-wide tile and the x rings within the 227 KB a block may
//   use. Where K fits (Kp <= 640, every Kaggle layer) the tile holds the
//   whole of K and is converted once per block. A wider K is taken in
//   chunks of 640 columns, the last one shorter: for each of its 64-row
//   tiles the block converts chunk after chunk into the one tile buffer,
//   with a barrier before each refill (every warpgroup has finished reading
//   the last chunk) and a `fence.proxy.async` and a barrier after it, and
//   the warpgroups keep one float32 accumulator across the chunks. The
//   epilogue runs once, after the last chunk. The warpgroups of a block
//   then walk their tiles in step, a warpgroup past M taking part in the
//   barriers on zeros. The dequantized weights never reach device memory.
// - Activations: each of the block's 1-4 warpgroups walks its own 64-row
//   tiles of x. Every thread copies its own A fragment of a k16 step (rows g
//   and g + 8 of its warp's 16, columns 2t, 2t + 1, 2t + 8, 2t + 9) with
//   `cp.async` into a private 4-stage ring in shared memory, 3 steps ahead,
//   8-byte copies when K is even (K = 13 and K = 367 rows are not 8-byte
//   aligned: 4-byte copies), zero-filled at M and K. As each thread reads
//   back only what it copied, no barrier is needed. It splits the fragment
//   into hi/mid/lo bf16 pairs in registers. (Loading the fragment straight
//   into registers one step ahead was slower on the H100; PERF.md has the
//   times.)
// - Compute: three `wgmma.mma_async.m64nBNk16.f32.bf16.bf16` per k16 step
//   (A from registers, B from shared memory), all into one float32
//   accumulator.
// - Epilogue, after the last k16 step: out = acc * scale[n] + bias[n]
//   (one fma), ReLU if asked, masked at M and N (N = 1 and N = 16 occur:
//   BN is 8, 16, 64 or 128).
// - Grid: (N tiles, M groups), sized so that every layer puts about one
//   block on each SM; with 64-row tiles per warpgroup, the 256 tiles of
//   B = 16384 spread over 128-132 SMs in every Kaggle layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroup = 128;
constexpr int kMaxWarpgroups = 4;
constexpr int kTileM = 64;
constexpr int kMaxKp = 640;
constexpr int kStages = 4;  // x fragments in flight per thread: kStages - 1 steps ahead
constexpr int kChunkSteps = kMaxKp / 16;  // k16 steps of one weight tile
// each warpgroup's ring of x fragments: kStages x 2 float4 per thread
constexpr int kRingBytes = kStages * 2 * kWarpgroup * 16;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + mid + lo for the two values of a fragment register.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(v.x, hf.x), ry = __fsub_rn(v.y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y));
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(l);
}

// Starts the copy of x[row, c] and x[row, c + 1] to shared memory at dst,
// zeros outside [0, M) x [0, K). c is even.
template <bool EVEN_K>
__device__ __forceinline__ void copy_pair(float* dst, const float* __restrict__ x, int64_t row,
                                          int M, int K, int c) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const float* p = x + (row < M ? row : 0) * K + c;
  if (EVEN_K) {
    const int n = row < M && c < K ? 8 : 0;  // bytes read; the rest is zero-filled
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(n ? p : x), "r"(n)
                 : "memory");
  } else {
    const int n0 = row < M && c < K ? 4 : 0;
    const int n1 = row < M && c + 1 < K ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(n0 ? p : x), "r"(n0)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + 4),
                 "l"(n1 ? p + 1 : x), "r"(n1)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two core matrices of a k16 step along K) and stride
// byte offset (between 8-row groups along N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[BN / 2] += A (64 x 16 bf16, this thread's fragment a[4]) * B (16 x BN
// bf16 in shared memory at desc_b), float32 accumulation.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Converts columns [k0, k0 + 8 * kc_fill) of the block's int8 weight rows
// n0 .. n0 + BN - 1 to bf16 (exact) in the tile's core-matrix layout of
// depth 8 * kc (zeros past N and K). Thread idx writes row r = idx % 8 of
// core matrix (g, c): neighbouring threads write neighbouring 16 bytes, and
// a warp reads 32 bytes of each of 8 rows.
template <int BN>
__device__ __forceinline__ void fill_weights(__nv_bfloat16* wsm, const int8_t* __restrict__ w,
                                             int n0, int N, int K, int k0, int kc_fill, int kc,
                                             int w_vec) {
  for (int idx = threadIdx.x; idx < BN * kc_fill; idx += blockDim.x) {
    const int r = idx & 7;
    const int c = (idx >> 3) % kc_fill;
    const int g = (idx >> 3) / kc_fill;
    const int n = n0 + g * 8 + r;
    const int k = k0 + c * 8;
    float v[8];
    if (n < N && w_vec && k < K) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(w + (int64_t)n * K + k));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (float)(int8_t)(((e < 4 ? raw.x : raw.y) >> (8 * (e & 3))) & 0xFF);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (n < N && k + e < K) ? (float)__ldg(w + (int64_t)n * K + k + e) : 0.0f;
      }
    }
    uint4 packed;
    packed.x = bf16x2_bits(__floats2bfloat162_rn(v[0], v[1]));
    packed.y = bf16x2_bits(__floats2bfloat162_rn(v[2], v[3]));
    packed.z = bf16x2_bits(__floats2bfloat162_rn(v[4], v[5]));
    packed.w = bf16x2_bits(__floats2bfloat162_rn(v[6], v[7]));
    *reinterpret_cast<uint4*>(wsm + ((g * kc + c) * 64 + r * 8)) = packed;
  }
}

// The rings follow the weight tile in shared memory, 16-byte aligned.
__host__ __device__ constexpr int ring_offset(int bn, int kp) { return (bn * kp * 2 + 15) & ~15; }

template <int BN, bool EVEN_K>
__global__ void __launch_bounds__(kWarpgroup * kMaxWarpgroups, 1) int8_linear_tc_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int M, int K, int N, int relu, int w_vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);  // [BN / 8][kc][8][8]
  const int Kp = (K + 15) & ~15;
  const int n0 = blockIdx.x * BN;

  // the tile's depth in core matrices: all of K where it fits, else a chunk
  const bool chunked = Kp > kMaxKp;
  const int kc = (chunked ? kMaxKp : Kp) / 8;
  if (!chunked) {  // the whole weight tile, once per block
    fill_weights<BN>(wsm, w, n0, N, K, 0, kc, kc, w_vec);
    // make the generic-proxy stores visible to wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  const int wg = threadIdx.x / kWarpgroup;
  const int nwg = blockDim.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % kWarpgroup) / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m_tiles = (M + kTileM - 1) / kTileM;
  const int steps = Kp / 16;
  const uint64_t desc0 = smem_desc(wsm, 128, kc * 128);

  // this thread's slots of its warpgroup's ring: stage st holds, as two
  // float4, x[r0, c..c+1], x[r1, c..c+1] and x[r0, c+8..c+9], x[r1, c+8..c+9]
  float4* ring = reinterpret_cast<float4*>(smem + ring_offset(BN, kc * 8)) +
                 wg * kStages * 2 * kWarpgroup + threadIdx.x % kWarpgroup;
  for (int base = blockIdx.y * nwg; base < m_tiles; base += gridDim.y * nwg) {
    const int tile = base + wg;
    // a warpgroup whose tiles have run out leaves, unless the weight tile is
    // refilled per chunk: then it takes part in the refills' barriers, past M
    if (!chunked && tile >= m_tiles) break;
    const int64_t r0 = (int64_t)tile * kTileM + warp * 16 + g;
    const int64_t r1 = r0 + 8;
    // each thread copies, and later reads, only its own fragment: no barrier
    auto issue = [&](int step) {
      float* lo = reinterpret_cast<float*>(ring + (step % kStages) * 2 * kWarpgroup);
      float* hi = reinterpret_cast<float*>(ring + ((step % kStages) * 2 + 1) * kWarpgroup);
      const int c = step * 16 + 2 * t;
      copy_pair<EVEN_K>(lo, x, r0, M, K, c);
      copy_pair<EVEN_K>(lo + 2, x, r1, M, K, c);
      copy_pair<EVEN_K>(hi, x, r0, M, K, c + 8);
      copy_pair<EVEN_K>(hi + 2, x, r1, M, K, c + 8);
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < steps) issue(st);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      if (chunked && s % kChunkSteps == 0) {
        // every warpgroup has waited for its wgmma of the last chunk
        __syncthreads();
        const int left = steps - s;
        fill_weights<BN>(wsm, w, n0, N, K, s * 16, (left < kChunkSteps ? left : kChunkSteps) * 2, kc,
                         w_vec);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
      if (s + kStages - 1 < steps) issue(s + kStages - 1);  // into the stage read last step
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // step s has landed
      const float4 f0 = ring[(s % kStages) * 2 * kWarpgroup];
      const float4 f1 = ring[((s % kStages) * 2 + 1) * kWarpgroup];
      uint32_t a_hi[4], a_mid[4], a_lo[4];
      split3(make_float2(f0.x, f0.y), a_hi[0], a_mid[0], a_lo[0]);
      split3(make_float2(f0.z, f0.w), a_hi[1], a_mid[1], a_lo[1]);
      split3(make_float2(f1.x, f1.y), a_hi[2], a_mid[2], a_lo[2]);
      split3(make_float2(f1.z, f1.w), a_hi[3], a_mid[3], a_lo[3]);
      // a k16 step is two core matrices along K: 256 bytes further on
      const uint64_t desc = desc0 + (uint64_t)((s % kChunkSteps) * 16);
      wgmma_fence();
      wgmma_bf16<BN>(acc, a_hi, desc);
      wgmma_bf16<BN>(acc, a_mid, desc);
      wgmma_bf16<BN>(acc, a_lo, desc);
      wgmma_commit();
      wgmma_wait_all();
    }

    // acc[4i + 2h + e] holds row r0 + 8h, column n0 + 8i + 2t + e
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float s0 = n < N ? __ldg(scale + n) : 0.0f;
      const float b0 = n < N ? __ldg(bias + n) : 0.0f;
      const float s1 = n + 1 < N ? __ldg(scale + n + 1) : 0.0f;
      const float b1 = n + 1 < N ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = h ? r1 : r0;
        if (row >= M) continue;
        float v0 = fmaf(acc[4 * i + 2 * h], s0, b0);
        float v1 = fmaf(acc[4 * i + 2 * h + 1], s1, b1);
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        float* o = out + row * N + n;
        if (N % 2 == 0 && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int BN, bool EVEN_K>
int launch(const float* x, const int8_t* w, const float* scale, const float* bias, float* out,
           int M, int K, int N, int relu, cudaStream_t stream) {
  // 8-byte weight loads when every row starts 8-byte aligned
  const int w_vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 7) == 0;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(int8_linear_tc_kernel<BN, EVEN_K>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               ring_offset(BN, kMaxKp) + kMaxWarpgroups * kRingBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + kTileM - 1) / kTileM;
  // about one block per SM: the M groups each N tile needs, then as many
  // warpgroups per block as spread the M tiles over them
  const int groups_target = (sm_count() + n_tiles - 1) / n_tiles;
  int wgs = (m_tiles + groups_target - 1) / groups_target;
  wgs = wgs < 1 ? 1 : (wgs > kMaxWarpgroups ? kMaxWarpgroups : wgs);
  int groups = (m_tiles + wgs - 1) / wgs;
  groups = groups < groups_target ? groups : groups_target;
  const dim3 grid(n_tiles, groups);
  const int Kp = (K + 15) & ~15;
  const size_t smem = ring_offset(BN, Kp < kMaxKp ? Kp : kMaxKp) + (size_t)wgs * kRingBytes;
  int8_linear_tc_kernel<BN, EVEN_K><<<grid, kWarpgroup * wgs, smem, stream>>>(
      x, w, scale, bias, out, M, K, N, relu, w_vec);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_bn(const float* x, const int8_t* w, const float* scale, const float* bias,
              float* out, int M, int K, int N, int relu, cudaStream_t stream) {
  // 8-byte activation loads when every row starts 8-byte aligned
  const bool even = K % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0;
  return even ? launch<BN, true>(x, w, scale, bias, out, M, K, N, relu, stream)
                    : launch<BN, false>(x, w, scale, bias, out, M, K, N, relu, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take: M, K or N below 1, K above 2^31 - 16).
extern "C" int dqrm_int8_linear(const void* x, const void* w, const void* scale,
                                const void* bias, void* out, int M, int K, int N, int relu,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K > 0x7FFFFFF0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 8) return launch_bn<8>(xf, wq, s, b, o, M, K, N, relu, st);
  if (N <= 16) return launch_bn<16>(xf, wq, s, b, o, M, K, N, relu, st);
  if (N <= 64) return launch_bn<64>(xf, wq, s, b, o, M, K, N, relu, st);
  return launch_bn<128>(xf, wq, s, b, o, M, K, N, relu, st);
}
