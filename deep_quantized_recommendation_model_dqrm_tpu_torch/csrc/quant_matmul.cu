// INT8-weight dequantize + matmul for the serving MLP.
//
// Replaces the TPU kernel `int8_linear` (kernel `_int8_linear_kernel`) in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/quant_matmul.py.
//
// Contract: out[m, n] = sum_k x[m, k] * (float(w[n, k]) * scale[n]) + bias[n],
// in full float32 (no TF32, no tensor cores): x [M, K] f32 row-major,
// w [N, K] int8 row-major, scale and bias [N] f32, out [M, N] f32.
//
// What bounds it on this card: operations. The seven serving layers at
// B = 16384 do 15.5 GFLOP against some 240 MB of activations, about 0.23 ms
// at the 67 TFLOP/s float32 rate outside the tensor cores and 0.07 ms at
// 3.35 TB/s.
//
// Design: a tiled SIMT SGEMM. Each block of 256 threads computes a 64 x 64
// output tile and walks K in steps of 16. Per step it stages the x tile
// (f32) and the int8 w tile in shared memory; w is dequantized on its way
// into shared memory with the same single product float(w) * scale[n] as
// the plain version (an _rn multiply, so nvcc fuses nothing into it), so
// the dequantized weights never reach device memory. Each thread keeps a
// 4 x 4 block of sums in registers and adds the bias in the epilogue.
// Ragged edges (K = 13, N = 1 and N = 16 all occur) are masked with zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps float4 reads aligned, spreads the stores

__global__ void __launch_bounds__(THREADS) int8_linear_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // output columns tx*TN .. +TN-1
  const int ty = tid / (BN / TN);  // output rows ty*TM .. +TM-1
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Loader mapping: each thread moves 4 consecutive k of one row per tile.
  const int ld_row = tid / (BK / 4);       // 0..63
  const int ld_k = (tid % (BK / 4)) * 4;   // 0, 4, 8, 12
  const int64_t xm = m0 + ld_row;
  const int wn = n0 + ld_row;
  const float w_scale = wn < N ? __ldg(scale + wn) : 0.0f;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ld_k + i;
      xs[ld_k + i][ld_row] = (xm < M && k < K) ? __ldg(x + xm * K + k) : 0.0f;
      const float wq = (wn < N && k < K) ? (float)__ldg(w + (int64_t)wn * K + k) : 0.0f;
      ws[ld_k + i][ld_row] = __fmul_rn(wq, w_scale);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[m * N + n] = __fadd_rn(acc[i][j], __ldg(bias + n));
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int dqrm_int8_linear(const void* x, const void* w, const void* scale,
                                const void* bias, void* out, int M, int K, int N,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_linear_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
