// Mid-table streaming scatter-add (K5) and sorted unique-row update (K6).
//
// K5 replaces the TPU kernel `stream_scatter_add` (kernel `_stream_kernel`)
// and K6 replaces `dma_row_update` (kernel `_dma_row_kernel`), both in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/stream_update.py.
//
// Contracts, in place on a [R, D] table of float32 or bfloat16:
//   K5: table.at[sids].add(svals, mode="drop") for sids [U] int32 sorted
//       ascending (duplicates and padding ids >= R allowed), svals [U, D]
//       float32. Each row's duplicates are summed in order in float32 and
//       added to the row once, with one rounding to the table's type.
//   K6: table.at[uids].add(uvals.astype(table.dtype)) for uids [U] int32
//       whose ids in [0, R) are unique (sorted, padding ids >= R at the tail
//       in the callers), uvals [U, D] float32: the values are first rounded
//       to the table's type, as the JAX kernel does (stream_update.py:404),
//       then added in float32 with one rounding to the table's type.
//   Ids outside [0, R) add nothing.
//
// Why the TPU designs are not carried over: TPU Pallas has no scatter and no
// atomics, so K5 streamed the whole table through VMEM and applied each
// tile's updates with a one-hot matmul, and K6 walked the sorted ids with a
// ring of single-row DMAs. Hopper reads and writes a row at any address, so
// both are direct: only the touched rows move.
//
// What bounds them on an H100: bytes, and at the training shape the launch.
// K5 at the main path's shape (8192 updates of d = 16 into one of the three
// mid Kaggle tables) reads 32 KB of ids and 512 KB of values and reads and
// writes at most 8192 touched 64 B rows (1 MB): about 0.5 us at 3.35 TB/s.
//
// Design. K5: one thread per (position i, column c). Position i starts a run
// when i == 0 or sids[i] != sids[i-1]; the sorted order makes each row's
// updates one contiguous run, so exactly one thread per column owns a row and
// the read-modify-write needs no atomics. The result does not depend on the
// schedule (unlike K1's atomics). The owner sums its run in order, so a run
// of n updates is n dependent steps in one thread: 8192 updates into 3 rows
// serialize about 2730 loads per thread. K6: one thread per (position,
// column), one read-modify-write each. Adds use __fadd_rn so nvcc does not
// contract them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to the table's type and back to float32.
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void stream_scatter_kernel(
    T* __restrict__ table,             // [R, D], updated in place
    const int32_t* __restrict__ sids,  // [U], sorted ascending
    const float* __restrict__ svals,   // [U, D]
    int64_t R, int64_t U, int D) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= U * D) return;
  const int64_t i = t / D;
  const int c = (int)(t - i * D);
  const int32_t row = __ldg(sids + i);
  if (i > 0 && __ldg(sids + i - 1) == row) return;  // not a run start
  if (row < 0 || (int64_t)row >= R) return;         // dropped
  float acc = 0.0f;
  for (int64_t j = i; j < U && __ldg(sids + j) == row; ++j) {
    acc = __fadd_rn(acc, __ldg(svals + j * D + c));
  }
  T* p = table + (int64_t)row * D + c;
  store_from_f32(p, __fadd_rn(load_f32(p), acc));
}

template <typename T>
__global__ void row_update_kernel(
    T* __restrict__ table,             // [R, D], updated in place
    const int32_t* __restrict__ uids,  // [U], unique within [0, R)
    const float* __restrict__ uvals,   // [U, D]
    int64_t R, int64_t U, int D) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= U * D) return;
  const int64_t i = t / D;
  const int c = (int)(t - i * D);
  const int32_t row = __ldg(uids + i);
  if (row < 0 || (int64_t)row >= R) return;
  T* p = table + (int64_t)row * D + c;
  store_from_f32(p, __fadd_rn(load_f32(p), round_to(p, __ldg(uvals + t))));
}

constexpr int kThreads = 256;

bool bad_args(long long R, long long U, int D) { return R <= 0 || U < 0 || D <= 0; }

unsigned blocks_for(long long U, int D) {
  return (unsigned)((U * D + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for arguments the kernels do not take).
// `table_bf16` is 0 for a float32 table, 1 for a bfloat16 one.
extern "C" int dqrm_stream_scatter_add(
    void* table, int table_bf16, const void* sids, const void* svals, long long R,
    long long U, int D, void* stream) {
  if (bad_args(R, U, D)) return (int)cudaErrorInvalidValue;
  if (U == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(sids);
  const float* vals = static_cast<const float*>(svals);
  if (table_bf16) {
    stream_scatter_kernel<__nv_bfloat16><<<blocks_for(U, D), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(table), ids, vals, R, U, D);
  } else {
    stream_scatter_kernel<float><<<blocks_for(U, D), kThreads, 0, s>>>(
        static_cast<float*>(table), ids, vals, R, U, D);
  }
  return (int)cudaGetLastError();
}

extern "C" int dqrm_dma_row_update(
    void* table, int table_bf16, const void* uids, const void* uvals, long long R,
    long long U, int D, void* stream) {
  if (bad_args(R, U, D)) return (int)cudaErrorInvalidValue;
  if (U == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(uids);
  const float* vals = static_cast<const float*>(uvals);
  if (table_bf16) {
    row_update_kernel<__nv_bfloat16><<<blocks_for(U, D), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(table), ids, vals, R, U, D);
  } else {
    row_update_kernel<float><<<blocks_for(U, D), kThreads, 0, s>>>(
        static_cast<float*>(table), ids, vals, R, U, D);
  }
  return (int)cudaGetLastError();
}
