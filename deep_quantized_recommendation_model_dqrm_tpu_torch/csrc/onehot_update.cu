// Small-table dense gradient (K1) and small-table weighted pooled lookup (K4),
// each one launch for a group of tables.
//
// K1 replaces the TPU kernel `onehot_dense_grad` (kernel `_kernel`) and K4
// the forward of `onehot_pooled_lookup` (`_onehot_pooled_lookup_fwd`, kernel
// `_lookup_kernel`), both in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/onehot_update.py.
//
// Contracts, in float32, for each table i of a group (n_i rows, slot k_i in
// the [T, B, P] ids, the [T, B, P] mask or weights and the [T, B, D] pooled
// tensor; K4's tables are float32 or, all of a group, bfloat16):
//   K1: out_i[n_i, D] = zeros.at[idx[k_i, b, p]].add(g[k_i, b] * mask[k_i, b, p])
//       over every (b, p): the pooled gradient g sent back to the rows the
//       lookups read (`rows_grad_from_pooled` followed by the TPU kernel's
//       scatter). An id outside [0, n_i) (-1 padding included) adds
//       nothing. The out_i are consecutive row ranges of one flat buffer.
//       Per-slot widths: the ids may instead be one [B, S] tensor of bags
//       of fixed, per-table widths (DLRM-DCNv2's multi-hot features), table
//       i's bag of width P_i in columns c_i to c_i + P_i of every row; then
//       idx[k_i, b, p] above reads idx[b, c_i + p], for p < P_i, and the
//       mask is 1.
//   K4: out_i[b, :] = sum_{p = 0..P-1 in order} w[k_i, b, p] * table_i[idx[k_i, b, p], :],
//       where an id outside [0, n_i) adds nothing and a missing w means 1;
//       out_i is the [B, D_i] block at float offset col_i * B of the output
//       (col_i = k_i * D for a [T, B, D] output; the serving model's QR/MD
//       members pass their own columns and widths D_i). A bfloat16 table's
//       rows are read exactly as float32 and each sum is rounded once to
//       bfloat16 (kept in the float32 output), as the TPU kernel casts its
//       float32 result to the table's type.
// The per-table entries of the wrapper are the same kernels with one table
// (K1 with P = 1 and no mask).
//
// Why the TPU design is not carried over: on the TPU both were one-hot
// matmuls on the MXU (with a hi/mid/lo bf16 split of the values so the
// products stay exact), because TPU Pallas has no atomics and its scatter
// and row gather were latency-bound. Hopper has float atomics in shared
// memory and in L2 and reads rows at any address, so both are direct.
//
// What bounds them on an H100. At the Kaggle training shape (18 tables of at
// most 20000 rows, 47,398 rows in all, D = 16, B = 128, P = 1) K1's work is
// writing 3.03 MB of gradient and reading 147 KB of g and 9 KB of ids: about
// 1 us at 3.35 TB/s. One launch per table cost 18 launches of about 2.3 us
// each, so the design is one launch for the group, with the zeroing as one
// memset. At B = 8192 the tables of 3 to 27 rows take 8192 updates each,
// which contend in L2 on a few dozen addresses; the design sums those in
// shared memory first. K4 at B = 16384, P = 1 reads 128 KB of ids and writes
// 1 MB of output per table, about 22 MB or 7 us over the 18 tables; the
// tables (3.03 MB) stay in the 50 MB L2.
//
// Design.
// - The group's descriptor is a `__grid_constant__` kernel parameter (at
//   most 32 tables), passed by value: no device copy, and no raw address
//   outlives the call.
// - K1: the blocks are split over (table, chunk of its updates); a block
//   finds its table from the prefix of block counts in the descriptor.
//   Update u of table i is (b, p) = (u / P_i, u % P_i); its id lies at
//   id_base_i + b * P + p, P the ids' row length ([T, B, P]: id_base_i =
//   k_i * B * P and P_i = P, so the id of update u is the u-th of the
//   table's block; [B, S]: id_base_i = c_i and P = S). So a table of width
//   1 reads no padding and a wide bag no other table's slots. D
//   threads take one update (b, p), one value each, so that a warp's
//   atomics touch at most 32 / D rows; the mask multiplies with __fmul_rn
//   (P = 1 without a mask stays exact). A table whose rows would each see
//   many updates (kSmemMinPerRow) is summed per block in shared memory
//   first and each nonzero sum then added to the output once; the others
//   are added straight to the output. Both adds are `atomicAdd`s whose
//   result is unused: in global memory a fire-and-forget RED in L2, in
//   shared memory a compare-and-swap loop (the H100 has no shared-memory
//   float add), which is why few updates per row go to L2 directly.
//   Duplicate ids are summed in an order that changes from run to run: the
//   result equals the sequential scatter up to float32 summation order.
// - K4: blockIdx.y is the table; D_i/4 threads take one bag, each reading
//   4 values of a row per id (16 bytes of float32, 8 of bfloat16), summing
//   the P terms in p order with the _rn intrinsics (no contraction into
//   FMAs; exact for P = 1), and writing 16 bytes straight into the table's
//   block of the output. Where a D_i is not a multiple of 4, or an address
//   is not aligned to its 4 values, one thread takes one value instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 32;
constexpr int kThreads = 256;
// K1 work per block. A table summed in global memory takes one pass of its
// block's threads over the updates (kThreads / D updates a pass) for each
// kUpdatesPerPass of its updates, from kMinPasses to kMaxPasses: a small
// batch spreads over more blocks, a large one over fewer, longer ones. A
// table summed in shared memory takes kSmemChunk updates a block. A table
// is summed in shared memory where its rows would each see at least
// kSmemMinPerRow updates in L2 and a block's chunk leaves at least 4
// updates per row; its gradient there takes at most kSmemBytes.
constexpr int kUpdatesPerPass = 1024;
constexpr int kMinPasses = 2;
constexpr int kMaxPasses = 8;
constexpr int kSmemChunk = 128;
constexpr int kSmemMinPerRow = 256;
constexpr int kSmemBytes = 48 * 1024;

struct GradTable {
  long long rows;
  long long slot;
  long long row_offset;  // in the flat output
  long long id_base;     // the table's first id in idx
  long long width;       // ids a bag (P_i)
  int chunk;             // updates per block
  int smem;              // accumulate in shared memory
};

// Each table's first block apart from the tables: a block finds its table by
// walking these alone, a few contiguous words of the parameter space (read
// strided through the tables' records, the walk cost the small-batch
// launches, whose blocks take few updates each, a tenth of their time).
struct GradGroup {
  int block_start[kMaxTables];
  GradTable t[kMaxTables];
  int count;
};

struct LookupTable {
  const void* data;  // [rows, dim], float32 or bfloat16 (the group's type)
  long long rows;
  long long slot;
  long long dim;
  long long col;  // the output block starts at col * B
};

struct LookupGroup {
  LookupTable t[kMaxTables];
  int count;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

// bfloat16 is the high half of a float32: widening is a shift, exact.
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(x.x << 16); v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16); v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else {
    v[0] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

// A sum rounded to the table's type and back to float32.
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Adds each in-range update u in [u0, u1) of one table into dst (shared or
// global memory, [rows, D]): D threads per update, one value each, so that
// a warp's atomics touch at most 32 / D rows; where D > kThreads, the
// block's threads take one update, a thread every kThreads-th column.
// Update u is (b, p) = (u / width, u % width), its id and mask value at
// b * P + p = u + b * (P - width) from `ids` and `mask` (the table's first),
// its gradient g[b]; where the bag is the whole row (width == P, the [T, B,
// P] layout) that is the u-th id.
__device__ __forceinline__ void scatter_updates(
    float* dst, const float* __restrict__ g, const int32_t* __restrict__ ids,
    const float* __restrict__ mask, int64_t rows, int64_t u0, int64_t u1, int64_t width, int P,
    int D) {
  const int lanes = D < kThreads ? D : kThreads;  // threads per update
  const int per_pass = kThreads / lanes;
  const int sub = (int)threadIdx.x / lanes;
  const int j0 = (int)threadIdx.x - sub * lanes;
  if (sub >= per_pass) return;
  for (int64_t u = u0 + sub; u < u1; u += per_pass) {
    const int64_t b = width == 1 ? u : u / width;
    const int64_t at = u + b * (P - width);
    const int64_t id = __ldg(ids + at);
    if (id < 0 || id >= rows) continue;
    const float* gu = g + b * D;
    const float m = mask ? __ldg(mask + at) : 1.0f;
    for (int j = j0; j < D; j += lanes) {
      float v = __ldg(gu + j);
      if (mask) v = __fmul_rn(v, m);
      atomicAdd(dst + id * D + j, v);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dense_grad_grouped_kernel(
    const __grid_constant__ GradGroup group,
    const float* __restrict__ g,      // [T, B, D]
    const int32_t* __restrict__ idx,  // [T, B, P] or [B, P] (bags at per-table columns)
    const float* __restrict__ mask,   // [T, B, P], or null (with bags, null)
    float* __restrict__ out,          // [sum of rows, D], zeroed
    int B, int P, int D) {
  extern __shared__ float acc[];
  int ti = 0;
  while (ti + 1 < group.count && (int)blockIdx.x >= group.block_start[ti + 1]) ++ti;
  const GradTable& d = group.t[ti];
  const int64_t R = (int64_t)B * d.width;
  const int64_t u0 = (int64_t)((int)blockIdx.x - group.block_start[ti]) * d.chunk;
  const int64_t u1 = u0 + d.chunk < R ? u0 + d.chunk : R;
  const int32_t* ids = idx + d.id_base;
  const float* msk = mask ? mask + d.id_base : nullptr;
  const float* gk = g + d.slot * B * (int64_t)D;
  float* o = out + d.row_offset * D;
  if (!d.smem) {  // uniform over the block
    scatter_updates(o, gk, ids, msk, d.rows, u0, u1, d.width, P, D);
    return;
  }
  const int64_t nd = d.rows * D;
  for (int64_t e = threadIdx.x; e < nd; e += kThreads) acc[e] = 0.0f;
  __syncthreads();
  scatter_updates(acc, gk, ids, msk, d.rows, u0, u1, d.width, P, D);
  __syncthreads();
  for (int64_t e = threadIdx.x; e < nd; e += kThreads) {
    const float s = acc[e];
    if (s != 0.0f) atomicAdd(o + e, s);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) pooled_lookup_grouped_kernel(
    const __grid_constant__ LookupGroup group,
    const int32_t* __restrict__ idx,  // [T, B, P]
    const float* __restrict__ w,      // [T, B, P] or null (weights of one)
    float* __restrict__ out,          // the tables' [B, dim] blocks
    int B, int P) {
  const LookupTable& d = group.t[blockIdx.y];
  const T* data = static_cast<const T*>(d.data);
  const int D = (int)d.dim;
  const int lanes = D / VEC;
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (int64_t)B * lanes) return;
  const int64_t b = item / lanes;
  const int lane = (int)(item - b * lanes);
  const int64_t bag = d.slot * (int64_t)B * P + b * P;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int64_t id = __ldg(idx + bag + p);
    if (id < 0 || id >= d.rows) continue;
    const float m = w ? __ldg(w + bag + p) : 1.0f;
    float v[VEC];
    load_vec<VEC>(data + id * D + lane * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(m, v[e]));
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = round_to(data, acc[e]);
  float* o = out + d.col * B + b * (int64_t)D + lane * VEC;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    o[0] = acc[0];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

template <typename T>
void launch_lookup(const LookupGroup& group, bool vec4, dim3 grid, cudaStream_t s, const int32_t* ids,
                   const float* w, float* out, int B, int P) {
  if (vec4) {
    pooled_lookup_grouped_kernel<T, 4><<<grid, kThreads, 0, s>>>(group, ids, w, out, B, P);
  } else {
    pooled_lookup_grouped_kernel<T, 1><<<grid, kThreads, 0, s>>>(group, ids, w, out, B, P);
  }
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for arguments the kernels do not take).

// K1 for `count` tables described by `tables` (host memory, 5 int64 each:
// rows, slot, row offset in `out`, bag column, bag width; the offsets of
// consecutive row ranges and the slots within g, checked by the caller):
// g [T, B, D], out [total_rows, D], which this entry zeroes first. Ids
// whose rows are P long: where a table's bag width is 0, idx is [T, B, P]
// and the table reads its slot's [B, P] block; else idx is [B, P] and the
// table reads `width` ids from `column` in every row. mask: [T, B, P], or
// null (always null with bags).
extern "C" int dqrm_dense_grad_grouped(
    const long long* tables, int count, const void* g, const void* idx, const void* mask,
    void* out, long long total_rows, int B, int P, int D, void* stream_) {
  if (tables == nullptr || count <= 0 || count > kMaxTables || total_rows <= 0 || B < 0 ||
      P < 0 || D <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const cudaError_t zero = cudaMemsetAsync(out, 0, (size_t)total_rows * D * sizeof(float), stream);
  if (zero != cudaSuccess) return (int)zero;
  if ((long long)B * P == 0) return (int)cudaGetLastError();
  const int per_pass = D < kThreads ? kThreads / D : 1;  // updates a block takes at once
  const int smem_chunk = kSmemChunk > per_pass ? kSmemChunk : per_pass;
  GradGroup group = {};
  group.count = count;
  long long blocks = 0;
  size_t smem = 0;
  for (int i = 0; i < count; ++i) {
    GradTable& t = group.t[i];
    t.rows = tables[5 * i];
    t.slot = tables[5 * i + 1];
    t.row_offset = tables[5 * i + 2];
    const long long column = tables[5 * i + 3];
    t.width = tables[5 * i + 4];
    if (t.rows <= 0 || t.slot < 0 || t.row_offset < 0 || t.row_offset + t.rows > total_rows ||
        t.width < 0 || column < 0 || column + t.width > P || (mask && t.width > 0)) {
      return (int)cudaErrorInvalidValue;
    }
    t.id_base = t.width == 0 ? t.slot * B * P : column;
    if (t.width == 0) t.width = P;
    const long long R = (long long)B * t.width;
    const long long passes = R / kUpdatesPerPass;
    const int global_chunk =
        per_pass * (int)(passes < kMinPasses ? kMinPasses : passes > kMaxPasses ? kMaxPasses : passes);
    const long long smem_updates = R < smem_chunk ? R : smem_chunk;
    const size_t bytes = (size_t)t.rows * D * sizeof(float);
    t.smem = R >= kSmemMinPerRow * t.rows && 4 * t.rows <= smem_updates &&
             bytes <= (size_t)kSmemBytes;
    t.chunk = t.smem ? smem_chunk : global_chunk;
    if (t.smem && bytes > smem) smem = bytes;
    group.block_start[i] = (int)blocks;
    blocks += (R + t.chunk - 1) / t.chunk;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dense_grad_grouped_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      group, static_cast<const float*>(g), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), B, P, D);
  return (int)cudaGetLastError();
}

// K4 for `count` tables described by `tables` (host memory, 5 int64 each:
// data address, rows, slot, dim, col; checked by the caller), float32, or
// bfloat16 where `table_bf16` is 1: idx [T, B, P], w [T, B, P] or null;
// table i writes the [B, dim_i] block at out + col_i * B (float32), and
// nothing else of `out` is written. `max_dim` is the largest dim of the
// group.
extern "C" int dqrm_pooled_lookup_grouped(
    const long long* tables, int count, int table_bf16, const void* idx, const void* w, void* out,
    int B, int P, int max_dim, void* stream) {
  if (tables == nullptr || count <= 0 || count > kMaxTables || B < 0 || P < 0 || max_dim <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  LookupGroup group = {};
  group.count = count;
  bool vec4 = aligned16(out);
  for (int i = 0; i < count; ++i) {
    LookupTable& t = group.t[i];
    t.data = reinterpret_cast<const void*>(tables[5 * i]);
    t.rows = tables[5 * i + 1];
    t.slot = tables[5 * i + 2];
    t.dim = tables[5 * i + 3];
    t.col = tables[5 * i + 4];
    if (t.data == nullptr || t.rows <= 0 || t.slot < 0 || t.dim <= 0 || t.dim > max_dim ||
        t.col < 0) {
      return (int)cudaErrorInvalidValue;
    }
    vec4 = vec4 && t.dim % 4 == 0 && (t.col * B) % 4 == 0 &&
           (table_bf16 ? aligned8(t.data) : aligned16(t.data));
  }
  if (B == 0) return (int)cudaGetLastError();
  const int lanes = vec4 ? max_dim / 4 : max_dim;
  const long long blocks = ((long long)B * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)count);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (table_bf16) {
    launch_lookup<__nv_bfloat16>(group, vec4, grid, s, ids, wf, of, B, P);
  } else {
    launch_lookup<float>(group, vec4, grid, s, ids, wf, of, B, P);
  }
  return (int)cudaGetLastError();
}
