// Mid-table streaming scatter-add (K5), one launch for a group of tables,
// and sorted unique-row update (K6).
//
// K5 replaces the TPU kernel `stream_scatter_add` (kernel `_stream_kernel`)
// and K6 replaces `dma_row_update` (kernel `_dma_row_kernel`), both in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/stream_update.py.
//
// Contracts, in place on [R, D] tables of float32 or bfloat16:
//   K5: for each table k of a group, table_k.at[sids[k]].add(svals[k],
//       mode="drop") for sids [K, U] int32, each row sorted ascending
//       (duplicates and padding ids >= R_k allowed), svals [K, U, D]
//       float32. Each row's duplicates are summed in float32 and added to the
//       row once, with one rounding to the table's type.
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
// What bounds them on an H100: bytes. K5 at the main path's shape (the three
// mid Kaggle tables, 8192 sorted updates of d = 16 each) reads 96 KB of ids
// and 1.5 MB of values and reads and writes at most 24576 touched 64 B rows
// (3 MB): about 1.4 us at 3.35 TB/s. K6 on 8192 unique rows reads 32 KB of
// ids and 512 KB of values and reads and writes 1 MB of rows: 0.5 us.
//
// K5's design.
// - One launch for the group: a `__grid_constant__` descriptor (at most 32
//   tables) gives each table's address, rows and first block.
// - A block takes a tile of kTile = 128 sorted positions of one table. D/4
//   threads take each position, one warp per 16-byte column lane: a warp
//   loads its lane of the tile's ids and values with 16-byte loads, all in
//   flight at once, then sums each run of equal ids with a segmented scan
//   in a fixed tree order: a warp-shuffle (Hillis-Steele) scan over 32
//   positions at a time, the run still open at the end carried into the
//   next 32. A run that lies within the tile ends with its sum in one
//   thread, which reads the row, adds the float32 sum, rounds once to the
//   table's type and stores it: one read-modify-write per row and column
//   lane, no atomics. A warp reads all of its rows before it writes any.
// - Runs that cross a tile boundary: each tile writes the partial sum of
//   its first run (if that run began in an earlier tile) and of its last
//   run (if it goes on into the next) to a scratch buffer, fences, and takes
//   a ticket from a per-table counter. The table's last block to take one
//   sets the counter back to 0 for the next launch and sums the partials in
//   tile order with the same segmented scan (each crossing run is a segment
//   of the tiles' partials), giving each such row its one read-modify-write.
// - The order of every sum is fixed by the positions alone, so two launches
//   on equal inputs give equal bits, and the sums are float32 sums of the
//   same terms as the plain version's, in another order.
// - Where D % 4 != 0 or an address is not 16-byte aligned (8-byte for a
//   bfloat16 table), one lane is one column.
// Why it beats the first design (one owner thread per run, summing it
// serially): a run of n updates was n dependent loads in one thread, so
// 8192 updates into 3 rows took 0.58-0.61 ms on an H100, and skewed ids
// (Zipf, as in Criteo) put runs of hundreds to thousands of updates on the
// hot rows. Here a run costs log2(32)
// shuffle steps per 32 positions and a tile boundary two partials, whatever
// its length, and the three tables take one launch instead of three. What
// is left is latency: a block's loads, its scans and its rows, then the
// last block's finish, a chain of dependent steps a few microseconds long
// against the 1.4 us that the bytes need.
//
// K6's design: D/4 threads per row (one 16-byte load of the values and one
// 16-byte read-modify-write of the row on a float32 table, 8 bytes on a
// bfloat16 one), 256 threads a block, so 256 / (D/4) rows a block; one
// thread per column where D % 4 != 0 or an address is unaligned.
// Adds use __fadd_rn so nvcc does not contract them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 32;
constexpr int kTile = 128;           // sorted positions per K5 block
constexpr int kChunks = kTile / 32;  // a warp scans 32 positions at a time
constexpr int kMaxWarps = 8;         // a K5 block: one warp per column lane, at most 8
constexpr int kThreads = 256;        // a K6 block
constexpr unsigned kFull = 0xffffffffu;

struct StreamTable {
  void* data;  // [rows, D], float32 or bfloat16
  long long rows;
  int block_start;  // this table's first block
  int tiles;        // its blocks, one per kTile positions
};

struct StreamGroup {
  StreamTable t[kMaxTables];
  int count;
};

// VEC consecutive float32 values; values are read through the read-only
// cache, partial sums written by other blocks of this launch through L2.
template <int VEC>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// A row's VEC values, as float32, and stored back with one rounding.
template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&a);
    x.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[VEC]) {
  store_vals<VEC>(p, v);
}

// row += s in float32, one rounding to the table's type.
template <typename T, int VEC>
__device__ __forceinline__ void add_to_row(T* p, const float (&s)[VEC]) {
  float r[VEC];
  load_row<VEC>(p, r);
#pragma unroll
  for (int e = 0; e < VEC; ++e) r[e] = __fadd_rn(r[e], s[e]);
  store_row<VEC>(p, r);
}

// v rounded to the table's type and back to float32.
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Segmented inclusive scan of v over a warp's 32 positions, in a fixed tree
// order (Hillis-Steele): `head` marks a position that starts a run, and
// each position ends up with the sum of its run's values up to it. The
// positions before the warp's first head continue the run whose sum so far
// is `carry`, which is added to them last; on return `carry` holds the
// sum at lane 31, the run still open for the next 32 positions.
template <int VEC>
__device__ __forceinline__ void segmented_scan(float (&v)[VEC], bool head, float (&carry)[VEC]) {
  const int lane = (int)threadIdx.x & 31;
  const unsigned upto = __ballot_sync(kFull, head) & (kFull >> (31 - lane));
  const int first = upto ? 31 - __clz(upto) : 0;  // the run's first lane in this warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float n = __shfl_up_sync(kFull, v[e], o);
      if (lane - o >= first) v[e] = __fadd_rn(n, v[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (!upto) v[e] = __fadd_rn(carry[e], v[e]);
    carry[e] = __shfl_sync(kFull, v[e], 31);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarps) stream_scatter_grouped_kernel(
    const __grid_constant__ StreamGroup group,
    const int32_t* __restrict__ sids,  // [K, U], each row sorted ascending
    const float* __restrict__ svals,   // [K, U, D]
    float* __restrict__ partials,      // [K, 2 * tiles, D]: each tile's first and last run
    unsigned* __restrict__ tickets,    // [K], 0 between launches
    int64_t U, int D) {
  int k = 0;
  while (k + 1 < group.count && (int)blockIdx.x >= group.t[k + 1].block_start) ++k;
  const StreamTable& d = group.t[k];
  const int tile = (int)blockIdx.x - d.block_start;
  const int tiles = d.tiles;
  const int lanes = D / VEC;
  const int lane = (int)threadIdx.x & 31;
  const int warp = (int)threadIdx.x >> 5;
  const int nwarps = (int)blockDim.x >> 5;
  const int32_t* ids = sids + (int64_t)k * U;
  const float* vals = svals + (int64_t)k * U * D;
  float* part = partials + (int64_t)k * 2 * tiles * D;
  T* table = static_cast<T*>(d.data);

  const int64_t p0 = (int64_t)tile * kTile;
  const int64_t p1 = p0 + kTile < U ? p0 + kTile : U;
  const int32_t first_id = __ldg(ids + p0);
  // the tile's first run began in an earlier tile / its last run goes on
  const bool cross_in = p0 > 0 && __ldg(ids + p0 - 1) == first_id;
  const bool cross_out = p1 < U && __ldg(ids + p1) == __ldg(ids + p1 - 1);
  // a warp takes column lanes l0, l0 + nwarps, ...; the last one's row
  // writes wait until the ticket is taken
  int32_t id[kChunks];
  bool head[kChunks], end[kChunks], rmw[kChunks] = {};
  float v[kChunks][VEC], r[kChunks][VEC];
  int l0 = warp;
  for (int l = warp; l < lanes; l += nwarps) {
    const int c = l * VEC;
    if (l > l0) {  // finish the last lane's rows
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (!rmw[j]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[j][e] = __fadd_rn(r[j][e], v[j][e]);
        store_row<VEC>(table + (int64_t)id[j] * D + l0 * VEC, r[j]);
      }
      l0 = l;
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int64_t p = p0 + j * 32 + lane;
      const bool valid = p < p1;
      id[j] = valid ? __ldg(ids + p) : 0;
      head[j] = valid && (p == p0 || __ldg(ids + p - 1) != id[j]);
      end[j] = valid && (p == p1 - 1 || __ldg(ids + p + 1) != id[j]);
      if (valid) {
        load_vals<VEC>(vals + p * D + c, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] = 0.0f;
      }
    }
    float carry[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) carry[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) segmented_scan<VEC>(v[j], head[j], carry);
    // each run that ends here: a partial if it crosses a tile boundary, else
    // its row's read-modify-write, every row read before any is written
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      rmw[j] = false;
      if (!end[j]) continue;
      if (cross_in && id[j] == first_id) {  // the run that came in
        store_vals<VEC>(part + (int64_t)(2 * tile) * D + c, v[j]);
      } else if (cross_out && p0 + j * 32 + lane == p1 - 1) {  // the run going on
        store_vals<VEC>(part + (int64_t)(2 * tile + 1) * D + c, v[j]);
      } else if (id[j] >= 0 && id[j] < d.rows) {
        rmw[j] = true;
        load_row<VEC>(table + (int64_t)id[j] * D + c, r[j]);
      }
    }
  }
  // the table's last block to finish sums the runs that cross tiles: this
  // block's partials are visible before it takes its ticket, and the ticket
  // is taken while its rows are in flight
  __shared__ bool last;
  if (tiles > 1) {
    if (cross_in || cross_out) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets + k, 1u) == (unsigned)tiles - 1;
  }
  if (l0 < lanes) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!rmw[j]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[j][e] = __fadd_rn(r[j][e], v[j][e]);
      store_row<VEC>(table + (int64_t)id[j] * D + l0 * VEC, r[j]);
    }
  }
  if (tiles == 1) return;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[k] = 0;  // for the next launch

  // item 2t is tile t's first-run partial, item 2t + 1 its last-run one; a
  // crossing run is the items from its first tile's last-run partial to its
  // last tile's first-run partial (0 for a tile it passes through), a
  // segment of the scan over the items, taken 32 * kChunks at a time
  const int items = 2 * tiles;
  for (int l = warp; l < lanes; l += nwarps) {
    const int c = l * VEC;
    float carry[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) carry[e] = 0.0f;
    for (int i0 = 0; i0 < items; i0 += 32 * kChunks) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int i = i0 + j * 32 + lane;
        head[j] = true;
        end[j] = false;
        id[j] = 0;
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] = 0.0f;
        if (i < items) {
          const int t = i >> 1;
          const int64_t q0 = (int64_t)t * kTile;
          const int64_t q1 = q0 + kTile < U ? q0 + kTile : U;
          const int32_t a = __ldg(ids + q0);
          const bool in = t > 0 && __ldg(ids + q0 - 1) == a;
          const bool thru = in && q1 < U && __ldg(ids + q1) == a;
          const bool out = q1 < U && __ldg(ids + q1) == __ldg(ids + q1 - 1);
          load_partial<VEC>(part + (int64_t)i * D + c, v[j]);
          // a partial that its tile did not write counts 0
          const bool written = (i & 1) ? out && !thru : in;
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] = written ? v[j][e] : 0.0f;
          head[j] = (i & 1) ? !thru : !in;
          end[j] = !(i & 1) && in && !thru;
          id[j] = a;
        }
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) segmented_scan<VEC>(v[j], head[j], carry);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        rmw[j] = end[j] && id[j] >= 0 && id[j] < d.rows;
        if (rmw[j]) load_row<VEC>(table + (int64_t)id[j] * D + c, r[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (!rmw[j]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[j][e] = __fadd_rn(r[j][e], v[j][e]);
        store_row<VEC>(table + (int64_t)id[j] * D + c, r[j]);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) row_update_kernel(
    T* __restrict__ table,             // [R, D], updated in place
    const int32_t* __restrict__ uids,  // [U], unique within [0, R)
    const float* __restrict__ uvals,   // [U, D]
    int64_t R, int64_t U, int D) {
  const int lanes = D / VEC;
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (item >= U * lanes) return;
  const int64_t i = item / lanes;
  const int c = (int)(item - i * lanes) * VEC;
  const int32_t row = __ldg(uids + i);
  if (row < 0 || (int64_t)row >= R) return;
  T* p = table + (int64_t)row * D + c;
  float v[VEC];
  load_vals<VEC>(uvals + i * D + c, v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = round_to(p, v[e]);
  add_to_row<T, VEC>(p, v);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int launch_grouped(const StreamGroup& group, int vec4, int blocks, int threads,
                   const int32_t* ids, const float* vals, float* partials, unsigned* tickets,
                   long long U, int D, cudaStream_t s) {
  if (vec4) {
    stream_scatter_grouped_kernel<T, 4><<<blocks, threads, 0, s>>>(group, ids, vals, partials,
                                                                    tickets, U, D);
  } else {
    stream_scatter_grouped_kernel<T, 1><<<blocks, threads, 0, s>>>(group, ids, vals, partials,
                                                                    tickets, U, D);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(T* table, int vec4, const int32_t* ids, const float* vals, long long R,
                long long U, int D, cudaStream_t s) {
  const long long items = U * (vec4 ? D / 4 : D);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec4) {
    row_update_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, vals, R, U, D);
  } else {
    row_update_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, vals, R, U, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for arguments the kernels do not take).
// `table_bf16` is 0 for float32 tables, 1 for bfloat16 ones.

// K5 for `count` tables described by `tables` (host memory, 2 int64 each:
// data address, rows; checked by the caller): sids [count, U] int32,
// svals [count, U, D] float32, partials [count, 2 * ceil(U / tile), D]
// float32 scratch (tile = dqrm_stream_tile()), tickets [count] (at least) unsigned, 0 before the launch
// and 0 again after it.
extern "C" int dqrm_stream_scatter_grouped(
    const long long* tables, int count, int table_bf16, const void* sids, const void* svals,
    void* partials, void* tickets, long long U, int D, void* stream) {
  if (tables == nullptr || count <= 0 || count > kMaxTables || U < 0 || D <= 0 ||
      partials == nullptr || tickets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (U == 0) return (int)cudaGetLastError();
  const long long tiles = (U + kTile - 1) / kTile;
  if (tiles * count > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  StreamGroup group = {};
  group.count = count;
  const uintptr_t row_align = table_bf16 ? 8 : 16;
  int vec4 = D % 4 == 0 && aligned(svals, 16) && aligned(partials, 16);
  for (int i = 0; i < count; ++i) {
    StreamTable& t = group.t[i];
    t.data = reinterpret_cast<void*>(tables[2 * i]);
    t.rows = tables[2 * i + 1];
    if (t.data == nullptr || t.rows <= 0) return (int)cudaErrorInvalidValue;
    t.block_start = (int)(i * tiles);
    t.tiles = (int)tiles;
    vec4 = vec4 && aligned(t.data, row_align);
  }
  const int lanes = vec4 ? D / 4 : D;
  const int threads = 32 * (lanes < kMaxWarps ? lanes : kMaxWarps);
  const int blocks = (int)(tiles * count);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(sids);
  const float* vals = static_cast<const float*>(svals);
  float* part = static_cast<float*>(partials);
  unsigned* tk = static_cast<unsigned*>(tickets);
  return table_bf16
             ? launch_grouped<__nv_bfloat16>(group, vec4, blocks, threads, ids, vals, part, tk, U, D, s)
             : launch_grouped<float>(group, vec4, blocks, threads, ids, vals, part, tk, U, D, s);
}

// Sorted positions per K5 block: the partials buffer holds 2 per block.
extern "C" int dqrm_stream_tile() { return kTile; }

extern "C" int dqrm_dma_row_update(
    void* table, int table_bf16, const void* uids, const void* uvals, long long R,
    long long U, int D, void* stream) {
  if (R <= 0 || U < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (U == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(uids);
  const float* vals = static_cast<const float*>(uvals);
  const int vec4 = D % 4 == 0 && aligned(uvals, 16) && aligned(table, table_bf16 ? 8 : 16);
  return table_bf16 ? launch_rows(static_cast<__nv_bfloat16*>(table), vec4, ids, vals, R, U, D, s)
                    : launch_rows(static_cast<float*>(table), vec4, ids, vals, R, U, D, s);
}
