// Packed gather + dequantize + sum-pool over INT4/INT8 embedding tables, all
// the tables of a serving batch in one launch.
//
// Replaces the TPU kernel `packed_pooled_lookup_pallas` (kernel
// `_hbm_lookup_kernel`) in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/packed_embedding.py,
// extended to what that package's plain path `packed_pooled_lookup` also
// covers, so one kernel serves every table: the symmetric per-table format
// and the rowwise (scale, bias) format, 4 and 8 bits, and an optional
// [B, P] bag mask.
//
// Contract (the JAX op order), per table of the group: for each bag b and
// value d,
//   out_t[b, d] = sum_{p = 0..P-1 in order} (v(r, d) * s  [+ bias[r]]) * mask[slot, b, p]
// with r = clamp(idx[slot, b, p], 0, rows - 1), v the unpacked integer (minus
// 2^(bits-1) for symmetric tables), s the table scale or scale[r]; `slot` is
// the table's place in the [T, B, P] ids and mask, and out_t the [B, D_t]
// block at float offset col * B of the output (col = slot * D for a
// [T, B, D] output; the serving model's QR/MD members pass their own
// columns and widths, so one launch serves tables of any D). INT4 layout:
// byte j holds value j in its low nibble and value j + D/2 in its high
// nibble.
//
// What bounds it on this card: bytes. Each lookup reads one packed row of
// D/2 (INT4) or D (INT8) bytes at a random address, which costs a whole
// 32-byte sector of device memory, and writes D floats of pooled output.
// At the serving shape (26 tables, B = 16384, P = 1, INT4, D = 16) one batch
// moves about 33 MB, some 10 us at 3.35 TB/s. One launch per table (26 of
// about 2.7 us each, mostly start-up and tail) cost 7x that, and a stack of
// the 26 outputs on top.
//
// Design: the TPU kernel fetched 8-row groups by DMA into VMEM because its
// compiler had no dynamic sublane reads; none of that applies here.
// - One launch for a group of tables: blockIdx.y is the table, whose
//   descriptor (data, scale and bias pointers, rows, bits, D, slot) sits in
//   a small device array built once by the caller, so the format branches
//   are uniform within a block. The per-table entry is the same kernel with
//   one table, its descriptor passed by value.
// - Each thread owns whole packed rows (8-byte chunks of a row: an INT4
//   row of D = 16 is one chunk): one 8-byte load per row, unpacked in
//   registers, the sums written as 16-byte stores straight into the
//   [T, B, D] output that the interaction reads. Rows of other widths
//   than a multiple of 8 bytes take a byte-per-thread path.
// - Latency: the random row reads in flight are what bounds the time, so
//   one bag per thread, for full occupancy. Pooling several bags per
//   thread with all their row loads issued first needs many more registers
//   and was slower on the H100 (PERF.md has the times).
// - Products and sums use the _rn intrinsics so that nvcc does not contract
//   them into FMAs: the result then matches the plain PyTorch version
//   exactly for P = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct TableDesc {  // 8 x int64, the layout of the wrapper's descriptor rows
  const uint8_t* data;  // [rows, Dp]
  const float* scale;   // [1] symmetric or [rows] rowwise
  const float* bias;    // [rows] rowwise, else null
  long long rows;
  long long bits;
  long long dim;        // D
  long long slot;
  long long col;        // the output block [B, dim] starts at out + col * B
};

constexpr int kThreads = 256;

// One work item per thread: W packed bytes (W = 8 or 1) of bag `item /
// chunks`'s rows in table d, pooled over P.
template <int BITS, bool ROWWISE, int W>
__device__ __forceinline__ void pool_rows(const TableDesc& d, const int32_t* __restrict__ idx,
                                          const float* __restrict__ mask,
                                          float* __restrict__ out, int B, int P, int64_t item) {
  const int D = (int)d.dim;
  const int Dp = BITS == 4 ? D / 2 : D;
  const int chunks = Dp / W;
  if (item >= (int64_t)B * chunks) return;
  const int64_t bag = item / chunks;
  const int chunk = (int)(item - bag * chunks);
  const int offset = ROWWISE ? 0 : (1 << (BITS - 1));
  const float table_scale = ROWWISE ? 0.0f : __ldg(d.scale);
  constexpr int V = BITS == 4 ? 2 * W : W;  // values per item
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int p = 0; p < P; ++p) {
    int64_t r = __ldg(idx + bag * P + p);
    r = r < 0 ? 0 : (r >= d.rows ? d.rows - 1 : r);
    const uint8_t* src = d.data + r * Dp + (int64_t)chunk * W;
    uint64_t raw;
    if constexpr (W == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      raw = (uint64_t)v.x | ((uint64_t)v.y << 32);
    } else {
      raw = __ldg(src);
    }
    const float s = ROWWISE ? __ldg(d.scale + r) : table_scale;
    const float bb = ROWWISE ? __ldg(d.bias + r) : 0.0f;
    const float m = mask ? __ldg(mask + bag * P + p) : 1.0f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int byte = (int)((raw >> (8 * e)) & 0xFF);
      const int q_lo = BITS == 4 ? (byte & 0xF) : byte;
      float v_lo = __fmul_rn((float)(q_lo - offset), s);
      if (ROWWISE) v_lo = __fadd_rn(v_lo, bb);
      acc[e] = __fadd_rn(acc[e], __fmul_rn(v_lo, m));
      if constexpr (BITS == 4) {
        float v_hi = __fmul_rn((float)((byte >> 4) - offset), s);
        if (ROWWISE) v_hi = __fadd_rn(v_hi, bb);
        acc[W + e] = __fadd_rn(acc[W + e], __fmul_rn(v_hi, m));
      }
    }
  }
  float* o = out + bag * D + (int64_t)chunk * W;
  if constexpr (W == 8) {  // 16-byte stores: D is a multiple of 8 (INT8) or 16 (INT4)
#pragma unroll
    for (int h = 0; h < V / 8; ++h) {
      float* dst = o + h * Dp;  // the high nibbles' values start D/2 further on
      const float* a = acc + 8 * h;
      reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
  } else {
    o[0] = acc[0];
    if constexpr (BITS == 4) o[Dp] = acc[1];
  }
}

template <int BITS, bool ROWWISE>
__device__ __forceinline__ void pool_table(const TableDesc& d, const int32_t* idx,
                                           const float* mask, float* out, int B, int P) {
  const int Dp = BITS == 4 ? (int)d.dim / 2 : (int)d.dim;
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (Dp % 8 == 0) {  // the wrapper checks that such rows are 8-byte aligned
    pool_rows<BITS, ROWWISE, 8>(d, idx, mask, out, B, P, item);
  } else {
    pool_rows<BITS, ROWWISE, 1>(d, idx, mask, out, B, P, item);
  }
}

// blockIdx.y picks the table: descs[blockIdx.y], or `one` when descs is null.
__global__ void __launch_bounds__(kThreads) packed_pooled_lookup_kernel(
    const TableDesc* __restrict__ descs, TableDesc one,
    const int32_t* __restrict__ idx,  // [T, B, P]
    const float* __restrict__ mask,   // [T, B, P] or null
    float* __restrict__ out,          // [T, B, D]
    int B, int P) {
  const TableDesc d = descs ? descs[blockIdx.y] : one;
  const int64_t bp = (int64_t)B * P;
  const int32_t* ids = idx + d.slot * bp;
  const float* msk = mask ? mask + d.slot * bp : nullptr;
  float* o = out + d.col * B;
  if (d.bits == 4) {
    if (d.bias) {
      pool_table<4, true>(d, ids, msk, o, B, P);
    } else {
      pool_table<4, false>(d, ids, msk, o, B, P);
    }
  } else if (d.bias) {
    pool_table<8, true>(d, ids, msk, o, B, P);
  } else {
    pool_table<8, false>(d, ids, msk, o, B, P);
  }
}

int launch(const TableDesc* descs, const TableDesc& one, int tables, const void* idx,
           const void* mask, void* out, int B, int P, int max_items_per_bag,
           cudaStream_t stream) {
  const int64_t blocks = ((int64_t)B * max_items_per_bag + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, (unsigned)tables);
  packed_pooled_lookup_kernel<<<grid, kThreads, 0, stream>>>(
      descs, one, static_cast<const int32_t*>(idx), static_cast<const float*>(mask),
      static_cast<float*>(out), B, P);
  return (int)cudaGetLastError();
}

// Work items per bag of a table: its 8-byte row chunks, or its bytes.
int items_per_bag(long long bits, long long dim) {
  const long long dp = bits == 4 ? dim / 2 : dim;
  return (int)(dp % 8 == 0 ? dp / 8 : dp);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for arguments the kernel does not take).

// One table: idx [B, P], mask [B, P] or null, out [B, D].
extern "C" int dqrm_packed_pooled_lookup(
    const void* data, const void* idx, const void* mask, const void* scale,
    const void* bias, void* out, long long rows, int B, int P, int D,
    int bits, void* stream) {
  if (B <= 0 || P <= 0 || rows <= 0 || D <= 0 || (bits != 4 && bits != 8) ||
      (bits == 4 && D % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  TableDesc one = {static_cast<const uint8_t*>(data), static_cast<const float*>(scale),
                   static_cast<const float*>(bias), rows, bits, D, 0, 0};  // slot 0, col 0
  return launch(nullptr, one, 1, idx, mask, out, B, P, items_per_bag(bits, D),
                static_cast<cudaStream_t>(stream));
}

// A group of `tables` tables described by `descs` (device memory, one
// TableDesc each, checked by the caller): idx [T, B, P], mask [T, B, P] or
// null, out holding every table's [B, D] block at col * B (the caller checks
// that the blocks of the 16-byte-store path start 16-byte aligned), T above
// every slot. `max_items_per_bag` is the largest items_per_bag of the
// group's tables.
extern "C" int dqrm_packed_pooled_lookup_grouped(
    const void* descs, int tables, const void* idx, const void* mask, void* out, int B, int P,
    int max_items_per_bag, void* stream) {
  if (descs == nullptr || tables <= 0 || B <= 0 || P <= 0 || max_items_per_bag <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const TableDesc none = {nullptr, nullptr, nullptr, 0, 0, 0, 0, 0};
  return launch(static_cast<const TableDesc*>(descs), none, tables, idx, mask, out, B, P,
                max_items_per_bag, static_cast<cudaStream_t>(stream));
}
