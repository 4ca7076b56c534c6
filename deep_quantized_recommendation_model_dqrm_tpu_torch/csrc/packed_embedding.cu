// Packed gather + dequantize + sum-pool over an INT4/INT8 embedding table.
//
// Replaces the TPU kernel `packed_pooled_lookup_pallas` (kernel
// `_hbm_lookup_kernel`) in
// deep_quantized_recommendation_model_dqrm_tpu/ops/pallas/packed_embedding.py,
// extended to what that package's plain path `packed_pooled_lookup` also
// covers, so one kernel serves every table: the symmetric per-table format
// and the rowwise (scale, bias) format, 4 and 8 bits, and an optional
// [B, P] bag mask.
//
// Contract (the JAX op order): for each bag b and value d,
//   out[b, d] = sum_{p = 0..P-1 in order} (v(r, d) * s  [+ bias[r]]) * mask[b, p]
// with r = clamp(idx[b, p], 0, rows - 1), v the unpacked integer (minus
// 2^(bits-1) for symmetric tables), s the table scale or scale[r].
// INT4 layout: byte j holds value j in its low nibble and value j + D/2 in
// its high nibble.
//
// What bounds it on this card: bytes. Each lookup reads one packed row of
// D/2 (INT4) or D (INT8) bytes at a random address, which costs a whole
// 32-byte sector of device memory, and writes D floats of pooled output.
// At the serving shape (26 tables, B = 16384, P = 1, INT4, D = 16) one batch
// moves about 42.6 MB, some 13 us at 3.35 TB/s; with one launch per table,
// launch overhead is of the same order.
//
// Design: the TPU kernel fetched 8-row groups by DMA into VMEM because its
// compiler had no dynamic sublane reads; none of that applies here. One
// thread per (bag, packed byte): the threads of a bag read neighbouring bytes
// of one row (one sector), unpack both nibbles, and keep two running sums in
// registers, so the pooled sum never leaves the chip until its one write.
// The per-table scale is read from device memory (no host sync). Products
// and sums use the _rn intrinsics so that nvcc does not contract them into
// FMAs: the result then matches the plain PyTorch version exactly for P = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BITS, bool ROWWISE>
__global__ void packed_pooled_lookup_kernel(
    const uint8_t* __restrict__ data,   // [rows, Dp]
    const int32_t* __restrict__ idx,    // [B, P]
    const float* __restrict__ mask,     // [B, P] or null
    const float* __restrict__ scale,    // [1] symmetric or [rows] rowwise
    const float* __restrict__ bias,     // [rows] rowwise, else null
    float* __restrict__ out,            // [B, D]
    int64_t rows, int B, int P, int Dp, int D) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * Dp) return;
  const int64_t b = t / Dp;
  const int j = (int)(t - b * Dp);
  const int offset = ROWWISE ? 0 : (1 << (BITS - 1));
  const float table_scale = ROWWISE ? 0.0f : __ldg(scale);
  float acc_lo = 0.0f;
  float acc_hi = 0.0f;
  for (int p = 0; p < P; ++p) {
    int64_t r = __ldg(idx + b * P + p);
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    const int byte = __ldg(data + r * Dp + j);
    const float s = ROWWISE ? __ldg(scale + r) : table_scale;
    const float m = mask ? __ldg(mask + b * P + p) : 1.0f;
    const int q_lo = BITS == 4 ? (byte & 0xF) : byte;
    float v_lo = __fmul_rn((float)(q_lo - offset), s);
    if (ROWWISE) v_lo = __fadd_rn(v_lo, __ldg(bias + r));
    acc_lo = __fadd_rn(acc_lo, __fmul_rn(v_lo, m));
    if (BITS == 4) {
      float v_hi = __fmul_rn((float)((byte >> 4) - offset), s);
      if (ROWWISE) v_hi = __fadd_rn(v_hi, __ldg(bias + r));
      acc_hi = __fadd_rn(acc_hi, __fmul_rn(v_hi, m));
    }
  }
  out[b * D + j] = acc_lo;
  if (BITS == 4) out[b * D + j + Dp] = acc_hi;
}

template <int BITS, bool ROWWISE>
void launch(const uint8_t* data, const int32_t* idx, const float* mask,
            const float* scale, const float* bias, float* out, int64_t rows,
            int B, int P, int D, cudaStream_t stream) {
  const int Dp = BITS == 4 ? D / 2 : D;
  const int threads = 256;
  const int64_t blocks = ((int64_t)B * Dp + threads - 1) / threads;
  packed_pooled_lookup_kernel<BITS, ROWWISE><<<(unsigned)blocks, threads, 0, stream>>>(
      data, idx, mask, scale, bias, out, rows, B, P, Dp, D);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int dqrm_packed_pooled_lookup(
    const void* data, const void* idx, const void* mask, const void* scale,
    const void* bias, void* out, long long rows, int B, int P, int D,
    int bits, void* stream) {
  if (B <= 0 || P <= 0 || rows <= 0 || (bits != 4 && bits != 8) ||
      (bits == 4 && D % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* m = static_cast<const float*>(mask);
  const float* s = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4 && bb == nullptr) launch<4, false>(d, i, m, s, bb, o, rows, B, P, D, st);
  if (bits == 4 && bb != nullptr) launch<4, true>(d, i, m, s, bb, o, rows, B, P, D, st);
  if (bits == 8 && bb == nullptr) launch<8, false>(d, i, m, s, bb, o, rows, B, P, D, st);
  if (bits == 8 && bb != nullptr) launch<8, true>(d, i, m, s, bb, o, rows, B, P, D, st);
  return (int)cudaGetLastError();
}
