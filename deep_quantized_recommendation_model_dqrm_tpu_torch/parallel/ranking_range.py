"""Ranking-range mixed-bit-width policy for the embedding-gradient exchange.

Port of the JAX package's parallel/ranking_range.py, its redesign of the
reference's `grad_precision_and_scale` (sgd_quantized_gradients_parallel_
comm.py:158-255) and its consumers (:276-315, :610-624). Every step:

1. each table's gradient range (max |coalesced rows|, reduced with MAX over
   the ranks) is normalized by the table's weight scale;
2. a permutation weighted by the normalized ranges is drawn: Gumbel top-k
   on the log-weights, the noise drawn from the step count with JAX's
   `jax.random.gumbel(fold_in(PRNGKey(0x5EED), step), (T,))`, so every
   replica draws the same and no broadcast is needed;
3. by rank, the first `frac_hi` of the tables take the high-precision
   channel, the next `frac_int8` INT8, the rest are skipped this step.

The exchange ships two int8 channels, the high and low bytes of an int16
quantization (2 B a value): INT8 tables send the high byte alone, skipped
tables nothing but zeros.

The step count is a host int here, so the noise is computed on the host:
threefry-2x32 in numpy uint32 arithmetic (the counter-based,
`jax_threefry_partitionable` bits), JAX's uniform on [tiny, 1) and its
"low" Gumbel -log(-log(u)), the logs by the Cephes polynomial that XLA's
CPU backend emits for float32 log (its fused multiply-adds where XLA fuses
them), so the [T] noise vector equals JAX's bit for bit. One [T] float32
copy a step goes to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.quant import SCALE_EPS

SKIP, INT8, HI = 0, 1, 2
SEED = 0x5EED
INT16_MAX = 32767.0

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Cephes logf, as XLA's CPU backend evaluates it (llvm_ir_runtime.cc)
_LOG_P = tuple(np.float32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of counters (x0, x1) under the key (k1, k2):
    20 rounds, a key injection every 4 (jax/_src/prng.py
    `_threefry2x32_lowering`). Returns two uint32 arrays."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def step_key(step: int):
    """`jax.random.fold_in(jax.random.PRNGKey(0x5EED), step)`: the key
    (0, 0x5EED) hashing the counter pair (0, step)."""
    y0, y1 = threefry2x32(SEED >> 32, SEED & 0xFFFFFFFF, np.zeros(1, _U32),
                          np.full(1, step & 0xFFFFFFFF, _U32))
    return int(y0[0]), int(y1[0])


def random_bits(key, n: int) -> np.ndarray:
    """`jax.random.bits(key, (n,))` under partitionable threefry: the hash
    of the 64-bit counters 0..n-1 split (high, low), its two words XORed."""
    b0, b1 = threefry2x32(key[0], key[1], np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return b0 ^ b1


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def xla_log(x: np.ndarray) -> np.ndarray:
    """log of positive, finite, normal float32 values, bit for bit as XLA's
    CPU backend computes it: Cephes' range reduction to [sqrt(1/2), sqrt(2)),
    its degree-8 polynomial in three fused parts, the exponent added back
    in two pieces."""
    x = np.maximum(np.asarray(x, np.float32), np.array(0x00800000, _U32).view(np.float32))
    bits = x.view(_U32)
    e = ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(np.float32) + np.float32(1)
    m = ((bits & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)
    small = m < np.float32(0.707106781186547524)
    m1 = (m - np.float32(1)) + np.where(small, m, np.float32(0))
    e = e - np.where(small, np.float32(1), np.float32(0))
    x2 = m1 * m1
    x3 = x2 * m1
    p = _LOG_P
    y = _fma(p[0], m1, p[1])
    y1 = _fma(p[3], m1, p[4])
    y2 = _fma(p[6], m1, p[7])
    y = _fma(y, m1, p[2])
    y1 = _fma(y1, m1, p[5])
    y2 = _fma(y2, m1, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    out = (m1 - x2 * np.float32(0.5)) + y
    return out + _LOG_Q2 * e


def gumbel(step: int, n: int) -> np.ndarray:
    """`jax.random.gumbel(fold_in(PRNGKey(0x5EED), step), (n,))`, float32,
    mode "low": -log(-log(u)) with u uniform on [tiny, 1) (jax/_src/
    random.py `_uniform`, `_gumbel`)."""
    bits = random_bits(step_key(step), n)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(tiny, f * np.float32(1.0) + tiny)
    return -xla_log(-xla_log(u))


def assign_bit_widths(grad_ranges: torch.Tensor, weight_scales: torch.Tensor, step: int,
                      frac_hi: float = 0.2, frac_int8: float = 0.3) -> torch.Tensor:
    """[T] int32 modes (SKIP, INT8, HI) from the all-reduced ranges [T] and
    the tables' weight scales [T] at host step `step`: the tables ordered by
    log(range / scale) + Gumbel noise, descending (a stable sort), the first
    round(frac_hi T) HI, the next round(frac_int8 T) INT8."""
    T = grad_ranges.shape[0]
    dev = grad_ranges.device
    norm = grad_ranges / torch.clamp_min(weight_scales, 1e-12)
    logw = torch.log(torch.clamp_min(norm, 1e-30))
    noise = torch.from_numpy(gumbel(step, T)).to(dev, non_blocking=True)
    order = torch.sort(-(logw + noise), stable=True).indices
    ranks = torch.empty_like(order).scatter_(0, order, torch.arange(T, device=dev))
    n_hi = max(int(round(frac_hi * T)), 0)
    n_int8 = max(int(round(frac_int8 * T)), 0)
    return torch.where(ranks < n_hi, HI, torch.where(ranks < n_hi + n_int8, INT8, SKIP)).to(torch.int32)


def grad_scale_int16(grad_range: torch.Tensor) -> torch.Tensor:
    """The scale that puts the all-reduced range on the int16 grid: max(range,
    1e-8) times the float32 reciprocal of 32767, as the compiled JAX step
    computes the quotient by a constant."""
    return torch.clamp_min(grad_range, SCALE_EPS) * float(np.float32(1.0) / np.float32(INT16_MAX))


def encode_two_channel(vals: torch.Tensor, scale: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Rows [..., K, D] on the int16 grid, split into high and low int8
    bytes: [..., K, 2D] (high || low). `scale` and `mode` broadcast against
    `vals` (one per table). INT8 zeroes the low byte, SKIP both."""
    q16 = torch.clamp(torch.round(vals / scale), -INT16_MAX, INT16_MAX).to(torch.int32)
    hi = (q16 >> 8).to(torch.int8)
    lo = (q16 & 0xFF).to(torch.uint8).view(torch.int8)
    lo = torch.where(mode == HI, lo, torch.zeros_like(lo))
    hi = torch.where(mode == SKIP, torch.zeros_like(hi), hi)
    return torch.cat([hi, lo], dim=-1)


def decode_two_channel(enc: torch.Tensor, scale: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """[..., K, 2D] int8 -> [..., K, D] float32: (high << 8 | low) * scale,
    0 for a skipped table."""
    d = enc.shape[-1] // 2
    q16 = (enc[..., :d].to(torch.int32) << 8) | (enc[..., d:].to(torch.int32) & 0xFF)
    out = q16.to(torch.float32) * scale
    return torch.where(mode == SKIP, torch.zeros_like(out), out)
