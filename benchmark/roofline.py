"""Peaks of the card and the operations and bytes of the measured work.

The yardstick of the benchmark: every roofline share and `mfu` reading is
a least time from these counts over a measured time. The counts come from
shapes alone (a configuration file's sizes and a batch's ids), never from
the program. Each input byte is counted read once and each output byte
written once, whatever a kernel reads again; the program's intermediates
(fake-quant copies, gradients, padding) are not counted.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates): 989 TFLOP/s on the tensor cores, the highest rate any
float32-accurate path can use (three bf16 passes still count their
product's operations once), and 3.35 TB/s of device memory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

TENSOR_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32  # bytes the memory system moves for one random read
F32 = 4
ID = 4


def least_s(flop: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, which bound binds) of work of `flop` operations and
    `nbytes` bytes."""
    t_ops, t_bytes = flop / TENSOR_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_layers(model: dict) -> list:
    """(in, out) of every bottom and top layer."""
    bot, top = model["mlp_bot"], model["mlp_top"]
    return list(zip(bot[:-1], bot[1:])) + list(zip(top[:-1], top[1:]))


def interaction_flop(model: dict, rows: int) -> int:
    """The dot interaction's Gram matrices, forward: 2 F^2 d per row."""
    f = len(model["table_sizes"]) + 1
    return 2 * rows * f * f * model["embedding_dim"]


def train_steps(model: dict, quant: dict, batch: int, steps: int, touched_rows: int) -> dict:
    """`steps` sparse QAT SGD steps at `batch` rows that touch `touched_rows`
    table rows, counted distinct within each step and table. After
    chip_smoke.py's `train_step_bound` (SGD parts), counting only what a
    step must move: operations of the MLPs' forward and both gradients and
    of the interaction's forward and backward (3 x forward each), at the
    tensor-core peak; bytes of the MLP weights read and written, the touched
    rows read and written, the batch read, each once a step, and the scale
    refresh (every table read once) spread over its period. Fake-quant
    copies and gradients are the program's intermediates and not counted."""
    layers = mlp_layers(model)
    n_w = sum(i * o + o for i, o in layers)
    d = model["embedding_dim"]
    sizes = model["table_sizes"]
    flop = steps * (3 * 2 * batch * sum(i * o for i, o in layers) + 3 * interaction_flop(model, batch))
    parts = {
        "mlp_bytes": steps * 2 * F32 * n_w,
        "table_rows_bytes": 2 * touched_rows * d * F32,
        "batch_bytes": steps * batch * (model["mlp_bot"][0] + len(sizes) + 1) * F32,
        "scale_refresh_bytes": steps * sum(sizes) * d * F32 / quant["scale_update_period"],
    }
    nbytes = sum(parts.values())
    seconds, by = least_s(flop, nbytes)
    return {"least_s": seconds, "bound_by": by, "flop": flop, "bytes": nbytes, **parts}


def distinct_rows(indices: torch.Tensor) -> torch.Tensor:
    """Distinct ids of each batch and table, summed over the tables: [n]
    from indices [n, T, B]."""
    s = indices.sort(dim=-1).values
    return (s[..., 1:] != s[..., :-1]).sum(-1).add_(1).sum(-1)


def k1_step(model: dict, train: dict, batch: int) -> dict:
    """K1 (`dense_grad_grouped_kernel`, one launch a step for the tables of
    at most `onehot_update_max_rows` rows). Copied from chip_smoke.py's
    `phase_kernel_k1` bound: the flat gradient written once, each table's
    slot of the pooled gradient and its ids read once."""
    d = model["embedding_dim"]
    small = [n for n in model["table_sizes"] if n <= train["onehot_update_max_rows"]]
    nbytes = sum(small) * d * F32 + len(small) * batch * (d * F32 + ID)
    seconds, by = least_s(0, nbytes)
    return {"least_s": seconds, "bound_by": by, "bytes": nbytes}


def packed_row_bytes(model: dict, emb_bits: int) -> int:
    return model["embedding_dim"] * emb_bits // 8


def packed_sector_bytes(model: dict, emb_bits: int, ids: torch.Tensor) -> int:
    """Bytes of the distinct packed-row sectors that ids [T, B, P] read, a
    sector each, and each table's scale."""
    dp = packed_row_bytes(model, emb_bits)
    nbytes = 0
    for k, n in enumerate(model["table_sizes"]):
        r = ids[k].long().clamp(0, n - 1).reshape(-1)
        nbytes += torch.unique(r * dp // SECTOR).numel() * SECTOR + F32
    return nbytes


def k2_batch(model: dict, emb_bits: int, ids: torch.Tensor) -> dict:
    """K2 (`packed_pooled_lookup_kernel`, one launch a batch for every
    packed table) on one batch of ids [T, B, P]. Copied from chip_smoke.py's
    `k2_bytes` (symmetric tables): a sector per distinct packed-row sector
    read, each table's scale, the ids and the pooled float32 output, each
    once."""
    T, B, P = ids.shape
    nbytes = packed_sector_bytes(model, emb_bits, ids) + ids.numel() * ID + T * B * model["embedding_dim"] * F32
    seconds, by = least_s(0, nbytes)
    return {"least_s": seconds, "bound_by": by, "bytes": nbytes}


def k3_layer(m: int, k: int, n: int) -> dict:
    """K3 (`int8_linear_tc_kernel`) on one layer: [m, k] float32 activations
    times int8 [n, k] weights with per-channel scales and a bias. Copied
    from chip_smoke.py's `phase_kernel_k3` count (activations, weights,
    scales and bias read once, the output written once), with its
    operations counted once at the tensor-core peak."""
    flop = 2 * m * k * n
    nbytes = m * k * F32 + k * n + 2 * n * F32 + m * n * F32
    seconds, by = least_s(flop, nbytes)
    return {"least_s": seconds, "bound_by": by, "flop": flop, "bytes": nbytes}


def k3_batch(model: dict, rows: int) -> dict:
    """K3's launches of one serving batch of `rows` (padded) rows: every
    bottom and top layer."""
    out = {"least_s": 0.0, "flop": 0, "bytes": 0, "launches": 0}
    for i, o in mlp_layers(model):
        one = k3_layer(rows, i, o)
        out["least_s"] += one["least_s"]
        out["flop"] += one["flop"]
        out["bytes"] += one["bytes"]
        out["launches"] += 1
    return out


def serve_batches(model: dict, serve: dict, batches) -> dict:
    """The least time to answer device batches of useful rows, each given
    by its ids [T, rows, P]: operations of the MLPs and the interaction,
    forward; bytes of the inputs (dense features and ids), the distinct
    packed-row sectors (`packed_sector_bytes`), the click probabilities,
    and the MLP weights (int8, per-channel scales, bias) once a batch."""
    layers = mlp_layers(model)
    weights = sum(i * o * serve["mlp_bits"] // 8 + 2 * o * F32 for i, o in layers)
    per_row = model["mlp_bot"][0] * F32 + len(model["table_sizes"]) * ID + F32
    flop = nbytes = 0
    for ids in batches:
        rows = ids.shape[1]
        flop += 2 * rows * sum(i * o for i, o in layers) + interaction_flop(model, rows)
        nbytes += rows * per_row + packed_sector_bytes(model, serve["emb_bits"], ids) + weights
    seconds, by = least_s(flop, nbytes)
    return {"least_s": seconds, "bound_by": by, "flop": flop, "bytes": nbytes}


def share(least_s: float, measured_s: float) -> float:
    """A least time over a measured time, in percent."""
    return 100.0 * least_s / measured_s


def kernel_device_s(device_ops: Sequence[tuple], pattern: str) -> Tuple[float, int]:
    """(device seconds, launches) of the device operations whose name holds
    `pattern`: (name, start_us, end_us) tuples from a trace."""
    hits = [(e - s) for name, s, e in device_ops if pattern in name]
    return sum(hits) / 1e6, len(hits)
