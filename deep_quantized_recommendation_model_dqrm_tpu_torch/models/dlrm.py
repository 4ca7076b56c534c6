"""DLRM/DQRM as plain functions on tensors: port of the JAX package's
models/dlrm.py for plain embedding tables.

Structure (reference `DLRM_Net.forward`): bottom MLP(dense) -> per-table
pooled lookups -> pairwise dot interaction -> top MLP -> click logit. Under
QAT (the HAWQ scheme) the pooled lookups are fake-quantized with per-table
scales kept in `QuantState` and refreshed every `scale_update_period` steps,
and the MLP weights and biases are fake-quantized from their current min/max
on every forward.

`init_params` draws from the same `np.random.RandomState` stream in the same
order as the JAX package (all embedding tables, then the bottom MLP, then the
top MLP), so both packages start from bit-identical weights.

Not in this slice (each raises `NotImplementedError`): QR/MD tables and
weighted pooling (`v_W`), PACT and LSQ, the activation-quant branch and the
integer interaction, bf16 tables and `compute_dtype="bfloat16"`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    group_slots,
    make_onehot_lookup_group,
    onehot_pooled_lookup_grouped,
    onehot_pooled_lookup_grouped_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import pooled_lookup
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import (
    cat_interaction,
    dot_interaction,
)

Params = Dict[str, Any]


class Batch(NamedTuple):
    """One minibatch, in the JAX package's layout (models/dlrm.py:49-57)."""

    dense: torch.Tensor  # [B, num_dense] float32, already log1p-transformed
    indices: torch.Tensor  # [T, B, P] int32
    labels: torch.Tensor  # [B] float32 in {0, 1}
    mask: Optional[torch.Tensor] = None  # [T, B, P] float32, None => all ones


class QuantState(NamedTuple):
    """The QAT state the reference keeps in module buffers (models/dlrm.py:
    60-77 of the JAX package). `step` is a host int, so the periodic refresh
    is a Python `if` and never waits for the device."""

    emb_scales: torch.Tensor  # [T] float32, per-table pooled-output scale
    act_min: torch.Tensor  # [2] float32, activation ranges (later slice)
    act_max: torch.Tensor  # [2] float32
    step: int  # global iteration count driving the periodic refresh
    act_fixed: int  # nonzero freezes activation ranges (later slice)


def init_quant_state(
    config: DLRMConfig, device: Optional[Union[str, torch.device]] = None
) -> QuantState:
    dev = resolve_device(device)
    return QuantState(
        emb_scales=torch.ones((config.num_tables,), dtype=torch.float32, device=dev),
        act_min=torch.zeros((2,), dtype=torch.float32, device=dev),
        act_max=torch.zeros((2,), dtype=torch.float32, device=dev),
        step=0,
        act_fixed=0,
    )


def check_supported(config: DLRMConfig) -> None:
    """Raise `NotImplementedError` for what this slice of the port does not
    run, naming the slice it waits for."""
    qc = config.quant
    if any(config.table_kind(k) != "dense" for k in range(config.num_tables)):
        raise NotImplementedError("QR/MD embedding tables: a later slice of the port")
    if config.weighted_pooling is not None:
        raise NotImplementedError("weighted pooling (v_W): a later slice of the port")
    if config.table_dtype != "float32" or config.compute_dtype != "float32":
        raise NotImplementedError(
            "bf16 tables and compute_dtype='bfloat16': a later slice of the port"
        )
    if qc.enabled and qc.quant_scheme != "hawq":
        raise NotImplementedError(f"the {qc.quant_scheme} scheme: a later slice of the port")
    if qc.enabled and (qc.quantize_activation or qc.modify_feature_interaction):
        raise NotImplementedError(
            "activation quantization and the integer interaction: a later slice of the port"
        )


def init_params(
    config: DLRMConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Initialize {"emb": [table], "bot": [{"w","b"}], "top": [{"w","b"}]}.

    MLP: W ~ N(0, sqrt(2/(fan_in+fan_out))), b ~ N(0, sqrt(1/fan_out))
    (create_mlp, dlrm_s_pytorch.py:199-238). Embeddings: U(-1/sqrt(n),
    1/sqrt(n)) (create_emb, dlrm_s_pytorch.py:269-276). Each table is drawn
    on the host and moved to `device` before the next is drawn.
    """
    dev = resolve_device(device)
    if any(config.table_kind(k) != "dense" for k in range(config.num_tables)):
        raise NotImplementedError("QR/MD embedding tables: a later slice of the port")
    if config.weighted_pooling is not None:
        raise NotImplementedError("weighted pooling (v_W): a later slice of the port")
    if config.quant.enabled and config.quant.quant_scheme == "lsq":
        raise NotImplementedError("LSQ step sizes: a later slice of the port")
    rng = np.random.RandomState(seed)
    t_dtype = torch.bfloat16 if config.table_dtype == "bfloat16" else torch.float32

    def mlp(ln):
        layers = []
        for n, m in zip(ln[:-1], ln[1:]):
            w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), size=(m, n)).astype(np.float32)
            b = rng.normal(0.0, np.sqrt(1.0 / m), size=(m,)).astype(np.float32)
            layers.append({"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)})
        return layers

    emb = []
    for n in config.table_sizes:
        bound = np.sqrt(1.0 / n)
        w = rng.uniform(-bound, bound, size=(n, config.embedding_dim)).astype(np.float32)
        emb.append(torch.from_numpy(w).to(dev, t_dtype))
    return {"bot": mlp(config.mlp_bot), "top": mlp(config.mlp_top), "emb": emb}


# ---------------------------------------------------------------------------
# Quantization-state updates
# ---------------------------------------------------------------------------


def compute_emb_scales(config: DLRMConfig, params: Params) -> torch.Tensor:
    """Per-table whole-table symmetric scales [T] (the periodic min/max
    scan, quant_utils.py:141-194)."""
    return torch.stack([q.table_scale(config.quant.embedding_bit, t) for t in params["emb"]])


def update_emb_scales(config: DLRMConfig, params: Params, qstate: QuantState) -> QuantState:
    """Refresh the scales when step % period == 0 (paper section 3.2)."""
    if not config.quant.quantize_emb:
        return qstate
    if qstate.step % max(config.quant.scale_update_period, 1) != 0:
        return qstate
    with torch.no_grad():
        return qstate._replace(emb_scales=compute_emb_scales(config, params))


# ---------------------------------------------------------------------------
# MLP application
# ---------------------------------------------------------------------------


def _apply_mlp_fp(layers, x: torch.Tensor, last_linear: bool) -> torch.Tensor:
    """FP32 MLP: Linear+ReLU stacks; the last top layer emits raw logits."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"].T + layer["b"]
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


def _quant_linear_weights(layer, wbits: int, bbits: int, per_channel: bool):
    """Per-forward weight/bias scale + fake-quant (QuantLinear,
    quant_modules.py:107-135)."""
    w, b = layer["w"], layer["b"]
    if per_channel:
        w_min, w_max = w.amin(dim=1), w.amax(dim=1)
    else:
        w_min, w_max = w.min(), w.max()
    s_w = q.symmetric_quantization_params(wbits, w_min, w_max)
    return s_w, q.fake_quant(w, s_w, wbits), q.fake_quant(b, s_w, bbits)


def _apply_mlp_quant(layers, x: torch.Tensor, qc, last_linear: bool) -> torch.Tensor:
    """Weight-only QAT MLP, HAWQ scheme: linear(x, fake_quant(w),
    fake_quant(b)) with the bias sharing the weight scale."""
    n = len(layers)
    for i, layer in enumerate(layers):
        _, w_fq, b_fq = _quant_linear_weights(layer, qc.weight_bit, qc.bias_bit, qc.mlp_channelwise)
        x = x @ w_fq.T + b_fq
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def lookup_all(
    config: DLRMConfig,
    params: Params,
    indices: torch.Tensor,  # [T, B, P]
    mask: Optional[torch.Tensor],
    plain: bool = False,
) -> torch.Tensor:  # [T, B, D]
    """Raw pooled lookups of every table, differentiable through the tables.
    The tables with at most `onehot_lookup_max_rows` rows go through one
    launch of kernel K4 (its plain version with `plain=True`) per group of
    up to 32 (`group_slots`); the others through `pooled_lookup`. The JAX
    package's `full_precision` argument selects PACT's table fake-quant, a
    later slice."""
    emb = params["emb"]
    lookup = onehot_pooled_lookup_grouped_plain if plain else onehot_pooled_lookup_grouped
    small = [k for k, t in enumerate(emb) if 0 < t.shape[0] <= config.onehot_lookup_max_rows]
    outs = {}
    for ks in group_slots(small):
        pooled = lookup(make_onehot_lookup_group([emb[k] for k in ks], ks), indices, mask)
        outs.update((k, pooled[k]) for k in ks)
    for k, table in enumerate(emb):
        if k not in outs:
            outs[k] = pooled_lookup(table, indices[k], None if mask is None else mask[k]).float()
    return torch.stack([outs[k] for k in range(len(emb))])


def emb_postprocess(
    config: DLRMConfig,
    pooled: torch.Tensor,  # [T, B, D] raw pooled lookups
    qstate: QuantState,
    full_precision: bool,
) -> torch.Tensor:
    """Pooled-output fake-quant with the per-table scales (HAWQ, the DQRM
    trick: quant_modules_not_quantize_grad.py:362-395), as one elementwise
    op over the stacked tables."""
    qc = config.quant
    if not qc.enabled or full_precision or not qc.quantize_emb:
        return pooled
    return q.fake_quant(pooled, qstate.emb_scales[:, None, None], qc.embedding_bit)


def apply_emb(
    config: DLRMConfig,
    params: Params,
    indices: torch.Tensor,
    mask: Optional[torch.Tensor],
    qstate: QuantState,
    full_precision: bool,
    plain: bool = False,
) -> torch.Tensor:  # [T, B, D]
    """Pooled lookups with the optional pooled-output fake-quant."""
    pooled = lookup_all(config, params, indices, mask, plain=plain)
    return emb_postprocess(config, pooled, qstate, full_precision)


# ---------------------------------------------------------------------------
# Forward and losses
# ---------------------------------------------------------------------------


def forward(
    config: DLRMConfig,
    params: Params,
    batch: Batch,
    qstate: Optional[QuantState] = None,
    *,
    train: bool = True,
    full_precision: bool = False,
    raw_pooled: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, QuantState]:
    """The DLRM forward: (logits [B], QuantState). The FP branch mirrors
    `sequential_forward` (dlrm_s_pytorch.py:590-615), the weight-QAT branch
    the quantized forward (comm_grad.py:852-859).

    `raw_pooled` injects precomputed raw pooled lookups [T, B, D] (before
    fake-quant): the sparse train step cuts autograd there. `train` matters
    only to the activation-quant branch of a later slice."""
    check_supported(config)
    qc = config.quant
    if qstate is None:
        qstate = init_quant_state(config, batch.dense.device)
    quantizing = qc.enabled and not full_precision
    pooled = raw_pooled
    if pooled is None:
        pooled = lookup_all(config, params, batch.indices, batch.mask, plain=plain)
    ly = emb_postprocess(config, pooled, qstate, not quantizing)
    if quantizing and qc.quantize_mlp:
        def mlp(part, x, last_linear):
            return _apply_mlp_quant(params[part], x, qc, last_linear)
    else:
        def mlp(part, x, last_linear):
            return _apply_mlp_fp(params[part], x, last_linear)
    x = mlp("bot", batch.dense, False)
    z = (
        dot_interaction(x, ly, config.interact_itself)
        if config.interaction == "dot"
        else cat_interaction(x, ly)
    )
    logits = mlp("top", z, True)
    return logits.reshape(-1), qstate


def predict(
    config: DLRMConfig,
    params: Params,
    batch: Batch,
    qstate: Optional[QuantState] = None,
    full_precision: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Click probability with the reference's loss_threshold clamp
    (dlrm_s_pytorch.py:607-614)."""
    logits, _ = forward(
        config, params, batch, qstate, train=False, full_precision=full_precision, plain=plain
    )
    p = torch.sigmoid(logits)
    if 0.0 < config.loss_threshold < 1.0:
        p = torch.clamp(p, config.loss_threshold, 1.0 - config.loss_threshold)
    return p


def _bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x*y + log1p(exp(-|x|)), the JAX package's expression."""
    zero = torch.zeros_like(logits)  # torch.maximum splits the gradient at a tie, as JAX does
    return torch.maximum(logits, zero) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_loss(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean binary cross-entropy on logits (dlrm_s_pytorch.py:142-153);
    per-sample weights give the weighted mean."""
    per = _bce_terms(logits, labels)
    if weights is not None:
        return (per * weights).sum() / torch.clamp_min(weights.sum(), 1e-12)
    return per.mean()


def training_loss(config: DLRMConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """"bce" (stable BCE on logits), "mse" (MSE of the sigmoid) or "wbce"
    (weight loss_weights[y] per sample, plain mean: dlrm_s_pytorch.py:
    140-152)."""
    lf = config.loss_function
    if lf == "mse":
        return ((torch.sigmoid(logits) - labels) ** 2).mean()
    per = _bce_terms(logits, labels)
    if lf == "wbce":
        w0, w1 = config.loss_weights
        w = torch.where(labels > 0.5, torch.full_like(labels, w1), torch.full_like(labels, w0))
        return (w * per).mean()
    return per.mean()
