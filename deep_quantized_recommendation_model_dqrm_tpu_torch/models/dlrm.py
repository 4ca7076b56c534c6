"""DLRM/DQRM as plain functions on tensors: port of the JAX package's
models/dlrm.py.

Structure (reference `DLRM_Net.forward`): bottom MLP(dense) -> per-table
pooled lookups -> pairwise dot interaction -> top MLP -> click logit. Under
`interaction="dcn"` (MLPerf Training's DLRM-DCNv2, torchrec's `DLRM_DCN`)
the bottom output and the pooled lookups are concatenated and pass a
low-rank cross network (`params["cross"]`, `ops.interaction.low_rank_cross`)
before the top MLP; its weights take the MLP's weight fake-quant. With
`multi_hot_sizes` each table pools a bag of its own fixed width, the ids of
a batch one [B, S] tensor (`bags`). QAT
(reference QAT forward, dlrm_s_pytorch_comm_grad.py:809-895) under one of
the paper's three schemes:

- HAWQ (the DQRM default): the pooled lookups are fake-quantized with
  per-table scales kept in `QuantState` and refreshed every
  `scale_update_period` steps; the MLP weights and biases from their current
  min/max on every forward;
- PACT: the DoReFa transform of the table rows before the pooling and of the
  MLP weights and biases;
- LSQ: learned step sizes (`params["lsq_emb"]`, `params["lsq_mlp"]`) for the
  pooled lookups and the MLP.

With `quantize_activation` (HAWQ only) an input QuantAct starts the integer
MLP chain, whose scales pass from layer to layer, and a second QuantAct
follows the interaction, optionally the INT16 integer one; their running
ranges live in `QuantState`.

Embedding tables are float32 or bfloat16 ([rows, D] tensors), or the
compositional tricks as dicts: QR {"q", "r"} and MD {"table"[, "proj"]}
(models/tricks.py), looked up at full precision under every scheme. With
`weighted_pooling` each table has a per-row pooling weight
(`params["v_W"]`, ones at init; "fixed" keeps them constant, "learned"
trains them) that multiplies the bag mask. `compute_dtype="bfloat16"` runs
the MLP and dot-interaction products on bf16 operands with float32 sums
(`ops/matmul.py`); the integer-activation chain stays float32.

`init_params` draws from the same `np.random.RandomState` stream in the same
order as the JAX package (all embedding tables, then the bottom MLP, then the
top MLP), so both packages start from bit-identical weights.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import tricks
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    bag_of,
    group_slots,
    make_onehot_lookup_group,
    onehot_pooled_lookup_grouped,
    onehot_pooled_lookup_grouped_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.qat_dense import (
    fake_quant_dense,
    fake_quant_dense_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import clamp_ids, pooled_lookup
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import (
    cat_interaction,
    dot_interaction,
    low_rank_cross,
    quantized_dot_interaction,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.matmul import linear
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.profiling import annotate

Params = Dict[str, Any]


class Batch(NamedTuple):
    """One minibatch, in the JAX package's layout (models/dlrm.py:49-57)."""

    dense: torch.Tensor  # [B, num_dense] float32, already log1p-transformed
    # [T, B, P] int32; under `multi_hot_sizes` [B, S] int32, S the widths'
    # sum, table k's bag in the columns `config.bags()` gives (`bags`)
    indices: torch.Tensor
    labels: torch.Tensor  # [B] float32 in {0, 1}
    mask: Optional[torch.Tensor] = None  # [T, B, P] float32, None => all ones (always None for [B, S])


class QuantState(NamedTuple):
    """The QAT state the reference keeps in module buffers (models/dlrm.py:
    60-77 of the JAX package). `step` is a host int, so the periodic refresh
    is a Python `if` and never waits for the device."""

    emb_scales: torch.Tensor  # [T] float32, per-table pooled-output scale
    # running ranges of the two QuantActs: [0] the dense input, [1] the
    # interaction output (comm_grad.py:522-523)
    act_min: torch.Tensor  # [2] float32
    act_max: torch.Tensor  # [2] float32
    step: int  # global iteration count driving the periodic refresh
    act_fixed: int  # nonzero freezes the activation ranges in train mode too


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


def freeze_ranges(qstate: QuantState) -> QuantState:
    """freeze_model (quant_modules.py:1071-1090): fix the activation ranges."""
    return qstate._replace(act_fixed=1)


def unfreeze_ranges(qstate: QuantState) -> QuantState:
    """unfreeze_model (quant_modules.py:1093-1112)."""
    return qstate._replace(act_fixed=0)


def trick_slots(config: DLRMConfig) -> Tuple[int, ...]:
    """The tables that are QR or MD dicts."""
    return tuple(k for k in range(config.num_tables) if config.table_kind(k) != "dense")


def init_params(
    config: DLRMConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    draw: bool = True,
) -> Params:
    """Initialize {"emb": [table], "bot": [{"w","b"}], "top": [{"w","b"}]},
    with `weighted_pooling` also "v_W" (ones, one [rows] float32 vector per
    table), under LSQ also the step sizes "lsq_emb" and "lsq_mlp".

    MLP: W ~ N(0, sqrt(2/(fan_in+fan_out))), b ~ N(0, sqrt(1/fan_out))
    (create_mlp, dlrm_s_pytorch.py:199-238). Embeddings: U(-1/sqrt(n),
    1/sqrt(n)) (create_emb, dlrm_s_pytorch.py:269-276), in `table_dtype`;
    QR tables draw q then r, MD tables the table then the projection
    (float32), from the one stream (JAX dlrm.py:134-193). Each table is
    drawn on the host and moved to `device` before the next is drawn. LSQ
    steps take no draw: s0 = 2 mean|w| / sqrt(Qp) (quantizer/lsq.py:42-45),
    one 0-d step per table at `embedding_bit` (1.0 for a QR/MD table, which
    LSQ does not quantize), and with `quantize_mlp` a per-out-channel weight
    step and a 0-d bias step per layer at `weight_bit` (QuantLinearLSQ,
    quant_learned_step_size_quan.py:32-57).

    Under `interaction="dcn"` also "cross": per cross layer {"v" [r, F],
    "w" [F, r], "b" [F]} (F the concatenation's width, r the rank): V and W
    Xavier-normal, N(0, sqrt(2 / (F + r))), and b zeros, as torchrec's
    `LowRankCrossNet` draws them; drawn after the top MLP, layer by layer,
    V then W, so the other leaves keep their draws.

    `draw=False` gives the same structure, shapes and dtypes with nothing
    drawn (uninitialized values): a template for a checkpoint that
    replaces every leaf.
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    t_dtype = torch.bfloat16 if config.table_dtype == "bfloat16" else torch.float32

    def mlp(ln):
        layers = []
        for n, m in zip(ln[:-1], ln[1:]):
            if not draw:
                layers.append({"w": torch.empty((m, n), device=dev), "b": torch.empty((m,), device=dev)})
                continue
            w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), size=(m, n)).astype(np.float32)
            b = rng.normal(0.0, np.sqrt(1.0 / m), size=(m,)).astype(np.float32)
            layers.append({"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)})
        return layers

    def uniform(bound, shape, dtype=t_dtype):
        if not draw:
            return torch.empty(shape, dtype=dtype, device=dev)
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape).astype(np.float32)).to(dev, dtype)

    emb = []
    md_dims = config.md_dims()
    d = config.embedding_dim
    for k, n in enumerate(config.table_sizes):
        bound = np.sqrt(1.0 / n)
        kind = config.table_kind(k)
        if kind == "qr":
            c = config.qr_collisions
            d_q = d // 2 if config.qr_operation == "concat" else d
            emb.append({"q": uniform(bound, ((n + c - 1) // c, d_q)),
                        "r": uniform(bound, (c, d - d_q if config.qr_operation == "concat" else d))})
        elif kind == "md":
            entry = {"table": uniform(bound, (n, md_dims[k]))}
            if md_dims[k] < d:
                lim = np.sqrt(6.0 / (md_dims[k] + d))
                entry["proj"] = uniform(lim, (d, md_dims[k]), torch.float32)
            emb.append(entry)
        else:
            emb.append(uniform(bound, (n, d)))
    params: Params = {"bot": mlp(config.mlp_bot), "top": mlp(config.mlp_top), "emb": emb}
    if config.interaction == "dcn":
        f, r = config.top_input_dim, config.dcn_low_rank_dim

        def xavier(shape):
            if not draw:
                return torch.empty(shape, device=dev)
            std = np.sqrt(2.0 / (f + r))
            return torch.from_numpy(rng.normal(0.0, std, size=shape).astype(np.float32)).to(dev)

        params["cross"] = []
        for _ in range(config.dcn_num_layers):
            v = xavier((r, f))
            params["cross"].append({"v": v, "w": xavier((f, r)),
                                    "b": torch.zeros((f,), dtype=torch.float32, device=dev)})
    if config.weighted_pooling is not None:
        params["v_W"] = [torch.ones((n,), dtype=torch.float32, device=dev) for n in config.table_sizes]
    return {**params, **init_lsq_steps(config, params)}


def init_lsq_steps(config: DLRMConfig, params: Params) -> Params:
    """LSQ's initial step sizes for `params` ({} unless the config is LSQ):
    "lsq_emb", and with `quantize_mlp` "lsq_mlp" (see `init_params`)."""
    qc = config.quant
    if not (qc.enabled and qc.quant_scheme == "lsq"):
        return {}
    out: Params = {"lsq_emb": [
        _lsq_init(t.float().abs().mean(), qc.embedding_bit) if not isinstance(t, dict)
        else torch.ones((), dtype=torch.float32, device=params["bot"][0]["w"].device)
        for t in params["emb"]]}
    if qc.quantize_mlp:
        out["lsq_mlp"] = {
            part: [{"w": _lsq_init(l["w"].abs().mean(dim=1), qc.weight_bit),
                    "b": _lsq_init(l["b"].abs().mean(), qc.weight_bit)} for l in params[part]]
            for part in ("bot", "top")
        }
    return out


def _lsq_init(mean_abs: torch.Tensor, bits: int) -> torch.Tensor:
    """2 mean|w| / sqrt(Qp), divided by sqrt(Qp) rounded to float32, as the
    JAX package computes it."""
    root = float(np.float32(np.sqrt(2 ** (bits - 1) - 1)))
    return q.divide(2.0 * mean_abs, root)


# ---------------------------------------------------------------------------
# Quantization-state updates
# ---------------------------------------------------------------------------


def compute_emb_scales(config: DLRMConfig, params: Params) -> torch.Tensor:
    """Per-table whole-table symmetric scales [T] (the periodic min/max
    scan, quant_utils.py:141-194), each reduced in its table's dtype; a
    QR/MD table, which stays in full precision, gets the placeholder 1.0."""
    dev = params["bot"][0]["w"].device
    return torch.stack([
        torch.ones((), dtype=torch.float32, device=dev) if isinstance(t, dict)
        else q.table_scale(config.quant.embedding_bit, t) for t in params["emb"]])


def emb_scales_due(config: DLRMConfig, qstate: QuantState) -> bool:
    """Whether `update_emb_scales` refreshes the scales at this step:
    quantized tables and step % period == 0 (paper section 3.2)."""
    return config.quant.quantize_emb and qstate.step % max(config.quant.scale_update_period, 1) == 0


def update_emb_scales(config: DLRMConfig, params: Params, qstate: QuantState) -> QuantState:
    """Refresh the scales where `emb_scales_due`."""
    if not emb_scales_due(config, qstate):
        return qstate
    with torch.no_grad():
        return qstate._replace(emb_scales=compute_emb_scales(config, params))


def _quant_act(
    x: torch.Tensor,
    bits: int,
    x_min: torch.Tensor,
    x_max: torch.Tensor,
    momentum: float,
    train: bool,
    percentile: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """QuantAct forward (quant_modules.py:538-637, symmetric mode): (x_fq,
    scale, new_min, new_max). In train mode the range starts from the first
    batch (the min == max sentinel), then follows the momentum EMA, or the
    running extremum at momentum -1; `percentile` > 0 clips the observed
    range (get_percentile_min_max, quant_modules.py:567-577). Outside train
    mode the stored range stays."""
    if train:
        if percentile > 0.0:
            cur_min, cur_max = q.get_percentile_min_max(x, 100.0 - percentile, percentile)
        else:
            cur_min, cur_max = x.detach().min(), x.detach().max()
        uninit = x_min == x_max
        if momentum == -1.0:
            upd_min, upd_max = torch.minimum(x_min, cur_min), torch.maximum(x_max, cur_max)
        else:
            upd_min = x_min * momentum + cur_min * (1.0 - momentum)
            upd_max = x_max * momentum + cur_max * (1.0 - momentum)
        new_min = torch.where(uninit, x_min + cur_min, upd_min)
        new_max = torch.where(uninit, x_max + cur_max, upd_max)
    else:
        new_min, new_max = x_min, x_max
    scale = q.symmetric_quantization_params(bits, new_min, new_max)
    return q.fake_quant(x, scale, bits), scale, new_min, new_max


def _ranges_after(qstate: QuantState, slot: int, new_min: torch.Tensor,
                  new_max: torch.Tensor, act_min: torch.Tensor, act_max: torch.Tensor):
    """(act_min, act_max) with QuantAct `slot`'s new range written in, new
    tensors; the old range stays while the ranges are frozen."""
    if qstate.act_fixed > 0:
        return act_min, act_max
    i = torch.arange(2, device=act_min.device) == slot
    return torch.where(i, new_min, act_min), torch.where(i, new_max, act_max)


# ---------------------------------------------------------------------------
# MLP application
# ---------------------------------------------------------------------------


def _apply_mlp_fp(layers, x: torch.Tensor, last_linear: bool, bf16: bool = False) -> torch.Tensor:
    """FP32 MLP: Linear+ReLU stacks; the last top layer emits raw logits.
    `bf16`: the products on bf16 operands (`ops.matmul.linear`)."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = linear(x, layer["w"], bf16) + layer["b"]
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


def _quant_weight(w: torch.Tensor, wbits: int, per_channel: bool):
    """A weight's scale (per tensor, or per output channel) and its
    fake-quant."""
    if per_channel:
        w_min, w_max = w.amin(dim=1), w.amax(dim=1)
    else:
        w_min, w_max = w.min(), w.max()
    s_w = q.symmetric_quantization_params(wbits, w_min, w_max)
    return s_w, q.fake_quant(w, s_w, wbits)


def _quant_linear_weights(layer, wbits: int, bbits: int, per_channel: bool):
    """Per-forward weight/bias scale + fake-quant (QuantLinear,
    quant_modules.py:107-135)."""
    s_w, w_fq = _quant_weight(layer["w"], wbits, per_channel)
    return s_w, w_fq, q.fake_quant(layer["b"], s_w, bbits)


def _fused_weight_quant(qc) -> bool:
    """Whether the forward fake-quantizes its dense weights in one
    multi-tensor pass (`_fake_quant_dense`): HAWQ weight-only QAT at
    per-tensor scales, outside tracing (`torch.export` takes the per-layer
    code). PACT, LSQ, per-channel scales and the integer-activation chain
    keep their per-layer code."""
    return (qc.quantize_mlp and not qc.quantize_activation and qc.quant_scheme == "hawq"
            and not qc.mlp_channelwise and not torch.compiler.is_compiling())


def _fake_quant_dense(params: Params, qc, plain: bool) -> Params:
    """{"bot", "top"[, "cross"]} with every weight and bias fake-quantized
    as `_quant_linear_weights` and `_cross_weights` do it, per tensor, in
    one multi-tensor pass with its straight-through gradient
    (`ops.cuda.qat_dense.fake_quant_dense`: the kernels on a CUDA tensor,
    the plain version on the CPU or with `plain`); a cross layer's V has
    its own scale and no bias."""
    parts = [part for part in ("bot", "top", "cross") if part in params]
    weights, biases = [], []
    for part in parts:
        for layer in params[part]:
            if part == "cross":
                weights.append(layer["v"])
                biases.append(None)
            weights.append(layer["w"])
            biases.append(layer["b"])
    fq = fake_quant_dense_plain if plain else fake_quant_dense
    w_fq, b_fq = fq(weights, biases, qc.weight_bit, qc.bias_bit)
    ws, bs = iter(w_fq), iter(b_fq)
    out: Params = {}
    for part in parts:
        out[part] = []
        for _ in params[part]:
            if part == "cross":
                v, _ = next(ws), next(bs)
                out[part].append({"v": v, "w": next(ws), "b": next(bs)})
            else:
                out[part].append({"w": next(ws), "b": next(bs)})
    return out


def _cross_weights(params: Params, qc, quantizing: bool) -> List[Dict[str, torch.Tensor]]:
    """The cross layers' {"v", "w", "b"} as the forward multiplies them:
    under weight QAT (`quantize_mlp`) V and W fake-quantized at
    `weight_bit` as the MLP's weights (per tensor, or per output channel
    with `mlp_channelwise`) and b at `bias_bit` with W's scale, b being W's
    bias; else as they are."""
    if not (quantizing and qc.quantize_mlp):
        return params["cross"]
    out = []
    for layer in params["cross"]:
        _, v_fq = _quant_weight(layer["v"], qc.weight_bit, qc.mlp_channelwise)
        _, w_fq, b_fq = _quant_linear_weights(layer, qc.weight_bit, qc.bias_bit, qc.mlp_channelwise)
        out.append({"v": v_fq, "w": w_fq, "b": b_fq})
    return out


def _apply_mlp_quant(layers, x: torch.Tensor, qc, last_linear: bool,
                     lsq_steps=None, bf16: bool = False) -> torch.Tensor:
    """Weight-only QAT MLP (quant_modules.py:138-186): linear(x,
    fake_quant(w), fake_quant(b)). HAWQ shares the weight scale with the
    bias; PACT applies the DoReFa transform to weights and bias at
    `weight_bit` (QuantLinearPACT, quant_pact_dorefa.py:42-53); LSQ takes
    the layer's learned steps from `lsq_steps`, per out-channel for the
    weights and per tensor for the bias (QuantLinearLSQ). `bf16`: the
    products on bf16 operands."""
    n = len(layers)
    for i, layer in enumerate(layers):
        if qc.quant_scheme == "pact":
            w_fq = q.fake_quant_pact(layer["w"], qc.weight_bit)
            b_fq = q.fake_quant_pact(layer["b"], qc.weight_bit)
        elif qc.quant_scheme == "lsq":
            st = lsq_steps[i]
            w_fq = q.fake_quant_lsq(layer["w"], st["w"], qc.weight_bit, per_channel=True)
            b_fq = q.fake_quant_lsq(layer["b"], st["b"], qc.weight_bit)
        else:
            _, w_fq, b_fq = _quant_linear_weights(layer, qc.weight_bit, qc.bias_bit,
                                                  qc.mlp_channelwise)
        x = linear(x, w_fq, bf16) + b_fq
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


def _apply_mlp_quant_act(layers, x_fq: torch.Tensor, act_scale: torch.Tensor, qc,
                         last_linear: bool) -> torch.Tensor:
    """Integer-activation QAT MLP (quant_modules.py:128-180): x_int = x /
    s_in, out = ste_round(x_int @ w_int.T + b_int) * (s_w s_in), the scales
    chained through the stack; per-tensor scales only. The operands are
    integers held in float32: true float32 matmuls keep them exact, TF32
    would round them."""
    n = len(layers)
    x, s_in = x_fq, act_scale.detach()
    for i, layer in enumerate(layers):
        w = layer["w"]
        s_w = q.symmetric_quantization_params(qc.weight_bit, w.detach().min(), w.detach().max())
        w_int = q.quantize_ste(w, s_w, qc.weight_bit)
        s_out = s_w * s_in
        b_int = q.quantize_ste(layer["b"], s_out, qc.bias_bit)
        out_int = q.ste_round((x / s_in) @ w_int.T + b_int)
        x = out_int * s_out
        s_in = s_out
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def pooling_weights(
    config: DLRMConfig,
    vw: Optional[List[torch.Tensor]],
    indices: torch.Tensor,  # [T, B, P]
    mask: Optional[torch.Tensor],  # [T, B, P]
) -> Optional[torch.Tensor]:  # [T, B, P]
    """The bag mask composed with the pooling weights: mask * v_W[k][idx]
    per table (per_sample_weights, apply_emb, dlrm_s_pytorch.py:407-411), or
    the mask alone without weighted pooling. `vw` is `params["v_W"]`;
    "fixed" weights take no gradient."""
    if config.weighted_pooling is None:
        return mask
    w = torch.stack([v[clamp_ids(indices[k], v.shape[0])[0]] for k, v in enumerate(vw)])
    if config.weighted_pooling == "fixed":
        w = w.detach()
    return w if mask is None else mask * w


def trick_pooled_lookup(
    config: DLRMConfig,
    table: Dict[str, torch.Tensor],
    indices: torch.Tensor,  # [B, P]
    mask: Optional[torch.Tensor],  # [B, P]
) -> torch.Tensor:  # [B, D] float32
    """Pooled lookup of one QR or MD table (the dict dispatch of the
    reference's create_emb, dlrm_s_pytorch.py:239-286), in full precision
    under every scheme."""
    if "q" in table:
        pooled = tricks.qr_pooled_lookup(table, indices, mask, config.qr_collisions, config.qr_operation)
    else:
        pooled = tricks.md_pooled_lookup(table, indices, mask)
    return pooled.float()


def splice_trick_pooled(
    config: DLRMConfig,
    emb: List[Any],  # the tables; the QR/MD dicts differentiable
    weights: Optional[torch.Tensor],  # [T, B, P] `pooling_weights`
    indices: torch.Tensor,  # [T, B, P]
    pooled: torch.Tensor,  # [T, B, D]
) -> torch.Tensor:  # [T, B, D]
    """`pooled` with the QR/MD slots recomputed from `emb` with their
    gradient: the sparse step cuts autograd at the pooled lookups, and the
    trick tables, small by construction, take dense gradients through this
    recompute (JAX dlrm.py:466-499)."""
    ks = trick_slots(config)
    if not ks:
        return pooled
    parts = list(pooled.unbind(0))
    for k in ks:
        parts[k] = trick_pooled_lookup(config, emb[k], indices[k], None if weights is None else weights[k])
    return torch.stack(parts)


def lookup_all(
    config: DLRMConfig,
    params: Params,
    indices: torch.Tensor,  # [T, B, P]
    mask: Optional[torch.Tensor],
    full_precision: bool = True,
    plain: bool = False,
) -> torch.Tensor:  # [T, B, D]
    """Raw pooled lookups of every table, differentiable through the tables
    (and learned pooling weights), float32. Under `multi_hot_sizes` each
    table's bag of [B, S] ids goes through `pooled_lookup`. The mask is composed with the
    pooling weights first (`pooling_weights`). The tables with at most
    `onehot_lookup_max_rows` rows, float32 or bfloat16, go through one
    launch of kernel K4 (its plain version with `plain=True`) per group of
    up to 32 (`group_slots`), the weights as K4's; the other tables through
    `pooled_lookup`, QR/MD tables through `trick_pooled_lookup`.

    PACT (unless `full_precision`) pools DoReFa-transformed rows
    (quant_pact_dorefa.py:97-105). Each table's normalizer max|tanh(w)| is
    taken over the whole table; the transform then applies to the gathered
    rows only (the K4 tables, small, are transformed whole). That gives the
    bits of transforming each table first without writing a transformed
    copy of the large tables every step. QR/MD tables take no transform."""
    if config.multi_hot_sizes is not None:
        if mask is not None:
            raise ValueError("bags of multi_hot_sizes take no mask")
        return torch.stack([pooled_lookup(t, ids).float() for t, ids in zip(params["emb"], bags(config, indices))])
    qc = config.quant
    pact = qc.enabled and qc.quantize_emb and not full_precision and qc.quant_scheme == "pact"
    emb = params["emb"]
    weights = pooling_weights(config, params.get("v_W"), indices, mask)
    lookup = onehot_pooled_lookup_grouped_plain if plain else onehot_pooled_lookup_grouped
    small = [k for k, t in enumerate(emb)
             if not isinstance(t, dict) and 0 < t.shape[0] <= config.onehot_lookup_max_rows]
    outs = {}
    for ks in group_slots(small):
        tables = [q.fake_quant_pact(emb[k], qc.embedding_bit) if pact else emb[k] for k in ks]
        pooled = lookup(make_onehot_lookup_group(tables, ks), indices, weights)
        outs.update((k, pooled[k]) for k in ks)
    for k, table in enumerate(emb):
        if k in outs:
            continue
        w = None if weights is None else weights[k]
        if isinstance(table, dict):
            outs[k] = trick_pooled_lookup(config, table, indices[k], w)
            continue
        row_fn = None
        if pact:
            norm = q.pact_normalizer(table)
            row_fn = lambda rows, norm=norm: q.pact_apply(rows, norm, qc.embedding_bit)  # noqa: E731
        outs[k] = pooled_lookup(table, indices[k], w, row_fn).float()
    return torch.stack([outs[k] for k in range(len(emb))])


def bags(config: DLRMConfig, indices: torch.Tensor) -> List[torch.Tensor]:
    """Each table's [B, P_k] ids: views of a [B, S] batch under
    `multi_hot_sizes`."""
    if indices.dim() != 2 or indices.shape[1] != sum(config.multi_hot_sizes):
        raise ValueError(f"multi_hot_sizes take [B, {sum(config.multi_hot_sizes)}] ids, "
                         f"got {tuple(indices.shape)}")
    return [bag_of(indices, k, bag) for k, bag in enumerate(config.bags())]


def emb_postprocess(
    config: DLRMConfig,
    params: Params,
    pooled: torch.Tensor,  # [T, B, D] raw pooled lookups
    qstate: QuantState,
    full_precision: bool,
    lsq_numel_scale: float = 1.0,
) -> torch.Tensor:
    """Pooled-output fake-quant per table, as one elementwise op over the
    stacked tables: HAWQ with the per-table scales (the DQRM trick,
    quant_modules_not_quantize_grad.py:362-395), LSQ with each table's
    learned step (quant_learned_step_size_quan.py:65-100), whose gradient
    scale counts one table's [B, D] (times `lsq_numel_scale`). PACT
    quantized the rows in `lookup_all`. QR/MD slots pass unchanged."""
    qc = config.quant
    if not qc.enabled or full_precision or not qc.quantize_emb or qc.quant_scheme == "pact":
        return pooled
    if qc.quant_scheme == "lsq":
        steps = torch.stack(params["lsq_emb"])[:, None, None]
        out = q.fake_quant_lsq(pooled, steps, qc.embedding_bit, numel=pooled[0].numel(),
                               numel_scale=lsq_numel_scale)
    else:
        out = q.fake_quant(pooled, qstate.emb_scales[:, None, None], qc.embedding_bit)
    ks = trick_slots(config)
    if ks:
        trick = q.constant(tuple(k in ks for k in range(config.num_tables)), torch.bool, pooled.device)
        out = torch.where(trick[:, None, None], pooled, out)
    return out


def apply_emb(
    config: DLRMConfig,
    params: Params,
    indices: torch.Tensor,
    mask: Optional[torch.Tensor],
    qstate: QuantState,
    full_precision: bool,
    plain: bool = False,
) -> torch.Tensor:  # [T, B, D]
    """Pooled lookups with the optional fake-quant of the scheme."""
    pooled = lookup_all(config, params, indices, mask, full_precision, plain=plain)
    return emb_postprocess(config, params, pooled, qstate, full_precision)


# ---------------------------------------------------------------------------
# Forward and losses
# ---------------------------------------------------------------------------


def require_fp32_matmul(device: torch.device) -> None:
    """The integer chain and the INT16 interaction multiply integers held in
    float32, which TF32 (11 significant bits) rounds: raise unless float32
    matmuls on the card are true float32, as PyTorch's defaults keep them."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "quantize_activation / modify_feature_interaction need true float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and float32 matmul precision 'highest'")


def forward(
    config: DLRMConfig,
    params: Params,
    batch: Batch,
    qstate: Optional[QuantState] = None,
    *,
    train: bool = True,
    full_precision: bool = False,
    raw_pooled: Optional[torch.Tensor] = None,
    lsq_numel_scale: float = 1.0,
    plain: bool = False,
) -> Tuple[torch.Tensor, QuantState]:
    """The DLRM forward: (logits [B], QuantState). The FP branch mirrors
    `sequential_forward` (dlrm_s_pytorch.py:590-615), the QAT branches the
    quantized forward (comm_grad.py:809-895): the integer-activation chain
    (`quantize_activation` and `quantize_mlp`), and weight-only QAT, whose
    dense input still passes the input QuantAct when `quantize_activation`
    is on and `quantize_mlp` off (the reference's branch 1, comm_grad.py:
    846-853).

    `raw_pooled` injects precomputed raw pooled lookups [T, B, D] (before
    the scheme's pooled-output fake-quant): the sparse train step cuts
    autograd there. `train` moves the activation ranges; the returned
    QuantState holds them (new tensors). `lsq_numel_scale`: see
    `emb_postprocess`. `compute_dtype="bfloat16"` puts the products of the
    float32 and weight-only MLPs and of the dot interaction on bf16
    operands; the integer chain and the INT16 interaction stay float32.
    Under `interaction="dcn"` the cross network's products too; its
    forward opens the span `dqrm.train.cross` where `train`. Under HAWQ
    weight-only QAT at per-tensor scales every MLP and cross weight and
    bias is fake-quantized once at the start, in one multi-tensor pass
    (`_fake_quant_dense`; its plain version with `plain`)."""
    qc = config.quant
    bf16 = config.compute_dtype == "bfloat16"
    if qstate is None:
        qstate = init_quant_state(config, batch.dense.device)
    quantizing = qc.enabled and not full_precision
    if quantizing and (qc.quantize_activation and qc.quantize_mlp or qc.modify_feature_interaction):
        require_fp32_matmul(batch.dense.device)

    def get_ly(fp_emb: bool) -> torch.Tensor:
        pooled = raw_pooled
        if pooled is None:
            pooled = lookup_all(config, params, batch.indices, batch.mask, fp_emb, plain=plain)
        return emb_postprocess(config, params, pooled, qstate, fp_emb, lsq_numel_scale)

    fused = quantizing and _fused_weight_quant(qc)
    fq = _fake_quant_dense(params, qc, plain) if fused else None

    def interact(x, ly):
        if quantizing and qc.modify_feature_interaction:
            return quantized_dot_interaction(x, ly, qc.interaction_bit, config.interact_itself)
        if config.interaction == "dot":
            return dot_interaction(x, ly, config.interact_itself, bf16)
        if config.interaction == "dcn":
            cross = fq["cross"] if fused else _cross_weights(params, qc, quantizing)
            with annotate("dqrm.train.cross") if train else contextlib.nullcontext():
                return low_rank_cross(cat_interaction(x, ly), cross, bf16)
        return cat_interaction(x, ly)

    act_min, act_max = qstate.act_min, qstate.act_max

    def quant_act(slot, x):
        nonlocal act_min, act_max
        x_fq, scale, lo, hi = _quant_act(x, qc.activation_bit, qstate.act_min[slot],
                                         qstate.act_max[slot], qc.act_range_momentum, train,
                                         qc.act_percentile)
        act_min, act_max = _ranges_after(qstate, slot, lo, hi, act_min, act_max)
        return x_fq, scale

    if not quantizing:
        x = _apply_mlp_fp(params["bot"], batch.dense, False, bf16)
        logits = _apply_mlp_fp(params["top"], interact(x, get_ly(True)), True, bf16)
    elif qc.quantize_activation and qc.quantize_mlp:
        # quant_input QuantAct -> integer MLP chains (comm_grad.py:863-879); the
        # interaction is the dot one whatever `config.interaction` says
        x_fq, s_act = quant_act(0, batch.dense)
        x = _apply_mlp_quant_act(params["bot"], x_fq, s_act, qc, False)
        ly = get_ly(False)
        z = (quantized_dot_interaction(x, ly, qc.interaction_bit, config.interact_itself)
             if qc.modify_feature_interaction else dot_interaction(x, ly, config.interact_itself))
        z_fq, s_feat = quant_act(1, z)
        logits = _apply_mlp_quant_act(params["top"], z_fq, s_feat, qc, True)
    else:
        if fused:
            def mlp(part, x, last_linear):
                return _apply_mlp_fp(fq[part], x, last_linear, bf16)
        elif qc.quantize_mlp:
            lsq_mlp = params.get("lsq_mlp")

            def mlp(part, x, last_linear):
                steps = lsq_mlp[part] if lsq_mlp is not None else None
                return _apply_mlp_quant(params[part], x, qc, last_linear, steps, bf16)
        else:
            def mlp(part, x, last_linear):
                return _apply_mlp_fp(params[part], x, last_linear, bf16)
        dense_in = batch.dense
        if qc.quantize_activation:  # the reference's branch 1: FP MLPs behind quant_input
            dense_in, _ = quant_act(0, batch.dense)
        x = mlp("bot", dense_in, False)
        logits = mlp("top", interact(x, get_ly(False)), True)
    return logits.reshape(-1), qstate._replace(act_min=act_min, act_max=act_max)


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
