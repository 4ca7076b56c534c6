"""Serving: post-training quantization export + packed inference engine.

Port of the JAX package's serving.py:

- `ptq_export` packs trained params (float32 or bf16 tables) into a
  `ServingModel`: tables bit-packed to INT4/INT8 (symmetric per-table, or
  rowwise ATen-style), each component of a QR or MD table packed the same
  way (an MD projection stays float32), the pooling weights `v_W` kept
  float32, MLP weights INT8 per output channel (or kept float32);
- `make_serving_fn` builds the inference function over the packed model:
  one grouped gather-dequant-pool launch for the packed tables (kernel K2),
  or for tables with at most `onehot_lookup_max_rows` rows, unpacked once,
  one grouped launch of kernel K4; QR's quotient and remainder and MD's
  narrow tables are members of the same launches, composed or projected
  after them; `v_W[ids]` times the mask as both kernels' weights; int8
  dequant matmuls with the ReLU fused (kernel K3), or with
  `mlp_impl="int8"` dynamic int8 activations and an int8 product; dot or
  cat interaction, sigmoid, `loss_threshold` clip;
- `ServingEngine` pads requests on the host to the nearest bucket size and
  chunks large ones; on a card it stages each device batch in its bucket's
  pinned buffers and runs the serving function as one CUDA graph replay per
  batch; `MicroBatcher` aggregates concurrent requests from many threads
  into one device batch per dispatch.

- `export_stablehlo` / `load_stablehlo` write a `torch.export` program of
  the serving function (`ServingModule`: the model's tensors as buffers,
  K2 and K3 as registered ops) and load it back.

- `ptq_export_streaming` packs one table at a time from a caller's
  accessor (the mega-table engines' blocks), each in row chunks, dropping
  its source before the next: bit-identical to `ptq_export`.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm, tricks
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    group_slots,
    make_onehot_lookup_group,
    onehot_pooled_lookup_grouped_fwd,
    onehot_pooled_lookup_grouped_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
    PackedGroup,
    PackedTable,
    make_packed_group,
    pack_table,
    packed_pooled_lookup_grouped,
    packed_pooled_lookup_grouped_plain,
    unpack_table,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
    QuantLinearWeights,
    int8_linear,
    int8_linear_dynamic,
    int8_linear_dynamic_plain,
    int8_linear_xla,
    quantize_linear_weights,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import block_view
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import (
    cat_interaction,
    dot_interaction,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.cuda_graph import GraphedCall
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.profiling import annotate


class ServingModel(NamedTuple):
    config: DLRMConfig
    # per table: a PackedTable, or for QR {"q", "r"} of PackedTables and for
    # MD {"table": PackedTable[, "proj": float32 [D, d_k]]}
    emb: List[Any]
    bot: List  # QuantLinearWeights or fp32 {"w","b"} dicts
    top: List
    mlp_bits: int  # 32 = fp32 MLP
    vw: Optional[List[torch.Tensor]] = None  # per-row pooling weights, float32 [n_k]


def _refuse_unserved(config: DLRMConfig) -> None:
    """The packed serving path has the dot and cat interactions over bags of
    one width: raise for a model it would not compute (DLRM-DCNv2's cross
    network, bags of per-table widths)."""
    if config.interaction == "dcn" or config.multi_hot_sizes is not None:
        raise ValueError("packed serving does not serve interaction='dcn' or multi_hot_sizes models "
                         "(no cross network, one bag width): serve such a model unpacked, through "
                         "train_step.make_eval_step")


def _pack_entry(t, emb_bits: int, rowwise: bool, row_chunk: int = 0):
    """A table packed, or each component of a QR/MD dict (the projection
    kept as it is); JAX serving.py:98-114."""
    if not isinstance(t, dict):
        return pack_table(t, bits=emb_bits, rowwise=rowwise, row_chunk=row_chunk)
    return {k: v if k == "proj" else pack_table(v, bits=emb_bits, rowwise=rowwise, row_chunk=row_chunk)
            for k, v in t.items()}


def _quantize_mlp(bot, top, mlp_bits: int):
    if mlp_bits not in (8, 32):
        raise ValueError("mlp_bits must be 8 or 32")
    if mlp_bits == 32:
        return bot, top
    return ([quantize_linear_weights(l["w"], l["b"], 8) for l in bot],
            [quantize_linear_weights(l["w"], l["b"], 8) for l in top])


def ptq_export(
    config: DLRMConfig,
    params: dlrm.Params,
    emb_bits: int = 4,
    mlp_bits: int = 8,
    rowwise: bool = False,
) -> ServingModel:
    """Pack a trained model for serving (quantize_dynamic +
    quantize_embedding, dlrm_s_pytorch.py:1446-1471). emb_bits in {4, 8},
    mlp_bits in {8, 32}. QR/MD tables pack each component at emb_bits (the
    reference's PTQ packs plain tables only); INT4 needs even widths, so an
    MD model with odd widths packs at 8 bits. The pooling weights ride
    along in float32. The model stays on the params' device."""
    _refuse_unserved(config)
    if emb_bits not in (4, 8):
        raise ValueError("emb_bits must be 4 or 8 for packed serving")
    bot, top = _quantize_mlp(params["bot"], params["top"], mlp_bits)
    emb = [_pack_entry(t, emb_bits, rowwise) for t in params["emb"]]
    vw = list(params["v_W"]) if config.weighted_pooling is not None else None
    return ServingModel(config=config, emb=emb, bot=bot, top=top, mlp_bits=mlp_bits, vw=vw)


def ptq_export_streaming(
    config: DLRMConfig,
    get_table: Callable[[int], Any],
    bot,
    top,
    vw: Optional[List[torch.Tensor]] = None,
    emb_bits: int = 4,
    mlp_bits: int = 8,
    rowwise: bool = False,
    row_chunk: int = 2_000_000,
) -> ServingModel:
    """`ptq_export` one table at a time (JAX serving.py:117-163): `get_table(k)`
    gives table k (a view of a mega-table block, or a QR/MD dict), which is
    packed in chunks of `row_chunk` rows (`pack_table(row_chunk=)`) and
    dropped before the next table is asked for. The peak holds the packed
    model, one table's source if `get_table` copies, and one chunk's
    temporaries, where `ptq_export` of a whole params dict holds every
    table's float32 temporaries in turn beside the source tables. The
    result is bit-identical to `ptq_export` of the same tables."""
    _refuse_unserved(config)
    if emb_bits not in (4, 8):
        raise ValueError("emb_bits must be 4 or 8 for packed serving")
    bot, top = _quantize_mlp(bot, top, mlp_bits)
    emb = []
    for k in range(config.num_tables):
        emb.append(_pack_entry(get_table(k), emb_bits, rowwise, row_chunk))
    return ServingModel(config=config, emb=emb, bot=bot, top=top, mlp_bits=mlp_bits,
                        vw=list(vw) if vw is not None else None)


def serving_model_bytes(sm: ServingModel) -> int:
    """Model size in bytes (the paper's 8x compression measurement,
    Table 3)."""
    n = 0
    for e in sm.emb:
        for v in (e.values() if isinstance(e, dict) else [e]):
            n += v.nbytes() if isinstance(v, PackedTable) else v.numel() * 4
    if sm.vw is not None:
        n += sum(v.numel() * 4 for v in sm.vw)
    for layers in (sm.bot, sm.top):
        for l in layers:
            if isinstance(l, QuantLinearWeights):
                n += l.w_int.numel() + l.scale.numel() * 4 + l.bias.numel() * 4
            else:
                n += (l["w"].numel() + l["b"].numel()) * 4
    return n


def _apply_mlp_serving(layers, x, mlp_bits: int, last_linear: bool, linear8) -> torch.Tensor:
    nl = len(layers)
    for i, l in enumerate(layers):
        relu = not (last_linear and i == nl - 1)
        if mlp_bits == 8:
            x = linear8(x, l, relu=relu)  # ReLU fused into K3's epilogue
        else:
            x = x @ l["w"].T + l["b"]
            if relu:
                x = torch.relu(x)
    return x


class _Member(NamedTuple):
    """One packed table of the lookup: reads id row `slot`, writes the
    [B, dim] block at column `col` of the output."""

    pt: PackedTable
    slot: int
    col: int


def _members(sm: ServingModel):
    """(members, QR slots, width): every packed table of the model with its
    id row and output column. Plain tables (and MD tables of the full width)
    write slot k of the leading [T, B, D] block; QR's q and r read the
    extra id rows T + i and T + n_qr + i (ids // c and ids % c) and MD's
    narrow tables their own ids, and write blocks after it, each at a
    column that is a multiple of 4 (16-byte aligned)."""
    T, D = len(sm.emb), sm.config.embedding_dim
    qr = [k for k, e in enumerate(sm.emb) if isinstance(e, dict) and "q" in e]
    members, col = [], T * D

    def extra(pt, slot):
        nonlocal col
        members.append(_Member(pt, slot, col))
        col += -(-pt.dim // 4) * 4

    for k, e in enumerate(sm.emb):
        if not isinstance(e, dict):
            members.append(_Member(e, k, k * D))
        elif "q" in e:
            i = qr.index(k)
            extra(e["q"], T + i)
            extra(e["r"], T + len(qr) + i)
        elif "proj" in e:
            extra(e["table"], k)
        else:
            members.append(_Member(e["table"], k, k * D))
    return members, qr, col


class _Parts(NamedTuple):
    """What the serving function computes once from a `ServingModel`: the
    lookup groups, the QR/MD tables to compose or project after them, the
    pooling weights concatenated, the MLPs."""

    config: DLRMConfig
    width: int  # output columns of the lookups: the [T, B, D] slots, then QR's and MD's blocks
    qr: list  # the QR tables' slots
    qsel: Optional[torch.Tensor]  # the same, int64, on the model's device; None without QR
    vw: Optional[tuple]  # (v_W concatenated, each table's offset, each table's last row) or None
    group: Optional[PackedGroup]  # the packed tables of one K2 launch
    onehot_groups: list  # the unpacked small tables, one K4 launch per 32
    post: list  # (slot, entry, its members): the QR tables to compose, the MD tables to project
    bot: List
    top: List
    mlp_bits: int


def _vw_parts(vw: Sequence[torch.Tensor]) -> tuple:
    """The pooling weights as one vector, with each table's offset and last
    row ([T, 1, 1] int64): one gather serves every table."""
    dev = vw[0].device
    sizes = torch.tensor([v.shape[0] for v in vw], dtype=torch.int64, device=dev)
    return torch.cat(list(vw)), (torch.cumsum(sizes, 0) - sizes)[:, None, None], (sizes - 1)[:, None, None]


def _parts(sm: ServingModel, onehot_lookup_max_rows: int = 0, vw: Optional[tuple] = None,
           qsel: Optional[torch.Tensor] = None) -> _Parts:
    """The `_Parts` of `sm`; `vw` and `qsel` where the caller keeps them
    (the exported module, as buffers)."""
    T = len(sm.emb)
    members, qr, width = _members(sm)
    by_slot = {m.slot: m for m in members}
    post = []
    for k, e in enumerate(sm.emb):
        if isinstance(e, dict) and "q" in e:
            i = qr.index(k)
            post.append((k, e, [by_slot[T + i], by_slot[T + len(qr) + i]]))
        elif isinstance(e, dict) and "proj" in e:
            post.append((k, e, [by_slot[k]]))
    small = [m for m in members if 0 < m.pt.rows <= onehot_lookup_max_rows]
    big = [m for m in members if not 0 < m.pt.rows <= onehot_lookup_max_rows]
    group = make_packed_group([m.pt for m in big], [m.slot for m in big], [m.col for m in big],
                              width) if big else None
    onehot_groups = []
    for part in group_slots(range(len(small))):
        ms = [small[i] for i in part]
        onehot_groups.append(make_onehot_lookup_group(
            [unpack_table(m.pt) for m in ms], [m.slot for m in ms], [m.col for m in ms]))
    if vw is None and sm.vw is not None:
        vw = _vw_parts(sm.vw)
    if qsel is None and qr:
        qsel = torch.tensor(qr, dtype=torch.int64, device=members[0].pt.data.device)
    return _Parts(config=sm.config, width=width, qr=qr, qsel=qsel, vw=vw, group=group,
                  onehot_groups=onehot_groups, post=post, bot=sm.bot, top=sm.top, mlp_bits=sm.mlp_bits)


def _serve(p: _Parts, dense: torch.Tensor, indices: torch.Tensor, mask: Optional[torch.Tensor],
           grouped, onehot, linear8) -> torch.Tensor:
    """The serving function's body: probabilities [B] of one batch, the
    lookups through `grouped` (K2) and `onehot` (K4), the int8 layers
    through `linear8`."""
    cfg = p.config
    T, D = len(cfg.table_sizes), cfg.embedding_dim
    w = mask
    B = indices.shape[1]
    if p.vw is not None:  # per_sample_weights v_W[ids] composed with the mask
        vw_flat, vw_off, vw_max = p.vw
        rows = vw_flat[torch.minimum(indices.long().clamp_min(0), vw_max) + vw_off]
        w = rows if w is None else w * rows
    if p.qr:
        c = cfg.qr_collisions
        qi = indices[p.qsel]
        indices = torch.cat([indices, qi // c, qi % c])
        if w is not None:
            w = torch.cat([w, w[p.qsel], w[p.qsel]])
    # the slots of the plain tables, then QR's and MD's blocks: K2 makes the
    # output, K4 writes its blocks into it (a traced program takes the value)
    if p.group is not None:
        out = grouped(p.group, indices, w).view(-1)
    else:
        out = torch.empty((p.width * B,), device=indices.device)
    for og in p.onehot_groups:
        out = onehot(og, indices, w, out=out)
    ly = out[:T * D * B].view(T, B, D)
    for k, e, ms in p.post:
        blocks = [block_view(out, m.col, B, m.pt.dim) for m in ms]
        ly[k] = tricks.qr_compose(*blocks, cfg.qr_operation) if "q" in e else tricks.md_project(e, blocks[0])
    x = _apply_mlp_serving(p.bot, dense, p.mlp_bits, False, linear8)
    z = (
        dot_interaction(x, ly, cfg.interact_itself)
        if cfg.interaction == "dot"
        else cat_interaction(x, ly)
    )
    logits = _apply_mlp_serving(p.top, z, p.mlp_bits, True, linear8)
    probs = torch.sigmoid(logits.reshape(-1))
    if 0.0 < cfg.loss_threshold < 1.0:
        probs = torch.clamp(probs, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
    return probs


def make_serving_fn(
    sm: ServingModel,
    mlp_impl: Optional[str] = None,
    onehot_lookup_max_rows: int = 0,
    fused_gather: bool = False,
    plain: bool = False,
    use_pallas_lookup: bool = False,
    use_pallas_mlp: bool = False,
) -> Callable[[dlrm.Batch], torch.Tensor]:
    """Inference function: Batch -> click probabilities [B] (float32, on the
    batch's device).

    The lookups of all packed tables go through one
    `packed_pooled_lookup_grouped` call, whose descriptor array is built
    here, once, and the int8 layers through `int8_linear`: kernels on the
    card, their plain versions on the CPU. The packed tables with at most
    `onehot_lookup_max_rows` rows are instead unpacked here, once, and kept
    beside the packed model (the 18 such Kaggle tables hold 47,398 rows:
    3,033,472 bytes of float32 at D = 16; `serving_model_bytes` stays the
    export's size), and one `onehot_pooled_lookup_grouped_fwd` launch
    (kernel K4) per 32 of them looks them up into the same output.

    QR and MD tables (JAX serving.py:388-445): each QR table's q and r are
    two members of those launches, reading ids // c and ids % c (one
    [T + 2 n_qr, B, P] id tensor built per batch in one pass), composed
    after the launch; an MD table's narrow table writes its own block of
    the output, projected after the launch. The blocks have any width, so
    one K2 launch serves all the packed tables. With weighted pooling the
    weights v_W[k][ids] (one gather from the vectors concatenated here,
    once) times the mask are the kernels' weights.

    `mlp_impl="int8"` runs the int8 layers as `int8_linear_dynamic` (the
    reference's quantize_dynamic: int8 activations, an int8 product, a
    rescale) instead of K3. `fused_gather=True` is accepted for the JAX
    package's signature: that package's one gather for all tables gives the
    per-table results, and here every lookup is one grouped launch already.
    `plain=True` calls the plain versions on any device — the reference the
    kernels are checked against on the card. `use_pallas_lookup` and
    `use_pallas_mlp` are accepted for the JAX package's signature and change
    nothing: there they choose the Pallas kernels over XLA's gather and
    matmul, and here the kernels are the only path. `export_stablehlo`
    traces the same body (`_serve`)."""
    _refuse_unserved(sm.config)
    del use_pallas_lookup, use_pallas_mlp  # the kernels are the only path
    if mlp_impl not in (None, "int8"):
        raise ValueError(f"unknown mlp_impl {mlp_impl!r}")
    del fused_gather  # the grouped lookup below is the fused path
    grouped = packed_pooled_lookup_grouped_plain if plain else packed_pooled_lookup_grouped
    onehot = onehot_pooled_lookup_grouped_plain if plain else onehot_pooled_lookup_grouped_fwd
    if mlp_impl == "int8":
        linear8 = int8_linear_dynamic_plain if plain else int8_linear_dynamic
    else:
        linear8 = int8_linear_xla if plain else int8_linear
    parts = _parts(sm, onehot_lookup_max_rows)

    @torch.inference_mode()
    def fn(batch: dlrm.Batch) -> torch.Tensor:
        return _serve(parts, batch.dense, batch.indices, batch.mask, grouped, onehot, linear8)

    return fn


def _serving_arrays(sm: ServingModel):
    """Split the ServingModel into (named tensors, static metadata), the
    JAX package's `_serving_arrays` (serving.py:207-259): here the tensors
    become an `nn.Module`'s buffers and the metadata its constructor's
    state. Names follow the model's structure: `emb_3_data`,
    `emb_5_q_scale`, `emb_7_proj`, `bot_0_w_int`, `top_2_b`."""
    arrays, emb_meta = {}, []

    def packed(prefix, pt: PackedTable):
        arrays[f"{prefix}_data"], arrays[f"{prefix}_scale"] = pt.data, pt.scale
        if pt.bias is not None:
            arrays[f"{prefix}_bias"] = pt.bias
        return (pt.bits, pt.dim, pt.bias is not None)

    for k, e in enumerate(sm.emb):
        if isinstance(e, dict):
            meta = {}
            for name, v in e.items():
                if isinstance(v, PackedTable):
                    meta[name] = packed(f"emb_{k}_{name}", v)
                else:
                    arrays[f"emb_{k}_{name}"] = v
                    meta[name] = None
            emb_meta.append(meta)
        else:
            emb_meta.append(packed(f"emb_{k}", e))
    for part in ("bot", "top"):
        for i, l in enumerate(getattr(sm, part)):
            fields = ("w_int", "scale", "bias") if isinstance(l, QuantLinearWeights) else ("w", "b")
            for f in fields:
                arrays[f"{part}_{i}_{f}"] = getattr(l, f) if isinstance(l, QuantLinearWeights) else l[f]
    meta = {"config": sm.config, "emb": emb_meta, "mlp_bits": sm.mlp_bits,
            "layers": (len(sm.bot), len(sm.top))}
    return arrays, meta


def _rebuild_serving_model(arrays, meta) -> ServingModel:
    """The ServingModel of `_serving_arrays`' (tensors, metadata), without
    its pooling weights (the serving body takes them concatenated)."""
    def packed(prefix, m):
        bits, dim, has_bias = m
        return PackedTable(data=arrays[f"{prefix}_data"], scale=arrays[f"{prefix}_scale"],
                           bias=arrays[f"{prefix}_bias"] if has_bias else None, bits=bits, dim=dim)

    emb = []
    for k, m in enumerate(meta["emb"]):
        if isinstance(m, dict):
            emb.append({name: arrays[f"emb_{k}_{name}"] if mm is None else packed(f"emb_{k}_{name}", mm)
                        for name, mm in m.items()})
        else:
            emb.append(packed(f"emb_{k}", m))
    mlps = []
    for part, n in zip(("bot", "top"), meta["layers"]):
        if meta["mlp_bits"] == 8:
            mlps.append([QuantLinearWeights(w_int=arrays[f"{part}_{i}_w_int"], scale=arrays[f"{part}_{i}_scale"],
                                            bias=arrays[f"{part}_{i}_bias"], bits=8) for i in range(n)])
        else:
            mlps.append([{"w": arrays[f"{part}_{i}_w"], "b": arrays[f"{part}_{i}_b"]} for i in range(n)])
    return ServingModel(config=meta["config"], emb=emb, bot=mlps[0], top=mlps[1], mlp_bits=meta["mlp_bits"])


class ServingModule(torch.nn.Module):
    """The packed serving model as an `nn.Module`: its tensors are buffers
    (the pooling weights concatenated, as the serving function keeps them)
    and `forward(dense, indices)` is `make_serving_fn`'s body with no mask,
    with K2, K3 (and the fixed int8 MLP) reached through the registered
    ops when traced. The form `export_stablehlo` exports."""

    def __init__(self, sm: ServingModel):
        super().__init__()
        arrays, self._meta = _serving_arrays(sm)
        for name, t in arrays.items():
            self.register_buffer(name, t)
        self._names = tuple(arrays)
        if sm.vw is not None:
            for name, t in zip(("vw_flat", "vw_off", "vw_max"), _vw_parts(sm.vw)):
                self.register_buffer(name, t)
        qr = _members(sm)[1]
        if qr:
            self.register_buffer("qsel", torch.tensor(qr, dtype=torch.int64, device=next(self.buffers()).device))

    def forward(self, dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        sm = _rebuild_serving_model({n: getattr(self, n) for n in self._names}, self._meta)
        vw = (self.vw_flat, self.vw_off, self.vw_max) if hasattr(self, "vw_flat") else None
        parts = _parts(sm, vw=vw, qsel=getattr(self, "qsel", None))
        return _serve(parts, dense, indices, None, packed_pooled_lookup_grouped, None, int8_linear)


def export_program(sm: ServingModel, batch_size: int) -> "torch.export.ExportedProgram":
    """`torch.export` of the serving model at a fixed batch: dense [B,
    num_dense] float32 and indices [T, B, P] int32, P = the config's
    pooling size, on the model's device (JAX's ShapeDtypeStructs,
    serving.py:486-489)."""
    cfg = sm.config
    module = ServingModule(sm)
    dev = next(module.buffers()).device
    dense = torch.zeros((batch_size, cfg.num_dense), dtype=torch.float32, device=dev)
    indices = torch.zeros((cfg.num_tables, batch_size, cfg.pooling_size), dtype=torch.int32, device=dev)
    with torch.no_grad():
        return torch.export.export(module, (dense, indices))


def export_stablehlo(sm: ServingModel, batch_size: int, path: str) -> str:
    """Serialize the packed inference function: the counterpart of the JAX
    package's `export_stablehlo` (serving.py:463-496), which writes
    StableHLO. Here `torch.export` traces `ServingModule` (K2 and K3 as the
    registered ops `dqrm::packed_pooled_lookup_grouped` and
    `dqrm::int8_linear`) at a fixed batch and `torch.export.save` writes
    the program with the model's tensors to `path`; `load_stablehlo` reads
    it back. The analogue of the reference's `--save-onnx` export
    (dlrm_s_pytorch.py:1813-1893). JAX's `_fuse_packed_tables`
    (serving.py:293-332), which concatenates the tables for one gather,
    has no counterpart: the grouped K2 launch already reads every table in
    place."""
    torch.export.save(export_program(sm, batch_size), path)
    return path


def load_stablehlo(path: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Load an `export_stablehlo` artifact: fn(dense, indices) -> click
    probabilities, run in inference mode (the ops then skip autograd's
    layer). Importing this module registers the ops it calls."""
    module = torch.export.load(path).module()

    def fn(dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(dense, indices)

    return fn


def _inputs(batch: dlrm.Batch) -> tuple:
    """What the serving function reads of a batch (not its labels)."""
    return batch.dense, batch.indices, batch.mask


class _Graph(GraphedCall):
    """One batch shape's CUDA graph of the serving function over its static
    inputs, `batch`."""

    def __init__(self, batch: dlrm.Batch, stream: torch.cuda.Stream):
        super().__init__(stream)
        dense, indices, mask = (None if t is None else torch.empty_like(t) for t in _inputs(batch))
        self.batch = dlrm.Batch(dense=dense, indices=indices, labels=None, mask=mask)


class _Stage(NamedTuple):
    """A bucket's host buffers: its dense rows and ids going up (pinned on
    the graphed path) and its probabilities coming back (pinned; None on
    the eager path)."""

    dense: torch.Tensor
    indices: torch.Tensor
    probs: Optional[torch.Tensor]


class ServingEngine:
    """Bucketed-batch inference host loop.

    Pads request batches up to the nearest bucket so the device sees a few
    fixed shapes, chunks requests larger than the biggest bucket, and slices
    the padding off. Each device batch opens the spans `dqrm.serve.pad`,
    `dqrm.serve.h2d` and `dqrm.serve.readback` (`utils.profiling`) and calls
    `fn` once, with a batch of its own device tensors. One lock holds a
    `predict` call, so concurrent callers take turns.

    On a card (and not `plain`) a device batch is copied into its bucket's
    pinned host buffers (zeroed past the chunk only where the chunk is
    short), uploaded without waiting, and answered by one replay of the
    serving function's CUDA graph for its shapes (`fn`: the batch copied on
    the device into the graph's static inputs, then the replay, in the span
    `dqrm.serve.graph`); the readback copies the graph's output into a
    pinned buffer, waits for the device and copies the live rows into the
    caller's own array. A shape's first `utils.cuda_graph.WARMUP_CALLS`
    calls run eagerly on a side stream, building every cache the forward
    keeps, and one more wherever the last did not run in the caller's
    thread; the next is captured there and answered by the graph's first
    replay. On the CPU, and with `plain=True`, every batch is padded in new
    host arrays, uploaded as it is and run eagerly.

    Counters: `batches` (device batches dispatched), `graph_captures`,
    `graph_replays` and `eager_batches` (the warm-ups, and every batch on
    the CPU or with `plain`): `eager_batches + graph_replays == batches`
    for the batches `predict` dispatched.
    """

    def __init__(
        self,
        sm: ServingModel,
        buckets: Sequence[int] = (128, 1024, 4096, 16384),
        mlp_impl: Optional[str] = None,
        onehot_lookup_max_rows: int = 0,
        plain: bool = False,
        use_pallas_lookup: bool = False,
        use_pallas_mlp: bool = False,
    ):
        """`use_pallas_lookup` and `use_pallas_mlp` change nothing, as in
        `make_serving_fn`."""
        del use_pallas_lookup, use_pallas_mlp
        self.sm = sm
        self.buckets = sorted(buckets)
        e = sm.emb[0]
        self.device = (next(iter(e.values())) if isinstance(e, dict) else e).data.device
        self._serve = make_serving_fn(
            sm, mlp_impl=mlp_impl, onehot_lookup_max_rows=onehot_lookup_max_rows,
            plain=plain,
        )
        self.graphed = self.device.type == "cuda" and not plain
        self.fn = self._replay if self.graphed else self._eager
        self.batches = self.graph_captures = self.graph_replays = self.eager_batches = 0
        self._lock = threading.Lock()
        self._stages = {}  # the chunk's shapes at its bucket -> _Stage (graphed path)
        self._graphs = {}  # the batch's shapes and dtypes -> _Graph
        self._stream = torch.cuda.Stream(self.device) if self.graphed else None

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, dense: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """dense [B,13] f32 (already log1p), indices [T,B,P] int32."""
        B = dense.shape[0]
        out = np.empty(B, np.float32)
        pos = 0
        with self._lock:
            while pos < B:
                chunk = min(B - pos, self.buckets[-1])
                rows = slice(pos, pos + chunk)
                with annotate("dqrm.serve.pad"):
                    stage = self._pad(self._bucket(chunk), dense[rows], indices[:, rows])
                with annotate("dqrm.serve.h2d"):
                    batch = dlrm.Batch(dense=stage.dense.to(self.device, non_blocking=True),
                                       indices=stage.indices.to(self.device, non_blocking=True),
                                       labels=None, mask=None)
                probs = self.fn(batch)
                with annotate("dqrm.serve.readback"):
                    if self.graphed:
                        stage.probs.copy_(probs, non_blocking=True)
                        torch.cuda.current_stream(self.device).synchronize()
                        out[rows] = stage.probs.numpy()[:chunk]
                    else:
                        out[rows] = probs.cpu().numpy()[:chunk]
                self.batches += 1
                pos += chunk
        return out

    def _pad(self, nb: int, dense: np.ndarray, indices: np.ndarray) -> _Stage:
        """The chunk at the bucket's `nb` rows, zero past it: in the bucket's
        pinned buffers on the graphed path, else in new host arrays."""
        chunk = dense.shape[0]
        shapes = ((nb, dense.shape[1]), (indices.shape[0], nb, indices.shape[2]))
        if not self.graphed:
            d = np.zeros(shapes[0], np.float32)
            d[:chunk] = dense
            ix = np.zeros(shapes[1], np.int32)
            ix[:, :chunk] = indices
            return _Stage(torch.from_numpy(d), torch.from_numpy(ix), None)
        stage = self._stages.get(shapes)
        if stage is None:
            stage = self._stages[shapes] = _Stage(
                torch.empty(shapes[0], dtype=torch.float32, pin_memory=True),
                torch.empty(shapes[1], dtype=torch.int32, pin_memory=True),
                torch.empty((nb,), dtype=torch.float32, pin_memory=True))
        # numpy's copy, on the caller's thread: torch's spreads over its
        # intra-op threads, whose spinning slows a caller that is not the
        # main thread more than the copy gains
        d, ix = stage.dense.numpy(), stage.indices.numpy()
        d[:chunk] = dense
        ix[:, :chunk] = indices
        if chunk < nb:
            d[chunk:] = 0
            ix[:, chunk:] = 0
        return stage

    def _eager(self, batch: dlrm.Batch) -> torch.Tensor:
        self.eager_batches += 1
        return self._serve(batch)

    @torch.inference_mode()
    def _replay(self, batch: dlrm.Batch) -> torch.Tensor:
        """The probabilities of `batch` from the CUDA graph of its shapes: the
        graph's output, which the next call of those shapes overwrites."""
        key = tuple(None if t is None else (t.shape, t.dtype) for t in _inputs(batch))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(batch, self._stream)
        for buf, t in zip(_inputs(g.batch), _inputs(batch)):
            if buf is not None:
                buf.copy_(t)
        if g.graph is None:
            serve = functools.partial(self._serve, g.batch)
            if not g.due():
                self.eager_batches += 1
                return g.warm_up(serve)
            g.capture(serve)
            self.graph_captures += 1
        with annotate("dqrm.serve.graph", self._counts):
            probs = g.replay()
        self.graph_replays += 1
        return probs

    def _counts(self) -> str:
        return f"replays={self.graph_replays} captures={self.graph_captures}"


class MicroBatcher:
    """Continuous-batching front end over a ServingEngine.

    Concurrent `predict` calls (single requests or small batches from many
    client threads) are aggregated by a background worker into one device
    batch per dispatch — up to `max_batch` rows or `max_wait_ms` after the
    first queued request, whichever comes first — then split back to the
    callers.
    """

    def __init__(self, engine: ServingEngine, max_batch: int = 16384,
                 max_wait_ms: float = 1.0):
        self.engine = engine
        self.max_batch = min(max_batch, engine.buckets[-1])
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, dense: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """Thread-safe; blocks until this request's slice is ready.

        dense [B,13] f32 (already log1p), indices [T,B,P] int32.
        """
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        done = threading.Event()
        item = {"dense": dense, "indices": indices, "done": done}
        self._q.put(item)
        done.wait()
        if "error" in item:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._worker.join()

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            rows = first["dense"].shape[0]
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(group)
                    return
                group.append(nxt)
                rows += nxt["dense"].shape[0]
            self._flush(group)

    def _flush(self, group) -> None:
        try:
            dense = np.concatenate([g["dense"] for g in group], axis=0)
            indices = np.concatenate([g["indices"] for g in group], axis=1)
            probs = self.engine.predict(dense, indices)
            pos = 0
            for g in group:
                n = g["dense"].shape[0]
                g["result"] = probs[pos : pos + n]
                pos += n
        except Exception as e:  # surface errors to every blocked caller
            for g in group:
                g["error"] = e
        finally:
            for g in group:
                g["done"].set()
