"""Row-sharded embedding parallelism: the mega-table split by GLOBAL rows.

Port of the JAX package's parallel/rowshard.py, its scaling extension
beyond the reference (which shards whole tables only, create_emb's
local_emb_indices, dlrm_s_pytorch.py:243-245). The dense tables are
concatenated into one global row space [R_total + 1 pad row, D], split
into N equal chunks whatever the table boundaries, so a table larger than
one card spans ranks and any world size works. One process per rank (NCCL
on the card; gloo where the caller names it):

- forward: every rank sums the rows it owns into PARTIAL pooled outputs
  [T, B, D] over the full batch (the other lookups masked to 0), then one
  `reduce_scatter_tensor` over the batch dimension both completes the sums
  and leaves each rank its batch slice [T, B/N, D]; the MLPs are
  data-parallel as in `hybrid`;
- backward: the reduce-scatter's gradient is an all-gather, so each rank
  receives the whole pooled gradient and scatter-adds into the rows it owns
  alone: no gradient collective for the tables;
- the per-table QAT scales are local min/max over each table's rows in the
  rank's chunk, then a MIN and a MAX all-reduce of the [T] vectors; PACT's
  per-table normalizer is a MAX all-reduce of the segment maxima (a table
  spans ranks, so a rank's own maximum is not the table's).

The row-sharded exchange moves about N times the hybrid all-to-all's
pooled bytes: it buys capacity and balance, not bandwidth.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import (
    _mean_scale,
    _over,
    world_size,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.hybrid import (
    PACT_LEARNED_VW,
    _apply_block_update,
    _empty_block,
    _mlp_update,
    _pact_row_fn,
    _predict_gather,
    _rank,
    split_params,
    trick_pooled,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import staged
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    _check,
    _grads,
    _lr,
    _on,
    repeat_step,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves, tree_map

Device = Optional[Union[str, torch.device]]


class RowShardPlan(NamedTuple):
    """Static layout of the row-sharded mega-table."""

    n_dev: int
    chunk: int  # rows per rank (the last row of the global space is a zero pad row)
    table_base: np.ndarray  # [T] global base row of each table (0 for QR/MD tables)
    dense_mask: np.ndarray = None  # [T] bool: True = the table's rows live in the mega-table


def plan_row_sharding(table_sizes: Tuple[int, ...], n_dev: int,
                      kinds: Optional[Tuple[str, ...]] = None) -> RowShardPlan:
    """Lay out the global row space over the dense tables (JAX
    rowshard.py:63-89); QR/MD tables (`kinds` not "dense") get no rows and
    replicate next to the MLPs."""
    T = len(table_sizes)
    dense = np.asarray([kinds is None or kinds[k] == "dense" for k in range(T)], bool)
    base = np.zeros(T, np.int64)
    off = 0
    for k in range(T):
        if dense[k]:
            base[k] = off
            off += int(table_sizes[k])
    chunk = -(-(off + 1) // n_dev)  # +1 global zero pad row, ceil over the ranks
    return RowShardPlan(n_dev=n_dev, chunk=chunk, table_base=base, dense_mask=dense)


def pack_rows(tables: Sequence[Any], plan: RowShardPlan, rank: int = 0,
              device: Device = None) -> torch.Tensor:
    """Rank `rank`'s chunk [chunk, D] of the padded global mega-table (the
    dense tables concatenated, zeros after): the rows [rank * chunk,
    (rank + 1) * chunk). At one rank the chunk is the whole mega-table, JAX
    `pack_rows`'. QR/MD dict entries are skipped. Host tables are copied in
    one slice at a time."""
    arrays = [t for t in tables if not isinstance(t, dict)]
    if arrays:
        D, dt = arrays[0].shape[-1], arrays[0].dtype
        dev = torch.device(device) if device is not None else arrays[0].device
    else:  # every table is QR/MD: a 1-wide placeholder keeps the exchange uniform
        D, dt, dev = 1, torch.float32, resolve_device(device)
    block = torch.zeros((plan.chunk, D), dtype=dt, device=dev)
    lo_r, hi_r = rank * plan.chunk, (rank + 1) * plan.chunk
    for k, t in enumerate(tables):
        if isinstance(t, dict):
            continue
        base = int(plan.table_base[k])
        a, b = max(base, lo_r), min(base + t.shape[0], hi_r)
        if a < b:
            block[a - lo_r:b - lo_r] = t[a - base:b - base]
    return block


def unpack_rows(mega: torch.Tensor, plan: RowShardPlan,
                table_sizes: Sequence[int]) -> List[Optional[torch.Tensor]]:
    """The inverse of `pack_rows` over the whole padded mega-table (the
    ranks' chunks in rank order; at one rank, its chunk): a view of each
    table, None for QR/MD tables."""
    out = []
    for k, rows in enumerate(table_sizes):
        if plan.dense_mask is not None and not bool(plan.dense_mask[k]):
            out.append(None)
            continue
        base = int(plan.table_base[k])
        out.append(mega[base:base + rows])
    return out


def pack_rows_vw(v_W: Sequence[torch.Tensor], plan: RowShardPlan, rank: int = 0,
                 device: Device = None) -> torch.Tensor:
    """The dense tables' pooling weights in rank `rank`'s chunk of the
    global row layout [chunk] (pad rows weigh 0); QR/MD tables' weights
    replicate as `vw_trick`."""
    cols = [v[:, None] if plan.dense_mask is None or bool(plan.dense_mask[k]) else {}
            for k, v in enumerate(v_W)]
    return pack_rows(cols, plan, rank, device)[:, 0]


def unpack_rows_vw(vw: torch.Tensor, plan: RowShardPlan,
                   table_sizes: Sequence[int]) -> List[Optional[torch.Tensor]]:
    return [None if c is None else c[:, 0] for c in unpack_rows(vw[:, None], plan, table_sizes)]


def _local_ranges(plan: RowShardPlan, table_sizes: Sequence[int], rank: int) -> List[Optional[Tuple[int, int]]]:
    """Each dense table's rows in rank `rank`'s chunk, as a local [a, b)
    range (None where the chunk holds none of them, and for QR/MD)."""
    lo_r, hi_r = rank * plan.chunk, (rank + 1) * plan.chunk
    out = []
    for k, n in enumerate(table_sizes):
        base = int(plan.table_base[k])
        a, b = max(base, lo_r), min(base + n, hi_r)
        dense = plan.dense_mask is None or bool(plan.dense_mask[k])
        out.append((a - lo_r, b - lo_r) if dense and a < b else None)
    return out


def segment_ids_rows(plan: RowShardPlan, table_sizes: Sequence[int], rank: int,
                     device: Device = None) -> torch.Tensor:
    """[chunk] table id of each row of rank `rank`'s chunk (T for pad rows):
    row `rank` of JAX's `_pact_segments_rows` (rowshard.py:239-251), built
    by range fills."""
    segs = torch.full((plan.chunk,), len(table_sizes), dtype=torch.int32, device=device)
    for k, r in enumerate(_local_ranges(plan, table_sizes, rank)):
        if r is not None:
            segs[r[0]:r[1]] = k
    return segs


class RowShardState(NamedTuple):
    mega: torch.Tensor  # [chunk, D] this rank's chunk of the global mega-table
    mlp: Any  # replicated (see hybrid.HybridState)
    qstate: dlrm.QuantState
    vw: Any = None  # pooling weights of the chunk's rows [chunk]; None without weighted pooling


def init_rowshard_state(config: DLRMConfig, tc: TrainConfig, plan: RowShardPlan,
                        seed: Optional[int] = None, device: Device = None, group=None,
                        draw: bool = True) -> RowShardState:
    """`dlrm.init_params` (bit-identical to the JAX package's), this rank's
    chunk packed from it, the replicated rest, a fresh QuantState
    (`draw=False`: an undrawn template for a checkpoint)."""
    dev = resolve_device(device)
    rank = _rank(group)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed,
                              device=dev if draw else "cpu", draw=draw)
    if draw:
        mega = pack_rows(params["emb"], plan, rank, dev)
        mlp, vw = split_params(params, lambda v: pack_rows_vw(v, plan, rank, dev), dev)
    else:  # a template: the chunk allocated, nothing copied into it
        mega = _empty_block(params["emb"], plan.chunk, dev)
        mlp, vw = split_params(params, lambda v: torch.empty((plan.chunk,), device=dev), dev)
    return RowShardState(mega=mega, mlp=mlp, qstate=dlrm.init_quant_state(config, dev), vw=vw)


def _reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """[T, B, D] partial sums -> this rank's [T, B/N, D] slice of their sum
    over the ranks."""
    n = dist.get_world_size(group)
    T, B, D = x.shape
    send = x.reshape(T, n, B // n, D).transpose(0, 1).reshape(n * T, B // n, D).contiguous()
    buf = staged(send, group)
    out = buf.new_empty((T, B // n, D))
    dist.reduce_scatter_tensor(out, buf, group=group)
    return out.to(x.device)


def _all_gather_batch(g: torch.Tensor, group=None) -> torch.Tensor:
    """[T, B/N, D] on each rank -> [T, B, D], the ranks' slices in rank
    order."""
    n = dist.get_world_size(group)
    T, b, D = g.shape
    buf = staged(g.contiguous(), group)
    out = buf.new_empty((n * T, b, D))
    dist.all_gather_into_tensor(out, buf, group=group)
    return out.to(g.device).reshape(n, T, b, D).transpose(0, 1).reshape(T, n * b, D)


class _ReduceScatterBatch(torch.autograd.Function):
    """JAX's `psum_scatter(x, scatter_dimension=1, tiled=True)`; its
    gradient is the all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_batch(g, ctx.group), None


def reduce_scatter_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """The partial pooled sums [T, B, D] completed over the ranks and split
    on the batch: [T, B/N, D], differentiable."""
    return _ReduceScatterBatch.apply(x, group)


def _all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    buf = staged(x.contiguous(), group)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _partial_pooled(block: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor], me: int,
                    chunk: int, vw_block: Optional[torch.Tensor] = None,
                    table_valid: Optional[torch.Tensor] = None, row_fn=None) -> torch.Tensor:
    """[T, B, D] partial pooled sums over the rows this rank owns (JAX
    rowshard.py:212-236), in the block's dtype; `gids` [T, B, P] are global
    row ids, `table_valid` [T] False for QR/MD tables (their partials are
    exactly 0)."""
    local = gids - me * chunk
    owned = (local >= 0) & (local < chunk)
    if table_valid is not None:
        owned = owned & table_valid[:, None, None]
    safe = local.clamp(0, chunk - 1)
    rows = block.index_select(0, safe.reshape(-1))
    if row_fn is not None:
        rows = row_fn(rows, safe.reshape(-1))
    rows = rows.view(tuple(gids.shape) + (block.shape[1],))
    w = owned.to(rows.dtype)
    if vw_block is not None:  # each row's weight lives with the row
        w = w * vw_block[safe].to(rows.dtype)
    if mask is not None:
        w = w * mask.to(rows.dtype)
    return (rows * w[..., None]).sum(dim=2)


def _row_engine(config: DLRMConfig, plan: RowShardPlan, group, dev: torch.device):
    """What the train and eval steps share: rank, global bases, the QR/MD
    slots, the dense selector, PACT's segments and row transform."""
    me = dist.get_rank(group)
    T = config.num_tables
    qc = config.quant
    pact = qc.enabled and qc.quantize_emb and qc.quant_scheme == "pact"
    trick_ks = [k for k in range(T) if config.table_kind(k) != "dense"]
    dense_sel = torch.as_tensor(np.asarray(plan.dense_mask, bool), device=dev) if trick_ks else None
    base = torch.as_tensor(plan.table_base, dtype=torch.long, device=dev)[:, None, None]
    segs = segment_ids_rows(plan, config.table_sizes, me, dev) if pact else None

    def row_fn(block):
        """PACT's rows: the normalizers are the MAX over the ranks of each
        table's local segment maximum (JAX rowshard.py:394-407)."""
        if not pact:
            return None
        local = q.pact_segment_absmax(torch.tanh(block), segs, T)
        return _pact_row_fn(block, segs, T, qc.embedding_bit,
                            _all_reduce(local, dist.ReduceOp.MAX, group))

    def pooled_slice(batch, partial, trick_p, vw_trick):
        """Complete and shard the partials; splice in QR/MD."""
        raw = reduce_scatter_batch(partial, group).float()
        if not trick_ks:
            return raw
        b_local = raw.shape[1]
        tp = trick_pooled(config, trick_p, vw_trick, batch, me * b_local, b_local, trick_ks)
        return torch.stack([tp[k] if k in tp else raw[k] for k in range(T)])

    return me, trick_ks, dense_sel, base, row_fn, pooled_slice


def make_rowshard_train_step(config: DLRMConfig, tc: TrainConfig, plan: RowShardPlan, group=None,
                             steps_per_dispatch: int = 1, device: Device = None,
                             backend: Optional[str] = None):
    """The row-sharded train step (see the module docstring; JAX
    rowshard.py:312-606). The returned fn takes (RowShardState, the GLOBAL
    batch, the same on every rank) and returns (new RowShardState, the loss
    averaged over the ranks); `steps_per_dispatch` > 1 runs that many steps
    per call (`train_step.repeat_step`). The chunk and `v_W` are updated
    in place."""
    _check(tc)
    qc = config.quant
    if qc.enabled and qc.quantize_emb and qc.quant_scheme == "pact" and config.weighted_pooling == "learned":
        raise NotImplementedError(PACT_LEARNED_VW)
    dev = resolve_device(device)
    n = world_size(dev, backend, group)
    if n != plan.n_dev:
        raise ValueError(f"the plan splits the rows over {plan.n_dev} ranks; the group has {n}")
    me, trick_ks, dense_sel, base, row_fn, pooled_slice = _row_engine(config, plan, group, dev)
    T, chunk = config.num_tables, plan.chunk
    learned_vw = config.weighted_pooling == "learned"
    ranges = _local_ranges(plan, config.table_sizes, me)
    period = max(qc.scale_update_period, 1)

    def table_scales(block: torch.Tensor) -> torch.Tensor:
        """[T] scales from each table's rows over all ranks: local min/max
        (+inf/-inf where the chunk holds none), MIN/MAX all-reduce."""
        inf = torch.full((), float("inf"), device=dev)
        lo = torch.stack([inf if r is None else block[r[0]:r[1]].amin().float() for r in ranges])
        hi = torch.stack([-inf if r is None else block[r[0]:r[1]].amax().float() for r in ranges])
        lo = _all_reduce(lo, dist.ReduceOp.MIN, group)
        hi = _all_reduce(hi, dist.ReduceOp.MAX, group)
        scales = q.symmetric_quantization_params(qc.embedding_bit, lo, hi)
        if dense_sel is not None:  # QR/MD tables stay full precision: scale 1.0
            scales = torch.where(dense_sel, scales, torch.ones_like(scales))
        return scales

    def step_fn(state: RowShardState, batch: dlrm.Batch) -> Tuple[RowShardState, torch.Tensor]:
        batch = _on(batch, dev)
        block, qstate = state.mega, state.qstate
        B = batch.labels.shape[0]
        if B % n:
            raise ValueError(f"a global batch of {B} does not split over {n} ranks")
        b_local = B // n
        start = me * b_local
        gids = batch.indices.long() + base
        if qc.enabled and qstate.step % period == 0:
            with torch.no_grad():
                qstate = qstate._replace(emb_scales=table_scales(block))
        with torch.no_grad():
            partial = _partial_pooled(block, gids, batch.mask, me, chunk, state.vw, dense_sel,
                                      row_fn(block))
        partial.requires_grad_()
        mlp = tree_map(lambda t: t.detach().requires_grad_(), state.mlp)
        vw_trick = mlp.get("vw_trick")
        if vw_trick is not None and not learned_vw:
            vw_trick = tree_map(torch.Tensor.detach, vw_trick)
        raw = pooled_slice(batch, partial, mlp.get("emb_trick"), vw_trick)
        local = dlrm.Batch(dense=batch.dense[start:start + b_local], indices=batch.indices[:, :1],
                           labels=batch.labels[start:start + b_local], mask=None)
        logits, new_qs = dlrm.forward(config, {**mlp, "emb": []}, local, qstate, train=True,
                                      raw_pooled=raw, lsq_numel_scale=float(n))
        loss = dlrm.training_loss(config, logits, local.labels)
        *mlp_grads, g_partial = _grads(loss, tree_leaves(mlp) + [partial])
        # g_partial: the whole [T, B, D] pooled gradient of the sum of the
        # ranks' losses, the same on every rank
        lr = _lr(tc, qstate.step + 1)
        with torch.no_grad():
            mean_loss = _mean_scale(loss, group)
            new_mlp = _mlp_update(state.mlp, mlp_grads, tc, lr, group)
            local_ids = gids - me * chunk
            owned = (local_ids >= 0) & (local_ids < chunk)
            if dense_sel is not None:  # QR/MD ids alias dense rows: never scatter them
                owned = owned & dense_sel[:, None, None]
            new_vw = _apply_block_update(block, state.vw, local_ids, owned, g_partial, batch.mask,
                                         _over(lr, n), learned_vw)
        return RowShardState(block, new_mlp, new_qs._replace(step=qstate.step + 1), new_vw), mean_loss

    if steps_per_dispatch > 1:
        return repeat_step(step_fn, steps_per_dispatch)
    return step_fn


def make_rowshard_eval_step(config: DLRMConfig, plan: RowShardPlan, group=None, device: Device = None,
                            backend: Optional[str] = None):
    """Sharded inference over the row-sharded state (JAX rowshard.py:
    609-699): every rank returns the GLOBAL batch's [B] scores."""
    dev = resolve_device(device)
    n = world_size(dev, backend, group)
    me, _, dense_sel, base, row_fn, pooled_slice = _row_engine(config, plan, group, dev)

    @torch.no_grad()
    def eval_fn(state: RowShardState, batch: dlrm.Batch) -> torch.Tensor:
        batch = _on(batch, dev)
        b_local = batch.labels.shape[0] // n
        start = me * b_local
        partial = _partial_pooled(state.mega, batch.indices.long() + base, batch.mask, me, plan.chunk,
                                  state.vw, dense_sel, row_fn(state.mega))
        raw = pooled_slice(batch, partial, state.mlp.get("emb_trick"), state.mlp.get("vw_trick"))
        local = dlrm.Batch(dense=batch.dense[start:start + b_local], indices=batch.indices[:, :1],
                           labels=batch.labels[start:start + b_local], mask=None)
        return _predict_gather(config, state, local, raw, group)

    return eval_fn
