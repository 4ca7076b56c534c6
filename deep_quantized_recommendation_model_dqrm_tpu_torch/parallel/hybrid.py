"""Hybrid parallelism: table-sharded embeddings and data-parallel MLPs.

Port of the JAX package's parallel/hybrid.py, the reference's hybrid
scripts (dlrm_s_pytorch_hybrid_multi_gpu.py:819-945 `distributed_forward`,
dlrm_s_pytorch_quantization_tr_two.py): each rank owns a subset of the
tables, looks up the FULL batch for them, and an all-to-all swaps
table-major to batch-major so that every rank ends with every table's
pooled output for its batch slice; the MLPs are replicated and trained
data-parallel.

One process per rank (NCCL on the card, one rank per device; gloo where
the caller names it), where JAX runs one `shard_map` over a mesh axis:

- the tables a rank owns are packed into its **block** of the mega-table,
  [block_rows, D], one table after another, with one zero pad row at the
  end that empty slots point at (`plan_table_sharding`: greedy row
  balancing, or the reference's contiguous or round-robin placement);
- the scale refresh reduces each of the rank's tables over its row range
  of the block (min and max are exact, so the scales equal a whole-table
  scan's) and all-gathers the [t_max] slot scales;
- the forward gathers the rank's slots over the full batch (a rank's
  tables, plus zero rows for empty slots), exchanges them
  (`compressed_a2a.all_to_all`, or `compressed_all_to_all` at
  `a2a_quant_bits` < 32), splices in the QR/MD tables, which are small and
  replicated next to the MLPs, and runs `dlrm.forward` from the pooled
  outputs on the rank's batch slice; autograd of the loss gives the MLP
  gradients and the pooled block's, which the exchange's transpose routes
  back to the owning rank;
- the MLP gradients take the mean over the ranks, through the compressed
  integer all-reduce at `grad_quant_bits` < 32; the block takes one local
  scatter-add of -(lr / N) times the pooled gradient into the rows the
  batch touched (cast to the block's dtype after the scaling), as does a
  learned `v_W`.

The step runs eagerly and updates the block (and `v_W`) in place. A step
built for the card refuses to run without a process group and on a group
whose backend is not the one asked for (`comm_grad.world_size`).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import clamp_ids, scatter_add_drop
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import (
    _gather,
    _mean_scale,
    _mean_tensors,
    _over,
    compressed_psum_batched,
    world_size,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.compressed_a2a import (
    all_to_all,
    compressed_all_to_all,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.mesh import table_assignment
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    _check,
    _grads,
    _lr,
    _on,
    _unflatten,
    repeat_step,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves, tree_map

Device = Optional[Union[str, torch.device]]

PACT_LEARNED_VW = ("quant_scheme='pact' + weighted_pooling='learned' is not supported by the "
                   "mega-table engines; use parallelism=none/dp")


class TableShardingPlan(NamedTuple):
    """Static metadata of the mega-table packing (host-side numpy)."""

    n_dev: int
    block_rows: int  # rows per rank's block (incl. its final zero pad row)
    t_max: int  # max tables per rank (slots padded with -1)
    table_rank: np.ndarray  # [T] owning rank of each table (-1: QR/MD, replicated)
    table_slot: np.ndarray  # [T] slot index within the owner
    table_base: np.ndarray  # [T] row offset of the table within its block
    local_ids: np.ndarray  # [n_dev, t_max] table id per slot (-1 = empty)
    local_base: np.ndarray  # [n_dev, t_max] base row per slot (pad row for empty slots)
    perm: np.ndarray  # [T] position of table k in the all-to-all output (-1: QR/MD)


def plan_table_sharding(
    table_sizes: Tuple[int, ...],
    n_dev: int,
    strategy: str = "greedy",
    kinds: Optional[Tuple[str, ...]] = None,
) -> TableShardingPlan:
    """Assign tables to ranks and lay out each rank's row block (JAX
    hybrid.py:61-137).

    strategy="greedy": longest-processing-time row balancing;
    "contiguous": the reference's `get_my_slice` split (dlrm_s_pytorch.py:
    243-245); "roundrobin": table k -> rank k % n (dlrm_s_pytorch.py:
    617-733). `kinds` (config.table_kind per table): QR/MD tables get no
    rows (rank and perm -1); the engines carry them replicated."""
    T = len(table_sizes)
    dense = [k for k in range(T) if kinds is None or kinds[k] == "dense"]
    if strategy == "contiguous":
        per_rank = [[dense[i] for i in g] for g in table_assignment(len(dense), n_dev)]
    elif strategy == "roundrobin":
        per_rank = [[] for _ in range(n_dev)]
        for i, k in enumerate(dense):
            per_rank[i % n_dev].append(k)
    else:
        sizes = np.asarray([table_sizes[k] for k in dense], np.int64)
        order = np.argsort(-sizes, kind="stable")
        loads = np.zeros(n_dev, np.int64)
        per_rank = [[] for _ in range(n_dev)]
        for i in order:
            r = int(np.argmin(loads))
            per_rank[r].append(dense[int(i)])
            loads[r] += sizes[i]
        per_rank = [sorted(g) for g in per_rank]  # table order within a rank

    t_max = max(max((len(g) for g in per_rank), default=1), 1)
    table_rank = np.full(T, -1, np.int32)
    table_slot = np.zeros(T, np.int32)
    table_base = np.zeros(T, np.int64)
    local_ids = np.full((n_dev, t_max), -1, np.int32)
    rank_rows = np.zeros(n_dev, np.int64)
    for r, group in enumerate(per_rank):
        off = 0
        for s, k in enumerate(group):
            table_rank[k], table_slot[k], table_base[k] = r, s, off
            local_ids[r, s] = k
            off += table_sizes[k]
        rank_rows[r] = off
    block_rows = int(rank_rows.max()) + 1  # +1 zero pad row
    local_base = np.full((n_dev, t_max), block_rows - 1, np.int64)
    for k in dense:
        local_base[table_rank[k], table_slot[k]] = table_base[k]
    perm = (table_rank.astype(np.int64) * t_max + table_slot).astype(np.int32)
    perm[table_rank < 0] = -1
    return TableShardingPlan(n_dev=n_dev, block_rows=block_rows, t_max=t_max, table_rank=table_rank,
                             table_slot=table_slot, table_base=table_base, local_ids=local_ids,
                             local_base=local_base, perm=perm)


def pack_tables(tables: Sequence[Any], plan: TableShardingPlan, rank: int = 0,
                device: Device = None) -> torch.Tensor:
    """Rank `rank`'s block [block_rows, D] of the mega-table: its tables
    copied in one after another, the rest zero (JAX `pack_tables` gives
    the whole [n_dev * block_rows, D] mega-table; a rank here holds only its
    block). QR/MD dict entries are skipped. The block lies on `device`
    (default: the tables' device); host tables are copied in one at a time
    (the counterpart of JAX's `pack_tables_pinned_streaming`, whose peak is
    the block plus one table)."""
    arrays = [t for t in tables if not isinstance(t, dict)]
    if arrays:
        D, dt = arrays[0].shape[-1], arrays[0].dtype
        dev = torch.device(device) if device is not None else arrays[0].device
    else:  # every table is QR/MD: a 1-wide placeholder keeps the exchange uniform
        D, dt, dev = 1, torch.float32, resolve_device(device)
    block = torch.zeros((plan.block_rows, D), dtype=dt, device=dev)
    for k, t in enumerate(tables):
        if isinstance(t, dict) or int(plan.table_rank[k]) != rank:
            continue
        base = int(plan.table_base[k])
        block[base:base + t.shape[0]] = t
    return block


def unpack_tables(block: torch.Tensor, plan: TableShardingPlan, table_sizes: Sequence[int],
                  rank: int = 0) -> List[Optional[torch.Tensor]]:
    """The inverse of `pack_tables`: views of the tables of rank `rank`'s
    block; None for a table another rank owns or a QR/MD table."""
    out = []
    for k, rows in enumerate(table_sizes):
        if int(plan.table_rank[k]) != rank:
            out.append(None)
            continue
        base = int(plan.table_base[k])
        out.append(block[base:base + rows])
    return out


def pack_vw(v_W: Sequence[torch.Tensor], plan: TableShardingPlan, rank: int = 0,
            device: Device = None) -> torch.Tensor:
    """The pooling weights [n_k] of rank `rank`'s tables in its block's row
    layout [block_rows] (pad and empty rows weigh 0). QR/MD tables' weights
    are skipped: they replicate next to their tables as `vw_trick`."""
    cols = [v[:, None] if int(plan.table_rank[k]) >= 0 else {} for k, v in enumerate(v_W)]
    return pack_tables(cols, plan, rank, device)[:, 0]


def unpack_vw(vw: torch.Tensor, plan: TableShardingPlan, table_sizes: Sequence[int],
              rank: int = 0) -> List[Optional[torch.Tensor]]:
    """The inverse of `pack_vw` (None for tables not in the block)."""
    return [None if c is None else c[:, 0] for c in unpack_tables(vw[:, None], plan, table_sizes, rank)]


def segment_ids(plan: TableShardingPlan, table_sizes: Sequence[int], rank: int,
                device: Device = None) -> torch.Tensor:
    """[block_rows] table id of each row of rank `rank`'s block (T for pad
    rows): the per-table DoReFa normalization's segments (row `rank` of
    JAX's `_pact_segments`, hybrid.py:263-278), built by range fills."""
    segs = torch.full((plan.block_rows,), len(table_sizes), dtype=torch.int32, device=device)
    for k, n in enumerate(table_sizes):
        if int(plan.table_rank[k]) == rank:
            b = int(plan.table_base[k])
            segs[b:b + n] = k
    return segs


class HybridState(NamedTuple):
    mega: torch.Tensor  # [block_rows, D] this rank's block of the mega-table
    mlp: Any  # replicated: {"bot", "top"} and where present LSQ's steps, "emb_trick", "vw_trick"
    qstate: dlrm.QuantState
    # pooling weights v_W in the block's row layout [block_rows]; None
    # unless config.weighted_pooling is set ("fixed" never updated,
    # "learned" takes the block's local scatter-add)
    vw: Any = None


def _rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def split_params(params: dlrm.Params, vw_packer: Callable, device: torch.device) -> Tuple[Any, Any]:
    """(the replicated part of a params dict, the packed v_W or None): the
    MLPs and LSQ's steps, the QR/MD tables as "emb_trick" {str(k): dict}
    and their pooling weights as "vw_trick" (JAX hybrid.py:392-422). Each
    leaf is moved to `device`."""
    mlp = {k: v for k, v in params.items() if k not in ("emb", "v_W")}
    trick = {str(k): t for k, t in enumerate(params["emb"]) if isinstance(t, dict)}
    if trick:
        mlp["emb_trick"] = trick
    vw = None
    if "v_W" in params:
        vw = vw_packer(params["v_W"])
        if trick:
            mlp["vw_trick"] = {k: params["v_W"][int(k)] for k in trick}
    return tree_map(lambda t: t.to(device), mlp), vw


def init_hybrid_state(config: DLRMConfig, tc: TrainConfig, plan: TableShardingPlan,
                      seed: Optional[int] = None, device: Device = None, group=None,
                      pin_mega_layout: bool = False, draw: bool = True) -> HybridState:
    """`dlrm.init_params` (bit-identical to the JAX package's), this rank's
    block packed from it, the replicated rest, a fresh QuantState.
    `pin_mega_layout`: draw the tables on the host and copy them into the
    block one at a time, so the card holds the block alone (JAX's pinned
    streaming build, hybrid.py:295-340); otherwise they are drawn on the
    card and packed there. `draw=False`: an undrawn template for a
    checkpoint that replaces every leaf."""
    dev = resolve_device(device)
    rank = _rank(group)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed,
                              device="cpu" if pin_mega_layout or not draw else dev, draw=draw)
    if draw:
        mega = pack_tables(params["emb"], plan, rank, dev)
        mlp, vw = split_params(params, lambda v: pack_vw(v, plan, rank, dev), dev)
    else:  # a template: the block allocated, nothing copied into it
        mega = _empty_block(params["emb"], plan.block_rows, dev)
        mlp, vw = split_params(params, lambda v: torch.empty((plan.block_rows,), device=dev), dev)
    return HybridState(mega=mega, mlp=mlp, qstate=dlrm.init_quant_state(config, dev), vw=vw)


def _empty_block(tables: Sequence[Any], rows: int, dev: torch.device) -> torch.Tensor:
    arrays = [t for t in tables if not isinstance(t, dict)]
    D, dt = (arrays[0].shape[-1], arrays[0].dtype) if arrays else (1, torch.float32)
    return torch.empty((rows, D), dtype=dt, device=dev)


def _local_rows(indices: torch.Tensor, local_ids: torch.Tensor,
                local_base: torch.Tensor) -> torch.Tensor:
    """[t_max, B, P] block rows of the rank's slots over the full batch
    (empty slots: the pad row)."""
    idx = indices.index_select(0, local_ids.clamp_min(0)).long()
    valid = (local_ids >= 0)[:, None, None]
    return torch.where(valid, idx, 0) + local_base[:, None, None]


def _local_pooled(block: torch.Tensor, rows_idx: torch.Tensor, mask: Optional[torch.Tensor],
                  vw_block: Optional[torch.Tensor] = None, row_fn=None) -> torch.Tensor:
    """Pooled lookups [t_max, B, D] of the rank's slots (the reference's
    `apply_emb(local tables, FULL batch)`, hybrid_multi_gpu.py:853; JAX
    hybrid.py:425-450), in the block's dtype. `mask` is [t_max, B, P];
    `vw_block` scales each row by its pooling weight; `row_fn(rows, ids)`
    transforms the gathered rows (PACT)."""
    ids = clamp_ids(rows_idx.reshape(-1), block.shape[0])[0]
    rows = block.index_select(0, ids)
    if row_fn is not None:
        rows = row_fn(rows, ids)
    rows = rows.view(tuple(rows_idx.shape) + (block.shape[1],))
    if vw_block is not None:
        rows = rows * vw_block[ids].view(rows_idx.shape)[..., None].to(rows.dtype)
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    return rows.sum(dim=2)


def trick_pooled(config: DLRMConfig, trick_p: dict, vw_trick: Optional[dict], batch: dlrm.Batch,
                 start: int, b_local: int, ks: Sequence[int]) -> dict:
    """{k: [b_local, D] float32}: the replicated QR/MD tables' pooled outputs
    on this rank's batch slice, differentiable through `trick_p` (and
    learned `vw_trick`); JAX hybrid.py:233-256, rowshard.py:254-281."""
    out = {}
    for k in ks:
        idx = batch.indices[k, start:start + b_local]
        m = None if batch.mask is None else batch.mask[k, start:start + b_local]
        if vw_trick is not None:  # per_sample_weights = v_W[idx] (dlrm_s_pytorch.py:417-448)
            v = vw_trick[str(k)]
            w = v[clamp_ids(idx, v.shape[0])[0]]
            m = w if m is None else m * w
        out[k] = dlrm.trick_pooled_lookup(config, trick_p[str(k)], idx, m).float()
    return out


def _pact_row_fn(block: torch.Tensor, segs: torch.Tensor, T: int, bits: int, seg_max=None):
    """PACT on gathered rows: the rows of `fake_quant_pact_segmented(block)`,
    bit for bit, without writing the transformed block (the normalizers
    come from one tanh pass over it, or `seg_max` when given)."""
    if seg_max is None:
        seg_max = q.pact_segment_absmax(torch.tanh(block), segs, T)
    return lambda rows, ids: q.pact_apply_segmented(torch.tanh(rows), bits, segs[ids], T, seg_max)


def _mlp_update(mlp, leaves: List[torch.Tensor], tc: TrainConfig, lr: float, group):
    """The mean over the ranks of each replicated leaf's gradient (`leaves`,
    in `tree_leaves(mlp)` order): the compressed integer all-reduce at
    grad_quant_bits < 32, per channel for 2-D leaves (bit-identical to
    `compressed_psum_dense` leaf by leaf), one float32 all-reduce
    otherwise; then SGD (JAX hybrid.py:652-674)."""
    if tc.grad_quant_bits < 32:
        means = compressed_psum_batched(leaves, tc.grad_quant_bits, [g.dim() == 2 for g in leaves], group)
    else:
        means = _mean_tensors(leaves, group)
    return sgd_update(mlp, _unflatten(mlp, means), lr)


def make_hybrid_train_step(config: DLRMConfig, tc: TrainConfig, plan: TableShardingPlan, group=None,
                           steps_per_dispatch: int = 1, device: Device = None,
                           backend: Optional[str] = None):
    """The hybrid-parallel train step (see the module docstring; JAX
    hybrid.py:453-800). The returned fn takes (HybridState, the GLOBAL
    batch: every rank passes the same batch, whose dense features and labels
    it slices to its rows while the ids stay whole) and returns (new
    HybridState, the loss averaged over the ranks). `steps_per_dispatch` > 1
    runs that many steps per call over a list of batches or one stacked
    Batch (`train_step.repeat_step`)."""
    _check(tc)
    qc = config.quant
    pact = qc.enabled and qc.quantize_emb and qc.quant_scheme == "pact"
    if pact and config.weighted_pooling == "learned":
        # learned v_W's gradient would need the fake-quantized rows
        raise NotImplementedError(PACT_LEARNED_VW)
    dev = resolve_device(device)
    n = world_size(dev, backend, group)
    if n != plan.n_dev:
        raise ValueError(f"the plan lays out {plan.n_dev} blocks; the group has {n} ranks")
    me = dist.get_rank(group)
    T = config.num_tables
    learned_vw = config.weighted_pooling == "learned"
    local_ids = torch.as_tensor(plan.local_ids[me], dtype=torch.long, device=dev)
    local_base = torch.as_tensor(plan.local_base[me], dtype=torch.long, device=dev)
    valid = (local_ids >= 0)[:, None, None]
    # JAX gathers all_slot.reshape(-1)[perm]: its -1 (QR/MD) wraps to the last slot
    perm = torch.as_tensor(plan.perm.astype(np.int64) % (n * plan.t_max), device=dev)
    trick_ks = [k for k in range(T) if int(plan.table_rank[k]) < 0]
    segs = segment_ids(plan, config.table_sizes, me, dev) if pact else None
    # each slot's row range [base, next) of the block: its table's rows
    bases = [int(b) for b in plan.local_base[me]] + [plan.block_rows - 1]
    slot_ranges = [(bases[s], bases[s + 1]) if plan.local_ids[me, s] >= 0 else None
                   for s in range(plan.t_max)]
    period = max(qc.scale_update_period, 1)

    def slot_scales(block: torch.Tensor) -> torch.Tensor:
        """Per-slot table-wide scales [t_max] from the rank's block (0-range
        scales for empty slots), reduced in the block's dtype."""
        zero = torch.zeros((), device=dev)
        lo, hi = [], []
        for r in slot_ranges:
            part = None if r is None else block[r[0]:r[1]]
            lo.append(zero if part is None else part.amin().float())
            hi.append(zero if part is None else part.amax().float())
        return q.symmetric_quantization_params(qc.embedding_bit, torch.stack(lo), torch.stack(hi))

    def step_fn(state: HybridState, batch: dlrm.Batch) -> Tuple[HybridState, torch.Tensor]:
        batch = _on(batch, dev)
        block, qstate = state.mega, state.qstate
        B = batch.labels.shape[0]
        if B % n:
            raise ValueError(f"a global batch of {B} does not split over {n} ranks")
        b_local = B // n
        start = me * b_local
        if qc.enabled and qstate.step % period == 0:
            with torch.no_grad():
                all_slot = _gather(slot_scales(block), group).reshape(-1)  # [n * t_max]
            qstate = qstate._replace(emb_scales=all_slot[perm])

        rows_idx = _local_rows(batch.indices, local_ids, local_base)
        mask = None if batch.mask is None else batch.mask.index_select(0, local_ids.clamp_min(0))
        with torch.no_grad():
            row_fn = _pact_row_fn(block, segs, T, qc.embedding_bit) if pact else None
            pooled = _local_pooled(block, rows_idx, mask, state.vw, row_fn)
        pooled.requires_grad_()
        mlp = tree_map(lambda t: t.detach().requires_grad_(), state.mlp)
        if tc.a2a_quant_bits < 32:
            swapped = compressed_all_to_all(pooled, group, tc.a2a_quant_bits, 1, 0)
        else:
            swapped = all_to_all(pooled, group, 1, 0)
        vw_trick = mlp.get("vw_trick")
        if vw_trick is not None and not learned_vw:
            vw_trick = tree_map(torch.Tensor.detach, vw_trick)
        raw = _assemble_pooled(config, plan, perm, swapped.float(), mlp.get("emb_trick"), batch,
                               start, b_local, trick_ks, vw_trick)
        local = dlrm.Batch(dense=batch.dense[start:start + b_local], indices=batch.indices[:, :1],
                           labels=batch.labels[start:start + b_local], mask=None)
        logits, new_qs = dlrm.forward(config, {**mlp, "emb": []}, local, qstate, train=True,
                                      raw_pooled=raw, lsq_numel_scale=float(n))
        loss = dlrm.training_loss(config, logits, local.labels)
        *mlp_grads, g_pooled = _grads(loss, tree_leaves(mlp) + [pooled])
        # g_pooled holds every rank's contribution: the gradient of the sum
        # of the ranks' losses, hence lr / N below
        lr = _lr(tc, qstate.step + 1)
        lr_n = _over(lr, n)
        with torch.no_grad():
            mean_loss = _mean_scale(loss, group)
            new_mlp = _mlp_update(state.mlp, mlp_grads, tc, lr, group)
            new_vw = _apply_block_update(block, state.vw, rows_idx, valid, g_pooled, mask, lr_n,
                                         learned_vw)
        return HybridState(block, new_mlp, new_qs._replace(step=qstate.step + 1), new_vw), mean_loss

    if steps_per_dispatch > 1:
        return repeat_step(step_fn, steps_per_dispatch)
    return step_fn


def _apply_block_update(block, vw, rows_idx, owned, g, mask, lr_n: float, learned_vw: bool):
    """The block's local scatter-add of -(lr / N) g into the rows the batch
    touched (rows not `owned` dropped), scaled by the pooling weights and
    the mask, cast to the block's dtype after the scaling; learned `v_W`
    takes -(lr / N) mask * (g . E[row]) the same way, from the block before
    its update (JAX hybrid.py:676-717, rowshard.py:490-531). Both in
    place; returns `vw`."""
    drop = torch.where(owned, rows_idx, block.shape[0]).reshape(-1)
    safe = clamp_ids(rows_idx.reshape(-1), block.shape[0])[0]
    vals = g[:, :, None, :].expand(tuple(rows_idx.shape) + (g.shape[-1],))
    if vw is not None:
        if learned_vw:
            rows_e = block.index_select(0, safe).view(vals.shape)
            contrib = torch.einsum("tbd,tbpd->tbp", g, rows_e.to(g.dtype))
            if mask is not None:
                contrib = contrib * mask
            vw_upd = -lr_n * contrib.reshape(-1).float()
        vals = vals * vw[safe].view(rows_idx.shape)[..., None].to(vals.dtype)
        if learned_vw:
            scatter_add_drop(vw, drop, vw_upd)
    if mask is not None:
        vals = vals * mask[..., None].to(vals.dtype)
    # cast after the scaling: the product is float32, as in JAX
    scatter_add_drop(block, drop, (-lr_n * vals.reshape(-1, vals.shape[-1]).float()).to(block.dtype))
    return vw


def _assemble_pooled(config: DLRMConfig, plan: TableShardingPlan, perm: torch.Tensor,
                     swapped: torch.Tensor, trick_p: Optional[dict], batch: dlrm.Batch, start: int,
                     b_local: int, trick_ks: Sequence[int], vw_trick: Optional[dict]) -> torch.Tensor:
    """Batch-major pooled outputs [T, B/N, D] of every table: the owned
    tables from the exchange's output, the QR/MD tables computed here from
    the replicated params on this rank's batch slice (JAX hybrid.py:
    217-259)."""
    if not trick_ks:
        return swapped.index_select(0, perm)
    tp = trick_pooled(config, trick_p, vw_trick, batch, start, b_local, trick_ks)
    return torch.stack([tp[k] if k in tp else swapped[int(plan.perm[k])]
                        for k in range(config.num_tables)])


def make_hybrid_eval_step(config: DLRMConfig, plan: TableShardingPlan, group=None,
                          device: Device = None, backend: Optional[str] = None):
    """Sharded inference over the hybrid state (JAX hybrid.py:803-884): the
    tables stay in their blocks, each rank scores its slice of the GLOBAL
    batch after the plain all-to-all, and the probabilities are
    all-gathered: every rank returns the whole batch's [B] scores."""
    dev = resolve_device(device)
    n = world_size(dev, backend, group)
    me = dist.get_rank(group)
    qc = config.quant
    pact = qc.enabled and qc.quantize_emb and qc.quant_scheme == "pact"
    T = config.num_tables
    local_ids = torch.as_tensor(plan.local_ids[me], dtype=torch.long, device=dev)
    local_base = torch.as_tensor(plan.local_base[me], dtype=torch.long, device=dev)
    perm = torch.as_tensor(plan.perm.astype(np.int64) % (n * plan.t_max), device=dev)
    trick_ks = [k for k in range(T) if int(plan.table_rank[k]) < 0]
    segs = segment_ids(plan, config.table_sizes, me, dev) if pact else None

    @torch.no_grad()
    def eval_fn(state: HybridState, batch: dlrm.Batch) -> torch.Tensor:
        batch = _on(batch, dev)
        b_local = batch.labels.shape[0] // n
        start = me * b_local
        rows_idx = _local_rows(batch.indices, local_ids, local_base)
        mask = None if batch.mask is None else batch.mask.index_select(0, local_ids.clamp_min(0))
        row_fn = _pact_row_fn(state.mega, segs, T, qc.embedding_bit) if pact else None
        pooled = _local_pooled(state.mega, rows_idx, mask, state.vw, row_fn)
        raw = _assemble_pooled(config, plan, perm, all_to_all(pooled, group, 1, 0).float(),
                               state.mlp.get("emb_trick"), batch, start, b_local, trick_ks,
                               state.mlp.get("vw_trick"))
        local = dlrm.Batch(dense=batch.dense[start:start + b_local], indices=batch.indices[:, :1],
                           labels=batch.labels[start:start + b_local], mask=None)
        return _predict_gather(config, state, local, raw, group)

    return eval_fn


def _predict_gather(config: DLRMConfig, state, local: dlrm.Batch, raw: torch.Tensor, group):
    logits, _ = dlrm.forward(config, {**state.mlp, "emb": []}, local, state.qstate, train=False,
                             raw_pooled=raw)
    p = torch.sigmoid(logits)
    if 0.0 < config.loss_threshold < 1.0:
        p = torch.clamp(p, config.loss_threshold, 1.0 - config.loss_threshold)
    return _gather(p, group).reshape(-1)
