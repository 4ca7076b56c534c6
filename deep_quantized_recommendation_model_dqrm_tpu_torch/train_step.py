"""Single-device train and eval steps with SGD, Adagrad and RWSAdagrad.

Port of the JAX package's train_step.py: forward -> loss -> backward -> LR
policy -> optimizer, with the QAT scale refresh folded in as explicit state.

- `_build_step_fn`: autograd through everything, tables included (dense
  table gradients). The cross-check, and the path on which kernel K4's
  backward (through K1) runs when `onehot_lookup_max_rows` is set.
- `_build_sparse_step_fn`: autograd is cut at the pooled lookups; each
  table takes its gradient as (ids, rows) pairs, applied by
  `apply_table_updates` along the routes `make_table_routes` fixes (the
  data-parallel and pseudo engines of `parallel/` apply their exchanged
  rows the same way):
  - tables with at most `onehot_update_max_rows` rows get their dense
    gradients from one launch of kernel K1 for all of them, straight from
    the pooled gradient, ids and mask, and a dense optimizer update (under
    SGD one batched multiply and one batched add);
  - tables above that and with at most `stream_update_max_rows` rows have
    their gradients sorted in one batched sort and applied by one launch of
    kernel K5 for all of them: straight into the tables under SGD (after
    one multiply by -lr), into zeroed dense gradients (one buffer) under
    Adagrad and RWSAdagrad, which then take the dense update;
  - the others take a scatter-add: under SGD the duplicate scatter,
    pre-coalesced when the table has at most 1M rows and the step at least
    4096 updates (train_step.py:427-443 of the JAX package); under Adagrad
    and RWSAdagrad a coalesced update of the touched rows.

There is no jit to donate the state to, so the sparse step updates every
tensor of the state passed to it in place, on any device (the tables, the
dense leaves, their optimizer state, the QAT state's tensors), and returns
that state with its step count advanced; on a CUDA state it runs as one
CUDA graph replayed per step (`_SparseStep`). A caller that needs the old
state clones it first (`clone_state`). `plain=True` makes the steps call the
plain versions of K1, K4, K5 and the dense leaves' kernels on any device,
eagerly: the reference the kernels are held against on the card. The dense
step returns new parameters.

Every QAT scheme of the model runs through both steps: HAWQ, PACT and LSQ,
with or without the integer-activation chain. The parameters other than the
tables (the MLPs, LSQ's step sizes and the pooling weights `v_W`) take
autograd's dense gradients and SGD, or classic Adagrad under both Adagrad
optimizers.

The rest of the single-device model runs through both steps too (JAX
train_step.py:186-230, 280-290, 325-362, 499-560):
- QR/MD tables take no route: the sparse step recomputes their pooled
  lookups with their gradient (`dlrm.splice_trick_pooled`) and updates
  each of their leaves densely;
- under weighted pooling the dense tables' gradients are scaled by
  `v_W[ids]` (the pooling weights stand in for K1's mask), and learned
  `v_W` of the dense tables takes the per-occurrence scalar gradients
  g_pooled . E[row] (PACT-transformed rows under PACT), coalesced across
  the tables in one pass and applied to the touched entries;
- a bf16 table takes its float32 update rounded to bf16 before the add.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    DenseGradGroup,
    bag_of,
    dense_grad_grouped_plain,
    group_slots,
    make_dense_grad_group,
    onehot_dense_grad_grouped,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
    MAX_GROUP_TABLES as STREAM_GROUP_TABLES,
    sort_sparse_grads_batched,
    stream_scatter_add_grouped,
    stream_scatter_grouped_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.qat_dense import dense_update_, dense_update_plain_
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    clamp_ids,
    coalesce_sparse_grad,
    coalesce_sparse_grads_batched,
    rows_grad_from_pooled,
    scatter_add_drop,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.lr_policy import lr_policy
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import (
    EPS,
    adagrad_init,
    adagrad_update,
    rwsadagrad_init,
    rwsadagrad_update,
    sgd_update,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.cuda_graph import GraphedCall
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.profiling import annotate
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves, tree_map

Device = Optional[Union[str, torch.device]]
Step = Callable[["TrainState", dlrm.Batch], Tuple["TrainState", torch.Tensor]]
LR = Union[float, torch.Tensor]  # a Python float, or a 0-d float32 tensor on the step's device

# Pre-coalescing gates of the JAX package's sparse step (train_step.py:38-39).
_SORTED_SCATTER_MAX_ROWS = 1_000_000
_SORTED_SCATTER_MIN_UPDATES = 4096


class TrainState(NamedTuple):
    params: dlrm.Params
    opt_state: Any  # None for plain SGD
    qstate: dlrm.QuantState


def _check(tc: TrainConfig) -> None:
    if tc.optimizer not in ("sgd", "adagrad", "rwsadagrad"):
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")


def _unflatten(tree, leaves: Sequence[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def clone_state(state: TrainState) -> TrainState:
    """A copy of `state` that shares no tensor with it, optimizer state
    included."""
    qs = state.qstate
    return TrainState(
        params=tree_map(torch.clone, state.params),
        opt_state=None if state.opt_state is None else tree_map(torch.clone, state.opt_state),
        qstate=qs._replace(emb_scales=qs.emb_scales.clone(), act_min=qs.act_min.clone(),
                           act_max=qs.act_max.clone()),
    )


def config_for_epoch(config: DLRMConfig, tc: TrainConfig, epoch: int) -> DLRMConfig:
    """QAT epoch schedule (comm_grad.py:1849-1872 of the reference): FP32
    pretrain epochs, delayed MLP quantization, a mid-training bit-width
    shift. Returns the effective config for `epoch` (`config` itself when
    nothing changes); callers rebuild the step when it changes."""
    qc = config.quant
    if not qc.enabled:
        return config
    if epoch < tc.pretrain_epochs:
        return dataclasses.replace(config, quant=dataclasses.replace(qc, enabled=False))
    quantize_mlp = qc.quantize_mlp and (
        tc.quantize_mlp_from_epoch < 0 or epoch >= tc.quantize_mlp_from_epoch
    )
    wb, bb = qc.weight_bit, qc.bias_bit
    if 0 <= tc.shift_bit_width_at_epoch <= epoch:
        wb = tc.shift_bit_width_to
        if bb == qc.weight_bit:
            # the reference's change_bitw shifts weight and bias width
            # together (comm_grad.py:576-581); an explicit bias_bit override
            # (e.g. 32) stays pinned
            bb = wb
    if quantize_mlp == qc.quantize_mlp and wb == qc.weight_bit and bb == qc.bias_bit:
        return config
    return dataclasses.replace(
        config, quant=dataclasses.replace(qc, quantize_mlp=quantize_mlp, weight_bit=wb, bias_bit=bb)
    )


def _init_opt_state(tc: TrainConfig, params: dlrm.Params) -> Any:
    if tc.optimizer == "adagrad":
        return adagrad_init(params)
    if tc.optimizer == "rwsadagrad":
        return rwsadagrad_init(params)
    return None


def init_train_state(
    config: DLRMConfig, tc: TrainConfig, seed: Optional[int] = None, device: Device = None,
    draw: bool = True,
) -> TrainState:
    """Params from `init_params` (bit-identical to the JAX package's;
    `draw=False`: undrawn, a template for a checkpoint), the optimizer's
    zeroed state (None for SGD), a fresh QuantState; on the card unless
    `device` says otherwise."""
    _check(tc)
    dev = resolve_device(device)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed, device=dev, draw=draw)
    return TrainState(params=params, opt_state=_init_opt_state(tc, params),
                      qstate=dlrm.init_quant_state(config, dev))


def _lr(tc: TrainConfig, step: int) -> float:
    # 1-based step count, as LRPolicyScheduler._step_count
    return lr_policy(tc.learning_rate, step, tc.lr_num_warmup_steps, tc.lr_decay_start_step,
                     tc.lr_num_decay_steps)


def _on(batch: dlrm.Batch, dev: torch.device) -> dlrm.Batch:
    """The batch on `dev` (a no-op for fields already there)."""
    return dlrm.Batch(*(None if t is None else t.to(dev, non_blocking=True) for t in batch))


def _params_device(params: dlrm.Params, dev: torch.device) -> None:
    got = params["bot"][0]["w"].device
    if got.type != dev.type or (dev.index is not None and got != dev):
        raise ValueError(f"params lie on {got}, the step was built for {dev}")


def _build_step_fn(config: DLRMConfig, tc: TrainConfig, plain: bool = False,
                   device: Device = None) -> Step:
    """The dense-autograd train step (every parameter, tables included, gets
    a dense gradient). Returns new parameters; the state is not modified."""
    _check(tc)
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        _params_device(state.params, dev)
        batch = _on(batch, dev)
        qstate = state.qstate
        if config.quant.enabled:
            # periodic scale refresh before the forward (paper section 3.2)
            qstate = dlrm.update_emb_scales(config, state.params, qstate)
        params = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        logits, new_qs = dlrm.forward(config, params, batch, qstate, train=True, plain=plain)
        loss = dlrm.training_loss(config, logits, batch.labels)
        grads = _grads(loss, tree_leaves(params))
        if tc.loss_scale != 1.0:
            grads = [g * tc.loss_scale for g in grads]
        lr = _lr(tc, qstate.step + 1)
        grads = _unflatten(state.params, grads)
        with torch.no_grad():
            if tc.optimizer == "sgd":
                new_params, opt = sgd_update(state.params, grads, lr), state.opt_state
            elif tc.optimizer == "adagrad":
                new_params, opt = adagrad_update(state.params, grads, state.opt_state, lr)
            else:
                new_params, opt = rwsadagrad_update(state.params, grads, state.opt_state, lr)
        new_qs = new_qs._replace(step=qstate.step + 1)
        return TrainState(new_params, opt, new_qs), loss.detach()

    return step_fn


def _dense_table_update(optimizer: str, table: torch.Tensor, acc: Optional[torch.Tensor],
                        dense: torch.Tensor, lr: LR) -> None:
    """A table's update from its dense gradient, in place (rows the batch did
    not touch see 0 and keep their values and accumulators); the float32
    update is rounded to the table's dtype before the add."""
    if optimizer == "sgd":
        table.add_((-lr * dense).to(table.dtype))
    elif optimizer == "adagrad":
        acc.add_(dense * dense)
        table.add_((-lr * dense / (torch.sqrt(acc) + EPS)).to(table.dtype))
    else:  # rwsadagrad: one accumulator per row
        acc.add_(torch.mean(dense * dense, dim=1))
        table.add_((-lr * dense / (torch.sqrt(acc)[:, None] + EPS)).to(table.dtype))


def _sparse_table_update(optimizer: str, table: torch.Tensor, acc: Optional[torch.Tensor],
                         ids: torch.Tensor, vals: torch.Tensor, lr: LR, presum: bool = True) -> None:
    """A table's update from its (ids, rows) gradient by scatter-adds, in
    place. Adagrad and RWSAdagrad coalesce duplicates first (torch sparse
    `.coalesce()` semantics) and touch only those rows; the padding ids of
    the coalesce read a clamped row and their updates are dropped. SGD
    coalesces first on the tables and step sizes where the JAX sparse step
    does, when `presum`."""
    n_rows = table.shape[0]
    if optimizer == "sgd":
        if presum and n_rows <= _SORTED_SCATTER_MAX_ROWS and ids.shape[0] >= _SORTED_SCATTER_MIN_UPDATES:
            uids, uvals = coalesce_sparse_grad(ids, vals, n_rows, max_unique=ids.shape[0])
            scatter_add_drop(table, uids, -lr * uvals)
        else:
            scatter_add_drop(table, ids, -lr * vals)
        return
    uids, uvals = coalesce_sparse_grad(ids, vals, n_rows, max_unique=ids.shape[0])
    cids, _ = clamp_ids(uids, n_rows)
    if optimizer == "adagrad":
        scatter_add_drop(acc, uids, uvals * uvals)
        denom = torch.sqrt(acc[cids]) + EPS
    else:
        scatter_add_drop(acc, uids, torch.mean(uvals * uvals, dim=1))
        denom = torch.sqrt(acc[cids])[:, None] + EPS
    scatter_add_drop(table, uids, -lr * uvals / denom)


class TableRoutes(NamedTuple):
    """Which update each embedding table takes, fixed by its row count:
    `groups` are the K1 groups of the tables with at most
    `onehot_update_max_rows` rows (one launch each per step), `stream` the
    tables above that with at most `stream_update_max_rows` rows (one sort
    and one K5 launch per 32 of them), `scatter` the others. QR/MD tables
    take none. `bags`: each table's (column, width) in a [B, S] id tensor
    (bags of per-table widths), or None for [T, B, P] ids."""

    groups: Tuple[DenseGradGroup, ...]
    stream: Tuple[int, ...]
    scatter: Tuple[int, ...]
    bags: Optional[Tuple[Tuple[int, int], ...]] = None


def make_table_routes(table_sizes: Sequence[int], tc: TrainConfig,
                      tricks: Sequence[int] = (),
                      bags: Optional[Sequence[Tuple[int, int]]] = None) -> TableRoutes:
    """The routes of tables with `table_sizes` rows under `tc`'s
    `onehot_update_max_rows` and `stream_update_max_rows`, the QR/MD slots
    `tricks` left out, their ids at `bags` (see `TableRoutes`); built once
    with a step. K5's batched sort takes bags of one width: the stream
    route refuses `bags`."""
    plain = [k for k in range(len(table_sizes)) if k not in tricks]
    small = [k for k in plain if 0 < table_sizes[k] <= tc.onehot_update_max_rows]
    stream = tuple(k for k in plain if tc.onehot_update_max_rows < table_sizes[k] <= tc.stream_update_max_rows)
    if bags is not None and stream:
        raise ValueError("bags of per-table widths take no stream route (stream_update_max_rows): "
                         "K5's batched sort takes gradients of one length")
    bags = None if bags is None else tuple((int(c), int(w)) for c, w in bags)
    groups = tuple(make_dense_grad_group([table_sizes[k] for k in ks], ks,
                                         None if bags is None else [bags[k] for k in ks])
                   for ks in group_slots(small))
    scatter = tuple(k for k in plain if k not in small and k not in stream)
    return TableRoutes(groups=groups, stream=stream, scatter=scatter, bags=bags)


def apply_table_updates(
    routes: TableRoutes,
    optimizer: str,
    tables: Sequence[torch.Tensor],
    accs: Optional[Sequence[Optional[torch.Tensor]]],
    g: torch.Tensor,  # [T, B, D] gradient w.r.t. the pooled lookups
    indices: torch.Tensor,  # [T, B, P] int32, or [B, S] at `routes.bags`
    mask: Optional[torch.Tensor],  # indices' shape, or None
    lr: LR,
    plain: bool = False,
    presum: bool = True,
) -> None:
    """Every table's update, in place, from the gradient of its pooled
    lookups: lookup (b, p) of table k adds g[k, b] * mask[k, b, p] to row
    indices[k, b, p]. A sparse gradient given as (ids [T, R], values
    [T, R, D]) is the case P = 1: g = values, indices = ids[..., None].
    With `routes.bags` table k's ids (and mask) are its bag's columns of
    [B, S] ids.
    `accs` holds the tables' Adagrad or RWSAdagrad accumulators (None under
    SGD). `plain=True` takes the plain versions of K1 and K5.

    - `routes.groups`: dense gradients from one K1 launch per group, then
      the dense update; under SGD one multiply of the flat gradient rounds
      the products -lr * grad (to each table's dtype) before one batched
      add, as `_dense_table_update` rounds them;
    - `routes.stream`: every table's gradient sorted in one batched sort,
      then one K5 launch per group of at most 32 tables: straight into the
      tables under SGD (after one multiply by -lr), into zeroed dense
      gradients (one buffer) under Adagrad and RWSAdagrad, which then take
      the dense update;
    - `routes.scatter`: `_sparse_table_update` (`presum=False`: SGD's
      scatter never coalesces first, as in the JAX dp and pseudo steps)."""
    dense_grads = dense_grad_grouped_plain if plain else onehot_dense_grad_grouped
    stream_scatter = stream_scatter_grouped_plain if plain else stream_scatter_add_grouped
    accs = accs if accs is not None else [None] * len(tables)

    def grad(k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        bag = None if routes.bags is None else routes.bags[k]
        return rows_grad_from_pooled(g[k], bag_of(indices, k, bag), None if mask is None else bag_of(mask, k, bag))

    if routes.groups:
        gc = g.contiguous()
    for group in routes.groups:
        flat, views = dense_grads(group, gc, indices, mask)
        group_tables = [tables[k] for k in group.slots]
        if optimizer == "sgd":
            deltas = (flat * -lr).split(group.rows)
            torch._foreach_add_(group_tables, [d.to(t.dtype) for d, t in zip(deltas, group_tables)])
            continue
        for k, table, dense in zip(group.slots, group_tables, views):
            _dense_table_update(optimizer, table, accs[k], dense, lr)

    if routes.stream:
        sids, svals = sort_sparse_grads_batched(*zip(*(grad(k) for k in routes.stream)))
        if optimizer == "sgd":  # one multiply, K5 straight into the tables
            targets = [tables[k] for k in routes.stream]
            svals = -lr * svals
        else:
            # Adagrad needs each row's summed gradient before the square: K5
            # into zeros, then the dense update
            rows = [tables[k].shape[0] for k in routes.stream]
            targets = torch.zeros((sum(rows), svals.shape[-1]), dtype=torch.float32,
                                  device=svals.device).split(rows)
        for lo in range(0, len(routes.stream), STREAM_GROUP_TABLES):
            hi = lo + STREAM_GROUP_TABLES
            stream_scatter(targets[lo:hi], sids[lo:hi], svals[lo:hi])
        if optimizer != "sgd":
            for k, summed in zip(routes.stream, targets):
                _dense_table_update(optimizer, tables[k], accs[k], summed, lr)

    for k in routes.scatter:
        _sparse_table_update(optimizer, tables[k], accs[k], *grad(k), lr, presum)


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves; a leaf the forward did not use (LSQ's MLP steps
    while the epoch schedule keeps the MLP in full precision) gets zeros, as
    under jax.grad."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def dense_keys(params: dlrm.Params) -> List[str]:
    """The parameter keys other than the tables: the MLPs and, where the
    model has them, the pooling weights and LSQ's step sizes (the JAX
    steps' `mlp_params`)."""
    return [key for key in params if key != "emb"]


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def sparse_grads(config: DLRMConfig, params: dlrm.Params, qstate: dlrm.QuantState,
                 batch: dlrm.Batch, plain: bool = False, lsq_numel_scale: float = 1.0):
    """Forward and backward with autograd cut at the raw pooled lookups (no
    table gradient is formed): (loss, the forward's QuantState, the
    gradients of every other parameter as a nest keyed like the params
    ({"bot", "top"} and, where present, "v_W", "lsq_emb" and "lsq_mlp"),
    and under QR/MD "emb_trick", {slot: the dict table's dense gradient},
    the gradient [T, B, D] w.r.t. the pooled lookups). Under QAT the
    lookups take the scheme's table transform (PACT's), whose gradient is
    the identity. The QR/MD slots are recomputed from their tables with
    their gradient (`dlrm.splice_trick_pooled`); their slots of the pooled
    gradient are 0."""
    return _sparse_backward(*_sparse_forward(config, params, qstate, batch, plain, lsq_numel_scale))


def _sparse_forward(config: DLRMConfig, params: dlrm.Params, qstate: dlrm.QuantState,
                    batch: dlrm.Batch, plain: bool, lsq_numel_scale: float = 1.0):
    """`sparse_grads`' forward: (loss, the forward's QuantState, and the
    leaves `_sparse_backward` differentiates: the dense parameters, the
    QR/MD tables, the pooled lookups)."""
    with torch.no_grad():
        raw_pooled = dlrm.lookup_all(config, params, batch.indices, batch.mask,
                                     not config.quant.enabled, plain=plain)
    dense = {key: _requiring_grad(params[key]) for key in dense_keys(params)}
    pooled = raw_pooled.requires_grad_()
    ks = dlrm.trick_slots(config)
    fwd_in, emb_trick = pooled, {}
    if ks:
        emb_trick = {k: _requiring_grad(params["emb"][k]) for k in ks}
        emb = [emb_trick.get(k, t) for k, t in enumerate(params["emb"])]
        weights = dlrm.pooling_weights(config, dense.get("v_W"), batch.indices, batch.mask)
        fwd_in = dlrm.splice_trick_pooled(config, emb, weights, batch.indices, pooled)
    logits, new_qs = dlrm.forward(config, {**dense, "emb": params["emb"]}, batch, qstate,
                                  train=True, raw_pooled=fwd_in, lsq_numel_scale=lsq_numel_scale,
                                  plain=plain)
    loss = dlrm.training_loss(config, logits, batch.labels)
    return loss, new_qs, dense, emb_trick, pooled


def _sparse_backward(loss, new_qs, dense, emb_trick, pooled):
    *grads, g_pooled = _grads(loss, tree_leaves(dense) + tree_leaves(emb_trick) + [pooled])
    n = len(tree_leaves(dense))
    out = _unflatten(dense, grads[:n])
    if emb_trick:
        out["emb_trick"] = _unflatten(emb_trick, grads[n:])
    return loss, new_qs, out, g_pooled


def _learned_vw_grads(config: DLRMConfig, params: dlrm.Params, batch: dlrm.Batch,
                      g_pooled: torch.Tensor, ks: Sequence[int]):
    """The learned pooling weights' gradients of the dense tables `ks`:
    lookup (b, p) of table k gives v_W[k][idx] the scalar g_pooled[k, b] .
    E[idx] times the bag mask (E the PACT-transformed table under PACT),
    coalesced in one batched pass (JAX train_step.py:499-547). Reads the
    tables before their update. Returns ([T', K] ids, [T', K] values)."""
    qc = config.quant
    pact = qc.enabled and qc.quantize_emb and qc.quant_scheme == "pact"
    rows = []
    for k in ks:
        table = params["emb"][k]
        r = table[clamp_ids(batch.indices[k], table.shape[0])[0]]
        if pact:
            r = q.pact_apply(r, q.pact_normalizer(table), qc.embedding_bit)
        rows.append(r.float())
    sel = q.constant(tuple(ks), torch.int64, g_pooled.device)
    contrib = torch.einsum("tbd,tbpd->tbp", g_pooled[sel].float(), torch.stack(rows))
    if batch.mask is not None:
        contrib = contrib * batch.mask[sel]
    ids = batch.indices[sel].reshape(len(ks), -1)
    nrv = q.constant(tuple(params["v_W"][k].shape[0] for k in ks), ids.dtype, ids.device)
    uids, uvals = coalesce_sparse_grads_batched(ids, contrib.reshape(len(ks), -1, 1), nrv, ids.shape[1])
    return uids, uvals[..., 0]


def _build_sparse_step_fn(config: DLRMConfig, tc: TrainConfig, plain: bool = False,
                          device: Device = None) -> "_SparseStep":
    """The train step with explicit sparse embedding updates (the reference's
    nn.EmbeddingBag(sparse=True) + manual optimizer, sgd_quantized_gradients_
    parallel_comm.py:601-685), as a `_SparseStep`.

    It updates every leaf of the state passed to it in place, on any device:
    the tables and their accumulators (`apply_table_updates`), the dense
    leaves (MLPs, cross network, pooling weights, LSQ's steps) and their
    Adagrad state (`ops.cuda.qat_dense.dense_update_`, one launch on the
    card, its plain version on the CPU or with `plain=True`), the QR/MD
    leaves (the optimizers' own arithmetic, written into the state's
    tensors), the scales and the activation ranges."""
    _check(tc)
    dev = resolve_device(device)
    opt = tc.optimizer
    ks = dlrm.trick_slots(config)
    routes = make_table_routes(config.table_sizes, tc, ks, config.bags())
    vw_ks = [k for k in range(config.num_tables) if k not in ks] \
        if config.weighted_pooling == "learned" else []
    update_dense = dense_update_plain_ if plain else dense_update_

    def body(state: TrainState, batch: dlrm.Batch, lr: torch.Tensor) -> torch.Tensor:
        """One step after the refresh, every leaf of `state` updated in
        place; returns the loss."""
        params, opt_state, qstate = state.params, state.opt_state, state.qstate
        with annotate("dqrm.train.forward"):
            fwd = _sparse_forward(config, params, qstate, batch, plain)
        with annotate("dqrm.train.backward"):
            loss, new_qs, mlp_grads, g_pooled = _sparse_backward(*fwd)
        del fwd  # the pooled lookups, freed before the update
        if tc.loss_scale != 1.0:
            mlp_grads = tree_map(lambda g: g * tc.loss_scale, mlp_grads)
            g_pooled = g_pooled * tc.loss_scale
        trick_grads = mlp_grads.pop("emb_trick", {})

        with annotate("dqrm.train.update"), torch.no_grad():
            if vw_ks:  # from the tables before their update
                vw_ids, vw_vals = _learned_vw_grads(config, params, batch, g_pooled, vw_ks)
            weights = dlrm.pooling_weights(config, params.get("v_W"), batch.indices, batch.mask)
            # classic Adagrad on the dense leaves under both Adagrads; the
            # accumulators paired by key (an imported state orders its keys)
            mlp = {key: params[key] for key in mlp_grads}
            accs = None if opt == "sgd" else tree_leaves(
                tree_map(lambda _, acc: acc, mlp, {key: opt_state[key] for key in mlp}))
            update_dense(tree_leaves(mlp), tree_leaves(mlp_grads), accs, lr)
            apply_table_updates(routes, opt, params["emb"], opt_state["emb"] if opt != "sgd" else None,
                                g_pooled, batch.indices, weights, lr, plain=plain)
            pairs = []  # (the state's leaves, their new values)
            for k in ks:
                if opt == "sgd":
                    pairs.append((params["emb"][k], sgd_update(params["emb"][k], trick_grads[k], lr)))
                    continue
                update = adagrad_update if opt == "adagrad" else rwsadagrad_update
                one, acc = update({"emb": [params["emb"][k]]}, {"emb": [trick_grads[k]]},
                                  {"emb": [opt_state["emb"][k]]}, lr)
                pairs += [(params["emb"][k], one["emb"][0]), (opt_state["emb"][k], acc["emb"][0])]
            for i, k in enumerate(vw_ks):
                vw = params["v_W"][k]
                if opt == "sgd":
                    scatter_add_drop(vw, vw_ids[i], -lr * vw_vals[i])
                    continue
                # v_W is a flat vector: element-wise Adagrad is row-wise Adagrad at D = 1
                acc = opt_state["v_W"][k]
                scatter_add_drop(acc, vw_ids[i], vw_vals[i] * vw_vals[i])
                denom = torch.sqrt(acc[clamp_ids(vw_ids[i], acc.shape[0])[0]]) + EPS
                scatter_add_drop(vw, vw_ids[i], -lr * vw_vals[i] / denom)
            pairs += [(qstate.act_min, new_qs.act_min), (qstate.act_max, new_qs.act_max)]
            pairs = [(old, new) for olds, news in pairs
                     for old, new in zip(tree_leaves(olds), tree_leaves(news)) if new is not old]
            if pairs:
                torch._foreach_copy_([old for old, _ in pairs], [new for _, new in pairs])
        return loss.detach()

    return _SparseStep(config, tc, dev, body, graphed=dev.type == "cuda" and not plain)


def _state_leaves(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of a state that a captured step reads or writes."""
    qs = state.qstate
    opt = [] if state.opt_state is None else tree_leaves(state.opt_state)
    return tree_leaves(state.params) + opt + [qs.emb_scales, qs.act_min, qs.act_max]


class _SparseStep:
    """The sparse train step: the QAT scale refresh (1 step in
    `scale_update_period`, into the state's `emb_scales`), the learning
    rate (a 0-d float32 tensor on the state's device, filled each step with
    `_lr`'s float32 value, which multiplies to the same bits as the Python
    float), then the body, which updates the state's own tensors in place;
    returns the state with `qstate.step` advanced, and the loss.

    On a CUDA state (not `plain`) the body runs as one CUDA graph, replayed
    for every step: the forward, `autograd.grad` and the updates as one
    graph launch instead of some 440 kernel launches from Python. The graph
    reads static buffers: the batch (copied in each step), the learning
    rate and the state's tensors. A capture bakes in the state's tensors,
    the batch's shapes and dtypes and `act_fixed`: its key. A call whose
    key differs (another state, such as a `clone_state` copy, or another
    batch shape) takes `utils.cuda_graph.WARMUP_CALLS` eager steps on the
    capture stream (the last on the capturing thread; they are real steps of
    the run and also start autograd's threads on that stream), then a new
    capture, which replaces the old graph; the capture does not execute, so
    it is replayed for the step it was captured on.
    The key holds the state's tensors by weak reference: when the first of
    them is freed, the step drops its graph, its memory pool and its static
    buffers. On a CPU state, and with `plain=True`, every step runs eagerly.
    `eager` is the step run eagerly, never captured: the reference the
    graph is held against.

    Each step opens the spans `dqrm.train.step`, `.refresh` (on the steps
    the scales refresh), and `.forward`, `.backward` and `.update` where it
    runs eagerly, `.graph` where it replays (`utils.profiling`).

    Counters: `graph_replays`, `graph_captures`, `eager_steps` (the warm-up
    steps), `bag_ids` (the ids the steps' lookups pool: under
    `multi_hot_sizes` the batch times the configuration's bag widths; for a
    masked [T, B, P] batch the mask's live slots, counted on the device, so
    that the counter is then a 0-d device tensor, read after the steps;
    else every slot) and `bag_slots` (the id slots the steps' gathers, K1
    and scatters read, padding included: the id tensor's elements), of the
    calls of the step (not of `eager`), and the same summed over every
    instance in the class's `totals`, which a reader sets to 0 and reads
    after, as it does the kernel wrappers' `launches`. A wrapper's
    `launches` counts the calls that reach it: one per eager step and one
    per capture, none per replay; a profiler's trace lists the kernels a
    replay runs."""

    totals = {"graph_replays": 0, "graph_captures": 0, "eager_steps": 0, "bag_ids": 0, "bag_slots": 0}

    def __init__(self, config: DLRMConfig, tc: TrainConfig, dev: torch.device, body: Callable,
                 graphed: bool):
        self.config, self.tc, self.dev, self.body, self.graphed = config, tc, dev, body, graphed
        self.graph_replays = self.graph_captures = self.eager_steps = self.bag_ids = self.bag_slots = 0
        self.stream = torch.cuda.Stream(dev) if graphed else None
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.refs = self.key = self.graph = self.batch = self.freed = None

    def __call__(self, state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        with annotate("dqrm.train.step"):
            out = self._step(state, batch, self.graphed)
            self._count("bag_ids", self._pooled_ids(batch))
            self._count("bag_slots", batch.indices.numel())
        return out

    def eager(self, state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        """The step run eagerly on the current stream, uncounted."""
        with annotate("dqrm.train.step"):
            return self._step(state, batch, False)

    def _count(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)
        _SparseStep.totals[name] += n

    def _pooled_ids(self, batch: dlrm.Batch):
        if self.config.multi_hot_sizes is not None:
            return batch.dense.shape[0] * sum(self.config.multi_hot_sizes)
        if batch.mask is not None:
            return torch.count_nonzero(batch.mask)
        return batch.indices.numel()

    def _counts(self) -> str:
        return f"replays={self.graph_replays} captures={self.graph_captures} eager_steps={self.eager_steps}"

    def _step(self, state: TrainState, batch: dlrm.Batch, graphed: bool) -> Tuple[TrainState, torch.Tensor]:
        _params_device(state.params, self.dev)
        qs = state.qstate
        if self.config.quant.enabled and dlrm.emb_scales_due(self.config, qs):
            with annotate("dqrm.train.refresh"), torch.no_grad():
                qs.emb_scales.copy_(dlrm.compute_emb_scales(self.config, state.params))
        self.lr.fill_(_lr(self.tc, qs.step + 1))
        loss = self._graphed(state, batch) if graphed else self.body(state, _on(batch, self.dev), self.lr)
        return state._replace(qstate=qs._replace(step=qs.step + 1)), loss

    def _graphed(self, state: TrainState, batch: dlrm.Batch) -> torch.Tensor:
        leaves = _state_leaves(state)
        key = (state.qstate.act_fixed, tuple(None if t is None else (t.shape, t.dtype) for t in batch))
        if not (key == self.key and len(leaves) == len(self.refs)
                and all(r() is t for r, t in zip(self.refs, leaves))):
            self._rekey(key, leaves, batch)
        for buf, t in zip(self.batch, batch):
            if buf is not None:
                buf.copy_(t, non_blocking=True)
        g = self.graph
        if g.graph is None:
            step = functools.partial(self.body, state, self.batch, self.lr)
            if not g.due():
                self._count("eager_steps")
                return g.warm_up(step)
            g.capture(step)
            self._count("graph_captures")
        with annotate("dqrm.train.graph", self._counts):
            loss = g.replay()
        self._count("graph_replays")
        return loss.clone()

    def _release(self) -> None:
        """Drops the graph, its memory pool and the static buffers."""
        if self.freed is not None:
            self.freed.detach()
        self.refs = self.key = self.graph = self.batch = self.freed = None

    def _rekey(self, key, leaves: List[torch.Tensor], batch: dlrm.Batch) -> None:
        self._release()
        self.key, self.refs, self.graph = key, [weakref.ref(t) for t in leaves], GraphedCall(self.stream)
        # a finalizer on the first leaf; it holds the step weakly, so an
        # unused step is freed whatever becomes of the state
        self.freed = weakref.finalize(leaves[0], _release_step, weakref.ref(self))
        self.batch = dlrm.Batch(*(None if t is None else torch.empty(t.shape, dtype=t.dtype, device=self.dev)
                                  for t in batch))


def _release_step(ref: "weakref.ref[_SparseStep]") -> None:
    step = ref()
    if step is not None:
        step._release()


def make_train_step(config: DLRMConfig, tc: TrainConfig, sparse_emb_grad: bool = False,
                    plain: bool = False, device: Device = None) -> Step:
    """The train step for a state on `device` (the card unless the caller
    says otherwise). `sparse_emb_grad` selects the explicit sparse-update
    body; `plain=True` the plain versions of the kernels."""
    build = _build_sparse_step_fn if sparse_emb_grad else _build_step_fn
    return build(config, tc, plain=plain, device=device)


def batch_rows(batch: dlrm.Batch, start: int, stop: int) -> dlrm.Batch:
    """Rows [start, stop) of a batch (a view)."""
    rows = slice(start, stop)
    return dlrm.Batch(dense=batch.dense[rows], indices=batch.indices[:, rows],
                      labels=batch.labels[rows],
                      mask=None if batch.mask is None else batch.mask[:, rows])


def _unstack(batches: dlrm.Batch, k: int) -> List[dlrm.Batch]:
    return [dlrm.Batch(*(None if t is None else t[i] for t in batches)) for i in range(k)]


def make_multi_train_step(config: DLRMConfig, tc: TrainConfig, k: int,
                          sparse_emb_grad: bool = False, plain: bool = False,
                          device: Device = None):
    """k sequential train steps per call, the port of the JAX scan megastep.

    Takes (TrainState, a list of k Batches or one Batch with a leading [k]
    axis) and returns (state, last loss). The k losses of the last call stay
    in `multi.losses` ([k] tensor on the device). The sparse step on a CUDA
    state replays one CUDA graph per step (`_SparseStep`)."""
    return repeat_step(make_train_step(config, tc, sparse_emb_grad, plain=plain, device=device), k)


class _Repeated:
    """`step` run k times per call (`repeat_step`). A class, so that nothing
    refers to itself: a dropped megastep frees its step (and a graphed
    step's CUDA graph) at once, without the cycle collector."""

    def __init__(self, step: Callable, k: int):
        self.step, self.k, self.losses = step, k, None

    def __call__(self, state, batches):
        seq = _unstack(batches, self.k) if isinstance(batches, dlrm.Batch) else list(batches)
        if len(seq) != self.k:
            raise ValueError(f"expected {self.k} batches, got {len(seq)}")
        losses = []
        for b in seq:
            state, loss = self.step(state, b)
            losses.append(loss)
        self.losses = torch.stack(losses)
        return state, losses[-1]


def repeat_step(body: Callable, k: int) -> Callable:
    """`body` run k times per call: takes (state, a list of k Batches or one
    Batch with a leading [k] axis) and returns (state, last loss). The k
    losses of the last call stay in `multi.losses` ([k] tensor on the
    device), `body` in `multi.step`."""
    return _Repeated(body, k)


def stack_batches(batches: Sequence[dlrm.Batch]) -> dlrm.Batch:
    """k Batches as one Batch with a leading [k] axis, on the batches'
    device (one upload per field when they lie on the host)."""
    return dlrm.Batch(
        dense=torch.stack([b.dense for b in batches]),
        indices=torch.stack([b.indices for b in batches]),
        labels=torch.stack([b.labels for b in batches]),
        mask=None if batches[0].mask is None else torch.stack([b.mask for b in batches]),
    )


def concat_batches(batches: Sequence[dlrm.Batch]) -> dlrm.Batch:
    """k Batches concatenated along the batch axis into one [k*B] batch, on
    the batches' device.

    Gradient accumulation (`--mlperf-grad-accum-iter`,
    dlrm_s_pytorch.py:1595-1601): the gradient of the mean loss over the
    concatenation equals the mean of the per-batch gradients; the reference
    sums the per-batch mean grads instead (backward without zero_grad), so
    callers set TrainConfig.loss_scale=k to recover the reference's
    sum-of-means trajectory."""
    return dlrm.Batch(
        dense=torch.cat([b.dense for b in batches], dim=0),
        indices=torch.cat([b.indices for b in batches], dim=1),
        labels=torch.cat([b.labels for b in batches], dim=0),
        mask=None if batches[0].mask is None else torch.cat([b.mask for b in batches], dim=1),
    )


def make_eval_step(config: DLRMConfig, plain: bool = False, device: Device = None):
    """Inference step returning click probabilities (the reference's
    `inference()` per-batch body, dlrm_s_pytorch.py:762-860)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dlrm.Batch) -> torch.Tensor:
        _params_device(state.params, dev)
        return dlrm.predict(config, state.params, _on(batch, dev), state.qstate, plain=plain)

    return eval_fn


def make_grad_probe(config: DLRMConfig, tc: TrainConfig, device: Device = None):
    """Per-batch embedding gradients for `--documenting-table-grads` (the
    JAX package's make_grad_probe, train_step.py:771-858).

    Returns fn(params, qstate, batch) -> (out, loss), where `out` maps
    "table_<k>_ids" to the [B*P] row ids the batch touches and
    "table_<k>_rows" to the [B*P, D] per-occurrence row gradients
    (duplicates not coalesced; scaled by the pooling weights where the
    model has them), and for a QR/MD table "table_<k>_<leaf>" to the
    leaf's dense gradient, taken w.r.t. the parameters before the update,
    as the train step takes them."""
    dev = resolve_device(device)

    def probe(params: dlrm.Params, qstate: dlrm.QuantState,
              batch: dlrm.Batch) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        _params_device(params, dev)
        batch = _on(batch, dev)
        if config.quant.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        loss, _, grads, g_pooled = sparse_grads(config, params, qstate, batch)
        weights = dlrm.pooling_weights(config, params.get("v_W"), batch.indices, batch.mask)
        out = {}
        for k in range(config.num_tables):
            if k in grads.get("emb_trick", {}):
                for leaf, g in sorted(grads["emb_trick"][k].items()):
                    out[f"table_{k}_{leaf}"] = g
                continue
            out[f"table_{k}_ids"], out[f"table_{k}_rows"] = rows_grad_from_pooled(
                g_pooled[k], batch.indices[k], None if weights is None else weights[k])
        return out, loss.detach()

    return probe
