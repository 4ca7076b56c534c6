"""Single-device train and eval steps with SGD, Adagrad and RWSAdagrad.

Port of the JAX package's train_step.py: forward -> loss -> backward -> LR
policy -> optimizer, with the QAT scale refresh folded in as explicit state.

- `_build_step_fn`: autograd through everything, tables included (dense
  table gradients). The cross-check, and the path on which kernel K4's
  backward (through K1) runs when `onehot_lookup_max_rows` is set.
- `_build_sparse_step_fn`: autograd is cut at the pooled lookups; each
  table takes its gradient as (ids, rows) pairs:
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

The steps run eagerly; there is no jit to donate the state to, so the sparse
step updates the embedding tables and their optimizer accumulators in place
and returns a state that shares them. A caller that needs the old state
clones it first (`clone_state`). `plain=True` makes the steps call the plain
versions of K1, K4 and K5 on any device: the reference the kernels are held
against on the card.

Not in this slice (each raises `NotImplementedError`): QR/MD tables, weighted
pooling (`v_W`), bf16 tables (`dlrm.check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
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
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    clamp_ids,
    coalesce_sparse_grad,
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
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves, tree_map

Device = Optional[Union[str, torch.device]]
Step = Callable[["TrainState", dlrm.Batch], Tuple["TrainState", torch.Tensor]]

# Pre-coalescing gates of the JAX package's sparse step (train_step.py:38-39).
_SORTED_SCATTER_MAX_ROWS = 1_000_000
_SORTED_SCATTER_MIN_UPDATES = 4096


class TrainState(NamedTuple):
    params: dlrm.Params
    opt_state: Any  # None for plain SGD
    qstate: dlrm.QuantState


def _check(config: DLRMConfig, tc: TrainConfig) -> None:
    dlrm.check_supported(config)
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
    config: DLRMConfig, tc: TrainConfig, seed: Optional[int] = None, device: Device = None
) -> TrainState:
    """Params from `init_params` (bit-identical to the JAX package's), the
    optimizer's zeroed state (None for SGD), a fresh QuantState; on the card
    unless `device` says otherwise."""
    _check(config, tc)
    dev = resolve_device(device)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed, device=dev)
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
    _check(config, tc)
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
        grads = torch.autograd.grad(loss, tree_leaves(params))
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
                        dense: torch.Tensor, lr: float) -> None:
    """A table's update from its dense gradient, in place (rows the batch did
    not touch see 0 and keep their values and accumulators)."""
    if optimizer == "sgd":
        table.add_(-lr * dense)
    elif optimizer == "adagrad":
        acc.add_(dense * dense)
        table.add_(-lr * dense / (torch.sqrt(acc) + EPS))
    else:  # rwsadagrad: one accumulator per row
        acc.add_(torch.mean(dense * dense, dim=1))
        table.add_(-lr * dense / (torch.sqrt(acc)[:, None] + EPS))


def _sparse_table_update(optimizer: str, table: torch.Tensor, acc: Optional[torch.Tensor],
                         ids: torch.Tensor, vals: torch.Tensor, lr: float) -> None:
    """A table's update from its (ids, rows) gradient by scatter-adds, in
    place. Adagrad and RWSAdagrad coalesce duplicates first (torch sparse
    `.coalesce()` semantics) and touch only those rows; the padding ids of
    the coalesce read a clamped row and their updates are dropped."""
    n_rows = table.shape[0]
    if optimizer == "sgd":
        if n_rows <= _SORTED_SCATTER_MAX_ROWS and ids.shape[0] >= _SORTED_SCATTER_MIN_UPDATES:
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


def _build_sparse_step_fn(config: DLRMConfig, tc: TrainConfig, plain: bool = False,
                          device: Device = None) -> Step:
    """The train step with explicit sparse embedding updates (the reference's
    nn.EmbeddingBag(sparse=True) + manual optimizer, sgd_quantized_gradients_
    parallel_comm.py:601-685). Updates the embedding tables and their
    accumulators in place."""
    _check(config, tc)
    dev = resolve_device(device)
    qc = config.quant
    opt = tc.optimizer
    dense_grads = dense_grad_grouped_plain if plain else onehot_dense_grad_grouped
    stream_scatter = stream_scatter_grouped_plain if plain else stream_scatter_add_grouped
    # the small tables' K1 groups, one launch each per step
    small = {k for k, n in enumerate(config.table_sizes) if 0 < n <= tc.onehot_update_max_rows}
    groups = [make_dense_grad_group([config.table_sizes[k] for k in ks], ks)
              for ks in group_slots(sorted(small))]

    def step_fn(state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        _params_device(state.params, dev)
        batch = _on(batch, dev)
        params, qstate = state.params, state.qstate
        if qc.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        with torch.no_grad():
            raw_pooled = dlrm.lookup_all(config, params, batch.indices, batch.mask, plain=plain)
        mlp = {part: tree_map(lambda t: t.detach().requires_grad_(), params[part])
               for part in ("bot", "top")}
        pooled = raw_pooled.requires_grad_()
        logits, new_qs = dlrm.forward(config, {**mlp, "emb": params["emb"]}, batch, qstate,
                                      train=True, raw_pooled=pooled)
        loss = dlrm.training_loss(config, logits, batch.labels)
        *mlp_grads, g_pooled = torch.autograd.grad(loss, tree_leaves(mlp) + [pooled])
        if tc.loss_scale != 1.0:
            mlp_grads = [g * tc.loss_scale for g in mlp_grads]
            g_pooled = g_pooled * tc.loss_scale
        lr = _lr(tc, qstate.step + 1)

        def grad(k: int) -> Tuple[torch.Tensor, torch.Tensor]:
            m = batch.mask[k] if batch.mask is not None else None
            return rows_grad_from_pooled(g_pooled[k], batch.indices[k], m)

        with torch.no_grad():
            mlp_params = {part: params[part] for part in ("bot", "top")}
            mlp_grads = _unflatten(mlp_params, mlp_grads)
            opt_state = state.opt_state
            if opt == "sgd":
                new_params = dict(params, **sgd_update(mlp_params, mlp_grads, lr))
            else:  # classic Adagrad on the MLP under both optimizers
                new_mlp, new_acc = adagrad_update(
                    mlp_params, mlp_grads, {part: opt_state[part] for part in mlp_params}, lr)
                new_params = dict(params, **new_mlp)
                opt_state = dict(opt_state, **new_acc)
            emb_acc = opt_state["emb"] if opt != "sgd" else [None] * len(params["emb"])

            # small tables: dense gradients from one K1 launch per group, then
            # the dense update; under SGD one multiply of the flat gradient
            # rounds the products -lr * grad before one batched add, as
            # `table.add_(-lr * dense)` rounds them
            for group in groups:
                flat, views = dense_grads(group, g_pooled.contiguous(), batch.indices, batch.mask)
                tables = [params["emb"][k] for k in group.slots]
                if opt == "sgd":
                    torch._foreach_add_(tables, (flat * -lr).split(group.rows))
                    continue
                for k, table, dense in zip(group.slots, tables, views):
                    _dense_table_update(opt, table, emb_acc[k], dense, lr)

            # mid-size tables: every one's gradient sorted in one batched
            # sort, then one K5 launch per group of at most 32 tables
            stream_ks = [k for k, t in enumerate(params["emb"])
                         if tc.onehot_update_max_rows < t.shape[0] <= tc.stream_update_max_rows]
            if stream_ks:
                sids, svals = sort_sparse_grads_batched(*zip(*(grad(k) for k in stream_ks)))
                if opt == "sgd":  # one multiply, K5 straight into the tables
                    targets = [params["emb"][k] for k in stream_ks]
                    svals = -lr * svals
                else:
                    # Adagrad needs each row's summed gradient before the
                    # square: K5 into zeros, then the dense update
                    rows = [params["emb"][k].shape[0] for k in stream_ks]
                    targets = torch.zeros((sum(rows), svals.shape[-1]), dtype=torch.float32,
                                          device=dev).split(rows)
                for lo in range(0, len(stream_ks), STREAM_GROUP_TABLES):
                    hi = lo + STREAM_GROUP_TABLES
                    stream_scatter(targets[lo:hi], sids[lo:hi], svals[lo:hi])
                if opt != "sgd":
                    for k, summed in zip(stream_ks, targets):
                        _dense_table_update(opt, params["emb"][k], emb_acc[k], summed, lr)

            for k, table in enumerate(params["emb"]):
                if k in small or k in stream_ks:
                    continue
                _sparse_table_update(opt, table, emb_acc[k], *grad(k), lr)
        new_qs = new_qs._replace(step=qstate.step + 1)
        return TrainState(new_params, opt_state, new_qs), loss.detach()

    return step_fn


def make_train_step(config: DLRMConfig, tc: TrainConfig, sparse_emb_grad: bool = False,
                    plain: bool = False, device: Device = None) -> Step:
    """The train step for a state on `device` (the card unless the caller
    says otherwise). `sparse_emb_grad` selects the explicit sparse-update
    body; `plain=True` the plain versions of the kernels."""
    build = _build_sparse_step_fn if sparse_emb_grad else _build_step_fn
    return build(config, tc, plain=plain, device=device)


def _unstack(batches: dlrm.Batch, k: int) -> List[dlrm.Batch]:
    return [dlrm.Batch(*(None if t is None else t[i] for t in batches)) for i in range(k)]


def make_multi_train_step(config: DLRMConfig, tc: TrainConfig, k: int,
                          sparse_emb_grad: bool = False, plain: bool = False,
                          device: Device = None):
    """k sequential train steps per call, the port of the JAX scan megastep.

    Takes (TrainState, a list of k Batches or one Batch with a leading [k]
    axis) and returns (state, last loss). The k losses of the last call stay
    in `multi.losses` ([k] tensor on the device)."""
    body = make_train_step(config, tc, sparse_emb_grad, plain=plain, device=device)

    def multi(state: TrainState, batches) -> Tuple[TrainState, torch.Tensor]:
        seq = _unstack(batches, k) if isinstance(batches, dlrm.Batch) else list(batches)
        if len(seq) != k:
            raise ValueError(f"expected {k} batches, got {len(seq)}")
        losses = []
        for b in seq:
            state, loss = body(state, b)
            losses.append(loss)
        multi.losses = torch.stack(losses)
        return state, losses[-1]

    multi.losses = None
    return multi


def stack_batches(batches: Sequence[dlrm.Batch]) -> dlrm.Batch:
    """k Batches as one Batch with a leading [k] axis, on the batches'
    device (one upload per field when they lie on the host)."""
    return dlrm.Batch(
        dense=torch.stack([b.dense for b in batches]),
        indices=torch.stack([b.indices for b in batches]),
        labels=torch.stack([b.labels for b in batches]),
        mask=None if batches[0].mask is None else torch.stack([b.mask for b in batches]),
    )


def make_eval_step(config: DLRMConfig, plain: bool = False, device: Device = None):
    """Inference step returning click probabilities (the reference's
    `inference()` per-batch body, dlrm_s_pytorch.py:762-860)."""
    dlrm.check_supported(config)
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
    (duplicates not coalesced), taken w.r.t. the parameters before the
    update, as the train step takes them. Plain tables only."""
    dlrm.check_supported(config)
    dev = resolve_device(device)

    def probe(params: dlrm.Params, qstate: dlrm.QuantState,
              batch: dlrm.Batch) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        _params_device(params, dev)
        batch = _on(batch, dev)
        if config.quant.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        with torch.no_grad():
            pooled = dlrm.lookup_all(config, params, batch.indices, batch.mask)
        pooled.requires_grad_()
        logits, _ = dlrm.forward(config, params, batch, qstate, train=True, raw_pooled=pooled)
        loss = dlrm.training_loss(config, logits, batch.labels)
        (g_pooled,) = torch.autograd.grad(loss, [pooled])
        out = {}
        for k in range(config.num_tables):
            m = batch.mask[k] if batch.mask is not None else None
            out[f"table_{k}_ids"], out[f"table_{k}_rows"] = rows_grad_from_pooled(
                g_pooled[k], batch.indices[k], m)
        return out, loss.detach()

    return probe
