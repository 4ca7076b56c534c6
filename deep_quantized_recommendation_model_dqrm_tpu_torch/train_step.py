"""Single-device train and eval steps with SGD.

Port of the JAX package's train_step.py: forward -> loss -> backward -> LR
policy -> SGD, with the QAT scale refresh folded in as explicit state.

- `_build_step_fn`: autograd through everything, tables included (dense
  table gradients). The cross-check, and the path on which kernel K4's
  backward (through K1) runs when `onehot_lookup_max_rows` is set.
- `_build_sparse_step_fn`: autograd is cut at the pooled lookups; each
  table takes its gradient as (ids, rows) pairs. Tables with at most
  `onehot_update_max_rows` rows get a dense gradient from kernel K1 and
  `table + (-lr * dense)`; the others a scatter-add (`index_add_`), pre-
  coalesced when the table has at most 1M rows and the step at least 4096
  updates (train_step.py:427-443 of the JAX package).

The steps run eagerly; there is no jit to donate the state to, so the sparse
step updates the embedding tables in place and returns a state that shares
them. A caller that needs the old state clones it first (`clone_state`).
`plain=True` makes the steps call the plain versions of K1 and K4 on any
device: the reference the kernels are held against on the card.

Not in this slice (each raises `NotImplementedError`): Adagrad and
RWSAdagrad, `stream_update_max_rows > 0` (kernel K5), `config_for_epoch` and
`make_grad_probe`.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    dense_grad_auto,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    coalesce_sparse_grad,
    rows_grad_from_pooled,
    scatter_add_drop,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.lr_policy import lr_policy
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update

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
    if tc.optimizer in ("adagrad", "rwsadagrad"):
        raise NotImplementedError(
            f"the {tc.optimizer} optimizer: the next slice of the port (with kernel K5)"
        )
    if tc.optimizer != "sgd":
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    if tc.stream_update_max_rows > 0:
        raise NotImplementedError(
            "stream_update_max_rows (kernel K5): the next slice of the port"
        )


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def _unflatten(tree, leaves: Sequence[torch.Tensor]):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def clone_state(state: TrainState) -> TrainState:
    """A copy of `state` that shares no tensor with it."""
    qs = state.qstate
    return TrainState(
        params=_map(torch.clone, state.params),
        opt_state=state.opt_state,
        qstate=qs._replace(emb_scales=qs.emb_scales.clone(), act_min=qs.act_min.clone(),
                           act_max=qs.act_max.clone()),
    )


def config_for_epoch(config: DLRMConfig, tc: TrainConfig, epoch: int) -> DLRMConfig:
    raise NotImplementedError("QAT epoch schedules (config_for_epoch): a later slice of the port")


def make_grad_probe(config: DLRMConfig, tc: TrainConfig):
    raise NotImplementedError("make_grad_probe: a later slice of the port")


def init_train_state(
    config: DLRMConfig, tc: TrainConfig, seed: Optional[int] = None, device: Device = None
) -> TrainState:
    """Params from `init_params` (bit-identical to the JAX package's), no
    optimizer state (SGD), a fresh QuantState; on the card unless `device`
    says otherwise."""
    _check(config, tc)
    dev = resolve_device(device)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed, device=dev)
    return TrainState(params=params, opt_state=None, qstate=dlrm.init_quant_state(config, dev))


def _lr(tc: TrainConfig, step: int) -> float:
    # 1-based step count, as LRPolicyScheduler._step_count
    return lr_policy(tc.learning_rate, step, tc.lr_num_warmup_steps, tc.lr_decay_start_step,
                     tc.lr_num_decay_steps)


def _on(batch: dlrm.Batch, dev: torch.device) -> dlrm.Batch:
    """The batch on `dev` (a no-op for fields already there)."""
    return dlrm.Batch(*(None if t is None else t.to(dev, non_blocking=True) for t in batch))


def _state_device(state: TrainState, dev: torch.device) -> None:
    got = state.params["bot"][0]["w"].device
    if got.type != dev.type or (dev.index is not None and got != dev):
        raise ValueError(f"train state lies on {got}, the step was built for {dev}")


def _build_step_fn(config: DLRMConfig, tc: TrainConfig, plain: bool = False,
                   device: Device = None) -> Step:
    """The dense-autograd train step (every parameter, tables included, gets
    a dense gradient). Returns new parameters; the state is not modified."""
    _check(config, tc)
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        _state_device(state, dev)
        batch = _on(batch, dev)
        qstate = state.qstate
        if config.quant.enabled:
            # periodic scale refresh before the forward (paper section 3.2)
            qstate = dlrm.update_emb_scales(config, state.params, qstate)
        params = _map(lambda t: t.detach().requires_grad_(), state.params)
        logits, new_qs = dlrm.forward(config, params, batch, qstate, train=True, plain=plain)
        loss = dlrm.training_loss(config, logits, batch.labels)
        grads = torch.autograd.grad(loss, _leaves(params))
        if tc.loss_scale != 1.0:
            grads = [g * tc.loss_scale for g in grads]
        lr = _lr(tc, qstate.step + 1)
        with torch.no_grad():
            new_params = sgd_update(state.params, _unflatten(state.params, grads), lr)
        new_qs = new_qs._replace(step=qstate.step + 1)
        return TrainState(new_params, state.opt_state, new_qs), loss.detach()

    return step_fn


def _build_sparse_step_fn(config: DLRMConfig, tc: TrainConfig, plain: bool = False,
                          device: Device = None) -> Step:
    """The train step with explicit sparse embedding updates (the reference's
    nn.EmbeddingBag(sparse=True) + manual SGD, sgd_quantized_gradients_
    parallel_comm.py:601-685). Updates the embedding tables in place."""
    _check(config, tc)
    dev = resolve_device(device)
    qc = config.quant

    def step_fn(state: TrainState, batch: dlrm.Batch) -> Tuple[TrainState, torch.Tensor]:
        _state_device(state, dev)
        batch = _on(batch, dev)
        params, qstate = state.params, state.qstate
        if qc.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        with torch.no_grad():
            raw_pooled = dlrm.lookup_all(config, params, batch.indices, batch.mask, plain=plain)
        mlp = {part: _map(lambda t: t.detach().requires_grad_(), params[part])
               for part in ("bot", "top")}
        pooled = raw_pooled.requires_grad_()
        logits, new_qs = dlrm.forward(config, {**mlp, "emb": params["emb"]}, batch, qstate,
                                      train=True, raw_pooled=pooled)
        loss = dlrm.training_loss(config, logits, batch.labels)
        *mlp_grads, g_pooled = torch.autograd.grad(loss, _leaves(mlp) + [pooled])
        if tc.loss_scale != 1.0:
            mlp_grads = [g * tc.loss_scale for g in mlp_grads]
            g_pooled = g_pooled * tc.loss_scale
        lr = _lr(tc, qstate.step + 1)

        with torch.no_grad():
            mlp_params = {part: params[part] for part in ("bot", "top")}
            new_params = dict(params, **sgd_update(mlp_params, _unflatten(mlp_params, mlp_grads), lr))
            for k, table in enumerate(params["emb"]):
                m = batch.mask[k] if batch.mask is not None else None
                ids, vals = rows_grad_from_pooled(g_pooled[k], batch.indices[k], m)
                n_rows = table.shape[0]
                if 0 < n_rows <= tc.onehot_update_max_rows:
                    # small table: K1's dense gradient, then a dense update
                    # (untouched rows see dense == 0)
                    table.add_(-lr * dense_grad_auto(ids, vals, n_rows, plain=plain))
                elif n_rows <= _SORTED_SCATTER_MAX_ROWS and ids.shape[0] >= _SORTED_SCATTER_MIN_UPDATES:
                    uids, uvals = coalesce_sparse_grad(ids, vals, n_rows, max_unique=ids.shape[0])
                    scatter_add_drop(table, uids, -lr * uvals)
                else:
                    scatter_add_drop(table, ids, -lr * vals)
        new_qs = new_qs._replace(step=qstate.step + 1)
        return TrainState(new_params, state.opt_state, new_qs), loss.detach()

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
        _state_device(state, dev)
        return dlrm.predict(config, state.params, _on(batch, dev), state.qstate, plain=plain)

    return eval_fn
