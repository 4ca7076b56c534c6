"""Top-k row-sparsified gradient synchronization (the ImageNet side-harness).

Port of the JAX package's parallel/topk_grad.py, its form of
`average_gradients_update` (training_imagenet_speedup.py:120-232) and the
loop around it (:541-562), the reference's sanity check of compressed-
gradient training outside DLRM:

- each rank scores every row of every >= 2-D parameter by
  ||row||^2 / row_numel of its local gradient (optionally times a per-row
  Hessian-trace weight, :137-140); every `world` steps the ranks' score
  vectors are exchanged (:148-167);
- step i applies the global top-k rows (over all layers) of rank
  i % world's scores (:174, round robin): the selected rows' gradients are
  summed over the ranks, averaged, weight-decayed and applied with plain
  SGD (:184-205);
- unselected rows take the rank's local gradient, as the reference's
  `optimizer.step()` (:562) applies the un-zeroed grads: replicas drift
  there like local SGD and re-converge as rows rotate through the top-k;
- 1-D parameters (biases, BN) are always averaged densely (:206-222);
- the synced volume counts mega-elements (:183: numel * selected /
  size(0) / 1e6).

One process per rank on a torch.distributed group (`parallel/multihost.py`:
NCCL on the card, gloo on the CPU; a gloo group with the card's tensors
stages each collective through host copies, `multihost.staged`). Each rank
keeps its own params, as `comm_grad.make_dp_nosync_train_step` does: the
JAX step is a `shard_map` whose params are declared replicated with the
check off, so each device keeps its own drifted copy, and rank r's params
here are JAX's `leaf.addressable_shards[r].data`. Every step runs:

- one all-gather of the [rows_total] float32 score vector (adopted only on
  refresh steps, step % world == 0, as JAX's `where`);
- one SUM all-reduce of the concatenation of what JAX sums leaf by leaf
  (the sums are elementwise, so the concatenation changes nothing): per
  >= 2-D leaf, the masked full-shape gradient (`mode="mask"`, the
  reference's dense wire) or only the [k_l, cols] block of its selected
  rows (`mode="gather"`, a static per-layer budget k_l ~ top_k * rows_l /
  rows_total); every 1-D gradient; the loss (averaged over the ranks).

The row domain follows JAX's tree order: `jax.tree_util` flattens dicts by
sorted key, so the score vector and the mask offsets run conv[0].w ...
conv[n-1].w, head.w whatever order the port's dicts hold. Row selection
breaks ties to the lower index, as `lax.top_k` does (a stable descending
sort): the zero scores of dead filters make ties real.

`estimate_row_trace` draws JAX's Rademacher vectors bit for bit on the host
(partitionable threefry, `rademacher_vectors`) and forms each Hessian-vector
product by double backward through the straight-through estimators.

Where the reference seeds `tmp_list` with a dummy zero entry (:125) and so
applies every mask one row off, the JAX package aligns masks with the
scored rows; so does the port. The gradients and the products run under
`quant_conv.fp32_convs()`: cuDNN reads its TF32 flag when the backward
runs, and the JAX package computes in float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.quant_conv import fp32_convs
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import world_size
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import staged
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.ranking_range import random_bits, threefry2x32

Device = Optional[Union[str, torch.device]]
Key = Tuple[int, int]
Path = Tuple[Union[str, int], ...]


class TopKState(NamedTuple):
    params: Any  # this rank's params
    # per-rank global row-score vectors [world, rows_total]; refreshed every
    # `world` steps (tmp_list_all, training_imagenet_speedup.py:148-167)
    scores: torch.Tensor
    step: int


def _paths(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs in `jax.tree_util`'s order: dicts by sorted key,
    lists and tuples by position."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _paths(x, prefix + (i,))
    else:
        yield prefix, tree


def _rebuild(tree: Any, new: Dict[Path, torch.Tensor], prefix: Path = ()) -> Any:
    """`tree`'s nest (its own dict order) with each leaf replaced by
    new[path]."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(x, new, prefix + (i,)) for i, x in enumerate(tree)]
    return new[prefix]


def _matrix_leaves(params: Any) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs of the >= 2-D leaves in JAX's tree order: the
    counterpart of iterating `model.named_parameters()` (:131, :171)."""
    return [(p, l) for p, l in _paths(params) if l.dim() >= 2]


def total_rows(params: Any) -> int:
    """Summed leading-dim rows over all >= 2-D params (the top-k domain)."""
    return int(sum(l.shape[0] for _, l in _matrix_leaves(params)))


def get_k_value(k: int, epoch: int, total_epoch: int, dataset: str = "cifar10") -> int:
    """Epoch schedule growing the synced-row budget
    (training_imagenet_speedup.py:251-272)."""
    if dataset == "imagenet":
        if epoch > 60:
            return 4 * k
        if epoch > 30:
            return 2 * k
        return k
    if dataset == "cifar10":
        if epoch > 150:
            return 8 * k
        if epoch > 120:
            return 4 * k
        if epoch > 60:
            return 2 * k
        return k
    return k


def _row_scores(g: torch.Tensor, trace_w: Optional[torch.Tensor]) -> torch.Tensor:
    """||row||^2 / row_numel, optionally times the normalized Hessian trace
    (training_imagenet_speedup.py:135-140; its normalization :493-500)."""
    flat = g.reshape(g.shape[0], -1)
    s = q.divide((flat * flat).sum(dim=1), float(flat.shape[1]))
    if trace_w is not None:
        s = s * trace_w
    return s


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest scores, largest first, ties to the
    lower index (`lax.top_k`'s order)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _on_rows(batch: Any, start: int, size: int, dev: torch.device) -> Any:
    """Rows [start, start + size) of every array of a (nest of) batch
    arrays, as tensors on `dev`."""
    if isinstance(batch, dict):
        return {k: _on_rows(v, start, size, dev) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_on_rows(x, start, size, dev) for x in batch)
    if batch is None:
        return None
    return torch.as_tensor(batch)[start:start + size].to(dev, non_blocking=True)


def _batch_size(batch: Any) -> int:
    leaf = next(x for x in (batch.values() if isinstance(batch, dict) else
                            batch if isinstance(batch, (list, tuple)) else [batch]) if x is not None)
    return _batch_size(leaf) if isinstance(leaf, (dict, list, tuple)) else int(leaf.shape[0])


def _all_gather(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """[n, *x.shape]: every rank's x, in rank order."""
    s = staged(x, group).contiguous()
    out = torch.empty((n * s.shape[0],) + tuple(s.shape[1:]), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(out, s, group=group)
    return out.reshape((n,) + tuple(x.shape)).to(x.device)


def _all_sum(parts: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, through one SUM all-reduce of
    their concatenation."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    s = staged(flat, group)
    dist.all_reduce(s, group=group)
    s = s.to(flat.device)
    return [m.reshape(p.shape) for p, m in zip(parts, s.split([p.numel() for p in parts]))]


def _synced_melem(terms: Sequence[Tuple[Optional[torch.Tensor], float]], dev: torch.device) -> torch.Tensor:
    """The synced Melem, sum over the leaves (in tree order) of
    `rows_synced * (numel / rows) / 1e6` (>= 2-D) and `numel / 1e6` (1-D),
    rounded as XLA computes JAX's float32 sum: the division by 1e6 as a
    product with the reciprocal, folded with numel / rows into one float32
    constant; each run of consecutive constant terms folded into one, a
    leading run joining the run after the first leaf that is not constant."""
    f32 = np.float32
    expr, pend = None, None
    for count, c in terms:
        if count is None:
            pend = f32(c) if pend is None else f32(pend + f32(c))
            continue
        v = count * float(f32(f32(c) * f32(1e-6)))
        if expr is None:
            expr = v
        else:
            expr = (expr if pend is None else expr + float(pend)) + v
            pend = None
    if expr is None:
        return torch.tensor(float(pend or 0.0), device=dev)
    return expr if pend is None else expr + float(pend)


def make_topk_dp_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    group=None,
    top_k: int = 32,
    learning_rate: float = 0.05,
    weight_decay: float = 0.0,
    mode: str = "mask",
    trace: Optional[Sequence[Optional[torch.Tensor]]] = None,
    device: Device = None,
    backend: Optional[str] = None,
):
    """The data-parallel top-k step on `group` (the default group when
    None, which must exist and run NCCL for the card or gloo for the CPU,
    unless `backend` names another).

    loss_fn(params, local_batch) -> scalar loss on this rank's rows.
    `trace`: optional per-matrix-leaf [rows] Hessian-trace weights in JAX's
    tree order (the `--metric hessian` path; None entries for unweighted).
    Returns step(state, global batch) -> (state, (mean loss, synced
    Melem)): the batch is a (nest of) arrays whose leading dim splits over
    the ranks (rank r takes rows [r B / N, (r + 1) B / N), JAX's batch
    sharding); the two results are float32 tensors on the device."""
    if mode not in ("mask", "gather"):
        raise ValueError(f"mode must be 'mask' or 'gather', got {mode!r}")
    dev = resolve_device(device)
    world = world_size(dev, backend, group)
    me = dist.get_rank(group)
    lr, wd = learning_rate, weight_decay

    def step_fn(state: TopKState, batch) -> Tuple[TopKState, Tuple[torch.Tensor, torch.Tensor]]:
        B = _batch_size(batch)
        if B % world:
            raise ValueError(f"a global batch of {B} does not split over {world} ranks")
        local = _on_rows(batch, me * (B // world), B // world, dev)
        paths = list(_paths(state.params))
        leaves = [l.detach().requires_grad_() for _, l in paths]
        params = _rebuild(state.params, {p: l for (p, _), l in zip(paths, leaves)})
        with fp32_convs():
            loss = loss_fn(params, local)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
            mat = [i for i, l in enumerate(leaves) if l.dim() >= 2]
            rows_total = sum(leaves[i].shape[0] for i in mat)
            k_global = min(top_k, rows_total)
            tw = list(trace) if trace is not None else [None] * len(mat)
            scores_local = torch.cat([_row_scores(grads[i], w) for i, w in zip(mat, tw)])
            # exchanged every step (one [rows_total] vector), adopted on
            # refresh steps only (:129 indicator % W == 0)
            gathered = _all_gather(scores_local, world, group)
            scores_all = gathered if state.step % world == 0 else state.scores
            sel_scores = scores_all[state.step % world]  # :174 the round-robin mask owner
            if mode == "mask":  # the global top-k rows (:148-156)
                sel_mask = torch.zeros(rows_total, device=dev).index_fill_(
                    0, top_k_indices(sel_scores, k_global), 1.0)

            parts, how, ptr = [], [], 0
            for p, g in zip(leaves, grads):
                if p.dim() >= 2:
                    rows = p.shape[0]
                    if mode == "mask":
                        mb = sel_mask[ptr:ptr + rows].reshape((rows,) + (1,) * (p.dim() - 1))
                        parts.append(g * mb)
                        how.append(mb)
                    else:
                        k_l = max(1, min(rows, round(k_global * rows / rows_total)))
                        idx = top_k_indices(sel_scores[ptr:ptr + rows], k_l)
                        parts.append(g.index_select(0, idx))
                        how.append(idx)
                    ptr += rows
                else:
                    parts.append(g)
                    how.append(None)
            *sums, loss_sum = _all_sum(parts + [loss.detach().reshape(1)], group)

            new, synced = {}, []
            for (path, _), p, g, s, h in zip(paths, leaves, grads, sums, how):
                p = p.detach()
                if p.dim() >= 2:
                    rows = p.shape[0]
                    if mode == "mask":
                        mb = h
                        u = q.divide(s, float(world)) + wd * p * mb
                    else:
                        u_rows = q.divide(s, float(world)) + wd * p.index_select(0, h)
                        u = torch.zeros_like(p).index_copy_(0, h, u_rows)
                        mb = torch.zeros(rows, device=dev).index_fill_(0, h, 1.0)
                        mb = mb.reshape((rows,) + (1,) * (p.dim() - 1))
                    # synced rows: the averaged update; the others: local SGD
                    # (optimizer.step() on un-zeroed grads, :562)
                    new[path] = p - lr * u - lr * g * (1.0 - mb)
                    synced.append((mb.sum(), p.numel() / rows))
                else:
                    new[path] = p - lr * (q.divide(s, float(world)) + wd * p)
                    synced.append((None, p.numel() / 1e6))
            mean_loss = q.divide(loss_sum[0], float(world))
        return (TopKState(_rebuild(state.params, new), scores_all, state.step + 1),
                (mean_loss, _synced_melem(synced, dev)))

    return step_fn


def broadcast_trace(trace: Optional[Sequence[torch.Tensor]], params: Any, group=None,
                    src: int = 0) -> List[torch.Tensor]:
    """Rank `src`'s per-matrix-leaf traces (None on the other ranks) on
    every rank of `group`, through one broadcast of their concatenation."""
    rows = [int(l.shape[0]) for _, l in _matrix_leaves(params)]
    dev = _matrix_leaves(params)[0][1].device
    flat = torch.cat(list(trace)) if trace is not None else torch.empty(sum(rows), device=dev)
    s = staged(flat, group)
    dist.broadcast(s, src=src, group=group)
    return list(s.to(dev).split(rows))


def init_topk_state(params: Any, world: int) -> TopKState:
    leaf = next(l for _, l in _paths(params))
    return TopKState(params=params, scores=torch.zeros((world, total_rows(params)), device=leaf.device),
                     step=0)


# ---------------------------------------------------------------------------
# Hutchinson's per-row Hessian trace
# ---------------------------------------------------------------------------


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)`: the key words (seed >> 32, low 32 bits)."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def split_key(key: Key, n: int) -> List[Key]:
    """`jax.random.split(key, n)` under partitionable threefry: the hash of
    the counters (0, i)."""
    b0, b1 = threefry2x32(key[0], key[1], np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def rademacher(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """`jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0)`,
    float32: JAX's uniform on [0, 1) from the key's bits, below 0.5."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(key, n)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.where(u < np.float32(0.5), np.float32(1), np.float32(-1)).reshape(shape)


def rademacher_vectors(key: Key, n_samples: int, shapes: Sequence[Tuple[int, ...]]) -> List[List[np.ndarray]]:
    """The probe vectors of `estimate_row_trace`: for each of the
    `split(key, n_samples)` keys, one Rademacher array per leaf shape (in
    JAX's tree order) from `split(sample key, len(shapes))`."""
    return [[rademacher(vk, tuple(s)) for vk, s in zip(split_key(k, len(shapes)), shapes)]
            for k in split_key(key, n_samples)]


def estimate_row_trace(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params: Any,
    batch: Any,
    n_samples: int = 8,
    key: Optional[Key] = None,
    normalize: bool = True,
) -> List[torch.Tensor]:
    """Per-row Hutchinson Hessian-trace estimates for the `--metric hessian`
    scoring path (training_imagenet_speedup.py:474-500): for Rademacher v,
    Hv = d/dp <grad loss(p), v> by double backward (what pyhessian does
    with `autograd.grad(create_graph=True)`, and what the straight-through
    estimators allow), accumulated as sum_over_row(v * Hv), an unbiased
    estimate of the row's Hessian diagonal mass. With `normalize` the
    reference's weighting t / (2 numel / rows) + 1 (:496-500) makes the
    weights ~1-centered multipliers for the row scores.

    `key` is a JAX key's two words (`prng_key(0)` when None); the probes
    equal JAX's bit for bit. `batch` goes whole to `loss_fn`, on the
    params' device. Returns one [rows] tensor per >= 2-D leaf in JAX's tree
    order, to pass as `trace=` to `make_topk_dp_train_step`."""
    key = prng_key(0) if key is None else key
    paths = list(_paths(params))
    leaves = [l.detach().requires_grad_() for _, l in paths]
    dev = leaves[0].device
    tree = _rebuild(params, {p: l for (p, _), l in zip(paths, leaves)})
    batch = _on_rows(batch, 0, _batch_size(batch), dev) if batch is not None else None
    probes = rademacher_vectors(key, n_samples, [tuple(l.shape) for l in leaves])
    acc = None
    with fp32_convs():
        grads = torch.autograd.grad(loss_fn(tree, batch), leaves, create_graph=True, allow_unused=True)
        for vs in probes:
            v = [torch.from_numpy(a).to(dev) for a in vs]
            dot = sum((g * vv).sum() for g, vv in zip(grads, v) if g is not None)
            hv = torch.autograd.grad(dot, leaves, retain_graph=True, allow_unused=True)
            s = [(vv * (torch.zeros_like(vv) if h is None else h.detach())).reshape(vv.shape[0], -1).sum(dim=1)
                 for vv, h in zip(v, hv) if vv.dim() >= 2]
            acc = s if acc is None else [a + b for a, b in zip(acc, s)]
    traces = [q.divide(a, float(n_samples)) for a in acc]
    if normalize:
        mats = [l for l in leaves if l.dim() >= 2]
        traces = [q.divide(t, 2.0 * l.numel() / l.shape[0]) + 1.0 for t, l in zip(traces, mats)]
    return traces
