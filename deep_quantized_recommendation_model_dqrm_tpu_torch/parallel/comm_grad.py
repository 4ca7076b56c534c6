"""Data-parallel training with quantized and sparsified gradient exchange.

Port of the JAX package's parallel/comm_grad.py, the DQRM headline
contribution (paper section 3.3; the reference's dlrm_s_pytorch_comm_grad.py:
1934-1991 and sgd_quantized_gradients_parallel_comm.py). One process per
card (torchrun's layout) holds a full replica; the collectives run on the
torch.distributed process group of `parallel/multihost.py` (NCCL on the
card, gloo on the CPU), where JAX runs them inside one `shard_map`:

- each rank computes gradients on its slice of the global batch;
- embedding gradients never densify: autograd is cut at the raw pooled
  lookups, each table's gradient is coalesced into (ids, rows), the rows
  are quantized with a per-table scale averaged over the ranks, and every
  rank all-gathers every rank's (ids, integer rows) and applies all of them
  (sgd_..._parallel_comm.py:257-320, 850-890); at 4 bits or fewer the rows
  travel two to a byte;
- MLP gradients: per-channel (weights) or per-tensor (biases) quantization
  with scales averaged over the ranks, one int32 all-reduce for all of
  them, dequantize, divide by the world size (sgd_..._parallel_comm.py:
  892-961), with optional error-feedback residuals
  (sgd_quantized_gradients.py:570-630);
- the other dense parameters (LSQ's step sizes) take one plain mean
  all-reduce; LSQ's gradient scales count the global batch
  (`lsq_numel_scale` = the world size), so the mean step gradients equal the
  single-device ones;
- the activation ranges of the QuantActs move on each rank's own slice and
  stay each rank's own, as each device's copy does in the JAX engines (whose
  replicated state reads back as the first device's copy);
- the update is the reference's manual SGD (`weight_update_parallel_comm`,
  sgd_..._parallel_comm.py:601-685); the tables take the routes of the
  single-device sparse step (`train_step.apply_table_updates`): one grouped
  K1 launch for the small tables, one sort and one grouped K5 launch for
  the mid tables, a scatter-add for the rest;
- `make_weight_sync` is the periodic full-weight mean (`weight_syncc`,
  comm_grad.py:1977-1991) the caller runs every `weight_sync_period` steps;
- every model option runs as in the JAX engines: QR/MD tables through the
  MLP's exchange, pooling weights, bf16 tables and compute, and the
  ranking-range policy over the plain tables' exchange
  (`parallel/ranking_range.py`).

The steps run eagerly and update the embedding tables in place, as the
single-device sparse step does. A step built for the card refuses to run
without a process group, and on a group whose backend is not the one asked
for (NCCL unless the caller names another): it never runs quietly on one
rank.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    coalesce_sparse_grads_batched,
    rows_grads_from_pooled,
    scatter_add_drop,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import ranking_range
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    TrainState,
    _build_step_fn,
    _check,
    _learned_vw_grads,
    _lr,
    _on,
    _params_device,
    _unflatten,
    apply_table_updates,
    dense_keys,
    make_table_routes,
    repeat_step,
    sparse_grads,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

Device = Optional[Union[str, torch.device]]
MLP_KEYS = ("w", "b")


class DPState(NamedTuple):
    params: dlrm.Params
    qstate: dlrm.QuantState
    # error-feedback residuals of the MLP gradients
    # (sgd_quantized_gradients.py:570-630), zeros when error_compensation is off
    ec: Any


def zero_ec(params: dlrm.Params) -> Any:
    """Zero residuals {"bot"/"top": [{"w", "b"}]} shaped like the MLPs."""
    return {part: [{k: torch.zeros_like(l[k]) for k in MLP_KEYS} for l in params[part]]
            for part in ("bot", "top")}


def dp_state_from(params: dlrm.Params, qstate: dlrm.QuantState) -> DPState:
    """Wrap existing params (a TrainState's, possibly loaded from a
    checkpoint) into a DPState without initializing the model again."""
    return DPState(params=params, qstate=qstate, ec=zero_ec(params))


def init_dp_state(config: DLRMConfig, tc: TrainConfig, seed: Optional[int] = None,
                  device: Device = None) -> DPState:
    """`init_params` (bit-identical to the JAX package's) and a fresh
    QuantState, on the card unless `device` says otherwise."""
    dev = resolve_device(device)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed, device=dev)
    return dp_state_from(params, dlrm.init_quant_state(config, dev))


def pin_dp_state_layout(state: DPState, group=None) -> DPState:
    """Returns `state`. The JAX package pins its tables to a row-major
    layout here; a PyTorch table is always stored row-major, so there is
    nothing to pin."""
    return state


def world_size(device: Device = None, backend: Optional[str] = None, group=None) -> int:
    """The size of `group` (the default group when None), after checking
    that it exists and runs `backend` (NCCL for tensors on the card, gloo
    for the CPU, unless named): the engines never run on one rank or on an
    unexpected transport by default."""
    dev = resolve_device(device)
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        raise RuntimeError("the data-parallel engines need a process group: call "
                           "parallel.multihost.init_distributed first")
    have = dist.get_backend(group)
    if have != want:
        raise RuntimeError(f"the process group runs {have}; tensors on {dev} take {want} "
                           "unless the caller names another backend")
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Compressed collectives
# ---------------------------------------------------------------------------


def _mean_scale(scale: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce mean over the ranks, of quantization scales
    (sgd_..._parallel_comm.py:874-878: `all_reduce(scale); scale /= N`) or
    of the loss."""
    s = scale.detach().clone()
    dist.all_reduce(s, group=group)
    return q.divide(s, float(dist.get_world_size(group)))


def _local_scale(g: torch.Tensor, bits: int, per_channel: bool) -> torch.Tensor:
    """The symmetric scale of one gradient: per output channel for a 2-D
    weight when `per_channel`, else one for the tensor."""
    if per_channel and g.dim() == 2:
        return q.symmetric_quantization_params(bits, g.amin(dim=1), g.amax(dim=1))
    return q.symmetric_quantization_params(bits, g.min(), g.max())


def compressed_psum_dense(g: torch.Tensor, bits: int, per_channel: bool, group=None) -> torch.Tensor:
    """The mean of `g` over the ranks through an integer all-reduce
    (quantize_linear_grad / quantize_bias_grad, sgd_..._parallel_comm.py:
    892-961): the scale averaged over the ranks, quantize, int32 SUM,
    dequantize, divide by the world size."""
    s = _mean_scale(_local_scale(g, bits, per_channel), group)
    g_int = q.quantize(g, s, bits).to(torch.int32)
    dist.all_reduce(g_int, group=group)
    return q.divide(q.dequantize(g_int, s), float(dist.get_world_size(group)))


def _compressed_sum(tensors: Sequence[torch.Tensor], local_scales: Sequence[torch.Tensor], bits: int,
                    group=None) -> List[torch.Tensor]:
    n = dist.get_world_size(group)
    sizes = [s.numel() for s in local_scales]
    s_all = _mean_scale(torch.cat([s.reshape(-1) for s in local_scales]), group)  # one all-reduce
    scales = [s.reshape(ls.shape) for s, ls in zip(s_all.split(sizes), local_scales)]
    flats = torch.cat([q.quantize(g, s, bits).to(torch.int32).reshape(-1)
                       for g, s in zip(tensors, scales)])
    dist.all_reduce(flats, group=group)  # one int32 all-reduce, never cast to float before it
    return [q.divide(q.dequantize(gi.reshape(g.shape), s), float(n))
            for g, s, gi in zip(tensors, scales, flats.split([g.numel() for g in tensors]))]


def compressed_psum_batched(tensors: Sequence[torch.Tensor], bits: int,
                            per_channel_flags: Sequence[bool], group=None) -> List[torch.Tensor]:
    """Bit-identical to mapping `compressed_psum_dense` over `tensors`, with
    one scale all-reduce and one int32 all-reduce for the whole list
    (concatenation commutes with both: the scale mean is elementwise and the
    integer sum exact). Returns the dequantized mean gradients."""
    local = [_local_scale(g, bits, pc) for g, pc in zip(tensors, per_channel_flags)]
    return _compressed_sum(tensors, local, bits, group)


def _gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[N, *x.shape]: every rank's x, in rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous().reshape((-1,) + tuple(x.shape[1:]))  # gloo concatenates along dim 0
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.reshape((n,) + tuple(x.shape))


def gather_tables(x: torch.Tensor, group=None) -> torch.Tensor:
    """[Td, K, ...] on each rank -> [Td, N K, ...]: each table's rows of
    every rank, rank-major (JAX's per-table tiled all_gather order, which
    the K5 route's stable sort relies on)."""
    g = _gather(x, group)  # [N, Td, K, ...]
    return g.movedim(0, 1).reshape((x.shape[0], -1) + tuple(x.shape[2:]))


def _pack_nibbles(v_int: torch.Tensor) -> torch.Tensor:
    """int4 values in [-8, 7], [..., D] int8 -> [..., D/2] uint8: the low
    nibble holds columns [:D/2], the high nibble [D/2:], each offset by 8."""
    u = (v_int.to(torch.int32) + 8).to(torch.uint8)
    d = u.shape[-1] // 2
    return u[..., :d] | (u[..., d:] << 4)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    v = packed.to(torch.int32)
    return torch.cat([(v & 0xF) - 8, ((v >> 4) & 0xF) - 8], dim=-1).to(torch.int8)


def compressed_sparse_allgather(ids: torch.Tensor, vals: torch.Tensor, bits: int,
                                group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One table's sparse gradient exchange: the scale averaged over the
    ranks, the rows quantized, then every rank's (ids [K], integer rows
    [K, D]) all-gathered (quantize_emb_grad + all_reduce,
    sgd_..._parallel_comm.py:850-890). At 4 bits or fewer and an even D the
    rows travel two to a byte. Returns (ids [N K], int8 rows [N K, D],
    scale)."""
    s = _mean_scale(q.symmetric_quantization_params(bits, vals.min(), vals.max()), group)
    v_int = q.quantize(vals, s, bits)
    all_ids = _gather(ids, group).reshape(-1)
    if bits <= 4 and vals.shape[-1] % 2 == 0:
        all_vals = _unpack_nibbles(_gather(_pack_nibbles(v_int), group).reshape(-1, vals.shape[-1] // 2))
    else:
        all_vals = _gather(v_int, group).reshape(-1, vals.shape[-1])
    return all_ids, all_vals, s


def _mean_tensors(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, through one float32
    all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = q.divide(flat, float(dist.get_world_size(group)))
    return [m.reshape(t.shape) for t, m in zip(tensors, flat.split([t.numel() for t in tensors]))]


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def make_dp_train_step(
    config: DLRMConfig,
    tc: TrainConfig,
    group=None,
    steps_per_dispatch: int = 1,
    plain: bool = False,
    device: Device = None,
    backend: Optional[str] = None,
):
    """The data-parallel train step with compressed gradient exchange.

    The returned fn takes (DPState, this rank's slice of the global batch)
    and returns (new DPState, the loss averaged over the ranks); it follows
    comm_grad.py:1874-1991 of the reference: forward -> backward -> quantize
    and exchange the gradients -> manual SGD -> lr step. The embedding
    tables are updated in place. `steps_per_dispatch` > 1 runs that many
    steps per call over a list of batches or one stacked Batch
    (`train_step.repeat_step`). `plain=True` takes the plain versions of K1,
    K4 and K5. `group` and `backend`: see `world_size`.

    Every model option of the single-device step runs (JAX comm_grad.py:
    289-307, 453-497, 510-527, 563-673):
    - QR/MD tables take dense gradients through their recomputed lookups;
      the leaves ride the MLP's compressed exchange (per channel when 2-D),
      with no error-feedback residual, then manual SGD;
    - under weighted pooling each occurrence's row gradient is scaled by
      mask * v_W[idx]; learned `v_W` of the dense tables takes the scalar
      gradients g_pooled . E[idx] (PACT-transformed rows under PACT),
      coalesced in one pass and exchanged uncompressed in one pair of
      all-gathers; the QR/MD tables' `v_W`, fixed `v_W` and LSQ's steps
      take one plain mean all-reduce;
    - a bf16 table takes its float32 update rounded after the scaling by
      lr / N: K1's add and K5 round once, the scatter each update;
    - `ranking_range` draws each step's modes (`parallel/ranking_range.py`)
      from the ranges max|coalesced rows| (MAX over the ranks) over the
      tables' weight scales, and exchanges the rows on the int16 two-byte
      channels in one pair of all-gathers; a skipped table's ids become its
      row count, which every route drops."""
    _check(tc)
    qc = config.quant
    trick_ks = dlrm.trick_slots(config)
    dense_ks = [k for k in range(config.num_tables) if k not in trick_ks]
    if tc.ranking_range and not dense_ks:
        raise ValueError(
            "ranking_range is a policy over the SPARSE embedding-gradient "
            "exchange; this model has no dense tables (all QR/MD) — "
            "nothing for the policy to govern")
    dev = resolve_device(device)
    n = world_size(dev, backend, group)
    bits = tc.grad_quant_bits
    learned_vw = config.weighted_pooling == "learned"
    dense_rows = [config.table_sizes[k] for k in dense_ks]
    # the dense tables' routes, by their ordinal among the dense tables
    routes = make_table_routes(dense_rows, tc)
    dense_sel = torch.tensor(dense_ks, device=dev)
    dense_rows_t = torch.tensor(dense_rows, dtype=torch.int32, device=dev)[:, None]
    keys = [(part, li, key) for part in ("bot", "top")
            for li in range(len(config.mlp_bot if part == "bot" else config.mlp_top) - 1)
            for key in MLP_KEYS]
    per_channel = [key == "w" for _, _, key in keys]

    def step_fn(state: DPState, batch: dlrm.Batch) -> Tuple[DPState, torch.Tensor]:
        _params_device(state.params, dev)
        batch = _on(batch, dev)
        params, qstate = state.params, state.qstate
        if qc.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        loss, new_qs, grads, g_pooled = sparse_grads(config, params, qstate, batch, plain,
                                                     lsq_numel_scale=float(n))
        trick_grads = grads.pop("emb_trick", {})
        lr = _lr(tc, qstate.step + 1)
        lr_n = _over(lr, n)

        with torch.no_grad():
            mean_loss = _mean_scale(loss, group)
            gs = [grads[p][li][k] + state.ec[p][li][k] if tc.error_compensation else grads[p][li][k]
                  for p, li, k in keys]
            trick_leaves = [(k, leaf) for k in trick_ks for leaf in sorted(trick_grads[k])]
            tg = [trick_grads[k][leaf] for k, leaf in trick_leaves]
            new_ec = state.ec  # never read while error compensation is off
            if bits >= 32:
                means = _mean_tensors(gs + tg, group)  # one all-reduce for the MLP and QR/MD leaves
                if tc.error_compensation:
                    new_ec = zero_ec(params)
            else:
                local = [_local_scale(g, bits, pc) for g, pc in zip(gs, per_channel)]
                means = _compressed_sum(gs + tg, local + [_local_scale(g, bits, g.dim() == 2) for g in tg],
                                        bits, group)
                if tc.error_compensation:
                    # the residual is what the LOCAL scale's quantization
                    # lost (sgd_quantized_gradients.py:596-598); none for
                    # the QR/MD leaves
                    new_ec = _nest(keys, [g - q.dequantize(q.quantize(g, s, bits), s)
                                          for g, s in zip(gs, local)])
            mlp_params = {part: params[part] for part in ("bot", "top")}
            new_params = dict(params, **sgd_update(mlp_params, _nest(keys, means[:len(keys)]), lr))
            if trick_ks:
                new_params["emb"] = list(params["emb"])
                for (k, leaf), g in zip(trick_leaves, means[len(keys):]):
                    new_params["emb"][k] = dict(new_params["emb"][k], **sgd_update(
                        {leaf: params["emb"][k][leaf]}, {leaf: g}, lr))
            # LSQ's steps and the QR/MD tables' learned v_W: one plain mean
            # all-reduce, then SGD. Fixed v_W takes no gradient: p - lr * 0
            # leaves it as it is, so it is not sent.
            rest = {key: grads[key] for key in dense_keys(params) if key not in ("bot", "top", "v_W")}
            if learned_vw and trick_ks:
                rest["v_W"] = {k: grads["v_W"][k] for k in trick_ks}
            if rest:
                mean_rest = _unflatten(rest, _mean_tensors(tree_leaves(rest), group))
                for key, g in mean_rest.items():
                    if key == "v_W":
                        new_params["v_W"] = [sgd_update(v, g[k], lr) if k in g else v
                                             for k, v in enumerate(params["v_W"])]
                    else:
                        new_params[key] = sgd_update(params[key], g, lr)
            if dense_ks:
                apply_dense_tables(params, qstate, batch, g_pooled, lr_n)
        new_qs = new_qs._replace(step=qstate.step + 1)
        return DPState(new_params, new_qs, new_ec), mean_loss

    def apply_dense_tables(params, qstate, batch, g_pooled, lr_n) -> None:
        """The dense tables' rows (and learned v_W's), in place: coalesce
        every table in one pass, then one scale all-reduce and two
        all-gathers for all of them (ranking_range: a MAX all-reduce of the
        ranges and two all-gathers)."""
        pick = (lambda t: t) if not trick_ks else (lambda t: t.index_select(0, dense_sel))  # noqa: E731
        weights = dlrm.pooling_weights(config, params.get("v_W"), batch.indices, batch.mask)
        ids, vals = rows_grads_from_pooled(pick(g_pooled), pick(batch.indices),
                                           None if weights is None else pick(weights))
        uniq_ids, uniq_vals = coalesce_sparse_grads_batched(ids, vals, dense_rows, ids.shape[1])
        if learned_vw:  # from the tables before their update
            vw_ids, vw_vals = _learned_vw_grads(config, params, batch, g_pooled, dense_ks)
        all_ids = gather_tables(uniq_ids, group)
        if tc.ranking_range:
            ranges = uniq_vals.abs().amax(dim=(1, 2))
            dist.all_reduce(ranges, op=dist.ReduceOp.MAX, group=group)
            w_scales = qstate.emb_scales.index_select(0, dense_sel) if qc.enabled else torch.ones_like(ranges)
            modes = ranking_range.assign_bit_widths(ranges, w_scales, qstate.step,
                                                    tc.ranking_frac_hi, tc.ranking_frac_int8)
            s = ranking_range.grad_scale_int16(ranges)[:, None, None]
            m = modes[:, None, None]
            enc = ranking_range.encode_two_channel(uniq_vals, s, m)
            deltas = ranking_range.decode_two_channel(gather_tables(enc, group), s, m)
            all_ids = torch.where(modes[:, None] == ranking_range.SKIP, dense_rows_t.to(all_ids.dtype), all_ids)
        elif bits >= 32:
            deltas = gather_tables(uniq_vals, group)
        else:
            s_vec = _mean_scale(q.symmetric_quantization_params(
                bits, uniq_vals.amin(dim=(1, 2)), uniq_vals.amax(dim=(1, 2))), group)[:, None, None]
            v_int = q.quantize(uniq_vals, s_vec, bits)
            if bits <= 4 and uniq_vals.shape[-1] % 2 == 0:
                all_int = _unpack_nibbles(gather_tables(_pack_nibbles(v_int), group))
            else:
                all_int = gather_tables(v_int, group)
            deltas = q.dequantize(all_int, s_vec)
        # every rank applies the N K gathered rows of each table at lr / N
        apply_table_updates(routes, "sgd", [params["emb"][k] for k in dense_ks], None, deltas,
                            all_ids[..., None], None, lr_n, plain=plain, presum=False)
        if learned_vw:  # in place, as the tables
            vw_all_ids = gather_tables(vw_ids, group)
            vw_all_vals = gather_tables(vw_vals, group)
            for d, k in enumerate(dense_ks):
                scatter_add_drop(params["v_W"][k], vw_all_ids[d], -lr_n * vw_all_vals[d])

    if steps_per_dispatch > 1:
        return repeat_step(step_fn, steps_per_dispatch)
    return step_fn


def _nest(keys: Sequence[Tuple[str, int, str]], values: Sequence[torch.Tensor]) -> Any:
    """{"bot"/"top": [{"w", "b"}]} from the (part, layer, key) of each value."""
    out = {"bot": [], "top": []}
    for (part, li, key), v in zip(keys, values):
        if li == len(out[part]):
            out[part].append({})
        out[part][li][key] = v
    return out


def _over(lr: float, n: int) -> float:
    """lr / n rounded to float32, as the JAX step computes it."""
    return float(torch.tensor(lr, dtype=torch.float32) / torch.tensor(float(n), dtype=torch.float32))


def make_dp_nosync_train_step(config: DLRMConfig, tc: TrainConfig, group=None,
                              plain: bool = False, device: Device = None,
                              backend: Optional[str] = None):
    """Local SGD with no gradient exchange (`dlrm_s_pytorch_dp_only.py`:
    1902-1905): each rank steps its own replica on its batch slice with
    dense autograd and manual SGD, and the replicas drift until
    `make_weight_sync` averages them. Returns (DPState, the loss averaged
    over the ranks). The dense step runs every model option; a bf16 table
    takes p - lr * g in float32, then rounds (JAX comm_grad.py:797-799)."""
    world_size(device, backend, group)
    local = _build_step_fn(config, tc.replace(optimizer="sgd"), plain=plain, device=device)

    def step_fn(state: DPState, batch: dlrm.Batch) -> Tuple[DPState, torch.Tensor]:
        new, loss = local(TrainState(state.params, None, state.qstate), batch)
        return DPState(new.params, new.qstate, state.ec), _mean_scale(loss, group)

    return step_fn


def make_dp_eval_step(config: DLRMConfig, group=None, plain: bool = False, device: Device = None,
                      backend: Optional[str] = None):
    """Rank-sharded evaluation (`inference_distributed`,
    dlrm_s_pytorch_comm_grad.py:1170-1305): each rank scores its batch slice
    and the probabilities are all-gathered, so every rank sees the global
    batch's [N B] scores in rank order."""
    dev = resolve_device(device)
    world_size(dev, backend, group)

    @torch.no_grad()
    def eval_fn(state, batch: dlrm.Batch) -> torch.Tensor:
        _params_device(state.params, dev)
        p = dlrm.predict(config, state.params, _on(batch, dev), state.qstate, plain=plain)
        return _gather(p, group).reshape(-1)

    return eval_fn


def make_weight_sync(group=None, device: Device = None, backend: Optional[str] = None):
    """The periodic full-weight mean (`weight_syncc`,
    dlrm_s_pytorch_comm_grad.py:1977-1991), which bounds the drift of
    replicas whose scatter-adds sum duplicates in different orders. The
    returned fn averages every parameter over the ranks in place and
    returns the state."""
    n = world_size(device, backend, group)

    @torch.no_grad()
    def sync(state):
        for t in tree_leaves(state.params):
            dist.all_reduce(t, group=group)
            t.div_(torch.full((), float(n), dtype=t.dtype, device=t.device))
        return state

    return sync
