"""N simulated data-parallel workers on one device.

Port of the JAX package's parallel/pseudo.py, the reference's validation
drivers `dlrm_s_pytorch_pseudo_multigpu.py` / `pseudo_cpustb.py`: the batch
is split into N micro-batches; each micro-step quantizes its gradients into
accumulation buffers (`grad_buffer_update_added_quantization`,
sgd_quantized_gradients.py:56-156); after the N micro-steps the buffers are
dequantized and applied by manual SGD (`weights_update_added_quantization`,
:349-421).

- Embedding gradients are coalesced before scale and quantize
  (quantize_emb_grad, :539-561); each table's scale is taken at the first
  micro-step of the step and reused by the others (:78-82), and the
  integer buffer is dequantized by scale / N at apply (:368-371).
- MLP weight gradients take per-channel scales (quantize_linear_grad,
  :563-600) and biases a per-tensor scale (quantize_bias_grad, :602-641),
  both cached at the first micro-step, with error compensation whose
  residual persists across micro-steps and steps (`ec` of the state).
- Apply: w -= lr * buffer * scale / N. The tables take the routes of the
  single-device sparse step (`train_step.apply_table_updates`): one grouped
  K1 launch for the small tables, one sort and one grouped K5 launch for
  the mid tables, a scatter-add for the rest; the tables are updated in
  place.

JAX runs the N micro-steps as one `lax.scan`; here they are a Python loop.
Every QAT scheme reaches the micro-steps through the sparse step's
`sparse_grads` (PACT's table transform included); the other parameters
(LSQ's steps, fixed pooling weights) and the activation ranges pass
through unchanged, as in JAX's engine (pseudo.py:305-309).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    coalesce_sparse_grads_batched,
    rows_grads_from_pooled,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import MLP_KEYS, zero_ec
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    _check,
    _lr,
    _on,
    _params_device,
    apply_table_updates,
    batch_rows,
    make_table_routes,
    sparse_grads,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

Device = Optional[Union[str, torch.device]]


class PseudoState(NamedTuple):
    params: dlrm.Params
    qstate: dlrm.QuantState
    ec: Any  # {"bot"/"top": [{"w", "b"}]} error-compensation residuals


def pseudo_state_from(params: dlrm.Params, qstate: dlrm.QuantState) -> PseudoState:
    """Wrap existing params (a TrainState's) with zero residuals."""
    return PseudoState(params=params, qstate=qstate, ec=zero_ec(params))


def init_pseudo_state(config: DLRMConfig, tc: TrainConfig, seed: Optional[int] = None,
                      device: Device = None) -> PseudoState:
    dev = resolve_device(device)
    params = dlrm.init_params(config, seed if seed is not None else tc.seed, device=dev)
    return pseudo_state_from(params, dlrm.init_quant_state(config, dev))


def make_pseudo_train_step(config: DLRMConfig, tc: TrainConfig, num_workers: int,
                           plain: bool = False, device: Device = None):
    """The simulated N-worker step: takes (PseudoState, a Batch of B rows,
    B % num_workers == 0) and returns (new state, mean loss of the N
    micro-steps). `plain=True` takes the plain versions of K1, K4 and K5.

    Fixed pooling weights scale each occurrence's row gradient (mask *
    v_W[idx]); learned ones and QR/MD tables raise, as in JAX's engine (the
    reference's buffer algorithm updates only the tables and the MLPs, and
    expects EmbeddingBag tables). A bf16 table takes its float32 update
    rounded once per route launch on the K1 and K5 tables (JAX rounds each
    update), and per update on the scatter tables."""
    if config.weighted_pooling == "learned":
        # The buffer algorithm only updates emb/bot/top
        # (weights_update_added_quantization, sgd_quantized_gradients.py:
        # 349-421): learned pooling weights would silently never train.
        raise NotImplementedError(
            "weighted_pooling='learned' is not supported by the pseudo "
            "step; use weighted_pooling='fixed' or parallelism=none"
        )
    if dlrm.trick_slots(config):
        # the reference's grad_buffer functions expect .embedding_bag
        # tables (sgd_quantized_gradients.py:75-95)
        raise NotImplementedError(
            "QR/MD embeddings are not supported by the pseudo step "
            "(nor by the reference's); use parallelism=none"
        )
    _check(tc)
    dev = resolve_device(device)
    qc = config.quant
    gb = tc.grad_quant_bits
    n = num_workers
    routes = make_table_routes(config.table_sizes, tc)

    def step_fn(state: PseudoState, batch: dlrm.Batch) -> Tuple[PseudoState, torch.Tensor]:
        _params_device(state.params, dev)
        batch = _on(batch, dev)
        params, qstate = state.params, state.qstate
        if qc.enabled:
            qstate = dlrm.update_emb_scales(config, params, qstate)
        B = batch.labels.shape[0]
        if B % n:
            raise ValueError(f"batch of {B} does not split into {n} workers")
        mb = B // n
        mlp_params = {part: params[part] for part in ("bot", "top")}
        buf = tree_map(torch.zeros_like, mlp_params)
        scales = tree_map(lambda _: None, mlp_params)
        ec = tree_map(lambda t: t, state.ec)  # a new nest: the entries are replaced, not mutated
        emb_scale = None
        losses, emb_ids, emb_vals = [], [], []
        for i in range(n):
            micro = batch_rows(batch, i * mb, (i + 1) * mb)
            loss, _, grads, g_pooled = sparse_grads(config, params, qstate, micro, plain)
            losses.append(loss.detach())
            with torch.no_grad():
                for part in ("bot", "top"):
                    for li, g_layer in enumerate(grads[part]):
                        for key in MLP_KEYS:
                            g = g_layer[key]
                            if gb >= 32:  # the unquantized buffer: g / N, no residual
                                buf[part][li][key] = buf[part][li][key] + g / n
                                continue
                            g_eff = g + ec[part][li][key]
                            if i == 0:
                                scales[part][li][key] = (
                                    q.symmetric_quantization_params(gb, g_eff.amin(dim=1), g_eff.amax(dim=1))
                                    if key == "w" else
                                    q.symmetric_quantization_params(gb, g_eff.min(), g_eff.max()))
                            sc = scales[part][li][key]
                            qv = q.quantize_ste(g_eff, sc, gb)
                            ec[part][li][key] = g_eff - qv * (sc.reshape(-1, 1) if key == "w" else sc)
                            buf[part][li][key] = buf[part][li][key] + qv

                # embeddings: coalesce every table's rows in one pass, the
                # scale of each table from the first micro-step, quantize
                weights = dlrm.pooling_weights(config, params.get("v_W"), micro.indices, micro.mask)
                ids, vals = rows_grads_from_pooled(g_pooled, micro.indices, weights)
                uids, uvals = coalesce_sparse_grads_batched(ids, vals, config.table_sizes, ids.shape[1])
                if gb < 32:
                    if i == 0:
                        emb_scale = q.symmetric_quantization_params(
                            gb, uvals.amin(dim=(1, 2)), uvals.amax(dim=(1, 2)))[:, None, None]
                    uvals = q.quantize_ste(uvals, emb_scale, gb)
                emb_ids.append(uids)
                emb_vals.append(uvals)

        lr = _lr(tc, qstate.step + 1)
        with torch.no_grad():
            def apply(p, b_, s):
                if gb < 32:
                    return p - lr * (b_ * ((s.reshape(-1, 1) if s.dim() else s) / n))
                return p - lr * b_  # already / N at accumulate

            new_mlp = {part: [{key: apply(l[key], bl[key], sl[key]) for key in MLP_KEYS}
                              for l, bl, sl in zip(params[part], buf[part], scales[part])]
                       for part in ("bot", "top")}
            # the N workers' rows of each table, worker-major: [T, N mb P, D]
            ids = torch.stack(emb_ids, dim=1).reshape(config.num_tables, -1)
            vals = torch.stack(emb_vals, dim=1).reshape(config.num_tables, ids.shape[1], -1)
            vals = vals * (emb_scale / n) if gb < 32 else vals / n
            apply_table_updates(routes, "sgd", params["emb"], None, vals, ids[..., None], None, lr,
                                plain=plain, presum=False)
        new_params = dict(params, **new_mlp)
        return PseudoState(new_params, qstate._replace(step=qstate.step + 1), ec), torch.stack(losses).mean()

    return step_fn
