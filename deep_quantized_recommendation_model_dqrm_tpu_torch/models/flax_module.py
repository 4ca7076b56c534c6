"""Module API: the DLRM/DQRM model as a `torch.nn.Module`.

Port of the JAX package's models/flax_module.py (its flax `linen.Module`).
The canonical definition stays functional (`models/dlrm.py`); this thin
wrapper exposes it through the API a PyTorch training loop expects
(`torch.optim` optimizers, `state_dict`, `torch.export`). The parameters
are `nn.Parameter`s in `dlrm.init_params`'s layout (`emb.0`, `emb.3.q`,
`bot.0.w`, `v_W.2`, `lsq_mlp.top.1.b`); the QAT state lives in registered
buffers (`emb_scales`, `act_min`, `act_max`), as the reference keeps it
(quant_modules.py:235-245), and its two counters (`step`, `act_fixed`) in
the module's extra state, which `state_dict` carries: they are host ints,
so the periodic scale refresh is a Python `if` that never waits for the
card.

- `DLRM(config, seed)` draws its parameters with `dlrm.init_params` (or
  takes `params=`); `DLRM.from_numpy` takes the JAX package's weights
  through `tools/jax_weights.py`;
- `forward(batch, train=True, full_precision=False)` refreshes the table
  scales and steps the counter where the JAX module's `__call__` does
  (flax_module.py:53-63), then calls `dlrm.forward`;
- `predict_proba(model, batch)` gives the clipped probabilities without
  touching the QAT state;
- `export_forward_loss(model, batch)` is `torch.export` of the model's
  forward and training loss on a batch (what the CLI's
  `--plot-compute-graph` writes): the small tables' lookup (kernel K4,
  with `onehot_lookup_max_rows`) is the registered op
  `dqrm::onehot_pooled_lookup_grouped`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm


def _tensors(tree: Any) -> bool:
    """Whether `tree` is a tensor or a dict of tensors."""
    return isinstance(tree, torch.Tensor) or (
        isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values()))


def _register(tree: Any):
    """A nest of dicts and lists of tensors as modules of `nn.Parameter`s
    that share the tensors' storage."""
    if isinstance(tree, dict):
        if _tensors(tree):
            return nn.ParameterDict(tree)
        return nn.ModuleDict({k: _register(v) for k, v in tree.items()})
    if all(_tensors(v) for v in tree):
        return nn.ParameterList([_register(v) if isinstance(v, dict) else v for v in tree])
    return nn.ModuleList([_register(v) for v in tree])


def _tree(module: nn.Module) -> Any:
    """The nest `_register` made, with the registered parameters as leaves."""
    if isinstance(module, (nn.ParameterDict, nn.ModuleDict)):
        return {k: _tree(v) for k, v in module.items()}
    if isinstance(module, (nn.ParameterList, nn.ModuleList)):
        return [_tree(v) for v in module]
    return module


class DLRM(nn.Module):
    """The DLRM/DQRM as an `nn.Module`.

    Usage:
        model = DLRM(config, seed=0, device="cuda")
        logits = model(batch)                  # train=True: QAT state moves
        loss = dlrm.bce_loss(logits, batch.labels)
        p = predict_proba(model, batch)        # no state change
    """

    def __init__(self, config: DLRMConfig, seed: int = 0, device=None,
                 params: Optional[dlrm.Params] = None, qstate: Optional[dlrm.QuantState] = None):
        super().__init__()
        self.config = config
        if params is None:
            params = dlrm.init_params(config, seed=seed, device=device)
        self._keys = tuple(k for k in ("emb", "bot", "top", "v_W", "lsq_emb", "lsq_mlp") if k in params)
        for key in self._keys:
            setattr(self, key, _register(params[key]))
        if qstate is None:
            qstate = dlrm.init_quant_state(config, params["bot"][0]["w"].device)
        self.register_buffer("emb_scales", qstate.emb_scales)
        self.register_buffer("act_min", qstate.act_min)
        self.register_buffer("act_max", qstate.act_max)
        self.step, self.act_fixed = qstate.step, qstate.act_fixed

    @classmethod
    def from_numpy(cls, config: DLRMConfig, np_params: Any, np_qstate: Any = None, device=None) -> "DLRM":
        """The module holding the JAX package's params (and `QuantState`,
        read by attribute name) as numpy arrays, bit for bit
        (`tools/jax_weights.py`)."""
        from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import jax_weights

        if np_qstate is None:
            return cls(config, params=jax_weights.params_from_numpy(np_params, device))
        state = jax_weights.train_state_from_numpy(np_params, np_qstate, device)
        return cls(config, params=state.params, qstate=state.qstate)

    def params(self) -> dlrm.Params:
        """The parameters in `dlrm.init_params`' layout (the registered
        tensors themselves)."""
        return {key: _tree(getattr(self, key)) for key in self._keys}

    def quant_state(self) -> dlrm.QuantState:
        return dlrm.QuantState(emb_scales=self.emb_scales, act_min=self.act_min, act_max=self.act_max,
                               step=self.step, act_fixed=self.act_fixed)

    def get_extra_state(self) -> dict:
        return {"step": self.step, "act_fixed": self.act_fixed}

    def set_extra_state(self, state: dict) -> None:
        self.step, self.act_fixed = int(state["step"]), int(state["act_fixed"])

    def forward(self, batch: dlrm.Batch, train: bool = True, full_precision: bool = False) -> torch.Tensor:
        """Logits [B]. With `train`, the QAT step of the JAX module: the
        table scales refreshed when the counter is at a period boundary
        (quantized configs), the activation ranges moved by the forward,
        and the counter stepped."""
        cfg = self.config
        params = self.params()
        qstate = self.quant_state()
        if cfg.quant.enabled and train:
            qstate = dlrm.update_emb_scales(cfg, params, qstate)
        logits, new_qs = dlrm.forward(cfg, params, batch, qstate, train=train, full_precision=full_precision)
        if train:
            self.emb_scales = new_qs.emb_scales.detach()
            self.act_min, self.act_max = new_qs.act_min.detach(), new_qs.act_max.detach()
            self.step = qstate.step + 1
        return logits


def predict_proba(model: DLRM, batch: dlrm.Batch) -> torch.Tensor:
    """Sigmoid probabilities, clipped by the config's `loss_threshold`,
    without moving the QAT state."""
    logits = model(batch, train=False)
    p = torch.sigmoid(logits)
    cfg = model.config
    if 0.0 < cfg.loss_threshold < 1.0:
        p = torch.clamp(p, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
    return p


class _ForwardLoss(nn.Module):
    """The model's training forward and loss at its current QAT state, as
    a function of the batch: (loss, logits)."""

    def __init__(self, model: DLRM):
        super().__init__()
        self.model = model

    def forward(self, dense, indices, labels, mask=None):
        model = self.model
        batch = dlrm.Batch(dense=dense, indices=indices, labels=labels, mask=mask)
        logits, _ = dlrm.forward(model.config, model.params(), batch, model.quant_state(), train=True)
        return dlrm.training_loss(model.config, logits, labels), logits


def export_forward_loss(model: DLRM, batch: dlrm.Batch) -> "torch.export.ExportedProgram":
    """`torch.export` of the model's forward and training loss (`bce` by
    default) on `batch`'s shapes, at the model's QAT state: the reference's
    torchviz graph of the loss (dlrm_s_pytorch.py:1797-1803). Nothing runs
    on the card while it traces; the program returns (loss, logits)."""
    args = (batch.dense, batch.indices, batch.labels) + (() if batch.mask is None else (batch.mask,))
    return torch.export.export(_ForwardLoss(model), args)
