"""Import a reference PyTorch checkpoint into the port.

Port of the JAX package's tools/torch_import.py. The reference saves
`torch.save(model_metrics_dict)` where `model_metrics_dict["state_dict"]`
is the DLRM_Net state dict (dlrm_s_pytorch.py:863-869, :1684-1704;
comm_grad.py:1370-1382). A user migrating from the reference points this
tool at that .pt file and gets a checkpoint loadable by `train.py
--load-model` of either package (the npz format of utils/checkpoint.py),
with weights bit-identical to the torch tensors.

Key mapping (reference module tree -> the params' layout):
  emb_l.{k}.weight                      -> params["emb"][k]   (FP32 model)
  emb_l.{k}.embedding_bag.weight        -> params["emb"][k]   (QAT variants)
  emb_l.{k}.weight_q / .weight_r        -> params["emb"][k]["q" / "r"]    (QR)
  emb_l.{k}.embs.weight / .proj.weight  -> params["emb"][k]["table" / "proj"] (MD)
  {bot,top}_l.{i}.weight / .bias        -> params["bot"/"top"][j]["w"/"b"]
      (i counts ModuleList slots incl. activation modules, which carry no
       parameters; j is the dense-layer order, recovered by sorting i)
  v_W_l.{k}                             -> params["v_W"][k]   (learned pooling)

QAT buffers (eb_scaling_factor etc.) are NOT imported: the QuantState
recomputes table scales from the (identical) weights on the first step
(models/dlrm.update_emb_scales), which the reference itself does after
load (quant_modules_not_quantize_grad.py:331-344).

The tool moves bytes between two files and computes nothing, so it works
on the host: the checkpoint is written from CPU tensors, and the state it
fills is an undrawn template (`init_train_state(draw=False)`), every
parameter of which the import replaces.

CLI:
  python -m deep_quantized_recommendation_model_dqrm_tpu_torch.tools.torch_import \
      reference_ckpt.pt out.npz [--quantized] [--optimizer sgd] [--unsafe-load] \
      [--qr-operation mult]
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, Tuple

import numpy as np

_EMB_RE = re.compile(r"^emb_l\.(\d+)\.(?:embedding_bag\.)?weight$")
# QR / MD compositional tables (the upstream DLRM script only: QREmbeddingBag owns
# weight_q/weight_r, PrEmbeddingBag owns embs.weight + optional proj.weight
# — tricks/qr_embedding_bag.py:140-149, md_embedding_bag.py:63-75)
_QR_RE = re.compile(r"^emb_l\.(\d+)\.weight_(q|r)$")
_MD_RE = re.compile(r"^emb_l\.(\d+)\.(embs|proj)\.weight$")
_MLP_RE = re.compile(r"^(bot|top)_l\.(\d+)\.(weight|bias)$")
_VW_RE = re.compile(r"^v_W_l\.(\d+)$")


def _to_np(val) -> np.ndarray:
    if hasattr(val, "detach"):  # torch tensor (dense)
        return val.detach().cpu().numpy()
    return np.asarray(val)


def params_from_torch_state_dict(
    sd: Dict[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference DLRM_Net state dict to the params' layout, as
    float32 numpy arrays.

    Accepts torch tensors or numpy arrays as values. Returns (params,
    arch) where arch = {"table_sizes", "embedding_dim", "mlp_bot",
    "mlp_top", "weighted_pooling", "table_kinds"} (and for QR tables
    "qr_collisions" and "qr_operation") inferred from the shapes — enough
    to build the matching DLRMConfig.
    """
    emb: Dict[int, Any] = {}
    mlp: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {"bot": {}, "top": {}}
    v_w: Dict[int, np.ndarray] = {}
    for key, val in sd.items():
        m = _EMB_RE.match(key)
        if m:
            emb[int(m.group(1))] = _to_np(val).astype(np.float32)
            continue
        m = _QR_RE.match(key)
        if m:
            emb.setdefault(int(m.group(1)), {})[m.group(2)] = _to_np(val).astype(np.float32)
            continue
        m = _MD_RE.match(key)
        if m:
            name = "table" if m.group(2) == "embs" else "proj"
            emb.setdefault(int(m.group(1)), {})[name] = _to_np(val).astype(np.float32)
            continue
        m = _MLP_RE.match(key)
        if m:
            part, idx, kind = m.group(1), int(m.group(2)), m.group(3)
            mlp[part].setdefault(idx, {})["w" if kind == "weight" else "b"] = _to_np(val).astype(np.float32)
            continue
        m = _VW_RE.match(key)
        if m:
            v_w[int(m.group(1))] = _to_np(val).astype(np.float32)
        # everything else: QAT buffers (incl. sparse grad buffers) / quant
        # integers / opt state — skipped, never converted

    if not emb or not mlp["bot"] or not mlp["top"]:
        raise ValueError(
            "state dict does not look like a reference DLRM_Net "
            f"(found {len(emb)} tables, {len(mlp['bot'])} bot, "
            f"{len(mlp['top'])} top layers)"
        )

    params: Dict[str, Any] = {
        "emb": [emb[k] for k in sorted(emb)],
        "bot": [mlp["bot"][i] for i in sorted(mlp["bot"])],
        "top": [mlp["top"][i] for i in sorted(mlp["top"])],
    }
    for part in ("bot", "top"):
        for j, layer in enumerate(params[part]):
            if "w" not in layer or "b" not in layer:
                raise ValueError(f"{part} layer {j} missing weight or bias")
    if v_w:
        params["v_W"] = [v_w[k] for k in sorted(v_w)]

    bot, top = params["bot"], params["top"]

    def _rows(t) -> int:
        if isinstance(t, dict):
            if "q" in t:
                # QREmbeddingBag stores ceil(n/c) x c; n itself is not
                # recoverable — report the upper bound num_q*c (indices
                # stay valid; only affects init bounds, which imports
                # overwrite anyway)
                return int(t["q"].shape[0]) * int(t["r"].shape[0])
            return int(t["table"].shape[0])
        return int(t.shape[0])

    kinds = tuple(
        ("qr" if "q" in t else "md") if isinstance(t, dict) else "dense"
        for t in params["emb"]
    )
    dense_dims = [int(t.shape[1]) for t in params["emb"] if not isinstance(t, dict)]
    arch = {
        "table_sizes": tuple(_rows(t) for t in params["emb"]),
        "embedding_dim": dense_dims[0] if dense_dims else int(bot[-1]["w"].shape[0]),
        "mlp_bot": tuple([int(bot[0]["w"].shape[1])] + [int(l["w"].shape[0]) for l in bot]),
        "mlp_top": tuple([int(top[0]["w"].shape[1])] + [int(l["w"].shape[0]) for l in top]),
        "weighted_pooling": "learned" if v_w else None,
        "table_kinds": kinds,
    }
    if "qr" in kinds:
        qr0 = next(t for t in params["emb"] if isinstance(t, dict) and "q" in t)
        arch["qr_collisions"] = int(qr0["r"].shape[0])
        # "concat" is shape-inferable (split dim); "mult" vs "add" is NOT —
        # both store [.,D]+[.,D]. Callers must pass the trained operation
        # (import_torch_checkpoint's qr_operation / the CLI --qr-operation);
        # the inference is recorded for the arch report.
        d_q = int(qr0["q"].shape[1])
        arch["qr_operation"] = "concat" if d_q != arch["embedding_dim"] else "mult-or-add"
    return params, arch


def import_torch_checkpoint(
    pt_path: str,
    out_path: str,
    quantized: bool = False,
    optimizer: str = "sgd",
    unsafe_load: bool = False,
    qr_operation: str = "mult",
) -> Dict[str, Any]:
    """Read a reference .pt checkpoint and write the npz checkpoint.

    Returns the inferred arch dict. The output loads via
    `train.py --load-model` with a config matching the inferred arch.
    """
    import torch

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import (
        DLRMConfig,
        QuantConfig,
        TrainConfig,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import (
        adagrad_init,
        rwsadagrad_init,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import save_checkpoint
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    if unsafe_load:
        # QAT checkpoints register a sparse-COO grad buffer
        # (quant_modules.py:254) that the weights_only unpickler may
        # reject; --unsafe-load runs the full unpickler, which executes
        # pickled code — only use on checkpoints you produced yourself.
        blob = torch.load(pt_path, map_location="cpu", weights_only=False)
    else:
        try:
            blob = torch.load(pt_path, map_location="cpu", weights_only=True)
        except Exception as e:
            raise RuntimeError(
                f"safe (weights_only) load of {pt_path!r} failed: {e}\n"
                "If this checkpoint is your own and contains non-tensor "
                "objects (e.g. the reference QAT sparse grad buffers), "
                "re-run with --unsafe-load."
            ) from e
    sd = blob["state_dict"] if isinstance(blob, dict) and "state_dict" in blob else blob
    params, arch = params_from_torch_state_dict(sd)

    kinds = arch["table_kinds"]
    trick_sizes = [n for n, k in zip(arch["table_sizes"], kinds) if k != "dense"]
    cfg_kw = {}
    if "qr" in kinds:
        if arch["qr_operation"] == "concat" and qr_operation != "concat":
            qr_operation = "concat"  # shape-proven
        elif arch["qr_operation"] == "mult-or-add" and qr_operation == "concat":
            raise ValueError(
                "checkpoint's QR tables are not concat-shaped but "
                "--qr-operation=concat was given"
            )
        arch["qr_operation"] = qr_operation
        cfg_kw = {
            "qr_flag": True,
            "qr_collisions": arch["qr_collisions"],
            "qr_threshold": min(trick_sizes) - 1,
            "qr_operation": qr_operation,
        }
    elif "md" in kinds:
        cfg_kw = {"md_flag": True, "md_threshold": min(trick_sizes) - 1}
    cfg = DLRMConfig(
        table_sizes=arch["table_sizes"],
        embedding_dim=arch["embedding_dim"],
        mlp_bot=arch["mlp_bot"],
        mlp_top=arch["mlp_top"],
        weighted_pooling=arch["weighted_pooling"],
        quant=QuantConfig(enabled=quantized),
        **cfg_kw,
    )
    tc = TrainConfig(batch_size=1, optimizer=optimizer)
    state = init_train_state(cfg, tc, device="cpu", draw=False)
    new_params = dict(state.params)
    new_params.update(tree_map(torch.from_numpy, params))
    if state.opt_state is not None:
        # accumulator shapes must follow the IMPORTED tables (QR/MD entry
        # shapes are not inferable from the config alone)
        init_opt = adagrad_init if optimizer == "adagrad" else rwsadagrad_init
        state = state._replace(opt_state=init_opt(new_params))
    state = state._replace(params=new_params)

    meta = {
        "imported_from": pt_path,
        "epoch": int(blob.get("epoch", 0)) if isinstance(blob, dict) else 0,
        "iter": int(blob.get("iter", 0)) if isinstance(blob, dict) else 0,
        "step": 0,
    }
    save_checkpoint(out_path, state, meta)
    return arch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pt_path", help="reference torch.save checkpoint (.pt)")
    p.add_argument("out_path", help="output .npz checkpoint")
    p.add_argument("--quantized", action="store_true",
                   help="build the state for a QAT config (quant enabled)")
    p.add_argument("--optimizer", default="sgd",
                   choices=("sgd", "adagrad", "rwsadagrad"))
    p.add_argument("--unsafe-load", action="store_true",
                   help="allow the full (code-executing) torch unpickler; "
                        "needed for QAT checkpoints with sparse buffers — "
                        "only for checkpoints you produced yourself")
    p.add_argument("--qr-operation", default="mult",
                   choices=("mult", "add", "concat"),
                   help="the QR composition the checkpoint was trained "
                        "with — mult and add are indistinguishable by "
                        "shape, so pass the one you used (concat is "
                        "auto-detected)")
    args = p.parse_args(argv)
    arch = import_torch_checkpoint(
        args.pt_path, args.out_path,
        quantized=args.quantized, optimizer=args.optimizer,
        unsafe_load=args.unsafe_load, qr_operation=args.qr_operation,
    )
    print(f"imported {args.pt_path} -> {args.out_path}")
    print(f"arch: {arch}")


if __name__ == "__main__":
    main()
