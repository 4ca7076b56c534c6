"""Serving: post-training quantization export + packed inference engine.

Port of the JAX package's serving.py for plain embedding tables:

- `ptq_export` packs trained float32 params into a `ServingModel`: tables
  bit-packed to INT4/INT8 (symmetric per-table, or rowwise ATen-style),
  MLP weights INT8 per output channel (or kept float32);
- `make_serving_fn` builds the inference function over the packed model:
  one grouped gather-dequant-pool launch for the packed tables (kernel K2),
  or for tables with at most `onehot_lookup_max_rows` rows, unpacked once,
  one grouped launch of kernel K4, int8 dequant matmuls with the
  ReLU fused (kernel K3), dot or cat interaction, sigmoid,
  `loss_threshold` clip;
- `ServingEngine` pads requests on the host to the nearest bucket size and
  chunks large ones; `MicroBatcher` aggregates concurrent requests from many
  threads into one device batch per dispatch.

The QR/MD/weighted-pooling entries, `mlp_impl="int8"`,
`ptq_export_streaming` and `export_stablehlo` wait for later slices of the
port.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    group_slots,
    make_onehot_lookup_group,
    onehot_pooled_lookup_grouped_fwd,
    onehot_pooled_lookup_grouped_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
    PackedTable,
    make_packed_group,
    pack_table,
    packed_pooled_lookup_grouped,
    packed_pooled_lookup_grouped_plain,
    unpack_table,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
    QuantLinearWeights,
    int8_linear,
    int8_linear_xla,
    quantize_linear_weights,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import (
    cat_interaction,
    dot_interaction,
)


class ServingModel(NamedTuple):
    config: DLRMConfig
    emb: List[PackedTable]
    bot: List  # QuantLinearWeights or fp32 {"w","b"} dicts
    top: List
    mlp_bits: int  # 32 = fp32 MLP


def ptq_export(
    config: DLRMConfig,
    params: dlrm.Params,
    emb_bits: int = 4,
    mlp_bits: int = 8,
    rowwise: bool = False,
) -> ServingModel:
    """Pack a trained model for serving (quantize_dynamic +
    quantize_embedding, dlrm_s_pytorch.py:1446-1471). emb_bits in {4, 8},
    mlp_bits in {8, 32}. The model stays on the params' device."""
    if emb_bits not in (4, 8):
        raise ValueError("emb_bits must be 4 or 8 for packed serving")
    if mlp_bits not in (8, 32):
        raise ValueError("mlp_bits must be 8 or 32")
    if config.weighted_pooling is not None or any(isinstance(t, dict) for t in params["emb"]):
        raise NotImplementedError(
            "QR/MD tables and weighted pooling in serving: a later slice of the port"
        )
    emb = [pack_table(t, bits=emb_bits, rowwise=rowwise) for t in params["emb"]]
    if mlp_bits == 8:
        bot = [quantize_linear_weights(l["w"], l["b"], 8) for l in params["bot"]]
        top = [quantize_linear_weights(l["w"], l["b"], 8) for l in params["top"]]
    else:
        bot, top = params["bot"], params["top"]
    return ServingModel(config=config, emb=emb, bot=bot, top=top, mlp_bits=mlp_bits)


def serving_model_bytes(sm: ServingModel) -> int:
    """Model size in bytes (the paper's 8x compression measurement,
    Table 3)."""
    n = sum(e.nbytes() for e in sm.emb)
    for layers in (sm.bot, sm.top):
        for l in layers:
            if isinstance(l, QuantLinearWeights):
                n += l.w_int.numel() + l.scale.numel() * 4 + l.bias.numel() * 4
            else:
                n += (l["w"].numel() + l["b"].numel()) * 4
    return n


def _apply_mlp_serving(layers, x, mlp_bits: int, last_linear: bool, linear8) -> torch.Tensor:
    nl = len(layers)
    for i, l in enumerate(layers):
        relu = not (last_linear and i == nl - 1)
        if mlp_bits == 8:
            x = linear8(x, l, relu=relu)  # ReLU fused into the kernel's epilogue
        else:
            x = x @ l["w"].T + l["b"]
            if relu:
                x = torch.relu(x)
    return x


def make_serving_fn(
    sm: ServingModel,
    mlp_impl: Optional[str] = None,
    onehot_lookup_max_rows: int = 0,
    fused_gather: bool = False,
    plain: bool = False,
) -> Callable[[dlrm.Batch], torch.Tensor]:
    """Inference function: Batch -> click probabilities [B] (float32, on the
    batch's device).

    The lookups of all packed tables go through one
    `packed_pooled_lookup_grouped` call, whose descriptor array is built
    here, once, and the int8 layers through `int8_linear`: kernels on the
    card, their plain versions on the CPU. The packed tables with at most
    `onehot_lookup_max_rows` rows are instead unpacked here, once, and kept
    beside the packed model (the 18 such Kaggle tables hold 47,398 rows:
    3,033,472 bytes of float32 at D = 16; `serving_model_bytes` stays the
    export's size), and one `onehot_pooled_lookup_grouped_fwd` launch
    (kernel K4) looks them up into their slots of the same output.
    `fused_gather=True` is accepted for the JAX package's signature:
    that package's one gather for all tables gives the per-table results,
    and here every lookup is one grouped launch already. `plain=True` calls
    the plain versions on any device — the reference the kernels are checked
    against on the card."""
    if mlp_impl == "int8":
        raise NotImplementedError(
            "mlp_impl='int8' (dynamic activation quant + int8 GEMM): a later slice of the port"
        )
    if mlp_impl is not None:
        raise ValueError(f"unknown mlp_impl {mlp_impl!r}")
    del fused_gather  # the grouped lookup below is the fused path
    cfg = sm.config
    grouped = packed_pooled_lookup_grouped_plain if plain else packed_pooled_lookup_grouped
    onehot = onehot_pooled_lookup_grouped_plain if plain else onehot_pooled_lookup_grouped_fwd
    linear8 = int8_linear_xla if plain else int8_linear
    small = [k for k, pt in enumerate(sm.emb) if 0 < pt.rows <= onehot_lookup_max_rows]
    big = [k for k in range(len(sm.emb)) if k not in small]
    group = make_packed_group([sm.emb[k] for k in big], big) if big else None
    onehot_groups = [make_onehot_lookup_group([unpack_table(sm.emb[k]) for k in ks], ks)
                     for ks in group_slots(small)]

    @torch.inference_mode()
    def fn(batch: dlrm.Batch) -> torch.Tensor:
        # [T, B, D]: the K2 group and the K4 groups write its slots between them
        T, B, _ = batch.indices.shape
        ly = torch.empty((T, B, cfg.embedding_dim), device=batch.indices.device)
        if group is not None:
            grouped(group, batch.indices, batch.mask, out=ly)
        for og in onehot_groups:
            onehot(og, batch.indices, batch.mask, out=ly)
        x = _apply_mlp_serving(sm.bot, batch.dense, sm.mlp_bits, False, linear8)
        z = (
            dot_interaction(x, ly, cfg.interact_itself)
            if cfg.interaction == "dot"
            else cat_interaction(x, ly)
        )
        logits = _apply_mlp_serving(sm.top, z, sm.mlp_bits, True, linear8)
        p = torch.sigmoid(logits.reshape(-1))
        if 0.0 < cfg.loss_threshold < 1.0:
            p = torch.clamp(p, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
        return p

    return fn


class ServingEngine:
    """Bucketed-batch inference host loop.

    Pads request batches up to the nearest bucket so the device sees a few
    fixed shapes, chunks requests larger than the biggest bucket, and slices
    the padding off. `batches` counts the device batches dispatched.
    """

    def __init__(
        self,
        sm: ServingModel,
        buckets: Sequence[int] = (128, 1024, 4096, 16384),
        mlp_impl: Optional[str] = None,
        onehot_lookup_max_rows: int = 0,
        plain: bool = False,
    ):
        self.sm = sm
        self.buckets = sorted(buckets)
        self.device = sm.emb[0].data.device
        self.fn = make_serving_fn(
            sm, mlp_impl=mlp_impl, onehot_lookup_max_rows=onehot_lookup_max_rows,
            plain=plain,
        )
        self.batches = 0
        self._count_lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, dense: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """dense [B,13] f32 (already log1p), indices [T,B,P] int32."""
        B = dense.shape[0]
        out = np.empty(B, np.float32)
        pos = 0
        while pos < B:
            chunk = min(B - pos, self.buckets[-1])
            nb = self._bucket(chunk)
            d = np.zeros((nb, dense.shape[1]), np.float32)
            d[:chunk] = dense[pos : pos + chunk]
            ix = np.zeros((indices.shape[0], nb, indices.shape[2]), np.int32)
            ix[:, :chunk] = indices[:, pos : pos + chunk]
            batch = dlrm.Batch(
                dense=torch.from_numpy(d).to(self.device),
                indices=torch.from_numpy(ix).to(self.device),
                labels=torch.zeros((nb,), dtype=torch.float32, device=self.device),
                mask=None,
            )
            out[pos : pos + chunk] = self.fn(batch).cpu().numpy()[:chunk]
            with self._count_lock:
                self.batches += 1
            pos += chunk
        return out


class MicroBatcher:
    """Continuous-batching front end over a ServingEngine.

    Concurrent `predict` calls (single requests or small batches from many
    client threads) are aggregated by a background worker into one device
    batch per dispatch — up to `max_batch` rows or `max_wait_ms` after the
    first queued request, whichever comes first — then split back to the
    callers.
    """

    def __init__(self, engine: ServingEngine, max_batch: int = 16384,
                 max_wait_ms: float = 1.0):
        self.engine = engine
        self.max_batch = min(max_batch, engine.buckets[-1])
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, dense: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """Thread-safe; blocks until this request's slice is ready.

        dense [B,13] f32 (already log1p), indices [T,B,P] int32.
        """
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        done = threading.Event()
        item = {"dense": dense, "indices": indices, "done": done}
        self._q.put(item)
        done.wait()
        if "error" in item:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._worker.join()

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            rows = first["dense"].shape[0]
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(group)
                    return
                group.append(nxt)
                rows += nxt["dense"].shape[0]
            self._flush(group)

    def _flush(self, group) -> None:
        try:
            dense = np.concatenate([g["dense"] for g in group], axis=0)
            indices = np.concatenate([g["indices"] for g in group], axis=1)
            probs = self.engine.predict(dense, indices)
            pos = 0
            for g in group:
                n = g["dense"].shape[0]
                g["result"] = probs[pos : pos + n]
                pos += n
        except Exception as e:  # surface errors to every blocked caller
            for g in group:
                g["error"] = e
        finally:
            for g in group:
                g["done"].set()
