"""Quantized CNN classifier family: the ImageNet side-harness model.

Port of the JAX package's models/cnn.py, its stand-in for the reference's
`training_imagenet_speedup.py` (a torchvision ResNet trained under a
row-sparsified gradient all-reduce, to sanity-check compressed-gradient
training outside DLRM): a compact VGG-style stack built from the HAWQ
quant-conv ops (`ops/quant_conv.py`), per block

    QuantBnConv2d -> ReLU -> MaxPool2d

then global average pooling and a per-channel fake-quantized linear head
(QuantLinear semantics, quant_modules.py:94-188). Everything is NHWC, as
in the JAX package.

- Params are a nest {"conv": [{"w", "b", "bn_scale", "bn_bias"}, ...],
  "head": {"w", "b"}} of float32 tensors. Conv kernels are stored
  output-channel-major, [cout, kh, kw, cin], so that dim 0 is the row axis
  the top-k gradient sync selects on (`parallel/topk_grad.py`); the forward
  transposes them to [kh, kw, cin, cout].
- `init_cnn_params` and `synthetic_image_batch` draw from
  `np.random.RandomState` in the JAX package's order: both packages build
  the same bits.
- True float32 on the card: the convs run under `quant_conv.fp32_convs()`
  (cuDNN would take TF32 by default), and the head refuses to run with
  PyTorch's TF32 float32 matmuls switched on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.quant_conv import (
    conv2d_nhwc,
    max_pool2d,
    quant_bn_conv2d,
    quant_conv2d,
    quant_dropout,
)

Device = Optional[Union[str, torch.device]]


@dataclass(frozen=True)
class CNNConfig:
    """Architecture spec (the reference's `-a/--arch` and the dataset's
    geometry, training_imagenet_speedup.py:33-40)."""

    image_size: int = 32
    in_channels: int = 3
    channels: Tuple[int, ...] = (32, 64, 128)  # one conv block per entry
    num_classes: int = 10
    kernel: int = 3
    quantize: bool = True
    bits: int = 8
    batch_norm: bool = True
    dropout_rate: float = 0.0

    def __post_init__(self):
        if self.image_size % (2 ** len(self.channels)) != 0:
            raise ValueError(
                "image_size must be divisible by 2^num_blocks "
                f"({self.image_size} vs {len(self.channels)} blocks)"
            )


def init_cnn_params(cfg: CNNConfig, seed: int = 0, device: Device = None) -> Dict[str, Any]:
    """He-normal conv kernels, identity BN, a Glorot-uniform head (the
    torchvision ResNet init family the reference trains from scratch,
    training_imagenet_speedup.py:309-350 with `--pretrained` off), drawn in
    the JAX package's order."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    blocks = []
    cin = cfg.in_channels
    for cout in cfg.channels:
        fan_in = cfg.kernel * cfg.kernel * cin
        blk = {"w": t(rs.normal(0.0, (2.0 / fan_in) ** 0.5, (cout, cfg.kernel, cfg.kernel, cin))),
               "b": torch.zeros((cout,), device=dev)}
        if cfg.batch_norm:
            blk["bn_scale"] = torch.ones((cout,), device=dev)
            blk["bn_bias"] = torch.zeros((cout,), device=dev)
        blocks.append(blk)
        cin = cout
    limit = (6.0 / (cin + cfg.num_classes)) ** 0.5
    head = {"w": t(rs.uniform(-limit, limit, (cfg.num_classes, cin))),
            "b": torch.zeros((cfg.num_classes,), device=dev)}
    return {"conv": blocks, "head": head}


def require_fp32_head(device: torch.device) -> None:
    """The head's product is float32 in the JAX package: raise where
    PyTorch would run float32 matmuls on the card in TF32."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the CNN head needs true float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False and float32 matmul "
                           "precision 'highest'")


def _head_linear(cfg: CNNConfig, head: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Per-output-channel fake-quantized linear head (the QuantLinear
    per-channel branch, quant_modules.py:94-188)."""
    require_fp32_head(x.device)
    w = head["w"]  # [classes, feat]
    if cfg.quantize:
        s = q.symmetric_quantization_params(cfg.bits, w.amin(dim=1), w.amax(dim=1))
        s_b = s.detach()[:, None]
        w = q.quantize_ste(w, s_b, cfg.bits) * s_b
    return x @ w.T + head["b"]


def cnn_forward(
    cfg: CNNConfig,
    params: Dict[str, Any],
    images: torch.Tensor,  # [N, H, W, C] float32 in [0, 1]
    train: bool = False,
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits [N, num_classes]. Dropout (train, a rate above 0 and a
    generator, where JAX takes a key) draws its masks from
    `dropout_generator`."""
    x = images
    for blk in params["conv"]:
        w = blk["w"].permute(1, 2, 3, 0)  # [cout, kh, kw, cin] -> [kh, kw, cin, cout]
        if cfg.quantize and cfg.batch_norm:
            x = quant_bn_conv2d(x, w, blk["b"], blk["bn_scale"], blk["bn_bias"], cfg.bits)
        elif cfg.quantize:
            x = quant_conv2d(x, w, blk["b"], cfg.bits)
        else:
            x = conv2d_nhwc(x, w) + blk["b"]
            if cfg.batch_norm:
                x = x * blk["bn_scale"] + blk["bn_bias"]
        x = torch.relu(x)
        x = max_pool2d(x, 2, 2)
        if train and cfg.dropout_rate > 0.0 and dropout_generator is not None:
            x = quant_dropout(x, cfg.dropout_rate, dropout_generator, train)
    x = x.mean(dim=(1, 2))  # global average pool -> [N, C_last]
    return _head_linear(cfg, params["head"], x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (the reference's
    nn.CrossEntropyLoss, training_imagenet_speedup.py:535)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Top-k accuracy (training_imagenet_speedup.py:686-700); ties ranked
    by index, as JAX's stable `argsort`."""
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    return (topk == labels.long()[:, None]).any(dim=-1).float().mean()


def synthetic_image_batch(
    cfg: CNNConfig, batch: int, rs: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable class-conditional synthetic images (the stand-in for the
    ImageNet/CIFAR folders the reference loads at
    training_imagenet_speedup.py:430-470), host arrays ([N, H, W, C]
    float32, [N] int32). Each class has a fixed coarse random block template
    (image_size/4 resolution, upsampled 4x) plus pixel noise: coarse
    structure survives the conv/pool/global-average-pool stack, so a small
    CNN separates the classes within a few hundred steps."""
    templ_rs = np.random.RandomState(1234)
    cs = max(1, cfg.image_size // 4)
    coarse = templ_rs.uniform(0.0, 1.0, (cfg.num_classes, cs, cs, cfg.in_channels))
    up = cfg.image_size // cs
    templates = np.kron(coarse, np.ones((1, up, up, 1)))
    labels = rs.randint(0, cfg.num_classes, batch)
    imgs = templates[labels] + rs.normal(0.0, 0.25, (batch, cfg.image_size, cfg.image_size, cfg.in_channels))
    return imgs.astype(np.float32), labels.astype(np.int32)
