"""The model's weights, drawn on the device from the run's seed.

Each leaf has a generator of its own, seeded from (seed, leaf name), so any
leaf can be drawn again alone, bit for bit: the reference and the check
draw the starting weights again instead of keeping a copy. The
distributions are the reference's `create_emb` and `create_mlp`
(dlrm_s_pytorch.py:199-276), as the configuration file states them:

- table k of n rows: U(-1/sqrt(n), 1/sqrt(n)), [n, d] float32;
- an MLP layer of fan_in n and fan_out m: W ~ N(0, sqrt(2 / (m + n)))
  [m, n], b ~ N(0, sqrt(1 / m)) [m], float32.

The result has the program's layout: {"emb": [tables], "bot": [{"w", "b"}],
"top": [{"w", "b"}]}.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one leaf of one run."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, name))
    return g


def table(model: dict, seed: int, k: int, device: torch.device) -> torch.Tensor:
    """Table k, drawn into its own storage in one call."""
    n, d = model["table_sizes"][k], model["embedding_dim"]
    bound = 1.0 / math.sqrt(n)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    return out.uniform_(-bound, bound, generator=generator(seed, f"emb{k}", device))


def mlp(model: dict, seed: int, part: str, device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """The layers of `part` ("bot" or "top")."""
    widths = model["mlp_" + part]
    layers = []
    for i, (n, m) in enumerate(zip(widths[:-1], widths[1:])):
        w = torch.empty((m, n), dtype=torch.float32, device=device)
        w.normal_(0.0, math.sqrt(2.0 / (m + n)), generator=generator(seed, f"{part}{i}.w", device))
        b = torch.empty((m,), dtype=torch.float32, device=device)
        b.normal_(0.0, math.sqrt(1.0 / m), generator=generator(seed, f"{part}{i}.b", device))
        layers.append({"w": w, "b": b})
    return layers


def params(model: dict, seed: int, device: torch.device) -> dict:
    return {
        "emb": [table(model, seed, k, device) for k in range(len(model["table_sizes"]))],
        "bot": mlp(model, seed, "bot", device),
        "top": mlp(model, seed, "top", device),
    }
