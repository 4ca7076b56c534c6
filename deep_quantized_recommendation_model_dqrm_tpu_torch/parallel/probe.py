"""The process group's collective self-test, run once at start-up.

Counterpart of the JAX package's parallel/probe.py (the reference's
all-to-all dry run at process-group init, extend_distributed.py:168-182):
a tiny checked pass of each collective the engines use, so a broken group
fails at once instead of hanging mid-training. Nothing falls back: a
collective the backend does not offer reports False.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device


def probe_collectives(group=None, device: Optional[Union[str, torch.device]] = None) -> Dict[str, bool]:
    """Run and check all_reduce ("psum"), all_gather, broadcast, all_to_all
    and a ring send/receive ("ppermute") on `group` (the default group when
    None) with tensors on `device` (the card unless the caller says "cpu").
    Returns one flag per collective and "ok", their conjunction; raises
    nothing for a collective that fails."""
    dev = resolve_device(device)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    mine = torch.arange(4, dtype=torch.float32, device=dev) + 4 * r
    table = torch.arange(n * 4, dtype=torch.float32, device=dev).reshape(n, 4)
    results = {}

    def check(name, fn):
        try:
            results[name] = bool(fn())
        except (RuntimeError, ValueError):  # the backend does not offer it
            results[name] = False

    def psum():
        x = mine.sum().reshape(1).clone()
        dist.all_reduce(x, group=group)
        return x.item() == float(table.sum())

    def all_gather():
        out = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(out, mine, group=group)
        return torch.equal(torch.stack(out), table)

    def broadcast():
        x = mine.clone()
        dist.broadcast(x, src=dist.get_global_rank(group, 0) if group is not None else 0, group=group)
        return torch.equal(x, table[0])

    def all_to_all():
        out = torch.empty(n, dtype=torch.float32, device=dev)
        dist.all_to_all_single(out, torch.full((n,), float(r), device=dev), group=group)
        return torch.equal(out, torch.arange(n, dtype=torch.float32, device=dev))

    def ppermute():
        if n == 1:
            return True
        out = torch.empty_like(mine)
        ops = [dist.P2POp(dist.isend, mine, (r + 1) % n, group),
               dist.P2POp(dist.irecv, out, (r - 1) % n, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(out, table[(r - 1) % n])

    for name, fn in (("psum", psum), ("all_gather", all_gather), ("broadcast", broadcast),
                     ("all_to_all", all_to_all), ("ppermute", ppermute)):
        check(name, fn)
    results["ok"] = all(results.values())
    return results
