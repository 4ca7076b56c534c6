"""The process group of the data-parallel engines, and each rank's batch
slice.

Counterpart of the JAX package's parallel/multihost.py. There,
`jax.distributed.initialize` joins the hosts and a device mesh spans them;
here `torch.distributed.init_process_group` joins one process per card
(torchrun's layout), and the engines' collectives run on that group:

- NCCL on the card. Gloo only where the caller asks for the CPU, or names
  it itself; `init_distributed` never picks gloo for the card.
- The rank, world size and rendezvous come from the arguments (the CLI's
  `--coordinator-address`, `--num-processes`, `--process-id`), else from
  torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR`, `MASTER_PORT`). With neither, a single-rank group in this
  process, as JAX's single-host call is a no-op that leaves one process.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

# torch.distributed.nn.functional binds `group.WORLD` as a default argument
# when it is first imported (torch.distributed.checkpoint imports it). Imported
# after the default group exists, it keeps that group alive past
# `destroy_process_group`: a gloo group's worker threads then outlive the
# interpreter, and one still releasing a collective's tensors at exit aborts
# the process ("terminate called without an active exception"). Imported
# here, before any group exists, it binds None.
import torch.distributed.nn  # noqa: F401  (isort: skip)

from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device

Device = Optional[Union[str, torch.device]]
# a rank that waits longer than this for the others (one failed before a
# collective) raises instead of hanging
DEFAULT_TIMEOUT_S = 60.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Device = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Create the default process group; returns (rank, world size).

    `device` is where the engine's tensors live (the card unless the
    caller says "cpu"): NCCL for the card, gloo for the CPU, unless
    `backend` names one. `coordinator_address` is "host:port" of rank 0
    (or a full init-method URL such as "file:///path"). On the card the
    rank's device is `LOCAL_RANK` (else the rank modulo the card count).
    `timeout_s` bounds the rendezvous and every collective. A group that
    already exists is kept when its backend is the one asked for."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"a {have} process group exists; this run needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    world = num_processes or _env_int("WORLD_SIZE") or 1
    rank = process_id if process_id is not None else (_env_int("RANK") or 0)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    timeout = timedelta(seconds=timeout_s)
    if dev.type == "cuda" and backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    if world == 1 and not coordinator_address:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
        return 0, 1
    if coordinator_address:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    else:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(f"a world of {world} needs --coordinator-address or "
                             "MASTER_ADDR and MASTER_PORT")
        url = f"tcp://{addr}:{port}"
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=timeout)
    return rank, world


def shutdown() -> None:
    """Destroy the default process group, if there is one, so that no
    process waits on it at exit."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def staged(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x`, or its host copy where the group runs gloo and `x` lies on the
    card. The mega-table engines hand gloo host tensors for their
    all-to-all, reduce-scatter and MIN/MAX all-reduce and copy the results
    back: the same collective on the same values, staged through the host
    explicitly (chip_smoke's two gloo ranks on one card)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows of a global batch: rank r of N
    takes rows [r B/N, (r+1) B/N), the contiguous block JAX's batch
    sharding gives device r (comm_grad.py:1904-1910 of the reference)."""
    rank, n = world()
    per = global_batch // n
    return rank * per, per
