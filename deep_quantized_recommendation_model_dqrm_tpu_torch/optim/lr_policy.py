"""Learning-rate policy: linear warmup -> hold -> quadratic decay -> freeze.

Port of the JAX package's optim/lr_policy.py (`LRPolicyScheduler`,
dlrm_s_pytorch.py:160-194). JAX evaluates it in float32 from a traced step;
a Python-double learning rate rounds differently under warmup and decay. So
this port computes it with `np.float32` arithmetic in the same order and
returns the float32 value as a Python float, which represents it exactly.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def lr_policy(
    base_lr: float,
    step: int,
    num_warmup_steps: int,
    decay_start_step: int,
    num_decay_steps: int,
) -> float:
    """The learning rate for the 1-based iteration count `step`.

    - step < warmup:            base_lr * (1 - (warmup - step)/warmup)
    - decay_start <= step < decay_end:
                                max(1e-7, base_lr * ((decay - d)/decay)^2)
    - step >= decay_end:        frozen at the final decay value
    - between warmup and decay (num_decay_steps > 0): base_lr*(1 - 1/warmup),
      the reference's `last_lr` from the final warmup step (base_lr when
      warmup == 0, a documented deviation of the JAX package)
    - num_decay_steps == 0:     base_lr after warmup
    """
    s = f32(step)
    warm = float(max(num_warmup_steps, 0))
    ds = float(decay_start_step)
    nd = float(num_decay_steps)
    lr = f32(base_lr)
    if nd > 0:
        decayed = min(max(s - f32(ds), f32(0.0)), f32(nd - 1.0))
        r = (f32(nd) - decayed) / f32(nd)
        decay_lr = max(f32(1e-7), lr * (r * r))
        # a Python-double expression in the JAX package, rounded once
        hold_lr = f32(base_lr * (1.0 - 1.0 / warm) if warm > 0 else base_lr)
        after = hold_lr if s < f32(ds) else decay_lr
    else:
        after = lr
    if warm > 0 and s < f32(warm):
        after = lr * (f32(1.0) - (f32(warm) - s) / f32(warm))
    return float(after)
