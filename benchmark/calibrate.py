"""Readings for the limits of the cells' checks, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <s1,s2,...> [--seconds 3]

For each seed, in one process: a run of the cell (set-up, a short window,
the check; `run.py` is not involved), the program's compared numbers; then
the readings of `control` in the cell's driver module (the control, and
the faults it plants in the reference), each read against the float32
reference the same way. One JSON line per seed on standard output. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

CODE_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(CODE_DIR))
sys.path.insert(1, str(CODE_DIR.parent))

import cells  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    root = CODE_DIR.parent
    cell = cells.load_cell(root, args.workload)
    device = torch.device("cuda", 0)
    drv = cells.driver(cell.traffic)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        rec = drv.run(cell, seed=seed, seconds=args.seconds, trace=False, device=device, t_start=t0,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
        line = {"workload": cell.name, "seed": seed, "program": rec["compared"], "failed": rec["failed"],
                **drv.control(cell, rec, seed, device), "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
