"""Readings for the limits of the cells' checks, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <s1,s2,...> [--seconds 3]

For each seed, in one process: a run of the cell (set-up, a short window,
the check; `run.py` is not involved), the program's compared numbers; then
the control, the reference computed with TF32 operands in the program's
place, read against the float32 reference the same way; for training
cells also the planted fault of half of each batch left out, in the
reference. One JSON line per seed on standard output. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

CODE_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(CODE_DIR))
sys.path.insert(1, str(CODE_DIR.parent))

import cells  # noqa: E402
import drive_train  # noqa: E402
import reference  # noqa: E402
import weights  # noqa: E402


def control_readings(cell, rec: dict, seed: int, device) -> dict:
    model = cell.config["model"]
    table = lambda k: weights.table(model, seed, k, device)  # noqa: E731
    mlp = {p: weights.mlp(model, seed, p, device) for p in ("bot", "top")}
    if rec["entry"] == "train":
        want = rec["check"]["reference"]
        out = {}
        for name, kw in (("control_tf32", {"precision": "tf32"}), ("fault_half_batch", {"half_batch": True})):
            got = reference.train(model, cell.config["quant"], cell.config["train"]["learning_rate"], table, mlp,
                                  rec["check"]["batches"], **kw)
            out[name] = {"loss_gap": drive_train.loss_gap(got["losses"], want["losses"]),
                         "change_gap": drive_train.change_gap(got["change"], want["change"])}
        return out
    got = reference.serve(model, cell.config["serve"], table, mlp, rec["check"]["dense"], rec["check"]["ids"],
                          precision="tf32").cpu().numpy()
    return {"control_tf32": {"prob_gap": float(np.abs(got.astype(np.float64) - rec["check"]["reference"]).max())}}


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
                **control_readings(cell, rec, seed, device), "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
