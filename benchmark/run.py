"""Run one cell of the benchmark once, in this process, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The run loads the cell's files (`cells.py`), sets up, warms up,
measures for `--seconds`, checks what the timed path produced against the
plain reference (`reference.py`), and prints, as its last line on standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics, each
read by `metrics/<name>.py`), `device`, with `--trace 1` `breakdown`, and
last `compared`: each number the check compared with its limit. The same
numbers end standard error.

It exits with another code than 0, and prints no result, where no card or
too few cards are visible, and where JAX or the JAX package is loaded when
the window has closed. Compile caches go to fixed directories inside the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CODE_DIR = Path(__file__).resolve().parent
ROOT = CODE_DIR.parent
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(cell, record: dict, trace: bool) -> dict:
    import cells

    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell, compared: dict) -> dict:
    """Each compared number beside its limit in `limits/<cell>.json`; a
    number without a limit is an error."""
    out = {}
    for name, value in compared.items():
        limit = cell.limits.get(name)
        if limit is None:
            raise KeyError(f"no limit for {name!r} in limits/{cell.name}.json")
        out[name] = {"value": value, "limit": limit}
    return out


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """One run; `device` given (a test) skips the look for a card."""
    args = parse(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CODE_DIR / ".cache" / sub)
    for i, p in enumerate((str(CODE_DIR), str(root))):
        if p not in sys.path:
            sys.path.insert(i, p)
    import torch

    import cells
    import guard
    import tracing

    cell = cells.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"no result: the cell needs {cell.chips} CUDA device(s); "
                f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}")
            return 3
        device = torch.device("cuda", 0)
    record = cells.driver(cell.traffic).run(cell, seed=args.seed, seconds=args.seconds,
                                           trace=bool(args.trace), device=device,
                                           t_start=T_START, log=log)
    found = guard.forbidden_loaded()
    if found:
        log(f"no result: the process holds {', '.join(found)}")
        return 4
    compared = judge(cell, record["compared"])
    correct = record["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    on_card = device.type == "cuda"
    result = {
        "correct": correct, "attempted": record["attempted"], "failed": record["failed"],
        "metrics": metrics_of(cell, record, bool(args.trace)),
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(record["memory_peak_bytes"])},
    }
    traced = record.get("traced")
    if traced is not None:
        tr = traced["trace"]
        result["device"]["busy_s"] = tracing.busy_s(tr)
        result["device"]["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(tr), "idle_gaps": tracing.idle_gaps(tr)}
    result["compared"] = compared
    for name, c in compared.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
