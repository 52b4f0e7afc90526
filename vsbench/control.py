"""The readings that the limits of `correct` are set from: for each seed,
one run of the cell (set-up, a short window at the cell's own load), the
program's readings, and the control's in the program's place (the
reference one precision lower: TF32 for the served float32 searches;
float8 centroids and bfloat16 sums for a Lloyd's pass).

    python3 -m vsbench.control --workload <name> --seeds 1,2,3 --seconds 5

One JSON line a seed on stdout: {"seed", "program": {...}, "control": {...}}.
Not run by the benchmark's runs; kept to set and re-check the limits.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    from vsbench import checks, harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0))
        _, check, ctrl = harness.run_cell(cell, time.perf_counter(), with_control=True)
        print(json.dumps({"seed": seed,
                          "program": {k: checks.printable(c["value"]) for k, c in check.items()},
                          "control": {k: checks.printable(c["value"]) for k, c in ctrl.items()}}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
