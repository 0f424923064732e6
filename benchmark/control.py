"""The readings that a cell's limits are set from, several seeds in one
process: the numbers each run of the program compares (the lower
reading); with --control, the same numbers with the plain reference
computed in bfloat16 in the program's place (the upper reading); with
--fault, the program's with a fault of `benchmark/faults.py` planted in
the timed path.

    python3 -m benchmark.control --workload botanic.map --seeds 11,12,13 --seconds 1 \
        [--control | --fault half_batch]

One JSON line a seed on standard output. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import faults
from benchmark import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    R.set_environment()
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = R.Cell(R.load_json(R.ROOT, "BENCHMARK.json"), args.workload)
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = R.Context(cell, seed, args.seconds, False, control=args.control)
        rec = R.run(cell, ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "seconds": time.perf_counter() - t0,
                          "checks": {c["name"]: c["value"] for c in rec["checks"]},
                          "metrics": rec["metrics"], "program": rec.get("program")}),
              flush=True)
        del rec, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
