"""Readings that the limits are set from (not part of a benchmark run).

    python3 benchmark/control.py --workload atb.genes --seed 11 --seconds 8
    python3 benchmark/control.py --workload atb.genes --seed 11 --seconds 8 --fault half

One run of the cell at its own size, on the card.  Prints one JSON line:
the program's numbers (`checks`) and, on the same rows, the ungapped
control's (`control_checks`); with --fault, the program runs with that
fault (reference/faults.py) planted under the window.  Loop over seeds in
the shell: each seed builds its own database.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib.harness import run_cell

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    out = run_cell(spec, args.workload, args.seed, args.seconds, False, device="cuda",
                   t_start=T_START, control=True, fault=args.fault)
    out["seed"] = args.seed
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
