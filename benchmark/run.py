"""The benchmark of lexicmap_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload gtdb.genes --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  Prints the result as the last line of
standard output, and the numbers that decided `correct`, each beside its
limit, as the last lines of standard error.  Exits non-zero with no
result where there is no CUDA card, where the port cannot be imported
from this checkout, or where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.lib.harness import forbidden_modules, run_cell

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import lexicmap_tpu_torch

    here = os.path.realpath(os.path.dirname(lexicmap_tpu_torch.__file__))
    if os.path.commonpath([here, os.path.realpath(ROOT)]) != os.path.realpath(ROOT):
        print(f"error: lexicmap_tpu_torch comes from {here}, not this checkout", file=sys.stderr)
        return 2

    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    result["device"]["count"] = chips
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
