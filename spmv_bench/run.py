#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 spmv_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; ``breakdown`` with ``--trace 1``; ``checks`` last: each number
compared with its limit, which also end standard error). Exits 3 without
a result where CUDA or the cards the cell asks for are missing, 4 where
JAX or the JAX package is loaded, 2 on a name the benchmark does not hold.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _refuse_forbidden(guard) -> bool:
    found = guard.forbidden_loaded()
    if found:
        print(f"refused: the run loaded {', '.join(found)}",
              file=sys.stderr)
    return bool(found)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import cfs_spmv_tpu_torch  # noqa: F401  (the program, before numpy)
    import torch

    from spmv_bench import guard, harness, spec

    if _refuse_forbidden(guard):
        return 4
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 3
    try:
        bench = spec.load_benchmark()
        cell = spec.cell(bench, args.workload)
        chips = cell["chips"]
        spec.operator(spec.config(bench, cell["config"]), chips)
    except spec.SpecError as err:
        print(err, file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), t0=T0)
    except spec.SpecError as err:
        print(err, file=sys.stderr)
        return 2
    if _refuse_forbidden(guard):
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
