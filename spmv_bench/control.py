#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size and
load, in one process (the set-up is paid once):

    python3 spmv_bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 --seconds 3

For each of ``--seeds``, a window of ``--seconds`` of the cell's traffic
through the program as the configuration states it, and the number the
run compares (``apply_err`` or ``cg_x_err``) over the window's sample. Then
the same with the control: the program's own path in the next lower
precision (the configuration's ``control``: float32 for a float64
configuration, bfloat16 values for a float32 one), on
``--control-seeds``. Prints one JSON line: each reading, the largest of the
program's (the lower reading) and the smallest of the control's (the
upper reading). The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(bench, name, seeds, seconds, *, control=False, device="cuda",
             cache=None, cfg=None, mix=None) -> dict:
    """{seed: the compared number} of ``name``'s traffic through the
    program (``control``: through the configuration's control path)."""
    from spmv_bench import harness, matrices, spec

    cell = spec.cell(bench, name)
    cfg = cfg or spec.config(bench, cell["config"])
    mix = mix or spec.mix(cell["traffic"])
    kind, iters = mix["kind"], mix.get("iters", 0)
    mat = matrices.make(cfg)
    prog = harness.Program(mat, cfg, device, cache or "",
                           variant=cfg["control"] if control else None,
                           chips=cell["chips"])
    ref = harness.reference_for(cfg)(mat, device)
    out = {}
    for seed in seeds:
        traffic = harness.Traffic(mix, mat, cfg, seed, device, ref=ref)
        window = harness.window_for(kind, prog.op,
                                    traffic.for_program(prog.dtype),
                                    iters, prog.cards)
        harness.warm_up(kind, window, len(traffic.inputs))
        sample = harness.Sample(mix["sample"], traffic.rng)
        window(seconds=seconds, sample=sample)
        checks, _ = harness.check(kind, ref, traffic, sample.kept, iters,
                                  cfg["limits"])
        (value,) = (c["value"] for c in checks.values())
        out[seed] = value
        print(f"{name} {'control' if control else 'program'} seed {seed}: "
              f"{value!r}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import cfs_spmv_tpu_torch  # noqa: F401
    import torch

    from spmv_bench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device: the readings are taken on the card",
              file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prog = readings(bench, args.workload, seeds, args.seconds,
                    cache=harness.CACHE)
    harness.free_cached(harness.cards(
        "cuda", spec.cell(bench, args.workload)["chips"]))
    ctrl = readings(bench, args.workload, cseeds, args.seconds,
                    control=True, cache=harness.CACHE) if cseeds else {}
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(0),
        "program": prog, "control": ctrl,
        "lower": max(prog.values()) if prog else None,
        "upper": min(ctrl.values()) if ctrl else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
