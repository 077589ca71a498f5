"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the plain reference, and the result line.

The program is the port's user-facing operator of the configuration's
matrix: ``SpDMV``, tuned with the plan cache, on one card; or, where the
configuration names ``"operator": "DistSpDMV"``, the rows sharded over the
cell's ``chips`` cards (``parallel/dist.DistSpDMV`` on
``parallel/mesh.make_mesh``). The window drives it as the cell's traffic
mix says (``mixes/<name>.json``):

- ``"kind": "apply"``: back-to-back eager ``op(x)`` (``SpDMV.__call__``)
  over a pool of device-resident x (``rhs`` columns each), with no host
  sync until the window ends;
- ``"kind": "cg"``: back-to-back ``models/solvers.cg(op, b, iters=...)``
  solves over a pool of right-hand sides, each solve waited for.

Every input comes from ``--seed``; the matrix is a fixed function of its
configuration. With ``--trace 1`` the port's recorder
(``cfs_spmv_tpu_torch.utils.trace``) is on through set-up and through the
traced window, and off through the measured one.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time

import numpy as np
import torch

from . import counts, matrices, reference, spec
from . import trace as tracing

#: the port's plan cache (``tune(cache_dir=...)``), inside the checkout
CACHE = os.path.join(spec.HERE, ".cache", "plans")
#: seconds of work a traced window aims at
TRACED_S = 0.5


@dataclasses.dataclass
class Run:
    """What a run measured: the record each metric's reader takes."""

    kind: str
    rhs: int
    iters: int
    setup_s: float
    tune_upload_s: float
    window_s: float
    #: applies (``apply``) or solves (``cg``) completed in the window
    done: int
    #: host seconds spent inside the calls (``apply``)
    host_call_s: float
    #: each solve's host wall, from the call to its x synchronised (``cg``)
    solve_walls_s: list
    #: each solve's replay loop by the solver's CUDA events (``cg``)
    loop_s: list
    logical_nnz: int
    #: the configuration's precision
    precision: str
    #: canonical bytes of one apply (``counts.apply_bytes``)
    apply_bytes: int
    #: bytes of the stored values in the configuration's precision
    value_bytes: int
    #: bytes of the plan's tensors that the program's appliers pass to
    #: their launches (``operand_bytes`` of the tuned operands)
    plan_bytes: int
    peak: counts.Peak | None
    trace: tracing.Trace | None = None
    #: applies or solves in the traced window
    traced: int = 0
    #: the cards the run used (1 on the CPU)
    chips: int = 1
    #: the port's recorded spans and counters (``utils/trace.Record``) of
    #: set-up, from the operator's construction to the end of warm-up,
    #: and of the traced window; None where the recorder was off
    setup_record: object = None
    window_record: object = None


def operand_bytes(obj, seen=None) -> int:
    """Bytes of the tensors reachable from ``obj`` (a tensor, a dict, a
    list or tuple, a dataclass), each storage counted once: what a tuned
    matrix holds for its appliers, read from its operands as uploaded,
    not from the plan it was built from."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        key = (obj.device, st.data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return st.nbytes()
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return sum(operand_bytes(o, seen) for o in obj)
    return 0


def cards(device, chips: int) -> list:
    """The CUDA cards a run of a cell of ``chips`` cards uses: on
    ``"cuda"`` the first ``chips``, on one named card (``"cuda:0"``) that
    card, on the CPU none."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    if dev.index is None:
        return [torch.device("cuda", i) for i in range(chips)]
    return [dev]


def _sync(cards) -> None:
    for card in cards:
        torch.cuda.synchronize(card)


class Program:
    """The system under test: the port's operator of ``mat`` in a cell of
    ``chips`` cards (``spec.operator``), with ``variant`` laid over its
    keywords (the control's lower precision). ``SpDMV`` is tuned as the
    configuration's ``tune`` says; ``DistSpDMV`` takes the configuration's
    ``dist`` keywords (``comm``, ``assign``, ``dia_min_count``) and one row
    shard a card of the cell on ``"cuda"``, or ``chips`` shards on one
    named device (``"cpu"``, ``"cuda:0"``)."""

    def __init__(self, mat, cfg: dict, device, plan_cache: str,
                 variant: dict | None = None, chips: int = 1):
        import cfs_spmv_tpu_torch as ct

        self.cards = cards(device, chips)
        csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                     symmetric=True)
        if spec.operator(cfg, chips) == "DistSpDMV":
            self._dist(csr, cfg, device, chips, variant)
            return
        opts = {**cfg["tune"], **(variant or {})}
        fmt = ct.Format[opts.pop("format")]
        tuning = ct.Tuning[opts.pop("tuning")]
        dtype = np.dtype(opts.pop("dtype", cfg["precision"]))
        a = ct.SparseMatrix.create(csr, fmt)
        t = time.perf_counter()
        self.op = ct.SpDMV(a, tuning, dtype=dtype, device=device,
                           cache_dir=plan_cache, **opts)
        _sync(self.cards)
        self.tune_upload_s = time.perf_counter() - t
        self.dtype = a.tuned.dtype
        self.plan_bytes = operand_bytes(a.tuned.operands)

    def _dist(self, csr, cfg, device, chips, variant) -> None:
        from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
        from cfs_spmv_tpu_torch.parallel.mesh import make_mesh

        opts = {**cfg.get("dist", {}), **(variant or {})}
        dtype = np.dtype(opts.pop("dtype", cfg["precision"]))
        t = time.perf_counter()
        self.op = DistSpDMV(csr, make_mesh(chips, device=device),
                            dtype=dtype, **opts)
        _sync(self.cards)
        self.tune_upload_s = time.perf_counter() - t
        self.dtype = self.op.dtype
        # every shard's operands, each storage once a device
        self.plan_bytes = operand_bytes(self.op.shards)


def reference_for(cfg: dict):
    """The plain reference's class of ``cfg``: ``references/<name>.py``
    where the configuration names one (``"reference"``), else
    ``reference.Reference``."""
    if "reference" in cfg:
        return spec.reference(cfg["reference"])
    return reference.Reference


class Traffic:
    """The inputs of one run, from its seed: ``inputs``, a pool of x (or,
    for CG, of b = A x_true by the plain reference) in the configuration's
    precision, and the generator of the answers' sample."""

    def __init__(self, mix: dict, mat, cfg: dict, seed: int, device,
                 ref=None):
        rhs = mix.get("rhs", 1)
        dtype = getattr(torch, cfg["precision"])
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2**63)
        shape = (mat.n,) if rhs == 1 else (mat.n, rhs)
        xs = [torch.rand(shape, generator=g, dtype=dtype, device=device)
              .mul_(2).sub_(1) for _ in range(mix["pool"])]
        if mix["kind"] == "cg":
            ref = ref or reference_for(cfg)(mat, device)
            xs = [ref.matvec(x).to(dtype) for x in xs]
        self.inputs = xs
        self.rng = np.random.default_rng(seed % 2**63)

    def for_program(self, dtype) -> list:
        """The inputs in the program's type."""
        return [x.to(dtype) for x in self.inputs]


class Sample:
    """A uniform sample of ``k`` of a window's answers, drawn from the
    seed (reservoir sampling): (index, answer) pairs."""

    def __init__(self, k: int, rng):
        self.k = k
        self.u = rng.random(1 << 20)
        self.kept = []

    def offer(self, i: int, answer) -> None:
        if i < self.k:
            self.kept.append((i, answer))
            return
        j = int(self.u[i % len(self.u)] * (i + 1))
        if j < self.k:
            self.kept[j] = (i, answer)


def apply_window(op, xs, cards, *, seconds=math.inf, count=None,
                 sample=None):
    """Back-to-back ``op(x)`` over the pool ``xs`` for ``seconds`` (or
    ``count`` calls), then one synchronisation of each of ``cards``:
    (window seconds, calls, host seconds inside the calls)."""
    host, i, pool = 0.0, 0, len(xs)
    t0 = time.perf_counter()
    stop = t0 + seconds
    while count is None or i < count:
        th = time.perf_counter()
        y = op(xs[i % pool])
        t = time.perf_counter()
        host += t - th
        if sample is not None:
            sample.offer(i, y)
        i += 1
        if t >= stop:
            break
    _sync(cards)
    return time.perf_counter() - t0, i, host


def cg_window(op, bs, iters, cards, *, seconds=math.inf, count=None,
              sample=None):
    """Back-to-back ``cg(op, b, iters=iters)`` over the pool ``bs``, each
    solve's x synchronised on each of ``cards`` before the next call:
    (window seconds, solves, each solve's host wall, each solve's
    replay-loop events)."""
    from cfs_spmv_tpu_torch.models import solvers

    walls, loops, i, pool = [], [], 0, len(bs)
    t0 = time.perf_counter()
    stop = t0 + seconds
    while count is None or i < count:
        th = time.perf_counter()
        x = solvers.cg(op, bs[i % pool], iters=iters)[0]
        _sync(cards)
        t = time.perf_counter()
        walls.append(t - th)
        if cards:
            loops.append(solvers._iterate.loop)
        if sample is not None:
            sample.offer(i, x)
        i += 1
        if t >= stop:
            break
    return time.perf_counter() - t0, i, walls, loops


def window_for(kind: str, op, xs, iters: int, cards):
    """The window function of a mix's kind over the program inputs
    ``xs`` on ``cards``: called with ``seconds=`` or ``count=`` (and
    ``sample=``)."""
    if kind == "apply":
        return lambda **kw: apply_window(op, xs, cards, **kw)
    return lambda **kw: cg_window(op, xs, iters, cards, **kw)


def warm_up(kind: str, window, pool: int) -> None:
    """Every shape the window uses, and the kernels' build on a first
    run: each input twice (two solves for CG)."""
    window(count=2 * pool if kind == "apply" else 2)


def free_cached(cards) -> None:
    """Collect garbage and return the allocator's unused blocks to each of
    ``cards``."""
    gc.collect()
    for card in cards:
        with torch.cuda.device(card):
            torch.cuda.empty_cache()


def check(kind: str, ref, traffic: Traffic, kept, iters: int,
          limits: dict):
    """Each sampled answer against the plain reference: ({name: {"value",
    "limit"}}, answers over their limit). ``apply``: the largest entry of
    |y - A x| / (|A| |x|) over the sample (``apply_err``); ``cg``: the
    largest ||x - x_ref|| / ||x_ref|| (``cg_x_err``), x_ref from the
    reference's own CG on the same b; ``ref`` is the plain reference of
    the cell's matrix (``reference_for``)."""
    done, errs = {}, []
    for i, answer in kept:
        p = i % len(traffic.inputs)
        if p not in done:
            v = traffic.inputs[p]
            done[p] = ((ref.matvec(v), ref.matvec(v, absolute=True))
                       if kind == "apply" else (ref.cg(v, iters),))
        errs.append(reference.apply_error(answer, *done[p])
                    if kind == "apply"
                    else reference.solve_error(answer, *done[p]))
    name = "apply_err" if kind == "apply" else "cg_x_err"
    limit = limits[name]
    value = max(errs) if errs else math.inf
    failed = sum(not e <= limit for e in errs) if errs else 1
    return {name: {"value": value, "limit": limit}}, failed


def device_info(cards) -> dict:
    """The result's ``device``: the cards used, and the peak of the
    fullest."""
    if not cards:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
            "count": len(cards),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(card)
                                     for card in cards)}


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t0: float | None = None,
             cache: str | None = CACHE, cfg: dict | None = None,
             mix: dict | None = None, root: str = spec.ROOT) -> dict:
    """One run of the cell ``name``: returns the result line's object.
    ``t0`` is the process's start by ``time.perf_counter``; ``cache`` the
    folder of the port's plan cache (None: none); ``cfg`` and ``mix`` stand
    in for the cell's files where given (the tests' small sizes);
    ``device`` is ``"cuda"`` (the cell's cards), one named device, or
    ``"cpu"``."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(bench, name)
    cfg = cfg or spec.config(bench, cell["config"], root)
    mix = mix or spec.mix(cell["traffic"])
    chips = cell["chips"]
    spec.operator(cfg, chips)
    wanted = spec.metrics_for(bench, name, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in wanted}
    kind, rhs, iters = mix["kind"], mix.get("rhs", 1), mix.get("iters", 0)
    if kind not in ("apply", "cg"):
        raise spec.SpecError(f"traffic mix {cell['traffic']!r}: unknown "
                             f"kind {kind!r}")
    used = cards(device, chips)
    n_cards = max(1, len(used))
    peak = counts.peak_for(torch.cuda.get_device_name(used[0])) \
        if used else None

    mat = matrices.make(cfg)
    traffic = Traffic(mix, mat, cfg, seed, device)
    # the peak is the program's: CG's right-hand sides come from the
    # reference, whose state is freed first
    free_cached(used)
    for card in used:
        torch.cuda.reset_peak_memory_stats(card)
    recorder = _recorder() if trace else None
    prog = Program(mat, cfg, device, cache or "", chips=chips)
    xs = traffic.for_program(prog.dtype)
    window = window_for(kind, prog.op, xs, iters, used)
    warm_up(kind, window, len(xs))
    setup_s = time.perf_counter() - t0
    setup_rec = _collect(recorder)

    sample = Sample(mix["sample"], traffic.rng)
    out = window(seconds=seconds, sample=sample)
    window_s, done = out[0], out[1]
    host_call_s = out[2] if kind == "apply" else 0.0
    walls = out[2] if kind == "cg" else []
    loops = [s.elapsed_time(e) / 1e3 for s, e, _ in out[3]] \
        if kind == "cg" else []

    tr, traced, window_rec = None, 0, None
    if trace:
        traced = max(2, min(2000, round(TRACED_S * done / window_s)))

        def work():  # the recorder holds the last profiled window alone
            recorder.collect()
            window(count=traced)

        with recorder.recording():
            tr = tracing.record(work, cards=n_cards)
        window_rec = recorder.collect()
    dev = device_info(used)
    plan_bytes, tune_upload_s = prog.plan_bytes, prog.tune_upload_s
    # the reference runs once the program's state is freed
    del prog, window, xs
    free_cached(used)

    checks, failed = check(kind, reference_for(cfg)(mat, device), traffic,
                           sample.kept, iters, cfg["limits"])
    run = Run(
        kind=kind, rhs=rhs, iters=iters, setup_s=setup_s,
        tune_upload_s=tune_upload_s, window_s=window_s, done=done,
        host_call_s=host_call_s, solve_walls_s=walls, loop_s=loops,
        logical_nnz=mat.logical_nnz, precision=cfg["precision"],
        apply_bytes=counts.apply_bytes(mat.n, mat.stored_nnz, rhs,
                                       cfg["precision"]),
        value_bytes=counts.value_bytes(mat.stored_nnz, cfg["precision"]),
        plan_bytes=plan_bytes, peak=peak, trace=tr, traced=traced,
        chips=n_cards, setup_record=setup_rec,
        window_record=window_rec,
    )
    return _result(run, wanted, readers, checks, failed, dev, trace)


def _recorder():
    """The port's recorder, emptied and turned on."""
    from cfs_spmv_tpu_torch.utils import trace as recorder

    recorder.collect()
    recorder.enable()
    return recorder


def _collect(recorder):
    """What ``recorder`` holds (None: no recorder), turned off."""
    if recorder is None:
        return None
    recorder.disable()
    return recorder.collect()


def _result(run, wanted, readers, checks, failed, dev, trace) -> dict:
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read "
                               "nothing")
    result = {"correct": failed == 0, "attempted": run.done,
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result
