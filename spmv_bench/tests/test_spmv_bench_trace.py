"""The reduction of a traced window and of the port's recorded spans to
the per-layer readings, on synthetic events and spans: each card's busy
time, the gaps in which no card is busy, the roofline's busiest card,
idle time by span, and the readers of the recorder's spans and counters;
then the recorder's records through a whole run at CPU sizes."""

import pytest

from cfs_spmv_tpu_torch.utils.trace import Record, Span
from spmv_bench import counts, harness, spec
from spmv_bench import trace as tracing

from .conftest import small_config

NEW = ["host_self_us_per_apply.apply", "plan_key_s", "plan_load_s",
       "upload_s", "solve_prep_ms.cg", "device_allocs_per_solve.cg",
       "prep_idle_pct.cg"]


def _events(device, annotations=()):
    """A 100-us window: ``device`` (card, ts, dur) kernels, host
    operations over the two gaps, and ``annotations`` (name, ts, dur)."""
    ev = [{"name": tracing.WINDOW, "cat": "user_annotation", "ph": "X",
           "ts": 0, "dur": 100}]
    ev += [{"name": "void k<double>(int)", "cat": "kernel", "ph": "X",
            "ts": ts, "dur": dur, "pid": card, "args": {"device": card}}
           for card, ts, dur in device]
    ev += [{"name": name, "cat": "cpu_op", "ph": "X", "ts": ts, "dur": dur}
           for name, ts, dur in (("host_a", 18, 14), ("host_b", 39, 61))]
    ev += [{"name": name, "cat": "user_annotation", "ph": "X", "ts": ts,
            "dur": dur} for name, ts, dur in annotations]
    return ev


# card 0 busy over [0, 20) (two kernels, 25 us of device time), card 1
# over [30, 40)
DEVICE = [(0, 0, 10), (0, 5, 15), (1, 30, 10)]


def _union_s(tr):
    """The busy time as one card's union of every interval."""
    spans, end, total = sorted((e["ts"], e["ts"] + e["dur"])
                               for e in tr.device), -1e300, 0.0
    for s, t in spans:
        total += max(0.0, t - max(s, end))
        end = max(end, t)
    return total / 1e6


def test_one_card_reads_the_union_of_every_interval():
    tr = tracing.Trace(_events(DEVICE))
    assert tr.busy_s == pytest.approx(_union_s(tr)) == pytest.approx(30e-6)
    assert tr.busiest_card_s() == tr.device_s() == pytest.approx(35e-6)


def test_each_card_reads_its_own_busy_time():
    tr = tracing.Trace(_events(DEVICE), cards=2)
    assert tr.busy_s == pytest.approx((20e-6 + 10e-6) / 2)
    assert tr.busiest_card_s() == pytest.approx(25e-6)
    assert tr.device_ops() == [["k<double>", pytest.approx(35e-6)]]
    # a card that ran nothing in the window counts as idle
    assert tracing.Trace(_events(DEVICE), cards=4).busy_s \
        == pytest.approx(30e-6 / 4)


@pytest.mark.parametrize("cards", [1, 2])
def test_idle_gaps_are_where_no_card_is_busy(cards):
    gaps = dict(tracing.Trace(_events(DEVICE), cards=cards).idle_gaps())
    assert gaps == {"host_a": pytest.approx(10e-6),
                    "host_b": pytest.approx(60e-6)}


def _run(tr, chips, kind="apply", **kw):
    base = dict(kind=kind, rhs=1, iters=50, setup_s=1.0, tune_upload_s=1.0,
                window_s=1.0, done=10, host_call_s=0.0, solve_walls_s=[],
                loop_s=[], logical_nnz=343, precision="float64",
                apply_bytes=185 * 8 + 2 * 27 * 8, value_bytes=185 * 8,
                plan_bytes=185 * 8,
                peak=counts.peak_for("NVIDIA H100 80GB HBM3"), trace=tr,
                traced=5, chips=chips)
    return harness.Run(**{**base, **kw})


def test_the_roofline_holds_the_cards_peaks_against_the_busiest_card():
    roofline = spec.reader("spmv_roofline")
    run = _run(tracing.Trace(_events(DEVICE)), 1)
    bound = counts.bound_s(run.apply_bytes, counts.apply_flops(343, 1),
                           run.peak, "float64")
    # one card: the bound over all the device time an apply, as before
    assert roofline(run) == 100 * bound / (run.trace.device_s() / 5)
    two = _run(tracing.Trace(_events(DEVICE), cards=2), 2)
    assert roofline(two) == pytest.approx(100 * bound / 2 / (25e-6 / 5))


def test_idle_time_by_the_ports_spans():
    tr = tracing.Trace(_events(DEVICE, [
        ("cfs.solve", 0, 100), ("cfs.solve.setup", 15, 20),
        ("cfs.solve.capture", 50, 10), ("cfs.stage", 52, 2)]))
    idle = tr.idle_by_span(tracing.SOLVE_PREP)
    assert idle == {"cfs.solve.setup": pytest.approx(10e-6),
                    "cfs.solve.capture": pytest.approx(10e-6),
                    None: pytest.approx(50e-6)}
    assert tracing.Trace(_events(DEVICE)).idle_by_span(
        tracing.SOLVE_PREP) is None
    run = _run(tr, 1, kind="cg", window_record=Record([], {}))
    assert spec.reader("prep_idle_pct.cg")(run) == pytest.approx(20.0)


def _span(name, i, parent, root, t0_us, t1_us):
    return Span(name, {}, i, parent, root, int(t0_us * 1e3),
                int(t1_us * 1e3))


def test_the_readers_of_the_recorders_spans():
    applies = Record([
        _span("cfs.stage", 2, 1, 1, 10, 30),
        _span("cfs.launch", 3, 1, 1, 20, 60),
        _span("cfs.apply", 1, None, 1, 0, 100),     # 50 us its own
        _span("cfs.launch", 5, 4, 4, 210, 230),
        _span("cfs.apply", 4, None, 4, 200, 280),   # 60 us its own
    ], {})
    setup = Record([
        _span("cfs.tune.key", 2, 1, 1, 0, 3e6),
        _span("cfs.tune.plan_load", 3, 1, 1, 3e6, 8e6),
        _span("cfs.tune.upload", 4, 1, 1, 8e6, 8.5e6),
        _span("cfs.tune.upload", 5, 1, 1, 9e6, 9.25e6),
        _span("cfs.tune", 1, None, 1, 0, 1e7),
    ], {"plancache.hits": 1})
    solves = Record([
        _span("cfs.solve.setup", 2, 1, 1, 0, 5e3),
        _span("cfs.solve.setup", 3, 1, 1, 5e3, 6e3),
        _span("cfs.solve.warmup", 4, 1, 1, 6e3, 10e3),
        _span("cfs.solve.capture", 5, 1, 1, 10e3, 19e3),
        _span("cfs.solve.restore", 6, 1, 1, 19e3, 20e3),
        _span("cfs.solve.replay", 7, 1, 1, 20e3, 23e3),
        _span("cfs.solve", 1, None, 1, 0, 24e3),     # 20 ms of preparation
        _span("cfs.solve.setup", 9, 8, 8, 30e3, 40e3),
        _span("cfs.solve", 8, None, 8, 30e3, 45e3),  # 10 ms
    ], {"cuda.device_allocs": 14})
    read = {name: spec.reader(name) for name in NEW}
    apply = _run(None, 1, setup_record=setup, window_record=applies)
    assert read["host_self_us_per_apply.apply"](apply) \
        == pytest.approx(55.0)
    assert read["plan_key_s"](apply) == pytest.approx(3.0)
    assert read["plan_load_s"](apply) == pytest.approx(5.0)
    assert read["upload_s"](apply) == pytest.approx(0.75)
    cg = _run(None, 1, kind="cg", setup_record=setup, window_record=solves)
    assert read["solve_prep_ms.cg"](cg) == pytest.approx(15.0)
    assert read["device_allocs_per_solve.cg"](cg) == pytest.approx(7.0)


@pytest.mark.parametrize("kind", ["apply", "cg"])
def test_the_new_readers_read_nothing_without_the_recorder(kind):
    tr = tracing.Trace(_events(DEVICE, [("cfs.solve.setup", 15, 20)]))
    run = _run(tr, 1, kind=kind)
    assert run.setup_record is None and run.window_record is None
    for name in NEW:
        assert spec.reader(name)(run) is None, name


@pytest.mark.parametrize("name", ["hpcg256-spmv", "hpcg256-cg"])
def test_a_traced_run_carries_the_recorders_records(
        bench, monkeypatch, tmp_path, name):
    """A ``--trace 1`` run at CPU sizes, the profiler's window stood in
    for by synthetic events (the CPU has no device events): set-up and the
    traced window reach the readers, and the recorder ends off."""
    from cfs_spmv_tpu_torch.utils import trace as recorder

    seen = []

    def record(work, tries=3, cards=1):
        work()
        seen.append(recorder.is_recording())
        return tracing.Trace(_events(DEVICE), cards=cards)

    monkeypatch.setattr(tracing, "record", record)
    cfg = small_config(bench, name)
    outs = [harness.run_cell(bench, name, seed, 0.2, True, device="cpu",
                             cache=str(tmp_path), cfg=cfg)
            for seed in (2**31 + 61, 2**31 + 62)]
    assert seen == [True, True] and not recorder.is_recording()
    assert [o["correct"] for o in outs] == [True, True]
    listed = {m["name"] for m in spec.metrics_for(bench, name, True)}
    got = [set(o["metrics"]) & set(NEW) for o in outs]
    # the plan is built in the first run and loaded in the second
    assert got[1] - got[0] == {"plan_load_s"}
    want = {n for n in NEW if n in listed} - {"prep_idle_pct.cg"}
    assert got[1] == want
