"""The reader ``dist_replay_share.cg`` on synthetic records: the share of
a window's ``cfs.dist.apply`` spans that the counter
``dist.graph_replays`` says were replays; 0 without the counter, nothing
without an apply, a recorder or a CG window."""

import pytest

from cfs_spmv_tpu_torch.utils.trace import Record
from spmv_bench import spec

from .test_spmv_bench_trace import _run, _span

NAME = "dist_replay_share.cg"


def _applies(n, counters):
    """One solve over ``n`` applies of 10 us, each a root span with its
    one step."""
    spans = [_span("cfs.solve", 1, None, 1, 0, 1e3)]
    for i in range(n):
        root = 2 * i + 2
        spans += [_span("cfs.dist.apply", root, None, root, 10 * i,
                        10 * i + 10),
                  _span("cfs.dist.replay", root + 1, root, root, 10 * i + 1,
                        10 * i + 9)]
    return Record(spans, counters)


@pytest.mark.parametrize("replays, share", [(51, 100.0), (50, 50 / 51 * 100),
                                            (0, 0.0)])
def test_the_share_of_applies_that_replayed(replays, share):
    run = _run(None, 4, kind="cg", window_record=_applies(
        51, {"dist.graph_replays": replays, "dist.copy_bytes": 1}))
    assert spec.reader(NAME)(run) == pytest.approx(share)


def test_zero_where_the_program_counts_no_replay():
    """A program without the counter (an eager apply across cards)."""
    run = _run(None, 4, kind="cg", window_record=_applies(
        3, {"dist.copy_bytes": 1}))
    assert spec.reader(NAME)(run) == 0.0


@pytest.mark.parametrize("kind, record", [
    ("cg", None),                                    # recorder off
    ("cg", Record([_span("cfs.solve", 1, None, 1, 0, 10)], {})),  # one card
    ("apply", _applies(2, {"dist.graph_replays": 2})),
])
def test_nothing_to_read(kind, record):
    run = _run(None, 1, kind=kind, window_record=record)
    assert spec.reader(NAME)(run) is None
