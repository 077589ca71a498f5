"""The multi-process distributed layer on the CPU: ``parallel/multihost.py``
joins gloo ranks in spawned processes, ``make_mesh()`` then gives one row
shard per rank, and ``DistSpDMV`` over that mesh applies this rank's shard
and all-gathers y (``parallel/dist.py``).

Each world size (P = 2 and 4) is one spawn of P ranks (a spawn costs a
few seconds here), which run every case: before joining the group, a rank
builds the single-process operator of the case (P shards on one CPU mesh)
and applies it; after, the same operator over the process-group mesh.
Every rank's y (SpMV) and Y (SpMM) must be ``torch.equal`` to the
single-process ones (the shards compute the same twins on the same
segments, and the all-gather only moves rows) and within ``allclose_spmv``
of ``CSR.spmv_host`` at the dtype's gate. The cases cover every comm
(halo, gather, ring), an uneven partition (segments not back to back),
the symmetric shards' paired stream, union and mirrored diagonals, the
clustered assignment (a permuted internal space), in float32 and float64;
and S1's cg over the 2-rank operator must equal the single-process solve
bit for bit.

Every spawn is bounded by ``join(timeout=...)``: a rank still running at
the deadline is killed and the test fails (there is no pytest-timeout
here), as ``test_a_stuck_rank_fails_in_time`` shows.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cfs_spmv_tpu_torch import COO, CSR
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

#: seconds a spawn of P ranks may take before it fails (it takes 5-15)
SPAWN_TIMEOUT = 240
DTYPES = ("float32", "float64")
#: right-hand sides of the SpMM applies
RHS = 5


def _band(n, half_bw, seed, scat=0.0):
    """Symmetric band of ``half_bw`` lower diagonals plus a diagonal in
    [1, 2), optionally a scattered symmetric residual."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r, c, v = [rows[keep]], [cols[keep]], [rng.uniform(-1, 1, keep.sum())]
    if scat:
        s = COO.random(n, n, scat, symmetric=True, seed=seed + 1,
                       dtype=np.float64)
        r, c, v = r + [s.row], c + [s.col], v + [s.val]
    r = np.concatenate(r + [np.arange(n)])
    c = np.concatenate(c + [np.arange(n)])
    v = np.concatenate(v + [rng.uniform(1, 2, n)])
    return CSR.from_coo(COO(n, n, r, c, v, symmetric=True).canonicalize())


def _spd(n=4096):
    """The SPD system of the port's cg test over a distributed operator."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n, dtype=np.int64), 6)
    cols = np.clip(rows - rng.integers(1, 40, n * 6), 0, n - 1)
    keep = cols < rows
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate([rng.uniform(-1, 1, keep.sum()), np.full(n, 15.0)])
    return CSR.from_coo(COO(n, n, r, c, v, symmetric=True).canonicalize())


def _communities():
    """Two communities whose tiles interleave (tile t in community
    t % 2), edges inside a community only: the clustered assignment's
    case of the port's single-process tests."""
    Tt, n = 16, 16 * 128
    rng = np.random.default_rng(30)
    rows, cols = [], []
    for t in range(Tt):
        comm_tiles = np.arange(t % 2, Tt, 2)
        rows.append(t * 128 + rng.integers(0, 128, 600))
        ct = comm_tiles[rng.integers(0, len(comm_tiles), 600)]
        cols.append(ct * 128 + rng.integers(0, 128, 600))
    r = np.concatenate(rows + [np.arange(n)])
    c = np.concatenate(cols + [np.arange(n)])
    keep = r >= c
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 1.5, len(r))
    return CSR.from_coo(COO(n, n, r, c, v, symmetric=True).canonicalize())


def _paired():
    from cfs_spmv_tpu_torch.utils.proxies import near_band_paired

    return near_band_paired(n=4096, n_diags=24, max_off=300, seed=3)


MATRICES = {
    # general, banded: halo under auto at P = 2 and 4
    "banded": lambda: CSR.from_coo(COO.random(
        4096, 4096, 6.0, bandwidth=150, seed=21, dtype=np.float64)),
    # 530 rows in 5 tiles: an equal-nnz partition, segments not back to
    # back
    "uneven": lambda: CSR.from_coo(COO.random(
        530, 530, 4.0, bandwidth=60, seed=4, dtype=np.float64)),
    # a symmetric band: union diagonals, halo under auto
    "dia": lambda: _band(4096, 6, 7),
    # band + scattered residual: union diagonals, the paired residual and
    # far entries; at P = 4 one shard is empty
    "mixed": lambda: _band(3000, 4, 8, 2.0),
    "paired": _paired,
    "communities": _communities,
    "spd": _spd,
}

#: name -> (matrix, DistSpDMV keywords, environment, the comm it resolves
#: to at P = 2 and 4, or {P: comm} where they differ)
CASES = {
    "banded_halo": ("banded", {}, {}, "halo"),
    "banded_gather": ("banded", dict(comm="gather"), {}, "gather"),
    "banded_ring": ("banded", dict(comm="ring"), {}, "ring"),
    "uneven_gather": ("uneven", dict(comm="gather"), {}, "gather"),
    "uneven_ring": ("uneven", dict(comm="ring"), {}, "ring"),
    "dia_halo": ("dia", dict(dia_min_count=8), {}, "halo"),
    "mirrored": ("dia", dict(dia_min_count=8),
                 {"CFS_DIST_SDIA_ROWS_MAX": "256"}, "halo"),
    "mirrored_ring": ("dia", dict(dia_min_count=8, comm="ring"),
                      {"CFS_DIST_SDIA_ROWS_MAX": "256"}, "ring"),
    "mixed_auto": ("mixed", dict(dia_min_count=8), {}, "gather"),
    "mixed_ring": ("mixed", dict(dia_min_count=8, comm="ring"), {}, "ring"),
    "paired": ("paired", {}, {"CFS_PAIRED": "force"}, "halo"),
    "cluster": ("communities", dict(assign="cluster"), {},
                {2: "halo", 4: "gather"}),
}
#: S1's cg over the 2-rank operator: iterations
CG_ITERS = 40


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _inputs(n, dtype):
    x = np.random.default_rng(7).uniform(10.01, 20.42, n).astype(dtype)
    X = np.random.default_rng(18).uniform(1, 2, (n, RHS)).astype(dtype)
    return x, X


def _oracle_ok(csr, x, y, dtype):
    """y (n,) or (n, B) within ``allclose_spmv`` of ``CSR.spmv_host`` at
    ``dtype``'s gate, column by column."""
    x, y = np.asarray(x, np.float64), y.numpy()
    npr = max(csr.to_coo().nnz_full / csr.nrows, 1.0)
    cols = [(x, y)] if x.ndim == 1 else [(x[:, b], y[:, b])
                                         for b in range(x.shape[1])]
    return all(allclose_spmv(yb, csr.spmv_host(xb), np.dtype(dtype),
                             nnz_per_row=npr,
                             scale=csr.spmv_host(xb, absolute=True))
               for xb, yb in cols)


def _rank_main(rank, P, out):
    """One gloo rank: every case single-process, then over the group."""
    import torch.distributed as dist

    from cfs_spmv_tpu_torch.models import solvers
    from cfs_spmv_tpu_torch.parallel import multihost
    from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
    from cfs_spmv_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mats = {k: f() for k, f in MATRICES.items()}

    def operator(case, dt, mesh):
        mname, kw, env, _ = CASES[case]
        return _with_env(env, lambda: DistSpDMV(mats[mname], mesh, dtype=dt,
                                                **kw))

    single = {}
    for case, (mname, _, _, _) in CASES.items():
        for dt in DTYPES:
            dsp = operator(case, dt, make_mesh(P, device="cpu"))
            x, X = _inputs(mats[mname].nrows, dt)
            single[case, dt] = (dsp(x), dsp(X))
    b = np.random.default_rng(0).uniform(1, 2, mats["spd"].nrows).astype(
        np.float32)
    if P == 2:
        spd1 = DistSpDMV(mats["spd"], make_mesh(P, device="cpu"))
        cg1 = solvers.cg(spd1, b, iters=CG_ITERS)

    multihost.initialize(device="cpu", init_method=f"file://{out}/init",
                         rank=rank, world_size=P)
    mesh = make_mesh(device="cpu")
    res = {"mesh": dict(rank=mesh.rank, shape=mesh.shape,
                        single_device=mesh.single_device,
                        group=mesh.group is not None,
                        devices=[str(d) for d in mesh.devices]),
           "cases": {}}
    try:
        make_mesh(P + 1, device="cpu")
    except ValueError:
        res["mesh"]["refuses_another_count"] = True
    for case, (mname, _, _, _) in CASES.items():
        for dt in DTYPES:
            dsp = operator(case, dt, mesh)
            x, X = _inputs(mats[mname].nrows, dt)
            y, Y = dsp(x), dsp(X)
            y1, Y1 = single[case, dt]
            res["cases"][f"{case} {dt}"] = dict(
                comm=dsp.comm, y_equal=bool(torch.equal(y, y1)),
                Y_equal=bool(torch.equal(Y, Y1)), dtype=str(y.dtype),
                oracle_ok=(_oracle_ok(mats[mname], x, y, dt)
                           and _oracle_ok(mats[mname], X, Y, dt)),
                shards=[sh is not None for sh in dsp.shards],
                max_diff=float((y.double() - y1.double()).abs().max()))
    if P == 2:
        spd = DistSpDMV(mats["spd"], mesh)
        cg = solvers.cg(spd, b, iters=CG_ITERS)
        res["cg"] = dict(
            equal=all(torch.equal(p, q) for p, q in zip(cg, cg1)),
            fall=float(cg[2][-1] / cg[2][0]))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _stuck_main(rank, out):
    """Rank 1 never ends."""
    if rank == 1:
        time.sleep(600)


def _join(ctx, timeout):
    """Wait for every process of ``ctx`` at most ``timeout`` seconds; kill
    whatever still runs then, and fail."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"a rank was still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(P): the results of every rank of one spawn of P gloo ranks,
    spawned once per world size."""
    cache = {}

    def run(P):
        if P not in cache:
            out = tmp_path_factory.mktemp(f"gloo{P}")
            ctx = mp.start_processes(_rank_main, args=(P, str(out)),
                                     nprocs=P, join=False,
                                     start_method="spawn")
            _join(ctx, SPAWN_TIMEOUT)
            cache[P] = [json.loads((out / f"rank{r}.json").read_text())
                        for r in range(P)]
        return cache[P]

    return run


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_y_bit_identical_to_single_process(ranks, P, dtype, case):
    for rank, res in enumerate(ranks(P)):
        r = res["cases"][f"{case} {dtype}"]
        comm = CASES[case][3]
        assert r["comm"] == (comm[P] if isinstance(comm, dict) else comm), (
            rank, r)
        assert r["dtype"] == f"torch.{dtype}", (rank, r)
        assert r["y_equal"] and r["Y_equal"], (rank, r)
        assert r["oracle_ok"], (rank, r)
        # this rank uploaded its own shard only
        assert r["shards"] == [d == rank for d in range(P)], (rank, r)


@pytest.mark.parametrize("P", [2, 4])
def test_process_group_mesh(ranks, P):
    for rank, res in enumerate(ranks(P)):
        m = res["mesh"]
        assert m["rank"] == rank and m["group"] and not m["single_device"]
        assert m["shape"] == {"rows": P} and m["devices"] == ["cpu"] * P
        assert m.get("refuses_another_count")


def test_cg_over_two_ranks_bit_identical(ranks):
    for res in ranks(2):
        assert res["cg"]["equal"] and res["cg"]["fall"] < 1e-3, res["cg"]


def test_a_stuck_rank_fails_in_time(tmp_path):
    t0 = time.monotonic()
    ctx = mp.start_processes(_stuck_main, args=(str(tmp_path),), nprocs=2,
                             join=False, start_method="spawn")
    with pytest.raises(pytest.fail.Exception, match="still running"):
        _join(ctx, 3)
    assert not any(p.is_alive() for p in ctx.processes)
    assert time.monotonic() - t0 < 60


def test_is_multiprocess(monkeypatch):
    from cfs_spmv_tpu_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not multihost.is_multiprocess()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not multihost.is_multiprocess()
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost.is_multiprocess()
    # the JAX launcher's variables do not make a torch process group
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    assert not multihost.is_multiprocess()


def test_initialize_single_process(monkeypatch):
    """One process: a no-op (on the CPU and on the card), no group is
    made; without CUDA the default device raises, as every entry point
    of the port does."""
    import torch.distributed as dist

    from cfs_spmv_tpu_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize()
    assert not dist.is_initialized()
