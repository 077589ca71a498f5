"""The port's solvers (``cfs_spmv_tpu_torch.models.solvers``) on the CPU.

Two kinds of test, each in float32 and float64:

- copies of the seven tests of ``tests/test_solvers.py`` on the port,
  with ``device="cpu"`` (convergence against the true solution or the
  dense spectrum, at the reference's thresholds);
- parity: the same numpy systems through the reference's solver (its
  Pallas kernels in interpret mode, as its own tests run them) and the
  port's. cg, bicgstab, jacobi, chebyshev and gmres compare x and the
  residual histories, relatively, over the history entries above 1e-4
  of the first: within ``HIST_TOL`` (1e-3 in float32, 1e-9 in float64:
  the two sum in other orders and the reference's float64 path keeps
  about 48 bits, so they drift apart by a few units of the last place
  per iteration); x within ``HIST_TOL`` of its largest entry. lanczos
  and power_iteration draw their start vectors from different
  generators (the port's is a ``torch.Generator``), so they compare
  their top eigenvalue estimates, on a matrix whose top eigenvalue
  stands apart so that both have converged: within ``EIG_TOL``. The
  reference's power and Lanczos start from a float32 vector, which its
  float64 plans refuse, so in float64 the reference runs on the
  float32-tuned matrix and the port's float64 estimate is held to it at
  float32's tolerance and to the dense spectrum at float64's.

The CPU runs the solver bodies eagerly; on the card the same bodies run
as replayed CUDA graphs (``chip_smoke.py`` holds the graphed solves
against eager ones there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfs_spmv_tpu import CSR as RefCSR
from cfs_spmv_tpu.models import solvers as ref_solvers
from cfs_spmv_tpu.tuning.tune import tune as ref_tune
from cfs_spmv_tpu.utils.platform import Format as RefFormat
from cfs_spmv_tpu_torch import COO, CSR, Format
from cfs_spmv_tpu_torch.models import solvers
from cfs_spmv_tpu_torch.tuning.tune import tune as port_tune

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]
HIST_TOL = {np.float32: 1e-3, np.float64: 1e-9}
EIG_TOL = {np.float32: 1e-5, np.float64: 1e-10}


def tune(csr, dtype, **kw):
    return port_tune(csr, dtype=dtype, device="cpu", **kw)


def spd_system(n=700, half_bw=5, seed=0, dtype=np.float32):
    """Diagonally dominant symmetric (hence SPD) banded system."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    offv = rng.uniform(-1, 1, keep.sum())
    v = np.concatenate([offv, np.full(n, 2.0 * half_bw + 1.0)])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32),
            v.astype(np.float64), symmetric=True).canonicalize()
    )
    x_true = rng.uniform(-1, 1, n).astype(dtype)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(dtype)
    return csr, x_true, b


def general_system(n, m, spread, dia, seed, dtype):
    """Nonsymmetric diagonally dominant system: ``m`` scattered entries
    in (-spread, spread) and ``dia`` on the diagonal."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    v = rng.uniform(-spread, spread, m)
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([v, np.full(n, dia)])
    csr = CSR.from_coo(COO(n, n, r.astype(np.int32), c.astype(np.int32),
                           v.astype(np.float64)).canonicalize())
    x_true = rng.uniform(-1, 1, n).astype(dtype)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(dtype)
    return csr, x_true, b


def ref_csr(csr):
    return RefCSR(csr.nrows, csr.ncols, csr.indptr.copy(),
                  csr.indices.copy(), csr.data.copy(), csr.symmetric)


def np_(t):
    return np.asarray(t.cpu() if torch.is_tensor(t) else t)


@pytest.fixture(scope="module")
def spd():
    return {dt: spd_system(dtype=dt) for dt in DTYPES}


# -- the reference's seven tests, on the port ----------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_converges(spd, dtype):
    csr, x_true, b = spd[dtype]
    t = tune(csr, dtype, fmt=Format.SSS)
    x, resid, hist = solvers.cg(t.matvec, torch.as_tensor(b), iters=80)
    assert x.dtype == t.dtype and hist.shape == (80,)
    assert float(resid) < 1e-3 * np.linalg.norm(b)
    assert np.allclose(np_(x), x_true, atol=5e-3)
    assert hist[-1] < hist[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_under_reorder(dtype):
    """Solver in permuted space must decode back to user ordering."""
    csr0, x_true, b = spd_system(n=2500, seed=2)
    # shuffle to force RCM (needs bw > the 2-tile block-local early-out)
    n = csr0.nrows
    rng = np.random.default_rng(3)
    shuf = rng.permutation(n)
    coo = csr0.to_coo()
    r, c = shuf[coo.row], shuf[coo.col]
    swap = c > r
    r[swap], c[swap] = c[swap], r[swap].copy()
    csr = CSR.from_coo(
        COO(n, n, r, c, coo.val.copy(), symmetric=True).canonicalize()
    )
    t = tune(csr, dtype, fmt=Format.SSS, reorder=True)
    # the float64 route takes no reordering, as the reference's
    assert (t.perm is not None) == (dtype == np.float32)
    x_ref = np.linalg.solve(csr.to_coo().to_dense(), np.ones(n))
    x, resid, _ = solvers.cg(t.matvec, np.ones(n, dtype), iters=100)
    assert np.allclose(np_(x), x_ref, atol=5e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_general(dtype):
    """Nonsymmetric diagonally dominant system."""
    csr, x_true, b = general_system(500, 2500, 0.2, 8.0, 1, dtype)
    t = tune(csr, dtype, fmt=Format.CSR, reorder=False)
    x, resid, _ = solvers.bicgstab(t.matvec, torch.as_tensor(b), iters=60)
    assert np.allclose(np_(x), x_true, atol=5e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_and_chebyshev(spd, dtype):
    csr, x_true, b = spd[dtype]
    t = tune(csr, dtype, fmt=Format.SSS)
    _, diag, _ = csr.split_triangle()
    xj, hist = solvers.jacobi(
        t.matvec, diag.astype(dtype), torch.as_tensor(b), iters=200,
        omega=0.9,
    )
    assert hist[-1] < 1e-2 * hist[0]
    # spectral bounds from Gershgorin (diag dominant)
    lam_max = float(2 * (2 * 5 + 1))
    lam_min = 1.0
    xc, hist_c = solvers.chebyshev(
        t.matvec, torch.as_tensor(b), lam_min, lam_max, iters=200
    )
    assert hist_c[-1] < 1e-2 * hist_c[0]
    assert np.allclose(np_(xc), x_true, atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_power_and_lanczos(spd, dtype):
    csr, _, _ = spd[dtype]
    t = tune(csr, dtype, fmt=Format.SSS)
    dense = csr.to_coo().to_dense()
    lam_true = np.max(np.abs(np.linalg.eigvalsh(dense)))
    _, lam = solvers.power_iteration(t.matvec, csr.nrows, iters=200)
    assert lam.dtype == t.dtype
    assert abs(float(lam) - lam_true) / lam_true < 5e-2
    alphas, betas = solvers.lanczos(t.matvec, csr.nrows, iters=60)
    T = np.diag(np_(alphas)) + np.diag(
        np_(betas)[:-1], 1
    ) + np.diag(np_(betas)[:-1], -1)
    ev = np.linalg.eigvalsh(T)
    assert abs(ev.max() - lam_true) / lam_true < 5e-2


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres_general(dtype):
    csr, x_true, b = general_system(400, 1600, 0.3, 6.0, 6, dtype)
    t = tune(csr, dtype, fmt=Format.CSR, reorder=False)
    x, resid, betas = solvers.gmres(
        t.matvec, torch.as_tensor(b), restart=25, outer=4
    )
    assert float(resid) < 1e-3 * np.linalg.norm(b)
    assert np.allclose(np_(x), x_true, atol=5e-3)
    assert betas[-1] < betas[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_jacobi_beats_cg_on_illconditioned(dtype):
    """Jacobi-PCG on a badly scaled SPD system converges faster."""
    rng = np.random.default_rng(11)
    n = 800
    scale = 10.0 ** rng.uniform(-2, 2, n)  # wild row scaling
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    offs = np.tile(np.arange(1, 4, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    off_v = rng.uniform(-0.5, 0.5, keep.sum()) * np.sqrt(
        scale[rows[keep]] * scale[cols[keep]]
    )
    v = np.concatenate([off_v, 7.0 * scale])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32),
            v.astype(np.float64), symmetric=True).canonicalize()
    )
    t = tune(csr, dtype, fmt=Format.SSS)
    _, diag, _ = csr.split_triangle()
    x_true = rng.uniform(-1, 1, n).astype(dtype)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(dtype)
    _, r_plain, _ = solvers.cg(t.matvec, torch.as_tensor(b), iters=40)
    xp, r_pcg, _ = solvers.cg(
        t.matvec, torch.as_tensor(b), iters=40,
        diag_precond=diag.astype(dtype),
    )
    assert float(r_pcg) < float(r_plain)
    assert np.allclose(np_(xp), x_true, atol=1e-2)


# -- parity with the reference -------------------------------------------

def both(csr, dtype, fmt, **kw):
    """(reference tuned matrix, port tuned matrix) of one system."""
    return (ref_tune(ref_csr(csr), fmt=RefFormat[fmt.name], dtype=dtype,
                     **kw),
            tune(csr, dtype, fmt=fmt, **kw))


def assert_history(h_ref, h_port, dtype):
    h_ref, h_port = np_(h_ref), np_(h_port)
    assert h_ref.shape == h_port.shape
    live = np.abs(h_ref) > 1e-4 * abs(h_ref[0])
    assert live.sum() >= 2
    rel = np.abs(h_port[live] / h_ref[live] - 1).max()
    assert rel <= HIST_TOL[dtype], rel


def assert_x(x_ref, x_port, dtype):
    x_ref, x_port = np_(x_ref), np_(x_port)
    assert x_port.dtype == dtype
    err = np.abs(x_port - x_ref).max() / np.abs(x_ref).max()
    assert err <= HIST_TOL[dtype], err


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_parity(spd, dtype):
    csr, _, b = spd[dtype]
    rt, pt = both(csr, dtype, Format.SSS)
    _, diag, _ = csr.split_triangle()
    for pre in (None, diag.astype(dtype)):
        xr, rr, hr = ref_solvers.cg(
            rt.matvec, jnp.asarray(b), iters=40,
            diag_precond=None if pre is None else jnp.asarray(pre))
        xp, rp, hp = solvers.cg(pt.matvec, b, iters=40, diag_precond=pre)
        assert_history(hr, hp, dtype)
        assert_x(xr, xp, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_parity(dtype):
    csr, _, b = general_system(500, 2500, 0.2, 8.0, 1, dtype)
    rt, pt = both(csr, dtype, Format.CSR, reorder=False)
    xr, _, hr = ref_solvers.bicgstab(rt.matvec, jnp.asarray(b), iters=30)
    xp, _, hp = solvers.bicgstab(pt.matvec, b, iters=30)
    assert_history(hr, hp, dtype)
    assert_x(xr, xp, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_chebyshev_parity(spd, dtype):
    csr, _, b = spd[dtype]
    rt, pt = both(csr, dtype, Format.SSS)
    _, diag, _ = csr.split_triangle()
    d = diag.astype(dtype)
    xr, hr = ref_solvers.jacobi(rt.matvec, jnp.asarray(d), jnp.asarray(b),
                                iters=60, omega=0.9)
    xp, hp = solvers.jacobi(pt.matvec, d, b, iters=60, omega=0.9)
    assert_history(hr, hp, dtype)
    assert_x(xr, xp, dtype)
    xr, hr = ref_solvers.chebyshev(rt.matvec, jnp.asarray(b), 1.0, 22.0,
                                   iters=60)
    xp, hp = solvers.chebyshev(pt.matvec, b, 1.0, 22.0, iters=60)
    assert_history(hr, hp, dtype)
    assert_x(xr, xp, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres_parity(dtype):
    # a weaker diagonal and short cycles: each restart gains about three
    # decades, so two of the four per-restart residuals are above 1e-4
    # of the first
    csr, _, b = general_system(400, 1600, 0.3, 3.0, 6, dtype)
    rt, pt = both(csr, dtype, Format.CSR, reorder=False)
    xr, rr, hr = ref_solvers.gmres(rt.matvec, jnp.asarray(b), restart=3,
                                   outer=4)
    xp, rp, hp = solvers.gmres(pt.matvec, b, restart=3, outer=4)
    assert_history(hr, hp, dtype)
    assert_x(xr, xp, dtype)


def separated_spectrum(n=600, seed=4):
    """A symmetric banded matrix whose top eigenvalue (about 40) stands
    far above the rest (under 12), so power iteration and Lanczos
    converge to it from any start vector."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    offs = np.tile(np.arange(1, 4, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    d = np.full(n, 6.0)
    d[n // 2] = 40.0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate([rng.uniform(-1, 1, keep.sum()), d])
    return CSR.from_coo(COO(n, n, r.astype(np.int32), c.astype(np.int32),
                            v, symmetric=True).canonicalize())


def top_ritz(alphas, betas):
    a, b = np_(alphas), np_(betas)
    T = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    return np.linalg.eigvalsh(T).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_power_lanczos_parity(dtype):
    csr = separated_spectrum()
    lam_true = np.linalg.eigvalsh(csr.to_coo().to_dense()).max()
    # the reference's start vectors are float32: its float32 plan
    rt = ref_tune(ref_csr(csr), fmt=RefFormat.SSS, dtype=np.float32)
    pt = tune(csr, dtype, fmt=Format.SSS)
    _, lam_r = ref_solvers.power_iteration(rt.matvec, csr.nrows, iters=200)
    _, lam_p = solvers.power_iteration(pt.matvec, csr.nrows, iters=200)
    ritz_r = top_ritz(*ref_solvers.lanczos(rt.matvec, csr.nrows, iters=40))
    ritz_p = top_ritz(*solvers.lanczos(pt.matvec, csr.nrows, iters=40))
    for port, ref in ((float(lam_p), float(lam_r)), (ritz_p, ritz_r)):
        assert abs(port / ref - 1) <= EIG_TOL[np.float32]
        assert abs(port / lam_true - 1) <= EIG_TOL[dtype]


def test_gmres_zero_rhs_gives_zero():
    """A zero residual is a breakdown of every Arnoldi step; the
    on-device least-squares solve gives y = 0 there (the reference's
    ``lstsq`` gives the least-norm answer, also 0), not NaN."""
    csr, _, _ = general_system(300, 1200, 0.3, 6.0, 2, np.float32)
    t = tune(csr, np.float32, fmt=Format.CSR, reorder=False)
    x, resid, betas = solvers.gmres(t.matvec, np.zeros(300, np.float32),
                                    restart=8, outer=2)
    assert torch.equal(x, torch.zeros(300)) and float(resid) == 0.0
    assert torch.equal(betas, torch.zeros(2))


def test_private_modes_agree_on_cpu(spd):
    """On CPU tensors the public (graph) mode runs the body eagerly: the
    three modes give the same bits."""
    csr, _, b = spd[np.float32]
    t = tune(csr, np.float32, fmt=Format.SSS)
    runs = [solvers.cg(t.matvec, b, iters=20, _mode=m)
            for m in ("graph", "eager", "plain")]
    for other in runs[1:]:
        for a, o in zip(runs[0], other):
            assert torch.equal(a, o)
    with pytest.raises(ValueError, match="_mode"):
        solvers.cg(t.matvec, b, iters=2, _mode="fast")
