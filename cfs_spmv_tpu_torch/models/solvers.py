"""Iterative solvers built on SpDMV — the framework's flagship "models".

Port of ``cfs_spmv_tpu/models/solvers.py``: the same seven solvers, with
the same signatures, fixed trip counts, eps-guarded divides and return
tuples. The reference runs each iteration loop inside one jitted
``lax.scan`` with no host round trip. Here, on the card, the loop body is
captured once into a CUDA graph and the graph is replayed once per
iteration (:func:`_iterate`):

- the state (x, r, p, rs, ...) lives in tensors allocated before the
  capture, which the body updates in place; scalars stay 0-d tensors on
  the device; no ``.item()``, ``float()`` or ``.cpu()`` runs in the loop;
- each history is a tensor allocated before the loop, written at a
  device-side iteration counter that the body advances;
- the replays run under ``torch.cuda.set_sync_debug_mode("error")``, so a
  host sync inside the loop raises; a capture the card refuses raises
  too: there is no eager fallback on a failure.

An operator that says one graph cannot hold its apply (``capturable``
False: a ``parallel/dist.DistSpDMV`` whose shards lie on several cards
of this process, whose copies between cards a capture refuses) is not
captured: its loop runs the same body eagerly on the card, still under
the sync debug mode, with the same spans and the same ``_iterate.loop``
events. The operator decides this before the loop, never a caught
failure.

One iteration is captured (for ``gmres``, one restart cycle, its Arnoldi
steps unrolled), not the whole solve: the capture costs one iteration's
host time whatever ``iters`` is, the graph's memory pool holds one
iteration's temporaries, and a replay's launch (a few microseconds of
host time) is queued while the card runs the previous one, since nothing
in the loop waits for the card.

On CPU tensors the same body runs eagerly. ``_mode`` (``"graph"``, the
default; ``"eager"``: the same body without a graph; ``"plain"``: eager
through the appliers' plain twins) is a private argument for the
comparisons of the tests and the smoke run; no public entry point sets
it.

Like the reference, every solver works in the tuned matrix's internal
(RCM-permuted) space through ``as_pure``'s ``encode``/``decode``; norms
are permutation-invariant. The start vectors of :func:`power_iteration`
and :func:`lanczos` are drawn from a ``torch.Generator`` on the CPU seeded
with ``seed``, in the operator's type, then moved to its device: they
differ from the reference's ``jax.random`` draws (and the float64 route
takes only float64 vectors), so the two agree in their eigenvalue
estimates, not their vectors.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Callable

import torch

from ..utils import trace
from ..utils.timing import _tuned, as_pure, capture, operator_space

__all__ = ["cg", "power_iteration", "bicgstab", "gmres", "jacobi", "chebyshev", "lanczos"]

_MODES = ("graph", "eager", "plain")


class _Operator:
    """The operator a solver applies, in its internal space: the pure
    applier (or, ``plain``, its twins), encode/decode, the type and
    device of its vectors (a bare callable's are ``like``'s), and how its
    loop runs on the card: ``graphed`` (captured and replayed) unless the
    operator's ``capturable`` is False (a ``DistSpDMV`` across several
    cards), where it runs eagerly; ``sync_free`` either way (a host sync
    in the loop raises)."""

    def __init__(self, matvec: Callable, mode: str, like=None):
        if mode not in _MODES:
            raise ValueError(f"_mode must be one of {_MODES}, got {mode!r}")
        fn, ops, self.encode, self.decode = as_pure(matvec)
        self.dtype, self.device = operator_space(matvec, like)
        if mode == "plain":
            self.apply = lambda v: fn(ops, v, plain=True)
        else:
            self.apply = lambda v: fn(ops, v)
        self.sync_free = mode == "graph" and self.device.type == "cuda"
        self.graphed = self.sync_free and getattr(_tuned(matvec),
                                                  "capturable", True)

    def vec(self, v) -> torch.Tensor:
        """``v`` (a tensor or array) as a vector of the operator's type on
        its device, in the internal space."""
        return self.encode(torch.as_tensor(v, dtype=self.dtype,
                                           device=self.device))

    def scalar(self, c: float) -> torch.Tensor:
        return torch.tensor(c, dtype=self.dtype, device=self.device)

    def start(self, n: int, seed: int) -> torch.Tensor:
        """A unit start vector drawn from a CPU generator seeded with
        ``seed``."""
        g = torch.Generator().manual_seed(seed)
        v = torch.randn(n, generator=g, dtype=self.dtype).to(self.device)
        return v / torch.linalg.vector_norm(v)


@contextlib.contextmanager
def _sync_forbidden():
    """A host sync in the enclosed block raises (PyTorch's sync debug
    mode), as nothing in a solver's loop may wait for the card."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _allocs() -> tuple[int, int]:
    """The caching allocator's device allocations and frees so far, over
    every card (0, 0 before CUDA is initialised)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0, 0
    stats = [torch.cuda.memory_stats(i)
             for i in range(torch.cuda.device_count())]
    return (sum(m.get("num_device_alloc", 0) for m in stats),
            sum(m.get("num_device_free", 0) for m in stats))


def _solver(fn):
    """``fn`` as the root span ``cfs.solve`` (attributes ``solver`` and
    ``iters``, a GMRES's restart cycles), whose steps are its children:
    ``cfs.solve.setup``, ``.warmup``, ``.capture``, ``.restore``,
    ``.replay`` and ``.finish``. While recording, the card's allocations
    and frees across the solve add to the counters
    ``cuda.device_allocs`` and ``cuda.device_frees``."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def solve(*args, **kwargs):
        if not trace.is_recording():
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arg = bound.arguments
        allocs, frees = _allocs()
        with trace.span("cfs.solve", solver=fn.__name__,
                        iters=arg.get("iters", arg.get("outer"))):
            out = fn(*args, **kwargs)
        allocs_end, frees_end = _allocs()
        trace.count("cuda.device_allocs", allocs_end - allocs)
        trace.count("cuda.device_frees", frees_end - frees)
        return out

    return solve


def _iterate(op: _Operator, body: Callable, state: list, iters: int) -> None:
    """Run ``body(k)`` ``iters`` times, ``k`` a (1,) int64 device tensor
    holding the iteration's index (for the histories), advanced after
    each call. ``body`` updates the tensors of ``state`` in place.

    Graphed: one call is captured after a warm-up call (which builds the
    kernels, and whose effect on ``state`` is undone), then replayed
    ``iters`` times under the sync debug mode; the replays add to the
    counter ``solve.replays``. Eager on the card (``op.sync_free`` but not
    ``op.graphed``): ``iters`` calls under the sync debug mode.
    ``_iterate.loop`` holds the CUDA events around the last loop on the
    card (on the current stream) and its iteration count."""
    with trace.span("cfs.solve.setup", step="iterate"):
        k = torch.zeros(1, dtype=torch.int64, device=op.device)
        saved = [t.clone() for t in state] if op.graphed else None

    def step():
        body(k)
        k.add_(1)

    run = step
    if op.graphed:
        graph = capture(step, prefix="cfs.solve")
        with trace.span("cfs.solve.restore"):
            for t, s in zip(state, saved):
                t.copy_(s)
            k.zero_()
        run = graph.replay
        trace.count("solve.replays", iters)
    guard = _sync_forbidden() if op.sync_free else contextlib.nullcontext()
    with trace.span("cfs.solve.replay", graphed=op.graphed):
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if op.device.type == "cuda" else None)
        with guard:
            if events:
                events[0].record()
            for _ in range(iters):
                run()
            if events:
                events[1].record()
                _iterate.loop = (*events, iters)


#: (start event, end event, iterations) of the last loop on the card
_iterate.loop = None


def _guard(v: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``v`` where ``|v| > eps``, else ``eps``: the reference's guarded
    divisor."""
    return torch.where(v.abs() > eps, v, eps)


@_solver
def cg(
    matvec: Callable,
    b,
    *,
    iters: int = 50,
    x0=None,
    diag_precond=None,
    _mode: str = "graph",
):
    """Fixed-iteration (optionally Jacobi-preconditioned) Conjugate
    Gradient for SPD systems.

    The fixed trip count keeps the loop free of data-dependent control
    flow (no host sync); the residual norm is returned for convergence
    checks. ``diag_precond`` is the matrix diagonal in USER ordering;
    when given, the iteration solves M^{-1}A x = M^{-1}b with M = diag(A).
    Returns (x, final residual norm, residual norm history).
    """
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode, b)
        b = op.vec(b)
        x = torch.zeros_like(b) if x0 is None else op.vec(x0).clone()
        minv = 1.0 / op.vec(diag_precond) if diag_precond is not None else None
        r = b - op.apply(x)
        z = r * minv if minv is not None else r
        p = z.clone()
        rs = torch.dot(r, z)
        eps = op.scalar(1e-30)
        hist = b.new_empty(iters)

    def body(k):
        Ap = op.apply(p)
        # eps-guarded divides: with a fixed trip count the iteration may
        # run past full convergence, where rs -> 0 gives 0/0
        alpha = rs / _guard(torch.dot(p, Ap), eps)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        z = r * minv if minv is not None else r
        rs_new = torch.dot(r, z)
        p.mul_(rs_new / _guard(rs, eps)).add_(z)
        rs.copy_(rs_new)
        hist.index_copy_(0, k, torch.dot(r, r).reshape(1))

    _iterate(op, body, [x, r, p, rs], iters)
    with trace.span("cfs.solve.finish"):
        return op.decode(x), torch.linalg.vector_norm(r), hist.sqrt()


@_solver
def power_iteration(matvec: Callable, n: int, *, iters: int = 100,
                    seed: int = 0, _mode: str = "graph"):
    """Dominant eigenvalue via power iteration (spectral-norm model).
    Returns (the last iterate, the last norm estimate)."""
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode)
        v = op.start(n, seed)
        nrms = v.new_empty(iters)

    def body(k):
        w = op.apply(v)
        nrm = torch.linalg.vector_norm(w)
        v.copy_(w / nrm)
        nrms.index_copy_(0, k, nrm.reshape(1))

    _iterate(op, body, [v], iters)
    with trace.span("cfs.solve.finish"):
        return op.decode(v), nrms[-1]


@_solver
def bicgstab(
    matvec: Callable,
    b,
    *,
    iters: int = 50,
    x0=None,
    _mode: str = "graph",
):
    """Fixed-iteration BiCGSTAB for general (non-SPD) systems.

    Complements :func:`cg` the way the reference's general CSR kernels
    complement its symmetric ones. Static trip count; breakdown-guarded
    with ``torch.where`` (no data-dependent branches). Returns (x, final
    residual norm, residual norm history).
    """
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode, b)
        b = op.vec(b)
        x = torch.zeros_like(b) if x0 is None else op.vec(x0).clone()
        eps = op.scalar(1e-30)
        r = b - op.apply(x)
        rhat = r.clone()
        rho = torch.dot(rhat, r)
        p = r.clone()
        hist = b.new_empty(iters)

    def body(k):
        v = op.apply(p)
        alpha = rho / _guard(torch.dot(rhat, v), eps)
        s = r - alpha * v
        t = op.apply(s)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / torch.where(tt > eps, tt, eps)
        x.add_(alpha * p).add_(omega * s)
        r.copy_(s - omega * t)
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / _guard(rho, eps)) * (alpha / _guard(omega, eps))
        p.copy_(r + beta * (p - omega * v))
        rho.copy_(rho_new)
        hist.index_copy_(0, k, torch.dot(r, r).sqrt().reshape(1))

    _iterate(op, body, [x, r, p, rho], iters)
    with trace.span("cfs.solve.finish"):
        return op.decode(x), torch.dot(r, r).sqrt(), hist


@_solver
def jacobi(
    matvec: Callable,
    diag,
    b,
    *,
    iters: int = 100,
    omega: float = 1.0,
    _mode: str = "graph",
):
    """(Weighted) Jacobi relaxation — the classic SpMV-per-step smoother.

    ``diag`` is the matrix diagonal in USER ordering (encoded inside).
    Returns (x, residual norm history).
    """
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode, b)
        b = op.vec(b)
        dinv = omega / op.vec(diag)
        x = torch.zeros_like(b)
        hist = b.new_empty(iters)

    def body(k):
        r = b - op.apply(x)
        x.add_(dinv * r)
        hist.index_copy_(0, k, torch.linalg.vector_norm(r).reshape(1))

    _iterate(op, body, [x], iters)
    with trace.span("cfs.solve.finish"):
        return op.decode(x), hist


@_solver
def chebyshev(
    matvec: Callable,
    b,
    lam_min: float,
    lam_max: float,
    *,
    iters: int = 50,
    _mode: str = "graph",
):
    """Chebyshev iteration for SPD systems with known spectral bounds —
    inner-product-free (no collectives beyond the SpMV), which makes it
    the preferred distributed smoother. Returns (x, residual norm
    history)."""
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode, b)
        b = op.vec(b)
        theta = (lam_max + lam_min) / 2.0
        delta = (lam_max - lam_min) / 2.0
        sigma = theta / delta
        x = torch.zeros_like(b)
        r = b.clone()
        d = r / theta
        rho = op.scalar(1.0 / sigma)
        hist = b.new_empty(iters)

    def body(k):
        x.add_(d)
        r.sub_(op.apply(d))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d.copy_(rho_new * rho * d + 2.0 * rho_new / delta * r)
        rho.copy_(rho_new)
        hist.index_copy_(0, k, torch.linalg.vector_norm(r).reshape(1))

    _iterate(op, body, [x, r, d, rho], iters)
    with trace.span("cfs.solve.finish"):
        return op.decode(x), hist


@_solver
def lanczos(
    matvec: Callable,
    n: int,
    *,
    iters: int = 64,
    seed: int = 0,
    _mode: str = "graph",
):
    """Lanczos tridiagonalization: extremal-eigenvalue estimates of a
    symmetric operator (condition-number model feeding chebyshev/cg).

    Returns (alphas, betas) of the tridiagonal T_k; eigvals(T_k)
    approximate the operator's extremal spectrum.
    """
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode)
        v = op.start(n, seed)
        v_prev = torch.zeros_like(v)
        beta = op.scalar(0.0)
        tiny = op.scalar(1e-30)
        alphas = v.new_empty(iters)
        betas = v.new_empty(iters)

    def body(k):
        w = op.apply(v) - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta_new = torch.linalg.vector_norm(w)
        v_prev.copy_(v)
        v.copy_(w / torch.where(beta_new > tiny, beta_new, 1.0))
        beta.copy_(beta_new)
        alphas.index_copy_(0, k, alpha.reshape(1))
        betas.index_copy_(0, k, beta_new.reshape(1))

    _iterate(op, body, [v, v_prev, beta], iters)
    with trace.span("cfs.solve.finish"):
        return alphas, betas


def _hessenberg_lstsq(H: torch.Tensor, beta: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """y minimising ||beta e1 - H y|| for the (m+1, m) upper Hessenberg
    H: Givens rotations reduce [H | beta e1] to upper triangular form,
    then back substitution, all on the device (no host sync; the
    reference calls ``jnp.linalg.lstsq``). A rotation whose pair is all
    below ``eps`` is the identity, and a pivot below ``eps`` gives 0, so
    a breakdown (a zero residual) yields y = 0, the least-norm answer
    the reference's ``lstsq`` gives there."""
    m = H.shape[1]
    R = torch.cat([H, torch.zeros_like(H[:, :1])], dim=1)
    R[0, m] = beta
    one = torch.ones_like(beta)
    for i in range(m):
        pair = R[i: i + 2, i]
        rad = torch.linalg.vector_norm(pair)
        ok = rad > eps
        c = torch.where(ok, pair[0] / torch.where(ok, rad, one), one)
        s = torch.where(ok, pair[1] / torch.where(ok, rad, one), 0 * one)
        G = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
        R[i: i + 2] = G @ R[i: i + 2]
    y = torch.zeros_like(R[:m, 0])
    for i in reversed(range(m)):
        piv = R[i, i]
        ok = piv.abs() > eps
        y[i] = torch.where(ok, (R[i, m] - torch.dot(R[i, :m], y))
                           / torch.where(ok, piv, one), 0 * one)
    return y


@_solver
def gmres(
    matvec: Callable,
    b,
    *,
    restart: int = 32,
    outer: int = 8,
    x0=None,
    _mode: str = "graph",
):
    """Restarted GMRES(m) for general systems.

    Fixed inner dimension and outer count keep every shape static; the
    Arnoldi recurrence runs over the Krylov index with the basis kept
    (classical Gram-Schmidt with one re-orthogonalization pass, CGS2),
    and the (m+1, m) least-squares solve stays on the device (Givens
    rotations, :func:`_hessenberg_lstsq`). One restart cycle is the unit
    replayed. Returns (x, final residual norm, per-restart residuals).
    """
    with trace.span("cfs.solve.setup"):
        op = _Operator(matvec, _mode, b)
        b = op.vec(b)
        x = torch.zeros_like(b) if x0 is None else op.vec(x0).clone()
        m = restart
        n = b.shape[0]
        eps = op.scalar(1e-30)
        V = b.new_zeros((m + 1, n))
        H = b.new_zeros((m + 1, m))
        betas = b.new_empty(outer)

    def cycle(k):
        r = b - op.apply(x)
        beta = torch.linalg.vector_norm(r)
        V.zero_()
        V[0] = r / torch.where(beta > eps, beta, 1.0)
        H.zero_()
        for j in range(m):
            w = op.apply(V[j])
            hcol = V @ w  # rows beyond j are zero, so they contribute 0
            w = w - V.T @ hcol
            # CGS2: one re-orthogonalization pass restores the stability
            # classical Gram-Schmidt loses in finite precision ("twice is
            # enough", Giraud et al.) at the cost of one extra GEMV pair
            hcol2 = V @ w
            w = w - V.T @ hcol2
            hcol = hcol + hcol2
            hj1 = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.where(hj1 > eps, hj1, 1.0)
            H[:, j] = hcol
            H[j + 1, j] = hj1
        y = _hessenberg_lstsq(H, beta, eps)
        x.add_(V[:m].T @ y)
        betas.index_copy_(0, k, beta.reshape(1))

    _iterate(op, cycle, [x], outer)
    with trace.span("cfs.solve.finish"):
        r = b - op.apply(x)
        return op.decode(x), torch.linalg.vector_norm(r), betas
