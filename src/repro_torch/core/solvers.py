"""Krylov linear solvers driven by fast matvecs (paper Sections 4, 6.2.3, 6.3).

PyTorch counterpart of the forward solvers of ``repro.core.solvers``:
Conjugate Gradients (Hestenes–Stiefel) and MINRES (Paige–Saunders), both
matrix-free, for

    (I + beta L_s) u = f        (kernel SSL, Eq. 6.4)
    (K + beta I) alpha = f      (kernel ridge regression, Section 6.3).

Batched right-hand sides ``b`` of shape (n, C) run C *independent*
recurrences in lockstep: per-column step sizes, per-column tolerances
(``tol * max(||b_c||, 1)``) and per-column masks that freeze a column once
it converges while the others go on.  The matvec is applied once per
iteration to the whole (n, C) block.

Guards, as in the JAX package: a non-finite right-hand-side column is
quarantined before the loop; a column whose iterate goes non-finite
mid-solve reverts to its last finite iterate and is frozen; a column whose
residual stops improving for ``stall_window`` iterations is frozen as
stagnated.  Every solve recomputes the true residual ``||b - A x||`` per
column at exit, so ``residual_norm`` / ``converged`` describe the returned
iterate.

Both solvers are resumable machines (:func:`cg_machine`,
:func:`minres_machine`): the complete loop state is a NamedTuple of tensors
(:class:`CGLoopState`, :class:`MinresLoopState`), and ``while
cond(s): s = body(s)`` then ``finish(s)`` is the solver.  :func:`cg` and
:func:`minres` run exactly that; the durable drivers
(:mod:`repro_torch.runtime.durable`) run the same body in bounded segments
with snapshots in between.  A plain Python loop takes the place of
``lax.while_loop``; ``cond`` reads one boolean from the device per
iteration.

:func:`cg` is differentiable by the implicit function theorem
(``implicit_diff=True``, the default): the loop runs without a graph, and
the solution it returns is ``x* + S(b - A x*)``, where the residual is the
exit residual every solve computes anyway (now with the graph, at no extra
matvec) and ``S`` is zero forward; backward, ``S`` solves ``A w = x̄`` by
the same CG, so ``b̄ = w`` and every tensor the matvec closes over gets
``−∂⟨w, A x*⟩``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]

# A column "improves" only when its residual beats its best-so-far by this
# relative margin; anything smaller feeds the stagnation counter.
_STALL_RTOL = 1e-3


class SolveHealth(NamedTuple):
    """Per-column solver guard flags (shapes mirror ``converged``).

    ``rhs_nonfinite``: the right-hand side (or ``x0``) held NaN/Inf; the
    column was quarantined before the first iteration and ``x`` is 0 for
    it.  ``nonfinite``: the iterate went non-finite mid-solve; ``x`` is the
    last finite iterate.  ``stagnated``: the residual stopped improving for
    ``stall_window`` iterations.  ``breakdown_iter``: the iteration at
    which ``nonfinite`` tripped, -1 if never.
    """

    rhs_nonfinite: torch.Tensor
    nonfinite: torch.Tensor
    stagnated: torch.Tensor
    breakdown_iter: torch.Tensor

    @property
    def any_fault(self) -> torch.Tensor:
        return self.rhs_nonfinite | self.nonfinite | self.stagnated


class SolveResult(NamedTuple):
    x: torch.Tensor
    num_iters: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    health: SolveHealth | None = None


def _col_norms(v: torch.Tensor) -> torch.Tensor:
    """Per-column 2-norms of (n, C) -> (C,); complex-safe (|v|^2)."""
    return torch.sqrt(torch.real(v * torch.conj(v)).sum(dim=0))


def _col_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column <u, v> (conjugating, real part) of (n, C) -> (C,)."""
    return torch.real((torch.conj(u) * v).sum(dim=0))


def _as_columns(matvec: Matvec, b, x0, preconditioner):
    """Normalize a (n,)- or (n, C)-shaped solve to the (n, C) layout."""
    if b.ndim == 2:
        return matvec, b, x0, preconditioner, True
    mv = lambda u: matvec(u[:, 0])[:, None]
    pc = None if preconditioner is None \
        else (lambda u: preconditioner(u[:, 0])[:, None])
    return mv, b[:, None], None if x0 is None else x0[:, None], pc, False


def _validate_rhs(b: torch.Tensor, x0: torch.Tensor | None):
    """Quarantine non-finite rhs / x0 columns before the loop: they get a
    zero rhs (and start), so they never enter the active set."""
    rhs_bad = ~torch.isfinite(b).all(dim=0)  # (C,)
    if x0 is not None:
        rhs_bad = rhs_bad | ~torch.isfinite(x0).all(dim=0)
        x0 = torch.where(rhs_bad[None, :], 0.0, x0)
    return rhs_bad, torch.where(rhs_bad[None, :], 0.0, b), x0


def _finish(matvec: Matvec, b: torch.Tensor, x: torch.Tensor,
            tol_abs: torch.Tensor, iters: torch.Tensor,
            rhs_bad: torch.Tensor, poisoned: torch.Tensor,
            stalled: torch.Tensor, bad_iter: torch.Tensor,
            batched: bool, adjoint_solve: Matvec | None = None
            ) -> SolveResult:
    """Shared exit: one more matvec for the true residual, and the health
    flags.  Quarantined or non-finite columns report ``inf``.

    With ``adjoint_solve`` (implicit differentiation) the residual keeps
    its graph to ``b`` and to what the matvec closes over, and where it has
    one, ``x`` becomes ``x + S(residual)`` (:class:`_ImplicitSolve`)."""
    r = b - matvec(x)
    res = _col_norms(r.detach())
    res = torch.where(rhs_bad | ~torch.isfinite(res), torch.inf, res)
    health = SolveHealth(rhs_nonfinite=rhs_bad, nonfinite=poisoned,
                         stagnated=stalled, breakdown_iter=bad_iter)
    if adjoint_solve is not None and r.requires_grad:
        x = x + _ImplicitSolve.apply(r, adjoint_solve, ~health.any_fault)
    out = SolveResult(x=x, num_iters=iters, residual_norm=res,
                      converged=res <= tol_abs, health=health)
    if batched:
        return out
    return SolveResult(x=out.x[:, 0], num_iters=out.num_iters[0],
                       residual_norm=out.residual_norm[0],
                       converged=out.converged[0],
                       health=SolveHealth(*(f[0] for f in health)))


class _ImplicitSolve(torch.autograd.Function):
    """``S(r)``: zero forward, so ``x* + S(b - A x*)`` is the solve's own
    iterate, bit for bit.  Backward: ``w = A^{-1} x̄`` by ``solve``, with
    the cotangents of faulted columns (``keep`` False) and non-finite
    entries set to exactly 0; ``w`` is the residual's cotangent, whence
    ``b̄ = w`` and ``θ̄ = −∂θ⟨w, A(θ) x*⟩`` (implicit function theorem)."""

    @staticmethod
    def forward(ctx, r, solve, keep):
        ctx.solve, ctx.keep = solve, keep
        return torch.zeros_like(r)

    @staticmethod
    def backward(ctx, x_bar):
        keep = ctx.keep.to(x_bar.dtype)
        x_bar = torch.where(torch.isfinite(x_bar), x_bar, 0.0) * keep
        w = ctx.solve(x_bar)
        return torch.where(torch.isfinite(w), w, 0.0) * keep, None, None


def cg(matvec: Matvec, b: torch.Tensor, *, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxiter: int = 1000,
       preconditioner: Matvec | None = None,
       stall_window: int = 250, implicit_diff: bool = True) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    ``b`` (n,): scalar result fields.  ``b`` (n, C): per-column recurrences
    in lockstep; ``x`` (n, C) and ``num_iters`` / ``residual_norm`` /
    ``converged`` (C,).  ``stall_window`` > 0 freezes a column whose
    residual fails to improve (by a relative 1e-3) for that many
    consecutive iterations; 0 disables it.  Guard flags land in
    ``result.health``.

    ``implicit_diff=True`` (the default): ``x`` is differentiable by the
    implicit function theorem, not by unrolling the loop, which runs
    without a graph.  The backward solves ``A w = x̄`` by CG on the same
    operator, with the same tolerance, preconditioner and guards, giving
    ``b̄ = w`` and, for every tensor the matvec closes over (a kernel
    parameter, a shift), ``θ̄ = −∂θ⟨w, A(θ) x*⟩``.  Only ``x`` is
    differentiable, not ``x0`` nor the diagnostics; faulted columns
    (``health.any_fault``) get exactly zero cotangents.  ``A`` must be
    symmetric.  ``implicit_diff=False`` is the plain recurrence (autograd
    through every iteration).
    """
    matvec, b, x0, preconditioner, batched = _as_columns(
        matvec, b, x0, preconditioner)
    rhs_bad, b, x0 = _validate_rhs(b, x0)
    loop = torch.no_grad() if implicit_diff else contextlib.nullcontext()
    with loop:
        s = run_machine(_cg_columns(matvec, b, x0, rhs_bad, batched, tol,
                                    maxiter, preconditioner, stall_window))

    def adjoint_solve(rhs):  # A w = rhs, as the forward solve
        with torch.no_grad():
            rhs_ok = torch.zeros(rhs.shape[1:], dtype=torch.bool,
                                 device=rhs.device)
            return run_machine(_cg_columns(
                matvec, rhs, None, rhs_ok, True, tol, maxiter,
                preconditioner, stall_window)).x

    # b keeps its graph here (the loop's state holds it detached)
    return _finish(matvec, b, s.x, s.tol_abs, s.iters, rhs_bad, s.poisoned,
                   s.stalled, s.bad, batched,
                   adjoint_solve if implicit_diff else None)


class CGLoopState(NamedTuple):
    """The complete CG loop state: a checkpointable tuple of tensors.

    The loop body is a function of this state alone (the matvec is supplied
    again on a restart), so snapshotting it mid-solve and resuming gives
    the trajectory of an uninterrupted run.  ``b`` / ``tol_abs`` /
    ``rhs_bad`` ride along so the exit needs only the state and the
    matvec.
    """

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    iters: torch.Tensor
    best: torch.Tensor      # best residual so far (stagnation reference)
    stall: torch.Tensor     # consecutive non-improving iterations
    poisoned: torch.Tensor  # SolveHealth.nonfinite accumulator
    stalled: torch.Tensor   # SolveHealth.stagnated accumulator
    bad: torch.Tensor       # SolveHealth.breakdown_iter accumulator
    i: torch.Tensor         # global iteration counter (0-d int32)
    b: torch.Tensor         # validated right-hand side
    tol_abs: torch.Tensor
    rhs_bad: torch.Tensor


class KrylovMachine(NamedTuple):
    """A Krylov solve in resumable form: ``state`` and ``cond`` / ``body``
    / ``finish``.

    ``while cond(s): s = body(s)`` followed by ``finish(s)`` is the solver
    (:func:`run_machine`; :func:`cg` and :func:`minres` run exactly this).
    ``cond`` returns a 0-d bool tensor.  A driver may run the loop in
    bounded segments and snapshot the state between them
    (:mod:`repro_torch.runtime.durable`); the trajectory is the same.
    """

    state: NamedTuple
    cond: Callable
    body: Callable
    finish: Callable


def run_machine(machine: KrylovMachine):
    """Run ``machine`` from its initial state until its condition fails;
    returns the final state (one host read an iteration)."""
    s = machine.state
    while bool(machine.cond(s)):
        s = machine.body(s)
    return s


def _guard_state(resn0: torch.Tensor) -> dict:
    """The per-column guard fields of a fresh loop state."""
    dev = resn0.device
    return dict(
        iters=torch.zeros(resn0.shape, dtype=torch.int32, device=dev),
        best=resn0,
        stall=torch.zeros(resn0.shape, dtype=torch.int32, device=dev),
        poisoned=torch.zeros(resn0.shape, dtype=torch.bool, device=dev),
        stalled=torch.zeros(resn0.shape, dtype=torch.bool, device=dev),
        bad=torch.full(resn0.shape, -1, dtype=torch.int32, device=dev),
        i=torch.zeros((), dtype=torch.int32, device=dev))


def _guard_step(s, active: torch.Tensor, ok: torch.Tensor,
                resn_of, stall_window: int) -> tuple:
    """Non-finite revert and stagnation, shared by both solvers.

    Returns ``(upd, guard fields of the next state)``; ``resn_of(upd)`` is
    the residual measure after the step (stagnation watches it)."""
    trip = active & ~ok
    poisoned = s.poisoned | trip
    bad = torch.where(trip & (s.bad < 0), s.i, s.bad)
    upd = active & ok
    resn = resn_of(upd)
    improved = resn < s.best * (1.0 - _STALL_RTOL)
    best = torch.minimum(s.best, resn)
    stall = torch.where(upd & ~improved, s.stall + 1, 0).to(torch.int32)
    stalled = s.stalled
    if stall_window:
        stalled = stalled | (stall >= stall_window)
    return upd, dict(iters=s.iters + active.to(torch.int32), best=best,
                     stall=stall, poisoned=poisoned, stalled=stalled,
                     bad=bad, i=s.i + 1)


def cg_machine(matvec: Matvec, b: torch.Tensor, *,
               x0: torch.Tensor | None = None, tol: float = 1e-8,
               maxiter: int = 1000, preconditioner: Matvec | None = None,
               stall_window: int = 250) -> KrylovMachine:
    """CG as a resumable machine (state: :class:`CGLoopState`)."""
    matvec, b, x0, preconditioner, batched = _as_columns(
        matvec, b, x0, preconditioner)
    rhs_bad, b, x0 = _validate_rhs(b, x0)
    return _cg_columns(matvec, b, x0, rhs_bad, batched, tol, maxiter,
                       preconditioner, stall_window)


def _cg_columns(matvec, b, x0, rhs_bad, batched, tol, maxiter,
                preconditioner, stall_window) -> KrylovMachine:
    """The CG machine on validated (n, C) columns."""
    if x0 is None:
        x, r = torch.zeros_like(b), b  # r0 = b - A·0: no matvec
    else:
        x, r = x0, b - matvec(x0)
    z = preconditioner(r) if preconditioner is not None else r
    state0 = CGLoopState(
        x=x, r=r, z=z, p=z, rz=_col_dot(r, z),
        **_guard_state(_col_norms(r)), b=b,
        tol_abs=tol * torch.clamp(_col_norms(b), min=1.0), rhs_bad=rhs_bad)

    def cond(s: CGLoopState) -> torch.Tensor:
        alive = (_col_norms(s.r) > s.tol_abs) & ~s.poisoned & ~s.stalled
        return (s.i < maxiter) & alive.any()

    def body(s: CGLoopState) -> CGLoopState:
        x, r, z, p, rz = s.x, s.r, s.z, s.p, s.rz
        active = (_col_norms(r) > s.tol_abs) & ~s.poisoned & ~s.stalled
        ap = matvec(p)
        denom = _col_dot(p, ap)
        alpha = rz / torch.where(denom != 0, denom, 1.0)
        alpha = torch.where(active, alpha, 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = preconditioner(r_new) if preconditioner is not None else r_new
        rz_new = _col_dot(r_new, z_new)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p_new = z_new + beta * p
        # quarantine: a column whose update went non-finite keeps its last
        # finite state and leaves the active set for good
        ok = (torch.isfinite(x_new).all(dim=0)
              & torch.isfinite(r_new).all(dim=0)
              & torch.isfinite(p_new).all(dim=0))
        upd, guard = _guard_step(
            s, active, ok,
            lambda u: _col_norms(torch.where(u[None, :], r_new, r)),
            stall_window)
        sel = lambda new, old: torch.where(upd[None, :], new, old)
        return CGLoopState(
            x=sel(x_new, x), r=sel(r_new, r), z=sel(z_new, z),
            p=sel(p_new, p), rz=torch.where(upd, rz_new, rz), **guard,
            b=s.b, tol_abs=s.tol_abs, rhs_bad=s.rhs_bad)

    def finish(s: CGLoopState) -> SolveResult:
        return _finish(matvec, s.b, s.x, s.tol_abs, s.iters, s.rhs_bad,
                       s.poisoned, s.stalled, s.bad, batched)

    return KrylovMachine(state=state0, cond=cond, body=body, finish=finish)


class MinresLoopState(NamedTuple):
    """The complete MINRES loop state (see :class:`CGLoopState`)."""

    x: torch.Tensor
    v: torch.Tensor
    v_prev: torch.Tensor
    w: torch.Tensor
    w_prev: torch.Tensor
    phi_bar: torch.Tensor
    delta1: torch.Tensor
    eps_k: torch.Tensor
    cs: torch.Tensor
    sn: torch.Tensor
    beta: torch.Tensor
    iters: torch.Tensor
    best: torch.Tensor
    stall: torch.Tensor
    poisoned: torch.Tensor
    stalled: torch.Tensor
    bad: torch.Tensor
    i: torch.Tensor
    b: torch.Tensor
    tol_abs: torch.Tensor
    rhs_bad: torch.Tensor


def minres_machine(matvec: Matvec, b: torch.Tensor, *,
                   x0: torch.Tensor | None = None, tol: float = 1e-8,
                   maxiter: int = 1000,
                   stall_window: int = 250) -> KrylovMachine:
    """MINRES as a resumable machine (state: :class:`MinresLoopState`)."""
    matvec, b, x0, _, batched = _as_columns(matvec, b, x0, None)
    rhs_bad, b, x0 = _validate_rhs(b, x0)
    if x0 is None:
        x, r = torch.zeros_like(b), b  # r0 = b - A·0 (matvec elided)
    else:
        x, r = x0, b - matvec(x0)
    beta1 = _col_norms(r)
    dtype = b.dtype
    eps = torch.finfo(dtype).tiny
    # Lanczos + Givens QR recurrences, one per column
    state0 = MinresLoopState(
        x=x, v=r / torch.clamp(beta1, min=eps), v_prev=torch.zeros_like(b),
        w=torch.zeros_like(b), w_prev=torch.zeros_like(b), phi_bar=beta1,
        delta1=torch.zeros_like(beta1), eps_k=torch.zeros_like(beta1),
        cs=-torch.ones_like(beta1), sn=torch.zeros_like(beta1), beta=beta1,
        **_guard_state(beta1),  # stagnation watches |phi_bar|
        b=b, tol_abs=tol * torch.clamp(_col_norms(b), min=1.0),
        rhs_bad=rhs_bad)

    def cond(s: MinresLoopState) -> torch.Tensor:
        alive = (s.phi_bar.abs() > s.tol_abs) & ~s.poisoned & ~s.stalled
        return (s.i < maxiter) & alive.any()

    def body(s: MinresLoopState) -> MinresLoopState:
        x, v, v_prev, w, w_prev = s.x, s.v, s.v_prev, s.w, s.w_prev
        phi_bar, delta1, eps_k, cs, sn, beta = (
            s.phi_bar, s.delta1, s.eps_k, s.cs, s.sn, s.beta)
        active = (phi_bar.abs() > s.tol_abs) & ~s.poisoned & ~s.stalled
        av = matvec(v)
        alpha = _col_dot(v, av).to(dtype)
        av = av - alpha * v - beta * v_prev
        beta_new = _col_norms(av)
        v_new = av / torch.clamp(beta_new, min=eps)
        # previous rotation
        delta2 = cs * delta1 + sn * alpha
        gamma1 = sn * delta1 - cs * alpha
        eps_next = sn * beta_new
        delta1_next = -cs * beta_new
        # new rotation
        gamma2 = torch.clamp(torch.sqrt(gamma1 * gamma1 + beta_new * beta_new),
                             min=eps)
        cs_new = gamma1 / gamma2
        sn_new = beta_new / gamma2
        tau = cs_new * phi_bar
        phi_bar_new = sn_new * phi_bar
        w_new = (v - delta2 * w - eps_k * w_prev) / gamma2
        x_new = x + tau * w_new
        # a column takes the step only when active and finite; every other
        # column keeps its whole recurrence state
        ok = (torch.isfinite(x_new).all(dim=0)
              & torch.isfinite(v_new).all(dim=0)
              & torch.isfinite(phi_bar_new))
        upd, guard = _guard_step(
            s, active, ok,
            lambda u: torch.where(u, phi_bar_new, phi_bar).abs(),
            stall_window)
        seln = lambda new, old: torch.where(upd[None, :], new, old)
        selc = lambda new, old: torch.where(upd, new, old)
        return MinresLoopState(
            x=seln(x_new, x), v=seln(v_new, v), v_prev=seln(v, v_prev),
            w=seln(w_new, w), w_prev=seln(w, w_prev),
            phi_bar=selc(phi_bar_new, phi_bar),
            delta1=selc(delta1_next, delta1), eps_k=selc(eps_next, eps_k),
            cs=selc(cs_new, cs), sn=selc(sn_new, sn),
            beta=selc(beta_new, beta), **guard, b=s.b, tol_abs=s.tol_abs,
            rhs_bad=s.rhs_bad)

    def finish(s: MinresLoopState) -> SolveResult:
        return _finish(matvec, s.b, s.x, s.tol_abs, s.iters, s.rhs_bad,
                       s.poisoned, s.stalled, s.bad, batched)

    return KrylovMachine(state=state0, cond=cond, body=body, finish=finish)


def minres(matvec: Matvec, b: torch.Tensor, *,
           x0: torch.Tensor | None = None, tol: float = 1e-8,
           maxiter: int = 1000, stall_window: int = 250) -> SolveResult:
    """MINRES for symmetric (possibly indefinite) operators.

    Batched ``b`` (n, C) runs per-column Lanczos + Givens recurrences in
    lockstep; a frozen column (converged, poisoned or stagnated) stops
    updating its whole recurrence.  Guard flags land in ``result.health``;
    ``stall_window=0`` disables stagnation detection.
    """
    m = minres_machine(matvec, b, x0=x0, tol=tol, maxiter=maxiter,
                       stall_window=stall_window)
    return m.finish(run_machine(m))


# ---------------------------------------------------------------------------
# Lockstep bank solvers: one bank matvec per iteration for S·C systems.
# ---------------------------------------------------------------------------

def _bank_solve(solver, bank_matvec: Matvec, b: torch.Tensor,
                x0: torch.Tensor | None, kwargs) -> SolveResult:
    """Flatten the bank axis into the column axis and run a lockstep solve.

    ``bank_matvec`` maps (S, n, C) -> (S, n, C), operator ``s`` on ``x[s]``
    (e.g. the lockstep flavour of ``FastsumOperatorBank.matvec``).  Every
    (s, c) system gets its own step sizes, tolerance and mask, and each
    iteration costs one bank matvec.
    """
    if b.ndim not in (2, 3):
        raise ValueError(
            f"bank rhs must be (S, n) or (S, n, C), got {tuple(b.shape)}")
    squeeze = b.ndim == 2
    b3 = b[..., None] if squeeze else b
    s, n, c = b3.shape

    def to_flat(v):  # (S, n, C) -> (n, S*C)
        return v.permute(1, 0, 2).reshape(n, s * c)

    def from_flat(v):  # (n, S*C) -> (S, n, C)
        return v.reshape(n, s, c).permute(1, 0, 2)

    x0f = None if x0 is None else to_flat(x0[..., None] if squeeze else x0)
    sol = solver(lambda u: to_flat(bank_matvec(from_flat(u))), to_flat(b3),
                 x0=x0f, **kwargs)
    x = from_flat(sol.x)
    stats = [a.reshape(s, c) for a in
             (sol.num_iters, sol.residual_norm, sol.converged)]
    health = SolveHealth(*(a.reshape(s, c) for a in sol.health))
    if squeeze:
        x = x[..., 0]
        stats = [a[:, 0] for a in stats]
        health = SolveHealth(*(a[:, 0] for a in health))
    return SolveResult(x, *stats, health=health)


def cg_bank(bank_matvec: Matvec, b: torch.Tensor, *,
            x0: torch.Tensor | None = None, tol: float = 1e-8,
            maxiter: int = 1000, stall_window: int = 250) -> SolveResult:
    """Lockstep CG over a bank axis: ``b`` (S, n) or (S, n, C).

    One bank matvec per iteration solves all S·C systems.  Result fields
    mirror the input: ``x`` (S, n[, C]), ``num_iters`` / ``residual_norm``
    / ``converged`` and the ``health`` flags (S[, C]); a poisoned member's
    systems are quarantined without touching its siblings.
    """
    return _bank_solve(cg, bank_matvec, b, x0,
                       dict(tol=tol, maxiter=maxiter,
                            stall_window=stall_window))


def minres_bank(bank_matvec: Matvec, b: torch.Tensor, *,
                x0: torch.Tensor | None = None, tol: float = 1e-8,
                maxiter: int = 1000, stall_window: int = 250) -> SolveResult:
    """Lockstep MINRES over a bank axis (see :func:`cg_bank`)."""
    return _bank_solve(minres, bank_matvec, b, x0,
                       dict(tol=tol, maxiter=maxiter,
                            stall_window=stall_window))
