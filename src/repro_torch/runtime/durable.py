"""Durable execution: preemption-safe Krylov solves with exactly-once replay.

PyTorch counterpart of ``repro.runtime.durable``.  The solvers expose their
complete loop state as a NamedTuple of tensors
(:class:`~repro_torch.core.solvers.CGLoopState`,
:class:`~repro_torch.core.solvers.MinresLoopState`,
:class:`~repro_torch.core.lanczos.LanczosLoopState`,
:class:`~repro_torch.core.lanczos.BlockLanczosLoopState`), and the drivers
here run the loop in bounded segments, snapshotting the state through
:mod:`repro_torch.training.checkpoint` every ``snapshot_every`` iterations.

Contract, as in the JAX package:

* bit-identical trajectories: a segment runs the same body applications
  as the plain loop (a Python loop over ``body`` while ``cond`` holds and
  the segment's limit is not reached), so a run killed at any iteration and
  resumed from its latest snapshot gives the iterates, eigenvalues and
  solutions of an uninterrupted run, bit for bit;
* exactly-once in effect: at most ``snapshot_every`` iterations run again
  on a restart, and they reproduce the originals;
* crash-safe snapshots: atomic rename, per-leaf CRC32 and
  :func:`~repro_torch.training.checkpoint.restore_latest_valid` make a
  snapshot torn by the crash cost one interval, never a wrong answer;
* bounded restart storms: in-process restarts are capped by
  ``max_restarts``, with exponential backoff; a cross-process resume is
  calling the same function again with the same arguments and
  ``ckpt_dir``.

On the card, a body is the same function of its state only if every kernel
it runs gives the same bits twice.  The drivers therefore run under
``torch.use_deterministic_algorithms(True, warn_only=True)``
(:func:`deterministic`), and restore the caller's setting on exit: the
window spread then takes its deterministic mode
(:func:`repro_torch.kernels.nfft_window.window_spread_deterministic`), and
PyTorch's own operations their deterministic implementations (``warn_only``:
cuBLAS's workspace check only warns).  A plain :func:`eigsh` or :func:`cg`
under the same switch runs the same bits.  The gather, ``kernel_matvec``,
cuFFT and the cuBLAS products repeat bit for bit in one stream.

Start vectors: :func:`resumable_eigsh` resolves them through
:func:`~repro_torch.core.lanczos.eigsh_setup`, as ``eigsh`` does, but
draws from a copy of the caller's ``generator``: the call leaves the
generator's state as it found it.  A torch generator advances with every
draw, where the JAX package's key is a value; drawing from a copy keeps the
reference's contract that a resume is calling the same function again with
the same arguments, also for a run killed before its first snapshot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.core import solvers as _solvers
from repro_torch.core.lanczos import (
    BlockLanczosLoopState, EigshResult, LanczosLoopState,
    block_lanczos_machine, eigsh_setup, lanczos_machine, ritz_from_block,
    ritz_from_lanczos, run_steps,
)
from repro_torch.core.solvers import KrylovMachine, SolveResult
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault_tolerance import InjectedFault

log = logging.getLogger("repro_torch.durable")


@dataclasses.dataclass(frozen=True)
class DurablePolicy:
    """Snapshot cadence and restart discipline of the durable drivers.

    ``snapshot_every`` counts operator applications (CG / MINRES / Lanczos
    iterations; block-Lanczos block steps).  ``keep`` snapshots stay on
    disk, so a damaged latest snapshot still has an intact predecessor.
    ``max_restarts`` bounds in-process restart storms; restart ``r``
    sleeps ``backoff_base_s * 2**(r-1)`` (at most ``backoff_max_s``)
    before it restores.
    """

    snapshot_every: int = 25
    keep: int = 2
    max_restarts: int = 10
    backoff_base_s: float = 0.0
    backoff_max_s: float = 30.0


@dataclasses.dataclass
class DurableReport:
    """What the durable driver did for one logical solve.

    ``snapshot_copy_s``: host seconds the driver spent taking its
    snapshots (the state's copy to the host, which waits for the card);
    ``snapshot_write_s``: seconds the writer threads took to write them,
    beside the next segments; ``snapshot_wait_s``: seconds the driver
    waited for writers at a restart and at the end (the part of the writes
    the segments did not hide)."""

    resumed_from: Optional[int]  # snapshot iteration resumed from, or None
    snapshots: int = 0           # snapshots written by this run
    segments: int = 0            # loop segments executed
    restarts: int = 0            # in-process restarts absorbed
    final_iteration: int = 0
    snapshot_copy_s: float = 0.0
    snapshot_write_s: float = 0.0
    snapshot_wait_s: float = 0.0


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    block, and the caller's setting again afterwards."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _clone(state):
    """A copy of a loop state (the Lanczos bodies write in place)."""
    return type(state)(*[t.clone() for t in state])


class _Writers:
    """The snapshot writers of one solve, and the time they took."""

    def __init__(self):
        self.threads = []
        self.wait_s = 0.0

    def add(self, thread) -> None:
        self.threads.append(thread)

    def join(self) -> None:
        t0 = time.perf_counter()
        for t in self.threads:
            t.join()
        self.wait_s += time.perf_counter() - t0

    def seconds(self) -> float:
        return sum(t.seconds for t in self.threads)


def _drive(state0, advance: Callable, done: Callable, ckpt_dir: str,
           policy: DurablePolicy,
           fault_hook: Optional[Callable[[int], None]]):
    """The segment / snapshot / restart loop of both drivers.

    ``advance(state) -> state`` runs one bounded segment; ``done(state)``
    says whether the loop is over; ``fault_hook(iteration)`` is the
    preemption seam (it raises
    :class:`~repro_torch.training.fault_tolerance.InjectedFault` to
    simulate a kill; a real kill is recovered by calling the durable
    function again, which takes the same restore path).
    """
    start, restored = ckpt.restore_latest_valid(ckpt_dir, state0)
    report = DurableReport(resumed_from=start)
    state = _clone(state0) if start is None else restored
    if start is not None:
        log.info("resumed solve from snapshot at iteration %d", start)
    writers = _Writers()
    while True:
        try:
            if fault_hook is not None:
                fault_hook(int(state.i))
            if done(state):
                break
            state = advance(state)
            report.segments += 1
            t0 = time.perf_counter()
            writers.add(ckpt.save_checkpoint(
                ckpt_dir, int(state.i), state, blocking=False,
                keep=policy.keep))
            report.snapshot_copy_s += time.perf_counter() - t0
            report.snapshots += 1
        except InjectedFault as e:
            report.restarts += 1
            writers.join()  # let every in-flight snapshot land
            if report.restarts > policy.max_restarts:
                raise
            if policy.backoff_base_s:
                delay = min(
                    policy.backoff_base_s * 2 ** (report.restarts - 1),
                    policy.backoff_max_s)
                log.warning("preempted (%s); backing off %.3fs before "
                            "restart %d", e, delay, report.restarts)
                time.sleep(delay)
            start, restored = ckpt.restore_latest_valid(ckpt_dir, state0)
            state = _clone(state0) if start is None else restored
    writers.join()
    report.snapshot_write_s = writers.seconds()
    report.snapshot_wait_s = writers.wait_s
    report.final_iteration = int(state.i)
    return state, report


def _resumable_columns(matvec, b, *, ckpt_dir, method, x0, tol, maxiter,
                       preconditioner, stall_window, policy, fault_hook):
    if method == "cg":
        machine = _solvers.cg_machine(
            matvec, b, x0=x0, tol=tol, maxiter=maxiter,
            preconditioner=preconditioner, stall_window=stall_window)
    elif method == "minres":
        if preconditioner is not None:
            raise ValueError("minres does not take a preconditioner")
        machine = _solvers.minres_machine(
            matvec, b, x0=x0, tol=tol, maxiter=maxiter,
            stall_window=stall_window)
    else:
        raise ValueError(f"method must be 'cg' or 'minres', got {method!r}")

    def advance(s):
        # the plain loop's body applications, at most snapshot_every of them
        limit = int(s.i) + policy.snapshot_every
        while bool(machine.cond(s) & (s.i < limit)):
            s = machine.body(s)
        return s

    final, report = _drive(machine.state, advance,
                           lambda s: not bool(machine.cond(s)), ckpt_dir,
                           policy, fault_hook)
    return machine.finish(final), report


def resumable_solve(matvec, b: torch.Tensor, *, ckpt_dir: str,
                    method: str = "cg", bank: bool = False,
                    x0: torch.Tensor | None = None, tol: float = 1e-8,
                    maxiter: int = 1000, preconditioner=None,
                    stall_window: int = 250,
                    policy: DurablePolicy | None = None,
                    fault_hook: Optional[Callable[[int], None]] = None,
                    ) -> tuple[SolveResult, DurableReport]:
    """Preemption-safe :func:`~repro_torch.core.solvers.cg` /
    :func:`~repro_torch.core.solvers.minres` (and their lockstep bank
    flavours).

    Runs the solver's loop in ``policy.snapshot_every``-iteration segments,
    snapshotting the loop state into ``ckpt_dir`` between them, under
    :func:`deterministic`.  Killed and called again (same arguments, same
    ``ckpt_dir``), it resumes from the latest intact snapshot and gives the
    uninterrupted run's trajectory bit for bit.  ``bank=True`` takes ``b``
    as (S, n) / (S, n, C) with a bank matvec, the
    :func:`~repro_torch.core.solvers.cg_bank` layout.  No graph is kept.

    Returns ``(SolveResult, DurableReport)``.  A fresh ``ckpt_dir`` starts
    a new logical solve; a snapshot of another problem's shapes is rejected
    by the checkpoint checks and the solve starts from the beginning.
    """
    policy = policy or DurablePolicy()
    with deterministic(), torch.no_grad():
        if bank:
            cell = {}

            def solver(flat_mv, bflat, x0=None, **kw):
                res, rep = _resumable_columns(
                    flat_mv, bflat, ckpt_dir=ckpt_dir, method=method, x0=x0,
                    preconditioner=preconditioner, policy=policy,
                    fault_hook=fault_hook, **kw)
                cell["report"] = rep
                return res

            sol = _solvers._bank_solve(
                solver, matvec, b, x0,
                dict(tol=tol, maxiter=maxiter, stall_window=stall_window))
            return sol, cell["report"]
        return _resumable_columns(
            matvec, b, ckpt_dir=ckpt_dir, method=method, x0=x0, tol=tol,
            maxiter=maxiter, preconditioner=preconditioner,
            stall_window=stall_window, policy=policy, fault_hook=fault_hook)


def resumable_eigsh(matvec, n: int, k: int, *, ckpt_dir: str,
                    num_iters: int | None = None, which: str = "LA",
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float64, v0=None,
                    block_size: int = 1,
                    device: str | torch.device | None = None,
                    policy: DurablePolicy | None = None,
                    fault_hook: Optional[Callable[[int], None]] = None,
                    ) -> tuple[EigshResult, DurableReport]:
    """Preemption-safe :func:`~repro_torch.core.lanczos.eigsh`.

    The (block) Lanczos factorization runs in snapshot-bounded segments
    under :func:`deterministic`; the Ritz extraction runs once, at the end.
    The start vector comes from :func:`~repro_torch.core.lanczos.eigsh_setup`
    as in ``eigsh``, drawn from a copy of ``generator``'s state: the
    caller's generator is left as it was, so calling again with the same
    arguments resumes the same run (see the module docstring).  Returns
    ``(EigshResult, DurableReport)``.
    """
    policy = policy or DurablePolicy()
    with deterministic(), torch.no_grad():
        state = None if generator is None else generator.get_state()
        try:
            setup = eigsh_setup(n, k, num_iters=num_iters, which=which,
                                generator=generator, dtype=dtype, v0=v0,
                                block_size=block_size, device=device)
        finally:
            if state is not None:
                generator.set_state(state)
        if setup.num_blocks:
            state0, body, finish = block_lanczos_machine(
                matvec, setup.v0, setup.num_blocks)
            total, state_cls = setup.num_blocks, BlockLanczosLoopState
        else:
            state0, body, finish = lanczos_machine(
                matvec, setup.v0, setup.num_iters)
            total, state_cls = setup.num_iters, LanczosLoopState

        def advance(state):
            i0 = int(state.i)
            i1 = min(i0 + policy.snapshot_every, total)
            carry = run_steps(body, tuple(state)[:-1], i0, i1)
            return state_cls(*carry, i=state.i + (i1 - i0))

        final, report = _drive(state0, advance,
                               lambda s: int(s.i) >= total, ckpt_dir,
                               policy, fault_hook)
        res = finish(final)
        if setup.num_blocks:
            return ritz_from_block(res, setup, n), report
        return ritz_from_lanczos(res, setup), report
