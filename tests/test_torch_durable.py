"""Resumable Krylov machines and durable drivers of the PyTorch port.

The port's machines (``cg_machine``, ``minres_machine``,
``lanczos_machine``, ``block_lanczos_machine``) are held against the JAX
package's on tests/test_durable.py's 48 x 48 SPD system with 2 columns and
on a small fastsum operator (the spiral's first two coordinates, n = 300,
SETUP_1, CPU), with numpy start vectors handed to both: iterates, T's
entries and eigenvalues agree within 1e-12 relative to their largest
entry.  Within the port,
segmented runs equal the unsegmented one bit for bit, and every case of
tests/test_durable.py (kill points, MINRES, cross-process resume, the
preemption storm and its cap, a bank, eigsh with block 1 and 4, a foreign
snapshot, an uninterrupted run) gives the plain solver's results bit for
bit.  On the CPU every kernel is the plain version, so bit-identity holds
without the card; ``chip_smoke.py``'s [durable] phase holds it on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import kernels as jkern
from repro.core import solvers as jsol
from repro_torch.core import fastsum as tfs
from repro_torch.core import kernels as tkern
from repro_torch.core import solvers as tsol
from repro_torch.data import synthetic as tsyn
from repro_torch.runtime import (
    DurablePolicy, KillPoint, KillSchedule, Preemption, durable,
    resumable_eigsh, resumable_solve,
)

# the module: ``repro_torch.core`` re-exports the function ``lanczos``
# under its name, as ``repro.core`` does
tlan = importlib.import_module("repro_torch.core.lanczos")

jlan = importlib.import_module("repro.core.lanczos")

pytestmark = pytest.mark.chaos

POLICY = DurablePolicy(snapshot_every=5)
REL = 1e-12  # port vs JAX package, relative to the largest entry


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= REL * scale


def _equal(a, b):
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.fixture(scope="module")
def spd():
    """tests/test_durable.py's system: (A, B) as numpy."""
    rng = np.random.default_rng(0)
    n, c = 48, 2
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n), rng.standard_normal((n, c))


@pytest.fixture(scope="module")
def ops(spd):
    """{name: (port matvec, JAX matvec, rhs)}: the SPD system, and
    I + L_s = 2 I - A of the normalized adjacency of the spiral's first two
    coordinates (n = 300, SETUP_1) with two seeded columns."""
    a, b = spd
    ta, ja = torch.as_tensor(a), jnp.asarray(a)
    pts = tsyn.spiral(300, seed=0)[0][:, :2]
    tadj = tfs.make_normalized_adjacency(
        tkern.make_kernel("gaussian", sigma=3.5), pts, tfs.SETUP_1,
        device="cpu")
    jadj = jfs.make_normalized_adjacency(
        jkern.make_kernel("gaussian", sigma=3.5), jnp.asarray(pts),
        jfs.SETUP_1)
    rhs = np.random.default_rng(3).normal(size=(300, 2))
    return {"spd": (lambda x: ta @ x, lambda x: ja @ x, b),
            "fastsum": (lambda x: 2.0 * x - tadj.matvec(x),
                        lambda x: 2.0 * x - jadj.matvec(x), rhs),
            "adjacency": (tadj.matvec, jadj.matvec, rhs)}


def _mv(a):
    return lambda x: a @ x


def _segmented(machine, lengths):
    """Run a Krylov machine in segments of the given lengths (cycled)."""
    s, k = machine.state, 0
    while bool(machine.cond(s)):
        limit = int(s.i) + lengths[k % len(lengths)]
        k += 1
        while bool(machine.cond(s) & (s.i < limit)):
            s = machine.body(s)
    return s


# -- the machines against the JAX package ------------------------------------

@pytest.mark.parametrize("op", ["spd", "fastsum"])
@pytest.mark.parametrize("method", ["cg", "minres"])
def test_krylov_machines_match_jax_and_segment_bitwise(ops, op, method):
    tmv, jmv, b = ops[op]
    tmake = getattr(tsol, f"{method}_machine")
    jmake = getattr(jsol, f"{method}_machine")
    m = tmake(tmv, torch.as_tensor(b), tol=1e-10, maxiter=200)
    whole = tsol.run_machine(m)
    got = m.finish(whole)
    jm = jmake(jmv, jnp.asarray(b), tol=1e-10, maxiter=200)
    want = jm.finish(jax.lax.while_loop(jm.cond, jm.body, jm.state))
    _close(got.x.numpy(), want.x)
    np.testing.assert_array_equal(got.num_iters.numpy(),
                                  np.asarray(want.num_iters))
    assert bool(got.converged.all())
    # the public solver is the machine
    plain = getattr(tsol, method)(tmv, torch.as_tensor(b), tol=1e-10,
                                  maxiter=200)
    _equal(plain.x, got.x)
    for lengths in ((1,), (3, 7), (50,))[:3 if op == "spd" else 1]:
        seg = _segmented(tmake(tmv, torch.as_tensor(b), tol=1e-10,
                               maxiter=200), lengths)
        for f_seg, f_whole in zip(seg, whole):
            _equal(f_seg, f_whole)


@pytest.mark.parametrize("op", ["spd", "adjacency"])
@pytest.mark.parametrize("block", [1, 4])
def test_lanczos_machines_match_jax_and_segment_bitwise(ops, op, block):
    """T's entries, the basis (up to sign) and the Ritz pairs against the
    JAX package; steps [0, 7), [7, 11), [11, end) against one run."""
    tmv, jmv, b = ops[op]
    n = b.shape[0]
    v0 = np.random.default_rng(7).normal(size=(n,) if block == 1
                                         else (n, block))
    steps = 30 if block == 1 else 8
    if block == 1:
        tmake, jmake = tlan.lanczos_machine, jlan.lanczos_machine
        tstate, jstate = tlan.LanczosLoopState, jlan.LanczosLoopState
    else:
        tmake, jmake = tlan.block_lanczos_machine, jlan.block_lanczos_machine
        tstate, jstate = (tlan.BlockLanczosLoopState,
                          jlan.BlockLanczosLoopState)
    state0, body, finish = tmake(tmv, torch.as_tensor(v0), steps)
    carry = tlan.run_steps(body, tuple(state0)[:-1], 0, steps)
    got = finish(tstate(*carry, i=state0.i + steps))
    js0, jbody, jfinish = jmake(jmv, jnp.asarray(v0), steps)
    jcarry = jax.lax.fori_loop(0, steps, jbody, tuple(js0)[:-1])
    want = jfinish(jstate(*jcarry, i=jnp.asarray(steps, jnp.int32)))
    if block == 1:
        _close(got.alphas.numpy(), want.alphas)
        _close(got.betas.numpy(), want.betas)
    else:
        _close(got.t_matrix.numpy(), want.t_matrix)
    _close(np.abs(got.basis.numpy()), np.abs(np.asarray(want.basis)))
    # the Ritz pairs (k = 4) of both factorizations
    setup = dict(k=4, which="LA", num_iters=steps * block, block_size=block,
                 num_blocks=steps if block > 1 else 0)
    if block == 1:
        tr = tlan.ritz_from_lanczos(got, tlan.EigshSetup(v0=None, **setup))
        jr = jlan.ritz_from_lanczos(want, jlan.EigshSetup(v0=None, **setup))
    else:
        tr = tlan.ritz_from_block(got, tlan.EigshSetup(v0=None, **setup), n)
        jr = jlan.ritz_from_block(want, jlan.EigshSetup(v0=None, **setup), n)
    _close(tr.eigenvalues.numpy(), jr.eigenvalues)
    vec, jvec = tr.eigenvectors.numpy(), np.asarray(jr.eigenvectors)
    _close(vec * np.sign(np.sum(vec * jvec, axis=0)), jvec)
    # segmented: [0, 7), [7, 11), [11, steps)
    s0, body, finish = tmake(tmv, torch.as_tensor(v0), steps)
    carry = tuple(s0)[:-1]
    for i0, i1 in ((0, 7 % steps), (7 % steps, 11 % steps),
                   (11 % steps, steps)):
        carry = tlan.run_steps(body, carry, i0, i1)
    seg = finish(tstate(*carry, i=s0.i + steps))
    for f_seg, f_whole in zip(seg, got):
        _equal(f_seg, f_whole)


# -- tests/test_durable.py, through the port ---------------------------------

@pytest.mark.parametrize("kill_at", [3, 7, 12])
def test_cg_kill_and_resume_bit_identical(tmp_path, spd, kill_at):
    a, b = map(torch.as_tensor, spd)
    ref = tsol.cg(_mv(a), b, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
        policy=POLICY, fault_hook=KillPoint(at_iteration=kill_at))
    assert rep.restarts == 1
    _equal(sol.x, ref.x)
    _equal(sol.num_iters, ref.num_iters)


def test_minres_kill_and_resume_bit_identical(tmp_path, spd):
    a, b = map(torch.as_tensor, spd)
    ref = tsol.minres(_mv(a), b, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path), method="minres", tol=1e-10,
        maxiter=100, policy=POLICY, fault_hook=KillPoint(at_iteration=8))
    assert rep.restarts == 1
    _equal(sol.x, ref.x)


def test_cg_cross_process_resume(tmp_path, spd):
    """max_restarts=0 makes the kill a process death; calling the same
    solve again resumes from the snapshot and still matches."""
    a, b = map(torch.as_tensor, spd)
    ref = tsol.cg(_mv(a), b, tol=1e-10, maxiter=100)
    with pytest.raises(Preemption):
        resumable_solve(
            _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
            policy=DurablePolicy(snapshot_every=5, max_restarts=0),
            fault_hook=KillPoint(at_iteration=12))
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
        policy=POLICY)
    assert rep.resumed_from is not None and rep.resumed_from >= 5
    _equal(sol.x, ref.x)


def test_preemption_storm_backoff_and_cap(tmp_path, spd):
    a, b = map(torch.as_tensor, spd)
    ref = tsol.cg(_mv(a), b, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path / "ok"), tol=1e-10, maxiter=100,
        policy=DurablePolicy(snapshot_every=5, max_restarts=3,
                             backoff_base_s=1e-3),
        fault_hook=KillSchedule(at_iterations=(3, 8, 12)))
    assert rep.restarts == 3
    _equal(sol.x, ref.x)
    with pytest.raises(Preemption):
        resumable_solve(
            _mv(a), b, ckpt_dir=str(tmp_path / "cap"), tol=1e-10,
            maxiter=100,
            policy=DurablePolicy(snapshot_every=5, max_restarts=2),
            fault_hook=KillSchedule(at_iterations=(3, 8, 12)))


def test_bank_kill_and_resume(tmp_path, spd):
    a, b = map(torch.as_tensor, spd)
    shifts = torch.tensor([0.5, 2.0], dtype=torch.float64)
    bank_mv = lambda xb: (torch.einsum("ij,sjc->sic", a, xb)
                          + shifts[:, None, None] * xb)
    bb = torch.stack([b, 2.0 * b])  # (S, n, C)
    ref = tsol.cg_bank(bank_mv, bb, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        bank_mv, bb, ckpt_dir=str(tmp_path), bank=True, tol=1e-10,
        maxiter=100, policy=POLICY, fault_hook=KillPoint(at_iteration=9))
    assert rep.restarts == 1
    _equal(sol.x, ref.x)
    _equal(sol.num_iters, ref.num_iters)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("block_size,kill_at", [(1, 11), (4, 3)])
def test_eigsh_kill_and_resume_bit_identical(tmp_path, spd, block_size,
                                             kill_at):
    a = torch.as_tensor(spd[0])
    n = a.shape[0]
    ref = tlan.eigsh(_mv(a), n, 4, generator=_gen(3), num_iters=30,
                     block_size=block_size, device="cpu")
    res, rep = resumable_eigsh(
        _mv(a), n, 4, ckpt_dir=str(tmp_path), generator=_gen(3),
        num_iters=30, block_size=block_size, device="cpu", policy=POLICY,
        fault_hook=KillPoint(at_iteration=kill_at))
    assert rep.restarts == 1
    _equal(res.eigenvalues, ref.eigenvalues)
    _equal(res.eigenvectors, ref.eigenvectors)


def test_eigsh_cross_process_resume(tmp_path, spd):
    """Called again with a freshly seeded generator, the resumed run is
    the uninterrupted one."""
    a = torch.as_tensor(spd[0])
    n = a.shape[0]
    ref = tlan.eigsh(_mv(a), n, 3, generator=_gen(5), num_iters=30,
                     device="cpu")
    with pytest.raises(Preemption):
        resumable_eigsh(
            _mv(a), n, 3, ckpt_dir=str(tmp_path), generator=_gen(5),
            num_iters=30, device="cpu",
            policy=DurablePolicy(snapshot_every=6, max_restarts=0),
            fault_hook=KillPoint(at_iteration=14))
    res, rep = resumable_eigsh(
        _mv(a), n, 3, ckpt_dir=str(tmp_path), generator=_gen(5),
        num_iters=30, device="cpu", policy=DurablePolicy(snapshot_every=6))
    assert rep.resumed_from is not None and rep.resumed_from >= 6
    _equal(res.eigenvalues, ref.eigenvalues)
    _equal(res.eigenvectors, ref.eigenvectors)


@pytest.mark.parametrize("fresh", [True, False])
def test_eigsh_resume_needs_a_freshly_seeded_generator(tmp_path, spd, fresh):
    """Killed before its first snapshot, a run starts again from its start
    vector.  resumable_eigsh draws it from a copy of the generator's
    state, so a freshly seeded generator and the very generator object the
    killed call was given draw the same one: either way the second call is
    the run that was killed (the JAX package's contract, a key being a
    value)."""
    a = torch.as_tensor(spd[0])
    n = a.shape[0]
    ref = tlan.eigsh(_mv(a), n, 3, generator=_gen(6), num_iters=30,
                     device="cpu")
    used = _gen(6)
    with pytest.raises(Preemption):
        resumable_eigsh(
            _mv(a), n, 3, ckpt_dir=str(tmp_path), generator=used,
            num_iters=30, device="cpu",
            policy=DurablePolicy(snapshot_every=6, max_restarts=0),
            fault_hook=KillPoint(at_iteration=0))
    res, rep = resumable_eigsh(
        _mv(a), n, 3, ckpt_dir=str(tmp_path),
        generator=_gen(6) if fresh else used, num_iters=30, device="cpu",
        policy=DurablePolicy(snapshot_every=6))
    assert rep.resumed_from is None
    _equal(res.eigenvalues, ref.eigenvalues)
    _equal(res.eigenvectors, ref.eigenvectors)


def test_eigsh_leaves_the_callers_generator_as_it_found_it(tmp_path, spd):
    """Kill before the first snapshot, resume with the same, already used
    generator: the resumed run is the plain eigsh's bit for bit, and after
    both calls the generator draws what a fresh one of its seed draws."""
    a = torch.as_tensor(spd[0])
    n = a.shape[0]
    ref = tlan.eigsh(_mv(a), n, 3, generator=_gen(9), num_iters=30,
                     device="cpu")
    used = _gen(9)
    torch.rand(5, generator=used)  # a generator already drawn from
    state = used.get_state()
    with pytest.raises(Preemption):
        resumable_eigsh(
            _mv(a), n, 3, ckpt_dir=str(tmp_path), generator=used,
            num_iters=30, device="cpu",
            policy=DurablePolicy(snapshot_every=6, max_restarts=0),
            fault_hook=KillPoint(at_iteration=0))
    assert torch.equal(used.get_state(), state)
    res, rep = resumable_eigsh(
        _mv(a), n, 3, ckpt_dir=str(tmp_path), generator=used,
        num_iters=30, device="cpu", policy=DurablePolicy(snapshot_every=6))
    assert rep.resumed_from is None
    assert torch.equal(used.get_state(), state)
    want = tlan.eigsh(_mv(a), n, 3, generator=used, num_iters=30,
                      device="cpu")
    _equal(res.eigenvalues, want.eigenvalues)
    _equal(res.eigenvectors, want.eigenvectors)
    assert not torch.equal(want.eigenvectors, ref.eigenvectors)


def test_stale_foreign_snapshot_is_rejected(tmp_path, spd):
    a, b = map(torch.as_tensor, spd)
    other = torch.eye(12, dtype=torch.float64) * 3.0
    resumable_solve(_mv(other), torch.ones((12, 1), dtype=torch.float64),
                    ckpt_dir=str(tmp_path), tol=1e-10, maxiter=50,
                    policy=POLICY)
    ref = tsol.cg(_mv(a), b, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
        policy=POLICY)
    assert rep.resumed_from is None  # the foreign snapshots did not fit
    _equal(sol.x, ref.x)


def test_uninterrupted_durable_solve_matches_plain(tmp_path, spd):
    a, b = map(torch.as_tensor, spd)
    ref = tsol.cg(_mv(a), b, tol=1e-10, maxiter=100)
    sol, rep = resumable_solve(
        _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
        policy=POLICY)
    assert rep.restarts == 0 and rep.snapshots >= 1
    assert rep.snapshots == rep.segments
    assert rep.snapshot_copy_s >= 0.0 and rep.snapshot_write_s > 0.0
    _equal(sol.x, ref.x)
    _equal(sol.num_iters, ref.num_iters)


# -- a fastsum operator ------------------------------------------------------

def test_fastsum_eigsh_and_solve_resume_bit_identical(tmp_path, ops):
    """The spiral's normalized adjacency (eigsh) and I + L_s (CG), killed
    twice each, against the plain solvers run under the same switch."""
    adj = ops["adjacency"][0]
    ssl, _, rhs = ops["fastsum"]
    n = rhs.shape[0]
    with durable.deterministic():
        ref = tlan.eigsh(adj, n, 5, generator=_gen(1), num_iters=30,
                         device="cpu")
        ref_x = tsol.cg(ssl, torch.as_tensor(rhs), tol=1e-10,
                        maxiter=200).x
    res, rep = resumable_eigsh(
        adj, n, 5, ckpt_dir=str(tmp_path / "eig"), generator=_gen(1),
        num_iters=30, device="cpu", policy=DurablePolicy(snapshot_every=10),
        fault_hook=KillSchedule(at_iterations=(7, 21)))
    assert rep.restarts == 2
    _equal(res.eigenvalues, ref.eigenvalues)
    _equal(res.eigenvectors, ref.eigenvectors)
    sol, rep = resumable_solve(
        ssl, torch.as_tensor(rhs), ckpt_dir=str(tmp_path / "cg"), tol=1e-10,
        maxiter=200, policy=DurablePolicy(snapshot_every=4),
        fault_hook=KillSchedule(at_iterations=(5, 9)))
    assert rep.restarts == 2
    _equal(sol.x, ref_x)


@pytest.mark.parametrize("before", [False, True])
def test_drivers_restore_the_deterministic_switch(tmp_path, spd, before):
    a, b = map(torch.as_tensor, spd)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(before)
    try:
        seen = []
        resumable_solve(
            _mv(a), b, ckpt_dir=str(tmp_path), tol=1e-10, maxiter=100,
            policy=POLICY, fault_hook=lambda i: seen.append(
                torch.are_deterministic_algorithms_enabled()))
        assert seen and all(seen)
        assert torch.are_deterministic_algorithms_enabled() is before
    finally:
        torch.use_deterministic_algorithms(prev)
