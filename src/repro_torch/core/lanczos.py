"""Lanczos method for extremal eigenpairs (paper Section 4), in PyTorch.

Counterpart of ``repro.core.lanczos``.  :func:`lanczos` builds the
tridiagonalization ``A Q_k = Q_k T_k + beta_{k+1} q_{k+1} e_k^T`` with full
reorthogonalization (two-pass classical Gram-Schmidt per step);
:func:`block_lanczos` applies the operator to whole (n, b) blocks;
:func:`eigsh` extracts the ``k`` algebraically largest (or smallest) Ritz
pairs.  A plain Python loop takes the place of ``fori_loop``.

Both factorizations are resumable machines (:func:`lanczos_machine`,
:func:`block_lanczos_machine`): ``body(i, carry)`` is a deterministic
function of the step index and the carry, so running steps ``[0, k)`` in
any segmentation gives the same trajectory; :func:`lanczos` and
:func:`block_lanczos` run it in one go, and
:func:`repro_torch.runtime.durable.resumable_eigsh` in snapshotted
segments.  The body writes the basis and T's entries in place, so a
driver copies the initial state before it runs it.

The breakdown guard stays on the device: a step whose recurrence goes
non-finite truncates the factorization (nothing at or after it is written),
and :func:`_sentinel_mask` pushes the dead tail of T out of the Ritz window,
so no step waits on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device

Matvec = Callable[[torch.Tensor], torch.Tensor]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor  # (k,) diagonal of T
    betas: torch.Tensor  # (k,) betas[i>=1] couples q_i to q_{i+1}; betas[0] = 0
    basis: torch.Tensor  # (k, n) rows are the Lanczos vectors
    residual_beta: torch.Tensor  # beta_{k+1}
    breakdown_iter: torch.Tensor  # first non-finite step; == k when clean


class BlockLanczosResult(NamedTuple):
    t_matrix: torch.Tensor  # (s, s) block-tridiagonal projection, s = blocks*b
    basis: torch.Tensor  # (blocks, n, b) orthonormal block basis
    residual_block: torch.Tensor  # (b, b) R factor of the last residual
    breakdown_iter: torch.Tensor  # first non-finite block step


class EigshHealth(NamedTuple):
    """``nonfinite``: the recurrence went non-finite and the subspace was
    truncated at ``breakdown_iter``; ``residual_bounds`` are then inf."""

    nonfinite: torch.Tensor  # bool scalar
    breakdown_iter: torch.Tensor  # int scalar, == subspace size when clean


class EigshResult(NamedTuple):
    eigenvalues: torch.Tensor  # (k,) descending (LA) / ascending (SA)
    eigenvectors: torch.Tensor  # (n, k)
    residual_bounds: torch.Tensor  # (k,)
    num_iters: int
    num_matvecs: int  # operator applications (a block counts as one)
    health: EigshHealth


class EigshSetup(NamedTuple):
    """Resolved eigsh configuration; ``num_blocks == 0`` is single-vector."""

    k: int
    which: str
    num_iters: int
    block_size: int
    num_blocks: int
    v0: torch.Tensor


class LanczosLoopState(NamedTuple):
    """Checkpointable Lanczos state: the loop's carry and the next step."""

    basis: torch.Tensor      # (num_iters, n)
    alphas: torch.Tensor     # (num_iters,)
    betas: torch.Tensor      # (num_iters,)
    beta_next: torch.Tensor  # 0-d: coupling into the next step
    breakdown: torch.Tensor  # 0-d: first non-finite step, num_iters if none
    i: torch.Tensor          # 0-d int32: next step index


def lanczos_machine(matvec: Matvec, v0: torch.Tensor, num_iters: int):
    """Lanczos in resumable form: ``(state0, body, finish)``.

    ``body(i, carry)`` runs step ``i`` on the 5-tuple carry ``state[:-1]``
    (updating it in place) and returns it; ``finish(state)`` gives the
    :class:`LanczosResult`.
    """
    n, dtype, dev = v0.shape[0], v0.dtype, v0.device
    basis = torch.zeros((num_iters, n), dtype=dtype, device=dev)
    basis[0] = v0 / torch.linalg.vector_norm(v0)
    tiny = torch.finfo(dtype).tiny

    def body(i: int, carry):
        basis, alphas, betas, beta_next, breakdown = carry
        alive = i < breakdown
        qi = basis[i]
        w = matvec(qi)
        alpha = torch.dot(qi, w)
        w = w - alpha * qi
        if i > 0:
            w = w - betas[i] * basis[i - 1]
        filled = basis[: i + 1]  # two-pass CGS against the filled basis
        for _ in range(2):
            w = w - filled.T @ (filled @ w)
        beta = torch.linalg.vector_norm(w)
        # a non-finite step truncates the factorization: nothing at or
        # after it is written, so NaNs never enter the basis or T
        ok = alive & torch.isfinite(alpha) & torch.isfinite(beta)
        breakdown = torch.where(alive & ~ok, i, breakdown)
        alphas[i] = torch.where(ok, alpha, 0.0)
        if i + 1 < num_iters:
            q_next = torch.where(beta > 0, w / torch.clamp(beta, min=tiny), 0.0)
            basis[i + 1] = torch.where(ok, q_next, basis[i + 1])
            betas[i + 1] = torch.where(ok, beta, betas[i + 1])
        return basis, alphas, betas, torch.where(ok, beta, 0.0), breakdown

    state0 = LanczosLoopState(
        basis=basis,
        alphas=torch.zeros((num_iters,), dtype=dtype, device=dev),
        betas=torch.zeros((num_iters,), dtype=dtype, device=dev),
        beta_next=torch.zeros((), dtype=dtype, device=dev),
        breakdown=torch.tensor(num_iters, device=dev),
        i=torch.zeros((), dtype=torch.int32, device=dev))

    def finish(state: LanczosLoopState) -> LanczosResult:
        return LanczosResult(alphas=state.alphas, betas=state.betas,
                             basis=state.basis,
                             residual_beta=state.beta_next,
                             breakdown_iter=state.breakdown)

    return state0, body, finish


def run_steps(body, carry: tuple, i0: int, i1: int) -> tuple:
    """Steps ``[i0, i1)`` of a (block) Lanczos machine's ``body``."""
    for i in range(i0, i1):
        carry = body(i, carry)
    return carry


def lanczos(matvec: Matvec, v0: torch.Tensor,
            num_iters: int) -> LanczosResult:
    """Run ``num_iters`` Lanczos steps from start vector ``v0`` (n,)."""
    state0, body, finish = lanczos_machine(matvec, v0, num_iters)
    carry = run_steps(body, tuple(state0)[:-1], 0, num_iters)
    return finish(LanczosLoopState(*carry, i=state0.i + num_iters))


class BlockLanczosLoopState(NamedTuple):
    """Checkpointable block-Lanczos state (see :class:`LanczosLoopState`)."""

    basis: torch.Tensor     # (num_blocks, n, b)
    a_blocks: torch.Tensor  # (num_blocks, b, b)
    b_blocks: torch.Tensor  # (num_blocks, b, b)
    resid: torch.Tensor     # (b, b)
    breakdown: torch.Tensor
    i: torch.Tensor


def block_lanczos_machine(matvec: Matvec, v0: torch.Tensor,
                          num_blocks: int):
    """Block Lanczos in resumable ``(state0, body, finish)`` form."""
    n, b = v0.shape
    dtype, dev = v0.dtype, v0.device
    basis = torch.zeros((num_blocks, n, b), dtype=dtype, device=dev)
    basis[0] = torch.linalg.qr(v0).Q

    def body(j: int, carry):
        basis, a_blocks, b_blocks, resid, breakdown = carry
        qj = basis[j]
        w = matvec(qj)  # (n, b): one batched operator application
        a = qj.T @ w
        a = 0.5 * (a + a.T)  # exact symmetry of the diagonal block
        w = w - qj @ a
        if j > 0:
            w = w - basis[j - 1] @ b_blocks[j].T
        # two-pass block CGS against the filled basis
        flat = basis[: j + 1].permute(1, 0, 2).reshape(n, (j + 1) * b)
        for _ in range(2):
            w = w - flat @ (flat.T @ w)
        q_next, r_next = torch.linalg.qr(w)
        alive = j < breakdown
        ok = (alive & torch.isfinite(a).all()
              & torch.isfinite(r_next).all())
        breakdown = torch.where(alive & ~ok, j, breakdown)
        if j + 1 < num_blocks:
            basis[j + 1] = torch.where(ok, q_next, basis[j + 1])
            b_blocks[j + 1] = torch.where(ok, r_next, b_blocks[j + 1])
        a_blocks[j] = torch.where(ok, a, 0.0)
        return (basis, a_blocks, b_blocks, torch.where(ok, r_next, 0.0),
                breakdown)

    state0 = BlockLanczosLoopState(
        basis=basis,
        a_blocks=torch.zeros((num_blocks, b, b), dtype=dtype, device=dev),
        b_blocks=torch.zeros((num_blocks, b, b), dtype=dtype, device=dev),
        resid=torch.zeros((b, b), dtype=dtype, device=dev),
        breakdown=torch.tensor(num_blocks, device=dev),
        i=torch.zeros((), dtype=torch.int32, device=dev))

    def finish(state: BlockLanczosLoopState) -> BlockLanczosResult:
        a_blocks, b_blocks = state.a_blocks, state.b_blocks
        breakdown = state.breakdown
        s = num_blocks * b
        t = torch.zeros((s, s), dtype=dtype, device=dev)
        for j in range(num_blocks):
            t[j * b:(j + 1) * b, j * b:(j + 1) * b] = a_blocks[j]
            if j > 0:
                # A Q_{j-1} = ... + Q_j R_j: lower block (j, j-1) is R_j;
                # the coupling into the first dead block is zeroed so the
                # masked tail stays decoupled from the valid head
                bj = torch.where(j < breakdown, b_blocks[j], 0.0)
                t[(j - 1) * b:j * b, j * b:(j + 1) * b] = bj.T
                t[j * b:(j + 1) * b, (j - 1) * b:j * b] = bj
        return BlockLanczosResult(t_matrix=t, basis=state.basis,
                                  residual_block=state.resid,
                                  breakdown_iter=breakdown)

    return state0, body, finish


def block_lanczos(matvec: Matvec, v0: torch.Tensor,
                  num_blocks: int) -> BlockLanczosResult:
    """Block Lanczos with block size ``b = v0.shape[1]`` (paper Section 4).

    Builds ``A Q = Q T + Q_next B_next E_last^T`` with T block-tridiagonal
    (diagonal blocks A_j, off-diagonal B_j^T / B_j).
    """
    state0, body, finish = block_lanczos_machine(matvec, v0, num_blocks)
    carry = run_steps(body, tuple(state0)[:-1], 0, num_blocks)
    return finish(BlockLanczosLoopState(*carry, i=state0.i + num_blocks))


def _sentinel_mask(t: torch.Tensor, valid: torch.Tensor,
                   which: str) -> torch.Tensor:
    """Push the dead (breakdown-truncated) tail of T out of the requested
    Ritz window: its diagonal gets a sentinel far on the wrong side."""
    sentinel = (t.abs().max() + 1.0) * 1e3
    if which == "LA":
        sentinel = -sentinel
    return t + torch.diag(torch.where(valid, 0.0, sentinel))


def eigsh_setup(n: int, k: int, *, num_iters: int | None = None,
                which: str = "LA", generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float64, v0=None,
                block_size: int = 1,
                device: str | torch.device | None = None) -> EigshSetup:
    """Resolve the eigsh configuration (subspace size, block, start vector).

    The start vector is the caller's ``v0`` (numpy or tensor, moved to
    ``device``) or standard normal draws from ``generator`` (default: a
    generator on ``device`` seeded with 0).  ``device`` defaults to v0's
    device when v0 is a tensor, else to ``cuda``.  A generator advances
    with every draw, so a caller that wants the same start vector from two
    calls (a durable run resumed by calling it again) passes a generator
    freshly seeded for each call.
    """
    if which not in ("LA", "SA"):
        raise ValueError(which)
    if device is None and isinstance(v0, torch.Tensor):
        device = v0.device
    dev = resolve_device(device)
    if v0 is not None:
        v0 = torch.as_tensor(v0, dtype=dtype, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if num_iters is None:
        num_iters = min(n, max(2 * k + 20, 30))
    num_iters = min(num_iters, n)

    if block_size > 1:
        if v0 is not None:
            block_size = v0.shape[1]
        # the subspace num_blocks * block_size must not exceed n, yet must
        # reach min(k, n): shrink oversized blocks
        block_size = min(block_size, max(n // 2, 1))
        need = min(k, n)
        while block_size > 1 and (n // block_size) * block_size < need:
            block_size -= 1
        if v0 is not None and v0.shape[1] > block_size:
            v0 = v0[:, :block_size]
        num_blocks = max(min(-(-num_iters // block_size), n // block_size),
                         -(-need // block_size))
        if v0 is None:
            v0 = torch.randn((n, block_size), generator=generator,
                             dtype=dtype, device=dev)
        return EigshSetup(k=k, which=which, num_iters=num_iters,
                          block_size=block_size, num_blocks=num_blocks,
                          v0=v0.contiguous())

    if v0 is None:
        v0 = torch.randn((n,), generator=generator, dtype=dtype, device=dev)
    return EigshSetup(k=k, which=which, num_iters=num_iters, block_size=1,
                      num_blocks=0, v0=v0)


def _top_k(theta: torch.Tensor, k: int, which: str) -> torch.Tensor:
    return (torch.argsort(-theta) if which == "LA"
            else torch.argsort(theta))[:k]


def ritz_from_lanczos(res: LanczosResult, setup: EigshSetup) -> EigshResult:
    """Ritz extraction from a finished single-vector Lanczos run."""
    k, which, num_iters = setup.k, setup.which, setup.num_iters
    dev = res.alphas.device
    broke = res.breakdown_iter < num_iters
    valid = torch.arange(num_iters, device=dev) < res.breakdown_iter
    off = torch.where(valid[1:], res.betas[1:], 0.0)
    t = torch.diag(res.alphas) + torch.diag(off, 1) + torch.diag(off, -1)
    theta, w = torch.linalg.eigh(_sentinel_mask(t, valid, which))
    order = _top_k(theta, k, which)
    w_k = w[:, order]
    bounds = torch.abs(res.residual_beta * w_k[-1, :])
    return EigshResult(
        eigenvalues=theta[order], eigenvectors=res.basis.T @ w_k,
        residual_bounds=torch.where(broke, torch.inf, bounds),
        num_iters=num_iters, num_matvecs=num_iters,
        health=EigshHealth(nonfinite=broke,
                           breakdown_iter=res.breakdown_iter))


def ritz_from_block(res: BlockLanczosResult, setup: EigshSetup,
                    n: int) -> EigshResult:
    """Ritz extraction from a finished block-Lanczos factorization."""
    k, which = setup.k, setup.which
    num_blocks, block_size = setup.num_blocks, setup.block_size
    dev = res.t_matrix.device
    broke = res.breakdown_iter < num_blocks
    valid = torch.repeat_interleave(
        torch.arange(num_blocks, device=dev) < res.breakdown_iter, block_size)
    theta, w = torch.linalg.eigh(_sentinel_mask(res.t_matrix, valid, which))
    basis_flat = res.basis.permute(1, 0, 2).reshape(n, num_blocks * block_size)
    order = _top_k(theta, k, which)
    w_k = w[:, order]
    bottom = w_k[-block_size:, :]  # (b, k) last-block Ritz components
    bounds = torch.linalg.vector_norm(res.residual_block @ bottom, dim=0)
    return EigshResult(
        eigenvalues=theta[order], eigenvectors=basis_flat @ w_k,
        residual_bounds=torch.where(broke, torch.inf, bounds),
        num_iters=num_blocks * block_size, num_matvecs=num_blocks,
        health=EigshHealth(nonfinite=broke,
                           breakdown_iter=res.breakdown_iter))


def eigsh(matvec: Matvec, n: int, k: int, *, num_iters: int | None = None,
          which: str = "LA", generator: torch.Generator | None = None,
          dtype: torch.dtype = torch.float64, v0=None, block_size: int = 1,
          device: str | torch.device | None = None) -> EigshResult:
    """Largest- (``which="LA"``) or smallest-algebraic (``"SA"``) eigenpairs
    of a symmetric operator.

    ``block_size > 1`` runs block Lanczos: ``num_iters`` still means the
    Krylov subspace dimension, but the operator is applied to (n, block)
    batches, so ``matvec`` must take (n, C) input.  See :func:`eigsh_setup`
    for ``generator``, ``v0`` and ``device``.
    """
    setup = eigsh_setup(n, k, num_iters=num_iters, which=which,
                        generator=generator, dtype=dtype, v0=v0,
                        block_size=block_size, device=device)
    if setup.num_blocks:
        res = block_lanczos(matvec, setup.v0, setup.num_blocks)
        return ritz_from_block(res, setup, n)
    return ritz_from_lanczos(lanczos(matvec, setup.v0, setup.num_iters),
                             setup)


def eigsh_smallest_laplacian(adjacency_matvec: Matvec, n: int, k: int,
                             **kw) -> EigshResult:
    """Smallest eigenpairs of ``L_s = I - A`` via the largest of A."""
    res = eigsh(adjacency_matvec, n, k, which="LA", **kw)
    return res._replace(eigenvalues=1.0 - res.eigenvalues)
