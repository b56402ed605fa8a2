"""Runtime accuracy guards: Lemma 3.1 consulted live (paper Section 3.1).

PyTorch counterpart of ``repro.runtime.guards``.  A *cheap* probe (no
O(n^2) dense matrix) of the Lemma 3.1 bound

    ||A - A_E||_inf <= eps (1 + eta) / (eta (eta - eps)),   eps < eta,

takes ``eta = d_min / ||W||_inf`` from one approximate-degree matvec
(Eq. 3.5) and ``eps`` from the Monte-Carlo regularization-error sweep of
:func:`repro_torch.core.error.estimate_epsilon` (Eq. 3.6).

:func:`guarded_fastsum` builds an operator, probes it, and doubles the
bandwidth ``N`` up to ``GuardPolicy.max_bandwidth`` until the bound meets
the tolerance.  If it runs out and the problem is small enough, it falls
to the exact :class:`DirectKernelOperator` (the floor of the degradation
ladder; on the card the hand-written direct-sum kernel); otherwise it
returns the best attempt with ``GuardReport.ok = False`` and a warning —
degraded, never silently wrong.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core.error import estimate_epsilon, lemma31_bound
from repro_torch.core.fastsum import (
    FastsumOperator, FastsumParams, _as_points, _normalized_adjacency_from,
    direct_matvec_tiled, make_fastsum, scale_nodes,
)
from repro_torch.core.kernels import Kernel


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Knobs for the accuracy guard.

    ``bound_tol``: maximum admissible Lemma 3.1 bound on ``||A - A_E||_inf``.
    ``max_bandwidth``: escalation ceiling for the bandwidth ``N``.
    ``direct_threshold``: problem size at/below which the exact O(n^2)
    fallback is allowed when escalation runs out.
    ``n_probe_samples`` / ``seed``: Monte-Carlo budget of the eps estimate.
    """

    bound_tol: float = 5e-2
    max_bandwidth: int = 256
    direct_threshold: int = 8192
    n_probe_samples: int = 2048
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ProbeReport:
    """One probe of one operator: the Lemma 3.1 ingredients + bound."""

    n_bandwidth: int
    eta: float
    eps: float
    bound: float


@dataclasses.dataclass
class GuardReport:
    """Every attempt of a guarded build, and what was returned.

    ``fallback`` is ``"none"`` (a fastsum operator) or ``"direct"`` (the
    exact floor).  ``ok`` is False only when no attempt met the tolerance
    *and* the direct floor was not admissible.
    """

    attempts: list[ProbeReport]
    fallback: str
    ok: bool

    @property
    def final(self) -> ProbeReport:
        return self.attempts[-1]

    @property
    def escalations(self) -> int:
        return len(self.attempts) - 1


@dataclasses.dataclass
class DirectKernelOperator:
    """Exact O(n^2)-operation kernel-sum operator — the degradation floor.

    Duck-compatible with :class:`~repro_torch.core.fastsum.FastsumOperator`'s
    matvec surface (``matvec`` / ``matvec_tilde`` / ``degrees`` /
    ``n_source``), backed by :func:`~repro_torch.core.fastsum.direct_matvec_tiled`
    (never materializes W).  Its error is exactly zero.
    """

    kernel: Kernel
    points: torch.Tensor

    @property
    def n_source(self) -> int:
        return self.points.shape[0]

    @property
    def n_target(self) -> int:
        return self.n_source

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return direct_matvec_tiled(self.kernel, self.points, x)

    def matvec_tilde(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x) + self.kernel.at_zero() * x

    def degrees(self) -> torch.Tensor:
        return self.matvec(torch.ones((self.n_source,),
                                      dtype=self.points.dtype,
                                      device=self.points.device))


def probe_fastsum(kernel: Kernel, points, params: FastsumParams,
                  fastsum: FastsumOperator | None = None, *,
                  n_samples: int = 2048, seed: int = 0,
                  device: str | torch.device | None = None) -> ProbeReport:
    """Cheap a-posteriori probe of one operator (no dense W).

    One approximate-degree matvec gives ``eta`` (Eq. 3.5); the Monte-Carlo
    regularization-error sweep gives ``eps`` (Eq. 3.6).  O(n + n_samples).
    ``device`` (default ``cuda``) places ``points`` when no operator is
    given; otherwise the operator's device is used.
    """
    pts = _as_points(points, device if fastsum is None else fastsum.device)
    if fastsum is None:
        fastsum = make_fastsum(kernel, pts, params, device=pts.device)
    deg = fastsum.degrees()
    if not bool(torch.isfinite(deg).all()):
        # a poisoned operator cannot even report degrees: worst bound
        return ProbeReport(params.n_bandwidth, 0.0, float("inf"),
                           float("inf"))
    w_inf = max(float(deg.max()), float(torch.finfo(deg.dtype).tiny))
    eta = max(float(deg.min()), 0.0) / w_inf
    _, rho, _ = scale_nodes(pts, params.eps_b_eff)
    eps = estimate_epsilon(kernel.rescaled(rho), fastsum, pts.shape[0], w_inf,
                           n_samples=n_samples, seed=seed)
    return ProbeReport(params.n_bandwidth, eta, eps, lemma31_bound(eta, eps))


def guarded_fastsum(kernel: Kernel, points, params: FastsumParams, *,
                    policy: GuardPolicy = GuardPolicy(),
                    device: str | torch.device | None = None):
    """Build a fastsum operator whose Lemma 3.1 bound meets the tolerance.

    Returns ``(operator, GuardReport)``.  Doubles ``N`` while the bound
    exceeds ``policy.bound_tol``; at the ceiling, falls to
    :class:`DirectKernelOperator` when ``n <= policy.direct_threshold``,
    else returns the best attempt with ``report.ok = False`` and a warning.
    ``device`` defaults to ``cuda``.
    """
    pts = _as_points(points, device)
    attempts: list[ProbeReport] = []
    p = params
    while True:
        op = make_fastsum(kernel, pts, p, device=pts.device)
        rep = probe_fastsum(kernel, pts, p, op,
                            n_samples=policy.n_probe_samples,
                            seed=policy.seed)
        attempts.append(rep)
        if rep.bound <= policy.bound_tol:
            return op, GuardReport(attempts, "none", True)
        if 2 * p.n_bandwidth > policy.max_bandwidth:
            break
        p = dataclasses.replace(p, n_bandwidth=2 * p.n_bandwidth)
    if pts.shape[0] <= policy.direct_threshold:
        return (DirectKernelOperator(kernel, pts),
                GuardReport(attempts, "direct", True))
    warnings.warn(
        f"accuracy guard: Lemma 3.1 bound {attempts[-1].bound:.3g} exceeds "
        f"tol {policy.bound_tol:.3g} at the bandwidth ceiling "
        f"N={attempts[-1].n_bandwidth} and n={pts.shape[0]} is above the "
        f"direct-fallback threshold; returning the best attempt UNGUARDED",
        RuntimeWarning, stacklevel=2)
    return op, GuardReport(attempts, "none", False)


def guarded_normalized_adjacency(kernel: Kernel, points,
                                 params: FastsumParams, *,
                                 policy: GuardPolicy = GuardPolicy(),
                                 device: str | torch.device | None = None):
    """Guarded Algorithm 3.2: the normalized adjacency over whichever
    operator (escalated fastsum or exact direct) the guard settled on.

    Returns ``(NormalizedAdjacencyOperator, GuardReport)``.
    """
    op, report = guarded_fastsum(kernel, points, params, policy=policy,
                                 device=device)
    return _normalized_adjacency_from(op), report
