"""NFFT-based fast summation — Algorithms 3.1 and 3.2 of the paper, in PyTorch.

Counterpart of ``repro.core.fastsum``.  Algorithm 3.1 computes
``(W̃ x)_j = sum_i x_i K(v_j - v_i)`` (diagonal ``K(0)``) in O(n), also
from sources to separate targets; Algorithm 3.2 wraps it into the
normalized adjacency ``A = D^{-1/2} W D^{-1/2}`` with ``W = W̃ - K(0) I``
and ``D = diag(W 1)``, including the node rescaling by ``rho``.
:func:`direct_matvec_tiled` is the exact O(n^2) direct method, on the
card the hand-written kernel of :mod:`repro_torch.kernels.kernel_matvec`.

Entry points run on the CUDA card unless the caller passes ``device``
(see :mod:`repro_torch.device`).

Differentiation: :meth:`FastsumOperator.with_kernel` rebuilds an operator's
spectral data for a kernel whose parameter is a tensor, so the matvec is
differentiable in sigma or c, and in its values, through the transpose
pipeline of :mod:`repro_torch.core.fastsum_exec`.  Node positions are
plan-time data: they are detached and get no gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fastsum_exec
from repro_torch.core.kernels import Kernel
from repro_torch.core.nfft import (
    KAISER_BESSEL, NfftGeometry, NfftPlan, WindowGeometry, build_geometry,
    build_window_geometry, nfft_adjoint, nfft_forward,
)
from repro_torch.core.regularization import kernel_fourier_coefficients
from repro_torch.device import resolve_device
from repro_torch.kernels.kernel_matvec import kernel_matvec


@dataclasses.dataclass(frozen=True)
class FastsumParams:
    """Static fast-summation accuracy parameters (Figure 1 of the paper)."""

    n_bandwidth: int  # N
    m: int  # NFFT window cut-off
    p: int | None = None  # regularization smoothness (default: m)
    eps_b: float | None = None  # regularization region (default: p/N)
    sigma_os: float = 2.0
    window: str = KAISER_BESSEL

    @property
    def p_eff(self) -> int:
        return self.m if self.p is None else self.p

    @property
    def eps_b_eff(self) -> float:
        return self.p_eff / self.n_bandwidth if self.eps_b is None else self.eps_b

    def nfft_plan(self, d: int) -> NfftPlan:
        return NfftPlan(d=d, n_bandwidth=self.n_bandwidth, m=self.m,
                        sigma_os=self.sigma_os, window=self.window)


# The paper's three accuracy tiers (Section 6.1).
SETUP_1 = FastsumParams(n_bandwidth=16, m=2, eps_b=0.0)
SETUP_2 = FastsumParams(n_bandwidth=32, m=4, eps_b=0.0)
SETUP_3 = FastsumParams(n_bandwidth=64, m=7, eps_b=0.0)


def scale_nodes(points: torch.Tensor, eps_b: float, *, center: bool = True):
    """Shift/scale raw data into the admissible ball (Alg. 3.2 step 1).

    Returns ``(scaled_nodes, rho, shift)`` with ``scaled = (points - shift)
    * rho`` and ``||scaled||_2 <= 1/4 - eps_b/2``; ``rho`` is a float.
    ``center=False`` keeps the origin (a zero shift).  Non-finite
    coordinates are rejected: one NaN node would poison the centering,
    collapse ``rho`` to NaN and corrupt every planned operator.
    """
    if not bool(torch.isfinite(points).all()):
        raise ValueError(
            "non-finite coordinates in the point set; scrub the data or "
            "drop the offending nodes before planning")
    if center:
        shift = (points.min(dim=0).values + points.max(dim=0).values) / 2.0
    else:
        shift = torch.zeros((points.shape[1],), dtype=points.dtype,
                            device=points.device)
    centered = points - shift
    # sqrt(sum(x*x)), as jnp.linalg.norm computes it
    max_norm = float(torch.sqrt((centered * centered).sum(dim=1)).max())
    target = 0.25 - eps_b / 2.0
    rho = target / max(max_norm, float(torch.finfo(points.dtype).tiny))
    return centered * rho, rho, shift


@dataclasses.dataclass
class FastsumOperator:
    """Algorithm 3.1 as a linear operator ``x -> W̃ x`` (+ optional targets).

    Build with :func:`make_fastsum` (or :func:`fastsum_from_arrays`).
    ``matvec_tilde`` maps (n_src,) or (n_src, C) real tensors to (n_tgt,)
    or (n_tgt, C).  The spectral fields (``b_hat``, ``multiplier_half``,
    ``kernel_at_zero``) carry the graph of a kernel parameter that is a
    tensor (:meth:`with_kernel`); the plan and geometry carry none.
    """

    plan: NfftPlan
    b_hat: torch.Tensor  # (N,)*d complex, FFT order
    scaled_src: torch.Tensor  # (n, d) nodes in the admissible ball
    output_scale: float  # rho**exponent correction
    kernel_at_zero: float | torch.Tensor  # K(0), already corrected
    multiplier_half: torch.Tensor  # fused multiplier, rfftn half-spectrum
    src_window: WindowGeometry
    rho: float
    fs_params: FastsumParams
    scaled_tgt: torch.Tensor | None = None  # (n_tgt, d); None: targets = sources
    tgt_window: WindowGeometry | None = None
    # flat geometries of the two-NFFT oracle, built at first use
    _src_geom: NfftGeometry | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _tgt_geom: NfftGeometry | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def with_kernel(self, kernel: Kernel) -> "FastsumOperator":
        """The same plan and geometry with a new kernel: only the spectral
        data (``b_hat``, ``multiplier_half``, ``output_scale``,
        ``kernel_at_zero``) is rebuilt.  With a tensor parameter the new
        operator's spectral data, and so its matvecs, are differentiable
        in it: the seam gradient-based model selection goes through.
        """
        if self.rho is None or self.fs_params is None:
            raise ValueError(
                "with_kernel needs the planning state (rho, fs_params); "
                "this operator was built by hand or by an older path — "
                "re-plan it with make_fastsum")
        b_hat, mult_half, out_scale, k0 = _member_spectral(
            kernel, self.rho, self.plan, self.fs_params, self.device)
        return dataclasses.replace(
            self, b_hat=b_hat, multiplier_half=mult_half,
            output_scale=out_scale, kernel_at_zero=k0)

    @property
    def n_source(self) -> int:
        return self.scaled_src.shape[0]

    @property
    def n_target(self) -> int:
        return self.n_source if self.scaled_tgt is None \
            else self.scaled_tgt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.scaled_src.device

    def matvec_tilde(self, x: torch.Tensor) -> torch.Tensor:
        """y = W̃ x (diagonal K(0) included)."""
        tgt = self.src_window if self.tgt_window is None else self.tgt_window
        f = fastsum_exec.fused_matvec_tilde(
            self.plan, self.multiplier_half, self.src_window, tgt, x)
        return f * self.output_scale

    @property
    def src_geometry(self) -> NfftGeometry:
        """O(n * taps^d) flat geometry of the sources, built at first use.

        Only the two-NFFT oracle reads it; operators that never call
        :meth:`matvec_tilde_reference` never pay its time or memory.
        """
        if self._src_geom is None:
            self._src_geom = build_geometry(self.plan, self.scaled_src)
        return self._src_geom

    @property
    def tgt_geometry(self) -> NfftGeometry:
        if self.scaled_tgt is None:
            return self.src_geometry
        if self._tgt_geom is None:
            self._tgt_geom = build_geometry(self.plan, self.scaled_tgt)
        return self._tgt_geom

    def matvec_tilde_reference(self, x: torch.Tensor) -> torch.Tensor:
        """y = W̃ x by the two-NFFT path (adjoint -> multiply -> forward).

        Plain torch ops on the flat geometry (``index_add_``, cuFFT on the
        card) and no window kernel: the yardstick the fused engine is held
        against.
        """
        x_hat = nfft_adjoint(self.plan, self.src_geometry, x)
        b_hat = self.b_hat[..., None] if x.ndim == 2 else self.b_hat
        f = nfft_forward(self.plan, self.tgt_geometry, b_hat * x_hat)
        return f.real * self.output_scale

    def _require_square(self, name: str) -> None:
        if self.scaled_tgt is not None:
            raise ValueError(
                f"FastsumOperator.{name} subtracts the K(0) diagonal, which "
                "is only defined when source and target nodes coincide; this "
                "operator was built with target_points — use matvec_tilde "
                "for rectangular kernel sums.")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = W x = (W̃ - K(0) I) x.  Requires src == tgt nodes."""
        self._require_square("matvec")
        return self.matvec_tilde(x) - self.kernel_at_zero * x

    def matvec_reference(self, x: torch.Tensor) -> torch.Tensor:
        """Two-NFFT W x, the oracle counterpart of :meth:`matvec`."""
        self._require_square("matvec_reference")
        return self.matvec_tilde_reference(x) - self.kernel_at_zero * x

    def degrees(self) -> torch.Tensor:
        """d = W 1 (row sums of the zero-diagonal weight matrix)."""
        ones = torch.ones((self.n_source,), dtype=self.scaled_src.dtype,
                          device=self.device)
        return self.matvec(ones)


def _as_points(points, device) -> torch.Tensor:
    """Points as a tensor on ``device``, detached: node positions are
    plan-time data, with no gradient (as in the JAX package)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, device=dev).detach()
    if not pts.is_floating_point():
        raise TypeError(f"points must be floating point, got {pts.dtype}")
    if pts.ndim != 2:
        raise ValueError(f"points must be (n, d), got {tuple(pts.shape)}")
    return pts


def _scaled_plan(pts: torch.Tensor, params: FastsumParams, target_points):
    """Kernel-independent plan-time setup, shared by single operators and
    banks: node scaling into the admissible ball (of the union with the
    targets, when given), the NFFT plan and the Morton-sorted window
    geometries.

    Returns ``(scaled_src, scaled_tgt, rho, plan, src_win, tgt_win)``;
    ``scaled_tgt`` and ``tgt_win`` are None when targets are the sources.
    """
    if target_points is None:
        scaled, rho, _ = scale_nodes(pts, params.eps_b_eff)
        scaled_tgt = None
    else:
        tgt = _as_points(target_points, pts.device).to(pts.dtype)
        both, rho, _ = scale_nodes(torch.cat([pts, tgt]), params.eps_b_eff)
        scaled, scaled_tgt = both[:pts.shape[0]], both[pts.shape[0]:]
    plan = params.nfft_plan(pts.shape[1])
    window = build_window_geometry(plan, scaled)
    tgt_window = None if scaled_tgt is None \
        else build_window_geometry(plan, scaled_tgt)
    return scaled, scaled_tgt, rho, plan, window, tgt_window


def _member_spectral(kernel: Kernel, rho: float, plan: NfftPlan,
                     params: FastsumParams, device: torch.device):
    """Per-kernel spectral data ``(b_hat, multiplier_half, out_scale,
    k0)``: the only kernel-dependent plan-time work, everything else
    (:func:`_scaled_plan`) is shared by a bank's members.  ``out_scale``
    depends on ``rho`` alone and is a float; ``k0`` is a float for a float
    parameter and a tensor, like ``b_hat`` and the multiplier carrying the
    graph, for a tensor parameter."""
    rescaled = kernel.rescaled(rho)
    b_hat = kernel_fourier_coefficients(rescaled, plan.d, params.n_bandwidth,
                                        params.p_eff, params.eps_b_eff,
                                        device=device)
    exponent = kernel.output_scale_exponent
    out_scale = rho ** exponent if exponent != 0 else 1.0
    # out_scale * K_rescaled(0) == K(0) for all four kernels
    return (b_hat, fastsum_exec.fused_spectral_multiplier(plan, b_hat),
            out_scale, out_scale * rescaled.at_zero())


def make_fastsum(kernel: Kernel, points, params: FastsumParams, *,
                 target_points=None,
                 device: str | torch.device | None = None) -> FastsumOperator:
    """Set up Algorithm 3.1 for ``points`` (n, d) in original coordinates.

    ``points`` (numpy or tensor) keep their float dtype; ``device``
    defaults to ``cuda``.  With ``target_points`` (m, d) the operator sums
    from ``points`` to them, and the *union* of both sets is rescaled into
    the admissible ball.
    """
    pts = _as_points(points, device)
    scaled, scaled_tgt, rho, plan, window, tgt_window = _scaled_plan(
        pts, params, target_points)
    b_hat, mult_half, out_scale, k0 = _member_spectral(
        kernel, rho, plan, params, pts.device)
    return FastsumOperator(
        plan=plan, b_hat=b_hat, scaled_src=scaled, output_scale=out_scale,
        kernel_at_zero=k0, multiplier_half=mult_half, src_window=window,
        rho=rho, fs_params=params, scaled_tgt=scaled_tgt,
        tgt_window=tgt_window)


def fastsum_from_arrays(arrays: dict, params: FastsumParams, *,
                        device: str | torch.device | None = None
                        ) -> FastsumOperator:
    """A :class:`FastsumOperator` from a planned operator's arrays.

    ``arrays`` maps ``b_hat``, ``multiplier_half``, ``src_window.base``,
    ``src_window.weights``, ``src_window.perm``, ``scaled_src``,
    ``output_scale``, ``kernel_at_zero`` and ``rho`` to numpy arrays (the
    leaves of ``repro.core.fastsum.FastsumOperator``).  The planned operator
    is this system's state: with it, execution can be checked apart from
    planning.
    """
    dev = resolve_device(device)

    def tensor(key):
        return torch.as_tensor(np.array(arrays[key]), device=dev)

    scaled = tensor("scaled_src")
    window = WindowGeometry.from_sorted(tensor("src_window.base"),
                                        tensor("src_window.weights"),
                                        tensor("src_window.perm"))
    return FastsumOperator(
        plan=params.nfft_plan(scaled.shape[1]), b_hat=tensor("b_hat"),
        scaled_src=scaled, output_scale=float(arrays["output_scale"]),
        kernel_at_zero=float(arrays["kernel_at_zero"]),
        multiplier_half=tensor("multiplier_half").contiguous(),
        src_window=window, rho=float(arrays["rho"]), fs_params=params)


# ---------------------------------------------------------------------------
# Prediction plans and operator banks.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PredictionPlan:
    """Plan-once serving frame: a fixed node scaling over train ∪ domain.

    :func:`make_fastsum` with ``target_points`` rescales the union of
    sources and targets, so every new target set is a full replan.  A
    ``PredictionPlan`` instead freezes ``(rho, shift)`` over the training
    points plus a declared serving domain (default: the training bounding
    box expanded by ``margin``).  A query set inside the domain is then
    admissible under the frozen scaling and costs only a target window
    geometry (:meth:`target_window`); the NFFT plan, the source geometry
    and every kernel's multiplier (:func:`prediction_multiplier`) are
    reused.  One plan serves every model fitted on the same points.
    """

    plan: NfftPlan
    scaled_src: torch.Tensor  # (n, d) training nodes under the frozen scaling
    src_window: WindowGeometry
    rho: float
    shift: np.ndarray  # (d,), plain numpy like rho, off the device
    radius: float  # admissible ball radius for scaled nodes

    @property
    def n_source(self) -> int:
        return self.scaled_src.shape[0]

    def scale_targets(self, query_points) -> torch.Tensor:
        """Map raw query points into the frozen scaled frame, on their own
        device (numpy points: the CPU)."""
        q = torch.as_tensor(query_points)
        return (q - torch.as_tensor(self.shift, dtype=q.dtype,
                                    device=q.device)) * self.rho

    def admissible(self, scaled_targets, *,
                   slack: float = 1e-9) -> torch.Tensor:
        """Per-row mask: does a scaled query point fit the admissible ball?

        Points outside wrap around the torus the NFFT periodizes over and
        give wrong kernel sums; callers must reject them.
        """
        s = torch.as_tensor(scaled_targets)
        return torch.sqrt((s * s).sum(dim=-1)) <= self.radius + slack

    def target_window(self, scaled_targets) -> WindowGeometry:
        """Per-tick work: the window geometry of (already scaled) targets,
        on the plan's device."""
        tgt = torch.as_tensor(scaled_targets, dtype=self.scaled_src.dtype,
                              device=self.scaled_src.device)
        return build_window_geometry(self.plan, tgt)


def _domain_corners(points: np.ndarray, margin: float) -> np.ndarray:
    """2^d corners of the training bounding box expanded by ``margin``."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    mid, half = (lo + hi) / 2.0, np.maximum((hi - lo) / 2.0, 1e-12)
    half = half * (1.0 + margin)
    d = points.shape[1]
    corners = np.stack(np.meshgrid(*[[-1.0, 1.0]] * d, indexing="ij"),
                       axis=-1).reshape(-1, d)
    return mid[None, :] + corners * half[None, :]


def make_prediction_plan(points, params: FastsumParams, *,
                         domain_points=None, margin: float = 0.5,
                         device: str | torch.device | None = None
                         ) -> PredictionPlan:
    """Kernel-independent serving plan over ``points`` (n, d).

    ``domain_points`` declares the region queries may come from; by
    default the training bounding box expanded by ``margin`` per
    dimension (its corners taken from a CPU copy of the points).  The
    scaling is computed once over train ∪ domain and frozen.
    """
    pts = _as_points(points, device)
    if domain_points is None:
        domain = torch.as_tensor(_domain_corners(pts.cpu().numpy(), margin),
                                 dtype=pts.dtype, device=pts.device)
    else:
        domain = torch.as_tensor(domain_points, dtype=pts.dtype,
                                 device=pts.device)
    both = torch.cat([pts, domain.reshape(-1, pts.shape[1])])
    scaled, rho, shift = scale_nodes(both, params.eps_b_eff)
    scaled_src = scaled[:pts.shape[0]]
    plan = params.nfft_plan(pts.shape[1])
    return PredictionPlan(
        plan=plan, scaled_src=scaled_src,
        src_window=build_window_geometry(plan, scaled_src), rho=float(rho),
        shift=shift.cpu().numpy(), radius=0.25 - params.eps_b_eff / 2.0)


def prediction_multiplier(kernel: Kernel, pred: PredictionPlan,
                          params: FastsumParams) -> torch.Tensor:
    """Fused serving multiplier of one kernel on a shared prediction plan,
    with the ``rho**exponent`` output correction folded in (the pipeline is
    linear), as :func:`make_fastsum_bank` folds its members'."""
    _, mult_half, out_scale, _ = _member_spectral(
        kernel, pred.rho, pred.plan, params, pred.scaled_src.device)
    return mult_half * out_scale


@dataclasses.dataclass
class FastsumOperatorBank:
    """A bank of S Algorithm 3.1 operators sharing nodes, plan and geometry.

    The members differ only in their kernel, hence their spectral
    multiplier, so a bank matvec shares one spread and one forward rfftn
    across all S (:func:`repro_torch.core.fastsum_exec.fused_pipeline_bank`):
    the execution shape of a hyperparameter sweep and of multilayer
    graphs.  Output scales are folded into ``multiplier_bank`` and
    ``b_hat_bank``, so a fixed-weight mixture is a weighted sum of
    multipliers (:meth:`mixture`).
    """

    plan: NfftPlan
    b_hat_bank: torch.Tensor  # (S,) + (N,)*d, output scale folded in
    scaled_src: torch.Tensor
    kernel_at_zero: torch.Tensor  # (S,) corrected K(0) per member
    multiplier_bank: torch.Tensor  # (S,) + half-spectrum, scale folded in
    src_window: WindowGeometry
    scaled_tgt: torch.Tensor | None = None  # None: targets = sources
    tgt_window: WindowGeometry | None = None
    rho: float | None = None
    fs_params: FastsumParams | None = None

    @property
    def size(self) -> int:
        return self.multiplier_bank.shape[0]

    @property
    def n_source(self) -> int:
        return self.scaled_src.shape[0]

    @property
    def _tgt_window(self) -> WindowGeometry:
        return self.src_window if self.tgt_window is None else self.tgt_window

    def _operator(self, b_hat, kernel_at_zero, multiplier_half):
        return FastsumOperator(
            plan=self.plan, b_hat=b_hat, scaled_src=self.scaled_src,
            output_scale=1.0, kernel_at_zero=kernel_at_zero,
            multiplier_half=multiplier_half, src_window=self.src_window,
            rho=self.rho, fs_params=self.fs_params,
            scaled_tgt=self.scaled_tgt, tgt_window=self.tgt_window)

    def member(self, s: int) -> FastsumOperator:
        """Member ``s`` as a plain :class:`FastsumOperator` on the bank's
        geometry; its output scale is folded in, so ``output_scale`` is 1."""
        return self._operator(self.b_hat_bank[s], self.kernel_at_zero[s],
                              self.multiplier_bank[s])

    def mixture(self, weights) -> FastsumOperator:
        """Collapse ``sum_s w_s W̃_s`` to ONE operator: its multiplier is the
        weighted sum of the members', so the mixture costs one fused matvec
        per application, not S."""
        w = torch.as_tensor(weights, dtype=self.kernel_at_zero.dtype,
                            device=self.kernel_at_zero.device)
        if tuple(w.shape) != (self.size,):
            raise ValueError(f"weights must have shape ({self.size},), "
                             f"got {tuple(w.shape)}")
        return self._operator(
            torch.tensordot(w.to(self.b_hat_bank.dtype), self.b_hat_bank,
                            dims=1),
            torch.dot(w, self.kernel_at_zero),
            torch.tensordot(w.to(self.multiplier_bank.dtype),
                            self.multiplier_bank, dims=1))

    def matvec_tilde(self, x: torch.Tensor) -> torch.Tensor:
        """Bank kernel sums (diagonal K(0) included).

        ``x`` (n,) / (n, C): broadcast, every member on the same right-hand
        sides -> (S, n) / (S, n, C).  ``x`` (S, n, C): lockstep, member
        ``s`` on ``x[s]``.  Either way one spread, one rfftn, one batched
        irfftn and one gather.
        """
        return fastsum_exec.fused_matvec_tilde_bank(
            self.plan, self.multiplier_bank, self.src_window,
            self._tgt_window, x)

    def matvec_tilde_columns(self, u: torch.Tensor) -> torch.Tensor:
        """Lockstep bank matvec in flat columns: (n, S*C) -> (n, S*C), with
        column ``s*C + j`` belonging to member ``s`` (bank-major), the
        layout :func:`repro_torch.graph.krr.krr_fit_sweep` iterates on."""
        return fastsum_exec.fused_matvec_tilde_bank_columns(
            self.plan, self.multiplier_bank, self.src_window,
            self._tgt_window, u)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[s] = (W̃_s - K_s(0) I) x (or x[s] in the lockstep flavour)."""
        if self.scaled_tgt is not None:
            raise ValueError(
                "FastsumOperatorBank.matvec subtracts the K(0) diagonal, "
                "which is only defined when source and target nodes "
                "coincide; this bank was built with target_points — use "
                "matvec_tilde for rectangular kernel sums.")
        out = self.matvec_tilde(x)  # (S, n[, C])
        k0 = self.kernel_at_zero.to(out.dtype).reshape(
            (self.size,) + (1,) * (out.ndim - 1))
        return out - k0 * x


def make_fastsum_bank(kernels, points, params: FastsumParams, *,
                      target_points=None,
                      device: str | torch.device | None = None
                      ) -> FastsumOperatorBank:
    """Plan a bank of Algorithm 3.1 operators over shared ``points``, one
    member per kernel: the node scaling, the NFFT plan and the window
    geometries are computed once, only the multipliers per member."""
    kernels = tuple(kernels)
    if not kernels:
        raise ValueError("make_fastsum_bank needs at least one kernel")
    pts = _as_points(points, device)
    scaled, scaled_tgt, rho, plan, window, tgt_window = _scaled_plan(
        pts, params, target_points)
    b_hats, mults, k0s = [], [], []
    for kernel in kernels:
        b_hat, mult_half, out_scale, k0 = _member_spectral(
            kernel, rho, plan, params, pts.device)
        # fold the rho**exponent output correction into the linear
        # spectral data, so members need no post-scale
        b_hats.append(b_hat * out_scale)
        mults.append(mult_half * out_scale)
        k0s.append(k0)
    b_hat_bank = torch.stack(b_hats)
    rdt = b_hat_bank.real.dtype
    return FastsumOperatorBank(
        plan=plan, b_hat_bank=b_hat_bank, scaled_src=scaled,
        kernel_at_zero=torch.stack([torch.as_tensor(k, dtype=rdt,
                                                    device=pts.device)
                                    for k in k0s]),
        multiplier_bank=torch.stack(mults), src_window=window,
        scaled_tgt=scaled_tgt, tgt_window=tgt_window, rho=rho,
        fs_params=params)


def fastsum_bank_from_arrays(arrays: dict, params: FastsumParams, *,
                             device: str | torch.device | None = None
                             ) -> FastsumOperatorBank:
    """A square :class:`FastsumOperatorBank` from a planned bank's arrays.

    ``arrays`` maps ``multiplier_bank``, ``b_hat_bank``, ``kernel_at_zero``,
    ``scaled_src``, ``src_window.base``, ``src_window.weights`` and
    ``src_window.perm`` to numpy arrays (the leaves of
    ``repro.core.fastsum.FastsumOperatorBank``), so that execution can be
    checked apart from planning, as with :func:`fastsum_from_arrays`.
    """
    dev = resolve_device(device)

    def tensor(key):
        return torch.as_tensor(np.array(arrays[key]), device=dev)

    scaled = tensor("scaled_src")
    return FastsumOperatorBank(
        plan=params.nfft_plan(scaled.shape[1]),
        b_hat_bank=tensor("b_hat_bank"), scaled_src=scaled,
        kernel_at_zero=tensor("kernel_at_zero"),
        multiplier_bank=tensor("multiplier_bank"),
        src_window=WindowGeometry.from_sorted(tensor("src_window.base"),
                                              tensor("src_window.weights"),
                                              tensor("src_window.perm")),
        fs_params=params)


@dataclasses.dataclass
class NormalizedAdjacencyOperator:
    """Algorithm 3.2: ``x -> A x``, ``A = D^{-1/2} W D^{-1/2}`` (symmetric)."""

    fastsum: FastsumOperator
    inv_sqrt_deg: torch.Tensor  # (n,)
    degrees: torch.Tensor  # (n,)

    @property
    def n(self) -> int:
        return self.inv_sqrt_deg.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.inv_sqrt_deg if x.ndim == 1 else self.inv_sqrt_deg[:, None]
        return scale * self.fastsum.matvec(scale * x)

    def laplacian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L_s x = x - A x."""
        return x - self.matvec(x)

    def stochastic_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """P x = D^{-1} W x."""
        inv_deg = self.inv_sqrt_deg ** 2
        scale = inv_deg if x.ndim == 1 else inv_deg[:, None]
        return scale * self.fastsum.matvec(x)


def make_normalized_adjacency(kernel: Kernel, points, params: FastsumParams,
                              *, device: str | torch.device | None = None
                              ) -> NormalizedAdjacencyOperator:
    """Algorithm 3.2 on ``points`` (n, d); ``device`` defaults to ``cuda``."""
    return _normalized_adjacency_from(
        make_fastsum(kernel, points, params, device=device))


def _normalized_adjacency_from(fs) -> NormalizedAdjacencyOperator:
    """Algorithm 3.2 over any operator with ``matvec`` and ``degrees``
    (a :class:`FastsumOperator` or the guard's direct floor)."""
    deg = fs.degrees()
    # Lemma 3.1 needs the approximation error below the smallest degree;
    # clamp so D^{-1/2} stays real where it is not
    deg = torch.clamp(deg, min=torch.finfo(deg.dtype).tiny)
    return NormalizedAdjacencyOperator(fastsum=fs,
                                       inv_sqrt_deg=1.0 / torch.sqrt(deg),
                                       degrees=deg)


def make_normalized_adjacency_mixture(kernels, weights, points,
                                      params: FastsumParams, *,
                                      device: str | torch.device | None = None
                                      ) -> NormalizedAdjacencyOperator:
    """Algorithm 3.2 for an aggregated multilayer weight matrix
    ``W = sum_l w_l (W̃_l - K_l(0) I)`` (Bergermann–Stoll–Volkmer 2020).

    The layers share nodes, so the mixture collapses to one summed
    multiplier (:meth:`FastsumOperatorBank.mixture`): each matvec of the
    multilayer adjacency costs one fused pipeline, as a single layer's.
    """
    bank = make_fastsum_bank(kernels, points, params, device=device)
    return _normalized_adjacency_from(bank.mixture(weights))


# ---------------------------------------------------------------------------
# Dense references (test and smoke oracles).
# ---------------------------------------------------------------------------

def dense_weight_matrix(kernel: Kernel, points: torch.Tensor) -> torch.Tensor:
    """W with zero diagonal (Eq. 2.3).  O(n^2) memory."""
    diff = points[:, None, :] - points[None, :, :]
    r = torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=0.0))
    w = kernel.phi(r)
    return w - torch.diag(torch.diag(w))


def dense_normalized_adjacency(kernel: Kernel,
                               points: torch.Tensor) -> torch.Tensor:
    w = dense_weight_matrix(kernel, points)
    inv_sqrt = 1.0 / torch.sqrt(w.sum(dim=1))
    return inv_sqrt[:, None] * w * inv_sqrt[None, :]


def direct_matvec_tiled(kernel: Kernel, points: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """W x with zero diagonal, exact, in O(n^2) operations (the paper's
    direct-method baseline); ``x`` (n,) or (n, C).

    Never materializes W: on the card it is the hand-written kernel of
    :func:`repro_torch.kernels.kernel_matvec.kernel_matvec`, on the CPU its
    plain version in row tiles.  The profile is evaluated on r^2, so it
    agrees with ``kernel.phi(r)`` to round-off.
    """
    (param,) = kernel.params.values()  # sigma or c
    return kernel_matvec(points, points, x, kernel_name=kernel.name,
                         param=param, zero_diagonal=True)
