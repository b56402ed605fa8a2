"""Rotation-invariant kernel functions (paper Section 2, Eq. (2.2)/(2.3)).

PyTorch counterpart of ``repro.core.kernels``.  A :class:`Kernel` exposes
the radial profile ``phi(r) = K(y)`` for ``r = ||y||`` on tensors, its value
at the origin, and the parameter rescaling of Algorithm 3.2 step 2 when
nodes are shrunk by the correction factor ``rho`` (Gaussian / Laplacian RBF
rescale ``sigma``; the (inverse) multiquadric rescale ``c`` and additionally
scale the *output*).  A parameter given as a number is kept as a Python
float; one given as a tensor stays that tensor, graph and all, so that
``at_zero``, ``rescaled`` and the spectral setup built on the kernel are
differentiable in sigma or c (the counterpart of the JAX package's traced
parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _as_param(v):
    """A tensor stays a tensor (it may carry a graph); anything else becomes
    a Python float, so kernels built from numbers compare by value."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _phi_gaussian(params):
    sigma = params["sigma"]

    def phi(r):
        return torch.exp(-(r * r) / (sigma * sigma))

    return phi


def _phi_laplacian_rbf(params):
    sigma = params["sigma"]

    def phi(r):
        return torch.exp(-r / sigma)

    return phi


def _phi_multiquadric(params):
    c = params["c"]

    def phi(r):
        return torch.sqrt(r * r + c * c)

    return phi


def _phi_inverse_multiquadric(params):
    c = params["c"]

    def phi(r):
        return 1.0 / torch.sqrt(r * r + c * c)

    return phi


# name -> (profile builder, output_scale_exponent)
_PHI_BUILDERS = {
    "gaussian": (_phi_gaussian, 0),
    "laplacian_rbf": (_phi_laplacian_rbf, 0),
    "multiquadric": (_phi_multiquadric, -1),
    "inverse_multiquadric": (_phi_inverse_multiquadric, 1),
}

GAUSSIAN = "gaussian"
LAPLACIAN_RBF = "laplacian_rbf"
MULTIQUADRIC = "multiquadric"
INVERSE_MULTIQUADRIC = "inverse_multiquadric"

ALL_KERNELS = (GAUSSIAN, LAPLACIAN_RBF, MULTIQUADRIC, INVERSE_MULTIQUADRIC)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A rotation-invariant kernel ``K(y) = phi(||y||)``.

    Attributes:
      name: one of :data:`ALL_KERNELS`.
      phi: radial profile, elementwise over a tensor of ``r >= 0``.
      params: ``{"sigma": value}`` or ``{"c": value}``, a float or a 0-d
        tensor.
      output_scale_exponent: after rescaling nodes by ``rho`` (and the
        parameters per :meth:`rescaled`), fast-summation outputs are
        multiplied by ``rho**output_scale_exponent`` to recover the
        original-kernel sums: 0 for Gaussian/Laplacian RBF, -1 for the
        multiquadric, +1 for the inverse multiquadric.
    """

    name: str
    phi: Callable[[torch.Tensor], torch.Tensor]
    params: dict
    output_scale_exponent: int = 0

    def __call__(self, r) -> torch.Tensor:
        return self.phi(torch.as_tensor(r))

    @property
    def param_device(self) -> torch.device | None:
        """The device of a tensor parameter; None for float parameters."""
        for value in self.params.values():
            if isinstance(value, torch.Tensor):
                return value.device
        return None

    def at_zero(self):
        """K(0), for the W = W̃ − K(0)·I correction: a float for float
        parameters, a 0-d tensor (on the parameter's device, carrying its
        graph) for a tensor parameter."""
        dev = self.param_device
        k0 = self.phi(torch.zeros((), dtype=torch.float64, device=dev))
        return float(k0) if dev is None else k0

    def rescaled(self, rho: float) -> "Kernel":
        """Kernel with parameters adjusted for nodes scaled by ``rho``
        (a tensor parameter keeps its graph)."""
        if self.name in (GAUSSIAN, LAPLACIAN_RBF):
            return make_kernel(self.name, sigma=self.params["sigma"] * rho)
        if self.name in (MULTIQUADRIC, INVERSE_MULTIQUADRIC):
            return make_kernel(self.name, c=self.params["c"] * rho)
        raise ValueError(f"unknown kernel {self.name!r}")


def make_kernel(name: str, *, sigma=None, c=None) -> Kernel:
    """Factory for the paper's four kernels (Section 2).

    ``sigma`` / ``c``: a number (kept as a float) or a 0-d tensor (kept,
    so that gradients reach it)."""
    if name not in _PHI_BUILDERS:
        raise ValueError(f"unknown kernel {name!r}")
    builder, exponent = _PHI_BUILDERS[name]
    if name in (GAUSSIAN, LAPLACIAN_RBF):
        if sigma is None:
            raise ValueError(f"kernel {name!r} needs sigma")
        params = {"sigma": _as_param(sigma)}
    else:
        if c is None:
            raise ValueError(f"kernel {name!r} needs c")
        params = {"c": _as_param(c)}
    return Kernel(name, builder(params), params,
                  output_scale_exponent=exponent)


#: The parameter each named kernel exposes (sigma or c), for parameter
#: sweeps and gradient-based model selection.
KERNEL_PARAM_NAME = {
    GAUSSIAN: "sigma",
    LAPLACIAN_RBF: "sigma",
    MULTIQUADRIC: "c",
    INVERSE_MULTIQUADRIC: "c",
}


def kernel_from_param(name: str, value) -> Kernel:
    """A named kernel from its one parameter (a number or a 0-d tensor)."""
    return make_kernel(name, **{KERNEL_PARAM_NAME[name]: value})
