"""Dense kernel-profile direct sum: the CUDA kernel and its plain version.

    y_j = sum_i K(||a_j - b_i||) x_i

for target points ``a`` (n_out, d), source points ``b`` (n_in, d) and
values ``x`` (n_in,) or (n_in, C), with the profile evaluated on squared
radii (:func:`kernel_profile_r2`) and, with ``zero_diagonal``, the entries
``row == col`` masked by index (also for two different point sets, as the
JAX package does).  It never materializes the n_out x n_in matrix on the
card: the paper's direct-method baseline, the exact floor of the accuracy
guard, and the rectangular oracle of kernel ridge regression.

Replaces the TPU kernel ``src/repro/kernels/kernel_matvec.py:_matvec_kernel``
(its oracle is ``src/repro/kernels/ref.py:kernel_matvec_ref``).  A tensor on
the CPU takes :func:`kernel_matvec_plain`; a CUDA tensor launches the
hand-written kernel in ``csrc/kernel_matvec.cu`` or raises.  The wrapper
counts its launches in ``kernel_matvec.launches``.  The kernel adds in a
fixed order, so its result is the same from run to run.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the order is the kernel's Profile enum (csrc/kernel_matvec.cu)
PROFILES = ("gaussian", "laplacian_rbf", "multiquadric",
            "inverse_multiquadric")
# largest d the CUDA kernel takes (kMaxD in csrc/kernel_matvec.cu)
MAX_D = 8
_FLOATS = (torch.float32, torch.float64)
# bounds the plain version's (rows, n_in, d) difference tile, in elements
_PLAIN_TILE_ELEMS = 1 << 25


def kernel_profile_r2(r2: torch.Tensor, kernel_name: str,
                      param: float) -> torch.Tensor:
    """Kernel profile evaluated on *squared* radii (all four paper kernels)."""
    if kernel_name == "gaussian":
        return torch.exp(-r2 / (param * param))
    if kernel_name == "laplacian_rbf":
        return torch.exp(-torch.sqrt(torch.clamp(r2, min=0.0)) / param)
    if kernel_name == "multiquadric":
        return torch.sqrt(r2 + param * param)
    if kernel_name == "inverse_multiquadric":
        return 1.0 / torch.sqrt(r2 + param * param)
    raise ValueError(f"unknown kernel {kernel_name!r}")


def kernel_matvec_plain(points_out: torch.Tensor, points_in: torch.Tensor,
                        x: torch.Tensor, *, kernel_name: str = "gaussian",
                        param: float = 1.0,
                        zero_diagonal: bool = True) -> torch.Tensor:
    """Plain version of :func:`kernel_matvec`: row tiles of broadcast
    differences -> profile -> zero diagonal -> ``@ x``."""
    x2 = x[:, None] if x.ndim == 1 else x
    n_out, d = points_out.shape
    n_in = points_in.shape[0]
    out = torch.empty((n_out, x2.shape[1]), dtype=x.dtype, device=x.device)
    step = max(1, _PLAIN_TILE_ELEMS // max(1, n_in * d))
    for s in range(0, n_out, step):
        diff = points_out[s:s + step, None, :] - points_in[None, :, :]
        w = kernel_profile_r2((diff * diff).sum(dim=-1), kernel_name, param)
        if zero_diagonal:
            # entries (r, s + r): global row index == column index
            w.diagonal(offset=s).zero_()
        out[s:s + step] = w @ x2
    return out[:, 0] if x.ndim == 1 else out


def kernel_matvec(points_out: torch.Tensor, points_in: torch.Tensor,
                  x: torch.Tensor, *, kernel_name: str = "gaussian",
                  param: float = 1.0,
                  zero_diagonal: bool = True) -> torch.Tensor:
    """y_j = sum_i K(||points_out_j - points_in_i||) x_i.

    points_out: (n_out, d); points_in: (n_in, d); x: (n_in,) or (n_in, C),
    all of one float dtype on one device.  ``param`` is sigma (Gaussian,
    Laplacian RBF) or c (the multiquadrics).  Returns (n_out,) or
    (n_out, C).
    """
    if points_out.ndim != 2 or points_in.ndim != 2 \
            or points_out.shape[1] != points_in.shape[1]:
        raise ValueError(f"points must be (n_out, d) and (n_in, d), got "
                         f"{tuple(points_out.shape)} and "
                         f"{tuple(points_in.shape)}")
    if x.ndim not in (1, 2) or x.shape[0] != points_in.shape[0]:
        raise ValueError(f"x must be ({points_in.shape[0]},) or "
                         f"({points_in.shape[0]}, C), got {tuple(x.shape)}")
    if kernel_name not in PROFILES:
        raise ValueError(f"unknown kernel {kernel_name!r}")
    if x.dtype not in _FLOATS or points_out.dtype != x.dtype \
            or points_in.dtype != x.dtype:
        raise TypeError(f"points and x must share float32 or float64, got "
                        f"{points_out.dtype}, {points_in.dtype}, {x.dtype}")
    if points_out.device != x.device or points_in.device != x.device:
        raise ValueError(f"points on {points_out.device} and "
                         f"{points_in.device}, x on {x.device}")
    if x.device.type == "cpu":
        return kernel_matvec_plain(points_out, points_in, x,
                                   kernel_name=kernel_name, param=param,
                                   zero_diagonal=zero_diagonal)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel_matvec kernel for device {x.device}")
    n_out, d = points_out.shape
    if d > MAX_D:
        raise ValueError(f"the CUDA kernel takes d <= {MAX_D}, got {d}")
    x2 = (x[:, None] if x.ndim == 1 else x).contiguous()
    c = x2.shape[1]
    out = torch.zeros((n_out, c), dtype=x.dtype, device=x.device)
    if n_out and c:
        a, b = points_out.contiguous(), points_in.contiguous()
        suffix = "f64" if x.dtype == torch.float64 else "f32"
        fn = getattr(_build.load_library("kernel_matvec.cu"),
                     f"repro_kernel_matvec_{suffix}")
        rc = fn(a.data_ptr(), b.data_ptr(), x2.data_ptr(), out.data_ptr(),
                n_out, b.shape[0], d, c, PROFILES.index(kernel_name),
                float(param), int(bool(zero_diagonal)),
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"repro_kernel_matvec_{suffix} failed to "
                               f"launch: CUDA error {rc}")
        kernel_matvec.launches += 1
    return out[:, 0] if x.ndim == 1 else out


kernel_matvec.launches = 0
