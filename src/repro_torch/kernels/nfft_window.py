"""NFFT window spread and gather: CUDA kernels and their plain versions.

The window step of the NFFT on the fused engine's separable geometry
(:class:`repro_torch.core.nfft.WindowGeometry`): per-node patch corner
``base`` (n, d) int32 in padded-grid coordinates and per-dimension weights
(n, d, taps).  The grid is the wrap-padded grid ``(P,)*d + (C,)``,
channels last, so no wrapping logic lives in the kernels; the fold-back of
the periodic pad is the caller's job.

* :func:`window_spread` — scatter-add each node's ``(taps,)^d`` window
  times its C values onto the grid.  Replaces the TPU kernel
  ``src/repro/kernels/nfft_window.py:_spread_kernel``.
* :func:`window_gather` — the exact transpose: contract each node's grid
  patch with its weight cube, giving (n, C).  Replaces
  ``src/repro/kernels/nfft_window.py:_gather_kernel``.

A tensor on the CPU takes the plain PyTorch version (same semantics as
``repro.kernels.ref``); a CUDA tensor launches the hand-written kernel in
``csrc/nfft_window.cu`` or raises.  Each wrapper counts its launches in a
``launches`` attribute.  The CUDA spread uses atomics, so its float sum
order, and its result's last bits, vary from run to run.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.float64)
# nodes per chunk of the plain versions: bounds the materialized cube at
# ~2^24 elements per channel
_PLAIN_CUBE_ELEMS = 1 << 24


def _check_geometry(base: torch.Tensor, weights: torch.Tensor,
                    device: torch.device, dtype: torch.dtype):
    if weights.ndim != 3:
        raise ValueError(f"weights must be (n, d, taps), got {tuple(weights.shape)}")
    n, d, taps = weights.shape
    if not 1 <= d <= 3:
        raise ValueError(f"d must be 1, 2 or 3, got {d}")
    if taps < 1:
        raise ValueError(f"taps must be >= 1, got {taps}")
    if tuple(base.shape) != (n, d):
        raise ValueError(f"base must be {(n, d)}, got {tuple(base.shape)}")
    if base.dtype != torch.int32:
        raise TypeError(f"base must be int32, got {base.dtype}")
    if weights.dtype != dtype:
        raise TypeError(f"weights are {weights.dtype}, values are {dtype}")
    if dtype not in _FLOATS:
        raise TypeError(f"values must be float32 or float64, got {dtype}")
    for name, t in (("base", base), ("weights", weights)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")
    return n, d, taps


def _launch(entry: str, args, device: torch.device) -> None:
    for t in args[:4]:
        if not t.is_contiguous():
            raise ValueError("the CUDA window kernels need contiguous tensors")
    fn = getattr(_build.load_library("nfft_window.cu"), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*(t.data_ptr() for t in args[:4]), *args[4:], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def window_spread(x: torch.Tensor, base: torch.Tensor, weights: torch.Tensor,
                  *, padded_size: int) -> torch.Tensor:
    """Scatter-add separable node windows onto the padded grid.

    x: (n, C); base: (n, d) int32 with ``0 <= base`` and
    ``base + taps <= padded_size``; weights: (n, d, taps), x's dtype.
    Returns the padded grid ``(padded_size,)*d + (C,)``.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be (n, C), got {tuple(x.shape)}")
    n, d, taps = _check_geometry(base, weights, x.device, x.dtype)
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} rows, geometry has {n}")
    if padded_size < taps:
        raise ValueError(f"padded_size {padded_size} < taps {taps}")
    if x.device.type == "cpu":
        return window_spread_plain(x, base, weights, padded_size=padded_size)
    if x.device.type != "cuda":
        raise ValueError(f"no window_spread kernel for device {x.device}")
    c = x.shape[1]
    grid = torch.zeros((padded_size,) * d + (c,), dtype=x.dtype,
                       device=x.device)
    if n == 0 or c == 0:
        return grid
    _launch(f"repro_window_spread_{_suffix(x.dtype)}",
            (x, base, weights, grid, n, d, taps, c, padded_size), x.device)
    window_spread.launches += 1
    return grid


window_spread.launches = 0


def window_gather(grid: torch.Tensor, base: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Gather separable node windows from the padded grid -> (n, C).

    grid: ``(P,)*d + (C,)``; base/weights as in :func:`window_spread`.
    """
    n, d, taps = _check_geometry(base, weights, grid.device, grid.dtype)
    if grid.ndim != d + 1 or len(set(grid.shape[:d])) != 1:
        raise ValueError(f"grid must be (P,)*{d} + (C,), got "
                         f"{tuple(grid.shape)}")
    padded_size, c = grid.shape[0], grid.shape[-1]
    if padded_size < taps:
        raise ValueError(f"padded grid {padded_size} < taps {taps}")
    if grid.device.type == "cpu":
        return window_gather_plain(grid, base, weights)
    if grid.device.type != "cuda":
        raise ValueError(f"no window_gather kernel for device {grid.device}")
    out = torch.empty((n, c), dtype=grid.dtype, device=grid.device)
    if n == 0 or c == 0:
        return out
    _launch(f"repro_window_gather_{_suffix(grid.dtype)}",
            (grid, base, weights, out, n, d, taps, c, padded_size),
            grid.device)
    window_gather.launches += 1
    return out


window_gather.launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (semantics of repro.kernels.ref.window_*_ref).
# They materialize the weight cube, chunked over nodes to bound memory.
# ---------------------------------------------------------------------------

def _chunk_rows(n: int, taps: int, d: int) -> int:
    return max(1, min(n, _PLAIN_CUBE_ELEMS // taps ** d))


def _weight_cube(w: torch.Tensor) -> torch.Tensor:
    """(t, d, taps) -> (t, taps**d), C order over the d tap axes."""
    t, d, taps = w.shape
    cube = w[:, 0]
    for ax in range(1, d):
        cube = cube[..., None] * w[:, ax].reshape((t,) + (1,) * ax + (taps,))
    return cube.reshape(t, -1)


def _flat_cells(base: torch.Tensor, taps: int, padded_size: int) -> torch.Tensor:
    """(t, d) corners -> (t, taps**d) int64 row indices of the flat grid."""
    d = base.shape[1]
    offs = torch.arange(taps, device=base.device)
    cube = offs
    corner = base[:, 0].to(torch.long)
    for ax in range(1, d):
        cube = (cube[..., None] * padded_size + offs).reshape(-1)
        corner = corner * padded_size + base[:, ax]
    return corner[:, None] + cube[None, :]


def window_spread_plain(x: torch.Tensor, base: torch.Tensor,
                        weights: torch.Tensor, *,
                        padded_size: int) -> torch.Tensor:
    """Plain version of :func:`window_spread` (``index_add_`` of the cube)."""
    n, d, taps = weights.shape
    c = x.shape[1]
    flat = torch.zeros((padded_size ** d, c), dtype=x.dtype, device=x.device)
    step = _chunk_rows(n, taps, d)
    for s in range(0, n, step):
        cube = _weight_cube(weights[s:s + step])
        idx = _flat_cells(base[s:s + step], taps, padded_size)
        updates = cube[..., None] * x[s:s + step, None, :]
        flat.index_add_(0, idx.reshape(-1), updates.reshape(-1, c))
    return flat.reshape((padded_size,) * d + (c,))


def window_gather_plain(grid: torch.Tensor, base: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`window_gather` (advanced-index take)."""
    n, d, taps = weights.shape
    padded_size, c = grid.shape[0], grid.shape[-1]
    flat = grid.reshape(-1, c)
    out = torch.empty((n, c), dtype=grid.dtype, device=grid.device)
    step = _chunk_rows(n, taps, d)
    for s in range(0, n, step):
        cube = _weight_cube(weights[s:s + step])
        idx = _flat_cells(base[s:s + step], taps, padded_size)
        vals = flat[idx]  # (t, taps**d, C)
        out[s:s + step] = (vals * cube[..., None]).sum(dim=1)
    return out
