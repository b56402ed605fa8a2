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
hand-written kernel in ``csrc/kernel_matvec.cu`` or raises; a ``meta``
tensor (the dry run) gets a ``meta`` result, and the kernel's :func:`work`
goes to the active trace counter, which counts the launch.  The wrapper
counts its launches on the card in ``kernel_matvec.launches``.  The
kernel adds in a fixed order, so its result is the same from run to run.

On the card the sources are cut into S contiguous splits
(:func:`choose_splits`), each summed by its own blocks; S > 1 sums go to a
scratch array and a second kernel adds them in split order.  Each row's
sum runs over its split's sources in tiles of :data:`SOURCE_TILE`: the
sources of a tile added one by one, the tiles' sums added in order.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

# the order is the kernel's Profile enum (csrc/kernel_matvec.cu)
PROFILES = ("gaussian", "laplacian_rbf", "multiquadric",
            "inverse_multiquadric")
# operations a pair for each profile of the squared radius
PROFILE_OPS = {"gaussian": 2, "laplacian_rbf": 3, "multiquadric": 2,
               "inverse_multiquadric": 3}
# largest d the CUDA kernel takes (kMaxD in csrc/kernel_matvec.cu)
MAX_D = 8
_FLOATS = (torch.float32, torch.float64)
# bounds the plain version's (rows, n_in, d) difference tile, in elements
_PLAIN_TILE_ELEMS = 1 << 25
# The CUDA kernel's shape (csrc/kernel_matvec.cu): threads per block,
# sources per shared-memory tile; target rows per thread by channel chunk.
BLOCK_THREADS = 128
SOURCE_TILE = 64
# Source splits: enough (row block, split) blocks for BLOCKS_PER_SM per SM
# (about two waves at the four blocks of 128 threads an SM holds at ~100
# registers a thread), at most MAX_SPLITS, and a scratch array of at most
# SCRATCH_ELEMS values.
BLOCKS_PER_SM = 8
MAX_SPLITS = 1024
SCRATCH_ELEMS = 1 << 24


def channel_chunk(c: int) -> int:
    """Channels the kernel accumulates per pass over the sources."""
    return 1 if c == 1 else 4 if c <= 4 else 8


def rows_per_thread(c: int, d: int) -> int:
    """Target rows each kernel thread owns (R): four independent chains at
    one channel and d = 2, 3; fewer where the coordinates (the generic d
    path keeps 8 a row) or a wider channel chunk's sums take more
    registers."""
    if channel_chunk(c) == 1:
        return 4 if d in (2, 3) else 2
    return 1


def split_length(n_in: int, splits: int) -> int:
    """Sources per split: a whole number of tiles, as even as that allows."""
    tiles = -(-n_in // SOURCE_TILE)
    return -(-tiles // max(1, splits)) * SOURCE_TILE


def choose_splits(n_out: int, n_in: int, d: int, c: int,
                  sm_count: int) -> int:
    """Source splits S for one launch on a card with ``sm_count`` SMs.

    The grid is (row blocks x S).  Where the row blocks alone give every SM
    BLOCKS_PER_SM blocks, S = 1; else S is what brings the grid there,
    capped by the source tiles, MAX_SPLITS and the scratch budget, and
    rounded to the splits that :func:`split_length` actually makes.
    """
    if n_out < 1 or n_in < 1:
        return 1
    row_blocks = -(-n_out // (BLOCK_THREADS * rows_per_thread(c, d)))
    target = BLOCKS_PER_SM * sm_count
    if row_blocks >= target:
        return 1
    want = min(-(-target // row_blocks), -(-n_in // SOURCE_TILE), MAX_SPLITS,
               max(1, SCRATCH_ELEMS // (n_out * c)))
    return -(-n_in // split_length(n_in, want))


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


def work(n_out: int, n_in: int, d: int, c: int, profile: str,
         dtype_name: str, zero_diagonal: bool) -> tuple:
    """(FLOPs, bytes) of one direct sum: per pair d subtractions and d
    multiply-adds (3d), the profile's operations, and 2C for the
    accumulation; each input read once and each output written once."""
    s = 8 if dtype_name == "float64" else 4
    pairs = n_out * n_in - (min(n_out, n_in) if zero_diagonal else 0)
    flops = pairs * (3 * d + PROFILE_OPS[profile] + 2 * c)
    nbytes = s * (n_out * d + n_in * (d + c) + n_out * c)
    return flops, nbytes


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if x.device.type == "meta":
        from repro_torch.launch.roofline import add_kernel_work
        n_out, d = points_out.shape
        c = 1 if x.ndim == 1 else x.shape[1]
        add_kernel_work("kernel_matvec", *work(
            n_out, points_in.shape[0], d, c, kernel_name,
            str(x.dtype).replace("torch.", ""), zero_diagonal))
        return torch.empty((n_out,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device="meta")
    if x.device.type == "cpu":
        return kernel_matvec_plain(points_out, points_in, x,
                                   kernel_name=kernel_name, param=param,
                                   zero_diagonal=zero_diagonal)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel_matvec kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (points_out, points_in, param)):
        raise ValueError("the CUDA kernel_matvec has a gradient in x only: "
                         "the reference has no such gradient in the points "
                         "(NaN from sqrt at r = 0) or the kernel parameter "
                         "(a static argument); detach them or run on the "
                         "CPU")
    if torch.is_grad_enabled() and x.requires_grad:
        return _KernelMatvecX.apply(points_out, points_in, x, kernel_name,
                                    param, zero_diagonal)
    return _launch(points_out, points_in, x, kernel_name, param,
                   zero_diagonal)


class _KernelMatvecX(torch.autograd.Function):
    """The CUDA direct sum, differentiable in x: the backward is a second
    launch with the two point sets swapped.  For a radial kernel
    K(a_j, b_i) = K(b_i, a_j), and the masked entries row == col are the
    same after the swap, so that launch applies the exact transpose."""

    @staticmethod
    def forward(ctx, points_out, points_in, x, kernel_name, param,
                zero_diagonal):
        ctx.save_for_backward(points_out, points_in)
        ctx.kw = dict(kernel_name=kernel_name, param=param,
                      zero_diagonal=zero_diagonal)
        return _launch(points_out, points_in, x, kernel_name, param,
                       zero_diagonal)

    @staticmethod
    def backward(ctx, y_bar):
        points_out, points_in = ctx.saved_tensors
        x_bar = kernel_matvec(points_in, points_out, y_bar, **ctx.kw)
        return None, None, x_bar, None, None, None


def _launch(points_out, points_in, x, kernel_name, param,
            zero_diagonal) -> torch.Tensor:
    """One launch of the CUDA kernel (and its split-order sum)."""
    n_out, d = points_out.shape
    if d > MAX_D:
        raise ValueError(f"the CUDA kernel takes d <= {MAX_D}, got {d}")
    x2 = (x[:, None] if x.ndim == 1 else x).contiguous()
    c, n_in = x2.shape[1], points_in.shape[0]
    if not (n_out and c and n_in):
        out = torch.zeros((n_out, c), dtype=x.dtype, device=x.device)
        return out[:, 0] if x.ndim == 1 else out
    out = torch.empty((n_out, c), dtype=x.dtype, device=x.device)
    a, b = points_out.contiguous(), points_in.contiguous()
    splits = choose_splits(n_out, n_in, d, c, _sm_count(x.device))
    partial = (torch.empty((splits, n_out, c), dtype=x.dtype,
                           device=x.device) if splits > 1 else None)
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    fn = getattr(_build.load_library("kernel_matvec.cu"),
                 f"repro_kernel_matvec_{suffix}")
    rc = fn(a.data_ptr(), b.data_ptr(), x2.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), n_out, n_in, d,
            c, PROFILES.index(kernel_name), float(param),
            int(bool(zero_diagonal)), splits, split_length(n_in, splits),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"repro_kernel_matvec_{suffix} failed to launch: "
                           f"CUDA error {rc}")
    kernel_matvec.launches += 1
    return out[:, 0] if x.ndim == 1 else out


kernel_matvec.launches = 0
