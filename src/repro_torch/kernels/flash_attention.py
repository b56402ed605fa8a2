"""Flash attention (forward): the CUDA kernel and its plain version.

    o[b, h, t] = softmax_k(scale * q[b, h, t] . k[b, h // G, k]) v[b, h // G, k]

for q (b, hq, sq, dh) and k, v (b, hkv, sk, dh), with G = hq // hkv query
heads per KV head (GQA), scale 1/sqrt(dh) unless given, float32 running
max, normaliser and accumulator, and the output in q's dtype.  Causal
masking uses decode alignment: query t sees keys k <= t + (sk - sq).  A
causal row that sees no key (sq > sk and t < sq - sk) is 0 here; the JAX
oracle gives NaN there and the TPU kernel a mean over its zero-padded
tile, and the serving path never reaches such a row.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:_flash_kernel``
(its oracle is ``src/repro/kernels/ref.py:flash_attention_ref``).  A
tensor on the CPU takes :func:`flash_attention_plain`; a CUDA tensor
launches a hand-written kernel in ``csrc/flash_attention.cu`` or raises,
at every head dim in :data:`HEAD_DIMS`; :func:`design` names it.
bfloat16 and float16 take the wgmma kernel (K/V tiles copied by TMA, P
split into hi + lo in the input dtype for the PV product, so the result
stays within two ulps of the float32 attention; dh 80, hubert's, as a
64-column region in 128-byte swizzle and a 16-column tail in 32-byte
swizzle; dh 256, gemma's and paligemma's, with q staged in shared
memory).  float32 takes the TF32 tensor cores through ``mma.sync``
m16n8k8, each operand split into a TF32 high and low part and each
product taken as hi hi + hi lo + lo hi (one TF32 pass misses the float32
limit of 2e-5), with K/V tiles staged by ``cp.async``.  A ``meta``
tensor (the dry run) gets a ``meta`` result, and the kernel's :func:`work`
goes to the active trace counter, which counts the launch.  The wrapper
counts its launches on the card in ``flash_attention.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# head dims the CUDA kernels are built for (a template parameter): every
# registered config's attention head dim is one of them
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# ... of which the wgmma kernel takes bf16 / fp16 at these: all
WGMMA_HEAD_DIMS = HEAD_DIMS
# the kernel that runs, by dtype (at every head dim of HEAD_DIMS)
_DESIGN = {torch.float32: "mma.sync tf32x3", torch.bfloat16: "wgmma",
           torch.float16: "wgmma"}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
# bounds the plain version's (b, hq, rows, sk) logits tile, in elements
_PLAIN_TILE_ELEMS = 1 << 25


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (b, hq, sq, dh) and k, v one "
                         f"(b, hkv, sk, dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1 \
            or hq % k.shape[1] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}:"
                         " same batch and dh, and hq a multiple of hkv")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32, bfloat16 or float16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention` (the oracle's softmax
    attention, in float32, over row tiles of the logits)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / dh ** 0.5
    kk = k.float().repeat_interleave(hq // hkv, dim=1)
    vv = v.float().repeat_interleave(hq // hkv, dim=1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    keys = torch.arange(sk, device=q.device)
    step = max(1, _PLAIN_TILE_ELEMS // max(1, b * hq * sk))
    for s0 in range(0, sq, step):
        qs = q[:, :, s0:s0 + step].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qs, kk) * scale
        if causal:
            rows = torch.arange(s0, s0 + qs.shape[2], device=q.device)
            visible = keys[None, :] <= rows[:, None] + (sk - sq)
            logits = logits.masked_fill(~visible, float("-inf"))
        ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                           vv)
        if causal:  # rows with no visible key: softmax gave NaN
            ctx = ctx.masked_fill(~visible.any(dim=1)[:, None], 0.0)
        out[:, :, s0:s0 + step] = ctx.to(q.dtype)
    return out


def design(dtype: torch.dtype, dh: int) -> str:
    """The name of the CUDA kernel that a CUDA tensor of ``dtype`` at head
    dim ``dh`` launches: ``"wgmma"`` (bf16, f16) or ``"mma.sync tf32x3"``
    (float32: TF32 ``mma.sync``, three products of split operands)."""
    if dtype not in _DESIGN or dh not in HEAD_DIMS:
        raise ValueError(f"no flash_attention kernel for {dtype} at dh {dh}")
    return _DESIGN[dtype]


def work(b: int, hq: int, hkv: int, sq: int, sk: int, dh: int,
         causal: bool, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one attention forward: 4 dh FLOPs per visible
    (query, key) pair (QK^T and PV); q, k, v read once and o written
    once."""
    if causal:  # row t sees keys [0, t + sk - sq], clipped to [0, sk)
        rows = np.arange(sq)
        pairs = int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())
    else:
        pairs = sq * sk
    flops = 4 * b * hq * dh * pairs
    nbytes = itemsize * (2 * b * hq * sq * dh + 2 * b * hkv * sk * dh)
    return flops, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention forward.  q: (b, hq, sq, dh); k, v: (b, hkv, sk, dh),
    one float dtype on one device.  Returns (b, hq, sq, dh) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "meta":
        from repro_torch.launch.roofline import add_kernel_work
        b, hq, sq, dh = q.shape
        add_kernel_work("flash_attention", *work(
            b, hq, k.shape[1], sq, k.shape[2], dh, causal, q.element_size()))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash_attention kernel takes dh in "
                         f"{HEAD_DIMS}, got {dh}")
    if b * hq > 65535:
        raise ValueError(f"b * hq = {b * hq} exceeds the kernel's grid "
                         "(65535)")
    if scale is None:
        scale = 1.0 / dh ** 0.5
    # the kernels copy rows in 16-byte pieces
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    suffix = _SUFFIX[q.dtype]
    fn = getattr(_build.load_library("flash_attention.cu"),
                 f"repro_flash_attention_{suffix}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, sk, dh, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"repro_flash_attention_{suffix} failed to "
                           f"launch: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
