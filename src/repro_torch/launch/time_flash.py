"""Time the flash attention kernel at the heads of the paths that launch it.

    python src/repro_torch/launch/time_flash.py [--label NAME] [--reps 20]
        [--only granite,hubert,...] [--dtype bfloat16] [--json PATH]

bf16 (or ``--dtype float16`` or ``float32``), b = 1, at each path's heads
(hq on hkv, s, dh): granite-3-2b (32 on 8, 2048, 64, causal), olmoe-1b-7b
(16, 2048, 128, causal), hubert-xlarge (16, 4096, 80, non-causal) and
gemma-7b (16, 2048, 256, causal); hubert's heads at dh 64 and 128 beside
its own 80, so that the time a unit of work at dh 80 can be set beside the
head dims whose rows are whole 128-byte swizzle regions; and the float32
paths' shapes: each rank's prefill under ``[shard_serve]`` (granite-3-2b
at (2, 2): b = 2, 16 on 4; at (1, 4): b = 4, 8 on 2; olmoe-1b-7b at (1,
4): b = 4, 4 on 4 at dh 128; s = 2048, causal) and reduced jamba's (4 on
1, 256, dh 16, causal); and llama3-405b (128 on 8, GQA 16:1) and
qwen1.5-32b (40 on 40), both at 2048 and dh 128, causal, in either dtype. Each is timed with CUDA events over back-to-back
calls after warm-up, and the device's time alone over the same calls
replayed from one CUDA graph, beside its bound (4 dh flops a visible
(query, key) pair over the dense tensor-core peak of the dtype,
``roofline.TENSOR_PEAK_FLOPS``: 989 TFLOP/s bf16 and fp16, 495 TF32 for
float32; or q, k, v read and o written once over the memory rate,
whichever is larger), for float32 the ceiling of three TF32 products a
pair (3 x flops / 495 TFLOP/s), and PyTorch's SDPA on its fused backends
(a yardstick only: the port never calls it; for float32 k and v are
expanded to hq heads before the timed window, since the efficient backend,
the fused one that takes float32, takes no ``enable_gqa``; inputs that no
fused backend takes raise), and held against its plain version (the
largest share of the limit: two ulps, 2e-5 + 2^-6 |p| in bf16 and 2e-5 +
2^-9 |p| in f16; 2e-5 in float32).

The script imports ``repro_torch`` from ``sys.path`` like any user, so it
also times another checkout's kernel: run this file with ``PYTHONPATH`` set
to that checkout's ``src`` (a checkout older than ``roofline.
TENSOR_PEAK_FLOPS`` takes this checkout's ``roofline.py`` over its own,
which only adds to it).  Two versions are compared only within one machine
and one call, in turns (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import roofline

# label -> (b, hq, hkv, s, dh, causal)
SHAPES = {"granite": (1, 32, 8, 2048, 64, True),
          "olmoe": (1, 16, 16, 2048, 128, True),
          "hubert": (1, 16, 16, 4096, 80, False),
          "gemma": (1, 16, 16, 2048, 256, True),
          "hubert@dh64": (1, 16, 16, 4096, 64, False),
          "hubert@dh128": (1, 16, 16, 4096, 128, False),
          "granite@rank22": (2, 16, 4, 2048, 64, True),
          "granite@rank14": (4, 8, 2, 2048, 64, True),
          "olmoe@rank14": (4, 4, 4, 2048, 128, True),
          "jamba": (1, 4, 1, 256, 16, True),
          "llama": (1, 128, 8, 2048, 128, True),
          "qwen": (1, 40, 40, 2048, 128, True)}
# the limit of the dtype, (atol, rtol): two ulps; float32 2e-5 absolute
TWO_ULPS = {"bfloat16": (2e-5, 2.0 ** -6), "float16": (2e-5, 2.0 ** -9),
            "float32": (2e-5, 0.0)}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """The device's time a call: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work sits between the kernels (at a
    latency-bound shape ``time_ms`` reads the host's time a call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 3, 1) / reps


def bound(b, hq, hkv, s, dh, causal, dtype="bfloat16"):
    """(ms, bound_by, flops) of the card's least time for the forward:
    ``flash_attention.work`` over ``roofline.bound_ms`` at the dtype's
    tensor-core peak."""
    itemsize = 4 if dtype == "float32" else 2
    flops, nbytes = fa.work(b, hq, hkv, s, s, dh, causal, itemsize)
    ms, by = roofline.bound_ms(flops, nbytes,
                               roofline.TENSOR_PEAK_FLOPS[dtype])
    return ms, by, flops


def sdpa_ms(q, k, v, causal: bool, reps: int) -> float:
    """SDPA on its fused backends (the efficient one takes float32); raises
    where none takes these inputs.  GQA in float32: k and v expanded to
    q's heads first, outside the timed window."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = q.shape[1] != k.shape[1]
    if gqa and q.dtype == torch.float32:
        g = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
        gqa = False
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return time_ms(lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q, k, v, is_causal=causal, enable_gqa=gqa), reps)


def design_of(dtype, dh) -> str:
    """The wrapper's name for its kernel (a checkout older than
    ``flash_attention.design`` has none)."""
    return fa.design(dtype, dh) if hasattr(fa, "design") else "unnamed"


def measure(label: str, reps: int, dev, dname: str = "bfloat16") -> dict:
    b, hq, hkv, s, dh, causal = SHAPES[label]
    gen = torch.Generator(device=dev).manual_seed(s + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(getattr(torch, dname))
               for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    launches = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    if fa.flash_attention.launches != launches + 1:
        raise RuntimeError("flash_attention did not launch its kernel")
    want = fa.flash_attention_plain(q, k, v, causal=causal).float()
    atol, rtol = TWO_ULPS[dname]
    share = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    del got, want
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps)
    device_ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                         reps)
    plain_ms = time_ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=causal), 3, 1)
    lib_ms = sdpa_ms(q, k, v, causal, reps)
    bound_ms, by, flops = bound(b, hq, hkv, s, dh, causal, dname)
    ceiling = (roofline.tf32_split_ceiling_ms(flops)
               if dname == "float32" else None)
    return {"label": label, "b": b, "hq": hq, "hkv": hkv, "s": s, "dh": dh,
            "causal": causal, "dtype": dname,
            "design": design_of(q.dtype, dh), "ms": ms,
            "device_ms": device_ms,
            "tflops": flops / ms / 1e9, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms,
            "ceiling_ms": ceiling,
            "ceiling_share": ceiling / ms if ceiling else None,
            "plain_ms": plain_ms, "sdpa_ms": lib_ms,
            "kernel_over_sdpa": ms / lib_ms,
            "limit_share": share}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="",
                    help="a name printed on every line (e.g. the commit)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(SHAPES),
                    help="comma-separated labels of SHAPES")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(TWO_ULPS))
    ap.add_argument("--json", help="write the rows there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_flash.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}  torch {torch.__version__}", flush=True)
    rows = []
    for label in args.only.split(","):
        r = measure(label, args.reps, dev, args.dtype)
        r["card"] = card
        rows.append(r)
        ceiling = (f", ceiling {r['ceiling_ms']:.4f} ms "
                   f"({100 * r['ceiling_share']:.1f} %)"
                   if r["ceiling_ms"] else "")
        print(f"{args.label} flash {label:14s} b={r['b']} hq={r['hq']} "
              f"hkv={r['hkv']} s={r['s']} dh={r['dh']} causal={r['causal']} "
              f"{r['dtype']} ({r['design']}): {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms), "
              f"{r['tflops']:.1f} TFLOP/s, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_share']:.2f} %){ceiling}, "
              f"plain {r['plain_ms']:.3f} ms, SDPA {r['sdpa_ms']:.4f} ms "
              f"({r['kernel_over_sdpa']:.2f}x), "
              f"{r['limit_share']:.3f} of the limit", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
