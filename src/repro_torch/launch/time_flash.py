"""Time the flash attention kernel at the heads of the paths that launch it.

    python src/repro_torch/launch/time_flash.py [--label NAME] [--reps 20]
        [--only granite,hubert,...] [--dtype bfloat16] [--json PATH]

bf16 (or ``--dtype float16``), b = 1, at each path's heads (hq on hkv,
s, dh): granite-3-2b (32 on 8, 2048, 64, causal), olmoe-1b-7b (16, 2048,
128, causal), hubert-xlarge (16, 4096, 80, non-causal) and gemma-7b (16,
2048, 256, causal); and hubert's heads at dh 64 and 128 beside its own
80, so that the time a unit of work at dh 80 can be set beside the head
dims whose rows are whole 128-byte swizzle regions.  Each is timed with
CUDA events over back-to-back calls after warm-up, beside its bound (4 dh
flops a visible (query, key) pair over the bf16 dense tensor-core peak, or
q, k, v read and o written once over the memory rate, whichever is
larger) and PyTorch's SDPA on its fused backends (a yardstick only: the
port never calls it), and held against its plain version (the largest
share of the two-ulp limit, 2e-5 + 2^-6 |p| in bf16 and 2e-5 + 2^-9 |p|
in f16).

The script imports ``repro_torch`` from ``sys.path`` like any user, so it
also times another checkout's kernel: run this file with ``PYTHONPATH`` set
to that checkout's ``src``.  Two versions are compared only within one
machine and one call, in turns (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import flash_attention as fa

# label -> (b, hq, hkv, s, dh, causal)
SHAPES = {"granite": (1, 32, 8, 2048, 64, True),
          "olmoe": (1, 16, 16, 2048, 128, True),
          "hubert": (1, 16, 16, 4096, 80, False),
          "gemma": (1, 16, 16, 2048, 256, True),
          "hubert@dh64": (1, 16, 16, 4096, 64, False),
          "hubert@dh128": (1, 16, 16, 4096, 128, False)}
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 rate
PEAK_BF16_TENSOR = 989e12
HBM_BYTES_PER_S = 3.35e12
# two ulps of the dtype, (atol, rtol)
TWO_ULPS = {"bfloat16": (2e-5, 2.0 ** -6), "float16": (2e-5, 2.0 ** -9)}


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


def bound(b, hq, hkv, s, dh, causal):
    """(ms, bound_by, flops) of the card's least time for the forward."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * dh * pairs
    nbytes = 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
    t_ops = flops / PEAK_BF16_TENSOR * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def measure(label: str, reps: int, dev, dname: str = "bfloat16") -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
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
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q, k, v, is_causal=causal,
                             enable_gqa=hq != hkv), reps)
    bound_ms, by, flops = bound(b, hq, hkv, s, dh, causal)
    return {"label": label, "b": b, "hq": hq, "hkv": hkv, "s": s, "dh": dh,
            "causal": causal, "dtype": dname, "ms": ms,
            "tflops": flops / ms / 1e9, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms,
            "sdpa_ms": lib_ms, "kernel_over_sdpa": ms / lib_ms,
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
        print(f"{args.label} flash {label:12s} hq={r['hq']} hkv={r['hkv']} "
              f"s={r['s']} dh={r['dh']} causal={r['causal']} {r['dtype']}: "
              f"{r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['bound_share']:.2f} %), SDPA {r['sdpa_ms']:.4f} ms "
              f"({r['kernel_over_sdpa']:.2f}x), {r['limit_share']:.3f} of "
              "the two-ulp limit", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
