"""Time the kernel_matvec kernel at the shapes of the paths that launch it.

    python src/repro_torch/launch/time_kernel_matvec.py [--label NAME]
        [--reps 20] [--sass] [--json PATH]

Shapes, float64, C = 1, each path's own points and profile: the accuracy
guard's direct floor (spiral n = 8000, d = 3, Gaussian sigma = 3.5, zero
diagonal), kernel SSL's exact degrees (crescent-fullmoon n = 10^5, d = 2,
Gaussian sigma = 0.75), the direct baseline (spiral n = 10^5, d = 3) and
KRR's direct prediction (400 test x 10^4 training points, d = 2, Gaussian
sigma = 2 and inverse multiquadric c = 2, no zero diagonal).  Each is timed
with CUDA events over back-to-back calls after warm-up and held against its
plain version (max |k - p| / max |p|).

``--sass`` also counts, in the built kernel's SASS (``cuobjdump -sass``),
the FP64-pipe instructions of the loop that adds one source to R target
rows, divides them by R, and prints the ceiling that count sets at each
shape: pairs x instructions per pair over the card's FP64 issue rate (132
SMs x 64 FP64 lanes x 1.98 GHz = 34 TFLOP/s / 2, H100 SXM data sheet).
The loop's listing goes to ``--sass-out``.

The script imports ``repro_torch`` from ``sys.path`` like any user, so it
also times another checkout's kernel: run this file with ``PYTHONPATH`` set
to that checkout's ``src``.  Two versions are compared only within one
machine and one call, in turns (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

from repro_torch.data.synthetic import crescent_fullmoon, spiral
from repro_torch.kernels import _build, kernel_matvec as km

# (path, points, n_out, n_in, d, profile, param, zero_diagonal)
SHAPES = (("guard", "spiral", 8000, 8000, 3, "gaussian", 3.5, True),
          ("ssl", "ssl", 100_000, 100_000, 2, "gaussian", 0.75, True),
          ("direct", "spiral", 100_000, 100_000, 3, "gaussian", 3.5, True),
          ("krr_gaussian", "krr", 400, 10_000, 2, "gaussian", 2.0, False),
          ("krr_inverse_multiquadric", "krr", 400, 10_000, 2,
           "inverse_multiquadric", 2.0, False))
# FP64 instructions a second on the whole card (H100 SXM: 34 TFLOP/s of
# FMAs counted as two operations)
FP64_ISSUE_PER_S = 34e12 / 2
FP64_OPS = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}
# mangled-name parts of the first pass's instances: <double, D, profile,
# CH = 1, R>
_PROFILE_ID = {name: i for i, name in enumerate(km.PROFILES)}


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


def inputs(points: str, n_out: int, n_in: int, d: int, dev):
    """(a, b, x) float64 on ``dev``: as chip_smoke.py's kernel_matvec
    paths make them."""
    if points == "krr":
        pts, _ = crescent_fullmoon(n_in + n_out, seed=5)
        b = torch.as_tensor(pts[:n_in], device=dev)
        a = torch.as_tensor(pts[n_in:], device=dev)
    else:
        pts, _ = (crescent_fullmoon(n_in, seed=0) if points == "ssl"
                  else spiral(n_in, seed=0))
        a = b = torch.as_tensor(pts[:, :d], device=dev)
    gen = torch.Generator(device=dev).manual_seed(n_out)
    x = torch.randn((n_in, 1), generator=gen, dtype=torch.float64, device=dev)
    return a, b, x


def pairs(n_out: int, n_in: int, zero_diagonal: bool) -> int:
    return n_out * n_in - (min(n_out, n_in) if zero_diagonal else 0)


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_functions(library: Path) -> dict:
    """{function name: [(address, predicated, opcode, operands)]} of a
    library's SASS; labels are resolved to addresses in the operands."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            out[name].append((addr, bool(m.group(2)), m.group(3),
                              m.group(4)))
    for name, insns in out.items():
        out[name] = [(a, p, op, re.sub(
            r"`?\(?(\.L_x_\d+)\)?`?",
            lambda mm: hex(labels[name].get(mm.group(1), -1)), rest))
            for a, p, op, rest in insns]
    return out


def pair_loop(insns) -> tuple:
    """(opcode counts, listing) of the innermost loop that holds FP64
    work: the conditional backward branch with the smallest span."""
    best = None
    for addr, predicated, op, rest in insns:
        if op.split(".")[0] != "BRA" or not predicated:
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [i for i in insns if lo <= i[0] <= addr]
        if not any(i[2].split(".")[0] in FP64_OPS for i in body):
            continue
        if best is None or addr - lo < best[1] - best[0]:
            best = (lo, addr, body)
    if best is None:
        return Counter(), []
    ops = Counter(i[2].split(".")[0] for i in best[2])
    return ops, [f"/*{a:04x}*/ {op}{rest}" for a, _, op, rest in best[2]]


def sass_report(rows: list, listing_path: str | None) -> None:
    """FP64 instructions per pair of each shape's kernel instance, and the
    ceiling they set."""
    library = _build.build()["kernel_matvec.cu"]["path"]
    funcs = sass_functions(library)
    listing = []
    for row in rows:
        r = km.rows_per_thread(1, row["d"])
        d_path = row["d"] if row["d"] in (2, 3) else 0
        tag = (f"kernel_matvec_kernelIdLi{d_path}"
               f"ELi{_PROFILE_ID[row['profile']]}ELi1ELi{r}E")
        name = next((f for f in funcs if tag in f), None)
        if name is None:
            print(f"[sass] {row['path']}: no instance {tag}", flush=True)
            continue
        ops, lines = pair_loop(funcs[name])
        fp64 = sum(ops[o] for o in FP64_OPS)
        per_pair = fp64 / r
        ceiling = row["pairs"] * per_pair / FP64_ISSUE_PER_S * 1e3
        row.update(sass_fp64_per_pair=per_pair, sass_ceiling_ms=ceiling,
                   sass_loop_ops=dict(ops))
        mix = ", ".join(f"{o} {ops[o]}" for o in sorted(FP64_OPS) if ops[o])
        print(f"[sass] {row['path']}: {tag}: loop of {sum(ops.values())} "
              f"instructions for R = {r} pairs, {fp64} FP64 ({mix})"
              f" -> {per_pair:g} FP64 instructions a pair; ceiling "
              f"{ceiling:.4f} ms at {row['pairs']} pairs, kernel "
              f"{row['ms']:.4f} ms = {100 * ceiling / row['ms']:.1f}% of it",
              flush=True)
        listing += [f"== {row['path']} {name}"] + lines
    if listing_path:
        Path(listing_path).parent.mkdir(parents=True, exist_ok=True)
        Path(listing_path).write_text("\n".join(listing) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this version")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="count FP64 instructions per pair in the SASS")
    ap.add_argument("--sass-out", default=None,
                    help="write the pair loop's SASS listing here")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_matvec needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[device] {smi.stdout.strip() or torch.cuda.get_device_name(0)}",
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for path, points, n_out, n_in, d, kname, param, zd in SHAPES:
        a, b, x = inputs(points, n_out, n_in, d, dev)
        kw = dict(kernel_name=kname, param=param, zero_diagonal=zd)
        want = km.kernel_matvec_plain(a, b, x, **kw)
        got = km.kernel_matvec(a, b, x, **kw)
        rel = float((got - want).abs().max() / want.abs().max())
        again = km.kernel_matvec(a, b, x, **kw)
        ms = time_ms(lambda: km.kernel_matvec(a, b, x, **kw),
                     args.reps if n_in < 100_000 else max(3, args.reps // 4))
        splits = (km.choose_splits(n_out, n_in, d, 1, sms)
                  if hasattr(km, "choose_splits") else 1)
        row = {"label": args.label, "path": path, "profile": kname,
               "n_out": n_out, "n_in": n_in, "d": d, "c": 1,
               "dtype": "float64", "zero_diagonal": zd, "splits": splits,
               "pairs": pairs(n_out, n_in, zd), "ms": ms, "rel_err": rel,
               "repeatable": bool(torch.equal(got, again))}
        rows.append(row)
        print(f"[time] {args.label} kernel_matvec {path}: {kname} "
              f"{n_out}x{n_in} d={d} C=1 float64 zero_diag={zd}: {ms:.4f} ms"
              f" (S={splits}), rel err {rel:.2e}, repeatable "
              f"{row['repeatable']}", flush=True)
    if args.sass:
        sass_report(rows, args.sass_out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
