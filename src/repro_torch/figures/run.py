"""Figure aggregator: one module per paper figure (twin of
``benchmarks/run.py``'s figure part).

    PYTHONPATH=src python -m repro_torch.figures.run [--only fig3,fig5] \
        [--full] [--device cpu]

Quick sizes by default; ``--full`` (or REPRO_BENCH_FULL=1) for the paper's
protocol sizes.  Runs on the CUDA card unless ``--device`` names another
device.  Reports go to ``$REPRO_BENCH_DIR`` (default
``experiments/bench``) as ``torch_<figure>.json``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback

MODULES = [
    ("fig3", "repro_torch.figures.fig3_eigenvalues",
     "Fig 3: eigenvalue accuracy + runtime (NFFT-Lanczos, Nyström, "
     "hybrid)"),
    ("fig5", "repro_torch.figures.fig5_segmentation",
     "Fig 5: image segmentation via spectral clustering"),
    ("fig6", "repro_torch.figures.fig6_phasefield",
     "Fig 6: Allen-Cahn phase-field SSL accuracy"),
    ("fig7", "repro_torch.figures.fig7_kernel_ssl",
     "Fig 7: kernel SSL misclassification (Gaussian)"),
    ("fig8", "repro_torch.figures.fig8_kernel_ssl_laplacian",
     "Fig 8: kernel SSL misclassification (Laplacian RBF)"),
    ("fig9", "repro_torch.figures.fig9_krr",
     "Fig 9: kernel ridge regression decision boundaries"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of keys: fig3,fig5,fig6,fig7,fig8,fig9")
    ap.add_argument("--full", action="store_true",
                    help="the paper's protocol sizes (slow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.full:
        os.environ["REPRO_BENCH_FULL"] = "1"
    keys = args.only.split(",") if args.only else [k for k, _, _ in MODULES]
    unknown = set(keys) - {k for k, _, _ in MODULES}
    if unknown:
        ap.error(f"unknown figures {sorted(unknown)}")
    failures = []
    for key, module, desc in MODULES:
        if key not in keys:
            continue
        print(f"\n=== {key}: {desc} ===", flush=True)
        t0 = time.perf_counter()
        try:
            importlib.import_module(module).run(device=args.device)
            print(f"--- {key} done in {time.perf_counter() - t0:.1f}s")
        except Exception:  # noqa: BLE001 — report every figure's failure
            failures.append(key)
            traceback.print_exc()
    if failures:
        print(f"\nFAILED figures: {failures}")
        return 1
    print("\nall figures complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
