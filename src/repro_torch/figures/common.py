"""Shared figure harness: timing, rows, result files.

The port's own copy of ``benchmarks/common.py``: the same
``REPRO_BENCH_DIR`` / ``REPRO_BENCH_FULL`` / ``QUICK`` variables, read
when used.  Report names carry a ``torch_`` prefix, so a port run never
overwrites the JAX package's reports.  :func:`timeit` ends each timed call
in ``torch.cuda.synchronize()`` when a card is present; the drivers run in
float64 (the paper's tiers need it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass
class Row:
    bench: str
    case: str
    value: float
    unit: str
    extra: dict = dataclasses.field(default_factory=dict)

    def format(self) -> str:
        extras = " ".join(f"{k}={v}" for k, v in self.extra.items())
        return (f"{self.bench:34s} {self.case:42s} {self.value:>12.6g} "
                f"{self.unit:10s} {extras}")


class Reporter:
    def __init__(self, name: str):
        self.name = f"torch_{name}"
        self.rows: list[Row] = []

    def add(self, case: str, value: float, unit: str, **extra) -> None:
        row = Row(self.name, case, float(value), unit, extra)
        self.rows.append(row)
        print(row.format(), flush=True)

    def save(self) -> str:
        results_dir = os.environ.get("REPRO_BENCH_DIR", "experiments/bench")
        os.makedirs(results_dir, exist_ok=True)
        path = os.path.join(results_dir, f"{self.name}.json")
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(r) for r in self.rows], f, indent=1)
        return path


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit(fn: Callable[[], Any], *, warmup: int = 1, repeats: int = 3
           ) -> tuple[float, Any]:
    """Median wall time (s) of fn(); each call ends in a device sync."""
    out = None
    for _ in range(warmup):
        out = fn()
        sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def quick() -> bool:
    """Quick mode is the default; REPRO_BENCH_FULL=1 opts into full sweeps.
    ``QUICK=1`` forces quick mode even if REPRO_BENCH_FULL is set."""
    if os.environ.get("QUICK") == "1":
        return True
    return os.environ.get("REPRO_BENCH_FULL", "0") != "1"


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (a reference
    ``jax.random.PRNGKey(seed)``'s counterpart; the numbers differ)."""
    return torch.Generator(device=device).manual_seed(seed)


def figure_args(argv, doc: str):
    """``--device`` (default: the card) and ``--sizes`` (the figure's
    problem sizes, comma separated; default: its quick or full list)."""
    import argparse

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated problem sizes")
    args = ap.parse_args(argv)
    sizes = None if args.sizes is None else [
        int(s) for s in args.sizes.split(",")]
    return args.device, sizes
