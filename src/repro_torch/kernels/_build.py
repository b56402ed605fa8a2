"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``csrc/`` is compiled at first use for ``sm_90a`` into a
shared library of its own, with a plain C interface, so no PyTorch headers
are involved; the ``nvcc`` processes of all sources run at the same time.
The libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout (an installed package uses ``repro_torch_kernels/`` under
``$XDG_CACHE_HOME`` or ``~/.cache``), each named by a hash of its source and
the flags, so a stale library is never loaded.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nfft_window.cu", "kernel_matvec.cu", "flash_attention.cu")
_PACKAGE = Path(__file__).resolve().parents[1]


def _build_dir() -> Path:
    """``build/`` of the checkout when running from ``src/``; else a
    per-user cache (an installed package has no checkout around it)."""
    if _PACKAGE.parent.name == "src":
        return _PACKAGE.parents[1] / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# (x|grid, base, weights, grid|out, tiles, n_tiles, d, taps, c, P, chunk,
#  max_cells, max_rows, pieces, stream)
_WINDOW_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32, _I32, _I64,
                _I32, _I32, _I32, _I32, _PTR]
# source -> ((argtypes, the entry points that share them), ...)
ENTRY_POINTS = {
    "nfft_window.cu": (
        (_WINDOW_ARGS,
         ("repro_window_spread_f64", "repro_window_spread_f32",
          "repro_window_gather_f64", "repro_window_gather_f32")),
        # ... + scratch, box_off, pair_tile, chunks, partial, arrivals,
        # waves (host), n_waves, side, pitch
        (_WINDOW_ARGS + [_PTR] * 7 + [_I32, _I32, _I32],
         ("repro_window_spread_det_f64", "repro_window_spread_det_f32"))),
    # (a, b, x, y, partial, n_out, n_in, d, c, profile, param,
    #  zero_diagonal, splits, split_len, stream)
    "kernel_matvec.cu": (
        ([_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I32, _I32, _I32,
          ctypes.c_double, _I32, _I32, _I64, _PTR],
         ("repro_kernel_matvec_f64", "repro_kernel_matvec_f32")),),
    # (q, k, v, o, b, hq, hkv, sq, sk, dh, scale, causal, stream)
    "flash_attention.cu": (
        ([_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32,
          ctypes.c_double, _I32, _PTR],
         ("repro_flash_attention_f32", "repro_flash_attention_bf16",
          "repro_flash_attention_f16")),),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels are built on the machine with the card")


def _stem(source: str) -> str:
    h = hashlib.sha256()
    h.update(source.encode())
    h.update((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return f"lib{Path(source).stem}_{h.hexdigest()[:16]}"


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile every source that has no library yet, all at once.

    Returns ``{source: {"path", "seconds", "log"}}``: the library, its
    build's wall time (0 when it was already built), and nvcc's
    ``-Xptxas -v`` report.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for source in SOURCES:
        stem = _stem(source)
        lib, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
        if lib.exists():
            out[source] = {"path": lib, "seconds": 0.0,
                           "log": log.read_text() if log.exists() else ""}
            continue
        # build under a unique name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, log, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for source, lib, log, tmp, cmd, proc, t0 in running:
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)
        out[source] = {"path": lib, "seconds": seconds, "log": text}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The built library of ``source``, with every entry point's signature
    set."""
    lib = ctypes.CDLL(str(build()[source]["path"]))
    for argtypes, names in ENTRY_POINTS[source]:
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
