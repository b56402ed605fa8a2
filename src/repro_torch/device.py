"""The port's default-device rule.

Entry points run on the CUDA card unless the caller names another device.
There is no silent CPU continuation: asking for ``cuda`` on a machine
without a card raises, and the message says how to ask for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises.  A CUDA
    device without an index gets the current card's, so that it compares
    equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_cpu_math() -> None:
    """Initialize the CPU vector-math library once, on one thread.

    PyTorch's CPU ``exp``, ``log``, ``sqrt``, ``sin``... call MKL's vector
    math, which sets itself up on its first call.  When that first call
    comes from several threads of a parallel loop at once, some of them can
    compute with a setup that is not finished: in some processes (MKL
    2024.2, eight threads on an AVX-512 CPU) the first parallel ``sqrt``
    returned wrong low-order bits, enough to leave the figure 3 script's
    200-point dense adjacency visibly unsymmetric and its eigenvalues off
    by a few 1e-13, while every later call was right.  One call
    on a single element, below the size that runs in parallel, finishes
    the setup before any parallel loop; :mod:`repro_torch` makes it at
    import.
    """
    torch.exp(torch.zeros(1, dtype=torch.float64))
