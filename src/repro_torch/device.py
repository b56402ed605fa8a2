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
