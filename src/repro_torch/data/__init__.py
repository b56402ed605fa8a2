"""Synthetic point sets and the LM training data pipeline (numpy only)."""

from repro_torch.data.synthetic import (  # noqa: F401
    crescent_fullmoon, gaussian_blobs, spiral, synthetic_image,
)
