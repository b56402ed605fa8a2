"""Distributed execution layer of the port.  So far its single-device part:
block-wise int8 gradient compression with error feedback
(``compression``), which the train loop applies per step.  The sharded
matvec, the pencil FFT and the sharding rules wait for ROADMAP queue 1
item 12."""

from repro_torch.dist.compression import (  # noqa: F401
    BLOCK, CompressionState, apply_error_feedback, compress_decompress,
    compress_psum, init_compression_state,
)
