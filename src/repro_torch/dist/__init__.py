"""Distributed execution layer of the port, on ``torch.distributed``.

Modules
-------
``fastsum_dist``
    Distributed NFFT fast summation (Algorithm 3.1 with the node dimension
    sharded over the ranks of a :class:`repro_torch.launch.mesh.Mesh`):
    the spectral sum is one all_reduce of the half-spectrum's support
    block per matvec (``spectral_mode="psum"``) or a reduce-scattered
    pencil-decomposed FFT (``"pencil"``) whose per-rank spectrum memory,
    FFT work and collective payload scale ~1/P.
``pencil_fft``
    The distributed ``rfftn``/``irfftn`` pair behind the pencil mode: grid
    axes 0 (and 1, d >= 3) sharded over row x col mesh-axis groups, local
    trailing-axis FFTs and one ``all_to_all`` transpose per sharded axis.
``compression``
    Block-wise int8 quantization with error feedback for the gradient mean
    over replicas (``compress_psum``) and per-step compression in the train
    loop (``apply_error_feedback``).

The JAX package's ``compat`` (a ``shard_map`` version shim) needs no twin;
its ``sharding`` rules come with the port's sharded train step, the next
slice after this one (ROADMAP queue 1 item 12, LM half).
"""

from repro_torch.dist.compression import (  # noqa: F401
    BLOCK, CompressionState, apply_error_feedback, compress_decompress,
    compress_psum, init_compression_state,
)
from repro_torch.dist.fastsum_dist import (  # noqa: F401
    SPECTRAL_MODES, distributed_matvec_bank_fn, distributed_matvec_fn,
    make_sharded_matvec, make_sharded_matvec_bank, resolve_pencil_spec,
)
from repro_torch.dist.pencil_fft import (  # noqa: F401
    PencilSpec, make_pencil_spec, pencil_irfftn, pencil_rfftn,
)
