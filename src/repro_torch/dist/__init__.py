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

``sharding``
    The FSDP/TP placement rules (``param_specs``, ``batch_specs``,
    ``cache_specs``, ``named``) over a :class:`repro_torch.launch.mesh.
    Mesh`, each rank's block of a leaf and the differentiable gather of
    the sharded train step (``gather_on_use``).

The JAX package's ``compat`` (a ``shard_map`` version shim) needs no twin.
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
from repro_torch.dist.sharding import (  # noqa: F401
    FSDP_AXES, MODEL_AXIS, NamedSharding, P, batch_specs, cache_specs,
    gather_on_use, named, param_specs,
)
