"""Core paper contribution: NFFT fast summation + Krylov methods, in PyTorch."""

from repro_torch.core.kernels import (  # noqa: F401
    ALL_KERNELS, Kernel, make_kernel,
)
from repro_torch.core.fastsum import (  # noqa: F401
    SETUP_1, SETUP_2, SETUP_3, FastsumOperator, FastsumParams,
    NormalizedAdjacencyOperator, dense_normalized_adjacency,
    dense_weight_matrix, direct_matvec_tiled, fastsum_from_arrays,
    make_fastsum, make_normalized_adjacency,
)
from repro_torch.core.nfft import (  # noqa: F401
    NfftGeometry, NfftPlan, WindowGeometry, build_geometry,
    build_window_geometry, ndft_adjoint, ndft_forward, nfft_adjoint,
    nfft_forward,
)
from repro_torch.core.lanczos import (  # noqa: F401
    EigshResult, eigsh, eigsh_smallest_laplacian,
)
from repro_torch.core.solvers import SolveResult, cg, minres  # noqa: F401
from repro_torch.core.nystrom import (  # noqa: F401
    NystromResult, nystrom_gaussian_nfft, nystrom_traditional,
)
from repro_torch.core.error import (  # noqa: F401
    aposteriori_report, lemma31_bound,
)
