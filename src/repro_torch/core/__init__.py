"""Core paper contribution: NFFT fast summation + Krylov methods, in PyTorch."""

from repro_torch.core.kernels import (  # noqa: F401
    ALL_KERNELS, GAUSSIAN, INVERSE_MULTIQUADRIC, KERNEL_PARAM_NAME,
    LAPLACIAN_RBF, MULTIQUADRIC, Kernel, kernel_from_param, make_kernel,
)
from repro_torch.core.fastsum import (  # noqa: F401
    SETUP_1, SETUP_2, SETUP_3, FastsumOperator, FastsumOperatorBank,
    FastsumParams, NormalizedAdjacencyOperator, PredictionPlan,
    dense_normalized_adjacency, dense_weight_matrix, direct_matvec_tiled,
    fastsum_bank_from_arrays, fastsum_from_arrays, make_fastsum,
    make_fastsum_bank, make_normalized_adjacency,
    make_normalized_adjacency_mixture, make_prediction_plan,
    prediction_multiplier, scale_nodes,
)
from repro_torch.core.fastsum_exec import (  # noqa: F401
    fused_gather_columns, fused_matvec_tilde, fused_matvec_tilde_bank,
    fused_matvec_tilde_bank_columns, fused_pipeline, fused_pipeline_bank,
    fused_pipeline_bank_columns, fused_spectral_multiplier,
    fused_transform_columns, spectral_support, stack_multipliers,
)
from repro_torch.core.nfft import (  # noqa: F401
    NfftGeometry, NfftPlan, WindowGeometry, build_geometry,
    build_window_geometry, ndft_adjoint, ndft_forward, nfft_adjoint,
    nfft_forward,
)
from repro_torch.core.lanczos import (  # noqa: F401
    BlockLanczosResult, EigshResult, block_lanczos, eigsh,
    eigsh_smallest_laplacian, lanczos,
)
from repro_torch.core.solvers import (  # noqa: F401
    SolveHealth, SolveResult, cg, cg_bank, minres, minres_bank,
)
from repro_torch.core.nystrom import (  # noqa: F401
    NystromResult, nystrom_gaussian_nfft, nystrom_traditional,
)
from repro_torch.core.error import (  # noqa: F401
    aposteriori_report, lemma31_bound,
)
