"""Graph applications of the fast matvec."""

from repro_torch.graph.spectral import (  # noqa: F401
    SpectralResult, clustering_agreement, kmeans, spectral_clustering,
)
from repro_torch.graph.ssl import (  # noqa: F401
    allen_cahn_multiclass, allen_cahn_ssl, kernel_ssl_cg,
    kernel_ssl_cg_multilayer, kernel_ssl_eig, make_training_vector,
)
from repro_torch.graph.krr import (  # noqa: F401
    KRRGradResult, KRRModel, KRRSweepResult, krr_fit, krr_fit_grad,
    krr_fit_sweep, krr_pred_cache_stats, krr_predict, krr_predict_direct,
    krr_predict_many, krr_prediction_operator, krr_sweep_model,
    krr_validation_loss, points_fingerprint,
)
