"""The port's copies of the JAX package's numpy metrics (classification,
calibration and fairness): the port imports nothing of the JAX package."""
from multimodalrouting_tpu_torch.metrics.classification import (  # noqa: F401
    auprc,
    auroc,
    binary_metrics,
    confusion,
    epoch_metrics,
    f1_score,
    mcc,
    multilabel_metrics,
)
from multimodalrouting_tpu_torch.metrics.calibration import (  # noqa: F401
    expected_calibration_error,
    find_best_thresholds,
    fit_temperature,
    reliability_table,
)
from multimodalrouting_tpu_torch.metrics.fairness import (  # noqa: F401
    eddi,
    equalized_odds_gap,
    predictive_parity_gap,
)
