from multimodalrouting_tpu_torch.utils.debug import checked_finite, debug_checks_enabled  # noqa: F401
from multimodalrouting_tpu_torch.utils.profiling import StepTimer, annotate, trace_context  # noqa: F401
