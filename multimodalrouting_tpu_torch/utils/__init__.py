from multimodalrouting_tpu_torch.utils.profiling import annotate, trace_context  # noqa: F401
