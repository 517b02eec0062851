"""The port's audit: copies of the JAX package's numpy audit modules (the
missing-modality drop table, the route heatmap tables and reliability
diagram, the diagnostic probes) and the gated family's interpretability
sweep (occlusion route contributions, UC/BI/TI, the inference demo)."""
from multimodalrouting_tpu_torch.audit.droptable import drop_table_eval, format_drop_table  # noqa: F401
from multimodalrouting_tpu_torch.audit.exports import (  # noqa: F401
    routing_heatmap_tables,
    save_array_with_versions,
    save_reliability_diagram,
)
