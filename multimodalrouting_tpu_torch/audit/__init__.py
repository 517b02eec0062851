"""The port's copies of the JAX package's numpy audit exports: the
missing-modality drop table and the route heatmap tables and reliability
diagram (the occlusion attribution, sweeps and probes are ROADMAP.md §1
item 9)."""
from multimodalrouting_tpu_torch.audit.droptable import drop_table_eval, format_drop_table  # noqa: F401
from multimodalrouting_tpu_torch.audit.exports import (  # noqa: F401
    routing_heatmap_tables,
    save_array_with_versions,
    save_reliability_diagram,
)
