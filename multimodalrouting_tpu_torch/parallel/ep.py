"""Route-level expert parallelism over the 'model' axis of the process mesh
(counterpart of multimodalrouting_tpu/parallel/ep.py).

The flagship's MulT router runs its six directional cross-attention
streams (L<-N, L<-I, N<-L, N<-I, I<-L, I<-N) as one stacked module with a
leading stream axis (``models/mult.py``, ``cross_streams``), and so does the
per-route MulT family (``models/route_mult.py``, ``route_mult.directional``).
Under ``train.route_parallel=true`` (the mesh's ``route`` role,
``parallel/mesh.py``) rank j of a model group holds and runs streams
[j·6/M, (j+1)·6/M) of each: the replicated inputs enter through
``copy_to_model_group`` (Megatron's *f*, whose backward sums the streams'
input gradients over the group), no collective runs inside the stacks, and
``gather_streams`` assembles the [6, B, T, d] outputs before the pooling and
the replicated pair projections. Stream-local dropout draws from the rank's
``slice_generator``. The self streams and the per-route family's tri program
(3 streams) stay replicated, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from multimodalrouting_tpu_torch.models.mult import CROSS_STREAMS

#: the module scopes of the stacked 6-stream programs: ``cross_streams`` in
#: ``models/mult.py:MULTRouter`` and ``route_mult.directional`` in
#: ``models/route_mult.py:PerRouteMulTFusion`` (``route_mult`` in
#: ``models/full.py``); the tri program (``route_mult.LNI.streams``) stays
#: replicated
_CROSS_SCOPE = "cross_streams"
_ROUTE_MULT_SCOPE = ("route_mult", "directional")

#: number of directional cross streams, from the taxonomy itself
N_CROSS_STREAMS = len(CROSS_STREAMS)


def ep_spec_for_name(name: str) -> Optional[int]:
    """The dimension of parameter `name` split over the model group: the
    leading (stream) axis of every leaf of a stacked 6-stream program, None
    elsewhere."""
    names = name.split(".")
    if _CROSS_SCOPE in names or all(s in names for s in _ROUTE_MULT_SCOPE):
        return 0
    return None


def validate_ep(cfg, n_model: int) -> None:
    """Reject configs where route parallelism cannot apply or divide (the JAX
    package's checks and messages)."""
    t, m = cfg.train, cfg.model
    if t.tensor_parallel or t.pipeline_parallel:
        raise ValueError(
            "train.route_parallel is mutually exclusive with "
            "train.tensor_parallel / train.pipeline_parallel — all three are "
            "roles of the 'model' mesh axis"
        )
    if m.routes != "10":
        raise ValueError(
            "train.route_parallel shards the stacked 6-stream cross program "
            "(MULTRouter or the per-route MulT family); it needs "
            "model.routes=10"
        )
    if n_model < 2 or N_CROSS_STREAMS % n_model:
        raise ValueError(
            f"train.route_parallel needs the {N_CROSS_STREAMS} cross streams "
            f"divisible by the model shards ({n_model}); use 2, 3 or 6"
        )
