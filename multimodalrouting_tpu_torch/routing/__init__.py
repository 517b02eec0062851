"""Routing heads of the PyTorch port."""
from multimodalrouting_tpu_torch.routing.capsule_head import (  # noqa: F401
    CapsuleHead,
    RouteDimAdapter,
    RoutePrimaryProjector,
    compose_priors,
)
