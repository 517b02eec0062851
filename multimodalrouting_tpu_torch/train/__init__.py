"""Training of the flagship capsule model (counterpart of multimodalrouting_tpu/train)."""
