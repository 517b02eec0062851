"""Shared helpers of the PyTorch port's parity tests: the same numpy inputs
and weights go through a JAX module and its port."""
from __future__ import annotations

import jax
import numpy as np
import torch

from multimodalrouting_tpu_torch.data.batches import Batch as TorchBatch
from multimodalrouting_tpu_torch.data.batches import batch_to

RTOL, ATOL = 2e-4, 2e-5  # fp32 parity, as tests/test_pallas.py holds the kernels


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, dtype=np.asarray(x).dtype), tree)


def jitter(variables, seed: int = 0, scale: float = 0.1):
    """Numpy copy of flax variables with every parameter perturbed and
    BatchNorm statistics made nonzero, so zero-initialised leaves (capsule
    head embedding, biases) carry signal through the comparison."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in to_numpy(dict(variables)).items():
        if col == "batch_stats":
            def stat(path, x):
                name = str(getattr(path[-1], "key", path[-1]))
                if name == "var":
                    return (0.5 + rng.random(x.shape)).astype(x.dtype)
                return (0.1 * rng.normal(size=x.shape)).astype(x.dtype)

            out[col] = jax.tree_util.tree_map_with_path(stat, tree)
        else:
            out[col] = jax.tree_util.tree_map(
                lambda x: (x + scale * rng.normal(size=x.shape)).astype(x.dtype), tree
            )
    return out


def torch_batch(batch) -> TorchBatch:
    """A JAX-package Batch of numpy arrays as the port's Batch of CPU tensors."""
    return batch_to(TorchBatch(*batch), "cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def assert_close(got, ref, rtol: float = RTOL, atol: float = ATOL, err_msg: str = ""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, dtype=np.float32), rtol=rtol, atol=atol, err_msg=err_msg)
