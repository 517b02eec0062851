"""multimodalrouting_tpu_torch — the PyTorch/CUDA port of multimodalrouting_tpu.

The same system (ICU outcome prediction from labs, notes and chest X-rays,
decomposed into unimodal, directional bimodal and trimodal routes and routed
by capsule routing-by-agreement) for an NVIDIA H100: plain tensor code in
PyTorch, and every Pallas kernel of the JAX package on the ported path as a
hand-written Hopper kernel under ``csrc/``. This package imports neither JAX
nor the JAX package; its tests hold it against that package on the CPU.

Ported so far: the capsule family's serving path (``serve.py``), training
(``train/``) and command line (``cli.py``: train, eval, predict).
"""

__version__ = "0.1.0"
