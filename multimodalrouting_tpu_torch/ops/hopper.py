"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh``) exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Libraries land in ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of their source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: ``library(name)`` builds on first use, and
``build()`` compiles every source at once (one ``nvcc`` process per source,
all started together) for callers that want the build up front.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SOURCES = ("packed_attention", "packed_attention_bwd", "flash_attention", "flash_attention_bwd", "capsule_routing")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

_PTR = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "packed_attention": {
        name: (_I, [_PTR] * 6 + [_I] * 4 + [_LL] * 8 + [_PTR])
        for name in ("packed_attention_bf16", "packed_attention_f32")
    },
    "packed_attention_bwd": {
        **{name: (_I, [_PTR] * 11 + [_I] * 4 + [_LL] * 12 + [_PTR])
           for name in ("packed_attention_bwd_bf16", "packed_attention_bwd_f32")},
        **{name: (_I, [_PTR] * 3 + [_I] * 4 + [_LL] * 4 + [_PTR])
           for name in ("attention_bwd_di_bf16", "attention_bwd_di_f32")},
    },
    "flash_attention": {
        name: (_I, [_PTR] * 6 + [_I] * 4 + [_LL] * 8 + [_PTR])
        for name in ("flash_attention_bf16", "flash_attention_f32")
    },
    "flash_attention_bwd": {
        name: (_I, [_PTR] * 11 + [_I] * 4 + [_LL] * 12 + [_PTR])
        for name in ("flash_attention_bwd_bf16", "flash_attention_bwd_f32")
    },
    "capsule_routing": {
        **{name: (_I, [_PTR] * 6 + [_I] * 6 + [_PTR]) for name in ("capsule_routing_f32", "capsule_routing_bf16")},
        "capsule_routing_empty": (_I, [_PTR]),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built on a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every library of `names` that is not built yet, all in
    parallel. Returns the wall seconds; raises with nvcc's log on failure.
    The ptxas report (registers, shared memory, spills) stays beside each
    library as ``<lib>.log``."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log_path = out[:-3] + ".log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
        jobs.append((name, proc, tmp, out, log_path))
    failed = []
    for name, proc, tmp, out, log_path in jobs:
        if proc.wait() == 0:
            os.replace(tmp, out)
        else:
            with open(log_path) as f:
                failed.append(f"{name}:\n{f.read()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc/ptxas output of the library's last build ('' if none)."""
    path = lib_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with every exported
    function's argtypes/restype declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build((name,))
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
