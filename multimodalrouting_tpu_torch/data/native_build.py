"""Build the data layer's C++ libraries (``native/wordpiece.cpp``,
``native/binner.cpp``) with ``g++`` into ``build/native/`` beside the package.

The port never loads the JAX package's ``native/*.so``: each library is
compiled from its source at first use, never at import, and rebuilt when
the source is newer than the library. ``BUILD_DIR`` may be pointed elsewhere
(the tests build into a temporary directory).
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC_DIR = os.path.join(REPO_DIR, "native")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def source_path(name: str) -> str:
    return os.path.join(NATIVE_SRC_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_native(name: str) -> Optional[str]:
    """``BUILD_DIR/lib<name>.so``, compiled from ``native/<name>.cpp`` when it
    is missing or older than the source; None when no toolchain builds it."""
    src, so = source_path(name), library_path(name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # concurrent builders each rename a whole library
    try:
        subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):  # no g++, or it failed
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
