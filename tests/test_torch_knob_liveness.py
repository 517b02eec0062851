"""Every knob the JAX package reads is read by the port (the port's copy of
tests/test_knob_liveness.py, which found knobs accepted and silently
ignored):

- every field of the port's config tree is read as an attribute
  (``.{name}``) by some source file of ``multimodalrouting_tpu_torch/``
  other than ``configs.py``;
- every ``MMR_*`` environment variable the JAX package reads (a quoted
  name in its source) is read by the port, less the TPU tiling and
  interpret variables, which change no result (ROADMAP.md's conventions),
  and ``MMR_JAX_CACHE_DIR``, the directory of JAX's compilation cache,
  which a package without JAX has no use for. The switches
  ``MMR_PACKED_BWD`` and ``MMR_FUSED_QKV`` went unread until they were
  ported; this test fails on such a switch.
"""
from __future__ import annotations

import re
from dataclasses import fields
from pathlib import Path

import pytest

from multimodalrouting_tpu_torch import configs

PORT = Path(configs.__file__).resolve().parent
JAX_PKG = PORT.parent / "multimodalrouting_tpu"
ENV_NAME = re.compile(r"[\"'](MMR_[A-Z0-9_]+)[\"']")
NOT_PORTED = re.compile(r"_BLOCK_|_INTERPRET$|^MMR_JAX_CACHE_DIR$")


def _source(pkg: Path, skip=("configs.py",)) -> str:
    return "\n".join(p.read_text() for p in sorted(pkg.rglob("*.py")) if p.name not in skip)


SOURCE = _source(PORT)
SECTIONS = {"encoder": configs.EncoderConfig, "model": configs.ModelConfig, "train": configs.TrainConfig,
            "data": configs.DataConfig}


def _all_knobs():
    for sec, dc in SECTIONS.items():
        for f in fields(dc):
            yield f"{sec}.{f.name}", f.name
    for f in fields(configs.Config):
        if f.name not in SECTIONS:
            yield f.name, f.name


def _jax_env_names():
    return sorted({m for m in ENV_NAME.findall(_source(JAX_PKG, skip=())) if not NOT_PORTED.search(m)})


@pytest.mark.parametrize("dotted,name", sorted(set(_all_knobs())))
def test_knob_is_read_somewhere_in_the_port(dotted, name):
    assert re.search(rf"\.{re.escape(name)}\b", SOURCE), (
        f"config knob {dotted!r} is never read in multimodalrouting_tpu_torch/: wire it up"
    )


@pytest.mark.parametrize("name", _jax_env_names())
def test_the_jax_package_s_environment_variable_is_read_by_the_port(name):
    assert name in ENV_NAME.findall(SOURCE), f"{name} is read by the JAX package and not by the port"


def test_the_environment_variables_cover_the_switches():
    assert {"MMR_ATTN", "MMR_FLASH", "MMR_DEBUG_CHECKS", "MMR_PACKED_BWD", "MMR_FUSED_QKV"} <= set(_jax_env_names())
