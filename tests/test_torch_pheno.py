"""The port's 25-phenotype train step against the JAX package's
``make_train_step`` on the CPU: configs/pheno_25.yaml (task pheno, 25 label
capsules, the pos-weighted multi-label loss with ``pos_weight_clip`` from the
YAML) on the tiny widths of tests/torch_parity.py, frozen notes, fp32,
dropouts at 0.

The port's config is the one a checkpoint holds (``ckpt.load_config``), so
the step runs through the fix of fault F1 (ROADMAP.md): the clip comes back
as the tuple (0.1, 5.0). The JAX package keeps F1, so its config gets the
tuple by ``dataclasses.replace``. The same jittered weights go in through
``bridge.train_state_from_jax``; one step later the losses agree within
rtol 5e-4 and every parameter, EMA and BatchNorm statistic within 5e-4 in
relative norm per leaf (tests/test_torch_train.py says why per leaf).
"""
import dataclasses
import os

import numpy as np

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.ckpt import load_config, save_checkpoint
from tests.torch_parity import RTOL_STEPS, TRAIN_SMALL, assert_same_weights, jax_trajectory, port_trajectory

PHENO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pheno_25.yaml")


def test_pheno_train_step_matches_jax(tmp_path):
    save_checkpoint(str(tmp_path), {}, tc.load_cfg(PHENO, overrides=TRAIN_SMALL, environ={}))
    tcfg = load_config(str(tmp_path))
    assert tcfg.model.task == "pheno" and tcfg.model.num_classes == 25
    assert tcfg.train.pos_weight_clip == (0.1, 5.0)
    jcfg = jc.load_cfg(PHENO, overrides=TRAIN_SMALL, environ={})
    assert jcfg.train.pos_weight_clip == "[0.1, 5.0]"  # F1, kept by the reference
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, pos_weight_clip=(0.1, 5.0)))
    batches = [make_synthetic_cohort(4, t=16, f=16, s=5, l=256, image_size=32, vocab_size=2048, seed=20, task="pheno")]
    assert batches[0].y.shape == (4, 25) and 0 < batches[0].y.mean() < 1
    init, jlosses, jstate = jax_trajectory(jcfg, batches)
    model, state, tlosses = port_trajectory(tcfg, init, batches)
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL_STEPS)
    assert state.step == int(jstate.step) == 1
    assert_same_weights(model, state, jstate)
