"""Variants of the port's train step on the CPU, at the tiny flagship of
tests/test_torch_train.py: one step under the frozen-text default against
the JAX package's ``make_train_step``; microbatch = 2 against the full
batch; chunk packing on against packing off."""
import numpy as np
import torch

from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket
from multimodalrouting_tpu_torch.train.state import create_train_state
from multimodalrouting_tpu_torch.train.steps import make_train_step
from tests.torch_parity import (
    RTOL_STEPS,
    assert_same_weights,
    jax_trajectory,
    port_trajectory,
    torch_batch,
    train_cfgs,
    train_cohorts,
)


def test_frozen_default_step_matches_jax():
    """finetune_text=false: the BERT body takes no gradient and no moments
    and stays where it was; everything else moves as in JAX."""
    jcfg, tcfg = train_cfgs()
    batches = train_cohorts(1, seed=20)
    init, jlosses, jstate = jax_trajectory(jcfg, batches)
    model, state, tlosses = port_trajectory(tcfg, init, batches)
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL_STEPS)
    assert not any(n.startswith("encoders.bbert.bert.") for n in state.names)
    assert all(not p.requires_grad for p in model.encoders.bbert.bert.parameters())
    assert_same_weights(model, state, jstate)


def _one_step(tcfg, cohort, note_pack: int, **extra):
    """A fresh model from one seed, one step -> (loss, Adam first moments)."""
    torch.manual_seed(0)
    model = build_model(tcfg, device="cpu", train=True)
    state = create_train_state(tcfg, model)
    metrics = make_train_step(tcfg, model)(state, torch_batch(cohort), None, 2e-4, 2e-4, note_pack=note_pack)
    return float(metrics.loss), state.mu, model


def _assert_same_moments(got, ref):
    """mu = (1 - b1) * clipped gradient after one step. 1e-5 relative to the
    leaf's largest moment: the same gradient summed in another grouping."""
    for name, r in ref.items():
        torch.testing.assert_close(got[name], r, rtol=0, atol=1e-5 * r.abs().max().item() + 1e-12, msg=name)


def test_microbatch_two_equals_the_full_batch():
    """Gradient accumulation over two halves == the full batch (GroupNorm:
    BatchNorm's batch statistics differ between halves by design)."""
    _, tcfg = train_cfgs(**{"encoder.vision_norm": "group", "encoder.finetune_text": True})
    _, tcfg2 = train_cfgs(**{"encoder.vision_norm": "group", "encoder.finetune_text": True, "train.microbatch": 2})
    cohort = train_cohorts(1, seed=30)[0]
    loss, mu, _ = _one_step(tcfg, cohort, 0)
    loss2, mu2, _ = _one_step(tcfg2, cohort, 0)
    np.testing.assert_allclose(loss2, loss, rtol=1e-6)
    _assert_same_moments(mu2, mu)


def test_note_packing_equals_packing_off():
    """BERT over the valid chunks only, scattered back: the same outputs and
    the same step as BERT over every chunk."""
    _, tcfg = train_cfgs(**{"encoder.finetune_text": True})
    cohort = train_cohorts(1, seed=40)[0]
    cap = note_pack_bucket(tcfg, Batch(*cohort))
    assert 0 < cap < cohort.chunk_mask.size
    loss, mu, model = _one_step(tcfg, cohort, cap)
    loss0, mu0, _ = _one_step(tcfg, cohort, 0)
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    _assert_same_moments(mu, mu0)
    with torch.no_grad():
        packed = model(torch_batch(cohort), train=False, note_pack=cap)
        full = model(torch_batch(cohort), train=False)
    for name in ("logits", "alpha", "r_matrix"):
        torch.testing.assert_close(getattr(packed, name), getattr(full, name), rtol=1e-5, atol=1e-6, msg=name)
