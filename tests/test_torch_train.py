"""The port's flagship train step against the JAX package's
``make_train_step`` on the CPU: a tiny flagship (the ``--small`` widths of
scripts/demo_synthetic.py, BERT at 256 tokens x 128 hidden with 2 heads so
the packed attention's gate holds, BatchNorm), fp32, dropouts and route
dropout at 0, fine-tuned notes, chunk packing as the loop computes it.

The same jittered weights go in through ``bridge.train_state_from_jax``;
K = 3 steps later the per-step losses agree within rtol 5e-4, and every
parameter, EMA and BatchNorm statistic within 5e-4 in relative norm per
leaf. Per leaf and not per element: Adam's first steps move each weight by
about lr * sign(g), so an element whose gradient is below fp32 summation
noise (convolutions summed in another order) takes a step of either sign in
the two frameworks; that moves a leaf's norm by far less than 5e-4 at these
weights, and a wrong learning rate, clip, decay or moment moves it by far
more. Head and encoder learning rates differ, so the grouping is checked.
K stays at 3: the layer4 BatchNorm of a 32^2 image sees 1 x 1 maps of 4
stays, and its batch variance over 4 values amplifies those sign-noise
differences step by step (measured 1.6e-5 after 1 step, 7.5e-5 after 3,
1.8e-3 after 5).
"""
import numpy as np

from multimodalrouting_tpu.train.loop import note_pack_bucket as jnote_pack_bucket
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket
from tests.torch_parity import (
    RTOL_STEPS,
    assert_same_weights,
    jax_trajectory,
    port_trajectory,
    train_cfgs,
    train_cohorts,
)


def test_finetuned_train_step_matches_jax():
    jcfg, tcfg = train_cfgs(**{"encoder.finetune_text": True})
    batches = train_cohorts(3)
    caps = [note_pack_bucket(tcfg, Batch(*b)) for b in batches]
    assert any(caps) and caps == [jnote_pack_bucket(jcfg, b) for b in batches]  # packing runs in both
    init, jlosses, jstate = jax_trajectory(jcfg, batches)
    model, state, tlosses = port_trajectory(tcfg, init, batches)
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL_STEPS)
    assert state.step == state.count == int(jstate.step) == 3
    assert_same_weights(model, state, jstate)
