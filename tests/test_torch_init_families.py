"""The fresh weights of every family that tests/test_torch_families.py
builds against flax's own init on the CPU, at its tiny widths: the
gated-concat model (learned and loss-based gates), FAME++ (learned, and
loss-based multitask), the 7-route capsule model at M = 2 and M = 25,
LateFusion and TriMF, and the unimodal models (``WideBEHRTClassifier``,
``NoteEmbeddingClassifier``, ``OMOPConceptModel``). A real flax
``model.init(PRNGKey(0), ...)`` is mapped by ``bridge.state_dict_from_jax``
onto a fresh port model's keys and held by
``torch_parity.assert_fresh_like_jax`` (both key sets equal, constants bit
for bit, every random leaf in distribution). tests/test_torch_init.py holds
the initializers themselves and the other models.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models import inspect as jinspect
from multimodalrouting_tpu.models import unimodal as junimodal
from multimodalrouting_tpu.models.baselines import build_baseline as jbuild_baseline
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.models import inspect as tinspect
from multimodalrouting_tpu_torch.models import unimodal as tunimodal
from multimodalrouting_tpu_torch.models.full import build_model
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import INIT_WIDTHS, assert_fresh_like_jax, jax_init, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILY = {**TINY, **INIT_WIDTHS, "model.fusion_dropout": 0.0, "model.smro_dropout": 0.0, "encoder.text_max_len": 16,
          "encoder.image_size": 32}

CASES = {
    "gated_concat-learned": ("gated_concat", {}),
    "gated_concat-loss_based": ("gated_concat", {"model.gate_mode": "loss_based"}),
    "fame-learned": ("fame", {}),
    "fame-loss_based-multitask": ("fame", {"model.smro_gate_mode": "loss_based", "model.task": "multitask",
                                           "model.num_classes": 3}),
    "capsule-7-mortality": ("capsule", {"model.routes": "7"}),
    "capsule-7-phenotype": ("capsule", {"model.routes": "7", "model.task": "pheno", "model.num_classes": 25,
                                        "model.bi_fusion_mode": "linear"}),
    "late_fusion": ("late_fusion", {}),
    "trimf": ("trimf", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fresh_family_draws_as_flax(case):
    family, extra = CASES[case]
    over = {**FAMILY, **extra}
    jcfg, tcfg = jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)
    jmodel = jbuild_baseline(jcfg, family) if family in ("late_fusion", "trimf") else jbuild_model(jcfg, family)
    batch = jax.tree_util.tree_map(jnp.asarray, tiny_batch(n=2, seed=1, task=jcfg.model.task))
    variables = jax_init(jmodel, batch, train=False)
    torch.manual_seed(0)
    ratios = assert_fresh_like_jax(variables, build_model(tcfg, family, device="cpu"))
    if family == "fame":  # the stacked route heads, fan_in = R * d and R * 2d
        assert {"route_heads.w1", "route_heads.w2"} <= set(ratios)


def test_unimodal_models_draw_as_flax():
    torch.manual_seed(0)
    x = jnp.zeros((2, 6 * 5))
    assert_fresh_like_jax(jax_init(junimodal.WideBEHRTClassifier(n_bins=6, n_labs=5, d=16, n_layers=1, n_heads=2), x),
                          tunimodal.WideBEHRTClassifier(6, 5, d=16, n_layers=1, n_heads=2))
    x = jnp.zeros((2, 24))
    assert_fresh_like_jax(jax_init(junimodal.NoteEmbeddingClassifier(hidden=64, num_classes=4), x),
                          tunimodal.NoteEmbeddingClassifier(24, hidden=64, num_classes=4))
    ids = jnp.zeros((2,), jnp.int32)
    assert_fresh_like_jax(jax_init(jinspect.OMOPConceptModel(110, 70, 90, hidden=32), ids, ids, ids),
                          tinspect.OMOPConceptModel(110, 70, 90, hidden=32))
