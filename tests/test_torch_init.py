"""The port's fresh weights against flax's own init on the CPU
(``multimodalrouting_tpu_torch/models/init.py``):

- each initializer of ``models/init.py`` against the flax initializer of
  the same name at >= 2^16 values: a 2-D kernel, the 10-route projector's
  stacked [10, 256, 33] (the route axis counted into the fans) and a 7 x 7
  conv [7, 7, 3, 64] (drawn 8 times), by a two-sample KS test at p >= 1e-4,
  the std ratio within 2%, the rule's std (``std``, what ``chip_smoke.py``
  holds the card's leaves to) within 2% of flax's draw, and a truncated
  draw cut at 2 sigma (sigma its untruncated std) in both packages;
- whole models at tiny widths: a real flax ``model.init(PRNGKey(0), ...)``,
  mapped by ``bridge.state_dict_from_jax`` onto a fresh port model's keys
  (``torch_parity.assert_fresh_like_jax``: both key sets equal, constants
  bit for bit, every random leaf in distribution): the flagship with
  BatchNorm, the 25-phenotype model, the per-route MulT branch, the
  pipeline layout, the int8 body, DenseNet-121 and ``RouteDimAdapter``;
  ``RouteDimAdapter``'s forward against JAX's.

The families of tests/test_torch_families.py and the unimodal models are in
tests/test_torch_init_families.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import initializers as fi
from flax.linen.linear import default_embed_init
from scipy.stats import ks_2samp

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models import cxr as jcxr
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.routing import RouteDimAdapter as JRouteDimAdapter
from multimodalrouting_tpu.routing import RoutePrimaryProjector as JRoutePrimaryProjector
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.models import cxr as tcxr
from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.routing import RouteDimAdapter, RoutePrimaryProjector
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    INIT_WIDTHS,
    assert_close,
    assert_fresh_like_jax,
    jax_init,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- the initializers ----------------------------------------------------------------

INITIALIZERS = {  # port, flax
    "lecun_normal": (init.lecun_normal, fi.lecun_normal()),
    "xavier_uniform": (init.xavier_uniform, fi.xavier_uniform()),
    "embed_normal": (init.embed_normal, default_embed_init),
    "normal": (init.normal(0.02), fi.normal(0.02)),
}
SHAPES = {"2d": (256, 512), "stacked": (10, 256, 33), "conv": (7, 7, 3, 64)}
MIN_VALUES = 2**16


def _draws(shape):
    """Draws of `shape` that hold at least 2^16 values together."""
    return -(-MIN_VALUES // int(np.prod(shape)))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("name", list(INITIALIZERS))
def test_initializer_draws_as_flax(name, shape):
    port, flax_init = INITIALIZERS[name]
    k = _draws(shape)
    g = torch.Generator().manual_seed(0)
    got = torch.cat([port(shape, generator=g).flatten() for _ in range(k)]).double().numpy()
    ref = np.concatenate([np.asarray(flax_init(key, shape, jnp.float32)).ravel()
                          for key in jax.random.split(jax.random.PRNGKey(0), k)]).astype(np.float64)
    assert got.size == ref.size >= MIN_VALUES
    assert port(shape).shape == shape  # the JAX layout
    p = ks_2samp(got, ref).pvalue
    assert p >= 1e-4, f"KS p={p:.2e}"
    assert abs(got.std() / ref.std() - 1.0) <= 0.02, got.std() / ref.std()
    assert abs(port.std(shape) / ref.std() - 1.0) <= 0.02, (port.std(shape), ref.std())
    if name == "lecun_normal":  # truncated at 2 sigma, sigma the untruncated std
        cut = 2.0 * port.std(shape) / init.TRUNCATED_STD
        for w in (got, ref):
            assert cut * 0.99 <= np.abs(w).max() <= cut * (1 + 1e-6)


def test_route_axis_counts_into_the_fan():
    """flax's lecun_normal on the whole [R, d_in, pc + 1]: fan_in = R * d_in,
    not d_in (std 1/sqrt(2560) at the 10-route flagship's shape)."""
    shape = SHAPES["stacked"]
    assert init.compute_fans(shape) == (10 * 256, 10 * 33)
    assert init.lecun_normal.std(shape) == pytest.approx(2560**-0.5)
    ref = np.asarray(fi.lecun_normal()(jax.random.PRNGKey(0), shape, jnp.float32))
    assert ref.std() == pytest.approx(2560**-0.5, rel=0.02)


def test_stacked_draws_each_slice_on_its_own_shape():
    """``init.stacked``: the pipeline layout's and nn.vmap's per-slice init,
    the fans those of one [in, out] slice."""
    shape = (8, 96, 128)
    g = torch.Generator().manual_seed(1)
    got = init.stacked(init.lecun_normal)(shape, generator=g).double().numpy()
    keys = jax.random.split(jax.random.PRNGKey(1), shape[0])
    ref = np.stack([np.asarray(fi.lecun_normal()(k, shape[1:], jnp.float32)) for k in keys]).astype(np.float64)
    assert got.shape == ref.shape == shape
    assert ks_2samp(got.ravel(), ref.ravel()).pvalue >= 1e-4
    assert abs(got.std() / ref.std() - 1.0) <= 0.02
    assert init.stacked(init.lecun_normal).std(shape) == init.lecun_normal.std(shape[1:]) == 96**-0.5


def test_port_shapes_and_constants():
    """A parameter laid out otherwise in the port is filled in its own shape
    at the fans of its JAX shape; constants are their values."""
    m = torch.nn.Module()
    init.param(m, "w", init.lecun_normal, (7, 7, 3, 64), (64, 3, 7, 7))
    assert m.w.shape == (64, 3, 7, 7) and m.w.is_contiguous()
    assert init.rules(m) == {"w": (init.lecun_normal, (7, 7, 3, 64))}
    assert m.w.abs().max().item() <= 2.0 * init.lecun_normal.std((7, 7, 3, 64)) / init.TRUNCATED_STD
    assert torch.equal(init.zeros((2, 3)), torch.zeros(2, 3)) and torch.equal(init.ones((4,)), torch.ones(4))
    assert init.constant(0.5)(()).item() == 0.5 and init.constant(((1.0,), (-2.0,)))((2, 1)).flatten().tolist() == [1, -2]
    assert init.zeros.std((2, 3)) == 0.0


# --- whole models -------------------------------------------------------------------

SLICE = {**TINY, **INIT_WIDTHS, "encoder.vision_norm": "batch", "encoder.text_max_len": 16, "encoder.image_size": 32}


def _model_case(over=None, yaml=None):
    over = {**SLICE, **(over or {})}
    if yaml:
        path = os.path.join(ROOT, "configs", yaml)
        jcfg = jc.load_cfg(path, overrides=over, environ={})
        tcfg = tc.load_cfg(path, overrides=over, environ={})
    else:
        jcfg, tcfg = jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)
    batch = jax.tree_util.tree_map(jnp.asarray, tiny_batch(n=2, seed=1, task=jcfg.model.task))
    variables = jax_init(jbuild_model(jcfg, "capsule"), batch, train=False)
    torch.manual_seed(0)
    return variables, build_model(tcfg, device="cpu")


MODELS = {
    "flagship": {},
    "phenotype": {"yaml": "pheno_25.yaml"},
    "per_route_mult": {"over": {"model.bi_fusion_mode": "mult"}},
    "pipeline_layout": {"over": {"train.pipeline_parallel": True, "encoder.bert_layers": 2}},
    "int8_body": {"over": {"encoder.int8_text": True}},
}


@pytest.mark.parametrize("case", list(MODELS))
def test_fresh_model_draws_as_flax(case):
    variables, model = _model_case(**MODELS[case])
    ratios = assert_fresh_like_jax(variables, model)
    if case == "flagship":  # the two sites whose fans count the route axis
        assert abs(ratios["projector.kernel"] - 1.0) <= 0.2
    if case == "pipeline_layout":
        assert any(k.endswith("pp_layers.i_kernel") for k in ratios)


def test_densenet121_draws_as_flax():
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax_init(jcxr.ImageEncoder(d=32, vision_backbone="densenet121", norm_kind="batch"), x)
    torch.manual_seed(0)
    assert_fresh_like_jax(variables, tcxr.ImageEncoder(d=32, vision_backbone="densenet121", norm_kind="batch"))


ROUTES = ("L", "N", "I", "LN", "LI", "NI", "LNI")


def _route_embs(b: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(b, d)).astype(np.float32) for k in ROUTES}


def test_route_dim_adapter_draws_as_flax():
    """lecun_normal on the whole [R, d_src, d_in]: fan_in = R * d_src."""
    embs = {k: jnp.asarray(v) for k, v in _route_embs(2, 96).items()}
    variables = jax_init(JRouteDimAdapter(ROUTES, d_in=64, d_src=96), embs)
    torch.manual_seed(0)
    port = RouteDimAdapter(ROUTES, d_in=64, d_src=96)
    assert tuple(port.kernel.shape) == (7, 96, 64)
    assert port.kernel.std().item() == pytest.approx((7 * 96) ** -0.5, rel=0.02)
    assert_fresh_like_jax(variables, port)


def test_route_projector_with_logit_bias_draws_as_flax():
    """The projector's constant route-logit bias (interaction routes at
    logit(0.30)) beside its kernel, drawn on the whole [R, d_in, pc + 1]."""
    embs = {k: jnp.asarray(v) for k, v in _route_embs(2, 96).items()}
    variables = jax_init(JRoutePrimaryProjector(ROUTES, d_in=96, pc_dim=31, use_route_logit_bias=True), embs)
    torch.manual_seed(0)
    port = RoutePrimaryProjector(ROUTES, 96, 31, use_route_logit_bias=True)
    ratios = assert_fresh_like_jax(variables, port)
    assert set(ratios) == {"kernel"} and port.route_logit_bias.flatten().tolist()[3:] == pytest.approx([-0.8473] * 4, abs=1e-4)


@pytest.mark.parametrize("d_src", [48, 32])
def test_route_dim_adapter_forward_matches_jax(d_src):
    """The per-route einsum at 1e-6, and the identity (no parameter) when
    d_src == d_in."""
    embs = _route_embs(5, d_src, seed=d_src)
    jm = JRouteDimAdapter(ROUTES, d_in=32, d_src=d_src)
    jembs = {k: jnp.asarray(v) for k, v in embs.items()}
    variables = jax_init(jm, jembs)
    ref = jax.tree_util.tree_map(np.asarray, jm.apply(variables, jembs))
    port = load_jax_variables(RouteDimAdapter(ROUTES, d_in=32, d_src=d_src), {"params": {}, **variables})
    assert len(list(port.parameters())) == (0 if d_src == 32 else 1)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in embs.items()})
    assert list(got) == list(ROUTES) and sorted(ref) == sorted(ROUTES)
    for k in ROUTES:
        assert tuple(got[k].shape) == (5, 32)
        assert_close(got[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)
