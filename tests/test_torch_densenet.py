"""The port's DenseNet-121 (models/cxr.py) against the JAX package's on the
CPU, fp32:

- ``DenseNet`` at reduced block sizes (growth kept at 32, so GroupNorm(32)
  holds) at 32^2, batch 2, under BatchNorm and GroupNorm, in eval and train
  mode: the pooled features and the feature map, the new running statistics
  of a training forward, and the gradient of every parameter against
  ``jax.grad`` (2e-4 / 2e-5);
- the full-depth densenet121 against the torchvision-named oracle
  ``TvDenseNet`` from one torchvision state_dict, at 64^2;
- ``ImageEncoder`` takes its channel count from the backbone, and the
  flagship builds and trains on DenseNet-121 (all 121 BatchNorms commit new
  running statistics in a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu.models import cxr as jcxr
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.models import cxr
from multimodalrouting_tpu_torch.models.full import build_model, collect_batch_stats
from multimodalrouting_tpu_torch.pretrained import copy_checked
from multimodalrouting_tpu_torch.train.state import create_train_state
from multimodalrouting_tpu_torch.train.steps import make_train_step
from tests.helpers import TINY, tiny_batch
from tests.test_torchvision_import import TvDenseNet, _randomize_bn_stats
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_close,
    compiled,
    one_torch_thread,
    seeded_like,
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCKS = (2, 3)  # two dense blocks and one transition at 32^2: 16 -> 8 -> 4


def _variables(norm: str, x):
    """Seeded DenseNet variables at init's shapes, BatchNorm variances positive."""
    module = jcxr.DenseNet(block_sizes=BLOCKS, norm_kind=norm)
    shapes = jax.eval_shape(lambda v: module.init(jax.random.PRNGKey(0), v), x)
    variables = seeded_like(shapes, seed=4)
    if "batch_stats" in variables:
        rng = np.random.default_rng(5)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, v: (0.5 + rng.random(v.shape)).astype(v.dtype) if p[-1].key == "var" else v,
            variables["batch_stats"])
    return module, variables


@pytest.fixture(scope="module", params=["batch", "group"])
def case(request):
    """(norm, x, the JAX outputs: eval (pooled, fmap), train (pooled, fmap,
    new stats), the gradient of sum(pooled * w) in train mode; the port
    DenseNet holding the same variables, the variables)."""
    norm = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    module, variables = _variables(norm, x)
    c_out = (64 + 32 * BLOCKS[0]) // 2 + 32 * BLOCKS[1]
    w = rng.normal(size=(2, c_out)).astype(np.float32)

    def run(v, xs, ws):
        evald = module.apply(v, xs, train=False)
        (pooled, fmap), upd = module.apply(v, xs, train=True, mutable=["batch_stats"])

        def loss(params):
            (p, _), _ = module.apply({**v, "params": params}, xs, train=True, mutable=["batch_stats"])
            return jnp.sum(p * ws)

        return evald, (pooled, fmap, upd.get("batch_stats")), jax.grad(loss)(v["params"])

    ref = jax.tree_util.tree_map(np.asarray, compiled(run, variables, jnp.asarray(x), jnp.asarray(w)))
    port = cxr.DenseNet(BLOCKS, norm_kind=norm)
    load_jax_variables(port, variables)
    return norm, x, w, ref, port, variables


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("train", [False, True])
def test_densenet_forward_matches_jax(case, train):
    norm, x, _, ref, port, variables = case
    pooled, fmap = port(_nchw(x), train)
    want = ref[1] if train else ref[0]
    assert_close(pooled, want[0], err_msg=f"{norm} pooled")
    assert_close(fmap.permute(0, 2, 3, 1), want[1], err_msg=f"{norm} fmap")
    stats = collect_batch_stats(port)
    if norm == "group" or not train:
        assert stats == {}
        return
    ref_stats = state_dict_from_jax({"params": variables["params"], "batch_stats": want[2]}, port)
    assert len(stats) == 2 * sum(1 for m in port.modules() if isinstance(m, cxr.BatchNorm))
    for key, value in stats.items():
        assert_close(value, ref_stats[key], err_msg=key)


def test_densenet_gradient_matches_jax(case):
    norm, x, w, ref, port, variables = case
    port.zero_grad()
    pooled, _ = port(_nchw(x), True)
    (pooled * torch.from_numpy(w)).sum().backward()
    collect_batch_stats(port)  # clear the pending statistics
    want = state_dict_from_jax({"params": ref[2], "batch_stats": variables.get("batch_stats")}, port)
    named = dict(port.named_parameters())
    assert set(named) <= set(want)
    for key, p in named.items():
        assert_close(p.grad, want[key], err_msg=f"{norm} d{key}")


def test_densenet121_matches_torchvision_oracle():
    """The full-depth backbone from a torchvision-layout state_dict
    (classifier-free, BatchNorm statistics randomised) at 64^2, eval mode."""
    torch.manual_seed(0)
    tv = TvDenseNet().eval()
    with torch.no_grad():
        _randomize_bn_stats(tv, seed=1)
    enc = cxr.ImageEncoder(d=32, vision_backbone="densenet121", norm_kind="batch")
    copy_checked(enc.backbone, cxr.import_torchvision_backbone_params(
        {**tv.state_dict(), "classifier.weight": torch.zeros(10, 1024)}, "densenet121"))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want_pooled, want_fmap = tv(x.permute(0, 3, 1, 2))
        pooled, fmap = enc.backbone(_nchw(x.numpy()))
    assert_close(pooled, want_pooled)
    assert_close(fmap, want_fmap)
    assert enc.backbone.out_channels == 1024 and tuple(enc.proj.weight.shape) == (32, 1024)
    tokens, mask, pooled_d, chexpert = enc(x)
    assert tuple(tokens.shape) == (2, 4, 32) and tuple(pooled_d.shape) == (2, 32) and tuple(chexpert.shape) == (2, 14)


def test_image_encoder_bridge_covers_jax_densenet121():
    """Every leaf of the JAX ImageEncoder(densenet121) maps onto the port's,
    and every port key is filled (names and shapes, from eval_shape)."""
    enc = jcxr.ImageEncoder(d=32, vision_backbone="densenet121", norm_kind="batch")
    shapes = jax.eval_shape(lambda v: enc.init(jax.random.PRNGKey(0), v), jnp.zeros((1, 64, 64, 3)))
    port = cxr.ImageEncoder(d=32, vision_backbone="densenet121", norm_kind="batch")
    sd = state_dict_from_jax(seeded_like(shapes, seed=1), port)
    assert set(sd) == set(port.state_dict())


def test_flagship_trains_on_densenet121():
    """build_model with densenet121 (no longer raising): a training step
    commits new running statistics into all 121 BatchNorms."""
    over = {**TINY, "encoder.vision_backbone": "densenet121", "encoder.vision_norm": "batch",
            "encoder.image_size": 32}
    cfg = tc.apply_overrides(tc.Config(), over)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    bns = {n: m for n, m in model.named_modules() if isinstance(m, cxr.BatchNorm)}
    assert len(bns) == 121 and model.encoders.imgenc.proj.weight.shape[1] == 1024
    before = {n: m.running_mean.clone() for n, m in bns.items()}
    state = create_train_state(cfg, model)
    metrics = make_train_step(cfg, model)(state, torch_batch(tiny_batch(n=4)), None, 1e-3, 1e-3)
    assert metrics.grad_finite and np.isfinite(float(metrics.loss))
    assert all(not torch.equal(bns[n].running_mean, before[n]) for n in bns)
