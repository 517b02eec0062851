"""Pretrained encoder weights in the port (pretrained.py, fault F3) against
the JAX package's pretrained.py on the CPU, fp32:

- the HF BertModel importer against JAX ``import_hf_bert_params`` through a
  forward of the BERT encoder (the pooler ignored), and into the pipeline
  layout as JAX ``load_bert_weights`` puts it there;
- the torchvision importers (ResNet-18, DenseNet-121), copied in by
  ``copy_checked``, against JAX ``load_torchvision_backbone``, key for key
  and bit for bit;
- ``apply_pretrained`` against JAX ``apply_pretrained`` on a tiny flagship:
  the same weights after the splice and the same forward;
- the refusals: a shape (naming the leaf), a missing leaf, vision weights
  under GroupNorm; the state_dict file forms ``_load_state_dict`` reads;
- F3: ``train_model`` (and so ``cli train``) splices both files on a fresh
  init, before the EMA is taken, and never into a state it is given (so
  neither ``--resume`` nor ``--init-from`` re-applies them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu import pretrained as jpretrained
from multimodalrouting_tpu.models import clinbert as jclinbert
from multimodalrouting_tpu.models import cxr as jcxr
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.parallel.pp import to_pp_layout as jto_pp_layout
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch import pretrained
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.models import cxr
from multimodalrouting_tpu_torch.models.clinbert import BertEncoder, import_hf_bert_params
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel.pp import to_pp_layout
from multimodalrouting_tpu_torch.train.loop import train_model
from multimodalrouting_tpu_torch.train.state import create_train_state
from tests.helpers import tiny_batch
from tests.test_pretrained_product import _fake_hf_state_dict
from tests.test_torch_cli import TINY_SETS, _sets, run
from tests.test_torchvision_import import TvDenseNet, TvResNet, _randomize_bn_stats
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_close,
    compiled,
    jax_forwards,
    one_torch_thread,
    seeded_variables,
    to_numpy,
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BERT = dict(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64, max_position=32)
FLAGSHIP = {**TINY_SETS, "model.routes": "10", "model.num_classes": 2, "model.attn_dropout": 0.0,
            "model.relu_dropout": 0.0, "model.res_dropout": 0.0, "model.embed_dropout": 0.0}


def _hf_state_dict(**dims):
    """A seeded HF BertModel state_dict, the pooler included."""
    d = {**BERT, **dims}
    sd = _fake_hf_state_dict(d["vocab_size"], d["hidden"], d["layers"], d["intermediate"], d["max_position"])
    g = torch.Generator().manual_seed(1)
    for name in list(sd):  # LayerNorms away from 1 / 0, so that a swapped leaf shows
        if "LayerNorm" in name:
            sd[name] = sd[name] + 0.1 * torch.randn(sd[name].shape, generator=g)
    sd["pooler.dense.weight"] = torch.randn(d["hidden"], d["hidden"], generator=g)
    sd["pooler.dense.bias"] = torch.randn(d["hidden"], generator=g)
    return sd


def _tv(backbone: str):
    torch.manual_seed(0)
    tv = TvDenseNet() if backbone == "densenet121" else TvResNet((2, 2, 2, 2))
    with torch.no_grad():
        _randomize_bn_stats(tv, seed=1)
    return tv.state_dict()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """torch.save()d files: an HF BERT at FLAGSHIP's dims, one at BERT's,
    torchvision resnet18 (with its fc) and densenet121 (with its classifier)."""
    root = tmp_path_factory.mktemp("pretrained")
    e = tc.apply_overrides(tc.Config(), FLAGSHIP).encoder
    out = {
        "bert": _hf_state_dict(vocab_size=e.bert_vocab_size, hidden=e.bert_hidden, layers=e.bert_layers,
                               intermediate=e.bert_intermediate, max_position=e.bert_max_position),
        "bert_small": _hf_state_dict(),
        "resnet18": {**_tv("resnet18"), "fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10)},
        "densenet121": {**_tv("densenet121"), "classifier.weight": torch.zeros(10, 1024)},
    }
    paths = {}
    for name, sd in out.items():
        paths[name] = str(root / f"{name}.pt")
        torch.save(sd, paths[name])
    return paths, out


def _positive_var(variables):
    rng = np.random.default_rng(7)
    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.5 + rng.random(v.shape)).astype(v.dtype) if p[-1].key == "var" else v,
        variables["batch_stats"])
    return out


def test_hf_import_matches_jax_through_a_forward(files):
    paths, sds = files
    sd = sds["bert_small"]
    imported = import_hf_bert_params(sd, BERT["layers"])
    assert not any(k.startswith("pooler") for k in imported)
    bert = BertEncoder(**BERT)
    pretrained.load_bert_weights(paths["bert_small"], BERT["layers"], bert)
    assert all(torch.equal(bert.state_dict()[k], v) for k, v in imported.items())

    rng = np.random.default_rng(0)
    ids = rng.integers(0, BERT["vocab_size"], size=(3, 16)).astype(np.int32)
    attn = (np.arange(16)[None, :] < np.array([[16], [9], [4]])).astype(np.int32)
    jparams = jclinbert.import_hf_bert_params(sd, BERT["layers"])
    jbert = jclinbert.BertEncoder(**BERT)
    want = compiled(lambda p, i, a: jbert.apply({"params": p}, i, a), jparams, jnp.asarray(ids), jnp.asarray(attn))
    with torch.no_grad():
        got = bert(torch.from_numpy(ids), torch.from_numpy(attn))
    assert_close(got, np.asarray(want))


def test_hf_import_into_the_pipeline_layout_matches_jax(files):
    """A pp_layers BERT takes the file in its stacked layout, leaf for leaf
    as JAX ``load_bert_weights`` stacks it."""
    paths, sds = files
    bert = BertEncoder(**BERT, pipeline=True)
    pretrained.load_bert_weights(paths["bert_small"], BERT["layers"], bert)
    template = jto_pp_layout(jclinbert.import_hf_bert_params(sds["bert_small"], BERT["layers"]))
    want = state_dict_from_jax({"params": jpretrained.load_bert_weights(paths["bert_small"], BERT["layers"],
                                                                         template)}, bert)
    got = bert.state_dict()
    assert any(k.startswith("pp_layers.") for k in got)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    layered = BertEncoder(**BERT)
    pretrained.load_bert_weights(paths["bert_small"], BERT["layers"], layered)
    assert all(torch.equal(got[k], v) for k, v in to_pp_layout(layered.state_dict()).items())


@pytest.mark.parametrize("backbone", ["resnet18", "densenet121"])
def test_torchvision_import_matches_jax(files, backbone):
    paths, sds = files
    jenc = jcxr.ImageEncoder(d=16, vision_backbone=backbone, norm_kind="batch")
    shapes = jax.eval_shape(lambda v: jenc.init(jax.random.PRNGKey(0), v), jnp.zeros((1, 64, 64, 3)))
    variables = to_numpy(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    want = state_dict_from_jax(jcxr.load_torchvision_backbone(variables, sds[backbone], backbone),
                               cxr.ImageEncoder(d=16, vision_backbone=backbone, norm_kind="batch"))
    enc = cxr.ImageEncoder(d=16, vision_backbone=backbone, norm_kind="batch")
    pretrained.copy_checked(enc.backbone, cxr.import_torchvision_backbone_params(
        torch.load(paths[backbone], weights_only=True), backbone))
    got = enc.state_dict()
    keys = [k for k in got if k.startswith("backbone.")]
    assert len(keys) == len(enc.backbone.state_dict())
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def test_apply_pretrained_matches_jax(files):
    """Both files spliced into a tiny flagship (BatchNorm ResNet-18): the
    port's weights equal the JAX splice's, and so do the forwards."""
    paths, _ = files
    over = {**FLAGSHIP, "encoder.bert_weights": paths["bert"], "encoder.vision_weights": paths["resnet18"]}
    jcfg, tcfg = jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)
    batch = tiny_batch(n=2, seed=3)
    jmodel = jbuild_model(jcfg, "capsule")
    variables = _positive_var(seeded_variables(jmodel, jax.tree_util.tree_map(jnp.asarray, batch), seed=2))
    logs = []
    spliced = jpretrained.apply_pretrained(jcfg, variables, log_fn=lambda s: None)
    model = build_model(tcfg, device="cpu")
    load_jax_variables(model, variables)
    assert pretrained.apply_pretrained(tcfg, model, log_fn=logs.append) is model
    assert logs == [f"[pretrained] note encoder <- {paths['bert']}",
                    f"[pretrained] vision backbone <- {paths['resnet18']}"]
    want = state_dict_from_jax(spliced, model)
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    (ref,) = jax_forwards(jmodel, spliced, batch, [{}])
    with torch.no_grad():
        out = model(torch_batch(batch))
    assert_close(out.logits, np.asarray(ref.logits))


def test_refusals(files):
    paths, sds = files
    enc = cxr.ImageEncoder(d=16, vision_backbone="resnet34", norm_kind="batch")
    with pytest.raises(KeyError):  # resnet18's blocks are not resnet34's
        pretrained.copy_checked(enc.backbone, cxr.import_torchvision_backbone_params(sds["resnet18"], "resnet34"))
    dense = cxr.ImageEncoder(d=16, vision_backbone="densenet121", norm_kind="batch")
    before = {k: v.clone() for k, v in dense.state_dict().items()}
    bad = dict(sds["densenet121"])
    bad["features.denseblock2.denselayer3.conv2.weight"] = torch.zeros(32, 128, 1, 1)
    with pytest.raises(ValueError, match=r"block2_layer2\.conv2\.weight shape \(32, 128, 1, 1\) != template"):
        pretrained.copy_checked(dense.backbone, cxr.import_torchvision_backbone_params(bad, "densenet121"))
    assert all(torch.equal(v, before[k]) for k, v in dense.state_dict().items())  # nothing written
    with pytest.raises(ValueError, match="check encoder dims match the checkpoint"):
        pretrained.load_bert_weights(paths["bert_small"], 2, BertEncoder(**{**BERT, "hidden": 64}))
    over = {**FLAGSHIP, "encoder.vision_norm": "group", "encoder.vision_weights": paths["resnet18"]}
    model = build_model(tc.apply_overrides(tc.Config(), over), device="cpu")
    with pytest.raises(ValueError, match="vision_norm=batch"):
        pretrained.apply_pretrained(tc.apply_overrides(tc.Config(), over), model, log_fn=lambda s: None)


def test_load_state_dict_forms(files, tmp_path):
    """A raw state_dict, a {"state_dict": ...} wrapper and a pickled module
    (which needs weights_only=False) read the same."""
    paths, sds = files
    bert = BertEncoder(**BERT)
    torch.save({"state_dict": sds["resnet18"], "epoch": 3}, tmp_path / "wrapped.pt")
    torch.save(bert, tmp_path / "module.pt")
    wrapped = pretrained._load_state_dict(str(tmp_path / "wrapped.pt"))
    assert all(torch.equal(wrapped[k], v) for k, v in sds["resnet18"].items())
    from_module = pretrained._load_state_dict(str(tmp_path / "module.pt"))
    assert all(torch.equal(from_module[k], v) for k, v in bert.state_dict().items())


def _tiny_cohorts():
    from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort

    return [make_synthetic_cohort(8, t=12, f=16, s=2, l=16, image_size=32, vocab_size=1024, seed=s)
            for s in (0, 1)]


def test_train_model_splices_before_the_ema(files):
    """F3: with both keys set, train_model's fresh state holds the files'
    weights and BatchNorm statistics bit for bit, and so does its EMA
    (epochs=0: the state as train_model made it)."""
    paths, sds = files
    over = {**FLAGSHIP, "encoder.finetune_text": True, "train.epochs": 0, "encoder.bert_weights": paths["bert"],
            "encoder.vision_weights": paths["resnet18"]}
    cfg = tc.apply_overrides(tc.Config(), over)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    logs = []
    train_b, val_b = _tiny_cohorts()
    state = train_model(cfg, model, train_b, val_b, log_fn=logs.append).state
    want = {f"encoders.bbert.bert.{k}": v for k, v in import_hf_bert_params(sds["bert"], 1).items()}
    want.update({f"encoders.imgenc.backbone.{k}": v
                 for k, v in cxr.import_torchvision_backbone_params(sds["resnet18"], "resnet18").items()})
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    ema = [k for k in want if k in state.ema]
    assert len(ema) == len([k for k in want if not k.endswith(("running_mean", "running_var"))])
    assert all(torch.equal(state.ema[k], want[k]) for k in ema)
    assert f"[pretrained] note encoder <- {paths['bert']}" in logs
    assert f"[pretrained] vision backbone <- {paths['resnet18']}" in logs


def test_a_given_state_gets_no_splice(files):
    paths, _ = files
    over = {**FLAGSHIP, "train.epochs": 0, "encoder.bert_weights": paths["bert"],
            "encoder.vision_weights": paths["resnet18"]}
    cfg = tc.apply_overrides(tc.Config(), over)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs = []
    train_model(cfg, model, *_tiny_cohorts(), state=create_train_state(cfg, model), log_fn=logs.append)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not any(line.startswith("[pretrained]") for line in logs)


def test_cli_train_splices_and_init_from_does_not(files, tmp_path):
    paths, _ = files
    sets = [*_sets(**{"train.ckpt_every": 0}), "--set", f"encoder.bert_weights={paths['bert']}",
            "--set", f"encoder.vision_weights={paths['resnet18']}"]
    base = ["train", "--epochs", "1", "--device", "cpu", *sets]
    rc, text = run(tcli.main, [*base, "--out", str(tmp_path / "a")])
    assert rc == 0 and "[pretrained] note encoder <-" in text and "[pretrained] vision backbone <-" in text
    rc, text = run(tcli.main, [*base, "--out", str(tmp_path / "b"), "--init-from", str(tmp_path / "a")])
    assert rc == 0 and "[pretrained]" not in text
