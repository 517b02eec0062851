"""The port's unimodal trainers (train/unimodal.py, models/unimodal.py,
models/inspect.py, ``cli unimodal``) against the JAX package's on the CPU,
fp32, at tiny sizes:

- the forwards of ``WideBEHRTClassifier``, ``NoteEmbeddingClassifier``,
  ``OMOPConceptModel`` ([B] and [B, T] ids) and ``CTVolumeEncoder`` (with
  and without a slice mask) on the same weights (2e-4 / 2e-5), and
  ``focal_pos_weight_bce`` element-wise;
- one ``_fit`` step (AdamW with global-norm clipping, every leaf decayed)
  against the JAX trainer's jitted step, each leaf's change within 5e-4 in
  relative norm, under both losses; the plateau, early stop and best
  parameters on a scripted validation-loss sequence;
- ``_note_encoder`` / ``_embed_notes`` against JAX's ``_note_embeddings``
  from one weights file, with a tail that does not fill a minibatch;
  ``stratified_three_way`` index-equal to JAX's;
  ``take_batch`` / ``concat_batches``;
- whole runs of ``train_unimodal`` / ``train_omop`` / ``train_ct``, where
  the train loss falls (or the task is learnt) as the JAX tests require;
- ``cli unimodal --device cpu`` for all four modalities with the JAX CLI's
  JSON keys, the INSPECT CSV flags refused naming ROADMAP item 10, and a run
  in a process where jax cannot be imported.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.data import batches as jbatches
from multimodalrouting_tpu.data import stratified as jstratified
from multimodalrouting_tpu.models import inspect as jinspect
from multimodalrouting_tpu.models import unimodal as junimodal
from multimodalrouting_tpu.train import losses as jlosses
from multimodalrouting_tpu.train import unimodal as jtrain
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.data import batches as tbatches
from multimodalrouting_tpu_torch.data import stratified as tstratified
from multimodalrouting_tpu_torch.models import inspect as tinspect
from multimodalrouting_tpu_torch.models import unimodal as tunimodal
from multimodalrouting_tpu_torch.train import losses as tlosses
from multimodalrouting_tpu_torch.train import unimodal as ttrain
from tests.helpers import TINY, tiny_batch, tiny_config
from tests.test_pretrained_product import _fake_hf_state_dict
from tests.test_torch_cli import run
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    RTOL_STEPS,
    assert_close,
    compiled,
    one_torch_thread,
    relative_errors,
    seeded_like,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeded(module, *inputs, seed=0, **kw):
    """Seeded JAX variables for `module` at init's shapes."""
    shapes = jax.eval_shape(lambda *xs: module.init(jax.random.PRNGKey(0), *xs, **kw), *inputs)
    return seeded_like(shapes, seed)


def _jax_apply(module, variables, *inputs, **kw):
    out = compiled(lambda v, *xs: module.apply(v, *xs, **kw), variables, *[jnp.asarray(x) for x in inputs])
    return jax.tree_util.tree_map(np.asarray, out)


def _cfg(**extra):
    return tc.apply_overrides(tc.Config(), {**TINY, **extra})


# --- models and loss ------------------------------------------------------------


def test_wide_behrt_forward_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 6 * 5)).astype(np.float32)
    jm = junimodal.WideBEHRTClassifier(n_bins=6, n_labs=5, d=16, n_layers=1, n_heads=2)
    variables = _seeded(jm, x)
    tm = load_jax_variables(tunimodal.WideBEHRTClassifier(6, 5, d=16, n_layers=1, n_heads=2), variables)
    want = _jax_apply(jm, variables, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert list(got) == ["mortality", "pe", "ph"]
    for t in got:
        assert_close(got[t], want[t], err_msg=t)


@pytest.mark.parametrize("num_classes", [1, 4])
def test_note_classifier_forward_matches_jax(num_classes):
    x = np.random.default_rng(1).normal(size=(5, 24)).astype(np.float32)
    jm = junimodal.NoteEmbeddingClassifier(hidden=16, num_classes=num_classes)
    variables = _seeded(jm, x)
    tm = load_jax_variables(tunimodal.NoteEmbeddingClassifier(24, hidden=16, num_classes=num_classes), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == ((5,) if num_classes == 1 else (5, num_classes))
    assert_close(got, _jax_apply(jm, variables, x))


@pytest.mark.parametrize("seq", [0, 3])
def test_omop_forward_matches_jax(seq):
    rng = np.random.default_rng(2)
    shape = (4,) if not seq else (4, seq)
    ids = [rng.integers(0, v, size=shape).astype(np.int32) for v in (11, 7, 9)]
    jm = jinspect.OMOPConceptModel(11, 7, 9, hidden=16)
    variables = _seeded(jm, *ids)
    tm = load_jax_variables(tinspect.OMOPConceptModel(11, 7, 9, hidden=16), variables)
    want = _jax_apply(jm, variables, *ids)
    with torch.no_grad():
        got = tm(*[torch.from_numpy(i) for i in ids])
    assert list(got) == list(jinspect.INSPECT_TASKS)
    for t in got:
        assert_close(got[t], want[t], err_msg=t)


def test_ct_encoder_forward_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 32, 32, 1)).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    jm = jinspect.CTVolumeEncoder(d=16, backbone="resnet18", norm_kind="group")
    variables = _seeded(jm, x)
    tm = load_jax_variables(tinspect.CTVolumeEncoder(d=16, backbone="resnet18", norm_kind="group"), variables)
    want = compiled(lambda v, xs, m: (jm.apply(v, xs), jm.apply(v, xs, m)), variables, jnp.asarray(x),
                    jnp.asarray(mask))
    with torch.no_grad():
        got = (tm(torch.from_numpy(x)), tm(torch.from_numpy(x), torch.from_numpy(mask)))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w))


def test_focal_pos_weight_bce_matches_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(16, 3))).astype(np.float32)
    y = (rng.random((16, 3)) < 0.4).astype(np.float32)
    pw = np.array([0.5, 2.0, 3.5], np.float32)
    for gamma in (2.0, 2.5):
        want = jlosses.focal_pos_weight_bce(jnp.asarray(logits), jnp.asarray(y), gamma=gamma,
                                            pos_weight=jnp.asarray(pw), reduce=False)
        got = tlosses.focal_pos_weight_bce(torch.from_numpy(logits), torch.from_numpy(y), gamma=gamma,
                                           pos_weight=torch.from_numpy(pw), reduce=False)
        assert_close(got, np.asarray(want))
    assert_close(tlosses.focal_pos_weight_bce(torch.from_numpy(logits), torch.from_numpy(y)),
                 np.asarray(jlosses.focal_pos_weight_bce(jnp.asarray(logits), jnp.asarray(y))))


# --- the fit ----------------------------------------------------------------------


class _Fixed:
    """A flax module whose init returns the given variables: the JAX trainer's
    ``_fit`` then starts from weights the port can be given too."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kw):
        return self.variables

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


# the LR scale and decay of one step: Adam's normalised term moves each weight
# by about 3e-2 and the decay by 3e-2 of the weight, so both show in every
# leaf's change
FIT = dict(focal_gamma=2.5, lr=3e-2, weight_decay=1.0, batch_size=12, epochs=1, patience=3, seed=5)
ZERO_GRAD = 1e-6  # a leaf's gradient norm below this share of the global norm is rounding


def _reference_grads(jm, variables, x, y, tasks, loss_kind, tmpl):
    """The JAX trainer's loss gradient at the start, per port key."""
    pw = jnp.asarray([jtrain._pos_weight(y[:, i]) for i in range(y.shape[1])], jnp.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        logits = jnp.stack([out[t] for t in tasks], axis=1)
        if loss_kind == "focal":
            per = jlosses.focal_pos_weight_bce(logits, jnp.asarray(y), gamma=FIT["focal_gamma"], pos_weight=pw,
                                               reduce=False)
        else:
            per = jlosses.bce_with_logits(logits, jnp.asarray(y), pos_weight=pw, reduce=False)
        return jnp.sum(jnp.mean(per, axis=0))

    grads = jax.grad(loss)(variables["params"])
    return state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}, tmpl)


@pytest.mark.parametrize("loss_kind", ["pos_weight_bce", "focal"])
def test_one_fit_step_matches_jax(loss_kind):
    """One step (12 of 12 rows) and the validation loss: each leaf's change
    within 5e-4 of the JAX step's in relative norm, every leaf moved. A leaf
    whose reference gradient is zero up to rounding (the key projection's
    bias: softmax ignores a shift shared by every key) gets Adam's normalised
    rounding noise on both sides, so it is left out, and it is the only one."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(12, 4 * 6)).astype(np.float32)
    y = (rng.random((12, 3)) < 0.4).astype(np.float32)
    xv, yv = rng.normal(size=(5, 24)).astype(np.float32), (rng.random((5, 3)) < 0.5).astype(np.float32)
    tasks = ("mortality", "pe", "ph")
    jm = junimodal.WideBEHRTClassifier(n_bins=4, n_labs=6, d=16, n_layers=1, n_heads=2)
    variables = _seeded(jm, x, seed=8)
    jparams, jhist = jtrain._fit(_Fixed(jm, variables), x, y, xv, yv, tasks=tasks, loss_kind=loss_kind,
                                 log_fn=lambda s: None, **FIT)
    tm = load_jax_variables(tunimodal.WideBEHRTClassifier(4, 6, d=16, n_layers=1, n_heads=2), variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    grads = _reference_grads(jm, variables, x, y, tasks, loss_kind, tm)
    params, hist = ttrain._fit(tm, x, y, xv, yv, tasks=tasks, loss_kind=loss_kind, log_fn=lambda s: None, **FIT)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jparams)}, tm)
    g_norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
    noise = {k for k, g in grads.items() if float(g.norm()) <= ZERO_GRAD * g_norm}
    assert noise == {"behrt.layer_0.attn.k_proj.bias"}
    errors = relative_errors({k: params[k] - before[k] for k in want if k not in noise},
                             {k: v - before[k] for k, v in want.items() if k not in noise})
    worst = max(errors, key=errors.get)
    assert errors[worst] <= RTOL_STEPS, f"{worst} change off by {errors[worst]:.3e}"
    assert all(not torch.equal(params[k], before[k]) for k in params)
    np.testing.assert_allclose(hist[0]["train_loss"], jhist[0]["train_loss"], rtol=2e-4)
    np.testing.assert_allclose(hist[0]["val_loss"], jhist[0]["val_loss"], rtol=RTOL_STEPS)


def test_fit_schedule_on_scripted_val_losses(monkeypatch):
    """val losses 1.0, 0.5, 0.5 (not better by 1e-6), 0.7, 0.4, 0.9, 0.9, 0.9
    with patience 3: best at epochs 1 and 4, the LR cut after epochs 3 and 6,
    the stop after epoch 7; the model ends on epoch 4's parameters."""
    seq = iter([1.0, 0.5, 0.5 - 1e-7, 0.7, 0.4, 0.9, 0.9, 0.9, 0.1])
    snaps = []

    def scripted(model, *args):
        snaps.append({k: v.clone() for k, v in model.state_dict().items()})
        return next(seq)

    monkeypatch.setattr(ttrain, "_val_loss", scripted)
    rng = np.random.default_rng(9)
    x, y = rng.normal(size=(8, 12)).astype(np.float32), (rng.random(8) < 0.5).astype(np.float32)
    torch.manual_seed(0)
    model = tunimodal.NoteEmbeddingClassifier(12, hidden=8)
    logs = []
    params, hist = ttrain._fit(model, x, y, x, y, tasks=("mortality",), loss_kind="focal", focal_gamma=2.0,
                               lr=1e-2, weight_decay=0.0, batch_size=4, epochs=20, patience=3, seed=0,
                               log_fn=logs.append, dict_output=False)
    assert [h["val_loss"] for h in hist] == [1.0, 0.5, 0.5 - 1e-7, 0.7, 0.4, 0.9, 0.9, 0.9]
    assert [line for line in logs if "plateau" in line or "early" in line] == [
        "[unimodal] plateau: lr -> 1.00e-03", "[unimodal] plateau: lr -> 1.00e-04", "[unimodal] early stopping"]
    assert logs.index("[unimodal] plateau: lr -> 1.00e-03") == logs.index(next(s for s in logs if "ep 03" in s)) + 1
    assert all(torch.equal(params[k], snaps[4][k]) for k in params)
    assert all(torch.equal(v, snaps[4][k]) for k, v in model.state_dict().items())


# --- the rest of the trainer ---------------------------------------------------------


def test_note_embeddings_match_jax(tmp_path):
    """One BERT weights file on both sides (encoder.d == bert_hidden, so
    there is no randomly initialised projection), 7 stays in minibatches of 3."""
    sets = {"encoder.d": 32, "encoder.bert_hidden": 32, "train.batch_size": 3}
    e = tiny_config(**sets).encoder
    sd = _fake_hf_state_dict(e.bert_vocab_size, e.bert_hidden, e.bert_layers, e.bert_intermediate,
                             e.bert_max_position)
    torch.save(sd, tmp_path / "bert.pt")
    sets["encoder.bert_weights"] = str(tmp_path / "bert.pt")
    jcfg = tiny_config(**sets)
    tcfg = _cfg(**sets)
    batches = [tiny_batch(n=7, seed=1), tiny_batch(n=2, seed=2)]
    want = jtrain._note_embeddings(jcfg, batches, seed=0)
    got = ttrain._embed_notes(ttrain._note_encoder(tcfg, 0, "cpu"), batches, tcfg.train.batch_size)
    assert [g.shape for g in got] == [(7, 32), (2, 32)]
    for g, w in zip(got, want):
        assert_close(torch.from_numpy(g), w)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_stratified_three_way_matches_jax(seed):
    y = (np.random.default_rng(seed).random((97, 3)) < [0.1, 0.3, 0.5]).astype(np.float32)
    for a, b in zip(tstratified.stratified_three_way(y, seed=seed), jstratified.stratified_three_way(y, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_take_and_concat_batches_match_jax():
    parts = [tiny_batch(n=3, seed=s, task="multitask") for s in (0, 1)]
    want = jbatches.concat_batches(parts)
    got = tbatches.concat_batches([tbatches.Batch(*p) for p in parts])
    idx = np.array([4, 0, 2])
    for g, w in zip(tbatches.take_batch(got, idx), jbatches.take_batch(want, idx)):
        assert (g is None) == (w is None) and (g is None or np.array_equal(g, np.asarray(w)))
    with pytest.raises(ValueError, match="mixed None"):
        tbatches.concat_batches([tbatches.Batch(*parts[0]), tbatches.Batch(*parts[1])._replace(sens=None)])
    sliced = tbatches.slice_batch(got, 2, 3)
    assert sliced.batch_size == 3 and np.array_equal(sliced.y, want.y[2:5])


# --- whole runs -----------------------------------------------------------------------


def _port_batch(*args, **kw):
    return tbatches.Batch(*tiny_batch(*args, **kw))


@pytest.mark.parametrize("task", ["multitask", "readmit"])
def test_train_unimodal_behrt_loss_falls(task, tmp_path):
    cfg = _cfg(**{"train.epochs": 5 if task == "multitask" else 4, "train.lr": 1e-3, "train.batch_size": 16})
    res = ttrain.train_unimodal(cfg, _port_batch(n=64, task=task), _port_batch(n=32, seed=1, task=task),
                                _port_batch(n=32, seed=2, task=task), modality="behrt", task=task, out_dir=str(tmp_path), log_fn=lambda s: None,
                                device="cpu")
    assert list(res.metrics) == (["mortality", "pe", "ph"] if task == "multitask" else ["readmit"])
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
    fair = json.loads((tmp_path / "fairness.json").read_text())
    assert set(fair) == set(res.metrics) and "sens" in fair[list(fair)[0]]["attributes"]
    assert json.loads((tmp_path / "unimodal_metrics.json").read_text())["modality"] == "behrt"


def test_train_unimodal_note_runs():
    cfg = _cfg(**{"train.epochs": 3, "train.lr": 1e-3, "train.batch_size": 16})
    res = ttrain.train_unimodal(cfg, _port_batch(n=48), _port_batch(n=16, seed=1), _port_batch(n=16, seed=2),
                                modality="note",
                                log_fn=lambda s: None, device="cpu")
    assert list(res.metrics) == ["mortality"] and np.isfinite(res.history[-1]["val_loss"])


def test_train_omop_learns_the_procedure_task(tmp_path):
    def split(n, seed):
        r = np.random.default_rng(seed)
        proc = r.integers(0, 50, n)
        y = np.stack([(proc % 2 == 0).astype(np.float32)] + [r.integers(0, 2, n).astype(np.float32)
                                                              for _ in range(3)], axis=1)
        return {"proc": proc, "meas": r.integers(0, 30, n), "drug": r.integers(0, 40, n), "y": y,
                "sens": r.integers(0, 2, n)}

    res = ttrain.train_omop({"train": split(256, 0), "val": split(64, 1), "test": split(64, 2)}, vocab_sizes=(50, 30, 40), hidden=32,
                            epochs=30, batch_size=32, lr=5e-3, patience=30, out_dir=str(tmp_path),
                            log_fn=lambda s: None, device="cpu")
    assert set(res.metrics) == {"pe", "mort1m", "read1m", "ph12m"}
    assert res.metrics["pe"]["auroc"] > 0.8
    assert (tmp_path / "fairness.json").exists()


# --- the CLI --------------------------------------------------------------------------

CLI_SETS = ["--set", "data.synthetic_n=32", "--set", "encoder.d=16", "--set", "model.d=16",
            "--set", "encoder.structured_layers=1", "--set", "encoder.structured_heads=2",
            "--set", "encoder.structured_seq_len=8", "--set", "encoder.structured_n_feats=6",
            "--set", "encoder.bert_layers=1", "--set", "encoder.bert_hidden=16", "--set", "encoder.bert_heads=2",
            "--set", "encoder.bert_intermediate=32", "--set", "encoder.bert_vocab_size=256",
            "--set", "encoder.bert_max_position=32", "--set", "encoder.text_max_len=16",
            "--set", "encoder.notes_max_chunks=2", "--set", "encoder.vision_backbone=resnet18",
            "--set", "train.batch_size=8"]


@pytest.mark.parametrize("modality, extra", [
    ("behrt", ["--task", "multitask"]), ("behrt", ["--task", "readmit"]), ("note", []), ("omop", []),
])
def test_cli_unimodal(modality, extra, tmp_path):
    rc, text = run(tcli.main, ["unimodal", "--modality", modality, *extra, "--epochs", "2", "--device", "cpu",
                               "--out", str(tmp_path), *CLI_SETS])
    summary = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and set(summary) == {"modality", "tasks", "auroc", "out_dir"}
    assert summary["modality"] == modality and summary["out_dir"] == str(tmp_path)
    assert ("[stratify] multilabel-stratified split" in text) == (extra == ["--task", "multitask"])
    want = {"omop": ["pe", "mort1m", "read1m", "ph12m"], "note": ["mortality"]}.get(
        modality, ["mortality", "pe", "ph"] if "multitask" in extra else ["readmit"])
    assert summary["tasks"] == want and all(np.isfinite(summary["auroc"][t]) for t in want)
    fair = json.loads((tmp_path / "fairness.json").read_text())
    assert set(fair) == set(want)


def test_cli_unimodal_ct_learns_the_slab_task(tmp_path):
    """The JAX CLI test's run (6 epochs, 96 stays, batch 32): the
    slab-intensity pe task beats chance."""
    rc, text = run(tcli.main, ["unimodal", "--modality", "ct", "--epochs", "6", "--out", str(tmp_path),
                               "--device", "cpu", "--set", "data.synthetic_n=96", "--set", "model.d=32",
                               "--set", "train.batch_size=32", "--set", "train.lr=1e-3",
                               "--set", "encoder.vision_backbone=resnet18"])
    res = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and res["modality"] == "ct" and set(res["auroc"]) == {"pe", "mort1m", "read1m", "ph12m"}
    assert res["auroc"]["pe"] > 0.6, res["auroc"]
    assert (tmp_path / "unimodal_metrics.json").exists() and (tmp_path / "fairness.json").exists()


@pytest.mark.parametrize("argv", [["--modality", "note", "--impressions-csv", "x.csv"],
                                  ["--modality", "omop", "--inspect-csv", "x.csv"]])
def test_cli_unimodal_inspect_loaders_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 10"):
        tcli.main(["unimodal", *argv, "--device", "cpu"])


def test_cli_unimodal_needs_no_jax(tmp_path):
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "multimodalrouting_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from multimodalrouting_tpu_torch import cli
sys.exit(cli.main(["unimodal", "--modality", "omop", "--epochs", "1", "--device", "cpu", "--out", {str(tmp_path)!r},
                   "--set", "model.d=16", "--set", "train.batch_size=32"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["modality"] == "omop"


def test_bridge_maps_the_trainer_wrappers():
    """The JAX trainers' adapters hold their models under ``omop`` and
    ``ct`` with one ``head_{t}`` per task beside ``ct``: their variables map
    onto the port's wrappers key for key, every key filled."""
    from flax import linen as nn

    tasks = jinspect.INSPECT_TASKS
    ids = np.zeros((2,), np.int32)
    omop = _seeded(jinspect.OMOPConceptModel(11, 7, 9, hidden=16), ids, ids, ids)
    port = ttrain.OMOPStacked((11, 7, 9), 16, tasks)
    assert set(state_dict_from_jax({"params": {"omop": omop["params"]}}, port)) == set(port.state_dict())
    x = np.zeros((1, 2, 32, 32, 1), np.float32)
    ct = _seeded(jinspect.CTVolumeEncoder(d=16, backbone="resnet18", norm_kind="group"), x)
    heads = {f"head_{t}": _seeded(nn.Dense(1), np.zeros((1, 16), np.float32))["params"] for t in tasks}
    port = ttrain.CTMultitask(16, "resnet18", tasks)
    assert set(state_dict_from_jax({"params": {"ct": ct["params"], **heads}}, port)) == set(port.state_dict())
