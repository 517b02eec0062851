"""The port's training loop (``train/loop.py:train_model``) against the JAX
package's, epoch by epoch, on the CPU: the same seeded weights, the same
numpy cohort, the loop settings of ``scripts/demo_families.py:160-172``
(``train.min_epochs=0``, ``early_stop_patience=3``,
``encoder_warmup_epochs=1``, ``ckpt_every=0``, ``use_ema=false``) with
``route_dropout_p=0`` and every dropout 0, 4 epochs of 6 steps (64 train
stays in batches of 10) and 40 validation stays (8 positives), at the tiny
widths of tests/test_torch_families.py.

Cases (one parametrised test): LateFusion under the fame loss; FAME++ at
stage tri with the learned gate and with the loss-based gate; the 10-route
capsule model (its loss trains the contrast l1 - l0 that the loop's monitor
reads; the others train both logits toward the label); and the curriculum
hand-off that feeds ``fame-tri-lossbased``: FAME++ trained at bi for 2
epochs by the JAX loop, saved by the JAX ``save_checkpoint``, then stage tri
under the loss-based gate in both packages from that one checkpoint, as
``cli train --init-from`` starts it (``restore_checkpoint`` /
``ckpt.restore_train_state`` with ``params_only``).

Each loop is recorded through its own module: the train step's loss, and
the evaluation step's logits (the JAX loop turns logits into
probabilities inline, so both loops' ``make_eval_step`` is wrapped, not
``probs_from_logits``).

**Epoch-synchronised.** Free-running, the two trajectories part by fp32
rounding that Adam amplifies. From the JAX loop's state before each of the
24 steps of fame tri, one port step lands within 6e-6 per leaf of JAX's
next state; free-running, the ResNet's conv weights part from step 9 and
grow about 1.5x a step, to 2e-3 per leaf and 3% of max|logit| in the val
logits after 24 steps (``python -m tests.test_torch_loop_parity steps
CASE`` and ``free`` print both). The first jump is one of the 128
elements of a GroupNorm bias of the image encoder at step 10, whose Adam
update (lr * m / sqrt(v)) takes the other sign. So at the first step of
every epoch after the first the port's state is first held against the
JAX loop's state at the same point and then set to it: weights, Adam
moments and count. Nothing the loop carries by itself is set: the step
counter, the route-loss EMA, the LR scale and plateau count, the best
values, the sampler's generator. Each epoch is thus 6 free steps of the
port's loop from JAX's state, and every check below sees the loop's own
decisions at the tolerance of 6 steps.

Tolerances, and why:

- epochs run, best epoch, early stop and the LR scale of every epoch: equal
  (decisions of the loop);
- train loss of every epoch: 1e-3 relative (six steps at 5e-4 per leaf,
  ``tests/torch_parity.py:RTOL_STEPS``, through a loss near 0.6);
- val logits of every evaluation: within 1e-3 x max|logit| (6 free steps
  move them by at most 1.2e-4 x max|logit| here);
- the loop's val AUROC, and the AUROC of each logit column and of the
  contrast: equal wherever no two of the scores lie closer than that logit
  tolerance (a closer pair may swap its rank order by rounding);
- weights at each epoch's end (before the sync) and at the run's end: each
  leaf within 5e-3 in relative norm (``RTOL_STEPS`` over 6 steps' growth;
  7e-5 at most here);
- Adam's moments at each epoch's end: each leaf within 5e-2, leaving out
  the leaves whose JAX moment is zero up to rounding (norm <= 1e-6 of the
  global norm: the attention key biases, whose gradient is zero up to
  rounding, and the heads the family does not use, as in
  tests/test_torch_unimodal.py). A moment averages the last steps'
  gradients, and the image encoder's gradient is what moves most with its
  weights (the sensitivity above): after the first epoch in which the
  encoders train, up to 1.2e-2 here. A moment that was reset or mixed up is
  off by 1 or more. The step and the Adam count: equal;
- the route-loss EMA after every epoch and at the end: 5e-3 in relative
  norm;
- ``best_metric`` and the thresholds: equal (no near tie, as above); the
  fitted temperature: 1e-3 relative (a smooth function of the logits).

Four cases run in processes of their own (``python -m
tests.test_torch_loop_parity worker CASE OUT``, each JAX run and then its
port run), the hand-off in the test's process meanwhile; each hands back
only what the checks read (``summarize``). The file alone: ~85 s with a
cold JAX compile cache, ~60 s warm.
"""
from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.ckpt import restore_checkpoint as jrestore_checkpoint
from multimodalrouting_tpu.ckpt import save_checkpoint as jsave_checkpoint
from multimodalrouting_tpu.data.batches import Batch as JBatch
from multimodalrouting_tpu.models.baselines import build_baseline as jbuild_baseline
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train import loop as jloop
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu.train.state import n_route_loss_ema_for as jn_route_loss_ema_for
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax, train_state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import restore_train_state
from multimodalrouting_tpu_torch.metrics.classification import auroc
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train import loop as tloop
from multimodalrouting_tpu_torch.train.state import create_train_state, n_route_loss_ema_for
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import one_torch_thread, relative_errors, seeded_variables, to_numpy  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_TRAIN, N_VAL, BATCH, EPOCHS = 64, 40, 10, 4
STEPS = N_TRAIN // BATCH  # 6 a epoch
LOOP = {
    **TINY, "encoder.text_max_len": 16, "encoder.image_size": 32,  # tests/test_torch_families.py:FAMILY
    "model.fusion_dropout": 0.0, "model.smro_dropout": 0.0, "model.attn_dropout": 0.0, "model.relu_dropout": 0.0,
    "model.res_dropout": 0.0, "model.embed_dropout": 0.0, "train.route_dropout_p": 0.0,
    # scripts/demo_families.py:160-172
    "train.min_epochs": 0, "train.early_stop_patience": 3, "train.encoder_warmup_epochs": 1, "train.ckpt_every": 0,
    "encoder.note_pack": False, "train.use_ema": False,
    "train.epochs": EPOCHS, "train.batch_size": BATCH,
}
LOSS_RTOL = 1e-3
LOGIT_TOL = 1e-3  # x max|logit|
STATE_RTOL = 5e-3
MOMENT_RTOL = 5e-2
NOISE_ONLY = 1e-6  # a moment leaf's share of the global norm below which it is rounding noise
TEMPERATURE_RTOL = 1e-3

# case -> (model family, loss family, stage, config overrides)
CASES = {
    "late_fusion": ("late_fusion", "fame", "", {}),
    "fame_tri_learned": ("fame", "fame", "tri", {"model.routes": "7"}),
    "fame_tri_loss_based": ("fame", "fame", "tri", {"model.routes": "7", "model.smro_gate_mode": "loss_based"}),
    "capsule_10": ("capsule", "capsule", "", {"model.routes": "10"}),
    "init_from_fame_bi": ("fame", "fame", "tri", {"model.routes": "7", "model.smro_gate_mode": "loss_based"}),
}
BI_EPOCHS = 2  # the JAX run that writes the checkpoint the last case starts from


def cfgs(**extra):
    over = {**LOOP, **extra}
    return jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)


def cohorts():
    """(train, val) of one numpy cohort, drawn once and split."""
    c = tiny_batch(n=N_TRAIN + N_VAL, seed=0, task="mort", missing_rate=0.3)
    train = JBatch(*(None if v is None else v[:N_TRAIN] for v in c))
    val = JBatch(*(None if v is None else v[N_TRAIN:] for v in c))
    assert int(val.y.sum()) >= 5
    return train, val


def jax_model(cfg, model_family):
    return jbuild_baseline(cfg, model_family) if model_family in ("late_fusion", "trimf") else jbuild_model(
        cfg, model_family)


def jax_variables(model, train):
    example = jax.tree_util.tree_map(jnp.asarray, JBatch(*(None if v is None else v[:BATCH] for v in train)))
    return seeded_variables(model, example, 1)


# --- recording both loops ---------------------------------------------------------
# A run sets `REC` (one run at a time in a process); the loop modules' step
# factories are wrapped (``recording``) and record into it.
REC: dict = {}


def _jax_state(state):
    return to_numpy({"params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state,
                     "step": state.step, "route_loss_ema": state.route_loss_ema})


def _record_jax_train(factory):
    def make(*args, **kwargs):
        step = factory(*args, **kwargs)

        def recorded(state, *a, **kw):
            i = len(REC["loss"])
            if i and i % STEPS == 0:  # the state the next epoch starts from (the step donates it)
                REC["boundary"].append(_jax_state(state))
            state, metrics = step(state, *a, **kw)
            REC["loss"].append(float(metrics.loss))
            return state, metrics

        return recorded

    return make


def _record_port_train(factory):
    def make(*args, **kwargs):
        step = factory(*args, **kwargs)

        def recorded(state, *a, **kw):
            i = len(REC["loss"])
            if i and i % STEPS == 0:
                boundary = REC["jax_boundary"]
                k = i // STEPS - 1
                if k < len(boundary):
                    REC["boundary"].append(hold_and_sync(state, boundary[k]))
            metrics = step(state, *a, **kw)
            REC["loss"].append(float(metrics.loss))
            return metrics

        return recorded

    return make


def _record_eval(factory):
    def make(*args, **kwargs):
        step = factory(*args, **kwargs)

        def recorded(*a, **kw):
            out = step(*a, **kw)
            logits = out.logits.numpy() if isinstance(out.logits, torch.Tensor) else out.logits
            REC["logits"].append(np.array(logits, dtype=np.float32))
            return out

        return recorded

    return make


def recording(setattr_):
    """Wrap both loop modules' step factories with `setattr_(module, name,
    value)` (``monkeypatch.setattr`` in the test's process)."""
    for mod, make_train in ((jloop, _record_jax_train), (tloop, _record_port_train)):
        setattr_(mod, "make_train_step", make_train(mod.make_train_step))
        setattr_(mod, "make_eval_step", _record_eval(mod.make_eval_step))


def moment_errors(got, ref):
    """Per leaf ||got - ref|| / ||ref|| of an Adam moment, leaving out the
    leaves whose reference is rounding noise (``NOISE_ONLY``)."""
    total = np.sqrt(sum(float(r.double().norm()) ** 2 for r in ref.values()))
    keep = {k: r for k, r in ref.items() if float(r.double().norm()) > NOISE_ONLY * total}
    return relative_errors(got, keep), sorted(set(ref) - set(keep))


def hold_and_sync(state, jax_state):
    """The port's state at an epoch's end against the JAX loop's at the same
    point (-> the errors), then set to it: weights, moments and Adam count;
    nothing the loop carries by itself."""
    saved = train_state_dict_from_jax(jax_state, state.model)
    mu_err, noise = moment_errors({n: state.mu[n] for n in state.names}, saved["mu"])
    nu_err, _ = moment_errors({n: state.nu[n] for n in state.names}, saved["nu"])
    held = {
        "params": relative_errors(state.model.state_dict(), saved["model"]),
        "mu": mu_err, "nu": nu_err, "noise_only": noise,
        "step": (state.step, saved["step"]), "count": (state.count, saved["count"]),
        "rle": None if state.route_loss_ema is None else (state.route_loss_ema.numpy().copy(),
                                                          saved["route_loss_ema"].numpy()),
    }
    state.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for n in state.names:
            state.mu[n].copy_(saved["mu"][n])
            state.nu[n].copy_(saved["nu"][n])
    state.count = saved["count"]
    return held


# --- one case -----------------------------------------------------------------------

def jax_start(jcfg, model, train, family, stage):
    return jcreate_train_state(jcfg, model, jax.tree_util.tree_map(jnp.asarray, jax_variables(model, train)),
                               stage=stage, n_route_loss_ema=jn_route_loss_ema_for(jcfg, family))


def hand_off(jcfg, tcfg, model, train, val, family, stage):
    """The JAX loop trains FAME++ (learned gate) at bi for BI_EPOCHS and
    writes it with the JAX ``save_checkpoint``; both packages then start
    `stage` from it as ``cli train --init-from`` does. -> (JAX state, port
    model, port state, what each side kept)."""
    bcfg, btcfg = cfgs(**{"model.routes": "7", "train.epochs": BI_EPOCHS})
    bmodel = jax_model(bcfg, "fame")
    REC.update(loss=[], logits=[], boundary=[])
    bi = jloop.train_model(bcfg, bmodel, train, val, family="fame", stage="bi",
                           init_state=jax_start(bcfg, bmodel, train, "fame", "bi"), log_fn=lambda s: None)
    ckpt = tempfile.mkdtemp(prefix="loop_parity_")
    try:
        jsave_checkpoint(ckpt, bi.state, bcfg, name="final")
        jstate = jrestore_checkpoint(ckpt, jax_start(jcfg, model, train, family, stage), name="final",
                                     params_only=True)
        tmodel = build_model(tcfg, "fame", device="cpu", train=True)
        tstate = create_train_state(tcfg, tmodel, stage=stage, n_route_loss_ema=n_route_loss_ema_for(tcfg, family))
        tstate = restore_train_state(ckpt, tstate, name="final", params_only=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    start = _jax_state(jstate)
    ref = state_dict_from_jax({"params": start["params"]}, tmodel)
    bi_params = to_numpy(bi.state.params)
    bi_sd = state_dict_from_jax({"params": bi_params}, tmodel, strict=False)
    saved = train_state_dict_from_jax(start, tmodel)
    kept = {
        "bi_epochs": len(bi.history),
        "port_keys_equal_jax": sorted(tmodel.state_dict()) == sorted(ref),
        "port_weights_unequal": [k for k, v in tmodel.state_dict().items() if not torch.equal(v, ref[k])],
        "jax_weights_not_bi": [k for k in ref if not torch.equal(ref[k], bi_sd[k])],
        "left_out": sorted(set(state_dict_from_jax({"params": bi_params}, build_model(btcfg, "fame", device="cpu")))
                           - set(ref)),
        "step": (tstate.step, int(start["step"])), "count": (tstate.count, saved["count"]),
        "moments_max": (max(float(v.abs().max()) for v in (*tstate.mu.values(), *tstate.nu.values())),
                        max(float(v.abs().max()) for v in (*saved["mu"].values(), *saved["nu"].values()))),
        "rle": (tstate.route_loss_ema.numpy().copy(), np.asarray(start["route_loss_ema"])),
    }
    return jstate, tmodel, tstate, kept


def summarize(name: str, sync: bool = True) -> dict:
    """Both loops of one case from the same weights (`sync`: the port's
    state set to JAX's at each epoch's end, after it is held) -> what the
    checks read: histories, per-step losses, each evaluation's logits, the
    errors at each epoch's end and at the run's end, the route-loss EMAs,
    best_metric / thresholds / temperature, and the hand-off's start."""
    model_family, family, stage, extra = CASES[name]
    jcfg, tcfg = cfgs(**extra)
    train, val = cohorts()
    model = jax_model(jcfg, model_family)
    kept = None
    if name == "init_from_fame_bi":
        jstate, tmodel, tstate, kept = hand_off(jcfg, tcfg, model, train, val, family, stage)
    else:
        variables = jax_variables(model, train)
        jstate = jax_start(jcfg, model, train, family, stage)
        tmodel = load_jax_variables(build_model(tcfg, model_family, device="cpu", train=True), variables)
        tstate = create_train_state(tcfg, tmodel, stage=stage, n_route_loss_ema=n_route_loss_ema_for(tcfg, family))
    REC.clear()
    REC.update(loss=[], logits=[], boundary=[])
    jres = jloop.train_model(jcfg, model, train, val, family=family, stage=stage, init_state=jstate,
                             log_fn=lambda s: None)
    jrec = dict(REC)
    jfinal = _jax_state(jres.state)
    REC.clear()
    REC.update(loss=[], logits=[], boundary=[], jax_boundary=jrec["boundary"] if sync else [])
    tres = tloop.train_model(tcfg, tmodel, train, val, family=family, stage=stage, state=tstate,
                             log_fn=lambda s: None)
    trec = dict(REC)
    REC.clear()
    ref = state_dict_from_jax({"params": jfinal["params"]}, tmodel)
    side = lambda res, rec: {  # noqa: E731
        "history": res.history, "loss": rec["loss"], "evaluations": evaluations(rec["logits"]),
        "best_metric": res.best_metric, "thresholds": np.asarray(res.thresholds), "temperature": res.temperature}
    return {
        "y": np.asarray(val.y), "jax": side(jres, jrec), "port": side(tres, trec), "boundary": trec["boundary"],
        "n_jax_boundary": len(jrec["boundary"]),
        "final_weights": relative_errors(tmodel.state_dict(), ref),
        "rle": (None if tres.state.route_loss_ema is None else tres.state.route_loss_ema.numpy().copy(),
                None if jfinal["route_loss_ema"] is None else np.asarray(jfinal["route_loss_ema"])),
        "hand_off": kept,
    }


def evaluations(logits):
    """The recorded logits, one [N_VAL, 2] array per pass over the split."""
    per = -(-N_VAL // BATCH)
    assert len(logits) % per == 0
    return [np.concatenate(logits[i:i + per])[:N_VAL] for i in range(0, len(logits), per)]


def worker(name: str, out: str) -> None:
    """One case in a process of its own -> its summary pickled to `out`."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")  # as tests/conftest.py sets it
    torch.set_num_threads(1)
    recording(setattr)
    summary = summarize(name)
    with open(out, "wb") as f:
        pickle.dump(summary, f)


IN_PROCESS = "init_from_fame_bi"  # the longest case runs in the test's process meanwhile


@pytest.fixture(scope="module")
def runs(one_torch_thread, tmp_path_factory):  # noqa: F811
    work = tmp_path_factory.mktemp("loop_parity")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_COORDINATOR")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen([sys.executable, "-m", "tests.test_torch_loop_parity", "worker", name,
                                     str(work / f"{name}.pkl")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in CASES if name != IN_PROCESS}
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            recording(mp.setattr)
            try:
                out[IN_PROCESS] = summarize(IN_PROCESS)
            except Exception:  # noqa: BLE001 (the case's test reports it; the others go on)
                out[IN_PROCESS] = {"error": traceback.format_exc()}
        for name, p in procs.items():
            log, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                out[name] = {"error": f"worker exited with {p.returncode}:\n{log[-6000:]}"}
                continue
            with open(work / f"{name}.pkl", "rb") as f:
                out[name] = pickle.load(f)
        yield out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# --- the checks -------------------------------------------------------------------

def aurocs(y, logits):
    """AUROC of each logit column and of the contrast l1 - l0."""
    return {"l0": auroc(y, logits[:, 0]), "l1": auroc(y, logits[:, 1]), "l1-l0": auroc(y, logits[:, 1] - logits[:, 0])}


def separated(scores, tol):
    s = np.sort(np.asarray(scores, np.float64))
    return len(s) < 2 or float(np.diff(s).min()) > tol


def assert_leaves(errors, what, limit=STATE_RTOL):
    worst = max(errors, key=errors.get)
    assert errors[worst] <= limit, f"{what}: {worst} off by {errors[worst]:.3e} in relative norm"


def assert_rle(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.linalg.norm(got - ref) <= STATE_RTOL * np.linalg.norm(ref), (what, got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_loop_matches_jax_epoch_by_epoch(runs, case):
    run = runs[case]
    if "error" in run:
        pytest.fail(run["error"], pytrace=False)
    j, t, y = run["jax"], run["port"], run["y"]

    # the loop's decisions: epochs run, best epoch, early stop, LR scale
    jh, th = j["history"], t["history"]
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh]
    assert [r["lr_scale"] for r in th] == [r["lr_scale"] for r in jh]
    best = lambda h: int(np.argmax([r["val_auroc"] for r in h]))  # noqa: E731
    assert best(th) == best(jh)
    assert len(t["loss"]) == len(j["loss"]) == STEPS * len(jh)

    # train loss, epoch by epoch
    np.testing.assert_allclose([r["train_loss"] for r in th], [r["train_loss"] for r in jh], rtol=LOSS_RTOL)

    # val logits of every evaluation (each epoch's, then the calibration pass)
    jev, tev = j["evaluations"], t["evaluations"]
    assert len(tev) == len(jev) == len(jh) + 1
    for e, (g, r) in enumerate(zip(tev, jev)):
        tol = LOGIT_TOL * float(np.abs(r).max())
        assert float(np.abs(g - r).max()) <= tol, (e, float(np.abs(g - r).max()), tol)
        ja, ta = aurocs(y, r), aurocs(y, g)
        for key, scores in (("l0", r[:, 0]), ("l1", r[:, 1]), ("l1-l0", r[:, 1] - r[:, 0])):
            if separated(scores, tol):
                assert ta[key] == ja[key], (e, key, ta[key], ja[key])
        if e < len(jh) and separated(r[:, 1] - r[:, 0], tol):  # the loop's own monitor reads the contrast
            assert th[e]["val_auroc"] == jh[e]["val_auroc"] == ja["l1-l0"], e

    # each epoch's end, before the sync: weights, moments, step and count, route-loss EMA
    assert len(run["boundary"]) == run["n_jax_boundary"] == len(jh) - 1
    for e, held in enumerate(run["boundary"]):
        assert_leaves(held["params"], f"weights after epoch {e}")
        assert_leaves(held["mu"], f"Adam mu after epoch {e}", MOMENT_RTOL)
        assert_leaves(held["nu"], f"Adam nu after epoch {e}", MOMENT_RTOL)
        assert held["step"][0] == held["step"][1] == STEPS * (e + 1)
        assert held["count"][0] == held["count"][1] == STEPS * (e + 1)
        if held["rle"] is not None:
            assert_rle(*held["rle"], f"route-loss EMA after epoch {e}")

    # the run's end
    assert_leaves(run["final_weights"], "final weights")
    got, ref = run["rle"]
    assert (got is None) == (ref is None) == (CASES[case][3].get("model.smro_gate_mode") != "loss_based")
    if got is not None:
        assert_rle(got, ref, "final route-loss EMA")
    if separated(jev[-1][:, 1] - jev[-1][:, 0], LOGIT_TOL * float(np.abs(jev[-1]).max())):
        assert t["best_metric"] == j["best_metric"]
        np.testing.assert_array_equal(t["thresholds"], j["thresholds"])
    np.testing.assert_allclose(t["temperature"], j["temperature"], rtol=TEMPERATURE_RTOL)

    if run["hand_off"] is not None:
        assert_hand_off(run["hand_off"])


def assert_hand_off(kept):
    """``--init-from`` of the JAX bi checkpoint: both packages take its
    weights bit for bit and keep a fresh optimizer (zero moments, step and
    count 0) and a zero route-loss EMA (a learned gate's checkpoint carries
    none); the learned gate's weights, which the loss-based model lacks, are
    left out by both."""
    assert kept["bi_epochs"] == BI_EPOCHS
    assert kept["port_keys_equal_jax"] and not kept["port_weights_unequal"], kept["port_weights_unequal"]
    assert not kept["jax_weights_not_bi"], kept["jax_weights_not_bi"]
    assert kept["left_out"] and all(k.startswith("mm_routing.") for k in kept["left_out"]), kept["left_out"]
    assert kept["step"] == (0, 0) and kept["count"] == (0, 0)
    assert kept["moments_max"] == (0.0, 0.0)
    assert not np.any(kept["rle"][0]) and not np.any(kept["rle"][1])


# --- the reports: python -m tests.test_torch_loop_parity sync|free [CASE ...] | steps CASE

def report(sync: bool, names) -> None:
    """Per case and epoch: the loop's monitor and the AUROC of each logit
    column and of the contrast in both packages, and how far the port's val
    logits lie from JAX's (relative to max|logit|); free-running
    (``sync=False``) or epoch-synchronised as the test runs."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")  # as tests/conftest.py sets it
    torch.set_num_threads(1)
    recording(setattr)
    print(f"mode: {'epoch-synchronised' if sync else 'free-running'}")
    for name in names or list(CASES):
        run = summarize(name, sync=sync)
        j, t = run["jax"], run["port"]
        for e, (r, g) in enumerate(zip(j["evaluations"], t["evaluations"])):
            if e >= len(j["history"]):
                break
            ja, ta = aurocs(run["y"], r), aurocs(run["y"], g)
            cols = " ".join(f"{k} {ja[k]:.4f}/{ta[k]:.4f}" for k in ja)
            print(f"{name} epoch {e}: loss {j['history'][e]['train_loss']:.6f}/{t['history'][e]['train_loss']:.6f} "
                  f"monitor {j['history'][e]['val_auroc']:.4f}/{t['history'][e]['val_auroc']:.4f} {cols} "
                  f"(JAX/port) logits {float(np.abs(g - r).max() / np.abs(r).max()):.2e} x max|logit|")
        worst = max(run["final_weights"], key=run["final_weights"].get)
        loss = max(abs(a["train_loss"] - b["train_loss"]) / abs(a["train_loss"])
                   for a, b in zip(j["history"], t["history"]))
        ends = {k: max((max(h[k].values()) for h in run["boundary"]), default=0.0) for k in ("params", "mu", "nu")}
        print(f"{name}: best {j['best_metric']:.4f}/{t['best_metric']:.4f} train loss within {loss:.2e} relative, "
              f"worst final leaf {worst} {run['final_weights'][worst]:.2e}, at the epochs' ends (synchronised runs) "
              f"weights {ends['params']:.2e} mu {ends['mu']:.2e} nu {ends['nu']:.2e}")


def report_steps(name: str) -> None:
    """Step by step, one case free-running: the port's worst leaf against
    JAX's after each step; and one port step from the JAX loop's state
    before each step against JAX's after it (weights, moments and count
    loaded through the bridge), with the leaf whose update parts most (of
    those whose gradient is not zero up to rounding, ``NOISE_ONLY``), the
    share of its elements whose update takes the other sign, and their
    largest gradient over the leaf's rms gradient."""
    import multimodalrouting_tpu_torch.train.steps as tsteps
    from multimodalrouting_tpu_torch.bridge import train_state_from_jax
    from tests.torch_parity import torch_batch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")  # as tests/conftest.py sets it
    torch.set_num_threads(1)
    model_family, family, stage, extra = CASES[name]
    assert name != "init_from_fame_bi", "a case that starts from seeded weights"
    jcfg, tcfg = cfgs(**extra)
    train, val = cohorts()
    model = jax_model(jcfg, model_family)
    variables = jax_variables(model, train)
    steps = []
    make = jloop.make_train_step

    def jax_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(state, batch, rng, lr_head, lr_enc, **kw):
            pre = _jax_state(state)
            state, metrics = step(state, batch, rng, lr_head, lr_enc, **kw)
            steps.append((pre, to_numpy(state.params), batch, float(lr_head), float(lr_enc)))
            return state, metrics

        return recorded

    jloop.make_train_step = jax_make
    jloop.train_model(jcfg, model, train, val, family=family, stage=stage,
                      init_state=jax_start(jcfg, model, train, family, stage), log_fn=lambda s: None)
    jloop.make_train_step = make

    free = []
    tmake = tloop.make_train_step

    def port_make(*args, **kwargs):
        step = tmake(*args, **kwargs)

        def recorded(state, *a, **kw):
            metrics = step(state, *a, **kw)
            free.append({k: v.clone() for k, v in state.model.state_dict().items()})
            return metrics

        return recorded

    tloop.make_train_step = port_make
    tmodel = load_jax_variables(build_model(tcfg, model_family, device="cpu", train=True), variables)
    tloop.train_model(tcfg, tmodel, train, val, family=family, stage=stage,
                      state=create_train_state(tcfg, tmodel, stage=stage,
                                               n_route_loss_ema=n_route_loss_ema_for(tcfg, family)),
                      log_fn=lambda s: None)
    tloop.make_train_step = tmake

    grads = {}
    apply = tsteps.apply_gradients

    def keep_grads(state, g, **kw):
        grads.update({n: v.detach().clone() for n, v in g.items()})
        return apply(state, g, **kw)

    tsteps.apply_gradients = keep_grads
    one = build_model(tcfg, model_family, device="cpu", train=True)
    for k, (pre, post, batch, lr_head, lr_enc) in enumerate(steps):
        state = train_state_from_jax(tcfg, one, pre, stage=stage)
        tsteps.make_train_step(tcfg, one, family, **({"stage": stage} if stage else {}))(
            state, torch_batch(batch), None, lr_head, lr_enc)
        before = state_dict_from_jax({"params": pre["params"]}, one)
        after = state_dict_from_jax({"params": post}, one)
        got = one.state_dict()
        errors = relative_errors(got, after)
        worst = max(errors, key=errors.get)
        total = float(torch.sqrt(sum(v.double().pow(2).sum() for v in grads.values())))
        noise = sorted(n for n, v in grads.items() if float(v.double().norm()) <= NOISE_ONLY * total)
        upd = {n: float((got[n] - after[n]).norm() / (after[n] - before[n]).norm().clamp_min(1e-30))
               for n in grads if n not in noise and (after[n] - before[n]).norm() > 0}
        moved = max(upd, key=upd.get)
        flip = ((got[moved] - before[moved]) * (after[moved] - before[moved])) < 0
        g = grads[moved].abs()
        rms = float(g.pow(2).mean().sqrt())
        fe = relative_errors(free[k], after)
        fworst = max(fe, key=fe.get)
        print(f"step {k} lr {lr_head:.1e}/{lr_enc:.1e}: one step {worst} {errors[worst]:.2e}; update parts most at "
              f"{moved} {upd[moved]:.2e}, {float(flip.float().mean()):.2e} of it flips"
              + (f" (|g| <= {float(g[flip].max()) / rms:.2e} x rms)" if bool(flip.any()) else "")
              + f" | free-running {fworst} {fe[fworst]:.2e} | gradient zero up to rounding: {', '.join(noise)}")
    tsteps.apply_gradients = apply


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "steps":
        report_steps(sys.argv[2])
    else:
        report(sync=sys.argv[1] != "free", names=sys.argv[2:])
