"""The port's model families against the JAX package's on the CPU, at the
tiny widths of tests/helpers.py (fp32, GroupNorm, dropouts 0):

- forwards: the gated-concat model at each gate mode and stage, FAME++
  with the learned gate at each sMRO stage and with the loss-based gate,
  the 7-route capsule model at M = 2 and M = 25, LateFusion and TriMF;
  every output the family gives, at 2e-4 / 2e-5;
- trainable sets: at each curriculum stage the parameters the port's
  ``leaf_trainable`` trains are those JAX's ``trainable_mask_for_stage``
  marks, mapped by name;
- train steps against JAX ``make_train_step``: gated step2 (learned gates),
  gated step3 (loss-based gates), FAME++ loss-based at bi (frozen head
  slices under weight decay, the route-loss EMA) and at tri (mortality, two
  logits), FAME++ learned at tri, TriMF (the baselines' fame loss with the
  fairness term) and LateFusion (the fame loss, mortality): per leaf
  within 5e-4 in relative norm, as tests/test_torch_train.py holds the
  capsule family;
- the JAX package's own tests of the same behaviour, on the port
  (tests/test_smro_loss_based.py, tests/test_fame_eval_stage.py).

JAX weights come from ``jax.eval_shape`` of the model's init filled with
seeded fan-in-scaled values, not from an init run (the same weights, at a
fraction of the CPU time); the JAX forwards and steps are compiled without
LLVM's expensive passes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models.baselines import build_baseline as jbuild_baseline
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.routes import get_routes as jget_routes
from multimodalrouting_tpu.routes import route_mask_from_presence as jroute_mask
from multimodalrouting_tpu.train.state import trainable_mask_for_stage
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import _param_key, load_jax_variables
from multimodalrouting_tpu_torch.ckpt import restore_train_state, save_checkpoint
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.routing.smro import loss_based_route_weights
from multimodalrouting_tpu_torch.train.state import (
    create_train_state,
    leaf_trainable,
    n_route_loss_ema_for,
    train_state_dict,
)
from multimodalrouting_tpu_torch.train.steps import make_eval_step, make_train_step
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_close,
    assert_step,
    jax_forwards,
    one_torch_thread,
    seeded_variables,
    to_numpy,
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILY = {**TINY, "model.fusion_dropout": 0.0, "model.smro_dropout": 0.0, "encoder.text_max_len": 16,
          "encoder.image_size": 32}


def cfgs(**extra):
    over = {**FAMILY, **extra}
    return jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)


def jax_model(cfg, family):
    return jbuild_baseline(cfg, family) if family in ("late_fusion", "trimf") else jbuild_model(cfg, family)


@functools.lru_cache(maxsize=None)
def _model_case(family: str, **model_extra):
    """(JAX model, numpy variables, the batch) of a model config."""
    task = model_extra.get("model.task", "mort")
    jcfg, _ = cfgs(**model_extra)
    batch = tiny_batch(n=6, seed=1, task=task, missing_rate=0.3)
    model = jax_model(jcfg, family)
    return model, seeded_variables(model, jax.tree_util.tree_map(jnp.asarray, batch), 1), batch


def case(family: str, **extra):
    """(JAX cfg, port cfg, JAX model, numpy variables, the batch) of one
    family at one config; the model and its weights are shared by every
    case of the same model config (train.* keys aside)."""
    model_extra = {k: v for k, v in sorted(extra.items()) if not k.startswith("train.")}
    model, variables, batch = _model_case(family, **model_extra)
    return (*cfgs(**extra), model, variables, batch)


def port_model(tcfg, family, variables, train=False):
    return load_jax_variables(build_model(tcfg, family, device="cpu", train=train), variables)


def assert_outputs(got, ref, names):
    for name in names:
        r = getattr(ref, name)
        if r is None:
            assert getattr(got, name) is None, name
        else:
            assert_close(getattr(got, name), r, err_msg=name)


ROUTED = ("logits", "gates", "block_w", "route_logits", "chexpert_logits")


# --- forwards -------------------------------------------------------------------

def test_gated_concat_forward_at_each_gate_mode_and_stage():
    """One set of weights (the learned gate's config holds the gate net);
    the gate mode and stage are the forward's arguments in both packages."""
    jcfg, tcfg, model, variables, batch = case("gated_concat")
    tmodel = port_model(tcfg, "gated_concat", variables)
    calls = [dict(gate_mode=g, stage=s) for g in ("learned", "uniform", "loss_based")
             for s in (("", "step1", "step2", "step3") if g == "learned" else ("",))]
    tb = torch_batch(batch)
    for kw, ref in zip(calls, jax_forwards(model, variables, batch, calls)):
        with torch.no_grad():
            got = tmodel(tb, **kw)
        assert_outputs(got, ref, ROUTED)
    assert tuple(got.gates.shape) == (6, 7) and tuple(got.route_logits.shape) == (6, 7, 2)


@pytest.mark.parametrize("gate", ["learned", "loss_based"])
def test_fame_forward(gate):
    """Learned: MMRouting at stage None, uni, bi and tri. Loss-based: the
    EMA gate at a zero EMA (the default) and at a trained one."""
    jcfg, tcfg, model, variables, batch = case("fame", **{"model.smro_gate_mode": gate})
    tmodel = port_model(tcfg, "fame", variables)
    tb = torch_batch(batch)
    if gate == "learned":
        calls = [dict(stage=s) for s in (None, "uni", "bi", "tri")]
    else:
        ema = np.abs(np.random.default_rng(3).normal(size=7)).astype(np.float32)
        calls = [{}, dict(route_losses_ema=ema)]
    refs = jax_forwards(model, variables, batch,
                        [{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
                         for kw in calls])
    for kw, ref in zip(calls, refs):
        with torch.no_grad():
            got = tmodel(tb, **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
        assert_outputs(got, ref, ROUTED)


@pytest.mark.parametrize("head", ["mortality", "phenotype"])
def test_seven_route_capsule_forward(head):
    """configs/trimodal_mort.yaml's head with model.routes=7 (M = 2), and
    configs/pheno_25.yaml's with routes=7, bi_fusion_mode=linear (M = 25)."""
    extra = {"model.routes": "7"}
    if head == "phenotype":
        extra.update({"model.task": "pheno", "model.num_classes": 25, "model.bi_fusion_mode": "linear"})
    jcfg, tcfg, model, variables, batch = case("capsule", **extra)
    tmodel = port_model(tcfg, "capsule", variables)
    rm = jroute_mask(*(jnp.asarray(h) for h in (batch.has_l, batch.has_n, batch.has_i)), jget_routes("7"))
    ref, = jax_forwards(model, variables, batch, [dict(route_mask=rm)])
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    assert tuple(got.r_matrix.shape) == (6, 7, 2 if head == "mortality" else 25)
    assert_outputs(got, ref, ("logits", "alpha", "r_matrix", "chexpert_logits"))
    assert sorted(got.route_embs) == sorted(ref.route_embs)


@pytest.mark.parametrize("family", ["late_fusion", "trimf"])
def test_baseline_forward(family):
    jcfg, tcfg, model, variables, batch = case(family)
    tmodel = port_model(tcfg, family, variables)
    ref, = jax_forwards(model, variables, batch, [{}])
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    assert_outputs(got, ref, ("logits", "gates", "chexpert_logits"))
    assert got.alpha is None and got.r_matrix is None


# --- trainable sets ---------------------------------------------------------------

@pytest.mark.parametrize("finetune", [False, True], ids=["frozen-text", "finetuned-text"])
@pytest.mark.parametrize("family, stage", [
    ("gated_concat", "step1"), ("gated_concat", "step2"), ("gated_concat", "step3"), ("gated_concat", ""),
    ("fame", "uni"), ("fame", "bi"), ("fame", "tri"), ("capsule", "step1"), ("capsule", "step2"),
])
def test_trainable_set_matches_jax(family, stage, finetune):
    """JAX trainable_mask_for_stage over the param tree, mapped to the port's
    state_dict keys, against the port's leaf_trainable and the train
    state's trainable names."""
    jcfg, tcfg, model, variables, _ = case(family)
    mask = to_numpy(trainable_mask_for_stage(variables["params"], stage, finetune_text=finetune))
    target = dict(build_model(tcfg, family, device="cpu").named_parameters())
    want = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(mask):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        key, _ = _param_key(keys, np.zeros((1, 1)), target)  # the name alone decides the key
        if float(leaf) == 1.0:
            want.add(key)
    got = {n for n in target if leaf_trainable(n, finetune, stage)}
    assert got == want
    tcfg_ft = tc.apply_overrides(tcfg, {"encoder.finetune_text": finetune})
    state = create_train_state(tcfg_ft, build_model(tcfg_ft, family, device="cpu"), stage=stage)
    assert set(state.names) == want
    if family == "gated_concat" and stage == "step3":
        assert want and all(k.split(".")[0] in ("final_head", "gate_net") or ".LNI." in k for k in want)


# --- train steps ------------------------------------------------------------------

def test_gated_step2_matches_jax():
    jcfg, tcfg, model, variables, batch = case("gated_concat")
    init, tmodel, state, _ = assert_step(tcfg, "gated_concat", "gated_concat", (jcfg, model, variables), batch,
                                         stage="step2")
    frozen = [n for n, _ in tmodel.named_parameters() if n not in state.names]
    assert any(n.startswith("encoders.") for n in frozen) and any(n.startswith("final_head.") for n in frozen)


def test_gated_step3_loss_based_matches_jax():
    jcfg, tcfg, model, variables, batch = case("gated_concat", **{"model.gate_mode": "loss_based",
                                                                      "train.fairness_gamma": 0.2})
    assert_step(tcfg, "gated_concat", "gated_concat", (jcfg, model, variables), batch, stage="step3")


def test_fame_loss_based_bi_step_matches_jax():
    """The route heads outside the bi block stay bit-identical under weight
    decay (masked on the gradients and the updates), the EMA moves."""
    jcfg, tcfg, model, variables, batch = case(
        "fame", **{"model.smro_gate_mode": "loss_based", "model.task": "multitask", "model.num_classes": 3,
                   "train.fairness_gamma": 0.1, "train.weight_decay": 0.05})
    ema = np.abs(np.random.default_rng(4).normal(size=7)).astype(np.float32)
    init, tmodel, state, jstate = assert_step(tcfg, "fame", "fame", (jcfg, model, variables), batch, stage="bi",
                                              ema=ema)
    assert_close(state.route_loss_ema, jstate.route_loss_ema)
    assert not np.allclose(state.route_loss_ema.numpy(), ema)
    heads = {n: p for n, p in tmodel.named_parameters() if n.startswith("route_heads.")}
    for name, p in heads.items():
        before = torch.from_numpy(np.asarray(init["params"]["route_heads"][name.split(".")[-1]]))
        assert torch.equal(p.detach()[[0, 1, 2, 6]], before[[0, 1, 2, 6]]), name
        assert not torch.equal(p.detach()[3:6], before[3:6]), name


def test_fame_loss_based_tri_step_matches_jax():
    """Mortality with two logits over FAME++'s 7 routes: the six route heads
    outside the tri block stay bit-identical under weight decay, the LNI
    head and the EMA move."""
    jcfg, tcfg, model, variables, batch = case("fame", **{"model.smro_gate_mode": "loss_based",
                                                             "train.weight_decay": 0.05})
    ema = np.abs(np.random.default_rng(5).normal(size=7)).astype(np.float32)
    init, tmodel, state, jstate = assert_step(tcfg, "fame", "fame", (jcfg, model, variables), batch, stage="tri",
                                              ema=ema)
    assert tuple(state.route_loss_ema.shape) == (7,)
    assert_close(state.route_loss_ema, jstate.route_loss_ema)
    assert not np.allclose(state.route_loss_ema.numpy(), ema)
    heads = {n: p for n, p in tmodel.named_parameters() if n.startswith("route_heads.")}
    assert heads
    for name, p in heads.items():
        before = torch.from_numpy(np.asarray(init["params"]["route_heads"][name.split(".")[-1]]))
        assert torch.equal(p.detach()[:6], before[:6]), name
        assert not torch.equal(p.detach()[6], before[6]), name


def test_fame_learned_tri_step_matches_jax():
    jcfg, tcfg, model, variables, batch = case("fame", **{"train.fairness_gamma": 0.1,
                                                             "train.fairness_kind": "eq_odds"})
    assert_step(tcfg, "fame", "fame", (jcfg, model, variables), batch, stage="tri")


def test_trimf_step_matches_jax():
    """The baselines train under the fame loss family."""
    jcfg, tcfg, model, variables, batch = case("trimf", **{"train.fairness_gamma": 0.1})
    assert_step(tcfg, "fame", "trimf", (jcfg, model, variables), batch)


def test_late_fusion_step_matches_jax():
    """LateFusion trains under the fame loss; mortality gives it two logits."""
    jcfg, tcfg, model, variables, batch = case("late_fusion")
    init, tmodel, state, jstate = assert_step(tcfg, "fame", "late_fusion", (jcfg, model, variables), batch)
    assert state.route_loss_ema is None and jstate.route_loss_ema is None
    assert tcfg.model.task == "mort" and tcfg.model.num_classes == 2


# --- the JAX package's behaviour tests, on the port ---------------------------------

def _loss_based_state(n_steps=3, stage="", lr=2e-3):
    _, tcfg = cfgs(**{"model.smro_gate_mode": "loss_based", "model.num_classes": 3, "train.route_loss_ema_beta": 0.9})
    torch.manual_seed(0)
    model = build_model(tcfg, "fame", device="cpu", train=True)
    state = create_train_state(tcfg, model, stage=stage, n_route_loss_ema=n_route_loss_ema_for(tcfg, "fame"))
    step = make_train_step(tcfg, model, "fame", **({"stage": stage} if stage else {}))
    batch = torch_batch(tiny_batch(n=16, task="multitask"))
    losses = [float(step(state, batch, None, lr, lr).loss) for _ in range(n_steps)]
    return losses, state, model, tcfg, batch


def test_gate_favors_lower_loss_routes_and_blocks():
    ema = torch.tensor([0.6, 0.7, 0.05, 1.2, 1.1, 1.3, 0.9])
    rw, bw = loss_based_route_weights(ema, 5.0, jget_routes("7"))
    assert int(rw.argmax()) == 2 and int(bw.argmax()) == 0
    np.testing.assert_allclose(float(rw.sum()), 1.0, rtol=1e-6)
    block_losses = torch.stack([ema[:3].mean(), ema[3:6].mean(), ema[6]])
    assert_close(bw, torch.softmax(-5.0 * block_losses, 0))


def test_loss_based_trains_ema_moves_and_eval_uses_it():
    losses, state, model, tcfg, batch = _loss_based_state(n_steps=4)
    assert losses[-1] < losses[0], losses
    ema = state.route_loss_ema.numpy()
    assert ema.shape == (7,) and np.all(np.isfinite(ema)) and np.all((ema > 0) & (ema < 10))
    out = make_eval_step(tcfg, model, "fame", use_ema=tcfg.train.use_ema)(state, batch)
    rw, _ = loss_based_route_weights(state.route_loss_ema, tcfg.model.smro_alpha, jget_routes("7"))
    assert_close(out.gates[0], rw)
    assert_close(out.gates[1], out.gates[0])


def test_loss_based_stage_freezes_nonstage_heads_encoders_train():
    torch.manual_seed(0)
    before = {n: p.detach().clone() for n, p in build_model(
        cfgs(**{"model.smro_gate_mode": "loss_based", "model.num_classes": 3})[1], "fame",
        device="cpu").named_parameters()}
    _, state, model, _, _ = _loss_based_state(n_steps=3, stage="uni")
    for n, p in model.named_parameters():
        if n.startswith("route_heads."):
            assert torch.equal(p.detach()[3:], before[n][3:]), n
            assert not torch.equal(p.detach()[:3], before[n][:3]), n
    assert any(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()
               if n.startswith("encoders."))


def test_route_loss_ema_checkpoint_roundtrip_and_old_checkpoints(tmp_path):
    """Full and params-only restores carry the route-loss EMA; a train state
    written without it restores with zeros."""
    _, state, model, tcfg, _ = _loss_based_state(n_steps=2)
    save_checkpoint(str(tmp_path / "new"), {}, tcfg, train_state=train_state_dict(state))
    old = train_state_dict(state)
    old.pop("route_loss_ema")
    save_checkpoint(str(tmp_path / "old"), {}, tcfg, train_state=old)
    fresh = lambda: create_train_state(tcfg, build_model(tcfg, "fame", device="cpu"),  # noqa: E731
                                       n_route_loss_ema=7)
    for params_only in (False, True):
        got = restore_train_state(str(tmp_path / "new"), fresh(), params_only=params_only)
        assert torch.equal(got.route_loss_ema, state.route_loss_ema)
        assert got.step == (0 if params_only else state.step)
        assert torch.equal(restore_train_state(str(tmp_path / "old"), fresh(), params_only=params_only).route_loss_ema,
                           torch.zeros(7))


def test_stage_bi_eval_is_invariant_to_the_tri_head():
    """Mid-curriculum fame evaluation fuses only the trained blocks."""
    _, tcfg = cfgs()
    torch.manual_seed(0)
    model = build_model(tcfg, "fame", device="cpu")
    batch = torch_batch(tiny_batch(n=4, seed=3))
    with torch.no_grad():
        out_bi, out_full = model(batch, stage="bi").logits, model(batch).logits
        for name in ("w1", "b1", "w2", "b2", "ln_scale", "ln_bias"):
            getattr(model.route_heads, name)[6] += 7.0
        assert_close(model(batch, stage="bi").logits, out_bi, rtol=1e-6, atol=1e-6)
        assert not np.allclose(model(batch).logits.numpy(), out_full.numpy(), atol=1e-3)


def test_loop_passes_the_stage_to_the_eval_step(monkeypatch):
    import multimodalrouting_tpu_torch.train.loop as loop

    captured = []
    orig = loop.make_eval_step

    def spy(cfg, model, family, **kw):
        captured.append(kw)
        return orig(cfg, model, family, **kw)

    monkeypatch.setattr(loop, "make_eval_step", spy)
    _, tcfg = cfgs(**{"train.epochs": 1, "train.use_ema": False, "train.min_epochs": 0, "train.sampler_mode": "none"})
    for family, stage, want in (("fame", "bi", "bi"), ("fame", "tri", None), ("gated_concat", "step2", "step2"),
                                ("gated_concat", "step3", None)):
        model = build_model(tcfg, family, device="cpu", train=True)
        loop.train_model(tcfg, model, tiny_batch(n=8, seed=0), tiny_batch(n=4, seed=1), family=family, stage=stage,
                         log_fn=lambda s: None)
        assert captured[-1].get("stage") == want, (family, stage, captured[-1])
