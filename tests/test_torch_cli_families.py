"""The port's CLI on the other families, on the CPU at tiny widths: the
FAME++ curriculum uni -> bi -> tri (loss-based gate, configs/fame_missing.yaml)
and the gated-concat curriculum step1 -> step2 -> step3, each stage warm
started with --init-from; eval (with the drop table) and predict on a
non-capsule family; LateFusion and TriMF; the 7-route capsule head; a
FAME++ serving artifact; and the options that still raise."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch.ckpt import load_config, load_meta
from multimodalrouting_tpu_torch.serve import Predictor, batch_from_records
from multimodalrouting_tpu_torch.train.state import leaf_trainable
from tests.test_torch_cli import TINY_SETS, run
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAME_YAML = os.path.join(ROOT, "configs", "fame_missing.yaml")
SETS = {**TINY_SETS, "data.synthetic_n": 16, "train.batch_size": 8, "train.ckpt_every": 0}  # final checkpoints only


def _sets(**extra):
    out = []
    for k, v in {**SETS, **extra}.items():
        out += ["--set", f"{k}={v}"]
    return out


def train(family, out, *extra, sets=None):
    rc, text = run(tcli.main, ["train", "--family", family, "--device", "cpu", "--out", out, "--epochs", "1", *extra,
                               *_sets(**(sets or {}))])
    assert rc == 0
    return json.loads(text.strip().splitlines()[-1])


def state_of(path):
    return torch.load(os.path.join(path, "train_state.pt"), map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def fame_chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("fame")
    outs, prev = {}, None
    for stage in ("uni", "bi", "tri"):
        out = str(root / stage)
        summary = train("fame", out, "--stage", stage, "--config", FAME_YAML,
                        *(["--init-from", prev] if prev else []), sets={"model.smro_gate_mode": "loss_based"})
        assert summary["stage"] == stage and summary["family"] == "fame" and summary["epochs_ran"] == 1
        outs[stage], prev = out, out
    return outs


@pytest.fixture(scope="module")
def gated_chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("gated")
    outs, prev = {}, None
    for stage in ("step1", "step2", "step3"):
        out = str(root / stage)
        summary = train("gated_concat", out, "--stage", stage, "--task", "mort",
                        *(["--init-from", prev] if prev else []))
        assert summary["stage"] == stage and np.isfinite(summary["best_val_auroc"])
        outs[stage], prev = out, out
    return outs


def test_fame_chain_carries_weights_and_the_route_loss_ema(fame_chain):
    """Each stage starts from the last one's final weights and route-loss
    EMA (a fresh optimizer); its route heads outside the stage's block do
    not move; the EMA moves on."""
    cfg = load_config(os.path.join(fame_chain["tri"], "final"))
    assert cfg.model.task == "multitask" and cfg.model.num_classes == 3 and cfg.train.route_dropout_p == 0.25
    keep = {"bi": [3, 4, 5], "tri": [6]}
    for prev, stage in (("uni", "bi"), ("bi", "tri")):
        before, after = state_of(os.path.join(fame_chain[prev], "final")), state_of(
            os.path.join(fame_chain[stage], "final"))
        assert after["step"] == 2 and after["count"] == 2  # 16 stays, batch 8: a fresh count of 2 steps
        frozen = [i for i in range(7) if i not in keep[stage]]
        for name in ("w1", "b1", "w2", "b2", "ln_scale", "ln_bias"):
            a, b = before["model"][f"route_heads.{name}"], after["model"][f"route_heads.{name}"]
            assert torch.equal(a[frozen], b[frozen]), (stage, name)
            assert not torch.equal(a[keep[stage]], b[keep[stage]]), (stage, name)
        assert before["route_loss_ema"].shape == (7,)
        assert not torch.equal(before["route_loss_ema"], after["route_loss_ema"])
        meta = load_meta(os.path.join(fame_chain[stage], "final"))
        np.testing.assert_allclose(meta["route_loss_ema"], after["route_loss_ema"].numpy(), rtol=1e-6)


def test_fame_eval_drop_table_and_predict(fame_chain, tmp_path):
    ckpt = fame_chain["tri"]
    rc, text = run(tcli.main, ["eval", "--ckpt", ckpt, "--family", "fame", "--drop-table", "--device", "cpu",
                               "--out", str(tmp_path)])
    assert rc == 0
    lines = text.splitlines()
    metrics = json.loads("\n".join(lines[lines.index("{"): lines.index("}") + 1]))
    assert np.isfinite(metrics["auroc_macro"])
    rows = [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")]
    assert rows == ["full", "dropL", "dropN", "dropI", "rand1"]
    assert not os.path.exists(os.path.join(str(tmp_path), "test_route_audit.json"))  # no alpha / r_matrix
    rc, text = run(tcli.main, ["predict", "--ckpt", ckpt, "--family", "fame", "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(ckpt, "predictions_test.jsonl")) as f:
        preds = [json.loads(line) for line in f]
    assert len(preds) == 16 and all(len(p["probs"]) == 3 and "top_routes" not in p for p in preds)


def test_predictor_serves_the_trained_route_loss_ema(fame_chain):
    """Predictor's forward takes the EMA the checkpoint's meta carries: its
    gates are the loss-based route weights of that EMA."""
    from multimodalrouting_tpu_torch.routing.smro import loss_based_route_weights

    pred = Predictor(os.path.join(fame_chain["tri"], "final"), "fame", device="cpu")
    meta = load_meta(os.path.join(fame_chain["tri"], "final"))
    assert pred.route_loss_ema.tolist() == pytest.approx(meta["route_loss_ema"])
    out = pred.forward(batch_from_records(pred.cfg, [{}, {}]))
    rw, _ = loss_based_route_weights(pred.route_loss_ema, pred.cfg.model.smro_alpha, pred.routes)
    torch.testing.assert_close(out.gates[0], rw)
    rows = pred.predict_records([{}])
    assert set(rows[0]) == {"probs", "pred", "temperature"} and pred.routes == ["L", "N", "I", "LN", "LI", "NI", "LNI"]


def test_gated_chain_freezes_what_each_stage_freezes(gated_chain):
    """step2 trains the fusions and route heads only, step3 the final head,
    the gate net and the LNI fusion only: every other parameter is
    bit-identical to the stage before (BatchNorm's running statistics move
    in every stage, as in the JAX package)."""
    for prev, stage in (("step1", "step2"), ("step2", "step3")):
        before, after = (state_of(os.path.join(gated_chain[s], "final"))["model"] for s in (prev, stage))
        moved = {k for k in after if not torch.equal(before[k], after[k]) and "running_" not in k}
        trainable = {k for k in after if leaf_trainable(k, False, stage)}
        assert moved and moved <= trainable, (stage, sorted(moved - trainable)[:5])
    rc, _ = run(tcli.main, ["eval", "--ckpt", gated_chain["step3"], "--family", "gated_concat", "--device", "cpu"])
    assert rc == 0


@pytest.mark.parametrize("family", ["late_fusion", "trimf"])
def test_baselines_train_eval_and_predict(family, tmp_path):
    out = str(tmp_path / family)
    summary = train(family, out, "--task", "mort")
    assert summary["family"] == family and np.isfinite(summary["best_val_auroc"])
    rc, text = run(tcli.main, ["eval", "--ckpt", out, "--family", family, "--drop-table", "--device", "cpu"])
    assert rc == 0 and "rand1" in text
    rc, _ = run(tcli.main, ["predict", "--ckpt", out, "--family", family, "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(out, "predictions_test.jsonl")) as f:
        assert len(f.readlines()) == 16


def test_seven_route_capsule_train_and_eval(tmp_path):
    """--routes 7 with the linear fusions on the phenotype task: the route
    audit has the 7 routes."""
    out = str(tmp_path / "c7")
    summary = train("capsule", out, "--task", "pheno", "--routes", "7", sets={"model.bi_fusion_mode": "linear"})
    assert summary["epochs_ran"] == 1
    assert load_config(os.path.join(out, "final")).model.routes == "7"
    rc, _ = run(tcli.main, ["eval", "--ckpt", out, "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(out, "test_route_audit.json")) as f:
        audit = json.load(f)
    assert "LNI" in json.dumps(audit) and "NL" not in json.dumps(audit)


def test_per_route_mult_train_eval_predict(tmp_path):
    """configs/pheno_atten_mult.yaml (the per-route MulT family, 25
    phenotypes, the sigmoid gate): train, eval with the drop table, predict
    with the 10-route audit."""
    out = str(tmp_path / "atten")
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "pheno_atten_mult.yaml")
    summary = train("capsule", out, "--task", "pheno", "--routes", "10", "--config", yaml)
    assert summary["epochs_ran"] == 1 and load_config(os.path.join(out, "final")).model.bi_fusion_mode == "mult"
    rc, text = run(tcli.main, ["eval", "--ckpt", out, "--drop-table", "--device", "cpu"])
    assert rc == 0 and "dropN" in text
    rc, _ = run(tcli.main, ["predict", "--ckpt", out, "--device", "cpu"])
    with open(os.path.join(out, "predictions_test.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rc == 0 and len(rows[0]["probs"]) == 25 and len(rows[0]["top_routes"]) == 3
    shutil.rmtree(out)  # ~0.2 GB of train state: keep the suite's disk small


def test_formerly_unported_fame_artifact_serves(fame_chain, tmp_path):
    """`predict --artifact --family fame` (ROADMAP.md §1 item 11) runs: the
    loss-based FAME++ checkpoint exported with its route-loss EMA serves the
    test split as the checkpoint does (the JAX artifact test's tolerance)."""
    art, probs = str(tmp_path / "art"), {}
    rc, _ = run(tcli.main, ["predict", "--ckpt", fame_chain["tri"], "--family", "fame", "--export-artifact", art,
                            "--device", "cpu"])
    assert rc == 0
    for flag, src in (("--artifact", art), ("--ckpt", fame_chain["tri"])):
        out = str(tmp_path / f"{flag[2:]}.jsonl")
        rc, _ = run(tcli.main, ["predict", flag, src, "--family", "fame", "--out", out, "--device", "cpu"])
        with open(out) as f:
            probs[flag] = [json.loads(line)["probs"] for line in f]
        assert rc == 0 and len(probs[flag]) == SETS["data.synthetic_n"]
    np.testing.assert_allclose(probs["--artifact"], probs["--ckpt"], rtol=1e-5, atol=1e-6)
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f)["family"] == "fame"


@pytest.mark.parametrize("argv, item", [
    (["train", "--family", "fame", "--stage", "tri", "--mesh", "data=2"], "item 12"),
    (["train", "--family", "gated_concat", "--stage", "step1", "--set", "train.ckpt_backend=orbax_async"],
     "item 13"),
])
def test_what_is_not_ported_still_raises(argv, item, tmp_path):
    if argv[0] == "train":
        argv = [*argv, "--device", "cpu", "--out", str(tmp_path), *_sets()]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        tcli.main(argv)
