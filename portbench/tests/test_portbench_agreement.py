"""The harness end to end on the CPU at tiny widths: the port against the
plain reference (``correct`` true), the faults a cell can have planted
under the timed path (``correct`` false), and the float8 control in the
program's place (failing the limits).

The tiny runs compute in float32 (the card's cells in bfloat16), so these
limits are the tiny float32 runs' own: the loss after the first step moves
with Adam's sign-like first update wherever a gradient element is near
zero, so the later steps' losses part by up to ~0.4% between two float32
programs that sum in another order.
"""
import pytest
import torch

import tiny
from portbench import control
from portbench.harness import manifest

TRAIN_LIMITS = {"loss_gap": 0.02, "grad_gap": 1e-3, "change_gap": 0.05, "later_loss_gap": 0.02}
SERVE_LIMITS = {"head_gap": 0.05, "alpha_gap": 1e-4, "calibration_gap": 1e-5, "decision_flips": 0,
                "top_route_flips": 0}
TRAIN = "pheno.train_finetune"
# the note encoder fine-tuned (the cell) and frozen (the same runner, its other branch)
FINETUNE = [True, False]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("finetune", FINETUNE, ids=["finetuned", "frozen"])
def test_train_cell_agrees_with_the_reference(finetune):
    line = tiny.run_tiny(TRAIN, limits=TRAIN_LIMITS, finetune=finetune)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_stays_per_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload,metric", [("mort.ward_requests", "request_p95_ms"),
                                             ("mort.cohort_rescore", "score_stays_per_s")])
def test_serve_cell_agrees_with_the_reference(workload, metric):
    line = tiny.run_tiny(workload, limits=SERVE_LIMITS, seconds=1.0)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", metric}


def unchanged_state(step):
    """A step that computes its loss and returns the state as it found it."""
    def faulty(state, batch, *a, **kw):
        saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        mu = {k: v.clone() for k, v in state.mu.items()}
        nu = {k: v.clone() for k, v in state.nu.items()}
        out = step(state, batch, *a, **kw)
        state.model.load_state_dict(saved)
        for k in mu:
            state.mu[k].copy_(mu[k])
            state.nu[k].copy_(nu[k])
        state.count -= 1
        return out
    return faulty


def half_batch(step):
    """A step over the first half of the batch only (the mean over the rest)."""
    from multimodalrouting_tpu_torch.data.batches import slice_batch

    def faulty(state, batch, *a, **kw):
        kw["note_pack"] = 0
        return step(state, slice_batch(batch, 0, batch.batch_size // 2), *a, **kw)
    return faulty


@pytest.mark.parametrize("finetune", FINETUNE, ids=["finetuned", "frozen"])
@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=["unchanged_state", "half_batch"])
def test_train_faults_fail(finetune, fault):
    line = tiny.run_tiny(TRAIN, limits=TRAIN_LIMITS, hooks={"step": fault}, finetune=finetune)
    assert not line["correct"], line["checks"]


def altered_answer(score):
    """One stay's probability moved by 0.05 where the rows are made."""
    def faulty(records):
        rows = score(records)
        p = rows[len(rows) // 2]["probs"]
        rows[len(rows) // 2]["probs"] = p + 0.05 if p < 0.5 else p - 0.05
        return rows
    return faulty


@pytest.mark.parametrize("workload", ["mort.ward_requests", "mort.cohort_rescore"])
def test_serve_altered_answer_fails(workload):
    """Under the cell's own limits file."""
    line = tiny.run_tiny(workload, seconds=1.0, hooks={"score": altered_answer})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", [TRAIN, "mort.ward_requests", "mort.cohort_rescore"])
def test_float8_control_fails(workload):
    """The serving cells under their own limits files."""
    limits = TRAIN_LIMITS if workload == TRAIN else None
    cell = tiny.shrink(limits=limits)(manifest.cell(manifest.benchmark(), workload))
    checks = control.control_checks(cell, 3, torch.device("cpu"))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
