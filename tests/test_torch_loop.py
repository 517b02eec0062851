"""The port's ``train_model`` on the CPU: the sample order, chunk bucketing
and pack capacities of the JAX package's loop from the same seed, two
epochs of training with a history, checkpoints that the serving
``Predictor`` loads and serves, and a streaming split (``StreamingSplit``)
under each sampler mode with the JAX loop's refusals."""
import os
import shutil

import numpy as np
import pytest

from multimodalrouting_tpu.train import loop as jloop
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.ckpt import load_meta
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel.mesh import get_active_mesh
from multimodalrouting_tpu_torch.serve import Predictor
from multimodalrouting_tpu_torch.train import loop as tloop
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import one_torch_thread, train_cohorts  # noqa: F401 (one_torch_thread: a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOOP = {**TINY, "encoder.vision_norm": "batch", "encoder.text_max_len": 16, "encoder.image_size": 32,
        "train.epochs": 2, "train.min_epochs": 0, "train.encoder_warmup_epochs": 1, "train.log_every": 2}


@pytest.mark.parametrize("mode", ["sqrt", "none", "pos_weight", "hybrid"])
def test_sample_order_bucketing_and_pack_capacity_match_jax(mode):
    y = (np.random.default_rng(0).random(37) > 0.7).astype(np.float32)
    chunk_mask = (np.random.default_rng(1).random((37, 6)) > 0.4).astype(np.float32)
    r_j, r_t = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):  # successive epochs draw from one generator
        oj, ot = jloop.weighted_sample_order(y, r_j, mode), tloop.weighted_sample_order(y, r_t, mode)
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_array_equal(tloop.chunk_bucketed_order(ot, chunk_mask, 4, r_t),
                                      jloop.chunk_bucketed_order(oj, chunk_mask, 4, r_j))
    cfg = tc.apply_overrides(tc.Config(), LOOP)
    for b in train_cohorts(4, seed=50):
        assert tloop.note_pack_bucket(cfg, Batch(*b)) == jloop.note_pack_bucket(cfg, b)


def test_train_model_two_epochs_writes_servable_checkpoints(tmp_path, monkeypatch):
    cfg = tc.apply_overrides(tc.Config(), LOOP)
    train, val = tiny_batch(n=12, seed=1), tiny_batch(n=8, seed=2)
    drawn = []
    real = tloop.weighted_sample_order
    monkeypatch.setattr(tloop, "weighted_sample_order", lambda *a, **k: drawn.append(real(*a, **k)) or drawn[-1])
    logs = []
    model = build_model(cfg, device="cpu", train=True)
    result = tloop.train_model(cfg, model, train, val, log_fn=logs.append, ckpt_dir=str(tmp_path))
    # the epochs' sample orders are the JAX package's from train.seed
    rng = np.random.default_rng(cfg.train.seed)
    assert len(drawn) == 2
    for order in drawn:
        np.testing.assert_array_equal(order, jloop.weighted_sample_order(train.y, rng, cfg.train.sampler_mode))
    assert [row["epoch"] for row in result.history] == [0, 1]
    assert all(np.isfinite(row["train_loss"]) and row["skipped_steps"] == 0 for row in result.history)
    assert result.state.step == 2 * (12 // cfg.train.batch_size)
    assert any(line.startswith("[epoch 000 step 2/3]") for line in logs)
    for name in ("best", "last", "final"):
        assert os.path.exists(tmp_path / name / "weights.pt"), name
    meta = load_meta(str(tmp_path / "final"))
    assert meta["temperature"] == pytest.approx(result.temperature)
    np.testing.assert_allclose(meta["thresholds"], result.thresholds)
    pred = Predictor(str(tmp_path / "final"), device="cpu")
    assert pred.temperature == pytest.approx(result.temperature)
    recs = [{"x_struct": val.x_struct[i], "m_struct": val.m_struct[i], "note_ids": val.note_ids[i],
             "note_attn": val.note_attn[i], "chunk_mask": val.chunk_mask[i], "image": val.image[i]} for i in range(2)]
    rows = pred.predict_records(recs)
    assert len(rows) == 2 and all(0.0 <= row["probs"] <= 1.0 and len(row["top_routes"]) == 3 for row in rows)


def test_train_model_runs_the_text_cache():
    """encoder.text_embedding_cache: the BERT body runs once per split, the
    steps from the cache (tests/test_torch_text_cache.py holds it against
    the JAX package)."""
    cfg = tc.apply_overrides(tc.Config(), {**LOOP, "encoder.text_embedding_cache": True, "train.epochs": 1})
    logs = []
    result = tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tiny_batch(8), tiny_batch(4),
                               log_fn=logs.append)
    assert any(line.startswith("[text-cache]") for line in logs) and np.isfinite(result.history[0]["train_loss"])


@pytest.mark.parametrize("over, ranks", [
    ({"train.num_data_shards": 2, "train.tensor_parallel": True, "train.microbatch": 2}, 2),
    ({"train.num_model_shards": 2, "train.route_parallel": True, "train.microbatch": 2}, 2),
    ({"train.num_data_shards": 2, "train.microbatch": 2}, 2),
])
def test_train_model_on_a_microbatched_mesh_asks_for_its_process_group(over, ranks):
    """Microbatching on a mesh, under tensor or route parallelism or not,
    which the port refused before it was ported, passes the checks and, in
    one process, asks for the ranks' launch before it sets a mesh
    (tests/test_torch_pp_mesh.py trains it on its ranks)."""
    cfg = tc.apply_overrides(tc.Config(), {**LOOP, **over})
    with pytest.raises(RuntimeError, match=f"needs a process group: launch {ranks} processes"):
        tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tiny_batch(4), tiny_batch(4))
    assert get_active_mesh() is None


STREAM = {**LOOP, "encoder.structured_seq_len": 4, "encoder.structured_n_feats": 2, "encoder.notes_max_chunks": 1,
          "encoder.text_max_len": 8, "train.batch_size": 8, "train.use_ema": False, "train.log_every": 0}


@pytest.fixture(scope="module")
def stream_export(tmp_path_factory):
    """tests/test_streaming_loader.py's export: 40 stays, 32 of them train."""
    from tests.test_streaming_loader import _write_export

    d = str(tmp_path_factory.mktemp("stream"))
    _write_export(d, 40, t=4, f=2, s=1, l=8)
    return d


@pytest.mark.parametrize("sampler", ["none", "pos_weight", "sqrt", "hybrid"])
def test_train_model_runs_a_streaming_split(sampler, stream_export, tmp_path):
    """A StreamingSplit is pulled epoch by epoch (the JAX loop's streaming
    branch): sqrt / hybrid switch on its resampler, the steps are the
    stream's batches, and the run checkpoints and resumes."""
    from multimodalrouting_tpu_torch.data.loader import load_split
    from multimodalrouting_tpu_torch.data.streaming import StreamingSplit

    resume = sampler == "none"  # two epochs and a resume on one sampler; one epoch on the others
    epochs = 2 if resume else 1
    cfg = tc.apply_overrides(tc.Config(), {**STREAM, "train.sampler_mode": sampler, "train.epochs": epochs})
    tr = StreamingSplit(stream_export, "train", image_size=32, shuffle_buffer=16, seed=0)
    va = load_split(stream_export, "val", image_size=32).batch
    result = tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tr, va, log_fn=lambda s: None,
                               ckpt_dir=str(tmp_path) if resume else None)
    assert [row["epoch"] for row in result.history] == list(range(epochs))
    assert all(np.isfinite(row["train_loss"]) for row in result.history)
    assert (tr._resample_fn is not None) == (sampler in ("sqrt", "hybrid"))
    if sampler in ("none", "pos_weight"):  # each epoch the whole split once: 4 batches of 8
        assert tr.stats.batches_emitted == 4 * epochs and result.state.step == 4 * epochs
    if not resume:
        return
    # a resume from the last checkpoint restarts at the epoch its step implies
    from multimodalrouting_tpu_torch.ckpt import restore_train_state
    from multimodalrouting_tpu_torch.train.state import create_train_state

    cfg3 = tc.apply_overrides(cfg, {"train.epochs": 3})
    model = build_model(cfg3, device="cpu", train=True)
    state = restore_train_state(str(tmp_path), create_train_state(cfg3, model), name="last")
    again = tloop.train_model(cfg3, model, tr, va, state=state, log_fn=lambda s: None)
    assert [row["epoch"] for row in again.history] == [2] and again.state.step > result.state.step
    shutil.rmtree(tmp_path)  # ~0.7 GB of train states: keep the suite's disk small


@pytest.mark.parametrize("over, match", [
    ({"train.chunk_bucketing": True}, "train.chunk_bucketing needs random access"),
    ({"encoder.text_embedding_cache": True}, "text_embedding_cache needs a dense split"),
])
def test_train_model_refuses_what_a_stream_cannot_do(over, match, stream_export):
    """The JAX loop's refusals on a streaming split, with its messages."""
    from multimodalrouting_tpu_torch.data.streaming import StreamingSplit

    cfg = tc.apply_overrides(tc.Config(), {**STREAM, "train.sampler_mode": "none", **over})
    tr = StreamingSplit(stream_export, "train", image_size=32)
    with pytest.raises(ValueError, match=match):
        tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), tr, tiny_batch(4))


def test_train_model_refuses_a_sampler_a_stream_cannot_draw():
    """A split with ``epoch_iter`` but no ``enable_sampler`` takes only
    'none' / 'pos_weight', as in the JAX loop."""
    class Sequential:
        batch_size = 8

        def epoch_iter(self, epoch, batch_size):
            yield from ()

    cfg = tc.apply_overrides(tc.Config(), {**STREAM, "train.sampler_mode": "sqrt"})
    with pytest.raises(ValueError, match="needs random access; this streaming split supports 'none'"):
        tloop.train_model(cfg, build_model(cfg, device="cpu", train=True), Sequential(), tiny_batch(4))


def test_metric_copies_match_jax():
    """The port's numpy copies of the JAX package's epoch metrics, temperature
    fit and threshold search, on binary and multi-label scores with ties."""
    from multimodalrouting_tpu.metrics import calibration as jcal
    from multimodalrouting_tpu.metrics import classification as jcls
    from multimodalrouting_tpu_torch.metrics import calibration as tcal
    from multimodalrouting_tpu_torch.metrics import classification as tcls

    rng = np.random.default_rng(9)
    y, p = (rng.random(200) > 0.7).astype(np.float32), np.round(rng.random(200), 2)
    ym, pm = (rng.random((60, 4)) > 0.6).astype(np.float32), rng.random((60, 4))
    for yy, pp in ((y, p), (ym, pm)):
        assert tcls.epoch_metrics(yy, pp) == jcls.epoch_metrics(yy, pp)
        assert [a.tolist() for a in tcal.find_best_thresholds(yy, pp)] == \
            [a.tolist() for a in jcal.find_best_thresholds(yy, pp)]
    logits = np.log(p + 1e-3) - np.log1p(-p + 1e-3)
    assert tcal.fit_temperature(logits, y) == jcal.fit_temperature(logits, y)
    assert tcal.expected_calibration_error(y, p) == jcal.expected_calibration_error(y, p)
