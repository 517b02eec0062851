"""Background checkpoint saves (``train.ckpt_backend=orbax_async``,
``ckpt.save_checkpoint(..., background=True)``, ``ckpt.wait_for_saves``) on
the CPU at tiny widths:

- a background save of a train state, whose write is held back while two
  more steps change the state in place, writes the directory a synchronous
  save of the same state writes, byte for byte; with the host copy planted
  out (``ckpt.host_copy`` the identity) the files differ, so the test sees
  the fault;
- an error in the writer thread re-raises from ``wait_for_saves`` and from
  the next save, and is not raised twice;
- ``train_model`` under ``orbax_async`` writes the checkpoints a msgpack run
  of the same seed writes, byte for byte, has no write in flight when it
  returns, and logs the loop's blocking time and each write;
- a reader waits for a write in flight to its checkpoint, and not for a
  write to another one, whose error it does not raise.
"""
import hashlib
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from multimodalrouting_tpu_torch import ckpt
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train import loop as tloop
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict, train_state_dict
from multimodalrouting_tpu_torch.train.steps import make_train_step
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import STEP_LR, one_torch_thread, torch_batch  # noqa: F401 (one_torch_thread: a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = {**TINY, "encoder.text_max_len": 16, "encoder.image_size": 32, "encoder.vision_norm": "batch",
       "train.epochs": 2, "train.min_epochs": 0, "train.encoder_warmup_epochs": 0}
FILES = ("config.json", "meta.json", "weights.pt", ckpt.TRAIN_STATE)


def _files(path):
    """{file name: sha256 of its bytes} of a checkpoint directory."""
    out = {}
    for name in FILES:
        with open(os.path.join(path, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed after the test: it holds ~0.2 GB checkpoints."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def no_write_left_behind():
    yield
    ckpt.wait_for_saves()


@pytest.fixture(scope="module")
def stepped():
    """A tiny fine-tuned flagship after one step: (cfg, state, step, batch)."""
    cfg = tc.apply_overrides(tc.Config(), CFG)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model)
    batch = torch_batch(tiny_batch(n=4, seed=1, missing_rate=0.25))
    assert step(state, batch, None, STEP_LR, STEP_LR).grad_finite
    return cfg, state, step, batch


def _held_writer(monkeypatch):
    """Hold every background write until the returned event is set."""
    release, real = threading.Event(), ckpt._write

    def held(*args):
        assert release.wait(60)
        real(*args)

    monkeypatch.setattr(ckpt, "_write", held)
    return release


@pytest.mark.parametrize("host_copy", [True, False], ids=["host_copy", "planted_fault_no_host_copy"])
def test_background_save_equals_the_synchronous_one_while_steps_go_on(stepped, host_copy, tmp_path, monkeypatch):
    cfg, state, step, batch = stepped
    meta = {"temperature": 1.5, "thresholds": np.array([0.25, 0.5])}
    ckpt.save_checkpoint(str(tmp_path / "sync"), serving_state_dict(state), cfg, train_state=train_state_dict(state),
                         **meta)
    if not host_copy:
        monkeypatch.setattr(ckpt, "host_copy", lambda tree: tree)
    release = _held_writer(monkeypatch)
    written = []
    ckpt.save_checkpoint(str(tmp_path / "async"), serving_state_dict(state), cfg,
                         train_state=train_state_dict(state), background=True,
                         on_written=lambda path, seconds: written.append(path), **meta)
    assert not os.path.exists(tmp_path / "async" / "weights.pt") and not written
    for _ in range(2):  # the state changes in place while the write waits
        assert step(state, batch, None, STEP_LR, STEP_LR).grad_finite
    release.set()
    ckpt.wait_for_saves()
    assert written == [str(tmp_path / "async")]
    sync, later = _files(tmp_path / "sync"), train_state_dict(state)
    saved = torch.load(tmp_path / "sync" / ckpt.TRAIN_STATE, weights_only=True)
    assert not all(torch.equal(saved["model"][k], v) for k, v in later["model"].items())  # the steps moved it
    same = _files(tmp_path / "async") == sync
    assert same == host_copy


def test_a_writer_error_surfaces_once(stepped, tmp_path, monkeypatch):
    cfg, state, _, _ = stepped

    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_checkpoint(str(tmp_path / "a"), serving_state_dict(state), cfg, background=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # raised once, then gone
    ckpt.save_checkpoint(str(tmp_path / "b"), serving_state_dict(state), cfg, background=True)
    for fut in list(ckpt._IN_FLIGHT.values()):
        fut.exception()  # the write has ended (in its error)
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):  # the next save re-raises it
        ckpt.save_checkpoint(str(tmp_path / "c"), serving_state_dict(state), cfg)
    assert not ckpt._IN_FLIGHT


def test_a_reader_waits_for_the_write_in_flight(stepped, tmp_path, monkeypatch):
    cfg, state, _, _ = stepped
    release = _held_writer(monkeypatch)
    ckpt.save_checkpoint(str(tmp_path / "final"), serving_state_dict(state), cfg,
                         train_state=train_state_dict(state), background=True)
    threading.Timer(0.2, release.set).start()
    assert ckpt.load_meta(str(tmp_path / "final"))["step"] == state.step


def test_a_reader_does_not_wait_for_another_checkpoint_s_write(stepped, tmp_path, monkeypatch):
    cfg, state, _, _ = stepped
    ckpt.save_checkpoint(str(tmp_path / "a"), serving_state_dict(state), cfg, train_state=train_state_dict(state))
    release = _held_writer(monkeypatch)
    ckpt.save_checkpoint(str(tmp_path / "b"), serving_state_dict(state), cfg, background=True)
    try:
        assert ckpt.load_meta(str(tmp_path / "a"))["step"] == state.step  # b's write is still held
        assert not os.path.exists(tmp_path / "b" / "weights.pt")
    finally:
        release.set()
    ckpt.wait_for_saves()
    assert os.path.exists(tmp_path / "b" / "weights.pt")

    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_checkpoint(str(tmp_path / "c"), serving_state_dict(state), cfg, background=True)
    for fut in list(ckpt._IN_FLIGHT.values()):
        fut.exception()  # the write has ended (in its error)
    assert ckpt.load_meta(str(tmp_path / "a"))["step"] == state.step  # c's error is not a's
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()


def test_train_model_under_orbax_async_writes_the_msgpack_runs_checkpoints(tmp_path):
    train, val = tiny_batch(n=12, seed=1), tiny_batch(n=8, seed=2)
    files, logs = {}, {}
    for backend in ("msgpack", "orbax_async"):
        cfg = tc.apply_overrides(tc.Config(), {**CFG, "train.ckpt_backend": backend})
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu", train=True)
        out = tmp_path / backend
        logs[backend] = []
        tloop.train_model(cfg, model, train, val, log_fn=logs[backend].append, ckpt_dir=str(out))
        assert not ckpt._IN_FLIGHT  # the run's end waited for its writes
        names = sorted(n for n in os.listdir(out) if os.path.isdir(out / n))
        files[backend] = {n: _files(out / n) for n in names}
        shutil.rmtree(out)
    assert sorted(files["msgpack"]) == ["best", "best_f1", "final", "last"]
    for name, want in files["msgpack"].items():
        got = files["orbax_async"][name]
        assert got.pop("config.json") != want.pop("config.json")  # the backend differs, nothing else
        assert got == want, name
    for backend, lines in logs.items():
        where = " in the background" if backend == "orbax_async" else ""
        assert any(line.startswith("[ckpt] final: train_state.pt ") and line.endswith(f"s{where}")
                   for line in lines), backend
        assert any(line.startswith("[ckpt] final: the loop blocked ") for line in lines)
