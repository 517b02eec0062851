"""The ranks of tests/test_torch_mesh.py: a process of a two-rank gloo world
on the CPU that runs the port's mesh paths and writes what it saw for the
test to compare with one process. It imports neither JAX nor the JAX
package.

    python -m tests.torch_mesh_ranks RANK WORLD PORT WORKDIR

Every model starts from ``WORKDIR/variables.pkl``, the test's seeded JAX
variables (written first), and each scenario writes
``WORKDIR/<scenario>.rank<r>.pt``.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import mesh as pmesh
from multimodalrouting_tpu_torch.train import steps as tsteps
from multimodalrouting_tpu_torch.train.loop import note_pack_bucket, train_model
from multimodalrouting_tpu_torch.train.losses import eddi_loss, soft_eq_odds_loss
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict

# a tiny flagship: BatchNorm ResNet18 at 32^2 (1 x 1 maps in layer4), BERT
# at 5 chunks of 32 tokens, the 10-route capsule head, fp32, every dropout 0
TINY = {
    "encoder.d": 16, "encoder.structured_seq_len": 8, "encoder.structured_n_feats": 8,
    "encoder.structured_layers": 1, "encoder.structured_heads": 2, "encoder.bert_hidden": 32,
    "encoder.bert_layers": 2, "encoder.bert_heads": 2, "encoder.bert_intermediate": 64,
    "encoder.bert_vocab_size": 256, "encoder.bert_max_position": 32, "encoder.notes_max_chunks": 5,
    "encoder.text_max_len": 32, "encoder.image_size": 32, "encoder.vision_backbone": "resnet18",
    "encoder.vision_norm": "batch", "encoder.dropout": 0.0, "model.d": 16, "model.mult_layers": 1,
    "model.mult_self_layers": 1, "model.mult_heads": 2, "model.pc_dim": 4, "model.mc_caps_dim": 8,
    "model.dtype": "float32", "model.routes": "10", "model.num_classes": 2, "model.attn_dropout": 0.0,
    "model.relu_dropout": 0.0, "model.res_dropout": 0.0, "model.embed_dropout": 0.0,
    "train.route_dropout_p": 0.0, "train.sampler_mode": "pos_weight", "train.chexpert_weight": 0.1,
    "train.batch_size": 8,
}
STEP_LR = 2e-3
# the loss-based fame family at the default dropouts (fine-tuned notes with
# encoder.dropout 0.1), trained on data=1, model=2
DROPOUT_0 = ("encoder.dropout", "model.attn_dropout", "model.relu_dropout", "model.res_dropout",
             "model.embed_dropout")
# train_model runs: 16 + 8 stays, two steps an epoch, no checkpoint but the
# final one where a directory is given
LOOP = {**TINY, "train.sampler_mode": "sqrt", "train.epochs": 2, "train.min_epochs": 0, "train.log_every": 0,
        "train.ckpt_every": 0}


def free_port(skip: int = 0) -> int:
    """A bindable port in [28100, 32100), spread by this process's PID, below
    Linux's ephemeral range (tests/test_multihost.py's rule, another range);
    `skip` passes over that many bindable ones, for several worlds at once."""
    import socket

    port = 28100 + os.getpid() % 4000
    for candidate in range(port, port + 50):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", candidate))
            except OSError:
                continue
        if skip == 0:
            return candidate
        skip -= 1
    raise RuntimeError(f"no bindable port in [{port}, {port + 50})")


def cfg_of(**over):
    return tc.apply_overrides(tc.Config(), {**TINY, **over})


def step_batch() -> Batch:
    """A global batch of 8 whose halves differ in positives (1 against 3),
    in images present (4 against 2) and in valid note chunks (17 against
    4), so that per-rank statistics show."""
    b = make_synthetic_cohort(8, t=8, f=8, s=5, l=32, image_size=32, vocab_size=256, seed=7)
    chunks = np.array([5, 4, 5, 3, 1, 2, 0, 1])
    cm = (np.arange(5)[None, :] < chunks[:, None]).astype(np.float32)
    return b._replace(
        y=np.array([1, 0, 0, 0, 1, 1, 1, 0], np.float32),
        has_i=np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32),
        has_n=(chunks > 0).astype(np.float32),
        chunk_mask=cm, note_attn=(b.note_attn * cm[:, :, None]).astype(np.int32),
    )


def loop_cohorts():
    kw = dict(t=8, f=8, s=5, l=32, image_size=32, vocab_size=256)
    return make_synthetic_cohort(16, seed=11, **kw), make_synthetic_cohort(8, seed=12, **kw)


def seeded_model(cfg, variables):
    """The port's model of `cfg` holding the test's JAX `variables`."""
    return load_jax_variables(build_model(cfg, device="cpu", train=True), variables)


def one_step(cfg, model, state, batch: Batch, record=None):
    """One train step on `batch` (this rank's rows on a mesh) -> metrics;
    `record` collects the gradients apply_gradients receives."""
    real = tsteps.apply_gradients
    if record is not None:
        def spy(st, grads, **kw):
            record.update({n: g.detach().clone() for n, g in grads.items()})
            return real(st, grads, **kw)

        tsteps.apply_gradients = spy
    try:
        step = tsteps.make_train_step(cfg, model)
        return step(state, batch_to(batch, "cpu"), None, STEP_LR, STEP_LR / 2, note_pack=note_pack_bucket(cfg, batch))
    finally:
        tsteps.apply_gradients = real


def state_out(state, metrics=None) -> dict:
    out = {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
           "serving": serving_state_dict(state), "step": state.step, "mu": dict(state.mu)}
    if metrics is not None:
        out.update(loss=float(metrics.loss), reg=float(metrics.reg_loss), finite=bool(metrics.grad_finite))
    return out


# --- the scenarios, each on every rank -----------------------------------------


def data_step(variables, mesh) -> dict:
    """The data=2 step (test_torch_mesh holds it against the JAX
    global-batch step)."""
    cfg = cfg_of(**{"train.num_data_shards": 2})
    model = seeded_model(cfg, variables)
    state = create_train_state(cfg, model)
    metrics = one_step(cfg, model, state, pmesh.shard_batch(step_batch(), mesh))
    return state_out(state, metrics)


def fault(kind: str):
    """A per-rank statistic planted in place of the global one."""
    from multimodalrouting_tpu_torch.models import cxr
    from multimodalrouting_tpu_torch.train import losses

    module, name = {"bn": (cxr, "global_mean"), "pos_weight": (losses, "global_sum")}[kind]
    real = getattr(module, name)
    setattr(module, name, lambda x: x)
    return lambda: setattr(module, name, real)


def chunk_rows(model) -> list:
    """The rows of each BERT call of `model`'s note encoder, recorded as
    they come."""
    enc = model.encoders.bbert
    rows, real = [], enc.chunk_embeddings

    def spy(ids, attn, generator=None):
        rows.append(int(ids.shape[0]))
        return real(ids, attn, generator)

    enc.chunk_embeddings = spy
    return rows


def model_sharded_step(variables) -> dict:
    """data=1, model=2 with fine-tuned notes: the chunks split over the two
    ranks; the gradients apply_gradients receives, BERT's included, and
    the chunks each rank's BERT ran on."""
    cfg = cfg_of(**{"encoder.finetune_text": True, "train.num_model_shards": 2})
    model = seeded_model(cfg, variables)
    state = create_train_state(cfg, model)
    grads: dict = {}
    rows = chunk_rows(model)
    metrics = one_step(cfg, model, state, step_batch(), record=grads)
    return {**state_out(state, metrics), "grads": grads, "chunk_rows": rows}


def loss_based_cfg(**over):
    return tc.apply_overrides(tc.Config(), {
        **{k: v for k, v in LOOP.items() if k not in DROPOUT_0}, "model.smro_gate_mode": "loss_based",
        "encoder.finetune_text": True, "encoder.dropout": 0.1, **over})


def loss_based_loop() -> dict:
    """2 epochs of the loss-based fame family at the default dropouts on
    data=1, model=2 (torch's seeded init): the ranks of the model group
    hold the same rows and must draw the same head masks, so the route-loss
    EMA that the gate reads and every decision it feeds stay the same."""
    cfg = loss_based_cfg(**{"train.num_model_shards": 2})
    torch.manual_seed(0)
    model = build_model(cfg, "fame", device="cpu", train=True)
    tr, va = loop_cohorts()
    res = train_model(cfg, model, tr, va, family="fame", log_fn=lambda _: None)
    return {**state_out(res.state), "history": res.history, "route_loss_ema": res.state.route_loss_ema.clone()}


# a channel's values: a large mean and a small spread, where E[x^2] - E[x]^2
# cancels in fp32
BN_SHAPE, BN_MEAN, BN_SPREAD = (8, 16, 2, 2), 30.0, 3e-2


def bn_inputs():
    """(x, the BatchNorm's scale and bias, the output's weights), seeded."""
    rng = np.random.default_rng(9)
    x = BN_MEAN + rng.normal(size=(1, BN_SHAPE[1], 1, 1)) + BN_SPREAD * rng.normal(size=BN_SHAPE)
    return [torch.tensor(v, dtype=torch.float32) for v in (
        x, 1 + 0.1 * rng.normal(size=BN_SHAPE[1]), rng.normal(size=BN_SHAPE[1]), rng.normal(size=BN_SHAPE))]


def batch_norm_rows(rows: slice) -> dict:
    """One training BatchNorm forward and backward on `rows` of bn_inputs()
    (a rank's 4 on a data mesh): the output, the input's gradient and the
    batch statistics (running statistics started at 0)."""
    from multimodalrouting_tpu_torch.models.cxr import BatchNorm

    x, scale, bias, w = bn_inputs()
    bn = BatchNorm(BN_SHAPE[1], torch.float32)
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(bias)
        bn.running_mean.zero_()
        bn.running_var.zero_()
    x = x[rows].clone().requires_grad_()
    out = bn(x, train=True)
    (out * w[rows]).sum().backward()
    m = 1 - BatchNorm.MOMENTUM
    return {"out": out.detach(), "grad": x.grad, "mean": bn.batch_update[0] / m, "var": bn.batch_update[1] / m}


def fairness(rows: slice) -> dict:
    """EDDI and soft equalized odds of `rows` of 8 (a rank's 4 on the mesh),
    and the gradient of each with respect to them."""
    rng = np.random.default_rng(3)
    probs, y = rng.random(8).astype(np.float32), np.array([1, 0, 0, 0, 1, 1, 1, 0], np.float32)
    groups = np.array([0, 0, 0, 1, 1, 1, 1, 0])
    out = {}
    for name, fn in (("eddi", eddi_loss), ("eq_odds", soft_eq_odds_loss)):
        p = torch.tensor(probs[rows], requires_grad=True)
        pen = fn(p, torch.tensor(y[rows]), torch.tensor(groups[rows]))
        pen.backward()
        out[name] = (float(pen.detach()), p.grad.clone())
    return out


def loop_run(work: str, variables, name: str, **over) -> dict:
    cfg = tc.apply_overrides(tc.Config(), {**LOOP, "train.num_data_shards": 2, **over})
    tr, va = loop_cohorts()
    ckpt = os.path.join(work, name) if over.get("train.epochs") == 1 else None
    model = seeded_model(cfg, variables)
    res = train_model(cfg, model, tr, va, log_fn=lambda _: None, ckpt_dir=ckpt)
    out = {**state_out(res.state), "history": res.history}
    if res.state.zero is not None:
        out["adam_bytes"] = sum(v.numel() * v.element_size() for d in (res.state.mu, res.state.nu)
                                for v in d.values())
    return out


def main(rank: int, world: int, port: str, work: str) -> None:
    from multimodalrouting_tpu_torch.parallel.distributed import init_multihost

    torch.set_num_threads(1)
    assert init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu")

    def save(name, value):
        torch.save(value, os.path.join(work, f"{name}.rank{rank}.pt"))

    with open(os.path.join(work, "variables.pkl"), "rb") as f:
        variables = pickle.load(f)
    data = pmesh.make_mesh(2, 1)
    pmesh.warmup_collectives(data, "cpu")
    pmesh.set_active_mesh(data)
    half = slice(4 * data.data_index, 4 * data.data_index + 4)
    save("fairness", fairness(half))
    save("batch_norm", batch_norm_rows(half))
    save("data_step", data_step(variables, data))
    for kind in ("bn", "pos_weight"):
        undo = fault(kind)
        try:
            save(f"fault_{kind}", data_step(variables, data))
        finally:
            undo()
    pmesh.set_active_mesh(pmesh.make_mesh(1, 2))
    save("model_sharded", model_sharded_step(variables))
    pmesh.set_active_mesh(None)
    save("loss_based", loss_based_loop())
    save("loop", loop_run(work, variables, "loop"))
    save("loop_zero", loop_run(work, variables, "loop_zero", **{"train.zero_sharded_opt": True}))
    save("ckpt_zero", loop_run(work, variables, "ckpt_zero", **{"train.zero_sharded_opt": True,
                                                                 "train.epochs": 1}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
