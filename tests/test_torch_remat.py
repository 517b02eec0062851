"""``model.remat`` in the port: each BERT layer's activations recomputed in
the backward (``torch.utils.checkpoint``) in the layered encoder, the
pipeline layout's loop and schedule, and the text cache's encoder, as the
JAX package's ``nn.remat`` / ``jax.checkpoint`` do. Remat changes no number:

- the layered ``BertEncoder`` at ``encoder.dropout`` 0.1 with a seeded
  generator: the recompute draws the first run's masks (the generator's
  state is put back around it), so the output and every gradient are those
  of the run without remat, and the generator ends where it would;
- the stacked layers' ``_scan_layers`` with and without remat, and against
  the JAX package's with ``remat=True`` (the one-process counterpart of its
  tests/test_pp.py:test_remat_scan_matches_plain);
- one fine-tuned train step of the tiny flagship, layered (with every
  dropout on) and in the pipeline layout, with and without remat;
- the text cache, an inference pass, with and without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu.parallel import pp as jpp
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.models.clinbert import BertEncoder
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import pp
from multimodalrouting_tpu_torch.train.state import create_train_state
from multimodalrouting_tpu_torch.train.steps import make_train_step
from multimodalrouting_tpu_torch.train.text_cache import compute_note_chunk_embs
from tests import torch_mesh_ranks as mr
from tests import torch_pp_ranks as ppr
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BERT = dict(vocab_size=64, hidden=32, layers=3, heads=4, intermediate=64, max_position=16)


def _bert_run(remat: bool):
    """One forward and backward of a seeded layered BertEncoder at dropout
    0.1 -> (output, gradients by name, the generator's state after)."""
    torch.manual_seed(0)
    enc = BertEncoder(**BERT, dropout=0.1, remat=remat)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(1, 64, (5, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(5, 16)
    mask[2:, 10:] = 0
    out = enc(ids, mask, g)
    (out.float() ** 2).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in enc.named_parameters()}, g.get_state()


def test_remat_in_the_layered_encoder_redraws_the_same_dropout_masks():
    out, grads, state = _bert_run(False)
    out_r, grads_r, state_r = _bert_run(True)
    assert torch.equal(out, out_r)
    assert torch.equal(state, state_r)
    assert sorted(grads) == sorted(grads_r)
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_remat_without_the_generator_s_state_put_back_would_be_caught(monkeypatch):
    """A planted fault: the recompute draws fresh masks (checkpoint's own RNG
    preservation covers the global generator only); the gradients then part
    from the run without remat."""
    from multimodalrouting_tpu_torch.models import clinbert
    from torch.utils.checkpoint import checkpoint

    monkeypatch.setattr(clinbert, "remat_layer", lambda layer, x, m, g: checkpoint(layer, x, m, g,
                                                                                   use_reentrant=False))
    _, grads, _ = _bert_run(False)
    _, grads_r, _ = _bert_run(True)
    assert any(not torch.allclose(g, grads_r[n], rtol=1e-3, atol=1e-6) for n, g in grads.items())


def test_remat_scan_matches_plain_and_jax():
    """_scan_layers with per-layer recomputation: the loss and gradients of
    the plain loop (tests/test_pp.py's limits) and of the JAX package's
    _scan_layers with remat=True."""
    case = ppr.schedule_case(6, 8)
    r = torch.from_numpy(case["r"])

    def port(remat):
        w = {k: torch.from_numpy(v).requires_grad_() for k, v in case["w"].items()}
        out = pp._scan_layers(w, torch.from_numpy(case["x"]), torch.from_numpy(case["mask"]), heads=ppr.HEADS,
                              dtype=torch.float32, remat=remat)
        loss = (torch.tanh(out @ r) ** 2).sum()
        return float(loss.detach()), dict(zip(w, torch.autograd.grad(loss, list(w.values()))))

    def jax_loss(w):
        out = jpp._scan_layers(w, jnp.asarray(case["x"]), jnp.asarray(case["mask"]), heads=ppr.HEADS,
                               dtype=jnp.float32, remat=True)
        return jnp.sum(jnp.tanh(out @ jnp.asarray(case["r"])) ** 2)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, case["w"]))
    (f_plain, g_plain), (f_remat, g_remat) = port(False), port(True)
    assert f_remat == pytest.approx(f_plain, rel=1e-6)
    assert f_remat == pytest.approx(float(j_loss), rel=1e-5)
    for k in g_plain:
        np.testing.assert_allclose(g_remat[k].numpy(), g_plain[k].numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
        if k != "k_bias":  # its gradient is rounding noise (softmax is shift-invariant)
            np.testing.assert_allclose(g_remat[k].numpy(), np.asarray(j_grads[k]), atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", ["layered", "pipeline"])
def test_a_train_step_with_remat_is_the_step_without_it(layout):
    """One fine-tuned step of the tiny flagship from the same init and
    generator, with and without model.remat: the same loss and the same
    parameters after it. The layered run keeps every dropout on (the
    pipeline layout's BERT has none)."""
    over = {**mr.TINY, "encoder.finetune_text": True, "model.attn_dropout": 0.1, "model.res_dropout": 0.1}
    if layout == "pipeline":
        over["train.pipeline_parallel"] = True
    else:
        over["encoder.dropout"] = 0.1
    batch = batch_to(mr.step_batch(), "cpu")
    runs = []
    for remat in (False, True):
        cfg = tc.apply_overrides(tc.Config(), {**over, "model.remat": remat})
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu", train=True)
        state = create_train_state(cfg, model)
        gen = torch.Generator().manual_seed(5)
        metrics = make_train_step(cfg, model)(state, batch, gen, 1e-3, 1e-3)
        runs.append((float(metrics.loss), {n: p.detach().clone() for n, p in model.named_parameters()}))
    (loss, params), (loss_r, params_r) = runs
    assert loss_r == loss
    for name, p in params.items():
        assert torch.equal(p, params_r[name]), name


def test_the_text_cache_is_the_same_with_remat():
    """The cache pass runs without a gradient, where remat recomputes
    nothing: the embeddings are the same bits."""
    over = {**mr.TINY, "encoder.text_embedding_cache": True}
    cohort = mr.step_batch()
    embs = []
    for remat in (False, True):
        cfg = tc.apply_overrides(tc.Config(), {**over, "model.remat": remat})
        torch.manual_seed(0)
        embs.append(compute_note_chunk_embs(cfg, build_model(cfg, device="cpu", train=True), cohort))
    assert torch.equal(*embs)
