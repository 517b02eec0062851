"""The traffic generator: the same seed gives the same inputs, another seed
the same sizes in another order."""
import numpy as np
import pytest
import torch

import tiny
from portbench.harness import manifest, traffic


def tiny_cell(workload):
    return tiny.shrink()(manifest.cell(manifest.benchmark(), workload))


@pytest.mark.parametrize("workload", ["pheno.train_finetune", "mort.ward_requests", "mort.cohort_rescore"])
def test_pool_is_deterministic_in_the_seed(workload):
    cell = tiny_cell(workload)
    n = 16
    big = 2**31 + 977
    a = traffic.make_pool(cell["traffic"], cell["config"], n, big, torch.device("cpu"))
    b = traffic.make_pool(cell["traffic"], cell["config"], n, big, torch.device("cpu"))
    c = traffic.make_pool(cell["traffic"], cell["config"], n, big + 1, torch.device("cpu"))
    for k in a.fields:
        assert torch.equal(a.fields[k], b.fields[k]), k
    assert not torch.equal(a.fields["note_ids"], c.fields["note_ids"])
    # the same sizes, in another order
    assert sorted(a.chunks) == sorted(c.chunks) and sorted(a.last_len) == sorted(c.last_len)
    assert np.array_equal(np.sort(a.labels, axis=0).sum(axis=0), np.sort(c.labels, axis=0).sum(axis=0)) or \
        a.labels.ndim == 2
    assert a.labels.sum() == c.labels.sum()


def test_pool_shapes_and_masks():
    cell = tiny_cell("pheno.train_finetune")
    e = cell["config"]["encoder"]
    p = traffic.make_pool(cell["traffic"], cell["config"], 16, 5, torch.device("cpu"))
    f = p.fields
    assert f["note_ids"].shape == (16, e["notes_max_chunks"], e["text_max_len"])
    assert f["image"].dtype == torch.uint8 and f["image"].shape == (16, e["image_size"], e["image_size"], 3)
    for i in range(16):
        c = int(p.chunks[i])
        assert f["chunk_mask"][i].tolist() == [1.0] * c + [0.0] * (e["notes_max_chunks"] - c)
        lens = f["note_attn"][i].sum(dim=1).tolist()
        assert lens[: c - 1] == [e["text_max_len"]] * (c - 1) and lens[c - 1] == p.last_len[i]
        assert sum(lens[c:]) == 0
        assert (f["note_ids"][i] != 0).sum() == sum(lens)


def test_train_order_and_requests_are_deterministic():
    cell = tiny_cell("pheno.train_finetune")
    mix = cell["traffic"]
    labels = traffic.make_labels(mix, cell["config"]["model"], 16, np.random.default_rng(0))
    a, b = traffic.train_order(mix, labels, 9), traffic.train_order(mix, labels, 9)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    first = np.concatenate(a[:3])
    assert len(set(first.tolist())) == len(first)  # the compared steps share no stay
    assert all(len(set(x.tolist())) == len(x) for x in a)
    serve = tiny_cell("mort.ward_requests")["traffic"]
    s1, s2 = traffic.request_sizes(serve, 4), traffic.request_sizes(serve, 5)
    lo, hi = serve["stays_per_request"]
    block = hi - lo + 1
    assert s1 == traffic.request_sizes(serve, 4) and s1 != s2
    assert sorted(s1[:block]) == sorted(s2[:block]) == list(range(lo, hi + 1))
