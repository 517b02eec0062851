"""The one traffic generator: stays, training batches and requests from a
mix's parameters (``portbench/traffic/<mix>.json``) and ``--seed``.

Every seed gets the same work in another order: the sizes of a pool (note
chunks per stay, the last chunk's length, the labs' valid hours, the
positives of each label) are a fixed multiset spread evenly over the
mix's ranges, and the seed permutes them; requests take their sizes from
blocks that each hold every size of the range once. The contents (token
ids, lab values, pixels) are drawn on the device from a ``torch.Generator``
seeded with ``--seed``.

A stay carries labs [hours, features] with its valid hours, 1 to 8 note
chunks of the configuration's chunk length (every chunk full but the last,
whose length the mix gives), and a CXR image of the configuration's size,
as uint8 pixels (training: the model normalises them) or normalised float32
(a request's record: the client has transformed its image).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

CLS_ID, FIRST_WORD_ID = 101, 1000
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole values spread evenly over [lo, hi] (each integer equally often
    where the range divides n)."""
    return np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n).astype(np.int64)


def _permuted(rng: np.random.Generator, values: np.ndarray) -> np.ndarray:
    return values[rng.permutation(len(values))]


@dataclasses.dataclass
class Pool:
    """n stays on the device (the model's Batch fields) and their sizes."""

    fields: Dict[str, torch.Tensor]
    chunks: np.ndarray  # [n] valid note chunks
    last_len: np.ndarray  # [n] the last chunk's length
    labels: np.ndarray  # [n] or [n, K] 0 / 1


def make_pool(mix: Mapping, cfg: Mapping, n: int, seed: int, device, float_images: bool = False) -> Pool:
    e, m = cfg["encoder"], cfg["model"]
    rng = np.random.default_rng([int(seed), 1])
    s_max, length = e["notes_max_chunks"], e["text_max_len"]
    t, f, side = e["structured_seq_len"], e["structured_n_feats"], e["image_size"]
    chunks = _permuted(rng, spread(*mix["chunks"], n))
    last_len = _permuted(rng, spread(min(mix["last_chunk_len"][0], length), min(mix["last_chunk_len"][1], length), n))
    hours = _permuted(rng, spread(min(mix["lab_hours"][0], t), min(mix["lab_hours"][1], t), n))
    labels = make_labels(mix, m, n, rng)

    gen = torch.Generator(device=device).manual_seed(int(seed))
    slot = torch.arange(s_max, device=device)[None, :]
    c = torch.as_tensor(chunks, device=device)[:, None]
    chunk_mask = (slot < c).float()
    lens = torch.where(slot < c - 1, torch.full_like(slot, length), torch.as_tensor(last_len, device=device)[:, None])
    lens = lens * (slot < c)
    pos = torch.arange(length, device=device)
    note_attn = (pos[None, None, :] < lens[..., None]).to(torch.int32)
    ids = torch.randint(FIRST_WORD_ID, e["bert_vocab_size"], (n, s_max, length), generator=gen, device=device,
                        dtype=torch.int32)
    ids[:, :, 0] = CLS_ID
    note_ids = ids * note_attn
    x_struct = torch.randn((n, t, f), generator=gen, device=device)
    m_struct = (torch.arange(t, device=device)[None, :] < torch.as_tensor(hours, device=device)[:, None]).float()
    pixels = torch.randint(0, 256, (n, side, side, 3), generator=gen, device=device, dtype=torch.uint8)
    if float_images:
        mean = torch.tensor(IMAGENET_MEAN, device=device)
        std = torch.tensor(IMAGENET_STD, device=device)
        image = (pixels.float() / 255.0 - mean) / std
    else:
        image = pixels
    ones = torch.ones(n, device=device)
    fields = {
        "x_struct": x_struct, "m_struct": m_struct, "note_ids": note_ids, "note_attn": note_attn,
        "chunk_mask": chunk_mask, "image": image, "has_l": ones, "has_n": ones, "has_i": ones,
        "y": torch.as_tensor(labels, dtype=torch.float32, device=device),
    }
    return Pool(fields=fields, chunks=chunks, last_len=last_len, labels=labels)


def make_labels(mix: Mapping, model_cfg: Mapping, n: int, rng: np.random.Generator) -> np.ndarray:
    """Mortality: round(rate n) positives. Phenotypes: one positive rate per
    label, spread over the mix's range and assigned by the seed, each with
    round(rate n) positives."""
    k = model_cfg["num_classes"]
    if model_cfg["task"] == "mort":
        y = np.zeros(n, np.float32)
        y[: int(round(mix["positive_rate"] * n))] = 1.0
        return _permuted(rng, y)
    lo, hi = mix["label_rates"]
    rates = _permuted(rng, lo + (hi - lo) * (np.arange(k) + 0.5) / k)
    y = np.zeros((n, k), np.float32)
    for j, rate in enumerate(rates):
        col = np.zeros(n, np.float32)
        col[: int(round(rate * n))] = 1.0
        y[:, j] = _permuted(rng, col)
    return y


def train_order(mix: Mapping, labels: np.ndarray, seed: int) -> List[np.ndarray]:
    """The pool's batches: one permutation drawn from the seed, cut into
    batches, so that every pass over the pool holds every stay once and the
    same work whatever the seed (the train loop's sqrt sampler draws with
    replacement, which would change the chunks a window holds with the
    seed); the first three batches share no stay."""
    rng = np.random.default_rng([int(seed), 2])
    batch = mix["batch"]
    perm = rng.permutation(len(labels))
    return [perm[i * batch:(i + 1) * batch] for i in range(mix["pool_batches"])]


def request_sizes(mix: Mapping, seed: int) -> List[int]:
    """Blocks that each hold every request size of the mix's range once, in
    an order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 3])
    lo, hi = mix["stays_per_request"]
    sizes = np.arange(lo, hi + 1)
    return [int(s) for _ in range(mix["blocks"]) for s in rng.permutation(sizes)]


def request_stays(sizes: Sequence[int], pool_n: int, seed: int) -> List[np.ndarray]:
    """The stays of each request: consecutive stays of a seeded permutation
    of the pool, taken cyclically."""
    rng = np.random.default_rng([int(seed), 4])
    perm = rng.permutation(pool_n)
    out, at = [], 0
    for s in sizes:
        out.append(perm[(at + np.arange(s)) % pool_n])
        at += s
    return out


def host_records(pool: Pool) -> List[Dict[str, np.ndarray]]:
    """The pool as request records (one dict of host arrays a stay)."""
    host = {k: pool.fields[k].cpu().numpy() for k in ("x_struct", "m_struct", "note_ids", "note_attn", "chunk_mask",
                                                       "image")}
    n = len(pool.chunks)
    return [{k: v[i] for k, v in host.items()} for i in range(n)]
