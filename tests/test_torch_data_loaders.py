"""The port's runtime data layer (``multimodalrouting_tpu_torch/data/``:
tokenization with the hash tokenizer and the native WordPiece, images,
loader, streaming, the INSPECT impressions loader) against the JAX
package's on the same inputs, bit for bit:

- ``tokenize_stay_notes`` and ``chunk_token_ids`` under the hash tokenizer
  and a native WordPiece on a written vocab (each package builds its own
  library; the port's goes into a temporary directory), and
  ``load_tokenizer``'s order and its log line;
- ``make_image_loader`` for train and val, uint8 and normalized, on written
  JPEG and PNG files, the train stack's seeded augmentation over a run of
  calls, and ``decode_image``'s failures;
- ``load_split`` on a real-format export (``cli etl``'s chain over the raw
  dump of tests/test_etl.py, JPEGs written at its ``cxr_path``s);
- ``StreamingSplit.epoch_iter`` over two epochs with and without the
  shuffle buffer under each sampler mode, ``example_batch`` and the stream's
  statistics;
- ``load_impressions_dataset`` with both tokenizers (the Batches field by
  field);
- ``prefetch_to_device`` off the card (``batch_to`` in order), also of a
  mesh's data shard's rows (``shard_batch``).
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from multimodalrouting_tpu.data import images as jimages
from multimodalrouting_tpu.data import inspect_etl as jinspect
from multimodalrouting_tpu.data import loader as jloader
from multimodalrouting_tpu.data import native_tokenizer as jnative_tokenizer
from multimodalrouting_tpu.data import streaming as jstreaming
from multimodalrouting_tpu.data import tokenization as jtok
from multimodalrouting_tpu_torch.data import images as timages
from multimodalrouting_tpu_torch.data import inspect_etl as tinspect
from multimodalrouting_tpu_torch.data import loader as tloader
from multimodalrouting_tpu_torch.data import native_build
from multimodalrouting_tpu_torch.data import native_tokenizer as tnative_tokenizer
from multimodalrouting_tpu_torch.data import streaming as tstreaming
from multimodalrouting_tpu_torch.data import tokenization as ttok
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.parallel.mesh import Mesh, shard_batch
from tests.test_etl import raw_dir  # noqa: F401 (the shared raw-dump fixture)
from tests.test_streaming_loader import _write_export
from tests.test_tokenizer_golden import WORDS
from tests.test_unimodal_legacy_inspect import _impressions_csv
from tests.torch_parity import (  # noqa: F401 (fixtures)
    assert_same_batch,
    port_etl_export,
    port_native_build_dir,
)

pytestmark = pytest.mark.usefixtures("port_native_build_dir")

TEXTS = [
    "",
    "   ",
    "The patient was admitted with acute on chronic respiratory failure and sepsis.",
    "Metoprolol 25 mg PO BID; lisinopril 5 mg daily (hypertension). HR 50-60, bradycardia?",
    " ".join(["intubated", "sepsis", "blood", "pressure", "stable", "unknownword", "Café"] * 90),
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    """tests/test_tokenizer_golden.py's vocab: the real BERT special-token
    layout and clinical word pieces."""
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


@pytest.mark.parametrize("chunking", [(16, 4, 3), (32, 8, 2), (512, 64, 8)])
@pytest.mark.parametrize("tokenizer", ["hash", "native"])
def test_tokenize_stay_notes_matches_jax(tokenizer, chunking, vocab_file):
    max_len, stride, max_chunks = chunking
    if tokenizer == "native":
        tt, jt = ttok.load_tokenizer(vocab_path=vocab_file), jtok.load_tokenizer(vocab_path=vocab_file)
        assert isinstance(tt, tnative_tokenizer.NativeWordPiece) and isinstance(jt, jnative_tokenizer.NativeWordPiece)
        assert tt.vocab_size == jt.vocab_size
    else:
        tt, jt = ttok.HashTokenizer(), jtok.HashTokenizer()
    tcfg = ttok.ChunkingConfig(max_len=max_len, stride=stride, max_chunks=max_chunks)
    jcfg = jtok.ChunkingConfig(max_len=max_len, stride=stride, max_chunks=max_chunks)
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
        got, ref = ttok.tokenize_stay_notes(text, tt, tcfg), jtok.tokenize_stay_notes(text, jt, jcfg)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        for g, r in zip(ttok.chunk_token_ids(tt.encode(text), tcfg), jtok.chunk_token_ids(jt.encode(text), jcfg)):
            np.testing.assert_array_equal(g, r)


def test_native_tokenizer_builds_into_the_ports_directory(vocab_file):
    """The port's WordPiece library is compiled from native/wordpiece.cpp
    into build/native/ (here a temporary directory), never the JAX package's
    native/libwordpiece.so; a stale library is rebuilt."""
    tok = tnative_tokenizer.load_native_tokenizer(vocab_file)
    so = native_build.library_path("wordpiece")
    assert tok is not None and os.path.dirname(so) == native_build.BUILD_DIR and os.path.exists(so)
    assert os.path.realpath(os.path.dirname(so)) != os.path.realpath(os.path.dirname(jnative_tokenizer._SO))
    os.utime(so, (0, 0))  # older than its source: built again
    assert native_build.build_native("wordpiece") == so and os.path.getmtime(so) > 0


def test_load_tokenizer_logs_the_one_it_chose(vocab_file, tmp_path):
    logs = []
    tok = ttok.load_tokenizer(vocab_path=vocab_file, log_fn=logs.append)
    assert isinstance(tok, tnative_tokenizer.NativeWordPiece) and logs[-1].startswith("[tokenizer] native WordPiece")
    # no vocab and no local HF tokenizer of that name: the hash fallback, as JAX chooses
    tok = ttok.load_tokenizer("no/such-model", vocab_path=str(tmp_path / "missing.txt"), log_fn=logs.append)
    assert isinstance(tok, ttok.HashTokenizer) and isinstance(jtok.load_tokenizer("no/such-model"), jtok.HashTokenizer)
    assert logs[-1].startswith("[tokenizer] hash fallback")


def _gradient_image(w=300, h=260, mode="RGB"):
    x, y = np.linspace(0, 255, w, dtype=np.float32), np.linspace(0, 255, h, dtype=np.float32)
    rgb = np.stack([np.tile(x, (h, 1)), np.tile(y[:, None], (1, w)), np.full((h, w), 128.0, np.float32)], -1)
    return Image.fromarray(rgb.astype(np.uint8)).convert(mode)


@pytest.mark.parametrize("spec", ["flagship", "medfuse"])
@pytest.mark.parametrize("pixels", ["uint8", "normalized"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_make_image_loader_matches_jax(split, pixels, spec, tmp_path):
    """JPEG and PNG files, grayscale and colour; the train stack's seeded
    augmentation over a run of calls, then after ``reseed``."""
    rows = []
    for i, (fmt, mode) in enumerate((("JPEG", "L"), ("PNG", "RGB"), ("JPEG", "RGB"), ("PNG", "L"))):
        p = f"img{i}.{fmt.lower()}"
        _gradient_image(300 - 20 * i, 260 + 10 * i, mode).save(tmp_path / p, format=fmt)
        rows.append(pd.Series({"cxr_path": p, "has_image": 1}))
    rows += [pd.Series({"cxr_path": "missing.jpg"}), pd.Series({"cxr_path": None}), pd.Series({"other": "x"})]
    kw = dict(spec=spec, resize=64, crop=48, seed=5, root=str(tmp_path), pixels=pixels)
    tl, jl = timages.make_image_loader(split, **kw), jimages.make_image_loader(split, **kw)
    for _ in range(2):
        for row in rows:
            got, ref = tl(row), jl(row)
            if ref is None:
                assert got is None
                continue
            assert got.dtype == ref.dtype == (np.uint8 if pixels == "uint8" else np.float32)
            np.testing.assert_array_equal(got, ref)
    tt = timages.build_image_transform(split, spec=spec, resize=64, crop=48, seed=1, pixels=pixels)
    jt = jimages.build_image_transform(split, spec=spec, resize=64, crop=48, seed=1, pixels=pixels)
    img = _gradient_image()
    for seed in (3, 3, 4):
        tt.reseed(seed)
        jt.reseed(seed)
        np.testing.assert_array_equal(tt(img), jt(img))


def test_inverse_affine_and_decode_failures_match_jax(tmp_path):
    for args in (((10.0, 12.0), 7.5, (3, -2), 1.04, (4.0, 0.0)), ((0.0, 0.0), -45.0, (0, 0), 0.9, (0.0, 0.0))):
        assert timages.inverse_affine_matrix(*args) == jimages.inverse_affine_matrix(*args)
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    for p in (tmp_path / "bad.jpg", tmp_path / "none.png", tmp_path / "x.dcm", ""):
        assert timages.decode_image(str(p)) is None and jimages.decode_image(str(p)) is None
    assert timages.PATH_COLUMN_CANDIDATES == jimages.PATH_COLUMN_CANDIDATES


@pytest.fixture(scope="module")
def export_dir(raw_dir, tmp_path_factory):  # noqa: F811
    """A real-format export through the port's ``cli etl`` chain (32 x 2
    notes), JPEGs at its ``cxr_path``s under ``images/``."""
    d = tmp_path_factory.mktemp("export")
    port_etl_export(raw_dir, d)
    return d


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("pixels", ["uint8", "normalized"])
def test_load_split_matches_jax(split, pixels, export_dir):
    """Every Batch field and the stay ids, images decoded (has_i exactly
    where a JPEG decoded)."""
    kw = dict(resize=40, crop=32, seed=0, root=str(export_dir / "images"), pixels=pixels)
    dtype = np.uint8 if pixels == "uint8" else np.float32
    got = tloader.load_split(str(export_dir / "export"), split, image_size=32, image_dtype=dtype,
                             image_loader=timages.make_image_loader(split, **kw))
    ref = jloader.load_split(str(export_dir / "export"), split, image_size=32, image_dtype=dtype,
                             image_loader=jimages.make_image_loader(split, **kw))
    assert_same_batch(got.batch, ref.batch)
    np.testing.assert_array_equal(got.stay_ids, ref.stay_ids)
    images = pd.read_parquet(export_dir / "export" / "images_48h.parquet").set_index("stay_id")
    for i, sid in enumerate(got.stay_ids):
        decoded = bool(images.loc[sid, "has_image"]) and isinstance(images.loc[sid, "cxr_path"], str)
        assert got.batch.has_i[i] == float(decoded) and (np.abs(got.batch.image[i]).sum() > 0) == decoded


@pytest.fixture(scope="module")
def stream_dir(tmp_path_factory):
    """tests/test_streaming_loader.py's export at 60 stays, with images."""
    d = tmp_path_factory.mktemp("stream")
    _write_export(str(d), 60, t=4, f=3, s=2, l=8, seed=4)
    img = d / "im.png"
    _gradient_image(40, 36).save(img)
    labels = pd.read_parquet(d / "labels.parquet")
    labels["mortality"] = (np.random.default_rng(1).random(len(labels)) < 0.2).astype(np.int8)  # imbalanced
    labels.to_parquet(d / "labels.parquet", index=False)
    pd.DataFrame({"stay_id": labels["stay_id"], "has_image": (labels["stay_id"] % 3 != 0).astype(int),
                  "cxr_path": [str(img) if s % 4 else None for s in labels["stay_id"]]}).to_parquet(
        d / "images_48h.parquet", index=False)
    return str(d)


@pytest.mark.parametrize("sampler", ["none", "sqrt", "hybrid"])
@pytest.mark.parametrize("shuffle_buffer", [0, 16])
def test_streaming_epochs_match_jax(shuffle_buffer, sampler, stream_dir):
    """Two epochs of ``epoch_iter`` (the train loop's pulls) batch by batch,
    with the train stack's seeded augmentation, then ``example_batch`` and
    the stream statistics."""
    splits = []
    for mod, images in ((tstreaming, timages), (jstreaming, jimages)):
        s = mod.StreamingSplit(stream_dir, "train", task="readmit", image_size=16, rows_per_read=7,
                               image_loader=images.make_image_loader("train", resize=20, crop=16, seed=2),
                               shuffle_buffer=shuffle_buffer, seed=5)
        s.enable_sampler(sampler)
        splits.append(s)
    ts, js = splits
    assert ts.batch_size == js.batch_size == 48
    for epoch in range(2):
        got, ref = list(ts.epoch_iter(epoch, 8)), list(js.epoch_iter(epoch, 8))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert_same_batch(g, r)
        assert np.asarray(got[0].has_i).sum() > 0
    assert_same_batch(ts.example_batch(8), js.example_batch(8))
    assert vars(ts.stats) == vars(js.stats)


def test_iter_split_batches_matches_jax_and_load_split(stream_dir):
    """Unshuffled, the stream is load_split's split in file order; the
    remainder batch and the pheno-less readmit labels as JAX."""
    kw = dict(batch_size=7, task="readmit", image_size=16, rows_per_read=5)
    got = list(tstreaming.iter_split_batches(stream_dir, "val", **kw))
    ref = list(jstreaming.iter_split_batches(stream_dir, "val", **kw))
    assert [len(s) for _, s in got] == [len(s) for _, s in ref] == [7, 5]
    for (gb, gs), (rb, rs) in zip(got, ref):
        assert_same_batch(gb, rb)
        np.testing.assert_array_equal(gs, rs)
    dense = tloader.load_split(stream_dir, "val", task="readmit", image_size=16).batch
    np.testing.assert_array_equal(np.concatenate([np.asarray(b.x_struct) for b, _ in got]), dense.x_struct)


@pytest.mark.parametrize("tokenizer", ["hash", "native"])
def test_load_impressions_dataset_matches_jax(tokenizer, vocab_file, tmp_path):
    csv = _impressions_csv(tmp_path, n=40)
    kw = dict(max_len=16, stride=4, max_chunks=2, seed=3, test_frac=0.2, val_frac=0.1,
              vocab_path=vocab_file if tokenizer == "native" else None, tokenizer_name="no/such-model")
    got, ref = tinspect.load_impressions_dataset(str(csv), **kw), jinspect.load_impressions_dataset(str(csv), **kw)
    assert got["_tasks"] == ref["_tasks"] == ("pe_positive_nlp", "1_month_mortality")
    for s in ("train", "val", "test"):
        assert_same_batch(got[s], ref[s])
    if tokenizer == "native":  # WordPiece pieces, not the hash tokenizer's 1000+ ids
        assert int(np.asarray(got["train"].note_ids).max()) < 104 + len(WORDS)


def test_prefetch_to_device_off_the_card_is_batch_to():
    batches = [_tiny_cohort(i) for i in range(5)]
    out = list(tloader.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for got, b in zip(out, batches):
        ref = batch_to(b, "cpu")
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.dtype == r.dtype and torch.equal(g, r)
    # with a mesh: the caller's shard_batch cuts this rank's data shard's rows of each global batch
    mesh = Mesh(n_data=3, n_model=2, rank=5)
    local = (shard_batch(b, mesh) for b in batches)
    for got, b in zip(tloader.prefetch_to_device(local, device="cpu"), batches):
        for g, r in zip(got, batch_to(b, "cpu")):
            assert (g is None) == (r is None)
            if r is not None:
                assert torch.equal(g, r[2:3])


def _tiny_cohort(seed: int):
    from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort

    return make_synthetic_cohort(3, t=4, f=2, s=2, l=8, image_size=8, vocab_size=64, seed=seed)
