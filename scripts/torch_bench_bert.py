"""The chunk-BERT forward alone, through the PyTorch port
(scripts/bench_bert.py's measurement): BERT-base at [N, 512] in bf16 with
fp32 parameters and the fp32 LayerNorm, seed-0 token ids and an all-ones
mask, timed on the host clock.

    python3 scripts/torch_bench_bert.py                        # on the CUDA card
    BENCH_GELU=erf python3 scripts/torch_bench_bert.py         # the erf GELU
    BENCH_BERT_INT8=1 python3 scripts/torch_bench_bert.py      # the int8 body
    python3 scripts/torch_bench_bert.py --device cpu --small   # tiny widths on the CPU

Env BENCH_BERT_N (128 chunks), BENCH_BERT_STEPS (10), BENCH_BERT_INT8 (0/1:
the six big products of each layer in int8, ``ops/quant.QuantDense``),
BENCH_GELU (poly, that script's default; ``BertEncoder``'s own is erf) and
MMR_FLASH (1 | 0, read by the attention selector as the JAX package reads
it). That script's MMR_FLASH_BLOCK_Q / _K / _B are TPU tiling knobs that the
port does not read, so the line leaves them out. One forward to warm up,
then the timed forwards under ``torch.inference_mode()``, each adding the
first CLS element to an accumulator that is read back at the end (on the
card that readback waits for the device). The JAX script salts the ids so
that ``jit`` cannot merge the calls; eager calls need no salt.

The line gives ms per forward, TFLOP/s from ``bert_fwd_flops`` (that
script's count: the four d x d projections, the FFN and the two attention
products, a multiply-add as 2) and MFU against the H100's dense bf16 peak,
989 TFLOP/s (NVIDIA's data sheet), not the v5e's 197 of the JAX script.
Earlier lines give the card's name and power limit and each kernel's
launches per forward (K1 = 12 at the defaults, in bf16 and int8 alike: at
T = 512 and 64-wide heads the selector takes the packed kernel even without
the frozen fast path). Without a CUDA card the script exits non-zero unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_bench as tb  # noqa: E402

H100_BF16_PEAK_TFLOPS = 989.0
VOCAB = 28996
SEQ = 512
# --small: BERT at 256 tokens x 128 hidden with 2 heads, so the packed
# attention's gate holds
SMALL = {"vocab_size": 2048, "hidden": 128, "layers": 2, "heads": 2, "intermediate": 256, "max_position": 256}
SMALL_SEQ = 256


def bert_fwd_flops(n_chunks: int, t: int = 512, d: int = 768, ff: int = 3072, layers: int = 12) -> float:
    """scripts/bench_bert.py:25-27."""
    per_layer = 4 * t * d * d * 2 + 2 * t * d * ff * 2 + 2 * t * t * d * 2
    return n_chunks * layers * per_layer


def build_encoder(int8: bool, gelu: str, device, small: bool = False):
    """The script's ``BertEncoder(dtype=bf16, int8=int8, gelu=gelu)``,
    seeded with 0, on `device`."""
    from multimodalrouting_tpu_torch.models.clinbert import BertEncoder

    torch.manual_seed(0)
    return BertEncoder(dtype=torch.bfloat16, int8=int8, gelu=gelu, **(SMALL if small else {})).to(device).eval()


def inputs(n: int, device, vocab: int = VOCAB, seq: int = SEQ):
    """Token ids from ``default_rng(0)`` and an all-ones mask."""
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, vocab, size=(n, seq)), dtype=torch.int32, device=device)
    return ids, torch.ones((n, seq), dtype=torch.float32, device=device)


def run_bert(n: int, steps: int, int8: bool, gelu: str, device, small: bool = False) -> dict:
    """One warm-up forward, then `steps` timed. -> ms per forward, TFLOP/s,
    MFU (%), the launches of the first forward and the last CLS row."""
    enc = build_encoder(int8, gelu, device, small)
    seq = SMALL_SEQ if small else SEQ
    ids, attn = inputs(n, device, SMALL["vocab_size"] if small else VOCAB, seq)

    def fwd():
        return enc(ids, attn)[:, 0].float()

    with torch.inference_mode():
        before = tb.launch_counts()
        out = fwd()
        float(out[0, 0])
        launches = tb.counts_since(before)
        acc = torch.zeros((), dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fwd()
            acc = acc + out[0, 0]
        float(acc)
        dt = (time.perf_counter() - t0) / steps
    dims = ({"t": seq, "d": SMALL["hidden"], "ff": SMALL["intermediate"], "layers": SMALL["layers"]}
            if small else {})
    tflops = bert_fwd_flops(n, **dims) / dt / 1e12
    return {"ms": dt * 1e3, "tflops": tflops, "mfu_pct": 100 * tflops / H100_BF16_PEAK_TFLOPS,
            "launches": launches, "cls": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="tiny widths for the CPU")
    args = ap.parse_args(argv)
    device = tb.bench_device(args.device)
    tb.log_environment(device)
    n = int(os.environ.get("BENCH_BERT_N", "128"))
    steps = int(os.environ.get("BENCH_BERT_STEPS", "10"))
    int8 = os.environ.get("BENCH_BERT_INT8", "0") == "1"
    gelu = os.environ.get("BENCH_GELU", "poly")
    res = run_bert(n, steps, int8, gelu, device, args.small)
    tb.log(f"[bench_bert] launches of one forward: {json.dumps(res['launches'])}; GELU {gelu}; "
           f"{res['ms']:.3f} ms/fwd, {res['tflops']:.2f} TFLOP/s")
    tb.log(
        f"[bench_bert] n={n} int8={int(int8)} flash={os.environ.get('MMR_FLASH', '1')}: "
        f"{res['ms']:.1f} ms/fwd  {res['tflops']:.1f} TFLOP/s  "
        f"MFU={res['mfu_pct']:.1f}% (H100 bf16 dense peak {H100_BF16_PEAK_TFLOPS:.0f} TFLOP/s)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
