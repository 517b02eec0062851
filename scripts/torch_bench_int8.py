"""bf16 against int8 matmul throughput on the card, and a prototype
dynamically quantized Dense (per-token activation scales x per-channel
weight scales -> int8 product -> fp32 dequantization), to size the
frozen-BERT int8 win: scripts/bench_int8.py's measurement through the
PyTorch port.

    python3 scripts/torch_bench_int8.py                        # on the CUDA card
    python3 scripts/torch_bench_int8.py --device cpu --small   # small shapes on the CPU

One [65536, 768] x [768, 768] product (a BERT q/k/v-like matmul over 128 x
512 tokens), timed three ways, each as one warm-up call and a readback, then
20 calls closed by a readback (on the card that readback waits for the
device):

  bf16                 ``torch.matmul`` of bf16 operands (the JAX script's ``jnp.dot``)
  int8-pre             the port's ``ops/quant.int8_matmul`` of operands quantized
                       once, in numpy, against each one's largest magnitude
  int8-dynamic-dense   ``quant_dense`` below, from fp32 operands

then the dynamic dense's relative error against the fp32 product (mean and
99th percentile), with the JAX script's lines and names. ``quant_dense`` is
that script's prototype as written there: the weight is [k, n] (not the
port's ``Dense`` layout, [out, in]), the scales have no epsilon, and
``torch.round`` rounds half to even as ``jnp.round`` does. The first line
gives the card's name and power limit. Without a CUDA card the script exits
non-zero unless given ``--device cpu``; ``--small`` takes a [512, 128] x
[128, 128] product (``torch._int_mm`` wants m > 16 and k, n multiples of 8).
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

M, K, N = 65536, 768, 768  # one BERT qkv-like matmul over 128x512 tokens
SMALL_MKN = (512, 128, 128)
STEPS = 20


def readback(out: torch.Tensor) -> None:
    np.asarray(out[..., :1, :1].float().cpu())


def timeit(fn, *args, steps: int = STEPS) -> float:
    """Seconds per call of fn(*args): one warm-up call, then `steps`."""
    readback(fn(*args))
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    readback(out)
    return (time.perf_counter() - t0) / steps


def quant_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dynamic per-token activation quantization times per-channel weight
    quantization: x [m, k] and w [k, n] in fp32 -> [m, n] bf16."""
    from multimodalrouting_tpu_torch.ops.quant import int8_matmul

    s_x = x.abs().amax(dim=1, keepdim=True) / 127.0
    s_w = w.abs().amax(dim=0, keepdim=True) / 127.0
    xq = torch.round(x / s_x).to(torch.int8)
    wq = torch.round(w / s_w).to(torch.int8)
    acc = int8_matmul(xq, wq)
    return (acc.float() * s_x * s_w).to(torch.bfloat16)


def operands(m: int, k: int, n: int):
    """The script's fp32 operands from ``default_rng(0)`` and their int8
    copies quantized against each one's largest magnitude."""
    rng = np.random.default_rng(0)
    x32 = rng.standard_normal((m, k)).astype(np.float32)
    w32 = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    xq = np.clip(np.round(x32 / np.abs(x32).max() * 127), -127, 127).astype(np.int8)
    wq = np.clip(np.round(w32 / np.abs(w32).max() * 127), -127, 127).astype(np.int8)
    return x32, w32, xq, wq


def run_int8(m: int, k: int, n: int, device, steps: int = STEPS) -> dict:
    """The three timings (s per call) and the dynamic dense's relative
    error against fp32 (mean, p99)."""
    from multimodalrouting_tpu_torch.ops.quant import int8_matmul

    x32, w32, xq, wq = operands(m, k, n)
    x, w = torch.from_numpy(x32).to(device), torch.from_numpy(w32).to(device)
    cases = (
        ("bf16", torch.matmul, (x.bfloat16(), w.bfloat16())),
        ("int8-pre", int8_matmul, (torch.from_numpy(xq).to(device), torch.from_numpy(wq).to(device))),
        ("int8-dynamic-dense", quant_dense, (x, w)),
    )
    times = {name: timeit(fn, *args, steps=steps) for name, fn, args in cases}
    ref = x32 @ w32
    got = quant_dense(x, w).float().cpu().numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-6)
    return {"seconds": times, "rel_mean": float(rel.mean()), "rel_p99": float(np.quantile(rel, 0.99))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="a small product for the CPU")
    args = ap.parse_args(argv)
    device = tb.bench_device(args.device)
    tb.log_environment(device)
    m, k, n = SMALL_MKN if args.small else (M, K, N)
    res = run_int8(m, k, n, device)
    fl = 2 * m * k * n
    tb.log(f"[bench_int8] [{m}, {k}] x [{k}, {n}], ms per call: "
           f"{json.dumps({name: dt * 1e3 for name, dt in res['seconds'].items()})}")
    for name, dt in res["seconds"].items():
        tb.log(f"[bench_int8] {name}: {dt * 1e3:.2f} ms  {fl / dt / 1e12:.1f} T(FL)OP/s")
    tb.log(f"[bench_int8] dynamic dense rel err: mean={res['rel_mean']:.4f} p99={res['rel_p99']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
