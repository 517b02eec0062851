#!/usr/bin/env python3
"""Where one K3 launch spends its time: SM clock (clock64) readings of CTA 0
at the boundaries of the kernel's phases, on an NVIDIA GPU.

    python3 scripts/k3_phase_clocks.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It copies multimodalrouting_tpu_torch/csrc/ to
build/k3_phase_clocks/ (git-ignored), inserts clock readings into the copy
of capsule_routing.cu at each phase boundary (the marks below), builds that
copy, launches it at both heads (B = 1 and 16, fp32 and bf16 inputs) and
prints, per launch, each phase's cycles as CTA 0 saw them. CTA 0 routes
batch row 0, so the routing phases are a row owner's. The readings are
written over the first values of pose_out; the timed source is otherwise
the kernel as built by the package, so its phases are the package's. The
profiler has no per-phase view of one kernel and `ncu` does not run on
the card's machine: this is the breakdown PERF.md quotes for K3.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import K3_HEADS, k3_inputs  # noqa: E402
from multimodalrouting_tpu_torch.ops import hopper  # noqa: E402
from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused  # noqa: E402

# (phase that ends at the mark, text of the source the mark goes before)
MARKS = (
    ("stage pose and acts", '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'),
    ("wait for the cluster", "  // ---- votes of (row, route n in g, label m in h)"),
    ("votes, pushed to the row owners", "  cluster.sync();  // every vote is in its row's CTA"),
    ("cluster barrier", "  // ---- routing of this CTA's own rows"),
    ("seed and agreement 1", "    // softmax over M: a group of L lanes"),
    ("softmax 1", "    for (int e = tid; e < own * md4; e += kThreads) {  // decision pose"),
)
END = "  // ---- outputs of the own rows\n"


def instrumented_source(src: str) -> str:
    """The kernel with a clock reading at its start, before each of MARKS
    (the last two repeat in every iteration), before the outputs and at its
    end, where CTA 0's thread 0 writes the readings over pose_out."""
    head = "  const int RP = p.rows_pad;\n"
    kernel_end = "}\n\n__global__ void capsule_routing_empty_kernel"
    for text in (head, END, kernel_end) + tuple(t for _, t in MARKS):
        assert src.count(text) == 1, text
    out = src.replace(head, head + "  long long tk[32];\n  int nk = 0;\n"
                      "#define MARK if (tid == 0 && nk < 32) tk[nk++] = clock64();\n  MARK\n")
    for _, text in MARKS + (("outputs", END),):
        out = out.replace(text, "  MARK\n" + text)
    return out.replace(kernel_end, "  MARK\n  __syncthreads();\n  if (blockIdx.x == 0 && tid == 0)\n"
                       "    for (int k = 1; k < nk; ++k) pose_out[k - 1] = (float)(tk[k] - tk[0]);\n" + kernel_end)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_phase_clocks: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    alt = os.path.join(ROOT, "build", "k3_phase_clocks")
    shutil.rmtree(alt, ignore_errors=True)
    shutil.copytree(hopper.CSRC_DIR, alt)
    path = os.path.join(alt, "capsule_routing.cu")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(instrumented_source(src))
    hopper.CSRC_DIR = alt
    hopper._LIBS.clear()
    hopper.build(("capsule_routing",))
    dev = torch.device("cuda")
    names = [name for name, _ in MARKS]
    for head in K3_HEADS:
        for b in (1, 16):
            for dtype in (torch.float32, torch.bfloat16):
                pose, act, w = k3_inputs(b, head, dtype, dev)
                with torch.no_grad():
                    for _ in range(3):  # the last of three back-to-back launches
                        out = capsule_routing_fused(pose, act, w, 3)[0]
                torch.cuda.synchronize()
                # cumulative readings: the 6 marks, then per later iteration (decision
                # pose + agreement, softmax), the last decision pose, the outputs
                ticks = out.flatten()[: len(names) + 2 * 2 + 2].tolist()
                steps = [t - (ticks[i - 1] if i else 0.0) for i, t in enumerate(ticks)]
                phases = dict(zip(names, steps))
                iters = steps[len(names):]
                total = ticks[-1]
                print(f"[k3-phases] {head} B={b} {str(dtype)[6:]}: total {total:.0f} cycles; "
                      + ", ".join(f"{n} {c:.0f}" for n, c in phases.items())
                      + "; then " + " / ".join(f"{c:.0f}" for c in iters), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
