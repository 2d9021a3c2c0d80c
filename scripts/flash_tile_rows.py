"""Rows of a block in the tensor-core flash kernel: 128 (two consumer
warpgroups, the kernel as committed) against 64 (one), on the card.

    python3 scripts/flash_tile_rows.py

Copies ``src/repro_torch`` into ``src/repro_torch/kernels/build/
tile_rows/`` (ignored by git) with ``kWG = 1`` in
``csrc/flash_attention.cu``, then times each version in a process of its
own, in turns 128, 64, 64, 128, at gemma3-1b's served prefill shape (B
4, Hq 4, Hkv 1, S 1024, D 256 bf16, random inputs from seed 0) on a
global (causal) and a local (window 512) layer: the median of 15 replays
of a CUDA graph of 20 launches, after a check against the plain version
(one bf16 rounding).  Prints one JSON line per run and the card's name
and power limit.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
WORK = os.path.join(SRC, "repro_torch", "kernels", "build", "tile_rows")

CHILD = r'''
import json, statistics, sys, torch
from repro_torch.kernels import flash_attention as fk, ref
g = torch.Generator("cuda").manual_seed(0)
B, S, D = 4, 1024, 256
q, k, v = (torch.randn(B, S, h, D, device="cuda", generator=g).bfloat16().transpose(1, 2)
           for h in (4, 1, 1))

def median_us(fn, inner=20, reps=15):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / inner)
    return statistics.median(times)

out = {"rows": int(sys.argv[1])}
for name, window in (("global_us", None), ("local_us", 512)):
    got, want = fk.flash_attention(q, k, v, window=window), ref.attention(q, k, v, window=window)
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -8 * (got.float().abs() + want.float().abs()) + 1e-6).all())
    out[name] = median_us(lambda: fk.flash_attention(q, k, v, window=window))
print(json.dumps(out), flush=True)
'''


def one_warpgroup_copy() -> str:
    """The package with one consumer warpgroup (64-row blocks)."""
    dst = os.path.join(WORK, "src")
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(SRC, "repro_torch"), os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, "repro_torch", "kernels", "csrc", "flash_attention.cu")
    text = open(path).read()
    old = "constexpr int kWG = 2;"
    if text.count(old) != 1:
        raise SystemExit(f"flash_tile_rows: {old!r} not found once in {path}")
    with open(path, "w") as f:
        f.write(text.replace(old, "constexpr int kWG = 1;"))
    return dst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_tile_rows: no CUDA device", file=sys.stderr)
        return 2
    paths = {128: SRC, 64: one_warpgroup_copy()}
    for rows in (128, 64, 64, 128):
        env = dict(os.environ, PYTHONPATH=paths[rows])
        subprocess.run([sys.executable, "-c", CHILD, str(rows)], env=env, check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
