"""Rows a CTA of the rmsnorm kernel's team route normalises at once when
there are many (``kTeamRows`` of ``csrc/rmsnorm.cu``: 2 as committed,
against 4 and 1), on the card.

    python3 scripts/rmsnorm_team_variants.py

Copies ``src/repro_torch`` into ``src/repro_torch/kernels/build/
team_variants/<name>/`` (ignored by git) with ``kTeamRows`` set per
variant, then, in a process of its own per variant and in turns (each
variant, then all again in reverse order), times the norm: the median
of 15 replays of a CUDA graph of 20 launches, bf16 x over a float32
weight, ``weight_offset`` 1, on mamba2-2.7b's prefill norms (2048 rows
of 2560 and 5120, the team route's many-rows case) and its decode norm
(4 x 5120, which launches one row a CTA in every variant).  Each
variant's outputs must equal the committed tree's bit for bit (the
variants change how many rows are in flight, not the arithmetic).
Prints one JSON line per run (with the team kernels' ptxas register
counts) and the card's name and power limit.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
WORK = os.path.join(SRC, "repro_torch", "kernels", "build", "team_variants")
SHAPES = [(2048, 5120), (2048, 2560), (4, 5120)]
VARIANTS = {"rows_2": None, "rows_4": "4", "rows_1": "1"}   # kTeamRows

CHILD = r'''
import json, statistics, sys, torch
from repro_torch.kernels import build, rmsnorm as rk
name, shapes = sys.argv[1], eval(sys.argv[2])
log = build.build_all(["rmsnorm"])["rmsnorm"].log.splitlines()
regs = sorted({l.split("Used ")[1].split(" registers")[0] for i, l in enumerate(log)
               if "registers" in l and any("team_kernel" in m for m in log[max(0, i - 3):i])})

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

out = {"variant": name, "team_registers": regs}
g = torch.Generator("cuda").manual_seed(0)
for rows, d in shapes:
    x = torch.randn(rows, d, device="cuda", generator=g).bfloat16()
    w = torch.randn(d, device="cuda", generator=g)
    assert rk.route(rows, d, x.dtype) == "team"
    y = rk.rmsnorm(x, w, weight_offset=1.0)
    torch.save(y.cpu(), f"{sys.argv[3]}/{rows}x{d}.{name}.pt")
    out[f"{rows}x{d}_us"] = median_us(lambda: rk.rmsnorm(x, w, weight_offset=1.0))
print(json.dumps(out), flush=True)
'''


def variant_copy(name: str, rows: str) -> str:
    """The package with ``kTeamRows = rows``."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(SRC, "repro_torch"), os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, "repro_torch", "kernels", "csrc", "rmsnorm.cu")
    text = open(path).read()
    old = "constexpr int kTeamRows = 2;"
    if text.count(old) != 1:
        raise SystemExit(f"rmsnorm_team_variants: {old!r} not found once in {path}")
    with open(path, "w") as f:
        f.write(text.replace(old, f"constexpr int kTeamRows = {rows};"))
    return dst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_team_variants: no CUDA device", file=sys.stderr)
        return 2
    paths = {n: SRC if k is None else variant_copy(n, k) for n, k in VARIANTS.items()}
    outputs = os.path.join(WORK, "outputs")
    os.makedirs(outputs, exist_ok=True)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for name in order:
        env = dict(os.environ, PYTHONPATH=paths[name])
        subprocess.run([sys.executable, "-c", CHILD, name, repr(SHAPES), outputs], env=env,
                       check=True)
    for rows, d in SHAPES:
        want = torch.load(os.path.join(outputs, f"{rows}x{d}.rows_2.pt"))
        for name in VARIANTS:
            got = torch.load(os.path.join(outputs, f"{rows}x{d}.{name}.pt"))
            if not torch.equal(got, want):
                raise SystemExit(f"rmsnorm_team_variants: {name} differs at {rows}x{d}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print("variants equal bit for bit")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
