"""Times of the port's embedding backward on the card at the slice widths
its kernel takes, and of the stable sort before it.

    PYTHONPATH=src python3 scripts/embedding_bwd_times.py

The kernel (``csrc/embedding.cu``) gives a warp one table row and a slice
of ``SLICE_COLS`` columns: wider slices write the rows no id selects with
fewer warps, narrower ones split an id's serial chain (its rows added in
token order) over more warps.  Each slice width of 1024, 512 and 256
columns (the wrapper's module constant, set in turn, the first timed
again at the end) is timed on bf16 dy at qwen1.5-0.5b's step (4096 ids,
D 1024, vocab 151 936) and glm4-9b's (D 4096, vocab 151 552): ids all
distinct, drawn from 16 values, and (qwen's shape) 4096 copies of one
id.  Each call is first held to ``ref.embedding_bwd`` bit for bit.  Time:
the median of 10 replays of a CUDA graph of 5 calls of the wrapper (sort
and kernels), in ms; then the stable sort alone of int64 and of int32 ids.
Prints one JSON object and the card's name and power limit.
"""

import json
import statistics
import subprocess

import torch

from repro_torch.kernels import embedding as ek
from repro_torch.kernels import ref

SLICES = (1024, 512, 256, 1024)


def median_ms(fn, reps: int = 10, inner: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        windows.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / inner for a, b in windows)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("embedding_bwd_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(3)
    T = 4096
    cases = {}
    for name, D, V in (("qwen", 1024, 151936), ("glm4", 4096, 151552)):
        dy = torch.randn(T, D, device="cuda", generator=gen).bfloat16()
        pool = torch.randint(0, V, (16,), device="cuda", generator=gen)
        cases[f"{name}_distinct"] = (dy, torch.randperm(V, device="cuda", generator=gen)[:T], V)
        cases[f"{name}_16_values"] = (
            dy, pool[torch.randint(0, 16, (T,), device="cuda", generator=gen)], V)
        if name == "qwen":
            cases["qwen_one_id"] = (dy, torch.full((T,), 777, device="cuda"), V)
    out = {"ms": {name: {} for name in cases}}
    default = ek.SLICE_COLS
    try:
        for cols in SLICES:
            ek.SLICE_COLS = cols
            for name, (dy, ids, V) in cases.items():
                got = ek.embedding_bwd(dy, ids, V)
                if not same_bits(got, ref.embedding_bwd(dy, ids, V)):
                    raise SystemExit(f"{name} at {cols} columns differs from the plain version")
                out["ms"][name].setdefault(str(cols), []).append(
                    median_ms(lambda: ek.embedding_bwd(dy, ids, V)))
    finally:
        ek.SLICE_COLS = default
    out["default_slice_cols"] = default
    out["sort_ms"] = {}
    for dt in (torch.int64, torch.int32):
        ids = cases["qwen_distinct"][1].to(dt)
        out["sort_ms"][str(dt).split(".")[1]] = median_ms(lambda: torch.sort(ids, stable=True))
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
