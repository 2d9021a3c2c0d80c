"""Times of the port's ``rmsnorm`` and ``pack_segments`` kernels on the
card, beside ``F.rms_norm`` and ``torch.cat`` on the same inputs.

    PYTHONPATH=src python3 scripts/norm_pack_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH``, so the same script times
two trees of the package in one session (an older tree unpacked
beside this one, then this one; compare only within one call, on one
card).  Shapes: the decode norms of mamba2-2.7b (4 rows of 2560 and
5120) and gemma3-1b (4 of 1152, 16 of 256 for the qk-norm), the prefill
norms (4096 x 1152, 16384 x 256, 2048 x 2560, 2048 x 5120), all bf16
with a float32 weight and ``weight_offset`` 1 as the models call them;
and the first fused Faces transfer (a 128^2 float32 face and eight
edges and corners of 8 ranks).  Each is checked first (the norm within
one bf16 rounding of the plain version, the pack bit for bit) and then
timed: the median of 15 replays of a CUDA graph of 20 calls, warm L2.
Where the package has two norm routes, each prefill shape is also
timed on the team route, through the C entry point.  Prints one JSON
line and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk

DECODE = [(4, 2560), (4, 5120), (4, 1152), (16, 256)]
PREFILL = [(4096, 1152), (16384, 256), (2048, 2560), (2048, 5120)]


def median_us(fn, inner: int = 20, reps: int = 15) -> float:
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
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        windows.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) * 1e3 / inner for a, b in windows)


def team_route(x, w):
    """The team route's launch on ``x``, through the C entry point."""
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    y = torch.empty_like(x)
    err = load_library("rmsnorm", rk.SIGNATURES).rt_rmsnorm(
        1, 0, x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        x.stride(0), 1e-6, 1.0, rk.ROUTES.index("team"), stream_arg(x))
    check_launch("rmsnorm", err)
    return y


def norm_times(gen, shapes):
    out = {}
    for rows, d in shapes:
        x = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
        w = torch.randn(d, device="cuda", generator=gen)
        w1 = (w + 1.0).bfloat16()
        got, want = rk.rmsnorm(x, w, weight_offset=1.0), ref.rmsnorm(x, w, weight_offset=1.0)
        g, v = got.float(), want.float()
        assert bool(((g - v).abs() <= 2.0 ** -8 * (g.abs() + v.abs()) + 1e-6).all()), (rows, d)
        row = {"kernel_us": median_us(lambda: rk.rmsnorm(x, w, weight_offset=1.0)),
               "rms_norm_us": median_us(lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6)),
               "bound_us": (2 * x.numel() * 2 + d * 4) / 3.35e12 * 1e6}
        if hasattr(rk, "route"):
            row["route"] = rk.route(rows, d, x.dtype)
            if row["route"] != "team":
                assert torch.equal(team_route(x, w), got), (rows, d)
                row["team_route_us"] = median_us(lambda: team_route(x, w))
        out[f"{rows}x{d}"] = row
    return out


def pack_times(gen):
    n_ranks = 8
    sizes = [16384] + [128] * 4 + [1] * 4
    sources = [(torch.randn(n_ranks, n, device="cuda", generator=gen), 0) for n in sizes]
    assert torch.equal(hk.pack_segments(sources, sizes), ref.pack_segments(sources, sizes))
    pieces = [s for s, _ in sources]
    return {"members": sizes, "ranks": n_ranks,
            "kernel_us": median_us(lambda: hk.pack_segments(sources, sizes)),
            "cat_us": median_us(lambda: torch.cat(pieces, dim=1)),
            "bound_us": 2 * n_ranks * sum(sizes) * 4 / 3.35e12 * 1e6}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("norm_pack_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    result = {"tag": args.tag, "decode": norm_times(gen, DECODE),
              "prefill": norm_times(gen, PREFILL), "pack_segments": pack_times(gen)}
    print(json.dumps(result), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
