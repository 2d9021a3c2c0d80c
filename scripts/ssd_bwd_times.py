"""Times of the port's SSD scan backward on the card at mamba2's and
hymba's training shapes, by kernel, bf16 parts and cluster size, with
the share of the gradient bound that every variant uses.

    PYTHONPATH=src python3 scripts/ssd_bwd_times.py [--tag NAME] [--shape mamba2|hymba]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the
wrapper's public functions, so the same script times two trees of the
package in one run (an older tree unpacked beside this one, then this
one; compare only within one call, on one card).  A tree without the
tensor-core backward is timed at its default only.

Shapes: mamba2's, B 4, S 512, H 80, P 64, G 1, N 128, bf16 x, B and C
as views of one conv output (row stride 5 376), float32 dt and A, a bf16
dy and no dh or init_state, as the model's backward calls it
(``chip_smoke.py`` phase 18); hymba's, B 4, S 640 (128 meta tokens and
512 tokens), H 50, P 64, G 1, N 16, the same way (phase 24).  For the
default call, the CUDA-core kernel on the same inputs, and variants of
the tensor-core kernel -- its operands cut into 1 or 2 bf16 parts; 1 or
2 CTAs a cluster (1, 2 or 3 of hymba's 5 chunks; fewer CTAs than chunks
walk groups of chunks) -- the median of 10 replays of a CUDA graph of 5
calls, and the largest share of the gradient bound
(``chip_smoke.py``'s GRAD_RTOL 2e-4 plus GRAD_FRAC 2e-5 of the leaf's
largest entry, 2^-8 of the magnitudes more for a bf16 result) used
against the plain VJP of the widened inputs.  Then one default call
under ``torch.profiler``: device µs by kernel (the main kernel and the
group and batch sums).  Bound of the call: its bytes (each input read
once, each output written once) at 3.35 TB/s, and its products, each
counted once at the sub-chunk of 16 to 128 rows that needs the fewest,
at 989 TFLOP/s (bf16 tensor cores); beside them the products the kernel
computes at its 128-row chunks (with its duplicate scores C B^T and
dy x^T).  Prints one JSON line and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12
P, G = 64, 1
#: (B, S, H, N) and the cluster sizes timed beside the default
SHAPES = {"mamba2": ((4, 512, 80, 128), (1, 2)), "hymba": ((4, 640, 50, 16), (1, 2, 3))}
GRAD_RTOL, GRAD_FRAC = 2e-4, 2e-5


def products(B: int, S: int, H: int, N: int, L: int, scores: int) -> int:
    """Operations at sub-chunks of L rows (S a multiple of L): over the
    causal triangle ``scores`` products of width N and scores - 1 of
    width P (3: the function's B C^T, x dy^T and their three products; 4:
    the kernel's, with C B^T and dy x^T too), the five L P N state
    products and U.H0's P N."""
    tri = L * (L + 1) // 2 * (scores * N + (scores - 1) * P)
    return 2 * B * H * (S // L) * (tri + 5 * L * P * N + P * N)


def median_us(fn, inner: int = 5, reps: int = 10) -> float:
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


def inputs(seed: int, B: int, S: int, H: int, N: int):
    gen = torch.Generator("cuda").manual_seed(seed)
    wide = torch.randn(B, S, H * P + 2 * G * N, device="cuda", generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
    A = torch.full((H,), -2.718281828, device="cuda")
    dy = torch.randn(B, S, H, P, device="cuda", generator=gen).bfloat16()
    return x, dt, A, Bm, C, dy


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--shape", choices=sorted(SHAPES), action="append")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_times: needs a CUDA device")
    for shape in args.shape or sorted(SHAPES, reverse=True):
        time_shape(args.tag, shape)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


def time_shape(tag: str, shape: str) -> None:
    (B, S, H, N), clusters = SHAPES[shape]
    x, dt, A, Bm, C, dy = inputs(0, B, S, H, N)
    n_bytes = 3 * B * S * H * P * 2 + 2 * B * S * H * 4 + 2 * H * 4 + 4 * B * S * G * N * 2
    flops = min(products(B, S, H, N, L, 3) for L in (16, 32, 64, 128))
    result = {"tag": tag, "shape": shape,
              "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N},
              "bytes_bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
              "bf16_ops_bound_us": flops / BF16_OPS_PER_S * 1e6,
              "kernel_bf16_ops_us": products(B, S, H, N, 128, 4) / BF16_OPS_PER_S * 1e6}
    want = ref.ssd_scan_vjp(x.float(), dt, A, Bm.float(), C.float(), None, dy.float(), None)
    bf16_out = (True, False, False, True, True)  # dx, ddt, dA, dB, dC

    def share(got) -> float:
        worst = 0.0
        for g, w, bf in zip(got, want, bf16_out):
            gf, wf = g.float(), w.float()
            bound = GRAD_RTOL * wf.abs() + GRAD_FRAC * float(wf.abs().max()) + 1e-30
            if bf:
                bound = bound + 2.0 ** -8 * (gf.abs() + wf.abs())
            worst = max(worst, float(((gf - wf).abs() / bound).max()))
        return worst

    calls = {"default": lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy)}
    route = ssd.bwd_route(torch.bfloat16, P, N)
    if route in ("wgmma", "wgmma_n16"):
        n16 = route == "wgmma_n16"
        served = ssd.BWD_PARTS_N16 if n16 else ssd.BWD_PARTS
        result["parts"], result["route"] = list(served), route
        calls["cuda_core"] = lambda: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy,
                                                              kernel="cuda_core")
        kws = [dict(parts=parts, cluster=ssd.max_cluster(S))
               for parts in (ssd.BWD_PARTS_N16_VARIANTS if n16 else ssd.BWD_PARTS_VARIANTS)]
        kws += [dict(parts=served, cluster=cluster) for cluster in clusters]
        for kw in kws:
            name = "_".join(f"{k}{''.join(map(str, v)) if k == 'parts' else v}"
                            for k, v in kw.items())
            calls[name] = lambda kw=kw: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy, **kw)
    rows = {}
    for name, fn in calls.items():
        rows[name] = {"bound_used": share(fn()[:5]), "us": median_us(fn)}
    result["variants"] = rows

    from torch.profiler import ProfilerActivity, profile
    calls["default"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            calls["default"]()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            by_kernel[ev.key[:80]] = us / 5
    result["device_us_a_call_by_kernel"] = by_kernel
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
