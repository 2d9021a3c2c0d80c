"""Times of the port's RMSNorm backward on the card at the training
shapes, split into its row pass and its dw pass, beside the plain VJP
and autograd of ``F.rms_norm`` on the same inputs.

    PYTHONPATH=src python3 scripts/norm_bwd_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the
wrapper's public functions, so the same script times two trees of the
package in one run (an older tree unpacked beside this one, then this
one; compare only within one call, on one card).

Shapes: mamba2-2.7b's block and final norms (2048 x 2560) and its gated
norm (2048 x 5120) at ``chip_smoke.py`` phase 18's 4 x 512 tokens, and a
rows-route shape (4096 x 1024); bf16 x and dy, a float32 weight, eps
1e-5 and ``weight_offset`` 1 as the model calls them.  Each shape is
checked first: dx and dw against ``ref.rmsnorm_vjp`` (float32 rtol 2e-5
plus 1e-5 of the leaf's largest entry, 2^-8 of the magnitudes more for
a bf16 result: the share of that bound used is printed), two calls equal
bit for bit.  Then the median of 15 replays of a CUDA graph of 20 calls:
warm (the same inputs every call, so x and dy partly stay in the 50 MB
L2, as ``chip_smoke.py``'s kernels line times them) and cold (the calls
cycle over copies of the inputs whose bytes exceed twice the L2); the
plain VJP's time; autograd of ``F.rms_norm`` (its weight w + 1 in bf16,
so that PyTorch's own norm kernels run): forward and backward in one
captured call, less the forward alone; and, as a yardstick of the rate
the card reaches on the same traffic, ``torch.add(x, dy, out=)`` warm and
cold (two bf16 reads and a bf16 write).  Then 5 warm calls under
``torch.profiler``: device µs a call by kernel (the row pass and the dw
pass).  Bound: x and dy read, dx written once in bf16, w read and dw
written once in float32, at 3.35 TB/s.  Prints one JSON line and the
card's name and power limit.
"""

import argparse
import itertools
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
SHAPES = [(2048, 2560), (2048, 5120), (4096, 1024)]
EPS, OFFSET = 1e-5, 1.0
RTOL, FRAC = 2e-5, 1e-5


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


def cold(fn, *args):
    """``fn`` as a call of no arguments cycling over copies of ``args``
    whose bytes together exceed twice the L2."""
    n_bytes = sum(a.numel() * a.element_size() for a in args)
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(-(-2 * L2_BYTES // n_bytes))]
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def bound_used(got, want) -> float:
    g, w = got.float(), want.float()
    bound = RTOL * w.abs() + FRAC * float(w.abs().max()) + 1e-30
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (g.abs() + w.abs())
    return float(((g - w).abs() / bound).max())


def by_kernel(fn, calls: int = 5) -> dict:
    """Device µs a call by kernel name.  A short window at times comes back
    without its kernels' records, so up to 5 windows are taken, until both
    passes (``rmsnorm_bwd*``, ``rmsnorm_dw*``) are seen."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us > 0:
                out[ev.key[:90]] = us / calls
        if all(any(name in k for k in out) for name in ("rmsnorm_bwd", "rmsnorm_dw")):
            break
    return out


def shape_times(gen, rows: int, d: int) -> dict:
    x = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    w = 0.1 * torch.randn(d, device="cuda", generator=gen)
    dy = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    call = lambda a, b, c: rk.rmsnorm_bwd(a, b, c, eps=EPS, weight_offset=OFFSET)  # noqa: E731
    got, again = call(x, w, dy), call(x, w, dy)
    want = ref.rmsnorm_vjp(x, w, dy, eps=EPS, weight_offset=OFFSET)
    row = {"route": rk.route(rows, d, x.dtype),
           "bound_used": {n: bound_used(g, v) for n, g, v in zip(("dx", "dw"), got, want)},
           "two_runs_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
    if hasattr(rk, "bwd_plan"):
        row["bwd_plan"] = rk.bwd_plan(rows, d, x.dtype)._asdict()
    row["bound_us"] = (3 * rows * d * 2 + 2 * d * 4) / HBM_BYTES_PER_S * 1e6
    row["kernel_us"] = median_us(lambda: call(x, w, dy))
    row["kernel_cold_us"] = median_us(cold(call, x, w, dy))
    row["plain_us"] = median_us(lambda: ref.rmsnorm_vjp(x, w, dy, eps=EPS, weight_offset=OFFSET),
                                inner=5, reps=5)
    xl = x.detach().requires_grad_()
    wl = (w + OFFSET).bfloat16().requires_grad_()

    def lib_fwd():
        return F.rms_norm(xl, (d,), weight=wl, eps=EPS)

    def lib_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lib_fwd(), (xl, wl), dy)

    fwd_bwd = median_us(lib_fwd_bwd)
    with torch.no_grad():
        fwd = median_us(lib_fwd)
    row["library_fwd_bwd_us"], row["library_fwd_us"] = fwd_bwd, fwd
    row["library_bwd_us"] = fwd_bwd - fwd
    # the same bytes through one PyTorch elementwise kernel: x and dy read,
    # their sum written in bf16
    out = torch.empty_like(x)
    row["same_bytes_add_us"] = median_us(lambda: torch.add(x, dy, out=out))
    row["same_bytes_add_cold_us"] = median_us(cold(lambda a, b: torch.add(a, b, out=out), x, dy))
    row["device_us_a_call_by_kernel"] = by_kernel(lambda: call(x, w, dy))
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("norm_bwd_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    result = {"tag": args.tag, "dtype": "bfloat16", "eps": EPS, "weight_offset": OFFSET,
              "shapes": {f"{rows}x{d}": shape_times(gen, rows, d) for rows, d in SHAPES}}
    print(json.dumps(result), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
