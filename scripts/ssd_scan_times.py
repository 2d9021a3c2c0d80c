"""Times of the port's SSD scan kernel on the card at mamba2's and
hymba's served prefill shapes, by bf16 parts and cluster size, with the
share of each check's bound that every variant uses.

    PYTHONPATH=src python3 scripts/ssd_scan_times.py [--tag NAME] [--shape mamba2|hymba]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the
wrapper's public function, so the same script times two trees of the
package in one run (an older tree unpacked beside this one, then this
one; compare only within one call, on one card).  A tree without the
tensor-core route is timed at its defaults only.

Shapes: mamba2's, B 4, S 512, H 80, P 64, G 1, N 128, chunk 128, bf16 x,
B and C as views of one conv output (row stride 5 376), float32 dt, A
and ``init_state``, as ``chip_smoke.py`` phase 8 draws them; hymba's,
B 4, S 640 (128 meta tokens and a 512-token prompt), H 50, P 64, G 1,
N 16, the same way (row stride 3 232), as phase 19 serves it, with and
without ``init_state`` (a prompt's end state), and the CUDA-core kernel
on the same inputs (the route's kernel before the N-16 tensor-core one).
For each variant of the tensor-core kernel -- (G, x o w, h) cut into 1,
2 or 3 bf16 parts, and 1, 2 or 4 CTAs a cluster (1, 2, 3 or 5 at
hymba's 5 chunks) -- the median of 10 replays of
a CUDA graph of 20 calls, and the largest share used of two bounds:
``chip_smoke.py``'s served bf16 bound (y and h against the plain
version), and, on the extreme-decay inputs of ``tests/test_torch_gpu.py``
in bf16, the float32 extreme-decay bound on the state against the plain
version of the same values in float32.  Bound of the call: its bytes
(each input read once, each output written once) at 3.35 TB/s, and its
products at 989 TFLOP/s (bf16 tensor cores) and at 67 TFLOP/s (float32).
Prints one JSON line and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

HBM_BYTES_PER_S, BF16_OPS_PER_S, FP32_OPS_PER_S = 3.35e12, 989e12, 67e12
P, G, CHUNK = 64, 1, 128
#: (B, S, H, N) and the cluster sizes timed
SHAPES = {"mamba2": ((4, 512, 80, 128), (1, 2, 4)), "hymba": ((4, 640, 50, 16), (1, 2, 3, 5))}


def median_us(fn, inner: int = 20, reps: int = 10) -> float:
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


def inputs(kind: str, seed: int, Bsz, S_, H_, N):
    gen = torch.Generator("cuda").manual_seed(seed)
    wide = torch.randn(Bsz, S_, H_ * P + 2 * G * N, device="cuda", generator=gen).bfloat16()
    x = wide[..., :H_ * P].reshape(Bsz, S_, H_, P)
    Bm = wide[..., H_ * P:H_ * P + G * N].reshape(Bsz, S_, G, N)
    C = wide[..., H_ * P + G * N:].reshape(Bsz, S_, G, N)
    if kind == "served":
        dt = torch.nn.functional.softplus(torch.randn(Bsz, S_, H_, device="cuda",
                                                      generator=gen))
        h0 = torch.randn(Bsz, H_, P, N, device="cuda", generator=gen)
    else:
        dt = 1.0 + 0.01 * torch.rand(Bsz, S_, H_, device="cuda", generator=gen)
        h0 = None
    A = torch.full((H_,), -2.718281828, device="cuda")
    return x, dt, A, Bm, C, h0


def served_share(y, h, x, dt, A, Bm, C, h0):
    yp, hp = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=None if h0 is None else h0.abs(), return_state=True)
    tol_y = 2.0 ** -8 * (y.float().abs() + yp.float().abs()) + (2.0 ** -8 + 2.0 ** -10) * yabs
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    return max(float(((y.float() - yp.float()).abs() / tol_y).max()),
               float(((h - hp).abs() / tol_h).max()))


def extreme_share(h, x, dt, A, Bm, C):
    _, hf = ref.ssd_scan(x.float(), dt, A, Bm.float(), C.float(), return_state=True)
    _, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                           return_state=True)
    return float(((h - hf).abs() / (2e-4 * hf.abs() + 3e-5 + 1e-4 * habs)).max())


def cuda_core(x, dt, A, Bm, C, h0):
    """The CUDA-core kernel on the same inputs at chunk 128, through its C
    entry point (as ``chip_smoke.py``'s ``cuda_core_ssd``)."""
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    Bsz, S, H, _ = x.shape
    N = Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    err = load_library("ssd_scan", ssd.SIGNATURES).rt_ssd_scan(
        1, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, S, H, P, G, N,
        CHUNK, *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3],
        stream_arg(x))
    check_launch("ssd_scan", err)
    return y, h


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--shape", choices=sorted(SHAPES), action="append")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_scan_times: needs a CUDA device")
    for shape in args.shape or sorted(SHAPES, reverse=True):
        time_shape(args.tag, shape)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


def time_shape(tag: str, shape: str) -> None:
    (B, S, H, N), clusters = SHAPES[shape]
    served = inputs("served", 0, B, S, H, N)
    extreme = inputs("extreme", 1, 1, S, 2, N)
    n_bytes = (2 * B * S * H * P * 2 + B * S * H * 4 + H * 4 + 2 * B * S * G * N * 2
               + 2 * B * H * P * N * 4)
    lens = [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]
    flops = B * H * sum(n * (n + 1) * (N + P) + 4 * n * N * P for n in lens)
    result = {"tag": tag, "shape": shape,
              "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N},
              "bytes_bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
              "bf16_ops_bound_us": flops / BF16_OPS_PER_S * 1e6,
              "float32_ops_bound_us": flops / FP32_OPS_PER_S * 1e6}

    def call(kw, args_):
        x, dt, A, Bm, C, h0 = args_
        if kw:
            return ssd.ssd_scan_variant(x, dt, A, Bm, C, init_state=h0, **kw)
        return ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=CHUNK, return_state=True)

    variants = {"default": {}}
    route = ssd.route(torch.bfloat16, P, N, CHUNK)
    n16 = route == "wgmma_n16"
    if route in ("wgmma", "wgmma_n16"):
        served_parts = ssd.PARTS_N16 if n16 else ssd.PARTS
        result["parts"], result["route"] = list(served_parts), route
        result["cluster"] = ssd.default_cluster(S, N)
        for parts in (ssd.PARTS_N16_VARIANTS if n16 else ssd.PARTS_VARIANTS):
            for cluster in clusters:
                variants[f"parts{''.join(map(str, parts))}_cluster{cluster}"] = dict(
                    parts=parts, cluster=cluster)
    rows = {}
    for name, kw in variants.items():
        y, h = call(kw, served)
        row = {"us": median_us(lambda: call(kw, served)),
               "served_bound_used": served_share(y, h, *served)}
        if kw:
            row["extreme_decay_state_bound_used"] = extreme_share(call(kw, extreme)[1],
                                                                   *extreme[:5])
        rows[name] = row
    if N == 16:
        # the prefill calls it without an initial state; and the CUDA-core kernel
        bare = served[:5] + (None,)
        rows["default_no_init_state"] = {"us": median_us(lambda: call({}, bare))}
        y, h = cuda_core(*served)
        rows["cuda_core"] = {"us": median_us(lambda: cuda_core(*served)),
                             "served_bound_used": served_share(y, h, *served)}
        rows["cuda_core_no_init_state"] = {"us": median_us(lambda: cuda_core(*bare))}
    result["variants"] = rows
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
