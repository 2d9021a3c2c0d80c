"""Times of the port's SSD scan kernel on the card at mamba2's served
prefill shapes, by bf16 parts and cluster size, with the share of each
check's bound that every variant uses.

    PYTHONPATH=src python3 scripts/ssd_scan_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the
wrapper's public function, so the same script times two trees of the
package in one run (an older tree unpacked beside this one, then this
one; compare only within one call, on one card).  A tree without the
tensor-core route is timed at its defaults only.

Shapes: B 4, S 512, H 80, P 64, G 1, N 128, chunk 128, bf16 x, B and C
as views of one conv output (row stride 5 376), float32 dt, A and
``init_state``, as ``chip_smoke.py`` phase 8 draws them.  For each
variant of the tensor-core kernel -- (G, x o w, h) cut into 1, 2 or 3
bf16 parts, and 1, 2 or 4 CTAs a cluster -- the median of 10 replays of
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
B, S, H, P, G, N, CHUNK = 4, 512, 80, 64, 1, 128, 128


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


def inputs(kind: str, seed: int, Bsz=B, S_=S, H_=H):
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_scan_times: needs a CUDA device")
    served = inputs("served", 0)
    extreme = inputs("extreme", 1, 1, S, 2)
    n_bytes = (2 * B * S * H * P * 2 + B * S * H * 4 + H * 4 + 2 * B * S * G * N * 2
               + 2 * B * H * P * N * 4)
    flops = B * H * (S // CHUNK) * (CHUNK * (CHUNK + 1) * (N + P) + 4 * CHUNK * N * P)
    result = {"tag": args.tag, "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N},
              "bytes_bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
              "bf16_ops_bound_us": flops / BF16_OPS_PER_S * 1e6,
              "float32_ops_bound_us": flops / FP32_OPS_PER_S * 1e6}

    def call(kw, args_):
        x, dt, A, Bm, C, h0 = args_
        if kw:
            return ssd.ssd_scan_variant(x, dt, A, Bm, C, init_state=h0, **kw)
        return ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=CHUNK, return_state=True)

    variants = {"default": {}}
    if hasattr(ssd, "PARTS_VARIANTS"):
        result["parts"], result["route"] = list(ssd.PARTS), ssd.route(torch.bfloat16, P, N,
                                                                       CHUNK)
        for parts in ssd.PARTS_VARIANTS:
            for cluster in (1, 2, 4):
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
    result["variants"] = rows
    print(json.dumps(result), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
