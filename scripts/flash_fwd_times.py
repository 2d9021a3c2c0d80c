"""Times of the port's flash-attention forward as serving calls it, at
gemma3-1b's global and local layers, so that two trees of the package
can be compared on one card.

    PYTHONPATH=src python3 scripts/flash_fwd_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the public
wrapper ``flash_attention`` under ``torch.no_grad`` (serving's call: no
row log-sum-exp asked for), so the same script times two trees in one
run (an older tree unpacked beside this one, then this one; compare only
within one call, on one card, in the order parent, change, change,
parent).

Shapes: B 4, 4 query heads and 1 kv head of 256, S 1024, bf16, causal,
the local layer with the window of 512; q, k, v are ``[B,S,H,D]``
tensors passed as ``[B,H,S,D]`` views, as the model passes them.  For
each: the route the wrapper took and its launches a call, a SHA-256 of
the output's bits (equal digests: the two trees give the same output),
and the median of 15 replays of a CUDA graph of 20 calls (warm: the same
inputs every call).  Prints one JSON line and the card's name and power
limit.
"""

import argparse
import hashlib
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import flash_attention as fk

B, HQ, HKV, S, D = 4, 4, 1, 1024, 256
LAYERS = {"global": None, "local": 512}


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


def layer_times(gen, window) -> dict:
    def mk(H):
        return torch.randn(B, S, H, D, device="cuda", generator=gen).bfloat16().transpose(1, 2)

    q, k, v = mk(HQ), mk(HKV), mk(HKV)
    call = lambda: fk.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
    before = dict(fk.launch_counts())
    out = call()
    torch.cuda.synchronize()
    after = fk.launch_counts()
    launched = {key: after[key] - before.get(key, 0) for key in after
                if after[key] != before.get(key, 0)}
    bits = out.contiguous().view(torch.int16).cpu().numpy().tobytes()
    return {"window": window, "launches_a_call": launched,
            "out_sha256": hashlib.sha256(bits).hexdigest(), "us": median_us(call)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        layers = {name: layer_times(gen, window) for name, window in LAYERS.items()}
    print(json.dumps({"tag": args.tag, "shape": [B, HQ, HKV, S, D], "dtype": "bfloat16",
                      "layers": layers}), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
