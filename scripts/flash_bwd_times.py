"""Times of the port's flash-attention backward at the training shapes,
the route the wrapper takes beside the CUDA-core backward on the same
inputs, so that two trees of the package can be compared on one card.

    PYTHONPATH=src python3 scripts/flash_bwd_times.py [--tag NAME] [--check]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls the public
wrappers ``forward_with_lse`` and ``flash_attention_bwd``, and the
CUDA-core backward through its C entry point ``rt_flash_attention_bwd``,
so the same script times two trees in one run (an older tree unpacked
beside this one, then this one; compare only within one call, on one
card, in the order parent, change, change, parent).

Shapes (bf16, q, k, v and dO ``[B,S,H,D]`` tensors passed as ``[B,H,S,D]``
views, as the model passes them): gemma3-1b's global and local layers (B
4, 4 query heads and 1 kv head of 256, S 1024, causal; the window of 512),
grok-1's soft-capped GQA (48 / 8 heads of 128, S 256, cap 30) and
deepseek-v3's MLA pair (16 heads, q / k 192, v 128, S 512).  For each: the
route and the backward's launches a call, a SHA-256 of the gradients'
bits, the median of 15 replays of a CUDA graph of 5 calls (warm: the
same inputs every call) of the wrapper and of the CUDA-core backward, and
the wrapper's device time by kernel (``torch.profiler``, eager calls).
With ``--check``, each shape and a few ragged ones are also held against
``ref.attention_vjp`` within ``chip_smoke.py``'s gradient bound (rtol 2e-4
plus 2e-5 of the leaf's largest entry plus 2^-8 of the magnitudes), and
two calls must give the same bits.  Prints one JSON line and the card's
name and power limit.
"""

import argparse
import hashlib
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, load_library, stream_arg

#: (name, B, Hq, Hkv, Sq, Skv, D, Dv, keywords)
SHAPES = (
    ("gemma3_global", 4, 4, 1, 1024, 1024, 256, 256, {}),
    ("gemma3_local", 4, 4, 1, 1024, 1024, 256, 256, {"window": 512}),
    ("grok_softcap_gqa", 1, 48, 8, 256, 256, 128, 128,
     {"logit_softcap": 30.0, "scale": 0.08838834764831845}),
    ("mla_192_128", 1, 16, 16, 512, 512, 192, 128, {"scale": 192 ** -0.5}),
)
#: ragged and masked shapes held to the bound with --check
CHECKS = (
    ("ragged_d64", 2, 4, 4, 70, 100, 64, 64, {"causal": False}),
    ("ragged_gqa6", 1, 12, 2, 150, 150, 128, 128, {"window": 40, "logit_softcap": 15.0}),
    ("no_key_rows", 1, 8, 2, 200, 200, 128, 128, {"q_offset": -40, "window": 100}),
    ("mla_q_offset", 1, 4, 2, 80, 200, 192, 128, {"q_offset": 120}),
    ("d256_ragged", 1, 4, 1, 130, 130, 256, 256, {"window": 64}),
)
GRAD_RTOL, GRAD_FRAC = 2e-4, 2e-5


def median_us(fn, inner: int = 5, reps: int = 15) -> float:
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


def inputs(gen, B, Hq, Hkv, Sq, Skv, D, Dv):
    def mk(S, H, d):
        return torch.randn(B, S, H, d, device="cuda", generator=gen).bfloat16().transpose(1, 2)

    return mk(Sq, Hq, D), mk(Skv, Hkv, D), mk(Skv, Hkv, Dv), mk(Sq, Hq, Dv)


def cuda_core_bwd(q, k, v, o32, lse, dout, causal=True, scale=None, window=None,
                  logit_softcap=None, q_offset=0):
    """The CUDA-core backward (the route of float32 and the small pairs)
    on bf16 inputs, through its C entry point."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ts = (q, k, v, dout, o32, dq, dk, dv)
    err = load_library("flash_attention", fk.SIGNATURES).rt_flash_attention_bwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o32.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, Dv, *[st for t in ts for st in t.stride()[:3]],
        D ** -0.5 if scale is None else float(scale),
        0.0 if logit_softcap is None else float(logit_softcap), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), stream_arg(q))
    check_launch("flash_attention", err)
    return dq, dk, dv


def bound_used(got, want) -> float:
    g, w = got.float(), want.float()
    bound = (GRAD_RTOL * w.abs() + GRAD_FRAC * float(w.abs().max()) + 1e-30
             + 2.0 ** -8 * (g.abs() + w.abs()))
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).abs() / bound).max())


def run_shape(gen, shape, check: bool, times: bool) -> dict:
    name, B, Hq, Hkv, Sq, Skv, D, Dv, kw = shape
    q, k, v, do = inputs(gen, B, Hq, Hkv, Sq, Skv, D, Dv)
    _, o32, lse = fk.forward_with_lse(q, k, v, **kw)
    before = dict(fk.launch_counts())
    got = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    torch.cuda.synchronize()
    after = fk.launch_counts()
    out = {"shape": [B, Hq, Hkv, Sq, Skv, D, Dv], **kw,
           "route": fk.route(q.dtype, D, Dv),
           "launches_a_call": {key: after[key] - before.get(key, 0) for key in after
                               if after[key] != before.get(key, 0)},
           "grads_sha256": hashlib.sha256(b"".join(
               g.contiguous().view(torch.int16).cpu().numpy().tobytes() for g in got)
           ).hexdigest()}
    if check:
        want = ref.attention_vjp(*(t.float() for t in (q, k, v, do)), **kw)
        out["bound_used"] = {n: bound_used(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        core = cuda_core_bwd(q, k, v, o32, lse, do, **kw)
        out["cuda_core_bound_used"] = {n: bound_used(g, w)
                                       for n, g, w in zip(("dq", "dk", "dv"), core, want)}
        again = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
        out["two_calls_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
        del want, core, again
    if times:
        out["us"] = median_us(lambda: fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw))
        out["cuda_core_us"] = median_us(lambda: cuda_core_bwd(q, k, v, o32, lse, do, **kw))
        out["kernel_us"] = kernel_split(lambda: fk.flash_attention_bwd(q, k, v, o32, lse, do,
                                                                       **kw))
    return out


def kernel_split(fn, calls: int = 5) -> dict:
    """Device µs a call by kernel (torch.profiler over ``calls`` calls
    after a warm-up): the backward's three kernels apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--no-times", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    res = {s[0]: run_shape(gen, s, args.check, not args.no_times) for s in SHAPES}
    if args.check:
        res.update({s[0]: run_shape(gen, s, True, False) for s in CHECKS})
    print(json.dumps({"tag": args.tag, "dtype": "bfloat16", "shapes": res}), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
