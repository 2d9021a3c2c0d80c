#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits non-zero without them, or when run outside
a checkout of the repository.  Phases, each of which must pass:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (timed);
2. drive the main path, the stream-triggered Faces loop, at full size —
   a (2,2,2) rank grid of 128^3 float32 blocks (2.1 M points a rank,
   67 MB of field), direct26, batched, coalesced, ``pack="kernel"``,
   ``damping=0.12`` — through the host, fused and persistent engines,
   10 iterations each, in ``stream`` and ``dataflow`` modes, with the
   kernels' launch counters set to 0 just before and read just after;
3. check the results: the engines agree bit for bit, the
   ``pack="torch"`` run agrees bit for bit, one iteration agrees with
   the NumPy ``faces_oracle`` within 1e-4, dispatch counts are
   ``dispatch_count_host() x 10`` / 10 / 1, every kernel launched;
4. hold each halo kernel against its plain PyTorch version on the main
   path's shapes, bit for bit, and time kernel, plain version and one
   PyTorch call for the same function (CUDA events, median);
5. serve mamba2-2.7b at full width and depth (64 layers, d_model 2560,
   80 SSD heads of 64, state 128, vocab 50 280, bf16 compute, float32
   parameters from ``torch.Generator(seed)``): 4 slots, 512-token
   prompts, 32 tokens each, first device-resident (decode = one CUDA
   graph launch) then host-stepped (one launch per token), with the SSD
   kernel's launch counter set to 0 just before each serve and read
   just after; a ``torch.profiler`` window over one prefill and one
   decode step;
6. check the serving results: both modes emit the same tokens,
   ``forward_logits`` (the reference's no-cache kernel path) equals the
   prefill's last-position logits bit for bit, and the logits are
   finite;
7. hold the SSD kernel against its plain version: at the served shapes
   in bf16 within a bound derived from bf16 rounding, and on the
   float32 cases of ``tests/test_kernels.py`` (plus a tail and an
   ``init_state`` case) at the repo's rtol 2e-4 / atol 3e-5; time both.

The last lines are a ``{"kernels": [...]}`` JSON line (five rows), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
N_ITERS = 10


REPLACES = {
    "halo_pack": "src/repro/kernels/halo_pack.py:67",
    "halo_unpack_add": "src/repro/kernels/halo_pack.py:84",
    "pack_segments": "src/repro/kernels/halo_pack.py:163",
    "unpack_segments": "src/repro/kernels/halo_pack.py:202",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:80",
}
SERVE = dict(batch=4, prompt_len=512, gen_len=32)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 15, inner: int = 20) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured into one
    CUDA graph (as the engines run them, without the host's per-call
    overhead), replayed ``reps`` times between CUDA events; the median
    window over ``inner``.  Repeated calls find their data in L2."""
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
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        windows.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / inner for a, b in windows)


def profile_iterations(torch, engine, mem, calls: int = 5) -> dict:
    """Kernel time by name over ``calls`` chained calls of a donating
    engine (no copy-in, as in a running loop)."""
    state = {"mem": engine(mem)}

    def step():
        state["mem"] = engine(state["mem"])

    return profile_calls(torch, step, calls)


def profile_calls(torch, fn, calls: int = 1) -> dict:
    """Kernel time by name over ``calls`` calls of ``fn`` after one
    warm-up (``torch.profiler``), the window's wall time and the
    device's idle share within it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    # device time of the kernels each PyTorch op launched itself
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages() if e.self_device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CPU), key=lambda o: -o[1])
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
            "top": [{"kernel": k[:90], "ms": t, "count": c}
                    for k, t, c in kernels[:12]],
            "ops": [{"op": k, "ms": t, "count": c} for k, t, c in ops[:16]]}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run_engines(torch, cfg, mesh, u0):
    """Phase 2: the main path through every engine; returns the fields
    after 10 iterations, the field after one host iteration, dispatch
    counts and median ms per iteration."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine,
                                  build_faces_program)

    prog = build_faces_program(cfg, mesh)
    fields, dispatches, ms = {}, {}, {}

    host = HostEngine(prog)
    mem = host.init_buffers({"u": u0})
    times = []
    for i in range(N_ITERS):
        t0 = time.perf_counter()
        mem = host(mem)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = mem["u"].clone()
    fields["host"], dispatches["host"], ms["host"] = mem["u"], host.stats.dispatches, statistics.median(times)

    for mode in ("stream", "dataflow"):
        fused = FusedEngine(prog, mode=mode, donate=True)
        fused.compile()
        mem = fused.init_buffers({"u": u0})
        events = []
        for _ in range(N_ITERS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            mem = fused(mem)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        key = f"fused_{mode}"
        fields[key] = mem["u"].clone()
        dispatches[key] = fused.stats.dispatches
        ms[key] = statistics.median(a.elapsed_time(b) for a, b in events)
        if mode == "stream":
            trace_engine = fused

        pers = PersistentEngine(prog.persistent(N_ITERS), mode=mode)
        pers.compile()
        init = pers.init_buffers({"u": u0})
        key = f"persistent_{mode}"
        fields[key] = pers(init)["u"]
        dispatches[key] = pers.stats.dispatches
        events = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            pers(init)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        ms[key] = statistics.median(a.elapsed_time(b) for a, b in events) / N_ITERS
    return prog, fields, first, dispatches, ms, trace_engine


def check_kernels(torch, prog, u, hk, ref):
    """Phase 4: each kernel against its plain version at the main path's
    shapes (bit for bit), its timings, and its bound from this input."""
    from repro_torch.core.engine_fused import Lowering
    from repro_torch.core.halo import _region_for

    points = tuple(u.shape[-3:])
    n_ranks = u.numel() // (points[0] * points[1] * points[2])
    itemsize = u.element_size()
    errs = dict.fromkeys(REPLACES, 0.0)

    def same(name, got, want, what):
        for g, w in zip(got, want):
            errs[name] = max(errs[name], float((g.float() - w.float()).abs().max()))
            require(torch.equal(g, w), f"{name} != plain on {what}")

    def row(name, fn, plain, library, n_bytes, n_ops=0):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/halo_pack.cu",
            "replaces": REPLACES[name], "max_abs_err": errs[name],
            "ms": median_ms(torch, fn), "plain_ms": median_ms(torch, plain),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None else median_ms(torch, library),
        }

    # halo_pack / halo_unpack_add: a face, an edge and a corner, bit for
    # bit; timed on a face (the largest region the path packs)
    for d in [(1, 0, 0), (0, -1, 1), (1, 1, -1), (-1, 0, 0)]:
        region = _region_for(d, points)
        same("halo_pack", [hk.halo_pack(u, region)], [ref.halo_pack(u, region)],
             f"direction {d}")
        msg = ref.halo_pack(torch.roll(u, 1, 0), region)
        same("halo_unpack_add", [hk.halo_unpack_add(u.clone(), msg, region)],
             [ref.halo_unpack_add(u.clone(), msg, region)], f"direction {d}")
    rows = []
    face = _region_for((1, 0, 0), points)
    slab = ref.halo_pack(u, face)
    view = u[(..., *face)]
    out = torch.empty_like(slab)
    rows.append(row("halo_pack", lambda: hk.halo_pack(u, face),
                    lambda: ref.halo_pack(u, face),
                    lambda: out.copy_(view), 2 * slab.numel() * itemsize))
    acc = u.clone()
    acc_view = acc[(..., *face)]
    rows.append(row("halo_unpack_add", lambda: hk.halo_unpack_add(acc, slab, face),
                    lambda: ref.halo_unpack_add(acc, slab, face),
                    lambda: acc_view.add_(slab), 3 * slab.numel() * itemsize,
                    n_ops=slab.numel()))

    # pack_segments / unpack_segments: replay the coalescing plan of the
    # path's batch with both versions, transfer by transfer
    low = Lowering(prog)
    batch = prog.batches[0]
    plan, consts = batch.plan, low.plans[batch.index]
    gen = torch.Generator(u.device).manual_seed(1)
    mem = {n: torch.randn(s.shape, dtype=s.dtype, device=u.device, generator=gen)
           for n, s in prog.buffers.items()}
    received, packs = [], []
    for ti, (t, route) in enumerate(zip(plan.transfers, consts.routes)):
        sources = []
        for seg in t.segments:
            if seg.hop == 0:
                ch = plan.channels[seg.channel]
                sources.append((low.ranks(mem[ch.src_buf]).reshape(n_ranks, -1), 0))
            else:
                pt, po = plan.routes[seg.channel][seg.hop - 1]
                sources.append((received[pt], po))
        sizes = [s.size for s in t.segments]
        staged = hk.pack_segments(sources, sizes)
        same("pack_segments", [staged], [ref.pack_segments(sources, sizes)],
             f"transfer {ti}")
        received.append(low.permute(staged, route))
        packs.append((sources, sizes))
    unpacks = []
    for ti, (chans, offs, masks) in consts.direct.items():
        outs = [mem[plan.channels[ci].dst_buf] for ci in chans]
        got, want = [o.clone() for o in outs], [o.clone() for o in outs]
        hk.unpack_segments(received[ti], got, offs, masks)
        ref.unpack_segments(received[ti], want, offs, masks)
        same("unpack_segments", got, want, f"transfer {ti}")
        unpacks.append((received[ti], got, offs, masks))

    # timed: the first transfer (a face and its eight edge/corner
    # members) and the unpack with the most members
    sources, sizes = packs[0]
    pieces = [s[:, c:c + n] for (s, c), n in zip(sources, sizes)]
    rows.append(row("pack_segments", lambda: hk.pack_segments(sources, sizes),
                    lambda: ref.pack_segments(sources, sizes),
                    lambda: torch.cat(pieces, dim=1),
                    2 * n_ranks * sum(sizes) * itemsize))
    buf, outs, offs, masks = max(unpacks, key=lambda x: len(x[1]))
    written = sum((n_ranks if masks is None else int(masks[j].sum()))
                  * (o.numel() // n_ranks) for j, o in enumerate(outs))
    rows.append(row("unpack_segments", lambda: hk.unpack_segments(buf, outs, offs, masks),
                    lambda: ref.unpack_segments(buf, outs, offs, masks),
                    None, 2 * written * itemsize))
    return rows


def run_serve(torch, seed: int):
    """Phase 5: serve mamba2-2.7b at full size in both decode modes.

    One untimed serve per mode first captures the decode graphs (set-up,
    as a server does once).  Then each mode serves once with the SSD
    kernel's counter set to 0 just before and read just after."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch

    cfg = get_config("mamba2-2.7b")
    eng = ServeEngine(cfg, slots=SERVE["batch"], prompt_len=SERVE["prompt_len"],
                      max_new=SERVE["gen_len"], chunk=SERVE["gen_len"] - 1)
    params = eng.model.init(seed)
    batch_in = synthetic_batch(cfg, np.random.RandomState(seed), SERVE["batch"],
                               SERVE["prompt_len"])
    t0 = time.perf_counter()
    for resident in (True, False):
        serve(cfg, params=params, batch_in=batch_in, engine=eng,
              device_resident=resident, **SERVE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs = {}
    for resident in (True, False):
        ssd.reset_launches()
        gen, stats = serve(cfg, params=params, batch_in=batch_in, engine=eng,
                           device_resident=resident, **SERVE)
        torch.cuda.synchronize()
        runs["resident" if resident else "host_stepped"] = (gen, stats, ssd.launch_counts())
    return cfg, eng, params, batch_in, runs, setup_s


def check_serving(torch, eng, params, batch_in, runs) -> dict:
    """Phase 6: equal tokens in both modes; ``forward_logits`` equal to the
    prefill's last-position logits; finite logits."""
    res, host = runs["resident"][0], runs["host_stepped"][0]
    require(res.shape == (SERVE["batch"], SERVE["gen_len"]), f"tokens of shape {res.shape}")
    require(bool((res == host).all()), "resident and host-stepped tokens differ")
    require(bool(((res >= 0) & (res < eng.cfg.vocab)).all()), "tokens out of the vocabulary")
    cast = eng.cast_params(params)
    caches = eng.init_state()[0]
    pre, _ = eng.model.prefill(cast, batch_in, caches)
    full = eng.model.forward_logits(cast, batch_in)
    last = full[:, -1]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(full).all()),
            "non-finite logits")
    # With a zero state and a zero conv pad, prefill and forward_logits run
    # the same kernels on the same inputs: equal bit for bit
    require(torch.equal(pre, last), "forward_logits differs from the prefill's logits "
            f"(max abs diff {float((pre.float() - last.float()).abs().max())})")
    return {"tokens_equal": True, "logits_finite": True,
            "forward_vs_prefill_bitwise": True,
            "last_logit_abs_max": float(pre.float().abs().max())}


def ssd_flops_bytes(B, S, H, P, G, N, chunk, itemsize, h0: bool):
    """Operations the chunked form needs and the bytes a call must move
    (each input read once, each output written once).  Per chunk of L
    rows: C B^T and G x over the causal triangle only (G is 0 above the
    diagonal), L (L + 1) (N + P); C h^T and x^T (B w), 4 L N P."""
    chunk = min(chunk, S)
    lens = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    flops = B * H * sum(L * (L + 1) * (N + P) + 4 * L * N * P for L in lens)
    n_bytes = (2 * B * S * H * P * itemsize + B * S * H * 4 + H * 4
               + 2 * B * S * G * N * itemsize + (2 if h0 else 1) * B * H * P * N * 4)
    return flops, n_bytes


def check_ssd(torch, ssd, ref, seed: int):
    """Phase 7: the SSD kernel against its plain version; returns its
    kernel-table row and the details of the check."""
    gen = torch.Generator("cuda").manual_seed(seed)
    fp32_err = 0.0
    # tests/test_kernels.py SSD_CASES, its init_state case, a tail case
    for B, S, H, P, G, N, chunk, h0 in [(1, 32, 2, 8, 1, 8, 8, False),
                                        (2, 80, 4, 16, 2, 24, 32, False),
                                        (1, 128, 2, 32, 1, 16, 128, False),
                                        (1, 40, 2, 8, 1, 8, 8, True),
                                        (2, 40, 4, 16, 2, 16, 16, True)]:
        x = torch.randn(B, S, H, P, device="cuda", generator=gen)
        dt = torch.randn(B, S, H, device="cuda", generator=gen).abs() * 0.1
        A = -torch.randn(H, device="cuda", generator=gen).abs()
        Bm = torch.randn(B, S, G, N, device="cuda", generator=gen)
        C = torch.randn(B, S, G, N, device="cuda", generator=gen)
        h = torch.randn(B, H, P, N, device="cuda", generator=gen) if h0 else None
        got = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h, chunk=chunk, return_state=True)
        want = ref.ssd_scan(x, dt, A, Bm, C, init_state=h, return_state=True)
        for g, w in zip(got, want):
            fp32_err = max(fp32_err, float((g - w).abs().max()))
            require(torch.allclose(g, w, rtol=2e-4, atol=3e-5),
                    f"ssd_scan != plain on float32 case S={S} chunk={chunk}")

    # served prefill shapes, bf16; x, B, C are views of the conv output
    B, S, H, P, G, N = SERVE["batch"], SERVE["prompt_len"], 80, 64, 1, 128
    wide = torch.randn(B, S, H * P + 2 * G * N, device="cuda", generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
    A = torch.full((H,), -2.718281828, device="cuda")  # -exp(A_log) at init
    h0 = torch.randn(B, H, P, N, device="cuda", generator=gen)
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128, return_state=True)
    yp, hp = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=h0.abs(), return_state=True)
    # Bound: the plain version rounds each x*B product to bf16 (2^-8 of
    # that term) where the kernel widens to float32 first; both round y to
    # bf16 (2^-8 of each); 2^-10 of the terms' magnitudes covers float32
    # reassociation and the chunked exponent's rounding.  yabs, habs: the
    # scan of |x|, |B|, |C|, |h0| -- the sum of the terms' magnitudes.
    dy = (y.float() - yp.float()).abs()
    tol_y = 2.0 ** -8 * (y.float().abs() + yp.float().abs()) + (2.0 ** -8 + 2.0 ** -10) * yabs
    dh = (h - hp).abs()
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    require(bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all()),
            "ssd_scan: non-finite output at the served shapes")
    require(bool((dy <= tol_y).all()) and bool((dh <= tol_h).all()),
            "ssd_scan != plain at the served shapes beyond the bf16 bound")
    flops, n_bytes = ssd_flops_bytes(B, S, H, P, G, N, 128, 2, True)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan"], "max_abs_err": float(dy.max()),
        "ms": median_ms(torch, lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                     chunk=128, return_state=True)),
        "plain_ms": median_ms(torch, lambda: ref.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                          return_state=True),
                              reps=3, inner=2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the chunked scan
    }
    detail = {
        "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": 128},
        "flops": flops, "bytes": n_bytes,
        "fp32_cases_max_abs_err": fp32_err,
        "bf16_y_max_abs_err": float(dy.max()),
        "bf16_y_max_rel_err": float(dy.max() / yp.float().abs().max()),
        "bf16_y_bound_used": float((dy / tol_y).max()),
        "h_max_abs_err": float(dh.max()),
        "h_max_rel_err": float(dh.max() / hp.abs().max()),
        "h_bound_used": float((dh / tol_h).max()),
    }
    return row, detail


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import numpy as np

    from repro_torch import make_mesh
    from repro_torch.core import FacesConfig, PersistentEngine, build_faces_program, faces_oracle
    from repro_torch.core.halo import AXES3
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import halo_pack as hk

    card = gpu_line()
    print(f"card: {card}", flush=True)
    # phase 1: every csrc/*.cu, one nvcc each, all started together
    t0 = time.perf_counter()
    infos = build.build_all()
    print(json.dumps({"build": {"seconds": time.perf_counter() - t0, "libraries": {
        name: {"library": i.path.name, "seconds": i.seconds,
               "ptxas": [l.strip() for l in i.log.splitlines()
                         if "registers" in l or "spill" in l]}
        for name, i in infos.items()}}}), flush=True)

    # phase 2: the main path
    cfg = FacesConfig(grid=(2, 2, 2), points=(128, 128, 128), dtype="float32",
                      granularity="direct26", batched=True, pack="kernel",
                      damping=0.12)
    mesh = make_mesh(cfg.grid, AXES3)
    u0 = np.random.RandomState(args.seed).randn(*cfg.grid, *cfg.points).astype(np.float32)
    hk.reset_launches()
    prog, fields, first, dispatches, ms, fused = run_engines(torch, cfg, mesh, u0)
    torch.cuda.synchronize()
    launches = hk.launch_counts()

    # phase 3: results
    want = {"host": N_ITERS * prog.dispatch_count_host(),
            "fused_stream": N_ITERS, "fused_dataflow": N_ITERS,
            "persistent_stream": 1, "persistent_dataflow": 1}
    require(dispatches == want, f"dispatch counts {dispatches} != {want}")
    require(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    base = fields["host"]
    require(bool(torch.isfinite(base).all()), "non-finite field after 10 iterations")
    for name, f in fields.items():
        require(torch.equal(f, base), f"{name} differs from the host engine")
    plain_cfg = dataclasses.replace(cfg, pack="torch")
    plain = PersistentEngine(build_faces_program(plain_cfg, mesh).persistent(N_ITERS))
    require(torch.equal(plain(plain.init_buffers({"u": u0}))["u"], base),
            'pack="torch" differs from pack="kernel"')
    oracle = faces_oracle(u0, cfg)
    err = float(np.abs(first.cpu().numpy() - oracle).max())
    require(np.allclose(first.cpu().numpy(), oracle, rtol=1e-4, atol=1e-4),
            f"one iteration differs from faces_oracle (max abs err {err})")
    print(json.dumps({"faces": {
        "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
        "dispatches": dispatches, "median_ms_per_iter": ms,
        "oracle_max_abs_err": err, "launches": launches}}), flush=True)

    # where the time of fused (stream) iterations goes
    print(json.dumps({"profile_fused_stream": profile_iterations(
        torch, fused, fused.init_buffers({"u": u0}))}), flush=True)

    # phase 4: kernels against their plain versions
    rows = check_kernels(torch, prog, base, hk, ref)
    for r in rows:
        r["launches"] = launches[r["name"]]
    del prog, fields, first, fused, base, plain

    # phase 5: serve mamba2-2.7b at full width and depth
    from repro_torch.kernels import ssd_scan as ssd
    torch.cuda.reset_peak_memory_stats()
    model_cfg, eng, params, batch_in, runs, setup_s = run_serve(torch, args.seed)
    serve_line = {"model": model_cfg.name, **SERVE, "setup_s": setup_s}
    for mode, (gen, stats, counts) in runs.items():
        require(counts["ssd_scan"] > 0, f"ssd_scan never launched serving {mode}")
        serve_line[mode] = {
            "prefill_ms": stats["prefill_s"] * 1e3, "decode_ms": stats["decode_s"] * 1e3,
            "decode_ms_per_token": stats["decode_s"] * 1e3 / (SERVE["gen_len"] - 1),
            "tok_per_s": stats["tok_per_s"], "decode_tokens": stats["decode_tokens"],
            "dispatches": stats["dispatches"],
            "decode_dispatches": stats["decode_dispatches"],
            "ssd_scan_launches": counts["ssd_scan"]}
    require((serve_line["resident"]["dispatches"],
             serve_line["resident"]["decode_dispatches"]) == (2, 1),
            f"resident dispatches {serve_line['resident']}")
    require(serve_line["host_stepped"]["decode_dispatches"] == SERVE["gen_len"] - 1,
            f"host-stepped dispatches {serve_line['host_stepped']}")
    serve_line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ssd_launches = sum(counts["ssd_scan"] for _, _, counts in runs.values())
    print(json.dumps({"serve": serve_line}), flush=True)

    # phase 6: serving results
    print(json.dumps({"serve_checks": check_serving(torch, eng, params, batch_in, runs)}),
          flush=True)

    # where the time of one prefill and one decode step goes
    cast = eng.cast_params(params)
    caches, tok, _, _ = eng.init_state()
    pre_caches = eng.model.prefill(cast, batch_in, caches)[1]
    print(json.dumps({"profile_prefill": profile_calls(
        torch, lambda: eng.model.prefill(cast, batch_in, caches))}), flush=True)
    print(json.dumps({"profile_decode_step": profile_calls(
        torch, lambda: eng.model.decode_step(cast, pre_caches, tok))}), flush=True)
    graph_caches = eng.decode_one(params, pre_caches, tok)[1]  # the graph's own buffers
    print(json.dumps({"profile_decode_graph": profile_calls(
        torch, lambda: eng.decode_one(params, graph_caches, tok))}), flush=True)
    del eng, params, cast, caches, pre_caches, graph_caches, runs

    # phase 7: the SSD kernel against its plain version
    row, detail = check_ssd(torch, ssd, ref, args.seed)
    row["launches"] = ssd_launches
    rows.append(row)
    print(json.dumps({"ssd_scan_check": detail}), flush=True)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}))
    print(f"card: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
