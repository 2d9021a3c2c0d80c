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
4. hold each kernel against its plain PyTorch version on the main
   path's shapes, bit for bit, and time kernel, plain version and one
   PyTorch call for the same function (CUDA events, median).

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
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
}


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
    engine (``torch.profiler``; no copy-in, as in a running loop), the
    window's wall time and the device's idle share within it."""
    from torch.profiler import ProfilerActivity, profile

    mem = engine(mem)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            mem = engine(mem)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
            "top": [{"kernel": k[:90], "ms": t, "count": c}
                    for k, t, c in kernels[:12]]}


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
    info = build.build_library()
    ptxas = [l.strip() for l in info.log.splitlines() if "registers" in l or "spill" in l]
    print(json.dumps({"build": {"seconds": info.seconds, "library": info.path.name,
                                "ptxas": ptxas}}), flush=True)

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
