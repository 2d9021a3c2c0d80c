#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits non-zero without them, or when run outside
a checkout of the repository.  Phases, each of which must pass:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (timed; one nvcc per source, all started together);
2. drive the main path, the stream-triggered Faces loop, at full size —
   a (2,2,2) rank grid of 128^3 float32 blocks (2.1 M points a rank,
   67 MB of field), direct26, batched, coalesced, ``pack="kernel"``,
   ``damping=0.12`` — through the host, fused and persistent engines,
   10 iterations each, in ``stream`` and ``dataflow`` modes, with the
   kernels' launch counters set to 0 just before and read just after;
3. check the results: the engines agree bit for bit, the
   ``pack="torch"`` run agrees bit for bit, one iteration agrees with
   the NumPy ``faces_oracle`` within 1e-4, dispatch counts are
   ``dispatch_count_host() x 10`` / 10 / 1, the four Faces kernels
   launched;
4. drive the same 10 iterations the paper's other way, through ONE
   contiguous buffer per rank (``faces_step_contiguous``:
   ``ops.pack_boundary`` and ``ops.unpack_boundary_add``, counters set
   to 0 just before), and require the first iteration and the tenth
   equal to the host engine's bit for bit;
5. hold each halo and boundary kernel against its plain PyTorch version
   on the main path's shapes, bit for bit (``halo_pack`` and
   ``halo_unpack_add`` on all 26 regions, the unpack in float32 and
   bf16; the boundary pair on each of the 8 rank blocks and on a bf16
   block, ``pack_boundary`` also on the whole field in both dtypes;
   ``pack_segments`` also on a relay-heavy bf16 member set at unaligned
   columns), and time kernel, plain version and one PyTorch call for
   the same function (CUDA events, median); ``halo_unpack_add`` also on
   one region of each class (x-, y- and z-face, edges along x, y and z,
   corner) against a slice ``add_``, with two bounds: the useful bytes
   and the 32-byte sectors the region touches (``sector_bound_ms``, also
   in the pack's, the unpack's and both boundary kernels' rows of the
   kernels line), and ``halo_pack`` on the same regions against a slice
   ``copy_`` with the same two bounds; ``unpack_boundary_add`` is timed
   beside one ``index_add_`` of the buffer at the regions' flat indices
   (which adds overlapping regions in another order: timed, not
   compared), ``unpack_segments`` beside no library call (no single
   PyTorch call writes N separate tensors); and, untimed, the four Faces
   kernels bit for bit at the part shapes of phase 12 (64- and 32-plane
   blocks: all 26 regions, and every coalescing plan of the 2- and
   4-part linked schedules, ghost planes and cross payloads included);
6. serve mamba2-2.7b at full width and depth (64 layers, d_model 2560,
   80 SSD heads of 64, state 128, vocab 50 280, bf16 compute, float32
   parameters from ``torch.Generator(seed)``): 4 slots, 512-token
   prompts, 32 tokens each, first device-resident (decode = one CUDA
   graph launch) then host-stepped (one launch per token); the prefill
   is one CUDA-graph launch in both.  A set-up serve in each mode
   captures the graphs; the kernels' counters are set to 0 just before
   it and read after the two served runs, which must launch no kernel
   eagerly and each launch the prefill graph once; the prefill graph
   must hold the SSD kernel, 64 launches all on its tensor-core route,
   and the rmsnorm kernel; ``torch.profiler`` windows
   over an eager and a graphed prefill and a decode step;
7. check the serving results: both modes emit the same tokens, the
   graphed prefill equals an eager ``Model.prefill`` bit for bit
   (logits and caches), ``forward_logits`` (the reference's no-cache
   kernel path) equals the prefill's last-position logits bit for bit,
   and the logits are finite;
8. hold the SSD kernel against its plain version, each case on its
   route: at the served shapes in bf16 within a bound derived from bf16
   rounding, and at the same bound on bf16 cases at the served widths
   (a short last chunk with ``init_state`` and 2 groups, 11 chunks, the
   extreme decay of ``tests/test_torch_gpu.py``, whose state is also
   held to that test's float32 bound) on the tensor-core route, and on
   the float32 cases of ``tests/test_kernels.py`` (plus a tail and an
   ``init_state`` case) at the repo's rtol 2e-4 / atol 3e-5 on the
   CUDA-core route; time the kernel, the CUDA-core kernel on the served
   bf16 inputs (``earlier_ms``) and the plain version;
9. serve gemma3-1b at full width and depth (26 layers, d_model 1152, 4
   query heads and 1 kv head of 256, 22 local layers with a 512-token
   window and 4 global ones, vocab 262 144, bf16 compute over float32
   parameters from ``torch.Generator(seed)``): 4 slots, 1024-token
   prompts (twice the window, so the local layers skip kv tiles), 32
   tokens each, resident then host-stepped, counted as in phase 6; the
   prefill graph must hold 26 flash launches on the tensor-core route
   and none on the CUDA-core route, and at least 105 norms; the checks
   of phase 7 (the eager prefill takes the same routes); profiles as in
   phase 6;
10. hold flash attention against its plain version on the q, k, v of the
   served prefill's first local layer (0) and first global layer (5),
   taken by calling the layers' functions, in bf16 within one rounding
   of the output (the tensor-core route), on bf16 cases at head_dim 64,
   128 and 256 at the same bound, and on float32 cases (softcap, one
   query at an offset, ragged kv, head_dim 32/64/128/256) at the repo's
   rtol 2e-4 / atol 3e-5 (the CUDA-core route); rmsnorm on the served
   layer-0 input and at d 1152, 256 and 2560 with a ragged row count at
   ``weight_offset`` 0 and 1, and at the decode shapes (4 x 2560, 4 x
   5120, 4 x 1152, 16 x 256 bf16); require the served input's first 4
   rows, normalised alone, equal to the same rows of the whole input
   bit for bit (two routes of the kernel); time both, flash on the
   global and the local layer, rmsnorm also at the decode shapes,
   against ``F.scaled_dot_product_attention`` and ``F.rms_norm``;
11. convergence on the Faces configuration of phase 2: for tol 1e-1,
   1e-2 and 1e-3 (``max_iters`` 64), ``run_faces_until_converged`` in
   ``dataflow`` mode (ONE launch of a CUDA graph whose conditional WHILE
   node repeats two passes, set by the step kernel of
   ``csrc/graph_loop.cu``; double buffered) against host-polled
   ``FusedEngine`` (one call and one host read of the residual an
   iteration): equal ``n_done``, residual trace and buffers bit for
   bit, dispatches 1 against ``n_done``, sync points 0 against
   ``n_done``, wall times (the counters are set to 0 just before these
   runs and read after them); tol 0 with ``max_iters`` 20 in both modes
   must stop at 20 and equal ``PersistentEngine(n_iters=20)`` bit for
   bit, with ms per iteration beside it (with and without the residual)
   and the times of one field copy and one residual; the step kernel
   against the plain step on known traces (the bound, and both
   parities of the last pass), and its time per iteration;
12. composition on the Faces configuration of phase 2: the domain split
   into 2 and 4 x-parts, one queue each, linked by cross-program
   channels and composed (``run_faces_pipelined``, 10 iterations, ONE
   graph launch with one CUDA stream a program), in ``stream`` and
   ``dataflow``: the merged field equal to the full-domain
   ``PersistentEngine`` bit for bit, dispatches and graph launches 1,
   the captured pass one stream wide a program (``graph_loop.
   graph_edges``: the kernel nodes' largest unordered set is 1 for the
   plain program and N for N parts in ``stream``, at most 2N in
   ``dataflow``), ms per iteration beside the full-domain run's and a
   ``torch.profiler`` window of each (one call, 10 iterations); with
   ``exchange=False`` each part equal to its own ``run_faces_persistent``
   bit for bit; one pass of the 2-part schedule on the host and fused
   engines equal to the full program's.  The counters are set to 0
   just before each composed run (``run_faces_pipelined``; the
   ``PersistentEngine`` of the schedule, compiled and called) and read
   just after it, before any other run: each such run must launch all
   four Faces kernels, and its counts are printed per mode and parts;
13. the verifier and the sanitizer: ``verify_program`` finds nothing on
   every program and schedule this script builds (count, and host ms of
   the largest); ``FusedEngine`` and ``PersistentEngine`` with
   ``sanitize=True`` equal ``sanitize=False`` bit for bit on the Faces
   program and the 2-part linked schedule in both modes, ms per
   iteration for both (and a profile of the persistent Faces call with
   and without); the racy mutation of ``tests/test_verify.py``
   (an unpack kernel moved ahead of its wait) at full width raises
   ``SanitizeError`` in every engine's constructor with no kernel
   launched, while the unsanitized engine runs it; the program registry
   (``repro_torch.analysis``) on the benchmark grid's 8 ranks: every
   program lints clean and every certificate is race-free.

14. the masked multi-queue loop on the Faces configuration of phase 2,
   split along x into 2 and 4 linked parts, in ``stream`` and
   ``dataflow``, each part to its own count or tolerance in ONE launch
   of a CUDA graph (a conditional WHILE node over two passes of every
   part, set by the schedule step of ``csrc/graph_loop.cu``, which also
   fires each part's snapshot and restore copies): (a) tolerance 1e-2 on
   every part, ``max_iters`` 20; (b) tolerances (1e-1, 1e-3) and (1e-1,
   1e-2, 1e-2, 1e-3), whether the tightest part plateaus at the bound,
   ms per iteration (CUDA events), the pass's and the freeze graphs'
   node counts by type, and (2 parts)
   ``sanitize=True`` equal bit for bit; (c) (b) unlinked, each part
   equal to its own ``run_faces_until_converged`` bit for bit (field,
   trace, ``n_done``); (d) 2 linked parts with counts 3 and 7, no
   reductions; (e) reductions only, every count 10, equal to the
   fixed-count composed graph bit for bit, ms per iteration beside it
   (CUDA events).  Every solve: one dispatch and one graph launch,
   fields, traces and ``n_done`` equal to the eager
   ``_run_schedule_while`` run on the card's tensors bit for bit, wall
   ms of the graph and the eager loop (host clock around synchronized
   calls), and the four Faces kernels and the schedule step launched
   (counters set to 0 just before the engine's compile and first call,
   read just after); the schedule step against the plain step on known
   traces, and its time per pass.
15. the tuner on phase 12's linked 2- and 4-part pipeline at full width:
   ``run_faces_pipelined(tune=True)`` (the reference's default space,
   interleave {round_robin, sequential, 2} x mode {dataflow, stream}; the
   3 cheapest predictions timed) and ``tune(certify=True)`` on the same
   builds with all 6 timed; then the 26-layer TP chain of phase 16 over
   mode x coalesce x double_buffer {None, False} (all 8 timed).  Each
   candidate's predicted µs beside its measured median and the rank
   agreement (Spearman) — no threshold: the cost model's constants are
   the reference's CPU ones; every candidate certified, each winner one
   dispatch and one graph launch, equal to the untuned run bit for bit
   (the Faces kernels' counters set to 0 just before each tuned run and
   read just after);
16. the ring collectives at gemma3-1b's MLP widths (m 4096 = 4 slots x
   1024 tokens, d_model 1152, d_ff 6912; weights from
   ``torch.Generator(seed)`` scaled by 1/sqrt(fan-in)) on a one-axis
   mesh of 4 ranks, float32: ``build_all_gather_matmul`` uni- and
   bidirectional, ``build_matmul_reduce_scatter``, ``build_all_to_all``
   through FusedEngine and PersistentEngine in both modes, each one
   launch, finite and equal to the port's decomposed oracle on the card
   bit for bit, and to its CPU run within rtol=atol=1e-5 (the
   all-to-all bit for bit); ``build_tp_block(chain=True)`` persistent
   over 26 layers: one dispatch, equal to 26 decomposed block
   applications bit for bit, to 26 fused calls and to its CPU run; ms a
   layer beside 26 eager calls of the stock composition (CUDA events).
   No hand-written kernel is on this path (the matmuls are cuBLAS, as
   the reference's are XLA's): every counter, set to 0 before it, reads
   0 after it.

The last lines are a ``{"kernels": [...]}`` JSON line (eleven rows: the
nine Pallas kernels' and the two step kernels', which have no Pallas
counterpart (``"pallas_counterpart": false``); the
flash and SSD rows also give ``earlier_ms``: the CUDA-core kernel, the
port's kernel before the tensor-core one, on the same input in this
run, and the SSD row its ``kernel_route``; the rmsnorm row gives
``decode``: its times at the decode shapes; the schedule step's row
``one_program_ms``: its loop with one program), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
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
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
N_ITERS = 10


REPLACES = {
    "halo_pack": "src/repro/kernels/halo_pack.py:67",
    "halo_unpack_add": "src/repro/kernels/halo_pack.py:84",
    "pack_boundary": "src/repro/kernels/halo_pack.py:112",
    "unpack_boundary_add": "src/repro/kernels/halo_pack.py:134",
    "pack_segments": "src/repro/kernels/halo_pack.py:163",
    "unpack_segments": "src/repro/kernels/halo_pack.py:202",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:28",
    "flash_attention": "src/repro/kernels/flash_attention.py:96",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:80",
    # no Pallas counterpart: the lax.while_loop of _run_persistent_while
    "graph_loop_step": "src/repro/core/engine_persistent.py:495",
    # nor here: the lax.while_loop of _run_schedule_while and its jnp.where masks
    "schedule_step": "src/repro/core/engine_persistent.py:599",
}
FACES_KERNELS = ("halo_pack", "halo_unpack_add", "pack_segments", "unpack_segments")
# one region of each class the Faces loop unpacks, by its DIRECTIONS entry
UNPACK_CLASSES = {"face_x": (1, 0, 0), "face_y": (0, 1, 0), "face_z": (0, 0, 1),
                  "edge_along_x": (0, 1, 1), "edge_along_y": (1, 0, 1),
                  "edge_along_z": (1, 1, 0), "corner": (1, 1, 1)}
SERVE = dict(batch=4, prompt_len=512, gen_len=32)          # mamba2-2.7b
DENSE_SERVE = dict(batch=4, prompt_len=1024, gen_len=32)   # gemma3-1b
CONV_TOLS = (1e-1, 1e-2, 1e-3)     # the reference's faces_convergence rows
CONV_MAX_ITERS = 64
BOUND_ITERS = 20                   # the loop's own cost: tol 0 runs to the bound
STEP_ITERS = 4096                  # iterations of the step kernel's timing loop
PARTS = (2, 4)                     # x-parts of the composed runs (phase 12)
# (tol, max_iters) of the step kernel's known-trace checks: n_done 14 and 17
# by the tolerance, 16, 7 and 1 by the bound, 1 by a first value below tol
STEP_CASES = ((0.6, 32), (0.5, 32), (-1.0, 16), (-1.0, 7), (-1.0, 1), (2.0, 16))
MASK_MAX_ITERS = 20                # phase 14: the bound of cases (a) to (c)
MASK_EQUAL_TOL = 1e-2              # case (a): every part
MASK_TOLS = {2: (1e-1, 1e-3), 4: (1e-1, 1e-2, 1e-2, 1e-3)}   # cases (b) and (c)
MASK_COUNTS = (3, 7)               # case (d): 2 linked parts, no reductions
MASK_FIXED = N_ITERS               # case (e): every count, reductions only
# (tols, counts, max_iters) of the schedule step's known-trace checks: programs
# stopping by a tolerance, by their count, without a predicate, at the first
# pass, and both parities of the last pass
SCHED_STEP_CASES = (((0.6, None, 0.1), (16, 4, 9), 16), ((2.0, 0.45), (5, 16), 16),
                    ((None,), (7,), 7), ((-1.0, -1.0), (1, 2), 2))
SCHED_STEP_PROGRAMS = 4            # programs of the step's timing loop
# phase 15: the tuner's spaces (the reference's default for the pipeline;
# benchmarks/overlap_bench.py's for the TP chain)
TUNE_SPACE = {"interleave": ["round_robin", "sequential", 2], "mode": ["dataflow", "stream"]}
TP_SPACE = {"mode": ["stream", "dataflow"], "coalesce": [True, False],
            "double_buffer": [None, False]}
# phase 16: gemma3-1b's MLP (configs/gemma3_1b.py: d_model 1152, d_ff 6912) over
# the serve phase's 4 slots x 1024 tokens, on a one-axis mesh of 4 ranks
MLP = (4096, 1152, 6912)
COLL_RANKS = 4
TP_LAYERS = 26                     # gemma3-1b's depth
COLL_TOL = 1e-5                    # card against CPU: the repo's engine-vs-engine bound


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


def kernel_row(torch, name, source, err, fn, plain, library, n_bytes, n_ops, ops_rate,
               plain_reps=(15, 20)):
    """A row of the kernels line: times of the kernel, its plain version
    and the library call, and the bound from this run's bytes and
    operations (``ops_rate``: the peak of the operations' type)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": REPLACES[name], "max_abs_err": err,
        "ms": median_ms(torch, fn), "plain_ms": median_ms(torch, plain, *plain_reps),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None if library is None else median_ms(torch, library),
    }


def sector_bound_ms(torch, u, regions, passes, packed_bytes) -> float:
    """The least time for a kernel that moves ``regions`` of ``u`` in
    whole 32-byte sectors: the distinct sectors of ``u`` the regions
    touch, each moved ``passes`` times (read, or read and written), and
    ``packed_bytes`` of a contiguous packed buffer, over the memory
    rate.  A strided region touches a sector for each element (a z-face
    of 4-byte elements: 8 times its useful bytes)."""
    index = torch.arange(u.numel(), device=u.device).view(u.shape)
    addrs = torch.cat([index[(..., *r)].flatten() for r in regions])
    sectors = torch.unique((u.data_ptr() + addrs * u.element_size()) // 32).numel()
    return (passes * 32 * sectors + packed_bytes) / HBM_BYTES_PER_S * 1e3


def run_contiguous(torch, cfg, u0, first, last, hk):
    """Phase 4: the same iterations through one contiguous buffer per rank
    (``faces_step_contiguous``), counters set to 0 just before and read
    just after; the first and the last iteration must equal the host
    engine's bit for bit."""
    from repro_torch.core import faces_step_contiguous

    u = torch.from_numpy(u0).cuda()
    torch.cuda.synchronize()
    hk.reset_launches()
    events = []
    for i in range(N_ITERS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        u = faces_step_contiguous(u, cfg)
        b.record()
        events.append((a, b))
        if i == 0:
            one = u.clone()
    torch.cuda.synchronize()
    launches = hk.launch_counts()
    require(launches["pack_boundary"] == N_ITERS and launches["unpack_boundary_add"] == N_ITERS,
            f"the one-buffer path did not take the boundary kernels: {launches}")
    require(torch.equal(one, first), "one-buffer iteration 1 differs from the host engine's")
    require(torch.equal(u, last), f"one-buffer iteration {N_ITERS} differs from the host "
            "engine's")
    return {"iterations": N_ITERS,
            "median_ms_per_iter": statistics.median(a.elapsed_time(b) for a, b in events),
            "equal_to_host_engine": True, "launches": launches}


def check_kernels(torch, prog, u, hk, ref):
    """Phase 4: each kernel against its plain version at the main path's
    shapes (bit for bit), its timings, and its bound from this input."""
    import numpy as np

    from repro_torch.core.engine_fused import Lowering
    from repro_torch.core.halo import DIRECTIONS, _region_for

    points = tuple(u.shape[-3:])
    n_ranks = u.numel() // (points[0] * points[1] * points[2])
    itemsize = u.element_size()
    errs = dict.fromkeys(REPLACES, 0.0)

    def same(name, got, want, what):
        for g, w in zip(got, want):
            errs[name] = max(errs[name], float((g.float() - w.float()).abs().max()))
            require(torch.equal(g, w), f"{name} != plain on {what}")

    def row(name, fn, plain, library, n_bytes, n_ops=0):
        return kernel_row(torch, name, "halo_pack.cu", errs[name], fn, plain, library,
                          n_bytes, n_ops, FP32_OPS_PER_S)

    # halo_pack / halo_unpack_add: all 26 regions, bit for bit (the
    # unpack also on the field in bf16); timed on a face (the largest
    # region the path packs), the unpack also on one region of each class
    ub = u.bfloat16()
    for d in DIRECTIONS:
        region = _region_for(d, points)
        same("halo_pack", [hk.halo_pack(u, region)], [ref.halo_pack(u, region)],
             f"direction {d}")
        for field in (u, ub):
            msg = ref.halo_pack(torch.roll(field, 1, 0), region)
            same("halo_unpack_add", [hk.halo_unpack_add(field.clone(), msg, region)],
                 [ref.halo_unpack_add(field.clone(), msg, region)],
                 f"direction {d}, {field.dtype}")
    rows = []
    face = _region_for((1, 0, 0), points)
    slab = ref.halo_pack(u, face)
    view = u[(..., *face)]
    out = torch.empty_like(slab)
    rows.append(row("halo_pack", lambda: hk.halo_pack(u, face),
                    lambda: ref.halo_pack(u, face),
                    lambda: out.copy_(view), 2 * slab.numel() * itemsize))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, [face], 1, slab.numel() * itemsize)
    acc = u.clone()
    acc_view = acc[(..., *face)]
    rows.append(row("halo_unpack_add", lambda: hk.halo_unpack_add(acc, slab, face),
                    lambda: ref.halo_unpack_add(acc, slab, face),
                    lambda: acc_view.add_(slab), 3 * slab.numel() * itemsize,
                    n_ops=slab.numel()))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, [face], 2, slab.numel() * itemsize)
    by_class = {}
    for name, d in UNPACK_CLASSES.items():
        region = _region_for(d, points)
        msg = ref.halo_pack(u, region)
        part = acc[(..., *region)]
        by_class[name] = {
            "elements": msg.numel(),
            "ms": median_ms(torch, lambda: hk.halo_unpack_add(acc, msg, region)),
            "library_ms": median_ms(torch, lambda: part.add_(msg)),
            "bound_ms": 3 * msg.numel() * itemsize / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": sector_bound_ms(torch, u, [region], 2,
                                               msg.numel() * itemsize)}
    print(json.dumps({"halo_unpack_add_by_class": by_class}), flush=True)
    by_class = {}
    for name, d in UNPACK_CLASSES.items():
        region = _region_for(d, points)
        slab_c = ref.halo_pack(u, region)
        part, out_c = u[(..., *region)], torch.empty_like(slab_c)
        by_class[name] = {
            "elements": slab_c.numel(),
            "ms": median_ms(torch, lambda: hk.halo_pack(u, region)),
            "library_ms": median_ms(torch, lambda: out_c.copy_(part)),
            "bound_ms": 2 * slab_c.numel() * itemsize / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": sector_bound_ms(torch, u, [region], 1,
                                               slab_c.numel() * itemsize)}
    print(json.dumps({"halo_pack_by_class": by_class}), flush=True)

    # pack_boundary / unpack_boundary_add: each of the 8 rank blocks of the
    # field and a bf16 block, bit for bit (the received buffer: the packed
    # one reversed), and pack_boundary on the whole field in float32 and
    # bf16; timed on the whole field, all ranks in one launch, as the
    # one-buffer path calls them
    send = [_region_for(d, points) for d in DIRECTIONS]
    back = [_region_for(tuple(-x for x in d), points) for d in DIRECTIONS]
    blocks = [u[g] for g in np.ndindex(*u.shape[:-3])] + [u[(0,) * (u.dim() - 3)].bfloat16()]
    for i, blk in enumerate(blocks):
        buf = hk.pack_boundary(blk, send)
        same("pack_boundary", [buf], [ref.pack_boundary(blk, send)], f"block {i}")
        msg = torch.flip(buf, [-1])
        same("unpack_boundary_add", [hk.unpack_boundary_add(blk.clone(), msg, back)],
             [ref.unpack_boundary_add(blk.clone(), msg, back)], f"block {i}")
    for field in (u, ub):
        same("pack_boundary", [hk.pack_boundary(field, send)],
             [ref.pack_boundary(field, send)], f"the field in {field.dtype}")
    del ub
    sent = hk.pack_boundary(u, send)
    flats = [u[(..., *r)].flatten(-3) for r in send]
    shell = torch.zeros(points, dtype=torch.bool)
    for r in send:
        shell[r] = True
    total, union = sent.shape[-1], int(shell.sum())
    rows.append(row("pack_boundary", lambda: hk.pack_boundary(u, send),
                    lambda: ref.pack_boundary(u, send),
                    lambda: torch.cat(flats, dim=-1), 2 * n_ranks * total * itemsize))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, send, 1, sent.numel() * itemsize)
    acc = u.clone()
    # the library call: one index_add_ of the whole buffer at the blocks'
    # flat indices (built here, outside the timed window); it adds the
    # overlapping regions in another order at edges and corners, so it is
    # timed, not compared
    index = torch.arange(points[0] * points[1] * points[2], device=u.device).view(points)
    idx = torch.cat([index[r].flatten() for r in back])
    acc_rows, sent_rows = acc.view(n_ranks, -1), sent.view(n_ranks, -1)
    rows.append(row("unpack_boundary_add", lambda: hk.unpack_boundary_add(acc, sent, back),
                    lambda: ref.unpack_boundary_add(acc, sent, back),
                    lambda: acc_rows.index_add_(1, idx, sent_rows),
                    n_ranks * (total + 2 * union) * itemsize, n_ops=n_ranks * total))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, back, 2, sent.numel() * itemsize)
    rows[-1]["library_call"] = ("index_add_ at the regions' flat indices (adds in another "
                                "order where regions overlap: timed, not compared)")

    # pack_segments / unpack_segments: replay the coalescing plan of the
    # path's batch with both versions, transfer by transfer
    low = Lowering(prog)
    gen = torch.Generator(u.device).manual_seed(1)
    mem = {n: torch.randn(s.shape, dtype=s.dtype, device=u.device, generator=gen)
           for n, s in prog.buffers.items()}
    packs, unpacks = replay_plan(low, prog.batches[0], mem, hk, ref, same)

    # a relay-heavy bf16 member set at columns that break 16-byte
    # alignment (sizes 1, 3, 127, 16384; relays through strided views),
    # one launch, bit for bit
    recv = torch.randn(n_ranks, 2 * 16384 + 301, device=u.device, generator=gen).bfloat16()
    slab = torch.randn(n_ranks, 127, device=u.device, generator=gen).bfloat16()
    relays = [(recv, 1), (recv, 5), (recv[:, 3:], 17), (recv, 301), (slab, 0),
              (recv[:, 1:], 16601), (recv, 0)]
    relay_sizes = [1, 3, 127, 16384, 127, 16384, 3]
    before = hk.pack_segments.launches
    staged = hk.pack_segments(relays, relay_sizes)
    require(hk.pack_segments.launches == before + 1, "pack_segments: not one launch")
    same("pack_segments", [staged], [ref.pack_segments(relays, relay_sizes)],
         "the bf16 relay set")

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


def replay_plan(low, batch, mem, hk, ref, same, what: str = ""):
    """Replay one batch's coalescing plan transfer by transfer, as
    ``_run_coalesced_batch`` runs it, through ``pack_segments`` and
    ``unpack_segments`` and their plain versions, held equal by
    ``same(name, got, want, what)``.  Returns each pack's ``(sources,
    sizes)`` and each unpack's ``(received, outs, offsets, masks)``."""
    plan, consts, n = batch.plan, low.plans[batch.index], low.n_ranks
    received, packs, unpacks = [], [], []
    for ti, (t, route) in enumerate(zip(plan.transfers, consts.routes)):
        sources = []
        for seg in t.segments:
            if seg.hop == 0:
                ch = plan.channels[seg.channel]
                src = low.ranks(mem[ch.src_buf])
                if ch.send_region is not None:
                    src = src[low.local_region(ch.send_region)]
                sources.append((src.reshape(n, -1), 0))
            else:
                pt, po = plan.routes[seg.channel][seg.hop - 1]
                sources.append((received[pt], po))
        sizes = [seg.size for seg in t.segments]
        staged = hk.pack_segments(sources, sizes)
        same("pack_segments", [staged], [ref.pack_segments(sources, sizes)],
             f"{what}batch {batch.index}, transfer {ti}")
        received.append(low.permute(staged, route))
        packs.append((sources, sizes))
    for ti, (chans, offs, masks) in consts.direct.items():
        outs = [mem[plan.channels[ci].dst_buf] for ci in chans]
        got, want = [o.clone() for o in outs], [o.clone() for o in outs]
        hk.unpack_segments(received[ti], got, offs, masks)
        ref.unpack_segments(received[ti], want, offs, masks)
        same("unpack_segments", got, want, f"{what}batch {batch.index}, transfer {ti}")
        unpacks.append((received[ti], got, offs, masks))
    return packs, unpacks


def check_part_shapes(torch, cfg, mesh, hk, ref):
    """Phase 5, part shapes: the four Faces kernels against their plain
    versions, bit for bit, on the blocks of the 2- and 4-part splits (all
    26 regions, the unpack in float32 and bf16) and on every coalescing
    plan of the linked schedules (ghost-plane batches with their send
    regions, cross payloads), replayed transfer by transfer as
    ``_run_coalesced_batch`` runs them."""
    from repro_torch.core import build_faces_pipeline, part_configs
    from repro_torch.core.engine_fused import Lowering
    from repro_torch.core.halo import DIRECTIONS, _region_for

    def same(name, got, want, what):
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name} != plain: {what}")

    gen = torch.Generator("cuda").manual_seed(2)
    out = {}
    for n_parts in PARTS:
        points = part_configs(cfg, n_parts)[0].points
        u = torch.randn(*cfg.grid, *points, device="cuda", generator=gen)
        for d in DIRECTIONS:
            region = _region_for(d, points)
            require(torch.equal(hk.halo_pack(u, region), ref.halo_pack(u, region)),
                    f"halo_pack != plain at part points {points}, direction {d}")
            for field in (u, u.bfloat16()):
                msg = ref.halo_pack(torch.roll(field, 1, 0), region)
                require(torch.equal(hk.halo_unpack_add(field.clone(), msg, region),
                                    ref.halo_unpack_add(field.clone(), msg, region)),
                        f"halo_unpack_add != plain at {points}, {d}, {field.dtype}")
        sched = build_faces_pipeline(cfg, mesh, n_parts)
        low = Lowering(sched)
        mem = {name: torch.randn(spec.shape, device="cuda", generator=gen)
               for name, spec in sched.buffers.items()}
        transfers = unpacks = 0
        for b in sched.batches:
            if b.plan is not None:
                packs, done = replay_plan(low, b, mem, hk, ref, same, f"{n_parts} parts, ")
                transfers, unpacks = transfers + len(packs), unpacks + len(done)
        out[f"parts{n_parts}"] = {"points": points, "regions": len(DIRECTIONS),
                                  "transfers": transfers, "unpacks": unpacks,
                                  "equal_bitwise": True}
    return out


def graph_shape(torch, graph_loop, eng) -> dict:
    """One pass of ``eng`` captured again with its graph kept: node counts
    by type and the largest set of kernel nodes no edge path orders (one
    stream's work is a chain: width 1 a stream)."""
    eng.compile()
    graph, _ = graph_loop.capture(lambda: eng._run_into(eng._bufs))
    names, edges = graph_loop.graph_edges(graph)
    kernels = [i for i, t in enumerate(names) if t == "kernel"]
    return {"nodes": len(names), "kernel_nodes": len(kernels), "edges": len(edges),
            "width": graph_loop.dag_width(len(names), edges, kernels),
            "node_types": graph_loop.node_types(graph)}


def run_pipeline(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 12: the linked N-part pipeline at full width against the
    full-domain persistent run; returns the phase's line and every
    program it built (for phase 13)."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine,
                                  build_faces_pipeline, build_faces_program, merge_parts,
                                  part_configs, part_names, run_faces_persistent,
                                  run_faces_pipelined, split_parts)

    def parts_init(n_parts):
        return dict(zip([f"{n}/u" for n in part_names(n_parts)], split_parts(u0, n_parts)))

    def merged(mem, n_parts):
        return merge_parts([mem[f"{n}/u"] for n in part_names(n_parts)])

    def counted(what, fn):
        # the counts of one composed run alone: set to 0 just before it, read
        # just after, and every Faces kernel must have launched in it
        torch.cuda.synchronize()
        hk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {n: hk.launch_counts()[n] for n in FACES_KERNELS}
        require(all(counts.values()), f"{what}: a kernel of the composed path never "
                f"launched: {counts}")
        return out, counts

    prog = build_faces_program(cfg, mesh)
    built, modes = [prog], {}
    launches = dict.fromkeys(FACES_KERNELS, 0)
    for mode in ("stream", "dataflow"):
        full = PersistentEngine(prog.persistent(N_ITERS), mode=mode, donate=True)
        full_init = full.init_buffers({"u": u0})
        full.compile()
        want = full(full_init)["u"].clone()
        row = {"full_ms_per_iter": events_ms(torch, lambda: full(full_init)) / N_ITERS,
               "full_graph": graph_shape(torch, graph_loop, FusedEngine(prog, mode=mode)),
               "full_profile": profile_calls(torch, lambda: full(full_init))}
        require(row["full_graph"]["width"] == (1 if mode == "stream" else 2),
                f"{mode}: the plain program's pass is {row['full_graph']['width']} wide")
        for n_parts in PARTS:
            what = f"{mode}, {n_parts} parts"
            t0 = time.perf_counter()
            (mem, stats), pipelined_counts = counted(what, lambda: run_faces_pipelined(
                cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts, mode=mode))
            first_wall = (time.perf_counter() - t0) * 1e3
            require((stats.dispatches, stats.sync_points) == (1, 0),
                    f"{mode}, {n_parts} parts: run_faces_pipelined took {stats}")
            require(torch.equal(merged(mem, n_parts), want), f"{mode}, {n_parts} parts: "
                    "the linked pipeline differs from the full domain")
            del mem
            sched = build_faces_pipeline(cfg, mesh, n_parts, N_ITERS)
            built.append(sched)
            eng = PersistentEngine(sched, mode=mode, donate=True)
            init = eng.init_buffers(parts_init(n_parts))

            def engine_run():
                eng.compile()
                return merged(eng(init), n_parts)

            got, engine_counts = counted(what, engine_run)
            require(torch.equal(got, want),
                    f"{mode}, {n_parts} parts: the engine differs from the full domain")
            for n in FACES_KERNELS:
                launches[n] += pipelined_counts[n] + engine_counts[n]
            require(eng.stats.dispatches == eng.graph_launches == 1,
                    f"{mode}, {n_parts} parts: {eng.stats.dispatches} dispatches, "
                    f"{eng.graph_launches} graph launches")
            ms = events_ms(torch, lambda: eng(init)) / N_ITERS
            profile = profile_calls(torch, lambda: eng(init))
            one_pass = build_faces_pipeline(cfg, mesh, n_parts)
            built.append(one_pass)
            shape = graph_shape(torch, graph_loop, FusedEngine(one_pass, mode=mode))
            wide = (shape["width"] == n_parts if mode == "stream"
                    else n_parts < shape["width"] <= 2 * n_parts)
            require(wide, f"{mode}, {n_parts} parts: the pass is {shape['width']} wide")
            del eng, init, got
            unlinked, _ = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts,
                                              mode=mode, exchange=False)
            for name, pcfg, part in zip(part_names(n_parts), part_configs(cfg, n_parts),
                                        split_parts(u0, n_parts)):
                alone, _ = run_faces_persistent(pcfg, mesh, part, n_iters=N_ITERS, mode=mode)
                require(torch.equal(unlinked[f"{name}/u"], alone["u"]),
                        f"{mode}: unlinked part {name} differs from its own run")
            del unlinked, alone
            built.append(build_faces_pipeline(cfg, mesh, n_parts, N_ITERS, exchange=False))
            row[f"parts{n_parts}"] = {
                "ms_per_iter": ms, "vs_full": ms / row["full_ms_per_iter"],
                "first_call_wall_ms": first_wall, "dispatches": 1, "graph_launches": 1,
                "links": len(sched.links), "graph": shape, "profile": profile,
                "launches": {"run_faces_pipelined": pipelined_counts,
                             "PersistentEngine": engine_counts},
                "equal_to_full_bitwise": True,
                "unlinked_equal_to_parts_bitwise": True}
        modes[mode] = row
        del full, full_init, want
    one = build_faces_pipeline(cfg, mesh, 2)
    for cls, kw in ((HostEngine, {}), (FusedEngine, {"mode": "stream"}),
                    (FusedEngine, {"mode": "dataflow"})):
        split, whole = cls(one, **kw), cls(prog, **kw)
        got = merged(split(split.init_buffers(parts_init(2))), 2)
        require(torch.equal(got, whole(whole.init_buffers({"u": u0}))["u"]),
                f"{cls.__name__} {kw}: one pass of the 2-part schedule differs")
    return {"card": card, "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
            "modes": modes, "one_pass_host_and_fused_equal": True,
            "launches": launches}, built


def run_verifier(torch, cfg, mesh, u0, card: str, hk, built):
    """Phase 13: the verifier on every program built, the sanitizer's
    parity and cost, and the racy mutation refused before any launch."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine, SanitizeError,
                                  build_faces_pipeline, part_names, split_parts,
                                  verify_program)
    from repro_torch.core.descriptors import KernelDesc, WaitDesc

    for p in built:
        diags = verify_program(p)
        require(diags == [], f"verify_program({p.name}): {[str(d) for d in diags[:3]]}")
    largest = max(built, key=lambda p: len(p.descriptors))
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify_program(largest)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    prog = built[0]
    parts = dict(zip([f"{n}/u" for n in part_names(2)], split_parts(u0, 2)))
    cases = {"faces": (prog, prog.persistent(N_ITERS), {"u": u0}),
             "parts2": (build_faces_pipeline(cfg, mesh, 2),
                        build_faces_pipeline(cfg, mesh, 2, N_ITERS), parts)}
    sanitizer = {}
    for mode in ("stream", "dataflow"):
        for name, (one_pass, loop, init) in cases.items():
            for cls, p, per in ((FusedEngine, one_pass, 1), (PersistentEngine, loop, N_ITERS)):
                row = {}
                outs = []
                for sanitize in (False, True):
                    eng = cls(p, mode=mode, donate=True, sanitize=sanitize)
                    own = eng(eng.init_buffers(init))  # the engine's own buffers
                    outs.append({k: t.clone() for k, t in own.items()})
                    # calls on the engine's own buffers: no copy-in, the graph alone
                    row["sanitized_ms_per_iter" if sanitize else "ms_per_iter"] = \
                        events_ms(torch, lambda: eng(own)) / per
                    if cls is PersistentEngine and name == "faces" and mode == "stream":
                        row["sanitized_profile" if sanitize else "profile"] = \
                            profile_calls(torch, lambda: eng(own))
                    del eng, own
                require(all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0]),
                        f"{cls.__name__} {mode} {name}: sanitize=True changed the result")
                row["equal_bitwise"] = True
                sanitizer[f"{cls.__name__}/{name}/{mode}"] = row
                del outs

    descs = list(prog.descriptors)
    wi = max(i for i, d in enumerate(descs) if isinstance(d, WaitDesc))
    ki = next(i for i, d in enumerate(descs) if i > wi and isinstance(d, KernelDesc))
    descs.insert(wi, descs.pop(ki))
    bad = dataclasses.replace(prog, descriptors=tuple(descs))
    torch.cuda.synchronize()
    hk.reset_launches()
    refused = []
    for cls in (FusedEngine, PersistentEngine, HostEngine):
        try:
            cls(bad, sanitize=True)
        except SanitizeError as e:
            refused.append((cls.__name__, str(e)[:160]))
    launched = hk.launch_counts()
    require(len(refused) == 3, f"the racy program was accepted: refused only by {refused}")
    require(not any(launched.values()), f"a refused engine launched kernels: {launched}")
    silent = FusedEngine(bad)
    silent(silent.init_buffers({"u": u0}))
    torch.cuda.synchronize()
    require(silent.stats.dispatches == 1, "the unsanitized engine did not run the racy program")
    # the program registry on the benchmark grid's 8 ranks, on the card
    from repro_torch.analysis import certificates, lint_all
    lint = lint_all()
    require(all(not d for _, d in lint), "a registry program does not lint clean: "
            f"{[(n, [str(x) for x in d[:2]]) for n, d in lint if d]}")
    certs = certificates()
    require(all(c.race_free for _, c in certs),
            f"racy registry programs: {[n for n, c in certs if not c.race_free]}")
    return {"card": card, "verified": len(built), "diagnostics": 0,
            "registry": {"programs": len(lint), "clean": True, "race_free": True,
                         "digests": {n: c.digest for n, c in certs}},
            "largest": {"name": largest.name, "descriptors": len(largest.descriptors),
                        "verify_host_ms": statistics.median(host_ms)},
            "sanitizer": sanitizer,
            "race": {"refused": refused, "launches_when_refused": launched,
                     "unsanitized_dispatches": silent.stats.dispatches}}


def run_serve(torch, seed: int, arch: str, shape: dict):
    """Serve ``arch`` at full size in both decode modes (phases 6 and 9).

    One serve per mode first captures the prefill and decode graphs
    (set-up, as a server does once); then each mode serves once more.
    Every kernel counter is set to 0 just before the set-up and read
    after the last serve (the launches of the main path: the graphs'
    eager warm-up passes and their captures), and read around each
    served run too, which replays graphs only and so launches no kernel
    eagerly.  Returns the runs as (tokens, stats, kernel launches, graph
    launches by dispatch kind), and the whole window's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch

    cfg = get_config(arch)
    eng = ServeEngine(cfg, slots=shape["batch"], prompt_len=shape["prompt_len"],
                      max_new=shape["gen_len"], chunk=shape["gen_len"] - 1)
    params = eng.model.init(seed)
    batch_in = synthetic_batch(cfg, np.random.RandomState(seed), shape["batch"],
                               shape["prompt_len"])
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    for resident in (True, False):
        serve(cfg, params=params, batch_in=batch_in, engine=eng,
              device_resident=resident, **shape)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs = {}
    for resident in (True, False):
        torch.cuda.synchronize()
        counts, graphs = ops.launch_counts(), eng.graph_launches
        gen, stats = serve(cfg, params=params, batch_in=batch_in, engine=eng,
                           device_resident=resident, **shape)
        torch.cuda.synchronize()
        counts = {k: n - counts[k] for k, n in ops.launch_counts().items()}
        graphs = {k: n - graphs[k] for k, n in eng.graph_launches.items()}
        runs["resident" if resident else "host_stepped"] = (gen, stats, counts, graphs)
    return cfg, eng, params, batch_in, runs, setup_s, ops.launch_counts()


def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attention, halo_pack, rmsnorm, ssd_scan

    for module in (flash_attention, halo_pack, rmsnorm, ssd_scan):
        module.reset_launches()


def serve_report(torch, cfg, eng, shape, runs, setup_s, launches) -> dict:
    """The serve line of phases 6 and 9; requires the dispatch counts,
    one prefill graph launch and no eager kernel launch per served run."""
    steps = shape["gen_len"] - 1
    line = {"model": cfg.name, **shape, "setup_s": setup_s, "launches": launches,
            "prefill_graph_holds": eng.captured_launches("prefill")}
    for mode, (gen, stats, counts, graphs) in runs.items():
        line[mode] = {
            "prefill_ms": stats["prefill_s"] * 1e3, "decode_ms": stats["decode_s"] * 1e3,
            "decode_ms_per_token": stats["decode_s"] * 1e3 / steps,
            "tok_per_s": stats["tok_per_s"], "decode_tokens": stats["decode_tokens"],
            "dispatches": stats["dispatches"],
            "decode_dispatches": stats["decode_dispatches"], "graph_launches": graphs,
            "eager_kernel_launches": sum(counts.values())}
    require((line["resident"]["dispatches"], line["resident"]["decode_dispatches"]) == (2, 1),
            f"resident dispatches {line['resident']}")
    require(line["host_stepped"]["decode_dispatches"] == steps,
            f"host-stepped dispatches {line['host_stepped']}")
    want = {"resident": {"prefill": 1, "decode": 1, "decode_one": 0},
            "host_stepped": {"prefill": 1, "decode": 0, "decode_one": steps}}
    for mode, w in want.items():
        require(line[mode]["graph_launches"] == w,
                f"{mode}: graph launches {line[mode]['graph_launches']} != {w} (the "
                "prefill must be one graph launch after set-up)")
        require(line[mode]["eager_kernel_launches"] == 0,
                f"{mode}: a served run launched kernels eagerly: {runs[mode][2]}")
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return line


def check_serving(torch, eng, params, batch_in, runs, shape) -> dict:
    """Phases 7 and 9: equal tokens in both modes; the graphed prefill
    equal to an eager ``Model.prefill`` (logits and caches) and
    ``forward_logits`` to the prefill's last-position logits, bit for
    bit; finite logits.  Returns the eager prefill's kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.nn import tree_leaves

    res, host = runs["resident"][0], runs["host_stepped"][0]
    require(res.shape == (shape["batch"], shape["gen_len"]), f"tokens of shape {res.shape}")
    require(bool((res == host).all()), "resident and host-stepped tokens differ")
    require(bool(((res >= 0) & (res < eng.cfg.vocab)).all()), "tokens out of the vocabulary")
    cast = eng.cast_params(params)
    graphed, graphed_caches = eng.prefill(params, batch_in, eng.init_state()[0])
    torch.cuda.synchronize()
    before = ops.launch_counts()
    pre, pre_caches = eng.model.prefill(cast, batch_in, eng.init_state()[0])
    torch.cuda.synchronize()
    eager = {k: n - before[k] for k, n in ops.launch_counts().items() if n > before[k]}
    full = eng.model.forward_logits(cast, batch_in)
    last = full[:, -1]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(full).all()),
            "non-finite logits")
    require(torch.equal(graphed, pre) and all(
        torch.equal(g, e) for g, e in zip(tree_leaves(graphed_caches), tree_leaves(pre_caches))),
        "the graphed prefill differs from the eager one")
    # With empty caches, prefill and forward_logits run the same kernels on
    # the same inputs: equal bit for bit
    require(torch.equal(pre, last), "forward_logits differs from the prefill's logits "
            f"(max abs diff {float((pre.float() - last.float()).abs().max())})")
    return {"tokens_equal": True, "logits_finite": True,
            "graphed_vs_eager_prefill_bitwise": True,
            "forward_vs_prefill_bitwise": True, "eager_prefill_launches": eager,
            "last_logit_abs_max": float(pre.float().abs().max())}


def print_profiles(torch, eng, params, batch_in, tag: str) -> None:
    """Where the time of one prefill (eager, and the served graph) and one
    decode step goes."""
    cast = eng.cast_params(params)
    caches, tok, _, _ = eng.init_state()
    pre_caches = eng.model.prefill(cast, batch_in, caches)[1]
    print(json.dumps({f"profile_prefill{tag}": profile_calls(
        torch, lambda: eng.model.prefill(cast, batch_in, caches))}), flush=True)
    fresh = eng.init_state()[0]   # the graph copies these in; they stay empty
    print(json.dumps({f"profile_prefill_graph{tag}": profile_calls(
        torch, lambda: eng.prefill(params, batch_in, fresh), calls=3)}), flush=True)
    print(json.dumps({f"profile_decode_step{tag}": profile_calls(
        torch, lambda: eng.model.decode_step(cast, pre_caches, tok))}), flush=True)
    graph_caches = eng.decode_one(params, pre_caches, tok)[1]  # the graph's own buffers
    print(json.dumps({f"profile_decode_graph{tag}": profile_calls(
        torch, lambda: eng.decode_one(params, graph_caches, tok))}), flush=True)


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


def served_ssd_inputs(torch, gen, B, S, H, G, kind="served", h0=True, P=64, N=128):
    """bf16 x, B and C as views of one conv output (row stride H P + 2 G
    N), float32 dt, A and init_state: ``"served"`` as the mamba2 prefill
    draws them (softplus dt, A = -exp(A_log) at init), ``"extreme"`` the
    extreme decay of ``tests/test_torch_gpu.py`` (dt ~ 1, A = -e)."""
    wide = torch.randn(B, S, H * P + 2 * G * N, device="cuda", generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    if kind == "served":
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
    else:
        dt = 1.0 + 0.01 * torch.rand(B, S, H, device="cuda", generator=gen)
    A = torch.full((H,), -2.718281828, device="cuda")
    h = torch.randn(B, H, P, N, device="cuda", generator=gen) if h0 else None
    return x, dt, A, Bm, C, h


def served_ssd_bound(torch, ref, y, h, x, dt, A, Bm, C, h0):
    """y and h against the plain version within the served bf16 bound:
    the largest shares of the bound used, and the largest errors.

    Bound: the plain version rounds each x*B product to bf16 (2^-8 of
    that term) where the kernel widens to float32 first; both round y to
    bf16 (2^-8 of each); 2^-10 of the terms' magnitudes covers float32
    reassociation, the chunked exponent's rounding and the tensor-core
    kernel's bf16 parts.  yabs, habs: the scan of |x|, |B|, |C|, |h0| --
    the sum of the terms' magnitudes."""
    yp, hp = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=None if h0 is None else h0.abs(), return_state=True)
    dy = (y.float() - yp.float()).abs()
    tol_y = 2.0 ** -8 * (y.float().abs() + yp.float().abs()) + (2.0 ** -8 + 2.0 ** -10) * yabs
    dh = (h - hp).abs()
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    require(bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all()),
            f"ssd_scan: non-finite output at {tuple(x.shape)}")
    require(bool((dy <= tol_y).all()) and bool((dh <= tol_h).all()),
            f"ssd_scan != plain beyond the served bf16 bound at {tuple(x.shape)}")
    return {"y_max_abs_err": float(dy.max()),
            "y_max_rel_err": float(dy.max() / yp.float().abs().max()),
            "y_bound_used": float((dy / tol_y).max()),
            "h_max_abs_err": float(dh.max()),
            "h_max_rel_err": float(dh.max() / hp.abs().max()),
            "h_bound_used": float((dh / tol_h).max())}


def cuda_core_ssd(torch, x, dt, A, Bm, C, h0):
    """The CUDA-core SSD kernel (the port's kernel before the tensor-core
    one; the route rule now gives it float32 and other shapes) on bf16
    inputs at chunk 128, called through its C entry point: its time at
    the served shapes is the SSD row's ``earlier_ms``."""
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = load_library("ssd_scan", sk.SIGNATURES).rt_ssd_scan(
        1, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, P, G, N, 128, *x.stride()[:3],
        *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3], stream_arg(x))
    check_launch("ssd_scan", err)
    return y, h


def check_ssd(torch, ssd, ref, seed: int):
    """Phase 8: the SSD kernel against its plain version on both routes;
    returns its kernel-table row and the details of the check."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def on_route(route, fn):
        """``fn()``, required to launch the SSD kernel once, on ``route``."""
        before = ssd.launch_counts()
        out = fn()
        moved = {k: v - before[k] for k, v in ssd.launch_counts().items() if v != before[k]}
        require(moved == {"ssd_scan": 1, f"ssd_scan_{route}": 1},
                f"ssd_scan took {moved}, not one launch on the {route} route")
        return out

    fp32_err = 0.0
    # tests/test_kernels.py SSD_CASES, its init_state case, a tail case:
    # float32, the CUDA-core route
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
        got = on_route("cuda_core", lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h,
                                                          chunk=chunk, return_state=True))
        want = ref.ssd_scan(x, dt, A, Bm, C, init_state=h, return_state=True)
        for g, w in zip(got, want):
            fp32_err = max(fp32_err, float((g - w).abs().max()))
            require(torch.allclose(g, w, rtol=2e-4, atol=3e-5),
                    f"ssd_scan != plain on float32 case S={S} chunk={chunk}")

    # served prefill shapes, bf16; x, B, C are views of the conv output
    B, S, H, P, G, N = SERVE["batch"], SERVE["prompt_len"], 80, 64, 1, 128
    x, dt, A, Bm, C, h0 = served_ssd_inputs(torch, gen, B, S, H, G)
    route = ssd.route(x.dtype, P, N, 128)
    y, h = on_route(route, lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128,
                                                return_state=True))
    served = served_ssd_bound(torch, ref, y, h, x, dt, A, Bm, C, h0)
    # bf16 at the served widths, the tensor-core route: a short last chunk
    # with init_state and 2 groups, more chunks than a cluster holds (11
    # chunks: the cluster of 8 walks two groups), and the extreme decay of
    # tests/test_torch_gpu.py, whose state is also held to that test's
    # bound against the plain version of the same values in float32
    cases = {}
    for shape in [(2, 300, 8, 2, "served", True), (1, 1300, 2, 1, "served", True),
                  (1, 256, 2, 1, "extreme", False)]:
        args = served_ssd_inputs(torch, gen, *shape)
        yc, hc = on_route("wgmma", lambda: ssd.ssd_scan(*args[:5], init_state=args[5],
                                                        chunk=128, return_state=True))
        key = "B{}_S{}_H{}_G{}_{}".format(*shape)
        cases[key] = served_ssd_bound(torch, ref, yc, hc, *args)
        if shape[4] == "extreme":
            xf, Bf, Cf = (t.float() for t in (args[0], args[3], args[4]))
            dtc, Ac = args[1], args[2]
            _, hf = ref.ssd_scan(xf, dtc, Ac, Bf, Cf, return_state=True)
            _, habs = ref.ssd_scan(xf.abs(), dtc, Ac, Bf.abs(), Cf.abs(), return_state=True)
            tol = 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs
            require(bool(((hc - hf).abs() <= tol).all()),
                    "ssd_scan: the state beyond the extreme-decay bound in bf16")
            cases[key]["h_extreme_decay_bound_used"] = float(((hc - hf).abs() / tol).max())

    flops, n_bytes = ssd_flops_bytes(B, S, H, P, G, N, 128, 2, True)
    # the products at the peak of the route's type: bf16 tensor cores, or
    # float32 on CUDA cores
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_OPS_PER_S if route == "wgmma" else FP32_OPS_PER_S)
    row = {
        "name": "ssd_scan", "route": "cuda", "kernel_route": route,
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan"], "max_abs_err": served["y_max_abs_err"],
        "ms": median_ms(torch, lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                     chunk=128, return_state=True)),
        "plain_ms": median_ms(torch, lambda: ref.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                          return_state=True),
                              reps=3, inner=2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the chunked scan
        "earlier_ms": median_ms(torch, lambda: cuda_core_ssd(torch, x, dt, A, Bm, C, h0)),
    }
    detail = {
        "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": 128},
        "route": route, "parts": list(ssd.PARTS), "cluster": ssd.default_cluster(S),
        "flops": flops, "bytes": n_bytes,
        "float32_ops_bound_ms": flops / FP32_OPS_PER_S * 1e3,
        "fp32_cases_max_abs_err": fp32_err,
        "served": served, "bf16_cases": cases,
    }
    return row, detail


def bf16_close(torch, got, want):
    """(within the bound, share of the bound used): both sides are float32
    results rounded to bf16, so they may land one ulp apart, at most 2^-8
    of their magnitudes, where the float32 values straddle a rounding
    boundary; 1e-6 absolute covers float32 reassociation near zero."""
    g, w = got.float(), want.float()
    d, tol = (g - w).abs(), 2.0 ** -8 * (g.abs() + w.abs()) + 1e-6
    return bool((d <= tol).all()), float((d / tol).max())


def attention_pairs(Sq: int, Skv: int, q_offset: int, window) -> int:
    """(query, key) pairs a causal attention with this window computes."""
    total = 0
    for i in range(Sq):
        hi = min(Skv, q_offset + i + 1)
        lo = 0 if window is None else max(0, q_offset + i - window + 1)
        total += max(0, hi - lo)
    return total


def cuda_core_flash(torch, q, k, v, window):
    """The CUDA-core flash kernel (the port's kernel before the tensor-core
    one; the route rule now gives it float32 and head_dims 16 and 32) on
    bf16 q, k, v, called through its C entry point: its time on the
    served layers is the flash row's ``earlier_ms``."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, Hq, Sq, D = q.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = load_library("flash_attention", fk.SIGNATURES).rt_flash_attention(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, k.shape[1], Sq,
        k.shape[2], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        D ** -0.5, 0.0, 1, -1 if window is None else int(window), 0, stream_arg(q))
    check_launch("flash_attention", err)
    return out


def check_dense_kernels(torch, eng, params, batch_in, fk, rk, ref, seed: int):
    """Phase 10: flash attention and rmsnorm against their plain versions;
    returns their kernel-table rows and the details of the checks."""
    import torch.nn.functional as F

    from repro_torch.models import nn, transformer as tfm

    cfg = eng.model.cfg
    cast = eng.cast_params(params)
    seg = cast["decoder"]["segments"][0]
    tokens = batch_in["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = nn.apply_embedding(cast["embed"], tokens, cfg)
    x0 = x
    detail, flash_err, layers = {}, 0.0, {}
    for li in range(6):   # layer 0 is local, layer 5 the first global one
        p = tfm.layer_params(seg, li)
        window, theta = tfm.layer_window_theta(cfg, li)
        if li in (0, 5):
            h = nn.apply_rmsnorm(p["ln_attn"], x, cfg)
            q, k, v = nn.attention_qkv(p["attn"], h, cfg, rope_theta=theta,
                                       positions=positions)
            layers[li] = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          window or None)
        x, _ = tfm.apply_block(p, x, cfg, "attn_mlp", window=window, rope_theta=theta,
                               positions=positions)

    def on_route(route, fn):
        """``fn()``, required to launch flash once, on ``route``."""
        before = fk.launch_counts()
        out = fn()
        after = fk.launch_counts()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(moved == {"flash_attention": 1, f"flash_attention_{route}": 1},
                f"flash_attention took {moved}, not one launch on the {route} route")
        return out

    for li, (q, k, v, window) in layers.items():
        got = on_route("wgmma", lambda: fk.flash_attention(q, k, v, window=window))
        want = ref.attention(q, k, v, window=window)
        ok, used = bf16_close(torch, got, want)
        err = float((got.float() - want.float()).abs().max())
        flash_err = max(flash_err, err)
        require(ok, f"flash_attention != plain on the served layer {li} beyond one bf16 "
                f"rounding (max abs err {err})")
        detail[f"layer{li}"] = {"window": window, "max_abs_err": err, "bound_used": used,
                                "out_abs_max": float(want.float().abs().max())}
        if window is None:   # the library call on the same input, for comparison only
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            detail[f"layer{li}"]["sdpa_bound_used"] = bf16_close(torch, lib, want)[1]

    # bf16 at head_dim 64 / 128 / 256 (GQA, ragged, an offset, a window, a
    # softcap), at the served layers' bound
    gen = torch.Generator("cuda").manual_seed(seed)
    used_max = 0.0
    for B, Hq, Hkv, Sq, Skv, D, kw in [
            (2, 4, 4, 100, 100, 64, dict()),
            (1, 8, 2, 130, 130, 128, dict(window=7)),
            (1, 8, 1, 200, 333, 256, dict(q_offset=133)),
            (1, 2, 1, 96, 96, 64, dict(logit_softcap=15.0)),
            (2, 4, 2, 1, 300, 256, dict(q_offset=299))]:
        qb, kb, vb = (torch.randn(B, H, S, D, device="cuda", generator=gen).bfloat16()
                      for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
        got = on_route("wgmma", lambda: fk.flash_attention(qb, kb, vb, **kw))
        ok, used = bf16_close(torch, got, ref.attention(qb, kb, vb, **kw))
        used_max = max(used_max, used)
        require(ok, f"flash_attention != plain on bf16 case {(B, Hq, Hkv, Sq, Skv, D, kw)}")
    detail["bf16_cases_bound_used"] = used_max

    # float32: the cases of tests/test_kernels.py (softcap, one query at an
    # offset, a window, ragged kv) and head_dim 128 and 256; the repo's
    # kernel-vs-reference bound, rtol 2e-4 / atol 3e-5
    fp32_err = 0.0
    for B, Hq, Hkv, Sq, Skv, D, kw in [
            (1, 2, 1, 64, 64, 32, dict()),
            (2, 4, 4, 48, 48, 16, dict(causal=False)),
            (1, 2, 2, 64, 64, 32, dict(window=19)),
            (1, 2, 1, 64, 64, 32, dict(logit_softcap=15.0)),
            (2, 4, 1, 1, 80, 32, dict(q_offset=79)),
            (1, 8, 2, 32, 96, 64, dict(q_offset=64)),
            (1, 2, 1, 50, 70, 32, dict(causal=False)),
            (1, 4, 2, 100, 100, 128, dict(window=7)),
            (2, 4, 1, 70, 200, 256, dict(q_offset=130, window=40)),
            (1, 4, 1, 300, 300, 256, dict())]:
        qf = torch.randn(B, Hq, Sq, D, device="cuda", generator=gen)
        kf = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen)
        vf = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen)
        got = on_route("cuda_core", lambda: fk.flash_attention(qf, kf, vf, **kw))
        want = ref.attention(qf, kf, vf, **kw)
        fp32_err = max(fp32_err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=2e-4, atol=3e-5),
                f"flash_attention != plain on float32 case {(B, Hq, Hkv, Sq, Skv, D, kw)}")
    detail["fp32_cases_max_abs_err"] = fp32_err
    detail["fp32_b1_h4_s300_d256_cuda_core_ms"] = median_ms(
        torch, lambda: fk.flash_attention(qf, kf, vf))

    # timed at the served global layer; bound: the pairs this input needs
    # in bf16 products summed in float32 (what the tensor cores compute)
    q, k, v, _ = layers[5]
    B, Hq, S, D = q.shape
    flops = {li: 4 * B * Hq * D * attention_pairs(S, S, 0, w)
             for li, (_, _, _, w) in layers.items()}
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ql, kl, vl, wl = layers[0]
    pos = torch.arange(S, device="cuda")
    local_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - wl)
    detail["flops"] = flops
    detail["bytes"] = n_bytes
    detail["local_layer0"] = {
        "ms": median_ms(torch, lambda: fk.flash_attention(ql, kl, vl, window=wl)),
        "earlier_ms": median_ms(torch, lambda: cuda_core_flash(torch, ql, kl, vl, wl)),
        "sdpa_window_mask_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=local_mask, enable_gqa=True)),
        "bound_ms": max(flops[0] / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3}
    rows = [kernel_row(
        torch, "flash_attention", "flash_attention.cu", flash_err,
        lambda: fk.flash_attention(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        n_bytes, flops[5], BF16_OPS_PER_S, plain_reps=(5, 4))]
    rows[0]["earlier_ms"] = median_ms(torch, lambda: cuda_core_flash(torch, q, k, v, None))
    require(bf16_close(torch, cuda_core_flash(torch, q, k, v, None), ref.attention(q, k, v))[0],
            "the CUDA-core kernel != plain on the served global layer")

    # rmsnorm: the served layer-0 input and sweeps of d, rows, offset
    norm_err = 0.0
    w = tfm.layer_params(seg, 0)["ln_attn"]["scale"]
    cases = [(x0, w, 1.0)]
    for rows_, d in [(37, 1152), (1001, 256), (7, 2560)]:
        for off in (0.0, 1.0):
            for dt in (torch.bfloat16, torch.float32):
                xs = torch.randn(rows_, d, device="cuda", generator=gen).to(dt)
                ws = torch.randn(d, device="cuda", generator=gen)
                cases.append((xs, ws, off))
    for xs, ws, off in cases:
        got = rk.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=off)
        want = ref.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=off)
        err = float((got.float() - want.float()).abs().max())
        norm_err = max(norm_err, err)
        if xs.dtype == torch.float32:
            require(torch.allclose(got, want, rtol=2e-5, atol=1e-5),
                    f"rmsnorm != plain at {tuple(xs.shape)} float32")
        else:
            require(bf16_close(torch, got, want)[0],
                    f"rmsnorm != plain at {tuple(xs.shape)} bf16 beyond one rounding")
    detail["rmsnorm_max_abs_err"] = norm_err
    # a row's output does not depend on the rows launched with it: the
    # served input's 4096 rows (the rows route) and its first 4 (the team
    # route) give the same first rows, bit for bit
    flat = x0.reshape(-1, x0.shape[-1])
    head = rk.rmsnorm(flat[:4], w, eps=cfg.norm_eps, weight_offset=1.0)
    full = rk.rmsnorm(flat, w, eps=cfg.norm_eps, weight_offset=1.0)
    require(torch.equal(head, full[:4]), "rmsnorm: the first 4 rows alone differ from the "
            "same rows of the served input")
    detail["rmsnorm_routes"] = {"served": rk.route(*flat.shape, flat.dtype),
                                "first_4_rows": rk.route(4, flat.shape[1], flat.dtype),
                                "rows_independent_bitwise": True}
    # the decode shapes: mamba2 (4 x 2560, 4 x 5120), gemma3 (4 x 1152 and
    # the qk-norm's 16 x 256), bf16 over a float32 weight, as served
    decode = []
    for rows_, d in [(4, 2560), (4, 5120), (4, 1152), (16, 256)]:
        xs = torch.randn(rows_, d, device="cuda", generator=gen).bfloat16()
        ws = torch.randn(d, device="cuda", generator=gen)
        ws1 = (ws + 1.0).bfloat16()
        require(bf16_close(torch, rk.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=1.0),
                           ref.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=1.0))[0],
                f"rmsnorm != plain at the decode shape {(rows_, d)} beyond one rounding")
        decode.append({
            "rows": rows_, "d": d, "route": rk.route(rows_, d, xs.dtype),
            "ms": median_ms(torch, lambda: rk.rmsnorm(xs, ws, eps=cfg.norm_eps,
                                                      weight_offset=1.0)),
            "library_ms": median_ms(torch, lambda: F.rms_norm(xs, (d,), weight=ws1,
                                                               eps=cfg.norm_eps)),
            "bound_ms": (2 * xs.numel() * 2 + d * 4) / HBM_BYTES_PER_S * 1e3})
    w1 = (w.float() + 1.0).to(x0.dtype)
    rows.append(kernel_row(
        torch, "rmsnorm", "rmsnorm.cu", norm_err,
        lambda: rk.rmsnorm(x0, w, eps=cfg.norm_eps, weight_offset=1.0),
        lambda: ref.rmsnorm(x0, w, eps=cfg.norm_eps, weight_offset=1.0),
        lambda: F.rms_norm(x0, (x0.shape[-1],), weight=w1, eps=cfg.norm_eps),
        2 * x0.numel() * x0.element_size() + w.numel() * w.element_size(), 0,
        FP32_OPS_PER_S))
    rows[-1]["decode"] = decode
    detail["rmsnorm_shape"] = list(x0.shape)
    return rows, detail


def events_ms(torch, fn, calls: int = 3) -> float:
    """Median device time of ``calls`` calls of ``fn`` (CUDA events)."""
    fn()
    windows = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        windows.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in windows)


def host_polled(torch, fused, residual, init, tol: float, max_iters: int):
    """The loop the device-resident one replaces: one FusedEngine call and
    one host read of the residual an iteration.  Returns the final
    buffers, the residual trace, the dispatches, the host reads and the
    wall time (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem, trace, reads = init, [], 0
    dispatches = fused.stats.dispatches
    while True:
        mem = fused(mem)
        trace.append(float(residual(mem)))
        reads += 1
        if not (trace[-1] >= tol and len(trace) < max_iters):
            break
    wall = (time.perf_counter() - t0) * 1e3
    return mem, trace, fused.stats.dispatches - dispatches, reads, wall


def check_step_kernel(torch, graph_loop):
    """Phase 11, part 3: the step kernel against the plain step on known
    traces (the bound, and both parities of the last pass, whose select
    must leave the last iteration's index), and its kernels-line row: one
    iteration of a loop whose passes replay a trace, against the same
    feed and the plain step in a plain graph."""
    trace = torch.linspace(1.0, 0.0, 32, device="cuda")
    err, cases = 0.0, []
    for tol, max_iters in STEP_CASES:
        want_red, want_n = graph_loop.trace_plain(trace, tol, max_iters)
        loop, red, n_done, last = graph_loop.trace_loop(trace, tol, max_iters)
        loop.launch()
        torch.cuda.synchronize()
        err = max(err, float((red.cpu() - want_red).abs().max()))
        require(int(n_done) == int(want_n) and torch.equal(red.cpu(), want_red),
                f"step kernel != plain step at tol {tol}, max_iters {max_iters}: "
                f"n_done {int(n_done)} vs {int(want_n)}")
        require(int(last) == int(want_n) - 1, f"the parity select kept iteration {int(last)}, "
                f"not the last ({int(want_n) - 1}), at n_done {int(want_n)}")
        cases.append({"tol": tol, "max_iters": max_iters, "n_done": int(n_done)})
    long_trace = torch.rand(STEP_ITERS, device="cuda")
    loop, _, n_done, _ = graph_loop.trace_loop(long_trace, -1.0, STEP_ITERS)
    iter_ms = events_ms(torch, loop.launch) / STEP_ITERS
    require(int(n_done) == STEP_ITERS, f"the timing loop ran {int(n_done)} iterations")
    reductions = torch.zeros(STEP_ITERS, device="cuda")
    count = torch.zeros((), dtype=torch.int32, device="cuda")

    def plain_iter():
        r = long_trace.index_select(0, count.reshape(1).long()).reshape(())
        graph_loop.step_plain(reductions, count, r, r >= -1.0, STEP_ITERS)

    # bytes of one step: the reduction, the predicate and n_done read, the
    # trace entry, n_done and the decision written
    t_bytes, t_ops = 21 / HBM_BYTES_PER_S, 2 / FP32_OPS_PER_S
    row = {"name": "graph_loop_step", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
           "replaces": REPLACES["graph_loop_step"], "pallas_counterpart": False,
           "max_abs_err": err, "ms": iter_ms,
           "plain_ms": median_ms(torch, plain_iter, reps=5, inner=20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    return row, cases


def run_convergence(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 11: Faces until the residual falls below each tolerance, device-
    resident (``run_faces_until_converged``, dataflow: one graph launch of
    a conditional WHILE node) against host-polled (``FusedEngine``, one
    call and one host read an iteration); then the loop's own cost at
    its bound beside the fixed-count graph, and the step kernel against
    its plain version.  Counters are set to 0 just before the device-
    resident runs and read just after them."""
    from repro_torch.core import (FusedEngine, PersistentEngine, build_faces_program,
                                  global_residual_fn, run_faces_until_converged)

    residual = global_residual_fn(cfg)
    prog = build_faces_program(cfg, mesh)
    fused = FusedEngine(prog, mode="dataflow", donate=True)
    fused.compile()
    rows = []
    torch.cuda.synchronize()
    hk.reset_launches()
    graph_loop.reset_launches()
    for tol in CONV_TOLS:
        t0 = time.perf_counter()
        mem, res, n_done, stats = run_faces_until_converged(
            cfg, mesh, u0, tol=tol, max_iters=CONV_MAX_ITERS, mode="dataflow")
        first_wall = (time.perf_counter() - t0) * 1e3
        require((stats.dispatches, stats.sync_points) == (1, 0),
                f"tol {tol}: the device-resident loop took {stats}")
        eng = PersistentEngine(prog.persistent(CONV_MAX_ITERS, until=lambda r, t=tol: r >= t),
                               mode="dataflow", reduce_fn=residual, donate=True)
        init = eng.init_buffers({"u": u0})
        eng.compile()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, warm_n = eng(init)
            warm_n = int(warm_n)
            walls.append((time.perf_counter() - t0) * 1e3)
        require(warm_n == n_done, f"tol {tol}: a warm call ran {warm_n} passes, not {n_done}")
        polled = [host_polled(torch, fused, residual, fused.init_buffers({"u": u0}), tol,
                              CONV_MAX_ITERS) for _ in range(3)]
        want, trace, dispatches, reads, _ = polled[-1]  # want: the fused engine's buffers
        require(len(trace) == n_done, f"tol {tol}: host-polled ran {len(trace)} "
                f"iterations, device-resident {n_done}")
        require(res.tolist() == trace, f"tol {tol}: residual traces differ")
        for name, t in want.items():
            require(torch.equal(mem[name], t), f"tol {tol}: {name} differs from the "
                    "host-polled run's")
        require(bool(torch.isfinite(mem["u"]).all()), f"tol {tol}: non-finite field")
        rows.append({"tol": tol, "n_done": n_done, "final_residual": trace[-1],
                     "device_resident": {"wall_ms": statistics.median(walls),
                                         "first_call_wall_ms": first_wall,
                                         "dispatches": stats.dispatches,
                                         "sync_points": stats.sync_points},
                     "host_polled": {"wall_ms": statistics.median(p[4] for p in polled),
                                     "dispatches": dispatches, "sync_points": reads},
                     "equal_bitwise": True})
        del eng, mem, want, polled
    torch.cuda.synchronize()
    launches = {**hk.launch_counts(), **graph_loop.launch_counts()}
    require(all(launches[n] > 0 for n in FACES_KERNELS + ("graph_loop_step",)),
            f"a kernel of the convergence path never launched: {launches}")
    del fused

    # the loop's own cost: tol 0 runs to the bound, beside the fixed-count graph
    bound = {}
    for mode in ("stream", "dataflow"):
        loop = PersistentEngine(prog.persistent(BOUND_ITERS, until=lambda r: r >= 0.0),
                                mode=mode, reduce_fn=residual, donate=True)
        fixed = PersistentEngine(prog.persistent(BOUND_ITERS), mode=mode, donate=True)
        reduced = PersistentEngine(prog.persistent(BOUND_ITERS), mode=mode,
                                   reduce_fn=residual, donate=True)
        init = loop.init_buffers({"u": u0})
        for e in (loop, fixed, reduced):
            e.compile()
        mem, red, n_done = loop(init)
        require(int(n_done) == BOUND_ITERS, f"{mode}: tol 0 stopped at {int(n_done)}, "
                f"not at max_iters {BOUND_ITERS}")
        want, want_red = reduced(init)
        require(torch.equal(mem["u"], fixed(init)["u"]) and torch.equal(mem["u"], want["u"])
                and torch.equal(red, want_red), f"{mode}: the loop at its bound differs "
                "from the fixed-count graph")
        bound[mode] = {"n_done": int(n_done),
                       "loop_ms_per_iter": events_ms(torch, lambda: loop(init)) / BOUND_ITERS,
                       "fixed_ms_per_iter": events_ms(torch, lambda: fixed(init)) / BOUND_ITERS,
                       "fixed_with_residual_ms_per_iter":
                           events_ms(torch, lambda: reduced(init)) / BOUND_ITERS}
        del loop, fixed, reduced, mem, want
    u = torch.from_numpy(u0).cuda()
    dst = torch.empty_like(u)
    costs = {"field_copy_ms": median_ms(torch, lambda: dst.copy_(u)),
             "residual_ms": median_ms(torch, lambda: residual({"u": u}))}
    row, cases = check_step_kernel(torch, graph_loop)
    row["launches"] = launches["graph_loop_step"]
    return {"card": card, "grid": cfg.grid, "points": cfg.points,
            "max_iters": CONV_MAX_ITERS, "rows": rows,
            "bound": {"max_iters": BOUND_ITERS, "card": card, **bound, **costs},
            "step_cases": cases, "launches": launches}, row


def check_schedule_step(torch, graph_loop):
    """Phase 14, the step: the schedule step kernel against the plain
    schedule step on known traces (each program's counter, kept through
    its snapshots and restores, must equal its count), and its kernels-
    line row: one pass of a 4-program loop replaying traces, against the
    same feed and the plain step in a plain graph."""
    err, cases = 0.0, []
    for tols, counts, max_iters in SCHED_STEP_CASES:
        traces = torch.stack([torch.linspace(1.0, 0.0, 16, device="cuda") * (k + 1)
                              for k in range(len(counts))])
        want_red, want_n = graph_loop.trace_schedule_plain(traces, tols, counts, max_iters)
        loop, red, n_done, v = graph_loop.trace_schedule_loop(traces, tols, counts, max_iters)
        loop.launch()
        torch.cuda.synchronize()
        err = max(err, float((red.cpu() - want_red).abs().max()))
        require(n_done.cpu().tolist() == want_n.tolist() and torch.equal(red.cpu(), want_red),
                f"schedule step != plain step at tols {tols}, counts {counts}: n_done "
                f"{n_done.tolist()} vs {want_n.tolist()}")
        require([int(t) for t in v] == want_n.tolist(), f"the freeze graphs kept "
                f"{[int(t) for t in v]}, not the counts {want_n.tolist()}")
        cases.append({"tols": tols, "counts": counts, "n_done": want_n.tolist()})
    n = SCHED_STEP_PROGRAMS
    long_traces = torch.rand(n, STEP_ITERS, device="cuda")
    loop, _, n_done, _ = graph_loop.trace_schedule_loop(long_traces, (-1.0,) * n,
                                                        (STEP_ITERS,) * n, STEP_ITERS)
    iter_ms = events_ms(torch, loop.launch) / STEP_ITERS
    require(n_done.cpu().tolist() == [STEP_ITERS] * n,
            f"the timing loop ran {n_done.tolist()} passes")
    # the same loop with one program: what the step's width and the IF nodes
    # of the other programs add
    one, _, _, _ = graph_loop.trace_schedule_loop(long_traces[:1], (-1.0,), (STEP_ITERS,),
                                                  STEP_ITERS)
    one_ms = events_ms(torch, one.launch) / STEP_ITERS
    reductions = torch.zeros(n, STEP_ITERS, device="cuda")
    count = torch.zeros(n, dtype=torch.int32, device="cuda")
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    i = torch.zeros((), dtype=torch.int32, device="cuda")
    limits = torch.full((n,), STEP_ITERS, dtype=torch.int32, device="cuda")
    yes = torch.ones(n, dtype=torch.bool, device="cuda")

    def plain_iter():
        r = long_traces.gather(1, count.long().clamp(max=STEP_ITERS - 1)[:, None]).reshape(n)
        graph_loop.schedule_step_plain(reductions, count, active, i, r, r >= -1.0, limits,
                                       yes, yes, STEP_ITERS)

    # bytes of one step: per program active, n_done, the reduction and the
    # predicate read (13), the trace entry, n_done and active written (12);
    # the pass counter read and written and the decision written (12)
    t_bytes, t_ops = (25 * n + 12) / HBM_BYTES_PER_S, 3 * n / FP32_OPS_PER_S
    row = {"name": "schedule_step", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
           "replaces": REPLACES["schedule_step"], "pallas_counterpart": False,
           "max_abs_err": err, "ms": iter_ms, "one_program_ms": one_ms,
           "plain_ms": median_ms(torch, plain_iter, reps=5, inner=20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    return row, cases


def run_masked(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 14: the masked multi-queue loop at full width, 2 and 4 x-parts
    in both modes: (a) equal tolerances, (b) unequal ones, (c) (b)
    unlinked, against each part's own converged run, (d) linked fixed
    counts 3 and 7, (e) every count 10 with reductions, against the
    fixed-count composed graph.  Every solve is one graph launch whose
    fields, traces and counts equal the eager loop's on the card bit for
    bit; the counters are set to 0 just before each masked run (compile
    and call) and read just after."""
    from repro_torch.core import (PersistentEngine, build_faces_pipeline, global_residual_fn,
                                  part_configs, part_names, run_faces_until_converged,
                                  split_parts)
    from repro_torch.core.engine_persistent import _run_schedule_while

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def solve(mode, n_parts, what, exchange=True, counts=MASK_MAX_ITERS, tols=None,
              reduce=True, sanitize=False):
        names = part_names(n_parts)
        fns = {nm: global_residual_fn(c, buf=f"{nm}/u")
               for nm, c in zip(names, part_configs(cfg, n_parts))} if reduce else None
        eng = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, counts, exchange,
                                                    tols=tols),
                               mode=mode, donate=True, reduce_fns=fns, sanitize=sanitize)
        init = eng.init_buffers(dict(zip([f"{n}/u" for n in names],
                                         split_parts(u0, n_parts))))
        torch.cuda.synchronize()
        hk.reset_launches()
        graph_loop.reset_launches()
        eng.compile()
        (mem, reds, n_done), first_ms = synced_ms(lambda: eng(init))
        counts_now = {**{n: hk.launch_counts()[n] for n in FACES_KERNELS},
                      "schedule_step": graph_loop.launch_counts()["schedule_step"]}
        require(all(counts_now.values()), f"{what}: a kernel of the masked path never "
                f"launched: {counts_now}")
        require((eng.stats.dispatches, eng.graph_launches, eng.stats.sync_points)
                == (1, 1, 0), f"{what}: {eng.stats}, {eng.graph_launches} graph launches")
        got = ({k: t.clone() for k, t in mem.items()}, {k: t.clone() for k, t in reds.items()},
               {k: int(v) for k, v in n_done.items()})
        walls = [synced_ms(lambda: eng(init))[1] for _ in range(3)]
        # the explicit reference: the eager loop on the card's tensors
        ref_red, ref_n = torch.zeros_like(eng._reductions), torch.zeros_like(eng._n_done)
        eager, eager_ms = synced_ms(lambda: _run_schedule_while(
            dict(init), sched=eng.program, mode=mode, low=eng._lowering, slots=eng._slots,
            reduce_fns=eng.reduce_fns, reductions=ref_red, n_done=ref_n))
        for k, sub in enumerate(eng.program.subs):
            require(int(ref_n[k]) == got[2][sub.name], f"{what}: {sub.name} ran "
                    f"{got[2][sub.name]} passes, the eager loop {int(ref_n[k])}")
            if sub.name in got[1]:
                require(torch.equal(got[1][sub.name], ref_red[k]),
                        f"{what}: {sub.name}'s trace differs from the eager loop's")
        for name, t in eager.items():
            require(torch.equal(got[0][name], t), f"{what}: {name} differs from the "
                    "eager loop's")
        row = {"n_done": got[2], "graph_wall_ms": statistics.median(walls),
               "first_call_wall_ms": first_ms, "eager_wall_ms": eager_ms,
               "dispatches": 1, "graph_launches": 1, "launches": counts_now,
               "equal_to_eager_bitwise": True}
        del eager
        return eng, init, got, row

    def tail(reds, n):
        return [float(x) for x in reds[max(0, n - 3):n]]

    out, step_launches = {}, 0
    for mode in ("stream", "dataflow"):
        for n_parts in PARTS:
            names = part_names(n_parts)
            tag = f"{mode}/parts{n_parts}"
            rows = {}
            # (a) equal tolerances
            eng, init, got, rows["a"] = solve(mode, n_parts, f"{tag} (a)",
                                              tols=(MASK_EQUAL_TOL,) * n_parts)
            require(all(bool(torch.isfinite(got[0][f"{n}/u"]).all()) for n in names),
                    f"{tag} (a): non-finite field")
            del eng, init, got
            # (b) unequal tolerances: does the tightest part plateau at the bound?
            tols = MASK_TOLS[n_parts]
            eng, init, got, rows["b"] = solve(mode, n_parts, f"{tag} (b)", tols=tols)
            tight = names[-1]
            trace = got[1][tight]
            n = got[2][tight]
            rows["b"]["tightest"] = {
                "name": tight, "tol": tols[-1], "n_done": n,
                "ran_to_bound": n == MASK_MAX_ITERS, "last_residuals": tail(trace, n),
                "plateau": bool(n == MASK_MAX_ITERS and abs(float(trace[n - 1])
                                - float(trace[n - 5])) <= 1e-3 * abs(float(trace[n - 1])))}
            rows["b"]["last_residuals"] = {k: tail(v, got[2][k]) for k, v in got[1].items()}
            # a pass with parts frozen (restores run) beside (e)'s, where none is
            rows["b"]["ms_per_iter"] = events_ms(torch, lambda: eng(init)) / max(got[2].values())
            if n_parts == 2:
                rows["b"]["pass_node_types"] = graph_loop.node_types(eng._loop.passes[0])
                freeze = {}
                for g in (g for f in eng._loop.freeze for g in f or ()):
                    for kind, c in graph_loop.node_types(g).items():
                        freeze[kind] = freeze.get(kind, 0) + c
                rows["b"]["freeze_node_types"] = freeze
                san = solve(mode, n_parts, f"{tag} (b) sanitized", tols=tols, sanitize=True)
                require(san[2][2] == got[2] and all(
                    torch.equal(san[2][0][k], t) for k, t in got[0].items()) and all(
                    torch.equal(san[2][1][k], t) for k, t in got[1].items()),
                    f"{tag} (b): sanitize=True changed the result")
                rows["b"]["sanitized_equal_bitwise"] = True
                rows["b"]["sanitized_graph_wall_ms"] = san[3]["graph_wall_ms"]
                del san
            del eng, init, got
            # (c) unlinked (b): each part equals its own converged run
            eng, init, got, rows["c"] = solve(mode, n_parts, f"{tag} (c)", exchange=False,
                                              tols=tols)
            for nm, pcfg, part, tol in zip(names, part_configs(cfg, n_parts),
                                           split_parts(u0, n_parts), tols):
                alone, res, n_alone, _ = run_faces_until_converged(
                    pcfg, mesh, part, tol=tol, max_iters=MASK_MAX_ITERS, mode=mode)
                require(n_alone == got[2][nm] and torch.equal(res, got[1][nm][:n_alone]),
                        f"{tag} (c): {nm} ran {got[2][nm]} passes, its own run {n_alone}, "
                        "or their traces differ")
                for buf, t in alone.items():
                    require(torch.equal(got[0][f"{nm}/{buf}"], t),
                            f"{tag} (c): {nm}/{buf} differs from its own run")
                del alone
            rows["c"]["equal_to_own_runs_bitwise"] = True
            del eng, init, got
            # (d) linked fixed counts, no reductions
            if n_parts == 2:
                eng, init, got, rows["d"] = solve(mode, 2, f"{tag} (d)", counts=MASK_COUNTS,
                                                  reduce=False)
                require(got[2] == dict(zip(names, MASK_COUNTS)) and got[1] == {},
                        f"{tag} (d): n_done {got[2]}")
                del eng, init, got
            # (e) reductions only, every count 10, against the fixed-count graph
            eng, init, got, rows["e"] = solve(mode, n_parts, f"{tag} (e)", counts=MASK_FIXED)
            fixed = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, MASK_FIXED),
                                     mode=mode, donate=True)
            fixed.compile()
            want = fixed(init)
            require(all(torch.equal(got[0][k], t) for k, t in want.items()),
                    f"{tag} (e): the masked loop differs from the fixed-count graph")
            ms, fixed_ms = (events_ms(torch, lambda e=e: e(init)) / MASK_FIXED
                            for e in (eng, fixed))
            rows["e"].update({"equal_to_fixed_count_bitwise": True, "ms_per_iter": ms,
                              "fixed_count_ms_per_iter": fixed_ms,
                              "vs_fixed_count": ms / fixed_ms})
            del eng, init, got, fixed, want
            torch.cuda.empty_cache()
            for r in rows.values():
                step_launches += r["launches"]["schedule_step"]
            out[tag] = rows
    row, cases = check_schedule_step(torch, graph_loop)
    row["launches"] = step_launches
    return {"card": card, "grid": cfg.grid, "points": cfg.points,
            "max_iters": MASK_MAX_ITERS, "cases": out, "step_cases": cases}, row


def spearman(xs, ys):
    """Rank correlation of two equal-length sequences (tied values share
    their average rank); None when either is constant."""
    def ranks(v):
        order = sorted(range(len(v)), key=lambda i: v[i])
        r = [0.0] * len(v)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and v[order[j + 1]] == v[order[i]]:
                j += 1
            for q in range(i, j + 1):
                r[order[q]] = (i + j) / 2
            i = j + 1
        return r
    rx, ry = ranks(xs), ranks(ys)
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    vx, vy = sum((a - mx) ** 2 for a in rx), sum((b - my) ** 2 for b in ry)
    if not vx or not vy:
        return None
    return sum((a - mx) * (b - my) for a, b in zip(rx, ry)) / (vx * vy) ** 0.5


def tune_rows(res) -> dict:
    """Each candidate's predicted µs beside its measured median, the
    winner, and the rank agreement over the timed candidates."""
    timed = [c for c in res.candidates if c.stats is not None]
    return {"winner": res.best.knobs.label(),
            "candidates": [{"knobs": c.knobs.label(), "predicted_us": c.predicted_us,
                            "measured_med_ms": c.measured_ms, "error": c.error,
                            "certified": bool(c.certificate is not None
                                              and c.certificate.equivalent)}
                           for c in res.candidates],
            "spearman": spearman([c.predicted_us for c in timed],
                                 [c.stats["med_s"] for c in timed]) if len(timed) > 2 else None,
            "predicted_cheapest": min(res.candidates, key=lambda c: c.predicted_us
                                      if c.predicted_us is not None else float("inf")
                                      ).knobs.label()}


def mlp_inputs(torch, seed: int):
    """x (m, k) ~ N(0, 1) and the MLP weights scaled by 1/sqrt(fan-in), from
    ``torch.Generator(seed)`` (unscaled, the chain grows ~10^3 a layer)."""
    m, k, f = MLP
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=g), torch.randn(k, f, generator=g) / k ** 0.5,
            torch.randn(f, k, generator=g) / f ** 0.5)


def run_tuner(torch, cfg, mesh, u0, card: str, hk, seed: int):
    """Phase 15: ``run_faces_pipelined(tune=True)`` on the linked 2- and
    4-part pipeline at full width, ``tune(certify=True)`` with every
    candidate timed on the same builds, then the TP chain of phase 16
    tuned over mode x coalesce x double_buffer.  Winners: one dispatch,
    one graph launch, equal to the untuned run bit for bit; every
    candidate certified.  The counters are set to 0 just before each
    tuned run and read just after."""
    from repro_torch import make_mesh
    from repro_torch.core import (PersistentEngine, build_faces_pipeline, collectives,
                                  part_names, run_faces_pipelined, split_parts)
    from repro_torch.launch.tune import Knobs, tune

    def rerun(winner, fresh):
        winner.stats.reset()
        winner.graph_launches = 0
        got = winner(fresh())
        require((winner.stats.dispatches, winner.graph_launches) == (1, 1),
                f"the winner took {winner.stats}, {winner.graph_launches} graph launches")
        return got

    out, launches = {}, dict.fromkeys(FACES_KERNELS, 0)
    for n_parts in PARTS:
        what = f"{n_parts} parts"
        init = dict(zip([f"{n}/u" for n in part_names(n_parts)], split_parts(u0, n_parts)))
        plain, _ = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts)
        plain = {k: t.clone() for k, t in plain.items()}
        torch.cuda.synchronize()
        hk.reset_launches()
        t0 = time.perf_counter()
        mem, stats, tuned = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS,
                                                n_parts=n_parts, tune=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: hk.launch_counts()[n] for n in FACES_KERNELS}
        require(all(counts.values()), f"{what}: a kernel of the tuned path never "
                f"launched: {counts}")
        for n in FACES_KERNELS:
            launches[n] += counts[n]
        require((stats.dispatches, stats.sync_points, tuned.best.engine.graph_launches)
                == (1, 0, 1), f"{what}: the tuned solve took {stats}, "
                f"{tuned.best.engine.graph_launches} graph launches")
        require(all(torch.equal(mem[k], t) for k, t in plain.items()),
                f"{what}: the tuned run differs from the untuned one")
        row = {"run_faces_pipelined": {**tune_rows(tuned), "wall_ms": wall,
                                       "launches": counts, "equal_to_untuned_bitwise": True}}
        del mem, tuned

        def build(knobs, n_parts=n_parts, init=init):
            eng = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, N_ITERS,
                                                        interleave=knobs.interleave_policy()),
                                   donate=True, **knobs.engine_kwargs())
            return eng, lambda: eng.init_buffers(init)

        n_cand = len(TUNE_SPACE["interleave"]) * len(TUNE_SPACE["mode"])
        res = tune(build, TUNE_SPACE, base=Knobs(), repeats=5, measure_top=n_cand,
                   certify=True)
        require(all(c.error is None and c.certificate.equivalent for c in res.candidates),
                f"{what}: a candidate was not certified: "
                f"{[(c.knobs.label(), c.error) for c in res.candidates if c.error]}")
        got = rerun(res.best.engine, res.best.fresh)
        require(all(torch.equal(got[k], t) for k, t in plain.items()),
                f"{what}: the certified winner differs from the untuned run")
        row["certified"] = {**tune_rows(res), "winner_equal_to_untuned_bitwise": True}
        out[f"parts{n_parts}"] = row
        del res, got, plain
        torch.cuda.empty_cache()

    x, w1, w2 = mlp_inputs(torch, seed)
    tp = collectives.build_tp_block(make_mesh((COLL_RANKS,), ("x",)), "x", *MLP, chain=True)
    pprog = tp.program.persistent(TP_LAYERS)
    args = {"x": x, "w1": w1, "w2": w2}

    def build_tp(knobs):
        eng = PersistentEngine(pprog, donate=True, **knobs.engine_kwargs())
        return eng, lambda: eng.init_buffers(args)

    eng, fresh = build_tp(Knobs())
    untuned = eng(fresh())["out"].clone()
    del eng
    n_cand = 2 * 2 * 2
    res = tune(build_tp, TP_SPACE, base=Knobs(), repeats=3, measure_top=n_cand, certify=True)
    require(all(c.error is None and c.certificate.equivalent for c in res.candidates),
            "TP chain: a candidate was not certified")
    got = rerun(res.best.engine, res.best.fresh)["out"]
    require(bool(torch.isfinite(got).all()) and torch.equal(got, untuned),
            "TP chain: the tuned winner differs from the untuned chain")
    out["tp_chain"] = {**tune_rows(res), "layers": TP_LAYERS, "mlp": MLP, "ranks": COLL_RANKS,
                       "winner_equal_to_untuned_bitwise": True}
    del res, got, untuned
    torch.cuda.empty_cache()
    return {"card": card, "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
            "space": TUNE_SPACE, "tp_space": TP_SPACE, "cases": out, "launches": launches}


def run_collectives(torch, card: str, seed: int):
    """Phase 16: the collective builders at gemma3-1b's MLP widths on 4
    ranks through FusedEngine and PersistentEngine in both modes, each
    equal to the port's decomposed oracle on the card bit for bit and to
    its CPU run within COLL_TOL (the all-to-all bit for bit); the
    26-layer persistent TP chain in one dispatch equal to 26 oracle
    applications, and its ms a layer beside 26 eager calls of the stock
    composition (CUDA events).  No hand-written kernel is on this path:
    the counters are set to 0 before it and must read 0 after it."""
    from repro_torch import make_mesh
    from repro_torch.core import FusedEngine, PersistentEngine, collectives
    from repro_torch.kernels import flash_attention, graph_loop, halo_pack, rmsnorm, ssd_scan

    kernels = (halo_pack, rmsnorm, flash_attention, ssd_scan, graph_loop)

    def counts():
        c = {}
        for mod in kernels:
            c.update(mod.launch_counts())
        return c

    m, k, f = MLP
    mesh = make_mesh((COLL_RANKS,), ("x",))
    cpu_mesh = make_mesh((COLL_RANKS,), ("x",), device="cpu")
    x, w1, w2 = mlp_inputs(torch, seed)
    builds = {
        "ag_matmul": (lambda mm: collectives.build_all_gather_matmul(mm, "x", m, k, f),
                      {"x": x, "w": w1}),
        "ag_matmul_bidi": (lambda mm: collectives.build_all_gather_matmul(
            mm, "x", m, k, f, bidirectional=True), {"x": x, "w": w1}),
        "matmul_rs": (lambda mm: collectives.build_matmul_reduce_scatter(mm, "x", m, k, f),
                      {"x": x, "w": w1}),
        "a2a": (lambda mm: collectives.build_all_to_all(mm, "x", m, k), {"x": x}),
    }
    torch.cuda.synchronize()
    for mod in kernels:
        mod.reset_launches()
    rows = {}
    for name, (build, args) in builds.items():
        cm = build(mesh)
        dev = [args[b].cuda() for b in cm.inputs]
        oracle = cm.reference(*dev)
        require(bool(torch.isfinite(oracle).all()), f"{name}: non-finite oracle")
        row = {"oracle_ms": events_ms(torch, lambda: cm.reference(*dev)),
               "stock_ms": events_ms(torch, lambda: cm.reference_stock(*dev))}
        for label, cls, mode in (("fused_stream", FusedEngine, "stream"),
                                 ("fused_dataflow", FusedEngine, "dataflow"),
                                 ("persistent_stream", PersistentEngine, "stream"),
                                 ("persistent_dataflow", PersistentEngine, "dataflow")):
            eng = cls(cm.program, mode=mode, donate=True)
            init = eng.init_buffers(args)
            got = eng(init)[cm.output]
            require(eng.stats.dispatches == eng.graph_launches == 1,
                    f"{name} {label}: {eng.stats}, {eng.graph_launches} graph launches")
            require(torch.equal(got, oracle), f"{name} {label}: differs from the "
                    "decomposed oracle")
            row[f"{label}_ms"] = events_ms(torch, lambda: eng(init))
            del eng, init, got
        cpu = FusedEngine(build(cpu_mesh).program)
        on_cpu = cpu(cpu.init_buffers(args))[cm.output]
        err = float((oracle.cpu() - on_cpu).abs().max())
        if name == "a2a":
            require(torch.equal(oracle.cpu(), on_cpu), "a2a: the card differs from the CPU")
        else:
            require(torch.allclose(oracle.cpu(), on_cpu, rtol=COLL_TOL, atol=COLL_TOL),
                    f"{name}: the card differs from the CPU by {err}")
        stock = cm.reference_stock(*dev)
        row.update({"equal_to_oracle_bitwise": True, "cpu_max_abs_err": err,
                    "stock_max_abs_err": float((stock - oracle).abs().max()),
                    "output_shape": tuple(oracle.shape)})
        rows[name] = row
        del cm, dev, oracle, cpu, on_cpu, stock
        torch.cuda.empty_cache()

    tp = collectives.build_tp_block(mesh, "x", *MLP, chain=True)
    args = {"x": x, "w1": w1, "w2": w2}
    dev = {b: a.cuda() for b, a in args.items()}
    chain = {}
    for mode in ("stream", "dataflow"):
        pers = PersistentEngine(tp.program.persistent(TP_LAYERS), mode=mode, donate=True)
        init = pers.init_buffers(args)
        got = pers(init)["out"].clone()
        require(pers.stats.dispatches == pers.graph_launches == 1,
                f"TP chain {mode}: {pers.stats}, {pers.graph_launches} graph launches")
        require(bool(torch.isfinite(got).all()), f"TP chain {mode}: non-finite result")
        chain[mode] = {"ms_per_layer": events_ms(torch, lambda: pers(init)) / TP_LAYERS,
                       "out": got}
        if mode == "dataflow":
            chain["profile"] = profile_calls(torch, lambda: pers(init))
        del pers, init
    require(torch.equal(chain["stream"]["out"], chain["dataflow"]["out"]),
            "TP chain: the modes differ")
    profile = chain.pop("profile")
    want = dev["x"]
    for _ in range(TP_LAYERS):
        want = tp.reference(want, dev["w1"], dev["w2"])
    got = chain["dataflow"]["out"]
    require(torch.equal(got, want), "TP chain: differs from the decomposed layers")
    fused = FusedEngine(tp.program, mode="dataflow", donate=True)
    mem = fused.init_buffers(args)
    for _ in range(TP_LAYERS):
        mem = fused(mem)
    require(fused.stats.dispatches == fused.graph_launches == TP_LAYERS
            and torch.equal(mem["out"], got), "TP chain: 26 fused calls differ")
    del fused, mem
    launched = counts()
    require(not any(launched.values()), f"a hand-written kernel launched on the "
            f"collectives' path: {launched}")

    def stock_chain():
        y = dev["x"]
        for _ in range(TP_LAYERS):
            y = tp.reference_stock(y, dev["w1"], dev["w2"])
        return y

    stock_ms = events_ms(torch, stock_chain) / TP_LAYERS
    stock_profile = profile_calls(torch, stock_chain)
    stock = stock_chain()
    t0 = time.perf_counter()
    ctp = collectives.build_tp_block(cpu_mesh, "x", *MLP, chain=True)
    ceng = PersistentEngine(ctp.program.persistent(TP_LAYERS))
    on_cpu = ceng(ceng.init_buffers(args))["out"]
    cpu_s = time.perf_counter() - t0
    err = float((got.cpu() - on_cpu).abs().max())
    require(torch.allclose(got.cpu(), on_cpu, rtol=COLL_TOL, atol=COLL_TOL),
            f"TP chain: the card differs from the CPU by {err}")
    scale = float(got.abs().max())
    rows["tp_chain"] = {
        "layers": TP_LAYERS, "ms_per_layer": {md: r["ms_per_layer"] for md, r in chain.items()},
        "stock_ms_per_layer": stock_ms,
        "vs_stock": {md: r["ms_per_layer"] / stock_ms for md, r in chain.items()},
        "dispatches": 1, "graph_launches": 1, "equal_to_oracle_layers_bitwise": True,
        "fused_26_calls_equal": True, "cpu_max_abs_err": err, "cpu_seconds": cpu_s,
        "max_abs_out": scale, "cpu_err_over_max": err / scale,
        "stock_max_abs_err": float((stock - got).abs().max()),
        "profile_26_layers": profile, "stock_profile_26_calls": stock_profile,
        "gflop_per_layer": 2 * 2 * m * k * f / 1e9,
        "fp32_bound_ms_per_layer": 2 * 2 * m * k * f / FP32_OPS_PER_S * 1e3}
    return {"card": card, "mlp": MLP, "ranks": COLL_RANKS, "cases": rows,
            "launches": launched}


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
    require(all(launches[n] > 0 for n in FACES_KERNELS), f"a kernel never launched: {launches}")
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
        "oracle_max_abs_err": err,
        "launches": {n: launches[n] for n in FACES_KERNELS}}}), flush=True)

    # where the time of fused (stream) iterations goes
    print(json.dumps({"profile_fused_stream": profile_iterations(
        torch, fused, fused.init_buffers({"u": u0}))}), flush=True)

    # phase 4: the one-buffer path
    contiguous = run_contiguous(torch, cfg, u0, first, base, hk)
    print(json.dumps({"faces_contiguous": contiguous}), flush=True)
    launches.update({n: contiguous["launches"][n]
                     for n in ("pack_boundary", "unpack_boundary_add")})

    # phase 5: halo and boundary kernels against their plain versions
    rows = check_kernels(torch, prog, base, hk, ref)
    print(json.dumps({"part_shapes": check_part_shapes(torch, cfg, mesh, hk, ref)}),
          flush=True)
    for r in rows:
        r["launches"] = launches[r["name"]]
    del prog, fields, first, fused, base, plain

    # phase 6: serve mamba2-2.7b at full width and depth
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as ssd
    torch.cuda.reset_peak_memory_stats()
    model_cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
        torch, args.seed, "mamba2-2.7b", SERVE)
    held = eng.captured_launches("prefill")
    require(held["ssd_scan"] == model_cfg.n_layers and held["rmsnorm"] > 0,
            f"the mamba2 prefill graph does not hold the SSD and rmsnorm kernels: {held}")
    require(held["ssd_scan_wgmma"] == model_cfg.n_layers,
            f"the mamba2 prefill graph's SSD launches are not all on the tensor-core "
            f"route: {held}")
    require(served["ssd_scan"] > 0 and served["rmsnorm"] > 0,
            f"a kernel never launched serving mamba2: {served}")
    print(json.dumps({"serve": serve_report(torch, model_cfg, eng, SERVE, runs, setup_s,
                                            served)}), flush=True)
    ssd_launches, norm_launches = served["ssd_scan"], served["rmsnorm"]

    # phase 7: serving results, and where the time goes
    print(json.dumps({"serve_checks": check_serving(torch, eng, params, batch_in, runs,
                                                    SERVE)}), flush=True)
    print_profiles(torch, eng, params, batch_in, "")
    del eng, params, runs

    # phase 8: the SSD kernel against its plain version
    row, detail = check_ssd(torch, ssd, ref, args.seed)
    row["launches"] = ssd_launches
    print(json.dumps({"ssd_scan_check": detail}), flush=True)
    ssd_row = row

    # phase 9: serve gemma3-1b at full width and depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model_cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
        torch, args.seed, "gemma3-1b", DENSE_SERVE)
    n = model_cfg.n_layers
    held = eng.captured_launches("prefill")
    routes = {"flash_attention_wgmma": n, "flash_attention_cuda_core": 0}
    require({k: held[k] for k in routes} == routes,
            f"the gemma3 prefill graph holds flash launches {held}, not {n} on the "
            "tensor-core route and none on the CUDA-core route")
    require(held["rmsnorm"] >= 4 * n + 1, f"the gemma3 prefill graph holds "
            f"{held['rmsnorm']} rmsnorm launches: not one on every norm")
    require(served["flash_attention"] > 0 and served["rmsnorm"] > 0,
            f"a kernel never launched serving gemma3: {served}")
    print(json.dumps({"serve_dense": serve_report(torch, model_cfg, eng, DENSE_SERVE, runs,
                                                  setup_s, served)}), flush=True)
    flash_launches = served["flash_attention"]
    norm_launches += served["rmsnorm"]
    checks = check_serving(torch, eng, params, batch_in, runs, DENSE_SERVE)
    eager = checks["eager_prefill_launches"]
    require({k: eager.get(k, 0) for k in routes} == routes,
            f"the eager gemma3 prefill took flash routes {eager}, not {routes}")
    print(json.dumps({"serve_dense_checks": checks}), flush=True)
    print_profiles(torch, eng, params, batch_in, "_dense")

    # phase 10: flash attention and rmsnorm against their plain versions
    dense_rows, detail = check_dense_kernels(torch, eng, params, batch_in, fk, rk, ref,
                                             args.seed)
    dense_rows[0]["launches"], dense_rows[1]["launches"] = flash_launches, norm_launches
    print(json.dumps({"dense_kernel_checks": detail}), flush=True)
    del eng, params, runs

    # phase 11: convergence loops, device-resident against host-polled
    from repro_torch.kernels import graph_loop
    torch.cuda.empty_cache()
    conv, step_row = run_convergence(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"convergence": conv}), flush=True)

    # phase 12: the linked N-part pipeline, one stream a program
    torch.cuda.empty_cache()
    pipeline, built = run_pipeline(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"pipeline": pipeline}), flush=True)

    # phase 13: the verifier and the sanitizer
    print(json.dumps({"verifier": run_verifier(torch, cfg, mesh, u0, gpu_line(), hk, built)}),
          flush=True)
    del built

    # phase 14: the masked multi-queue loop, each part to its own count
    torch.cuda.empty_cache()
    masked, sched_row = run_masked(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"masked": masked}), flush=True)

    # phase 15: the tuner
    torch.cuda.empty_cache()
    print(json.dumps({"tuner": run_tuner(torch, cfg, mesh, u0, gpu_line(), hk, args.seed)}),
          flush=True)

    # phase 16: the ring collectives at gemma3-1b's MLP widths
    torch.cuda.empty_cache()
    print(json.dumps({"collectives": run_collectives(torch, gpu_line(), args.seed)}),
          flush=True)

    rows = rows + dense_rows + [ssd_row, step_row, sched_row]
    require(sorted(r["name"] for r in rows) == sorted(REPLACES), "a kernel row is missing")
    require(all(r["launches"] > 0 for r in rows), "a kernel was not launched on its path")
    order = ("name", "route", "kernel_route", "source", "replaces", "pallas_counterpart",
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "sector_bound_ms", "library_ms", "library_call", "earlier_ms", "decode",
             "one_program_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r} for r in rows]}))
    print(f"card: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
