"""ms per iteration of the plain (uncomposed) Faces program on the card,
fused and persistent, in ``stream`` and ``dataflow``, timed two ways:

* ``copy_in_out``: an engine without ``donate``, CUDA events around
  each call (a call copies the given buffers in and clones them out);
  fused: the median of 10 calls, persistent (10 iterations a call): the
  median of 3 calls over 10.  The persistent engine is timed so in
  ``chip_smoke.py`` phase 2; phase 2's fused engine donates (no copies),
  so its time is lower than this one's;
* ``copy_in`` as phase 12 times its full-domain run: a persistent
  engine with ``donate=True`` (a call copies the given buffers in and
  returns the engine's own), one warm call, then the median of 3.

Also counts the nodes, by type, of one fused pass captured with its
graph kept (``graph_loop.node_types``): equal counts in two trees show
the same graph.

    PYTHONPATH=src python3 scripts/faces_plain_times.py [--tag NAME] [--rounds N]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only what two
trees of the package have in common, so the same script times both in
one run (an older tree unpacked beside this one; compare only within
one call, on one card).  Configuration: that of ``chip_smoke.py``
phase 2, grid (2, 2, 2), 128^3 float32 blocks, direct26, batched,
coalesced, ``pack="kernel"``, ``damping=0.12``.  Each round times every
engine and method once; the rounds' medians are printed.  Prints one
JSON line and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch import make_mesh
from repro_torch.core import FacesConfig, FusedEngine, PersistentEngine, build_faces_program
from repro_torch.core.halo import AXES3
from repro_torch.kernels import graph_loop

N_ITERS = 10


def windows_ms(calls) -> float:
    """Median device time of the calls in ``calls`` (CUDA events)."""
    windows = []
    for fn in calls:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        windows.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in windows)


def one_round(prog, u0) -> dict:
    out = {}
    for mode in ("stream", "dataflow"):
        fused = FusedEngine(prog, mode=mode)
        fused.compile()
        mem = [fused.init_buffers({"u": u0})]

        def step():
            mem[0] = fused(mem[0])

        out[f"fused_{mode}/copy_in_out"] = windows_ms([step] * N_ITERS)
        pers = PersistentEngine(prog.persistent(N_ITERS), mode=mode)
        pers.compile()
        init = pers.init_buffers({"u": u0})
        pers(init)
        out[f"persistent_{mode}/copy_in_out"] = windows_ms([lambda: pers(init)] * 3) / N_ITERS
        donated = PersistentEngine(prog.persistent(N_ITERS), mode=mode, donate=True)
        init = donated.init_buffers({"u": u0})
        donated.compile()
        donated(init)
        out[f"persistent_{mode}/copy_in"] = windows_ms([lambda: donated(init)] * 3) / N_ITERS
        del fused, mem, pers, donated, init
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="tree")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    cfg = FacesConfig(grid=(2, 2, 2), points=(128, 128, 128), dtype="float32",
                      granularity="direct26", batched=True, pack="kernel", damping=0.12)
    prog = build_faces_program(cfg, make_mesh(cfg.grid, AXES3))
    u0 = np.random.RandomState(0).randn(*cfg.grid, *cfg.points).astype(np.float32)
    rounds = [one_round(prog, u0) for _ in range(args.rounds)]
    nodes = {}
    for mode in ("stream", "dataflow"):
        eng = FusedEngine(prog, mode=mode)
        eng.compile()
        graph, _ = graph_loop.capture(lambda: eng._run_into(eng._bufs))
        nodes[mode] = graph_loop.node_types(graph)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tag": args.tag, "card": card.strip(), "iterations": N_ITERS,
                      "ms_per_iter": {k: [r[k] for r in rounds] for k in rounds[0]},
                      "median_ms_per_iter": {k: statistics.median(r[k] for r in rounds)
                                             for k in rounds[0]},
                      "fused_pass_nodes": nodes}))
    print(card.strip())


if __name__ == "__main__":
    main()
