"""Times of the port's ``unpack_boundary_add`` and ``unpack_segments``
kernels on the card, beside ``index_add_`` and per-member slice
``copy_`` calls on the same inputs.

    PYTHONPATH=src python3 scripts/unpack_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only public
functions of the package, so the same script times two trees of it in
one run (an older tree unpacked beside this one, then this one; compare
only within one call, on one card).  Shapes: the Faces field, a 128^3
float32 block on each of 8 ranks of a (2, 2, 2) grid.
``unpack_boundary_add`` takes the 26 regions the one-buffer path
unpacks into (``-d`` for each DIRECTIONS entry ``d``), all ranks in one
launch, beside one ``index_add_`` of the buffer at the regions' flat
indices (built before the timed window; it adds the overlapping regions
in another order, so it is timed and not compared).  ``unpack_segments``
takes each direct transfer of the coalescing plan of the Faces program
(non-periodic, so a rank at the grid's edge has no sender: the engine's
masks), with its masks and without, beside one slice ``copy_`` a member.
``unpack_boundary_add`` is also timed on each class of regions alone
(the two z-faces, the four x- and y-faces, the edges and corners)
beside ``index_add_`` on the same class, and beside two
``halo_unpack_add`` launches on the two z-faces.
Each call is first checked bit for bit against its plain version, then
timed: the median of 15 replays of a CUDA graph of 20 calls (warm L2).
Bounds at 3.35 TB/s: the useful bytes (each element read once and
written once; the masked unpack counts the ranks it delivers to) and,
for the boundary unpack, the 32-byte sectors of the block it reads and
writes plus the buffer read once.  Prints one JSON line and the card's
name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch import make_mesh
from repro_torch.core import FacesConfig, build_faces_program
from repro_torch.core.engine_fused import Lowering
from repro_torch.core.halo import AXES3, DIRECTIONS, _region_for
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref

HBM_BYTES_PER_S = 3.35e12
GRID = (2, 2, 2)
POINTS = (128, 128, 128)
N_RANKS = 8
DEVICE = "cuda"


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


def boundary_times(u):
    back = [_region_for(tuple(-x for x in d), POINTS) for d in DIRECTIONS]
    sent = hk.pack_boundary(u, [_region_for(d, POINTS) for d in DIRECTIONS])
    assert torch.equal(hk.unpack_boundary_add(u.clone(), sent, back),
                       ref.unpack_boundary_add(u.clone(), sent, back))
    index = torch.arange(u[0].numel(), device=u.device).view(POINTS)
    idx = torch.cat([index[r].flatten() for r in back])
    shell = torch.zeros(POINTS, dtype=torch.bool, device=u.device)
    for r in back:
        shell[r] = True
    itemsize, union = u.element_size(), int(shell.sum())
    elements = torch.arange(u.numel(), device=u.device).view(u.shape)[:, shell]
    sectors = torch.unique((u.data_ptr() + elements * itemsize) // 32).numel()
    acc = u.clone()
    rows, flat = acc.view(N_RANKS, -1), sent.view(N_RANKS, -1)
    return {"regions": len(back), "ranks": N_RANKS, "total": sent.shape[-1],
            "kernel_us": median_us(lambda: hk.unpack_boundary_add(acc, sent, back)),
            "index_add_us": median_us(lambda: rows.index_add_(1, idx, flat)),
            "bound_us": N_RANKS * (sent.shape[-1] + 2 * union) * itemsize
            / HBM_BYTES_PER_S * 1e6,
            "sector_bound_us": (2 * 32 * sectors + sent.numel() * itemsize)
            / HBM_BYTES_PER_S * 1e6}


BOUNDARY_CLASSES = {"z_faces": lambda d: sum(map(abs, d)) == 1 and d[2] != 0,
                    "xy_faces": lambda d: sum(map(abs, d)) == 1 and d[2] == 0,
                    "edges_corners": lambda d: sum(map(abs, d)) > 1}


def boundary_class_times(u):
    """``unpack_boundary_add`` on each class of the 26 regions alone (its
    own buffer, all ranks in one launch) beside ``index_add_`` on the
    same class, and two ``halo_unpack_add`` launches on the two z-faces:
    where the one launch of all 26 spends its time."""
    gen = torch.Generator(DEVICE).manual_seed(2)
    index = torch.arange(u[0].numel(), device=u.device).view(POINTS)
    out = {}
    for name, pick in BOUNDARY_CLASSES.items():
        regions = [_region_for(tuple(-x for x in d), POINTS) for d in DIRECTIONS if pick(d)]
        total = sum(ref.region_size(r) for r in regions)
        buf = torch.randn((N_RANKS, total), device=u.device, generator=gen)
        assert torch.equal(hk.unpack_boundary_add(u.clone(), buf, regions),
                           ref.unpack_boundary_add(u.clone(), buf, regions)), name
        idx = torch.cat([index[r].flatten() for r in regions])
        acc = u.clone()
        rows = acc.view(N_RANKS, -1)
        out[name] = {"regions": len(regions),
                     "kernel_us": median_us(lambda: hk.unpack_boundary_add(acc, buf, regions)),
                     "index_add_us": median_us(lambda: rows.index_add_(1, idx, buf))}
    faces = [_region_for(d, POINTS) for d in ((0, 0, 1), (0, 0, -1))]
    msgs = [ref.halo_pack(u, r) for r in faces]
    acc = u.clone()

    def two_faces():
        for r, m in zip(faces, msgs):
            hk.halo_unpack_add(acc, m, r)

    out["halo_unpack_add_two_z_faces_us"] = median_us(two_faces)
    return out


def segment_times(seed: int = 1):
    cfg = FacesConfig(grid=GRID, points=POINTS, granularity="direct26", batched=True,
                      pack="kernel")
    prog = build_faces_program(cfg, make_mesh(GRID, AXES3, device=DEVICE))
    low = Lowering(prog)
    batch = prog.batches[0]
    plan, consts = batch.plan, low.plans[batch.index]
    gen = torch.Generator(DEVICE).manual_seed(seed)
    mem = {n: torch.randn(s.shape, dtype=s.dtype, device=DEVICE, generator=gen)
           for n, s in prog.buffers.items()}
    out = []
    for ti, (chans, offs, masks) in consts.direct.items():
        width = sum(seg.size for seg in plan.transfers[ti].segments)
        buf = torch.randn((N_RANKS, width), device=DEVICE, generator=gen)
        outs = [mem[plan.channels[ci].dst_buf] for ci in chans]
        sizes = [o.numel() // N_RANKS for o in outs]
        for m in (masks, None):
            got, want = [o.clone() for o in outs], [o.clone() for o in outs]
            hk.unpack_segments(buf, got, offs, m)
            ref.unpack_segments(buf, want, offs, m)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ti
        views = [o.view(N_RANKS, -1) for o in outs]
        pieces = [buf[:, off:off + n] for off, n in zip(offs, sizes)]

        def copies():
            for v, p in zip(views, pieces):
                v.copy_(p)

        delivered = sum((N_RANKS if masks is None else int(masks[j].sum())) * n
                        for j, n in enumerate(sizes))
        row = {"transfer": ti, "members": len(outs), "sizes": sizes,
               "masked_ranks": None if masks is None else int((~masks).sum()),
               "unmasked_us": median_us(lambda: hk.unpack_segments(buf, outs, offs, None)),
               "copy_us": median_us(copies),
               "bound_us": 2 * N_RANKS * sum(sizes) * 4 / HBM_BYTES_PER_S * 1e6}
        if masks is not None:
            row["masked_us"] = median_us(lambda: hk.unpack_segments(buf, outs, offs, masks))
            row["masked_bound_us"] = 2 * delivered * 4 / HBM_BYTES_PER_S * 1e6
        out.append(row)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("unpack_times: needs a CUDA device")
    gen = torch.Generator(DEVICE).manual_seed(0)
    u = torch.randn((N_RANKS, *POINTS), device=DEVICE, generator=gen)
    result = {"tag": args.tag, "unpack_boundary_add": boundary_times(u),
              "unpack_boundary_add_by_class": boundary_class_times(u),
              "unpack_segments": segment_times()}
    print(json.dumps(result), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
