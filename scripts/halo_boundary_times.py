"""Times of the port's ``halo_pack``, ``halo_unpack_add`` and ``pack_boundary``
kernels on the card, beside a slice ``copy_``, a slice ``add_`` and
``torch.cat`` on the same inputs.

    PYTHONPATH=src python3 scripts/halo_boundary_times.py [--tag NAME]

It imports ``repro_torch`` from ``PYTHONPATH`` and calls only the
wrappers' public functions, so the same script times two trees of the
package in one run (an older tree unpacked beside this one, then
this one; compare only within one call, on one card).  Shapes: the
Faces field, a 128^3 float32 block on each of 8 ranks.
``halo_pack`` and ``halo_unpack_add`` on one region of each class the
Faces loop packs and unpacks (x-, y- and z-face, edges along x, y and
z, corner; a message of the region's shape); ``pack_boundary`` on the
26 regions in DIRECTIONS order, all ranks in one launch, as the
one-buffer path calls it.  Each
is checked first, bit for bit against its plain version, and then
timed: the median of 15 replays of a CUDA graph of 20 calls, so the
sectors a call touches (at most 14 MB) stay in the 50 MB L2.  Two
bounds at 3.35 TB/s: the useful bytes (each element read once and
written once), and the 32-byte sectors the call touches (a strided
region touches one sector of the block per element; the pack reads
them once, the unpack reads and writes them).  Prints one JSON line and
the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.core.halo import DIRECTIONS, _region_for
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref

HBM_BYTES_PER_S = 3.35e12
POINTS = (128, 128, 128)
N_RANKS = 8
CLASSES = {"face_x": (1, 0, 0), "face_y": (0, 1, 0), "face_z": (0, 0, 1),
           "edge_along_x": (0, 1, 1), "edge_along_y": (1, 0, 1),
           "edge_along_z": (1, 1, 0), "corner": (1, 1, 1)}


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


def sectors(u, regions) -> int:
    """The distinct 32-byte sectors of ``u`` that ``regions`` touch."""
    index = torch.arange(u.numel(), device=u.device).view(u.shape)
    addrs = torch.cat([index[(..., *r)].flatten() for r in regions])
    return torch.unique((u.data_ptr() + addrs * u.element_size()) // 32).numel()


def unpack_times(u):
    out = {}
    acc = u.clone()
    itemsize = u.element_size()
    for name, d in CLASSES.items():
        region = _region_for(d, POINTS)
        msg = ref.halo_pack(torch.roll(u, 1, 0), region)
        assert torch.equal(hk.halo_unpack_add(u.clone(), msg, region),
                           ref.halo_unpack_add(u.clone(), msg, region)), name
        part = acc[(..., *region)]
        n_bytes = msg.numel() * itemsize
        out[name] = {
            "elements": msg.numel(),
            "kernel_us": median_us(lambda: hk.halo_unpack_add(acc, msg, region)),
            "add_us": median_us(lambda: part.add_(msg)),
            "bound_us": 3 * n_bytes / HBM_BYTES_PER_S * 1e6,
            "sector_bound_us": (2 * 32 * sectors(u, [region]) + n_bytes)
            / HBM_BYTES_PER_S * 1e6}
    return out


def halo_pack_times(u):
    out = {}
    itemsize = u.element_size()
    for name, d in CLASSES.items():
        region = _region_for(d, POINTS)
        want = ref.halo_pack(u, region)
        assert torch.equal(hk.halo_pack(u, region), want), name
        part, slab = u[(..., *region)], torch.empty_like(want)
        n_bytes = want.numel() * itemsize
        out[name] = {
            "elements": want.numel(),
            "kernel_us": median_us(lambda: hk.halo_pack(u, region)),
            "copy_us": median_us(lambda: slab.copy_(part)),
            "bound_us": 2 * n_bytes / HBM_BYTES_PER_S * 1e6,
            "sector_bound_us": (32 * sectors(u, [region]) + n_bytes) / HBM_BYTES_PER_S * 1e6}
    return out


def pack_times(u):
    regions = [_region_for(d, POINTS) for d in DIRECTIONS]
    sent = hk.pack_boundary(u, regions)
    assert torch.equal(sent, ref.pack_boundary(u, regions))
    flats = [u[(..., *r)].flatten(-3) for r in regions]
    n_bytes = sent.numel() * u.element_size()
    return {"regions": len(regions), "ranks": N_RANKS, "total": sent.shape[-1],
            "kernel_us": median_us(lambda: hk.pack_boundary(u, regions)),
            "cat_us": median_us(lambda: torch.cat(flats, dim=-1)),
            "bound_us": 2 * n_bytes / HBM_BYTES_PER_S * 1e6,
            "sector_bound_us": (32 * sectors(u, regions) + n_bytes) / HBM_BYTES_PER_S * 1e6}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("halo_boundary_times: needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    u = torch.randn((N_RANKS, *POINTS), device="cuda", generator=gen)
    result = {"tag": args.tag, "halo_pack": halo_pack_times(u),
              "halo_unpack_add": unpack_times(u), "pack_boundary": pack_times(u)}
    print(json.dumps(result), flush=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
