"""Production mesh construction — port of ``repro.launch.mesh``.

The reference's target is a TPU pod of 16×16 chips, optionally two pods.
The port keeps those mesh shapes, so that every spec and every
per-device byte count of its dry run (:mod:`.dryrun`) can be held against
the reference's, but builds them on the ``meta`` device: they describe
how a step would be sharded, and no tensor of a step on them holds data.
The port runs on one card; a bundle with real tensors on a mesh larger
than 1×1 raises (:mod:`.steps`).

Axes:

* ``data``  — batch / FSDP sharding (16-way a pod);
* ``model`` — tensor / expert parallel (16-way);
* ``pod``   — (multi-pod) data-parallel replication across pods.

The card's constants stand in for the TPU v5e ones, with the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.mesh import Mesh, make_mesh

#: the card the constants are for (name, power limit)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core rate, per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 450e9              # bytes/s per card and direction (18 NVLink 4 links)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``, on
    the ``meta`` device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> Mesh:
    """A small mesh on the host (CPU) for tests and examples."""
    return make_mesh(tuple(shape), tuple(axes), device="cpu")


def mesh_name(mesh: Mesh) -> str:
    """The reference's record name of a production mesh: ``pod16x16`` or
    ``pod2x16x16``."""
    return "pod" + "x".join(str(s) for s in mesh.axis_sizes)
