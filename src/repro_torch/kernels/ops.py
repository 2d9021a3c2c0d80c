"""The kernels' public entry point — port of ``repro.kernels.ops``.

The same names and function arguments as the reference:
``halo_pack``, ``halo_unpack_add``, ``pack_boundary``,
``unpack_boundary_add``, ``rmsnorm`` (any leading dimensions),
``flash_attention`` and ``ssd_scan``.  The reference's TPU tiling and
interpret arguments (``block_rows``, ``block_q``, ``block_k``,
``interpret``) have no counterpart: the tensors' device picks the route
(:func:`.build.use_plain`), so CPU tensors run the plain versions of
:mod:`.ref` and CUDA tensors the hand-written Hopper kernels, which
launch or raise.  There is no environment variable and no backend
switch.

Two differences from the reference, both for the card's memory: the
unpacks add into ``u`` in place and return it, and ``flash_attention``
returns a ``[B,Hq,Sq,D]`` view of ``[B,Sq,Hq,D]`` memory.
:func:`launch_counts` (not in ``__all__``, which mirrors the reference's
names) gathers every kernel's launch counters; :func:`embedding` (not in
``__all__`` either: the reference's lookup is ``jnp.take`` in its model
code) is the lookup whose backward is the hand-written kernel of
:mod:`.embedding`.
"""

from __future__ import annotations

from typing import Dict

from . import embedding as _embedding
from . import flash_attention as _flash
from . import halo_pack as _halo
from . import ref
from . import rmsnorm as _rmsnorm
from . import ssd_scan as _ssd
from .embedding import embedding
from .flash_attention import flash_attention
from .halo_pack import halo_pack, halo_unpack_add, pack_boundary, unpack_boundary_add
from .rmsnorm import rmsnorm
from .ssd_scan import ssd_scan

__all__ = [
    "halo_pack", "halo_unpack_add", "pack_boundary", "unpack_boundary_add",
    "rmsnorm", "flash_attention", "ssd_scan", "ref",
]


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count by name (flash attention
    also by route)."""
    out: Dict[str, int] = {}
    for module in (_halo, _rmsnorm, _flash, _ssd, _embedding):
        out.update(module.launch_counts())
    return out
