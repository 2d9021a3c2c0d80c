"""PyTorch/CUDA port of the stream-triggered (ST) message-passing system.

``repro_torch`` mirrors the JAX package ``repro`` module for module
(``core/``, ``kernels/``) and name for name (``STQueue``, ``STProgram``,
``FusedEngine``, ``HostEngine``, ``PersistentEngine``, ``FacesConfig``,
``build_faces_program``).  All ranks of a program live on one GPU in the
reference's global layout; the halo kernels are hand-written CUDA for
Hopper (``kernels/csrc``).  It imports torch, numpy and the standard
library only.
"""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
