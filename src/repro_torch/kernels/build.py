"""Build and load the hand-written CUDA kernels at first use.

``csrc/halo_pack.cu`` has a plain C interface, so ``nvcc`` compiles it
in seconds into a shared library that :mod:`ctypes` loads (no PyTorch
headers involved).  The library goes to ``kernels/build/`` (ignored by
git) under a name that hashes the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built at
import time: the first kernel launch calls :func:`load_library`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "halo_pack.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "rt_halo_pack": [_I, _P, _P, _I64] + [_I] * 9 + [_P],
    "rt_halo_unpack_add": [_I, _P, _P, _I64] + [_I] * 9 + [_P],
    "rt_pack_segments": [_I, _P, _I, _P, _I64, _I64, _P],
    "rt_unpack_segments": [_I, _P, _I64, _I64, _P, _I, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: Optional[float]  # None when an existing library was reused
    log: str                  # nvcc's output (ptxas register/spill report)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libhalo_pack-{digest}.so"


def build_library() -> BuildInfo:
    """Compile ``csrc/halo_pack.cu`` unless this source was built before."""
    path = library_path()
    if path.exists():
        return BuildInfo(path, None, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds agree on one file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C types."""
    lib = ctypes.CDLL(str(build_library().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib
