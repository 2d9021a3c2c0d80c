"""Build and load the hand-written CUDA kernels at first use, and the
helpers every kernel wrapper shares (which path a tensor takes, the
stream, the launch check).

Every ``csrc/*.cu`` has a plain C interface, so ``nvcc`` compiles each
in seconds into a shared library of its own that :mod:`ctypes` loads
(no PyTorch headers involved).  The libraries go to ``kernels/build/``
(ignored by git) under names that hash the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is
built at import time: a wrapper's first launch calls
:func:`load_library` for its own source, with the C types of its entry
points, which the wrapper declares; :func:`build_all` compiles
every source at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: Optional[float]  # None when an existing library was reused
    log: str                  # nvcc's output (ptxas register/spill report)


def sources() -> Dict[str, Path]:
    """Every CUDA source of the port, by name (``csrc/<name>.cu``)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name hashes the source and
    the flags, so the library of an edited source is a new file."""
    digest = hashlib.sha256(sources()[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> Dict[str, BuildInfo]:
    """Compile the named sources (all by default) that were not built
    before, one ``nvcc`` process each, started together; raises if any
    fails."""
    todo = {n: library_path(n) for n in (names or sources())}
    missing = [n for n, path in todo.items() if not path.exists()]
    nvcc = nvcc_path() if missing else ""
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in missing:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, path in todo.items():
        if name not in procs:
            out[name] = BuildInfo(path, None, "")
            continue
        tmp, proc = procs[name]
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, path)  # atomic: concurrent builds agree on one file
            out[name] = BuildInfo(path, time.perf_counter() - t0, log)
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}


def load_library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it once, and declare the
    C argument types of the entry points its wrapper names in
    ``signatures`` (every library also has ``rt_error_string``)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def use_plain(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the wrapper runs the plain version) and for
    ``meta`` tensors (the plain version gives the shapes of a dry run and
    computes nothing); False for tensors on one CUDA device (it launches
    the kernel or raises)."""
    kinds = {t.device for t in tensors}
    if all(d.type == "cpu" for d in kinds) or all(d.type == "meta" for d in kinds):
        return True
    if len(kinds) == 1 and next(iter(kinds)).type == "cuda":
        return False
    raise ValueError(f"the kernels take tensors on the CPU or on one CUDA device (or all on "
                     f"the meta device), got {sorted(map(str, kinds))}")


def stream_arg(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned an error."""
    if code:
        msg = _LOADED[name].rt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (error {code})")
