"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, named by a hash of the sources,
in ``panogrf_tpu_torch/_build/`` (ignored by git), with nvcc's output
(ptxas's registers and spills) beside it in a ``.log`` of the same name.
The build runs at first use in the process; a library whose sources have
not changed is reused, and its log read back.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.panogrf_mlp2.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.panogrf_mlp2.restype = i
    lib.panogrf_mlp3.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.panogrf_mlp3.restype = i
    lib.panogrf_cross_view_pool.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.panogrf_cross_view_pool.restype = i
    lib.panogrf_ray_attention.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.panogrf_ray_attention.restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(exist_ok=True)
    lib_path = BUILD_DIR / f"libpanogrf_kernels_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    reused = lib_path.exists()
    if reused:
        log = log_path.read_text() if log_path.exists() else ""
    else:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        tmp_log = log_path.with_suffix(f".{os.getpid()}.logtmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, lib_path)
    BUILD_INFO.update(path=str(lib_path), log=log, reused=reused,
                      seconds=time.perf_counter() - t0,
                      sources=[str(s.relative_to(_PKG.parent))
                               for s in sources])
    _LIB = _declare(ctypes.CDLL(str(lib_path)))
    return _LIB
