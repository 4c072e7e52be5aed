"""Build the package's CUDA kernels with nvcc and load them with ctypes.

At first use, :func:`load` compiles ``gym_futbol_tpu_torch/csrc/*.cu``
into one shared library with a plain C interface, under
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and flags; a later call in any process reuses it. The library
file is written under a temporary name and renamed into place, so two
processes building at once do not see a half-written file. nvcc's
output, ``-Xptxas -v`` register and spill report included, is kept
beside the library as ``<library>.log``.

Nothing here runs at import: the CPU tests import the package freely.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # No fast math, and no contraction of a*b+c into FMAs that the plain
    # PyTorch version never does.
    "--fmad=false",
    "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfutbol_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is missing; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(f"{path}.log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.futbol_kernel_num_consts.argtypes = []
    lib.futbol_kernel_num_consts.restype = i
    lib.futbol_fused_rollout_random.argtypes = [
        p, p, p, p, p,        # statef, statei in; statef, statei, reward out
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_rollout_random.restype = i
    lib.futbol_fused_rollout_replay.argtypes = [
        p, p, p, p, p,        # statef, statei in; statef, statei, reward out
        p,                    # actions
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_rollout_replay.restype = i
    _LIB = lib
    return lib
