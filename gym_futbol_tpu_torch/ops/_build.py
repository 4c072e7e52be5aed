"""Build the package's CUDA kernels with nvcc and load them with ctypes.

At first use, :func:`load` compiles each ``gym_futbol_tpu_torch/csrc/*.cu``
to an object file, all nvcc processes started together, and links them
into one shared library with a plain C interface, under
``build/torch_kernels/`` at the repository root. The library is named
by a hash of the flags and of every source, the shared headers
(``csrc/*.cuh``) included, so an edit to any of them builds a new
library; a later call in any process reuses it. The library file is
written under a temporary name and renamed into place, so two processes
building at once do not see a half-written file. nvcc's output,
``-Xptxas -v`` register and spill report included, is kept beside the
library as ``<library>.log``.

Every wrapper launches through :func:`launch`, which counts the launch
in :data:`LAUNCHES` under a counter its module registered
(:func:`counters`). The card's limits the planners lay kernels out by
are :data:`SMEM_BYTES` and :data:`SMS`.

Nothing here builds at import: the CPU tests import the package freely.
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
    "-Xcompiler", "-fPIC",
    # No fast math, and no contraction of a*b+c into FMAs that the plain
    # PyTorch version never does.
    "--fmad=false",
    "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None

SMEM_BYTES = 232448   # shared memory a block may use (H100)
SMS = 132             # the H100's SMs

# Kernel launches by counter, for every kernel of the package. The policy
# wrappers count their bfloat16 tensor-core route under their own name
# and their float32 route under ``<name>_f32``; the update its
# tensor-core route under its name and its CUDA-core chain under
# ``<name>_chain``; the random rollout its lanes route under its name and
# its one-thread-per-env route under ``<name>_union``; K6 each of its two
# kernels (forward, backward) under ``fused_lstm_bptt``.
LAUNCHES: dict[str, int] = {}


def counters(*names: str) -> None:
    """Register launch counters, each at 0: a kernel module registers
    its own at import."""
    for name in names:
        LAUNCHES.setdefault(name, 0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(entry: str, counter: str, *args) -> None:
    """Call the library's C entry ``entry`` with ``args`` (building the
    library at first use); raise on a non-zero ``cudaError_t``, else
    count one launch under ``counter``."""
    err = getattr(load(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{counter} ({entry}): kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[counter] += 1


def _sources(csrc_dir: str = CSRC_DIR, pattern: str = "*.cu") -> list[str]:
    return sorted(glob.glob(os.path.join(csrc_dir, pattern)))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def library_path(csrc_dir: str = CSRC_DIR) -> str:
    """Where the library for the sources and headers in ``csrc_dir``
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc_dir, "*.cu") + _sources(csrc_dir, "*.cuh"):
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = f"{path}.{os.path.basename(src)}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    tmp = f"{path}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(f"{path}.log", "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.futbol_kernel_num_consts.argtypes = []
    lib.futbol_kernel_num_consts.restype = i
    lib.futbol_fused_rollout_random.argtypes = [
        p, p, p, p, p,        # statef, statei in; statef, statei, reward out
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        i, i,                 # plan: lanes per env, threads per block
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_rollout_random.restype = i
    lib.futbol_fused_rollout_replay.argtypes = [
        p, p, p, p, p,        # statef, statei in; statef, statei, reward out
        p,                    # actions
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        i, i,                 # plan: lanes per env, threads per block
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_rollout_replay.restype = i
    lib.futbol_fused_collect.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i32p, i,           # flat weights, layer table [n, 4], n_layers
        p, p, p, p, p, p, p,  # obs, dirs, acts, logp, value, reward, done
        p,                    # last_value
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i, i,           # n_bodies, B, T, F_pad
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales (1/w, 1/h, 1/max_speed)
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_collect.restype = i
    lib.futbol_fused_selfplay.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i32p,              # policy A: flat weights, layer table
        p, i32p,              # policy B: flat weights, layer table
        i,                    # n_layers (both)
        p, p,                 # reward, goals
        p, p,                 # packed dirs, acts [T, 2, B] or NULL
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_selfplay.restype = i
    lib.futbol_fused_collect_tc.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i, p,              # bf16 weight fragments, their 16-byte units, f32 vector
        i32p, i, i,           # layer table [n, 4], n_layers (torso + logits),
                              # value head offset
        i32p,                 # plan: envs, resident, tile bytes x2, row strides x2
        p, p, p, p, p, p, p,  # obs, dirs, acts, logp, value, reward, done
        p,                    # last_value
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i, i,           # n_bodies, B, T, F_pad
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_collect_tc.restype = i
    lib.futbol_collect_tc_culls.argtypes = [i]   # n_bodies
    lib.futbol_collect_tc_culls.restype = i
    lib.futbol_fused_selfplay_tc.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i, p,              # bf16 weight fragments (both MLPs), units, f32 vector
        i32p, i32p, i,        # layer tables of A and B, n_layers (both)
        i32p,                 # plan
        p, p,                 # reward, goals
        p, p,                 # packed dirs, acts [T, 2, B] or NULL
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i,              # n_bodies, B, T
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_selfplay_tc.restype = i
    lib.futbol_fused_recurrent.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i32p, i, i,        # flat weights, layer table [n_torso + 2, 4],
                              # n_torso, LSTM size H
        p, p, p, p,           # carry_c, carry_h in; carry_c, carry_h out
        p, p, p, p, p, p, p,  # obs, dirs, acts, logp, value, reward, done
        p,                    # last_value
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i, i,           # n_bodies, B, T, F_pad
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_recurrent.restype = i
    lib.futbol_fused_recurrent_tc.argtypes = [
        p, p, p, p,           # statef, statei in; statef, statei out
        p, i, p,              # bf16 weight fragments, their 16-byte units, f32 vector
        i32p, i, i, i,        # layer table [n_torso + 2, 4], n_torso, LSTM size H,
                              # value head offset
        i32p,                 # plan: envs, resident units, tile bytes x3, row strides x3
        p, p, p, p,           # carry_c, carry_h in; carry_c, carry_h out
        p, p, p, p, p, p, p,  # obs, dirs, acts, logp, value, reward, done
        p,                    # last_value
        p,                    # uniforms table or NULL
        ctypes.c_uint32,      # seed
        i, i, i, i,           # n_bodies, B, T, F_pad
        i, i, i,              # substeps, solver_iterations, max_steps
        f32p, i,              # host constants, count
        f32p,                 # observation scales
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_recurrent_tc.restype = i
    # the LayerNorm instantiation: the same, with the LayerNorm vectors'
    # offset in the f32 vector and a scratch [2, 2, H, B] f32 after the
    # value head's offset
    ln_tc = list(lib.futbol_fused_recurrent_tc.argtypes)
    lib.futbol_fused_recurrent_ln_tc.argtypes = ln_tc[:11] + [i, p] + ln_tc[11:]
    lib.futbol_fused_recurrent_ln_tc.restype = i
    lib.futbol_fused_update.argtypes = [
        p, p,                 # host arrays of weight / gradient pointers
        i32p, i, i, i,        # widths [n_torso + 1], n_torso, F, G*5
        p, ctypes.c_longlong,  # obs [F_pad, N], N
        p, i, i,              # block indices, mb_blocks, block
        p, p, p, p, p, p,     # dirs, acts, logp, value, ret, adv_n
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        i,                    # bf16 operands (1) or float32 (0)
        p, p, p, p,           # activation pointers, dz, dlogits, dvalue
        p, ctypes.c_longlong, i,  # partials, their size, chunk
        p,                    # metrics [4]
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_update.restype = i
    lib.futbol_fused_update_tc.argtypes = [
        p, p, p,              # bf16 W1, W2, Wl, padded
        p, p, p, p, p,        # float32 b1, b2, bl, wv (padded), bv
        i, i, i, i, i,        # F_pad, F1 padded, H1 padded, H2 padded or 0, G
        i,                    # W2 streamed (1) or resident (0)
        p, ctypes.c_longlong,  # obs [F_pad, N], N
        p, i, i,              # block indices, mb_blocks, block
        p, p, p, p, p, p,     # dirs, acts, logp, value, ret, adv_n
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        p, p,                 # dz, rounded obs (bf16)
        p, p, i,              # forward / backward partials, chunk
        p, p,                 # forward / backward sums
        p,                    # cudaStream_t
    ]
    lib.futbol_fused_update_tc.restype = i
    lib.futbol_bptt_forward_tc.argtypes = [
        p, p, p, i, p,        # t's fragments, Wi/Wh fragments (hi, lo), their
                              # units, bias
        p, p, p,              # done (u8 [T, S]), c0, h0
        p, p, p, p, p, p, p,  # gates, c (fragment order), h, h_{t-1} (hi,
                              # lo), c and h after the window
        i, i, i, i,           # S, T, kt, H
        p,                    # cudaStream_t
    ]
    lib.futbol_bptt_forward_tc.restype = i
    lib.futbol_bptt_backward_tc.argtypes = [
        p, p, p, p, p,        # gates, c (fragment order), c0, done, dh of every step
        p, p, i,              # fragments of Wh^T (hi, lo), their units
        p, p,                 # dgates (hi, lo: bf16 [T, S, H, 4])
        i, i, i,              # S, T, H
        p,                    # cudaStream_t
    ]
    lib.futbol_bptt_backward_tc.restype = i
    lib.futbol_bptt_ln_forward_tc.argtypes = [
        p, p, p, i,           # the gates' input side (f32 [T, S, H, 4]), Wh
                              # fragments (hi, lo), their units
        p, p, p, p,           # gh, bh (the kernel's column order), gc, bc [H]
        p, p, p,              # done (u8 [T, S]), c0, h0
        p, p, p, p, p, p, p,  # gates, c' (fragment order), h, h_{t-1} (hi,
                              # lo), c and h after the window
        p, p, p,              # y = h_{t-1} Wh [T, S, H, 4], its rows' and c''s
                              # statistics [T, S, 2]
        i, i, i,              # S, T, H
        p,                    # cudaStream_t
    ]
    lib.futbol_bptt_ln_forward_tc.restype = i
    lib.futbol_bptt_ln_backward_tc.argtypes = [
        p, p, p, p, p,        # gates, c' (fragment order), c0, done, dh of every step
        p, p, i,              # fragments of Wh^T (hi, lo), their units
        p, p,                 # dy (hi, lo: bf16 [T, S, H, 4])
        p, p, p,              # y, its statistics, c''s statistics
        p, p, p,              # gh ([H, 4] unit-major), gc, bc [H]
        p, p,                 # dpre f32 [T, S, H, 4], dn f32 [T, S, H]
        i, i, i,              # S, T, H
        p,                    # cudaStream_t
    ]
    lib.futbol_bptt_ln_backward_tc.restype = i
    _LIB = lib
    return lib
