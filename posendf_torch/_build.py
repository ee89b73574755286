"""Build the CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each source in ``csrc/`` has a plain C interface and includes no PyTorch
header, so it compiles in seconds:

  ``field``  ``csrc/field_kernels.cu``  forward, value-and-grad, projection step
  ``train``  ``csrc/train_kernels.cu``  encoder, training gradient (tile + reduction)
  ``knn``    ``csrc/knn_kernels.cu``    geodesic top-k (the engines' corpus packs, the
                                        top-k per corpus range, the merge)
  ``int8``   ``csrc/int8_kernels.cu``   int8 serving forward, bf16 / int8 probe chains

All include ``csrc/common.cuh`` and ``csrc/hopper.cuh`` (the PTX of wgmma,
mbarriers and bulk copies, and the ring of slabs they share); ``field`` and
``train`` also include ``csrc/tc_tile.cuh`` (the 64-pose tile, the program's
header, the 3xTF32 A split and the encoder walk they share). A library goes to
``build/posendf_torch/<name>_<hash>.so`` under the repository root, keyed by
a hash of its source, the headers and the compiler flags: an edited source is
rebuilt, an unchanged one is loaded as it is. Different libraries may be
built at once from several threads. Pointers and the CUDA stream are
passed as ``c_void_p``; each launcher returns ``cudaGetLastError()``, and
:func:`check` raises on any nonzero value.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["library", "check", "build_info", "SOURCES", "ACT_CODES"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"field": CSRC / "field_kernels.cu", "train": CSRC / "train_kernels.cu",
           "knn": CSRC / "knn_kernels.cu", "int8": CSRC / "int8_kernels.cu"}
HEADERS = [CSRC / "common.cuh", CSRC / "hopper.cuh", CSRC / "tc_tile.cuh"]
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "posendf_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]

# activation codes of the kernels' `act` argument
ACT_CODES = {"lrelu": 0, "relu": 1, "softplus": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (pose, B, enc, parents, J, F, slabs, vec, prog, nfwd, nbwd, act, beta, bf16, full, split,
#  split_slabs, ...)
_COMMON = [_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P]
_SIGNATURES = {
    "field": {
        # ..., d_out, stream
        "posendf_forward": (_COMMON + [_P, _P], _I),
        # ..., d_out, g_out, zscratch, stream
        "posendf_value_and_grad": (_COMMON + [_P, _P, _P, _P], _I),
        # ..., d_out, q_out, zscratch, step_scale, tangent, renormalize, stream
        "posendf_project_step": (_COMMON + [_P, _P, _P, _F, _I, _I, _P], _I),
        # (B, J, F, zsum, act) -> floats of the derivative-state scratch a launch needs
        "posendf_field_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
        # (act, cluster) -> CTAs of the 3xTF32 kernel that clusters of that size keep resident
        # (cluster 1: a launch without clusters)
        "posendf_field_cluster_slots": ([_I, _I], _I),
        # () -> dynamic shared memory bytes of one CTA
        "posendf_smem_bytes": ([], _I),
        "posendf_error_string": ([_I], ctypes.c_char_p),
    },
    "train": {
        # quat, B, enc, parents, J, F, act, beta, out, stream
        "posendf_encoder": ([_P, _I, _P, _P, _I, _I, _I, _F, _P, _P], _I),
        # enc, parents, J, F, slabs, vec, prog, nfwd, nbwd, meta, L, act, l2, eik_coef, then
        # each branch (noisy, manifold): pose, B, gt, dd_coef, a_scr, c_scr, dd_out,
        # enc_slot, loss_slot, scratch; stream
        "posendf_train_tile": ([_P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _F]
                               + 2 * [_P, _I, _P, _F, _P, _P, _P, _P, _P, _P] + [_P], _I),
        # B -> CTAs (encoder and loss slots) of a branch of the tile kernel
        "posendf_train_tile_ctas": ([_I], _I),
        # F -> the tile's encoder walk: 1 compiled width, 0 run-time width, -1 not taken
        "posendf_train_tile_walk": ([_I], _I),
        # (B, J, F, zsum) -> floats of a branch's scratch of the tile kernel
        "posendf_train_tile_scratch_floats": ([_I, _I, _I, _I], ctypes.c_longlong),
        # meta, meta_host, L, a_n, c_n, dd_n, rows_n, a_m, c_m, dd_m, rows_m, enc_slot,
        # loss_slot, nslots_n, nslots_m, J, F, partial, grads, loss, stream
        "posendf_train_reduce": ([_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I,
                                  _I, _I, _P, _P, _P, _P], _I),
        # (meta_host, L, rows_n, rows_m) -> floats of the reduction's partial buffer
        "posendf_train_reduce_partial_floats": ([_P, _I, _I, _I], _I),
        "posendf_train_error_string": ([_I], ctypes.c_char_p),
    },
    "knn": {
        # c, N, packed, cmax, stream
        "posendf_knn_pack_joint": ([_P, _I, _P, _P, _P], _I),
        # N -> bytes of the exact and bf16 engines' packed corpus
        "posendf_knn_joint_bytes": ([_I], ctypes.c_longlong),
        # q, Q, c, packed, cmax, N, w (host, 21 floats), w_total, engine, k, kpad, S, part_d,
        # part_i, stream
        "posendf_knn_joint": ([_P, _I, _P, _P, _P, _I, ctypes.POINTER(_F), _F, _I, _I, _I, _I, _P,
                               _P, _P], _I),
        # c, N, packed, cmax, stream
        "posendf_knn_pack": ([_P, _I, _P, _P, _P], _I),
        # N -> bytes of the packed corpus
        "posendf_knn_bound_bytes": ([_I], _I),
        # q, Q, packed, cmax, N, w_total, kpad, S, part_d, part_i, stream
        "posendf_knn_bound": ([_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P], _I),
        # part_d, part_i, S, Q, kpad, k, d_out, i_out, stream
        "posendf_knn_merge": ([_P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
        "posendf_knn_error_string": ([_I], ctypes.c_char_p),
    },
    "int8": {
        # pose, B, enc, parents, J, F, fw, qw, meta, L, x0_bytes, x1_bytes, maxn8, act, beta,
        # d_out, stream
        "posendf_forward_int8": ([_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
                                  _P], _I),
        # (x0_bytes, x1_bytes, maxn8) -> dynamic shared memory bytes of one CTA
        "posendf_int8_smem_bytes": ([_I, _I, _I], _I),
        # x, packed w, B, layers, out, stream
        "probe_bf16_chain": ([_P, _P, _I, _I, _P, _P], _I),
        # x, w, s, B, layers, out, stream
        "probe_int8_chain": ([_P, _P, _P, _I, _I, _P, _P], _I),
        "posendf_int8_error_string": ([_I], ctypes.c_char_p),
    },
}
_ERROR_STRING = {"field": "posendf_error_string", "train": "posendf_train_error_string",
                 "knn": "posendf_knn_error_string", "int8": "posendf_int8_error_string"}

_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    path = shutil.which("nvcc") or (cuda_nvcc if os.path.exists(cuda_nvcc) else None)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    blob = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def _compile(name: str) -> None:
    out = _target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    _INFO[name] = dict(path=str(out), built=True, seconds=time.perf_counter() - t0,
                       log=proc.stdout.strip())


@functools.cache
def library(name: str = "field") -> ctypes.CDLL:
    """The named kernels' shared library, built first if its source changed."""
    out = _target(name)
    if not out.exists():
        _compile(name)
    _INFO.setdefault(name, dict(path=str(out), built=False, seconds=0.0, log=""))
    lib = ctypes.CDLL(str(out))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_info(name: str = "field") -> dict:
    """Path, whether this process compiled it, seconds taken and nvcc's
    output (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    library(name)
    return dict(_INFO[name])


def check(err: int, what: str, name: str = "field") -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error."""
    if err != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
