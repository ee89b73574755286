"""Build the CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

``csrc/field_kernels.cu`` has a plain C interface and includes no PyTorch
header, so it compiles in seconds. The shared library goes to
``build/posendf_torch/field_kernels_<hash>.so`` under the repository root,
keyed by a hash of the source and the compiler flags: an edited source is
rebuilt, an unchanged one is loaded as it is. Pointers and the CUDA stream
are passed as ``c_void_p``; each launcher returns ``cudaGetLastError()``,
and :func:`check` raises on any nonzero value.
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

__all__ = ["library", "check", "build_info", "SOURCE", "ACT_CODES"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "field_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "posendf_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# activation codes of the kernels' `act` argument
ACT_CODES = {"lrelu": 0, "relu": 1, "softplus": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (pose, B, enc, parents, J, F, dfw, meta, L, maxw, zsum, act, beta, ...)
_COMMON = [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F]
_SIGNATURES = {
    # ..., d_out, stream
    "posendf_forward": (_COMMON + [_P, _P], _I),
    # ..., d_out, g_out, zscratch, stream
    "posendf_value_and_grad": (_COMMON + [_P, _P, _P, _P], _I),
    # ..., d_out, q_out, zscratch, step_scale, tangent, renormalize, stream
    "posendf_project_step": (_COMMON + [_P, _P, _P, _F, _I, _I, _P], _I),
    # (J, F, L, maxw) -> dynamic shared memory bytes of one block
    "posendf_smem_bytes": ([_I, _I, _I, _I], _I),
    "posendf_error_string": ([_I], ctypes.c_char_p),
}

_INFO: dict = {}


def _nvcc() -> str:
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    path = shutil.which("nvcc") or (cuda_nvcc if os.path.exists(cuda_nvcc) else None)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    _INFO.update(built=True, seconds=time.perf_counter() - t0,
                 log=(res.stdout + res.stderr).strip())


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if the source changed."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"field_kernels_{key}.so"
    _INFO.update(path=str(out), built=False, seconds=0.0, log="")
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_info() -> dict:
    """Path, whether this process compiled it, seconds taken and nvcc's
    output (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    library()
    return dict(_INFO)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().posendf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
