"""ctypes binding of the native batch loader (``native/posendf_io.cc``).

Port of ``posendf_tpu/data/native.py``. The C++ runtime maps .npz files
(``np.savez`` writes STORED zip entries: nothing to decode) and assembles
training batches on a thread pool: random row gathers, the k-label mean,
optional w >= 0 quaternion flips. Each row is drawn from
``splitmix64(seed + golden * (item + 1)) % rows`` (:func:`draw_rows` is the
same draw in numpy), so a batch is the same for any thread count.

The port builds its own copy of the library from the repository's source at
first use: ``g++`` with the flags of ``native/build.sh`` into
``build/posendf_torch/posendf_io_<hash>.so`` (keyed by the source and the
flags, as ``_build.py`` keys the CUDA kernels); it never loads
``native/libposendf_io.so`` or the JAX package's copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from posendf_torch._build import BUILD_DIR

__all__ = ["available", "build", "library_path", "NativeNpz", "assemble_batch", "draw_rows"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "posendf_io.cc"
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread"]
MAN_SEED_XOR = 0xDEADBEEF     # the manifold draws' seed: the file's seed ^ this

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of this source and these flags is (or will be)
    built: under the module's ``BUILD_DIR`` (``build/posendf_torch/``)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return Path(BUILD_DIR) / f"posendf_io_{key}.so"


def _compile(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native loader is built with g++")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    P, I64, U64, I, FP = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_float))
    sig = {
        "pndf_open": ([ctypes.c_char_p], P),
        "pndf_close": ([P], None),
        "pndf_rows": ([P, ctypes.c_char_p], I64),
        "pndf_row_elems": ([P, ctypes.c_char_p], I64),
        "pndf_sample_labeled": ([P, I64, U64, I, FP, FP, I], I),
        "pndf_sample_rows": ([P, ctypes.c_char_p, I64, U64, I, FP, I], I),
        "pndf_assemble_batch": ([ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(U64),
                                 I64, I64, I, I, FP, FP, FP, I], I),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def build() -> ctypes.CDLL:
    """The loaded library, compiled first if this source was not built yet
    (raises if the build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            _lib = _bind(path)
        return _lib


def available() -> bool:
    """Whether the library is built (loaded, or on disk for this source)."""
    return _lib is not None or library_path().exists()


def draw_rows(seed: int, n: int, rows: int) -> np.ndarray:
    """The rows the native loader draws for items 0..n-1 of ``seed`` (its
    ``draw_below``: splitmix64 of ``seed + 0x9E3779B97F4A7C15 * (i + 1)``,
    modulo ``rows``), in numpy's wrapping uint64 arithmetic."""
    with np.errstate(over="ignore"):
        z = (np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
             + np.uint64(0x9E3779B97F4A7C15) * (np.arange(n, dtype=np.uint64) + np.uint64(1)))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(rows)).astype(np.int64)


def _fptr(a: np.ndarray, shape):
    """A float pointer to an out-buffer, checked first: the C side writes
    blindly, so a wrong dtype garbles data and a short or strided buffer
    corrupts the heap."""
    if a.dtype != np.float32:
        raise TypeError(f"out buffer must be float32, got {a.dtype}")
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("out buffer must be C-contiguous")
    if a.shape != tuple(shape):
        raise ValueError(f"out buffer shape {a.shape} != required {tuple(shape)}")
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeNpz:
    """An mmap'd .npz with the native gathers. Raises ``OSError`` for a
    file the reader refuses (a compressed .npz, a truncated one)."""

    def __init__(self, path: str):
        self._lib = build()
        self._h = self._lib.pndf_open(str(path).encode())
        if not self._h:
            raise OSError(f"native open failed for {path} (compressed npz or bad file)")
        self.path = str(path)

    def _handle(self):
        if not self._h:
            raise ValueError(f"NativeNpz for {self.path} is closed")
        return self._h

    def rows(self, key: str) -> int:
        return int(self._lib.pndf_rows(self._handle(), key.encode()))

    def row_elems(self, key: str) -> int:
        return int(self._lib.pndf_row_elems(self._handle(), key.encode()))

    def sample_labeled(self, n: int, seed: int, flip: bool = False, threads: int = 4,
                       poses_out: Optional[np.ndarray] = None,
                       dist_out: Optional[np.ndarray] = None):
        """(poses (n, 21, 4), dist (n,)) float32: rows ``draw_rows(seed, n,
        rows)`` and the mean of their k labels."""
        pe = self.row_elems("pose")
        poses = poses_out if poses_out is not None else np.empty((n, pe), np.float32)
        dist = dist_out if dist_out is not None else np.empty((n,), np.float32)
        rc = self._lib.pndf_sample_labeled(self._handle(), n, seed & 0xFFFFFFFFFFFFFFFF,
                                           int(flip), _fptr(poses, (n, pe)), _fptr(dist, (n,)),
                                           threads)
        if rc != 0:
            raise RuntimeError(f"pndf_sample_labeled failed rc={rc} for {self.path}")
        return poses.reshape(n, pe // 4, 4), dist

    def sample_rows(self, key: str, n: int, seed: int, flip: bool = False, threads: int = 4,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, row_elems) float32: rows ``draw_rows(seed, n, rows)`` of ``key``."""
        pe = self.row_elems(key)
        if pe < 0:
            raise KeyError(f"{key} not in {self.path}")
        out = out if out is not None else np.empty((n, pe), np.float32)
        rc = self._lib.pndf_sample_rows(self._handle(), key.encode(), n,
                                        seed & 0xFFFFFFFFFFFFFFFF, int(flip),
                                        _fptr(out, (n, pe)), threads)
        if rc != 0:
            raise RuntimeError(f"pndf_sample_rows failed rc={rc} for {self.path}")
        return out

    def close(self):
        if self._h:
            self._lib.pndf_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def assemble_batch(labeled: List[NativeNpz], manifold: Optional[List[NativeNpz]],
                   seeds: List[int], num_pts: int, flip: bool, ref_flip_quirk: bool,
                   poses_out: np.ndarray, dist_out: np.ndarray, man_out: np.ndarray,
                   threads: int = 4) -> None:
    """One whole training batch in one native call (``pndf_assemble_batch``):
    file b's rows are ``draw_rows(seeds[b], num_pts, ...)`` and its manifold
    rows ``draw_rows(seeds[b] ^ MAN_SEED_XOR, ...)``, the per-file calls'
    draws. ``manifold`` may be None only under ``ref_flip_quirk`` (the
    manifold poses are then the flipped noisy rows, ``load_data.py:63``)."""
    lib = build()
    B = len(labeled)
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for {B} labeled files")
    if not ref_flip_quirk and (manifold is None or len(manifold) != B):
        raise ValueError("manifold handles required unless ref_flip_quirk")
    pe = labeled[0].row_elems("pose")
    labs = (ctypes.c_void_p * B)(*[h._handle() for h in labeled])
    mans = None if ref_flip_quirk else (ctypes.c_void_p * B)(*[h._handle() for h in manifold])
    seed_arr = (ctypes.c_uint64 * B)(*[s & 0xFFFFFFFFFFFFFFFF for s in seeds])
    n = B * num_pts
    rc = lib.pndf_assemble_batch(labs, mans, seed_arr, B, num_pts, int(flip),
                                 int(ref_flip_quirk), _fptr(poses_out, (n, pe)),
                                 _fptr(dist_out, (n,)), _fptr(man_out, (n, pe)), threads)
    if rc != 0:
        raise RuntimeError(f"pndf_assemble_batch failed rc={rc} "
                           f"(files: {[h.path for h in labeled]})")
