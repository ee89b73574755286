"""Host-side training input pipeline.

Port of ``posendf_tpu/data/pipeline.py``. Reference semantics
(``model/load_data.py:18-86``): each training example draws ``num_pts``
random (pose, distance-label) rows from one labelled .npz file (distance =
mean of the kNN distances) plus ``num_pts`` clean manifold poses from one
random raw-AMASS file; a step batches ``batch_size`` such draws; ``epoch()``
visits every labelled file once per epoch in a seeded permutation, dropping
the last partial batch. For the same ``(seed, epoch)`` the batch stream is
the JAX package's, draw for draw.

``flip`` quirk (reference ``load_data.py:51-63``): under ``flip`` with
``flip_mode="reference"`` the manifold poses are the flipped NOISY rows;
``flip_mode="corrected"`` flips real manifold draws.

Two backends assemble a batch, as in the JAX package: ``numpy`` (the
draws of a numpy generator) and ``native`` (the C++ loader of
``data/native.py``: mmap'd files, threaded gathers, rows drawn by a
splitmix64 hash of a per-file seed; the same files and labels, other
rows). ``auto`` takes ``native`` when its library is built and ``numpy``
otherwise; ``native`` builds it, and raises if the build fails. Either
way a batch consumes one draw of the batcher's generator, so a native
loader that fails mid-run falls back to numpy without changing the
batches that follow.

:func:`prefetch_to_device` replaces the JAX prefetcher: a thread assembles
batches ahead, copies them into pinned host memory and issues
``non_blocking`` host-to-device copies, so input assembly overlaps the
train step.
"""

from __future__ import annotations

import collections
import glob
import os
import queue
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from posendf_torch.data.splits import AMASS_SPLITS

__all__ = ["TrainingBatcher", "prefetch_to_device"]


def _flip_np(q: np.ndarray) -> np.ndarray:
    return np.where(q[..., :1] < 0, -q, q)


class TrainingBatcher:
    """Samples flat training batches from labelled + raw pose files.

    Args:
      data_dir: directory of labelled files ``<subset>/<seq>.npz`` with keys
        ``pose`` (N, 21, 4) and ``dist`` (N, K).
      amass_dir: directory of clean pose files ``<subset>/<seq>.npz`` with a
        ``pose`` (N, 21, 4) key.
      split: which AMASS split's subsets to read (``train``/``vald``/``test``).
      batch_size: files per step (reference: 4).
      num_pts: rows per file per step (reference: 5000).
      flip: canonicalize quaternions to w >= 0.
      flip_mode: ``reference`` or ``corrected`` (see the module docstring).
      seed: RNG seed; per-epoch streams derive from it.
      file_glob: pattern under data_dir. None = the reference's
        ``*/*000.npz`` filter, falling back to ``*/*.npz`` with a warning
        when that matches nothing; an explicit glob is used verbatim.
      subsets: overrides the split's subset list.
      backend: ``auto``, ``numpy`` or ``native`` (see the module docstring).
      native_threads: the native loader's gather threads.
    """

    def __init__(self, data_dir: str, amass_dir: str, split: str = "train",
                 batch_size: int = 4, num_pts: int = 5000, flip: bool = False,
                 flip_mode: str = "reference", seed: int = 0,
                 file_glob: Optional[str] = None, subsets: Optional[Sequence[str]] = None,
                 backend: str = "auto", native_threads: int = 4):
        subsets = list(subsets) if subsets is not None else AMASS_SPLITS[split]

        def _labeled(pattern: str) -> List[str]:
            return [f for f in sorted(glob.glob(os.path.join(data_dir, pattern)))
                    if os.path.basename(os.path.dirname(f)) in subsets]

        if file_glob is None:
            labeled = _labeled("*/*000.npz")
            if not labeled:
                labeled = _labeled("*/*.npz")
                if labeled:
                    warnings.warn(
                        "no */*000.npz labeled shards (the reference's training-file "
                        "filter) — falling back to */*.npz; pass file_glob explicitly "
                        "to silence", stacklevel=2)
        else:
            labeled = _labeled(file_glob)
        manifold = [f for f in sorted(glob.glob(os.path.join(amass_dir, "*/*.npz")))
                    if os.path.basename(os.path.dirname(f)) in subsets]
        if not labeled:
            raise FileNotFoundError(f"no labeled files under {data_dir} for subsets {subsets}")
        if not manifold:
            raise FileNotFoundError(f"no manifold files under {amass_dir} for subsets {subsets}")
        if flip_mode not in ("reference", "corrected"):
            raise ValueError(f"unknown flip_mode {flip_mode!r}")
        self.labeled, self.manifold = labeled, manifold
        self.batch_size = batch_size
        self.num_pts = num_pts
        self.flip = flip
        self.flip_mode = flip_mode
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        # bounded LRU over decoded files: AMASS-scale datasets would otherwise
        # grow host memory without limit
        self.max_cached_files = 32
        self._cache: "collections.OrderedDict[str, Dict[str, np.ndarray]]" = (
            collections.OrderedDict())
        self._cache_lock = threading.Lock()

        if backend not in ("auto", "numpy", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        from posendf_torch.data import native as _native

        self.native_threads = native_threads
        self._native = None
        self.backend = "numpy"
        if backend == "native" or (backend == "auto" and _native.available()):
            _native.build()     # raises if the build fails
            self._native = _native
            # a bounded pool of open maps (a file descriptor each), least recently used out
            self.max_native_handles = 256
            self._native_handles: "collections.OrderedDict[str, object]" = (
                collections.OrderedDict())
            self._native_lock = threading.Lock()
            self.backend = "native"

    def _native_open(self, path: str):
        # evicted handles are not closed here (another thread may be gathering
        # from one): they close when their last user drops them
        with self._native_lock:
            h = self._native_handles.get(path)
            if h is None:
                h = self._native.NativeNpz(path)
                self._native_handles[path] = h
                while len(self._native_handles) > self.max_native_handles:
                    self._native_handles.popitem(last=False)
            else:
                self._native_handles.move_to_end(path)
            return h

    def __len__(self) -> int:
        """Steps per epoch (file-level epochs like the reference loader)."""
        return max(1, len(self.labeled) // self.batch_size)

    def _load(self, path: str, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        with self._cache_lock:
            hit = self._cache.get(path)
            if hit is not None:
                self._cache.move_to_end(path)
                return hit
        with np.load(path) as z:
            data = {k: np.asarray(z[k]) for k in keys if k in z}
        with self._cache_lock:
            self._cache[path] = data
            self._cache.move_to_end(path)
            while len(self._cache) > self.max_cached_files:
                self._cache.popitem(last=False)
        return data

    def sample_batch(self, rng: Optional[np.random.Generator] = None,
                     lab_idx: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One flat training batch: pose (B*P, 21, 4), dist (B*P,), man_poses
        (B*P, 21, 4), float32. Consumes exactly one draw from ``rng``; every
        other draw comes from a child generator seeded by it, in the JAX
        package's order."""
        rng = rng or self._rng
        seed0 = int(rng.integers(0, 2 ** 62))
        inner = np.random.default_rng(seed0)
        lab_was_none = lab_idx is None
        if lab_was_none:
            lab_idx = inner.integers(0, len(self.labeled), self.batch_size)
        man_idx = inner.integers(0, len(self.manifold), self.batch_size)
        if self._native is not None:
            try:
                return self._sample_batch_native(inner, lab_idx, man_idx)
            except (OSError, RuntimeError) as e:
                warnings.warn(f"native loader failed ({type(e).__name__}: {e}); falling back "
                              "to the numpy backend for the rest of the run", stacklevel=2)
                with self._native_lock:
                    self._native_handles.clear()
                self._native = None
                self.backend = "numpy"
                # the child generator again from the same seed, its header draws
                # replayed: the numpy loop then sees a never-native run's stream
                inner = np.random.default_rng(seed0)
                if lab_was_none:
                    inner.integers(0, len(self.labeled), self.batch_size)
                inner.integers(0, len(self.manifold), self.batch_size)
        poses, dists, mans = [], [], []
        for li, mi in zip(lab_idx, man_idx):
            lab = self._load(self.labeled[li], ("pose", "dist"))
            rows = inner.integers(0, len(lab["pose"]), self.num_pts)
            p = lab["pose"][rows]
            d = lab["dist"][rows]
            if d.ndim > 1:
                d = d.mean(axis=1)  # mean of k nearest (load_data.py:53)
            if self.flip and self.flip_mode == "reference":
                # reference quirk (load_data.py:63): man_poses = the flipped noisy rows
                p = _flip_np(p)
                m = p
            else:
                man = self._load(self.manifold[mi], ("pose",))
                m = man["pose"][inner.integers(0, len(man["pose"]), self.num_pts)]
                if self.flip:
                    p = _flip_np(p)
                    m = _flip_np(m)
            poses.append(p)
            dists.append(d)
            mans.append(m)
        return {
            "pose": np.concatenate(poses).astype(np.float32),
            "dist": np.concatenate(dists).astype(np.float32),
            "man_poses": np.concatenate(mans).astype(np.float32),
        }

    def _sample_batch_native(self, rng, lab_idx, man_idx) -> Dict[str, np.ndarray]:
        """One batch in one native call, sized by ``len(lab_idx)`` (an
        epoch's last index slice is short when there are fewer labelled
        files than ``batch_size``); a seed a file from the child generator,
        the manifold rows from that seed ^ ``native.MAN_SEED_XOR``."""
        B, P = len(lab_idx), self.num_pts
        pose = np.empty((B * P, 21, 4), np.float32)
        dist = np.empty((B * P,), np.float32)
        man = np.empty((B * P, 21, 4), np.float32)
        ref_quirk = self.flip and self.flip_mode == "reference"
        seeds = [int(rng.integers(0, 2 ** 62)) for _ in range(B)]
        labs = [self._native_open(self.labeled[li]) for li in lab_idx]
        mans = None if ref_quirk else [self._native_open(self.manifold[mi])
                                       for mi in man_idx[:B]]
        self._native.assemble_batch(labs, mans, seeds, P, self.flip, ref_quirk,
                                    pose.reshape(B * P, -1), dist, man.reshape(B * P, -1),
                                    threads=self.native_threads)
        return {"pose": pose, "dist": dist, "man_poses": man}

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Deterministic per-epoch stream of ``len(self)`` batches, keyed on
        (seed, epoch) only; every labelled file once, the last partial batch
        dropped."""
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, epoch_idx]))
        perm = rng.permutation(len(self.labeled))
        for step in range(len(self)):
            lab_idx = perm[step * self.batch_size:(step + 1) * self.batch_size]
            yield self.sample_batch(rng, lab_idx=lab_idx)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: through pinned memory with
    ``non_blocking`` copies to a CUDA device, as views of the arrays on the CPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator, device, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Assemble and copy ``depth`` batches ahead on a background thread.

    The copies run on the device's default stream, which the train step also
    uses, so a batch is complete before any kernel reads it. An exception in
    the thread is raised to the consumer; a consumer that stops early stops
    the thread.
    """
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    failure: list = []
    cancel = threading.Event()

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if cancel.is_set() or not _put(to_device(batch, device)):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            failure.append(e)
        finally:
            _put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if failure:
                    raise failure[0]
                break
            yield item
    finally:
        cancel.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
