"""The port's native batch loader (``posendf_torch/data/native.py``) on the CPU.

The library is built here with the machine's ``g++`` from
``native/posendf_io.cc``, into a temporary build directory (the default,
``build/posendf_torch/``, stays untouched, so ``TrainingBatcher(backend=
"auto")`` elsewhere in the run keeps its numpy stream). The semantics of the
JAX package's ``tests/test_native_io.py`` carry over: opening and shapes,
``sample_labeled``'s rows, labels, determinism and flips, thread-count
invariance, compressed and truncated files, use after close, the out-buffer
checks, the whole-batch call against the per-file calls, a short last batch
and the fallback to numpy that keeps the stream.
Every native draw is also held to a numpy model of its row draws
(``native.draw_rows``, the splitmix64 hash) to the bit, and the port's
native batcher to the JAX package's native batcher, draw for draw.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch import _build  # noqa: E402
from posendf_torch.data import native  # noqa: E402
from posendf_torch.data.pipeline import TrainingBatcher  # noqa: E402
from posendf_torch.data.synthetic import write_synthetic_dataset  # noqa: E402

KEYS = ("pose", "dist", "man_poses")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The library built into a temporary directory; the module's state is
    restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("native_build"))
        mp.setattr(native, "_lib", None)
        assert not native.available()
        native.build()
        assert native.available() and native.library_path().exists()
        yield native.library_path()


@pytest.fixture(scope="module")
def npz_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("native") / "seq.npz"
    pose = rng.normal(size=(500, 21, 4)).astype(np.float32)
    pose /= np.linalg.norm(pose, axis=-1, keepdims=True)
    dist = np.abs(rng.normal(size=(500, 5))).astype(np.float32)
    np.savez(path, pose=pose, dist=dist)
    return str(path), pose, dist


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("synth")))


def _flip(q):
    return np.where(q[..., :1] < 0, -q, q)


def test_builds_from_the_repository_source_into_the_port_build_dir(built):
    assert native.SOURCE.name == "posendf_io.cc" and native.SOURCE.parent.name == "native"
    assert built.name.startswith("posendf_io_") and built.suffix == ".so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", _build.BUILD_DIR)
        assert native.library_path().parent == _build.BUILD_DIR   # build/posendf_torch/


def test_open_and_shapes(built, npz_file):
    path, _, _ = npz_file
    h = native.NativeNpz(path)
    assert (h.rows("pose"), h.row_elems("pose"), h.rows("dist"), h.row_elems("dist")) == \
        (500, 84, 500, 5)
    assert h.rows("missing") == -1
    h.close()


@pytest.mark.parametrize("flip", [False, True])
def test_sample_labeled_is_the_numpy_model_of_its_draws(built, npz_file, flip):
    """The rows of ``draw_rows(seed, n, rows)``, flipped to w >= 0 on
    request, and the mean of their k labels, to the bit."""
    path, pose, dist = npz_file
    h = native.NativeNpz(path)
    p, d = h.sample_labeled(200, seed=42, flip=flip)
    rows = native.draw_rows(42, 200, 500)
    want = _flip(pose[rows]) if flip else pose[rows]
    np.testing.assert_array_equal(p, want)
    np.testing.assert_array_equal(d, dist[rows].mean(axis=1))
    if flip:
        assert (p[..., 0] >= 0).all()
    r = h.sample_rows("pose", 64, seed=9, flip=flip)
    rows = native.draw_rows(9, 64, 500)
    np.testing.assert_array_equal(r, (_flip(pose[rows]) if flip else pose[rows]).reshape(64, 84))
    h.close()


def test_sample_labeled_deterministic(built, npz_file):
    h = native.NativeNpz(npz_file[0])
    p1, d1 = h.sample_labeled(64, seed=7)
    p2, d2 = h.sample_labeled(64, seed=7)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(p1, h.sample_labeled(64, seed=8)[0])
    h.close()


def test_sampling_thread_count_invariant(built, npz_file):
    h = native.NativeNpz(npz_file[0])
    n = 8192   # above the gather's threshold, so the threads split the work
    p1, d1 = h.sample_labeled(n, seed=123, threads=1)
    p4, d4 = h.sample_labeled(n, seed=123, threads=4)
    np.testing.assert_array_equal(p1, p4)
    np.testing.assert_array_equal(d1, d4)
    np.testing.assert_array_equal(h.sample_rows("pose", n, seed=9, threads=1),
                                  h.sample_rows("pose", n, seed=9, threads=3))
    h.close()


def test_compressed_truncated_and_mismatched_files_fail_cleanly(built, tmp_path, npz_file):
    rng = np.random.default_rng(1)
    np.savez_compressed(tmp_path / "c.npz", pose=rng.normal(size=(10, 21, 4)).astype(np.float32))
    with pytest.raises(OSError):
        native.NativeNpz(str(tmp_path / "c.npz"))
    raw = open(npz_file[0], "rb").read()
    (tmp_path / "t.npz").write_bytes(raw[: len(raw) // 3])
    try:
        h = native.NativeNpz(str(tmp_path / "t.npz"))
    except OSError:
        pass
    else:   # opened: sampling must refuse or stay inside the mapping
        try:
            h.sample_labeled(8, seed=0)
        except RuntimeError:
            pass
        h.close()
    np.savez(tmp_path / "bad.npz", pose=rng.normal(size=(100, 21, 4)).astype(np.float32),
             dist=np.abs(rng.normal(size=(40, 5))).astype(np.float32))
    h = native.NativeNpz(str(tmp_path / "bad.npz"))
    with pytest.raises(RuntimeError, match="rc=4"):
        h.sample_labeled(16, seed=0)
    h.close()


def test_use_after_close_and_out_buffer_checks(built, npz_file):
    h = native.NativeNpz(npz_file[0])
    with pytest.raises(TypeError, match="float32"):
        h.sample_labeled(8, seed=0, poses_out=np.empty((8, 84), np.float64),
                         dist_out=np.empty((8,), np.float32))
    with pytest.raises(ValueError, match="shape"):
        h.sample_labeled(8, seed=0, poses_out=np.empty((4, 84), np.float32),
                         dist_out=np.empty((8,), np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        h.sample_labeled(8, seed=0, poses_out=np.empty((8, 168), np.float32)[:, ::2],
                         dist_out=np.empty((8,), np.float32))
    h.close()
    with pytest.raises(ValueError, match="closed"):
        h.rows("pose")
    with pytest.raises(ValueError, match="closed"):
        h.sample_labeled(8, seed=0)


@pytest.mark.parametrize("flip, quirk", [(False, False), (True, True), (True, False)])
def test_assemble_batch_is_the_per_file_calls(built, dataset, flip, quirk):
    """One whole-batch call equals 2 x B per-file calls (the manifold rows
    from seed ^ MAN_SEED_XOR), bit for bit, in every flip mode."""
    labeled, amass = dataset
    b = TrainingBatcher(labeled, amass, batch_size=3, num_pts=48, backend="numpy")
    labs = [native.NativeNpz(f) for f in b.labeled[:3]]
    mans = [native.NativeNpz(f) for f in b.manifold[:3]]
    seeds, P = [3, 2 ** 40 + 5, 77], 48
    pose, dist, man = (np.empty((3 * P, 84), np.float32), np.empty((3 * P,), np.float32),
                       np.empty((3 * P, 84), np.float32))
    native.assemble_batch(labs, None if quirk else mans, seeds, P, flip, quirk, pose, dist, man)
    for i, (lab, mh, s) in enumerate(zip(labs, mans, seeds)):
        p, d = lab.sample_labeled(P, s, flip=flip)
        np.testing.assert_array_equal(pose[i * P:(i + 1) * P], p.reshape(P, 84))
        np.testing.assert_array_equal(dist[i * P:(i + 1) * P], d)
        m = p.reshape(P, 84) if quirk else mh.sample_rows("pose", P, s ^ native.MAN_SEED_XOR,
                                                          flip=flip)
        np.testing.assert_array_equal(man[i * P:(i + 1) * P], m)


def test_assemble_batch_refusals(built, npz_file, tmp_path):
    lab = native.NativeNpz(npz_file[0])
    np.savez(tmp_path / "wide.npz",
             pose=np.random.default_rng(1).normal(size=(50, 24, 4)).astype(np.float32))
    wide = native.NativeNpz(str(tmp_path / "wide.npz"))
    P = 8
    bufs = (np.empty((P, 84), np.float32), np.empty((P,), np.float32),
            np.empty((P, 84), np.float32))
    with pytest.raises(RuntimeError, match="pndf_assemble_batch failed"):
        native.assemble_batch([lab], [wide], [3], P, False, False, *bufs)
    with pytest.raises(ValueError, match="manifold handles required"):
        native.assemble_batch([lab], None, [3], P, False, False, *bufs)
    native.assemble_batch([lab], None, [3], P, True, True, *bufs)
    np.testing.assert_array_equal(bufs[2], bufs[0])
    assert (bufs[0].reshape(P, 21, 4)[..., 0] >= 0).all()


@pytest.mark.parametrize("flip, flip_mode", [(False, "reference"), (True, "reference"),
                                             (True, "corrected")])
def test_native_stream_is_the_numpy_model_and_the_jax_batchers(built, dataset, monkeypatch,
                                                                flip, flip_mode):
    """The native batcher's batches are the files and rows a numpy model of
    its draws gives (the batcher's generator draws the files and one seed a
    file, ``draw_rows`` the rows), to the bit, and the JAX package's native
    batcher's (its binding pointed at this library), draw for draw."""
    from posendf_tpu.data import native as jax_native
    from posendf_tpu.data.pipeline import TrainingBatcher as JaxBatcher

    labeled, amass = dataset
    kw = dict(batch_size=2, num_pts=40, flip=flip, flip_mode=flip_mode, seed=5)
    mine = TrainingBatcher(labeled, amass, backend="native", **kw)
    assert mine.backend == "native"
    got = list(mine.epoch(1)) + [mine.sample_batch()]

    ref = TrainingBatcher(labeled, amass, backend="numpy", **kw)
    rng = np.random.default_rng(np.random.SeedSequence([5, 1]))
    perm = rng.permutation(len(ref.labeled))
    idx = [perm[s * 2:(s + 1) * 2] for s in range(len(ref))]
    for step, g in enumerate(got):
        r = rng if step < len(idx) else ref._rng
        inner = np.random.default_rng(int(r.integers(0, 2 ** 62)))
        lab_idx = idx[step] if step < len(idx) else inner.integers(0, len(ref.labeled), 2)
        man_idx = inner.integers(0, len(ref.manifold), 2)
        for b, (li, mi) in enumerate(zip(lab_idx, man_idx)):
            seed = int(inner.integers(0, 2 ** 62))
            with np.load(ref.labeled[li]) as z:
                pose, dist = z["pose"], z["dist"]
            rows = native.draw_rows(seed, 40, len(pose))
            p, d = pose[rows], dist[rows].mean(axis=1)
            if flip and flip_mode == "reference":
                p = m = _flip(p)
            else:
                with np.load(ref.manifold[mi]) as z:
                    m = z["pose"][native.draw_rows(seed ^ native.MAN_SEED_XOR, 40,
                                                   len(z["pose"]))]
                p, m = (_flip(p), _flip(m)) if flip else (p, m)
            sl = slice(b * 40, (b + 1) * 40)
            np.testing.assert_array_equal(g["pose"][sl], p)
            np.testing.assert_array_equal(g["dist"][sl], d)
            np.testing.assert_array_equal(g["man_poses"][sl], m)

    monkeypatch.setattr(jax_native, "_LIB_PATH", str(built))
    monkeypatch.setattr(jax_native, "_lib", None)
    theirs = JaxBatcher(labeled, amass, backend="native", **kw)
    assert theirs.backend == "native"
    want = list(theirs.epoch(1)) + [theirs.sample_batch()]
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_short_last_batch_and_fallback(built, dataset):
    """Fewer labelled files than batch_size: the short batch of the files
    there are. A native failure falls back to numpy without changing the
    stream."""
    labeled, amass = dataset
    n_files = len(TrainingBatcher(labeled, amass, batch_size=1, num_pts=4,
                                  backend="numpy").labeled)
    b = TrainingBatcher(labeled, amass, batch_size=n_files + 2, num_pts=16, backend="native")
    batches = list(b.epoch(0))
    assert batches and all(x["pose"].shape[0] == n_files * 16 for x in batches)
    for x in batches:
        np.testing.assert_allclose(np.linalg.norm(x["pose"], axis=-1), 1.0, atol=1e-4)

    ref = TrainingBatcher(labeled, amass, batch_size=2, num_pts=32, backend="numpy", seed=7)
    want = [ref.sample_batch() for _ in range(3)]
    b = TrainingBatcher(labeled, amass, batch_size=2, num_pts=32, backend="native", seed=7)

    def boom(*a, **k):
        raise OSError("injected native failure")

    b._sample_batch_native = boom
    with pytest.warns(UserWarning, match="native loader failed"):
        got = [b.sample_batch()]
    assert b.backend == "numpy"
    got += [b.sample_batch() for _ in range(2)]
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k])


def test_backend_names(built, dataset, monkeypatch, tmp_path):
    """``auto`` is native once the library is built and numpy before;
    ``native`` builds, and raises when the build fails."""
    labeled, amass = dataset
    assert TrainingBatcher(labeled, amass, backend="auto").backend == "native"
    assert TrainingBatcher(labeled, amass, backend="numpy").backend == "numpy"
    with pytest.raises(ValueError, match="backend"):
        TrainingBatcher(labeled, amass, backend="mmap")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    assert TrainingBatcher(labeled, amass, backend="auto").backend == "numpy"
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TrainingBatcher(labeled, amass, backend="native")
    assert not os.path.exists(tmp_path / "empty") or not any((tmp_path / "empty").iterdir())
