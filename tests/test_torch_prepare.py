"""``posendf_torch/data/prepare.py`` and ``cli prepare-data`` against
``posendf_tpu/data/prepare.py`` on the CPU (JAX on the CPU).

The host code is numpy in both, so the sampled files and the noisy queries
are the same bytes. Labels: the same neighbours (``nn_pose`` equal), and
distances within 1e-6 (fp32 sums over 21 joints in another order).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from posendf_tpu.cli import main as jax_main  # noqa: E402
from posendf_tpu.data import prepare as jprep  # noqa: E402
from posendf_tpu.data.synthetic import synthetic_manifold_poses  # noqa: E402

from posendf_torch import cli  # noqa: E402
from posendf_torch.data import prepare  # noqa: E402
from posendf_torch.ops import fused_knn  # noqa: E402

SUBSETS = ["ACCAD", "CMU"]


@pytest.fixture(scope="module")
def raw_amass(tmp_path_factory):
    """A raw-AMASS-shaped directory: <subset>/<seq>/clip.npz with 'poses'
    (T, 156) axis-angle, and a shape file that must be skipped."""
    root = tmp_path_factory.mktemp("raw_amass")
    rng = np.random.default_rng(0)
    for subset in SUBSETS:
        for seq in ("s1", "s2"):
            d = root / subset / seq
            d.mkdir(parents=True)
            poses = rng.normal(scale=0.3, size=(120, 156)).astype(np.float32)
            np.savez(d / "clip_poses.npz", poses=poses,
                     betas=rng.normal(size=16).astype(np.float32))
            np.savez(d / "shape.npz", poses=np.zeros((5, 156), np.float32))
    return str(root)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            if key == "dist":
                np.testing.assert_allclose(za[key], zb[key], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def _assert_same_dirs(a, b):
    assert _files(a) == _files(b) and _files(a)
    for rel in _files(a):
        _assert_same_npz(os.path.join(a, rel), os.path.join(b, rel))


def test_to_quats_and_doublecover_are_the_same_bytes():
    rng = np.random.default_rng(1)
    aa = rng.normal(scale=0.5, size=(17, 63)).astype(np.float32)
    aa[3, :3] = 0.0          # a zero rotation takes the small-angle branch
    np.testing.assert_array_equal(prepare._to_quats(aa), jprep._to_quats(aa))
    q = synthetic_manifold_poses(rng, 8)
    np.testing.assert_array_equal(prepare.quat_doublecover(q, 30, np.random.default_rng(2)),
                                  jprep.quat_doublecover(q, 30, np.random.default_rng(2)))
    assert prepare.SMPL_LIMB_CHAINS == jprep.SMPL_LIMB_CHAINS


@pytest.mark.parametrize("case", ["default", "per_pose_noise", "runs", "structured"])
def test_noisy_queries_are_the_same_bytes(case):
    clean = synthetic_manifold_poses(np.random.default_rng(3), 64)
    kw = {"default": {}, "per_pose_noise": dict(per_pose_noise=True),
          "runs": dict(runs=4), "structured": dict(per_pose_noise=True)}[case]
    frac = 0.5 if case == "structured" else 0.0
    got = prepare.sample_noisy_queries(clean, 200, prepare.NoiseSpec(structured_frac=frac),
                                       np.random.default_rng(4), **kw)
    want = jprep.sample_noisy_queries(clean, 200, jprep.NoiseSpec(structured_frac=frac),
                                      np.random.default_rng(4), **kw)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_noisy_queries_raise_as_in_jax():
    clean = synthetic_manifold_poses(np.random.default_rng(5), 16)
    for fn in (prepare.sample_noisy_queries, jprep.sample_noisy_queries):
        with pytest.raises(ValueError, match="divide"):
            fn(clean, 1005, rng=np.random.default_rng(0), runs=10)
        with pytest.raises(ValueError, match="zero"):
            fn(clean, 10, rng=np.random.default_rng(0), runs=10)


LABEL_CASES = {
    "highest": {},
    "weighted": dict(weighted=True),
    "euc": dict(metric="euc"),
    "euc_weighted": dict(metric="euc", weighted=True),
    "two_stage": dict(k_candidates=60),
    "fast_unfused": dict(precision="fast", fused=False),
    "structured_runs": dict(spec=dict(structured_frac=0.5), runs=2, per_pose_noise=True),
}


@pytest.mark.parametrize("case", list(LABEL_CASES))
def test_label_sequence_matches_jax(case):
    rng = np.random.default_rng(6)
    corpus = synthetic_manifold_poses(rng, 300)
    clean = synthetic_manifold_poses(rng, 40)
    kw = dict(LABEL_CASES[case])
    spec = kw.pop("spec", {})
    want = jprep.label_sequence(clean, jnp.asarray(corpus), num_queries=40, k=5,
                                query_batch=16, rng=np.random.default_rng(7),
                                spec=jprep.NoiseSpec(**spec), **kw)
    got = prepare.label_sequence(clean, corpus, num_queries=40, k=5, query_batch=16,
                                 rng=np.random.default_rng(7), spec=prepare.NoiseSpec(**spec),
                                 device="cpu", **kw)
    assert got["pose"].tobytes() == want["pose"].tobytes()
    np.testing.assert_array_equal(got["nn_pose"], want["nn_pose"])
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=1e-6)
    assert got["dist"].dtype == np.float32 and got["dist"].shape == (40, 5)


@pytest.mark.parametrize("precision", ["highest", "default", "fast"])
def test_label_sequence_kernel_path_on_cpu(precision):
    """fused=True on a CPU tensor runs the kernel's plain version: exact
    'highest' and 'fast' give JAX's exact labels; 'default' (bf16 operands)
    stays within the bf16 bar of the test of the bf16 engine."""
    rng = np.random.default_rng(8)
    corpus = synthetic_manifold_poses(rng, 300)
    clean = synthetic_manifold_poses(rng, 40)
    want = jprep.label_sequence(clean, jnp.asarray(corpus), num_queries=40, k=4,
                                query_batch=16, rng=np.random.default_rng(9), fused=False)
    before = dict(fused_knn.LAUNCHES)
    got = prepare.label_sequence(clean, torch.from_numpy(corpus), num_queries=40, k=4,
                                 query_batch=16, rng=np.random.default_rng(9), fused=True,
                                 precision=precision)
    assert fused_knn.LAUNCHES == before
    if precision == "default":
        np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=2.0 ** -8 + 1e-5)
    else:
        np.testing.assert_array_equal(got["nn_pose"], want["nn_pose"])
        np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="fused=True"):
        prepare.label_sequence(clean, corpus, num_queries=8, metric="euc", fused=True,
                               rng=np.random.default_rng(0), device="cpu")


@pytest.mark.parametrize("corpus_kind", ["pose", "uniform_s3"])
def test_probe_fast_safety_matches_jax(corpus_kind):
    """A pose corpus is safe for the bound engine, uniform S^3 is not; the
    statistics are JAX's."""
    rng = np.random.default_rng(10)
    if corpus_kind == "pose":
        corpus = synthetic_manifold_poses(rng, 2048)
    else:
        q = rng.normal(size=(2048, 21, 4)).astype(np.float32)
        corpus = q / np.linalg.norm(q, axis=-1, keepdims=True)
    want = jprep.probe_fast_safety(corpus, np.random.default_rng(11), n_queries=128)
    got = prepare.probe_fast_safety(corpus, np.random.default_rng(11), n_queries=128,
                                    device="cpu")
    assert got["safe"] == want["safe"] == (corpus_kind == "pose")
    for key in ("w_margin_frac", "topk_overlap", "n_queries", "corpus_probe_rows", "k"):
        assert got[key] == want[key], key
    # a mean of label differences, each within 1e-6 (fp32 sums in another
    # order); relative to a label scale above 0.01
    np.testing.assert_allclose(got["label_mae"], want["label_mae"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["label_mae_rel"], want["label_mae_rel"], rtol=0, atol=1e-4)
    w = prepare._joint_weights_np()
    got_w = prepare.probe_fast_safety(corpus, np.random.default_rng(12), n_queries=64,
                                      corpus_cap=1024, weights=w, device="cpu")
    want_w = jprep.probe_fast_safety(corpus, np.random.default_rng(12), n_queries=64,
                                     corpus_cap=1024, weights=w)
    assert got_w["topk_overlap"] == want_w["topk_overlap"]
    np.testing.assert_allclose(got_w["label_mae"], want_w["label_mae"], rtol=0, atol=1e-6)


def test_resolve_knn_precision_on_cuda_and_cpu(monkeypatch, capsys):
    """'auto' takes the bound engine only on a device type where it is the
    faster of the two ways to exact labels (``FAST_ENGINE_BACKENDS``): none,
    so 'auto' is exact 'highest' on the card and the CPU. On a device type
    of the set it follows JAX's rule on the TPU: the probe decides, and
    searches the engine does not apply to stay exact."""
    corpus = synthetic_manifold_poses(np.random.default_rng(13), 1024)
    ineligible = ({"backend": "cpu"}, {"backend": "cuda", "k_candidates": 50},
                  {"backend": "cuda", "k": 9}, {"backend": "cuda", "space": "joints"},
                  {"backend": "cuda", "fused": False}, {"backend": "cuda", "metric": "euc"})
    assert prepare.FAST_ENGINE_BACKENDS == frozenset()
    for kwargs in ({"backend": "cuda"},) + ineligible:
        assert prepare.resolve_knn_precision("auto", corpus, device="cpu", verbose=False,
                                             **{"k": 5, **kwargs}) == ("highest", None), kwargs
    prepare.resolve_knn_precision("auto", corpus, k=5, backend="cuda", device="cpu")
    assert "slower than the exact one on cuda" in capsys.readouterr().out
    monkeypatch.setattr(prepare, "FAST_ENGINE_BACKENDS", frozenset({"cuda"}))
    prec, stats = prepare.resolve_knn_precision("auto", corpus, k=5, backend="cuda",
                                                device="cpu", rng=np.random.default_rng(14),
                                                verbose=False)
    j_prec, j_stats = jprep.resolve_knn_precision("auto", corpus, k=5, backend="tpu",
                                                  rng=np.random.default_rng(14), verbose=False)
    assert prec == j_prec == "fast"
    assert stats["topk_overlap"] == j_stats["topk_overlap"] and stats["safe"]
    for kwargs in ineligible:
        assert prepare.resolve_knn_precision("auto", corpus, device="cpu", verbose=False,
                                             **{"k": 5, **kwargs}) == ("highest", None), kwargs
    prepare.resolve_knn_precision("auto", corpus, k=5, backend="cpu", device="cpu")
    assert "slower than the exact one on cpu" in capsys.readouterr().out
    for p in ("highest", "high", "default", "fast"):
        assert prepare.resolve_knn_precision(p, corpus, k=5) == (p, None)


def test_sample_and_label_split_write_jax_files(raw_amass, tmp_path):
    """Stage 1 and stage 3 (weighted, 2 runs, restart guard, a shard) write
    the files JAX writes."""
    out = {}
    for name, mod in (("jax", jprep), ("torch", prepare)):
        root = tmp_path / name
        sampled = mod.sample_amass(raw_amass, str(root / "sampled"), SUBSETS, seed=0)
        assert len(sampled) == 4
        kw = {} if name == "jax" else dict(device="cpu")
        labeled = mod.label_split(str(root / "sampled"), str(root / "labeled"), SUBSETS,
                                  num_queries=10, runs=2, k=5, weighted=True, **kw)
        again = mod.label_split(str(root / "sampled"), str(root / "labeled"), SUBSETS,
                                num_queries=10, runs=2, k=5, **kw)
        assert sorted(labeled) == sorted(again) and len(labeled) == 4
        shard = mod.label_split(str(root / "sampled"), str(root / "shard"), SUBSETS,
                                num_queries=10, runs=2, k=3, shard=(1, 2), **kw)
        assert len(shard) == 2
        out[name] = root
    _assert_same_dirs(str(out["jax"]), str(out["torch"]))


def test_cli_prepare_data_writes_jax_files(raw_amass, tmp_path, capsys):
    args = ["prepare-data", "--amass-raw", raw_amass, "--num-samples", "10", "--runs", "2",
            "--k", "3", "--split", "ACCAD", "--structured-frac", "0.2"]
    jax_main(args + ["--out-dir", str(tmp_path / "jax")])
    cli.main(args + ["--out-dir", str(tmp_path / "torch"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "stage 1: sampled 2" in out and "stage 3: labeled 2" in out
    _assert_same_dirs(str(tmp_path / "jax"), str(tmp_path / "torch"))
    # stage label alone, on the sampled directory just written
    cli.main(["prepare-data", "--amass-raw", raw_amass, "--out-dir", str(tmp_path / "torch"),
              "--stage", "label", "--split", "ACCAD", "--device", "cpu", "--fused-knn", "on",
              "--knn-precision", "highest", "--num-samples", "10", "--runs", "2", "--k", "3"])
    assert "stage 3: labeled 2" in capsys.readouterr().out


def test_what_is_not_ported_raises(raw_amass, tmp_path):
    """``mesh=`` is ported (its sharded runs: ``tests/test_torch_parallel.py``):
    a one-process mesh labels as no mesh does, to the bit. ``space="joints"``
    needs a body model (the CLI a real SMPL file, as JAX's does)."""
    from posendf_torch.parallel import make_mesh

    corpus = synthetic_manifold_poses(np.random.default_rng(15), 64)
    mesh = make_mesh(device="cpu")
    got, want = (prepare.label_sequence(corpus[:8], corpus, num_queries=10, device="cpu",
                                        rng=np.random.default_rng(3), mesh=m)
                 for m in (mesh, None))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sampled = tmp_path / "sampled" / SUBSETS[0]
    sampled.mkdir(parents=True)
    np.savez(sampled / "seq.npz", pose=corpus[:16])
    paths = prepare.label_split(str(tmp_path / "sampled"), str(tmp_path / "x"), SUBSETS,
                                device="cpu", num_queries=4, runs=1, mesh=mesh)
    assert len(paths) == 1 and os.path.exists(paths[0])
    with pytest.raises(ValueError, match="requires a body_model"):
        prepare.label_sequence(corpus[:8], corpus, num_queries=10, device="cpu",
                               space="joints")
    with pytest.raises(ValueError, match="requires a body_model"):
        prepare.label_split(raw_amass, str(tmp_path / "x"), SUBSETS, device="cpu",
                            space="joints")
    with pytest.raises(SystemExit, match="requires --bm-path"):
        cli.main(["prepare-data", "--amass-raw", raw_amass, "--out-dir", str(tmp_path / "y"),
                  "--stage", "label", "--space", "joints", "--device", "cpu"])
