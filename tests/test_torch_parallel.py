"""The port's multi-device paths on a gloo group of 4 CPU ranks.

One module-scoped fixture spawns the group once (``init_method="file://..."``,
the spawn start method) and runs every sharded check in it: the 1-frame halo
(``parallel/halo.py``), two fused and two autodiff steps of the data-parallel
``Trainer``, a batch that does not divide over the ranks, sharded labelling
(``label_sequence`` / ``label_split``), a frame-sharded denoise, a
batch-sharded projection and int8 forward, ``cli train`` in the group, and
which rank wrote files. Each rank saves what it computed; each test below reads
its part and holds it to the one-process result, computed here, and to the
JAX package's sharded result on 4 virtual devices
(``tests/data/torch_port_parallel_expected.npz``, made by
``scripts/make_torch_port_parallel_golden.py``), so this file compiles no
JAX.

The bars:
  * the halo's rows and gradient are the unsharded ``x[:-1] - x[1:]`` and its
    autograd to the bit (the same subtractions, and two cotangents summed in
    either order); the temporal loss within 1e-6 (a sum over ranks of
    partial means);
  * a sharded step is a mean of four 16-row means where one process takes
    one 64-row mean: the losses agree within rtol 1e-5, and after two Adam
    steps (each moves a weight by about lr, Adam's normalized update) every
    weight is within 2 x 2 lr of the other run and 99% within lr / 20, the
    bars ``tests/test_torch_trainer.py`` holds the port's trainer to JAX's;
  * the labels are the one-process labels to the bit (the kNN kernel's
    plain version answers each query alone), and JAX's within 1e-6;
  * the 1 x 4-step denoise is the unsharded one within 1e-5 and JAX's within
    1e-4 (the bar of the JAX package's own ``tests/test_parallel.py``), its
    last prior term within 1e-5;
  * the sharded projection is the one-process one within 1e-5 (poses) and
    1e-6 (history), the sharded int8 forward within 1e-6: the bars of
    ``__graft_entry__.py``'s dry runs of the JAX package's sharded paths.
"""

import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_parallel_expected.npz")
WORLD = 4
DIMS = [32, 48]
LR = 1e-3
TERMS = ("total", "dist", "man_loss", "eikonal")
GROUP_DEADLINE_S = 420


def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _params(g, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(v) for k, v in g.items()
            if k.startswith(prefix + "/")}


def _batch(g, prefix):
    return {k: g[f"{prefix}_{k}"] for k in ("pose", "dist", "man_poses")}


def _config(root, fused):
    from posendf_torch.config import PoseNDFConfig

    cfg = PoseNDFConfig()
    cfg.experiment.root_dir = str(root)
    cfg.dfnet.dims = list(DIMS)
    cfg.dfnet.live_head = True
    cfg.train.optimizer_param = LR
    cfg.train.continue_train = False
    cfg.train.fused_grads = fused
    return cfg


def _denoiser(g):
    from posendf_torch.experiments.denoise import MotionDenoiser
    from posendf_torch.models import PoseNDF
    from posendf_torch.smpl import BodyModel
    from posendf_torch.smpl.lbs import synthetic_model

    module = PoseNDF(dfnet_dims=(32,), activation="softplus")
    module.load_state_dict(_params(g, "den_params"))
    return MotionDenoiser(module, BodyModel(model=synthetic_model(num_vertices=64, seed=2),
                                            device="cpu"))


def _train(g, root, fused, mesh=None, batches=None):
    """Two Trainer steps from the golden's initial weights: (metrics (2, 4),
    the weights after them)."""
    from posendf_torch.training.trainer import Trainer

    trainer = Trainer(_config(root, fused), device="cpu", mesh=mesh)
    trainer.load_params(_params(g, "train_init"))
    batches = batches or [_batch(g, "train_batch0"), _batch(g, "train_batch1")]
    ms = [trainer.train_step(b) for b in batches]
    return (np.asarray([[float(m[k]) for k in TERMS] for m in ms]),
            {k: v.detach().clone() for k, v in trainer.module.state_dict().items()},
            trainer)


def _record_writes(log):
    """Count this rank's file writes: checkpoints, the config copy, the
    metrics log and ``np.savez`` (``label_split``'s files)."""
    from posendf_torch.training import checkpoints, trainer

    save, cfg_save, logger, savez = (checkpoints.CheckpointStore.save, trainer.save_config,
                                     trainer.MetricsLogger, np.savez)

    def store_save(self, *a, **k):
        log.append("checkpoint")
        return save(self, *a, **k)

    def config_save(*a, **k):
        log.append("config")
        return cfg_save(*a, **k)

    def metrics_log(*a, **k):
        log.append("metrics")
        return logger(*a, **k)

    def np_savez(*a, **k):
        log.append("labels")
        return savez(*a, **k)

    checkpoints.CheckpointStore.save = store_save
    trainer.save_config = config_save
    trainer.MetricsLogger = metrics_log
    np.savez = np_savez


def _unit(seed, n):
    """``n`` unit-quaternion poses of numpy stream ``seed``."""
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


def _projection_module():
    """The projection dry run's field: one 32-wide softplus layer."""
    from posendf_torch.models import PoseNDF

    return PoseNDF(dfnet_dims=(32,), activation="softplus")


def _int8_field_and_poses():
    """The int8 dry run's quantized field (the default architecture with a
    live head, calibrated on 256 poses) and the poses it serves."""
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.field import Field

    cfg = PoseNDFConfig()
    cfg.dfnet.live_head = True
    calib_and_poses = _unit(5, 256 + 8 * WORLD)
    return Field(cfg.make_model()).quantize_int8(calib_and_poses[:256]), calib_and_poses[256:]


def _rank_checks(rank, out_dir, init_file):
    from posendf_torch.data.prepare import label_sequence, label_split
    from posendf_torch.field import Field
    from posendf_torch.projection import project
    from posendf_torch.parallel import (adjacent_difference_sharded, gather_rows,
                                        init_distributed, make_mesh, shard_batch,
                                        temporal_loss_sharded)

    torch.set_num_threads(1)
    init_distributed(init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                     device="cpu", timeout_s=180)
    mesh = make_mesh(("data",), device="cpu")
    g = _golden()
    res, writes = {"rank": rank, "size": mesh.size}, []
    _record_writes(writes)

    # the halo: rows, the gradient of a weighted sum, the temporal loss
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(32, 12, 3, generator=gen)
    w = torch.randn(31, 12, 3, generator=gen)
    xl = shard_batch(mesh, x, even=True).clone().requires_grad_(True)
    d = adjacent_difference_sharded(xl, mesh)
    rows = shard_batch(mesh, torch.arange(32))[:d.shape[0]]
    (d * w[rows]).sum().backward()
    res["halo_rows"] = gather_rows(mesh, d).numpy()
    res["halo_grad"] = gather_rows(mesh, xl.grad).numpy()
    v = torch.randn(16, 40, 3, generator=gen)
    vl = shard_batch(mesh, v, even=True).clone().requires_grad_(True)
    loss = temporal_loss_sharded(vl, mesh)
    loss.backward()
    res["temporal_loss"] = float(loss)
    res["temporal_grad"] = gather_rows(mesh, vl.grad).numpy()

    # data-parallel training, fused and autodiff; a batch that does not divide
    for fused in (True, False):
        name = "fused" if fused else "auto"
        metrics, params, trainer = _train(g, os.path.join(out_dir, "runs"), fused, mesh)
        res[f"{name}_metrics"], res[f"{name}_params"] = metrics, params
        if fused:
            try:
                trainer.train_step(_batch(g, "ragged"))
            except ValueError as e:
                res["fused_ragged_error"] = str(e)
            trainer.save()
    metrics, params, _ = _train(g, os.path.join(out_dir, "ragged"), False, mesh,
                                [_batch(g, "ragged")])
    res["ragged_metrics"], res["ragged_params"] = metrics, params

    # sharded labelling: the kernel's plain version here, a tail batch that
    # does not divide (100 queries in batches of 32)
    lab = label_sequence(g["label_clean"], g["label_corpus"], num_queries=100, k=5,
                         rng=np.random.default_rng(1), mesh=mesh, fused=True, query_batch=32)
    res["label_dist"], res["label_pose"], res["label_nn"] = lab["dist"], lab["pose"], \
        lab["nn_pose"]
    res["label_split"] = label_split(os.path.join(out_dir, "sampled"),
                                     os.path.join(out_dir, "labeled"), ["ACCAD"],
                                     num_queries=6, runs=1, k=3, fused=True, mesh=mesh)

    # the frame-sharded denoise
    pose, m = _denoiser(g).optimize(g["den_noisy"], iterations=1, steps_per_iter=4, mesh=mesh)
    res["den_pose"], res["den_metrics"] = pose.numpy(), m

    # the serving paths, batch-sharded (__graft_entry__.py's two dry runs)
    out, hist = project(Field(_projection_module()), shard_batch(mesh, _unit(4, 8 * WORLD),
                                                                   even=True), steps=5)
    res["proj_out"] = gather_rows(mesh, out).numpy()
    res["proj_hist"] = gather_rows(mesh, hist.t().contiguous()).t().numpy()
    qfield, poses = _int8_field_and_poses()
    res["int8_d"] = gather_rows(mesh, qfield.distance(shard_batch(mesh, poses, even=True))).numpy()

    # cli train in the group, as under torchrun
    import contextlib
    import io

    from posendf_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", "--config", os.path.join(out_dir, "run.json"), "--device", "cpu",
                  "--fused-grads", "--max-epoch", "1"])
    res["cli_out"] = out.getvalue()
    res["writes"] = list(writes)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _rank_main(rank, out_dir, init_file):
    try:
        _rank_checks(rank, out_dir, init_file)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the sharded checks, in rank order."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("ranks")
    init_file = out / "group_init"
    sampled = out / "sampled" / "ACCAD"      # two sequences for label_split
    sampled.mkdir(parents=True)
    corpus = _golden()["label_corpus"]
    for i in range(2):
        np.savez(sampled / f"seq{i}.npz", pose=corpus[i * 8:(i + 1) * 8])
    from posendf_torch.config import save_config
    from posendf_torch.data.synthetic import write_synthetic_dataset

    cfg = _config(out / "cli_runs", True)   # cli train's run: 4 x 16 rows a step
    cfg.data.data_dir, cfg.data.amass_dir = write_synthetic_dataset(str(out / "synth"))
    cfg.train.batch_size, cfg.train.num_pts = 2, 32
    save_config(cfg, str(out / "run.json"))
    ctx = mp.start_processes(_rank_main, args=(str(out), str(init_file)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + GROUP_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank group did not finish in "
                                   f"{GROUP_DEADLINE_S} s")
    except Exception as e:
        errs = [p.read_text() for p in sorted(out.glob("rank*.err"))]
        raise RuntimeError(f"sharded checks failed: {e}\n" + "\n".join(errs)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def golden():
    return _golden()


def _hold_weights(got, want, steps=2):
    """Every weight within 2 x steps x lr, 99% within lr / 20 (the module
    docstring's bar)."""
    for k, v in want.items():
        err = (got[k] - v).abs()
        assert float(err.max()) <= 2 * steps * LR, (k, float(err.max()))
        assert float((err <= LR / 20).float().mean()) >= 0.99, k


# ------------------------------------------------------------- the halo

def test_halo_rows_and_gradient_are_the_unsharded_ones(ranks):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(32, 12, 3, generator=gen).requires_grad_(True)
    w = torch.randn(31, 12, 3, generator=gen)
    d = x[:-1] - x[1:]
    (d * w).sum().backward()
    for r in ranks:
        assert r["size"] == WORLD
        np.testing.assert_array_equal(r["halo_rows"], d.detach().numpy())
        np.testing.assert_array_equal(r["halo_grad"], x.grad.numpy())


def test_halo_temporal_loss_and_gradient_match_unsharded(ranks):
    gen = torch.Generator().manual_seed(0)
    torch.randn(32, 12, 3, generator=gen), torch.randn(31, 12, 3, generator=gen)
    v = torch.randn(16, 40, 3, generator=gen).requires_grad_(True)
    loss = torch.sqrt(torch.sum((v[:-1] - v[1:]) ** 2, dim=-1) + 1e-12).mean()
    loss.backward()
    loss = float(loss.detach())
    for r in ranks:
        assert abs(r["temporal_loss"] - loss) <= 1e-6
        np.testing.assert_allclose(r["temporal_grad"], v.grad.numpy(), rtol=0, atol=1e-8)


# -------------------------------------------------------------- training

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "autodiff"])
def test_sharded_steps_match_one_process_and_jax(ranks, golden, tmp_path, fused):
    name = "fused" if fused else "auto"
    want_m, want_p, _ = _train(golden, tmp_path, fused)
    for r in ranks:
        # the ranks hold the same weights, to the bit
        for k, v in ranks[0][f"{name}_params"].items():
            assert torch.equal(r[f"{name}_params"][k], v), k
    got_m, got_p = ranks[0][f"{name}_metrics"], ranks[0][f"{name}_params"]
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5)
    _hold_weights(got_p, want_p)
    np.testing.assert_allclose(got_m, golden[f"{name}_metrics"], rtol=1e-5)
    _hold_weights(got_p, _params(golden, f"{name}_params"))


def test_uneven_shards_autodiff_is_the_global_mean_and_fused_raises(ranks, golden, tmp_path):
    """66 rows over 4 ranks (17, 17, 16, 16): the autodiff step weights each
    rank's terms by its rows and gives the one-process step on the whole
    batch; the fused step (JAX's pmean, a mean of equal shards) refuses."""
    want_m, want_p, _ = _train(golden, tmp_path, False, batches=[_batch(golden, "ragged")])
    for r in ranks:
        np.testing.assert_allclose(r["ragged_metrics"], want_m, rtol=1e-5)
        _hold_weights(r["ragged_params"], want_p, steps=1)
        assert "do not divide over 4 ranks" in r["fused_ragged_error"]


# ------------------------------------------------------------- labelling

def test_sharded_labelling_is_the_one_process_labelling_to_the_bit(ranks, golden):
    from posendf_torch.data.prepare import label_sequence

    want = label_sequence(golden["label_clean"], golden["label_corpus"], num_queries=100, k=5,
                          rng=np.random.default_rng(1), fused=True, query_batch=32,
                          device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r["label_pose"], want["pose"])
        np.testing.assert_array_equal(r["label_dist"], want["dist"])
        np.testing.assert_array_equal(r["label_nn"], want["nn_pose"])
    np.testing.assert_array_equal(ranks[0]["label_pose"], golden["label_pose"])
    np.testing.assert_allclose(ranks[0]["label_dist"], golden["label_dist"], rtol=0, atol=1e-6)


def test_sharded_projection_matches_one_process(ranks):
    """A batch-sharded 5-step projection gathered back: the one-process
    projection within 1e-5, its history within 1e-6
    (``__graft_entry__.py::_dryrun_sharded_projection``'s bars)."""
    from posendf_torch.field import Field
    from posendf_torch.projection import project

    out, hist = project(Field(_projection_module()), _unit(4, 8 * WORLD), steps=5)
    assert float(hist[0].mean()) > 0
    for r in ranks:
        np.testing.assert_allclose(r["proj_out"], out.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["proj_hist"], hist.numpy(), rtol=0, atol=1e-6)


def test_sharded_int8_forward_matches_one_process(ranks):
    """The int8 forward on each rank's shard, gathered back: the one-process
    forward within 1e-6 (``__graft_entry__.py::_dryrun_sharded_int8_forward``)."""
    qfield, poses = _int8_field_and_poses()
    want = qfield.distance(poses).numpy()
    assert float(np.abs(want).max()) > 0
    for r in ranks:
        np.testing.assert_allclose(r["int8_d"], want, rtol=0, atol=1e-6)


def test_only_rank0_writes(ranks, tmp_path):
    """The config copy, the metrics logs, the checkpoint and the labelled
    files come from rank 0 alone; every rank returns the same paths."""
    assert sorted(set(ranks[0]["writes"])) == ["checkpoint", "config", "labels", "metrics"]
    assert ranks[0]["writes"].count("labels") == 2
    for r in ranks[1:]:
        assert r["writes"] == []
        assert r["label_split"] == ranks[0]["label_split"]
    with np.load(ranks[0]["label_split"][0]) as z:
        n = len(z["pose"])      # 6 asked, split over the noise levels
        assert n >= 5 and z["pose"].shape == (n, 21, 4) and z["dist"].shape == (n, 3)


def test_cli_train_runs_data_parallel_in_a_group(ranks):
    """``cli train`` in a process group (as under ``torchrun``): the fused
    sharded step on every rank, "on 4 device(s)" and the epoch lines printed
    by rank 0 alone."""
    assert "on 4 device(s)" in ranks[0]["cli_out"] and "epoch 0:" in ranks[0]["cli_out"]
    for r in ranks[1:]:
        assert r["cli_out"] == ""


# --------------------------------------------------------------- denoise

def test_frame_sharded_denoise_matches_unsharded_and_jax(ranks, golden):
    den = _denoiser(golden)
    want, m = den.optimize(golden["den_noisy"], iterations=1, steps_per_iter=4)
    for r in ranks:
        np.testing.assert_allclose(r["den_pose"], want.numpy(), rtol=0, atol=1e-5)
        for k, v in m.items():
            assert abs(r["den_metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
        np.testing.assert_allclose(r["den_pose"], golden["den_pose"], rtol=1e-4, atol=1e-4)
        assert abs(r["den_metrics"]["final_pose_pr"] - float(golden["den_final_pose_pr"])) < 1e-5


def test_frame_sharded_denoise_needs_frames_that_divide(golden):
    """The mesh axis must be the one named, and a one-process mesh is the
    unsharded solve."""
    from posendf_torch.parallel import make_mesh

    den = _denoiser(golden)
    mesh = make_mesh(("seq",), device="cpu")
    with pytest.raises(ValueError, match="mesh axis"):
        den.optimize(golden["den_noisy"], iterations=1, steps_per_iter=1, mesh=mesh)
    pose, _ = den.optimize(golden["den_noisy"], iterations=1, steps_per_iter=2, mesh=mesh,
                           mesh_axis="seq")
    want, _ = den.optimize(golden["den_noisy"], iterations=1, steps_per_iter=2)
    assert torch.equal(pose, want)


# ------------------------------------------------------- one process, no group

def test_init_distributed_single_process_is_idempotent(monkeypatch):
    from posendf_torch.parallel import init_distributed

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") == 0
    assert init_distributed(device="cpu") == 0
    assert not torch.distributed.is_initialized()


def test_make_mesh_without_a_group_has_size_one_and_identity_helpers():
    from posendf_torch.parallel import (all_reduce_mean, all_reduce_sum, gather_rows,
                                        make_mesh, shard_batch, sum_across)

    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis) == (1, 0, None, "data")
    x = torch.arange(10.0)
    assert shard_batch(mesh, {"a": x})["a"] is not None and torch.equal(shard_batch(mesh, x), x)
    for fn in (all_reduce_sum, all_reduce_mean, gather_rows, sum_across):
        assert fn(mesh, x) is x
    with pytest.raises(ValueError, match="one axis"):
        make_mesh(("data", "seq"), device="cpu")


def test_python_m_posendf_torch_is_the_cli():
    proc = subprocess.run([sys.executable, "-m", "posendf_torch", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "denoise-bench" in proc.stdout, proc.stderr


def test_profiling_trace_timer_and_nan_debugging(tmp_path):
    """``utils/profiling.py``: a Chrome trace of the block (``trace.json``
    without a group), nothing for ``None``; the NaN switch turns on
    autograd's anomaly detection."""
    import json

    from posendf_torch.utils import enable_nan_debugging, trace

    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])
    with trace(None):
        pass
    was = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
