"""The port's trainer, data pipeline and checkpoints against the JAX package's, on the CPU.

The synthetic dataset writer and the numpy batcher give the JAX package's
arrays and batch stream; three ``Trainer`` steps on that stream, autodiff
and fused (the train kernels' plain version here; JAX's Pallas kernel in
interpret mode), give the JAX ``Trainer``'s losses and weights from the same
initial weights; the checkpoint store round-trips, falls back on a torn
latest and writes the reference's ``.tar`` that the JAX package reads;
``cli train`` runs end to end; the matched-head init gives JAX's.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.config import PoseNDFConfig as JaxConfig  # noqa: E402
from posendf_tpu.data.pipeline import TrainingBatcher as JaxBatcher  # noqa: E402
from posendf_tpu.data.synthetic import write_synthetic_dataset as jax_write  # noqa: E402
from posendf_tpu.training import moment_matched_head_init as jax_matched_head  # noqa: E402
from posendf_tpu.training.torch_import import load_torch_checkpoint as jax_load_tar  # noqa: E402
from posendf_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.config import PoseNDFConfig, load_config, save_config  # noqa: E402
from posendf_torch.data.pipeline import TrainingBatcher, prefetch_to_device  # noqa: E402
from posendf_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.training.checkpoints import CheckpointStore  # noqa: E402
from posendf_torch.training.init_utils import he_gain, moment_matched_head_init  # noqa: E402
from posendf_torch.training.metrics import RunningAverage  # noqa: E402
from posendf_torch.training.trainer import Trainer  # noqa: E402

DIMS = [32, 48]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return write_synthetic_dataset(str(root), subsets=("ACCAD", "CMU", "HumanEva"))


def _configs(tmp_path, labeled, amass, **train):
    """The same small lrelu run in both packages' configs."""
    out = []
    for cls in (PoseNDFConfig, JaxConfig):
        cfg = cls()
        cfg.data.data_dir, cfg.data.amass_dir = labeled, amass
        cfg.experiment.root_dir = str(tmp_path / cls.__module__.split(".")[0])
        cfg.dfnet.dims = list(DIMS)
        cfg.dfnet.live_head = True
        cfg.train.optimizer_param = 1e-3
        cfg.train.batch_size, cfg.train.num_pts = 2, 32
        for k, v in train.items():
            setattr(cfg.train, k, v)
        out.append(cfg)
    return out


def test_synthetic_dataset_is_the_jax_packages(tmp_path, dataset):
    labeled, amass = dataset
    j_labeled, j_amass = jax_write(str(tmp_path), subsets=("ACCAD", "CMU", "HumanEva"))
    for mine, theirs in ((labeled, j_labeled), (amass, j_amass)):
        names = sorted(os.path.relpath(os.path.join(d, f), mine)
                       for d, _, fs in os.walk(mine) for f in fs)
        assert names == sorted(os.path.relpath(os.path.join(d, f), theirs)
                               for d, _, fs in os.walk(theirs) for f in fs)
        for n in names:
            a, b = np.load(os.path.join(mine, n)), np.load(os.path.join(theirs, n))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (n, k)


@pytest.mark.parametrize("flip", [False, True])
def test_batch_stream_is_the_jax_packages(dataset, flip):
    """For one (seed, epoch) the port's batcher draws the JAX batcher's
    batches, draw for draw (the JAX one on its numpy backend)."""
    labeled, amass = dataset
    kw = dict(batch_size=2, num_pts=16, seed=5, flip=flip)
    mine, theirs = TrainingBatcher(labeled, amass, **kw), JaxBatcher(labeled, amass,
                                                                     backend="numpy", **kw)
    assert len(mine) == len(theirs) == 2
    pairs = list(zip(mine.epoch(1), theirs.epoch(1))) + [(mine.sample_batch(),
                                                          theirs.sample_batch())]
    assert len(pairs) == 3
    for a, b in pairs:
        for k in ("pose", "dist", "man_poses"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    vald = TrainingBatcher(labeled, amass, split="vald", batch_size=1, num_pts=4)
    assert [os.path.basename(os.path.dirname(f)) for f in vald.labeled] == ["HumanEva"] * 2


def test_prefetch_delivers_the_stream_and_raises_its_errors(dataset):
    labeled, amass = dataset
    b = TrainingBatcher(labeled, amass, batch_size=2, num_pts=8, seed=1)
    for got, want in zip(prefetch_to_device(b.epoch(0), "cpu"), b.epoch(0)):
        assert isinstance(got["pose"], torch.Tensor)
        np.testing.assert_array_equal(got["pose"].numpy(), want["pose"])

    def broken():
        yield b.sample_batch()
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(broken(), "cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_steps_match_the_jax_trainer(tmp_path, dataset, fused):
    """Three steps from the same initial weights on the same batches: the
    losses (rtol 1e-5) and the weights, which Adam moves by about lr a step
    (all within the 2 * 3 lr two runs can part, 99% within lr / 20)."""
    labeled, amass = dataset
    cfg, jcfg = _configs(tmp_path, labeled, amass, fused_grads=fused)
    batches = list(TrainingBatcher(labeled, amass, batch_size=2, num_pts=32, seed=2).epoch(0))
    batches += [TrainingBatcher(labeled, amass, batch_size=2, num_pts=32, seed=3).sample_batch()]
    assert len(batches) == 3
    jt = JaxTrainer(jcfg)
    trainer = Trainer(cfg, device="cpu")
    trainer.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params)))
    with pltpu.force_tpu_interpret_mode():
        want = [jt.train_step({k: jnp.asarray(v) for k, v in b.items()}) for b in batches]
    got = [trainer.train_step(b) for b in batches]
    for g, w in zip(got, want):
        for k in ("total", "dist", "man_loss", "eikonal"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5, err_msg=k)
    lr = cfg.train.optimizer_param
    want_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for k, v in trainer.module.state_dict().items():
        err = (v - want_params[k]).abs()
        assert float(err.max()) <= 6 * lr and float((err > lr / 20).float().mean()) <= 0.01, k


def test_checkpoint_store_round_trip_and_torn_latest(tmp_path):
    cfg = PoseNDFConfig()
    cfg.dfnet.dims = DIMS
    cfg.experiment.root_dir = str(tmp_path)
    t = Trainer(cfg, device="cpu")
    q = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 21, 4)).astype(np.float32))
    t.train_step({"pose": q, "dist": torch.rand(64), "man_poses": q})
    first = {k: v.clone() for k, v in t.module.state_dict().items()}
    t.save()
    t.epoch += 1
    t.train_step({"pose": q, "dist": torch.rand(64), "man_poses": q})
    t.save()
    store = t.store
    assert sorted(os.listdir(store.directory)) == ["checkpoint_latest.tar",
                                                   "checkpoint_previous.tar"]

    # the reference layout, which the JAX package reads
    raw = torch.load(store.latest_path, weights_only=True)
    assert raw["epoch"] == 1 and "optimizer_state_dict" in raw
    assert raw["model_state_dict"]["enc.net.0.net.0.weight"].shape == (10, 4)
    jparams, epoch = jax_load_tar(store.latest_path)
    assert epoch == 1
    for k, v in params_from_jax(jparams).items():
        assert torch.equal(v, t.module.state_dict()[k]), k

    # resume: weights, optimizer moments and epoch
    t2 = Trainer(cfg, device="cpu")
    assert t2.epoch == 2
    for k, v in t.module.state_dict().items():
        assert torch.equal(v, t2.module.state_dict()[k]), k
    s1, s2 = t.optimizer.state_dict()["state"], t2.optimizer.state_dict()["state"]
    assert all(torch.equal(s1[i]["exp_avg_sq"], s2[i]["exp_avg_sq"]) for i in s1)

    # a torn latest falls back to previous
    with open(store.latest_path, "wb") as f:
        f.write(b"torn")
    with pytest.warns(UserWarning, match="falling back"):
        assert store.restore(t2.module, t2.optimizer) == 0
    for k, v in first.items():
        assert torch.equal(v, t2.module.state_dict()[k]), k

    # a directory loads as a field (from previous, latest being torn); a
    # mismatched model raises
    with pytest.warns(UserWarning, match="falling back"):
        field = posendf_torch.load_field(store.directory, config=cfg, device="cpu")
    assert torch.equal(field.module.dfnet.w0, first["dfnet.w0"])
    with pytest.warns(UserWarning, match="falling back"), \
            pytest.raises(ValueError, match="does not match the model"):
        store.restore(PoseNDF(dfnet_dims=(64, 48)))


def test_best_checkpoint_is_validation_gated(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    module = PoseNDF(dfnet_dims=(64, 48))
    assert store.best_info() is None and store.restore_best(module) is None
    assert store.save_best(module, None, 3, 0.5) is not None
    assert store.save_best(module, None, 4, 0.7) is None
    assert store.save_best(module, None, 5, float("nan")) is None
    assert store.best_info() == {"epoch": 3, "metric": 0.5, "mode": "min"}
    assert store.save_best(module, None, 6, 0.9, mode="max") is not None
    assert store.restore_best(module) == 6
    os.utime(os.path.join(store.directory, "checkpoint_best.tar"), ns=(1, 1))
    assert store.best_info() is None  # the sidecar no longer describes the file


def test_fit_with_validation_keeps_the_best_and_stops_early(tmp_path, dataset):
    labeled, amass = dataset
    cfg, _ = _configs(tmp_path, labeled, amass)
    cfg.train.optimizer_param = 0.0  # nothing improves: every validation after the first is stale
    trainer = Trainer(cfg, device="cpu")
    train = TrainingBatcher(labeled, amass, batch_size=2, num_pts=16)
    val = TrainingBatcher(labeled, amass, split="vald", batch_size=1, num_pts=16, seed=9)
    fixed = val.sample_batch()
    val.sample_batch = lambda: fixed  # the same validation batch every time
    trainer.fit(train, epochs=10, val_batcher=val, val_every=1, val_batches=1,
                early_stop_patience=2)
    assert trainer.epoch == 3
    assert trainer.store.best_info()["epoch"] == 0
    assert trainer.restore_best() == 0
    lines = open(os.path.join(trainer.exp_dir, "metrics.jsonl")).read().splitlines()
    assert sum("val/total" in line for line in lines) == 3


@pytest.mark.parametrize("fused", [False, True])
def test_cli_train_end_to_end(tmp_path, dataset, fused):
    """A JSON config (written without yaml) drives ``cli train``; the run's
    checkpoint directory loads back as a field with the trained weights."""
    labeled, amass = dataset
    cfg, _ = _configs(tmp_path, labeled, amass)
    path = str(tmp_path / "run.json")
    save_config(cfg, path)
    assert load_config(path) == cfg
    argv = ["train", "--config", path, "--max-epoch", "2", "--device", "cpu",
            "--matched-head-init"]
    cli.main(argv + (["--fused-grads"] if fused else []))
    exp_dir = os.path.join(cfg.experiment.root_dir, cfg.exp_name())
    assert os.path.exists(os.path.join(exp_dir, "run.json"))
    records = [json.loads(x) for x in open(os.path.join(exp_dir, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train/total"]) for r in records)
    field = posendf_torch.load_field(os.path.join(exp_dir, "checkpoints"), config=path,
                                     device="cpu")
    q = torch.from_numpy(np.load(os.path.join(labeled, "ACCAD", "seq00_000.npz"))["pose"][:8])
    assert torch.isfinite(field.distance(q)).all()
    cli.main(argv)  # resumes at epoch 2 of 2: nothing left to train
    assert len(open(os.path.join(exp_dir, "metrics.jsonl")).read().splitlines()) == 2
    out = str(tmp_path / "gen.npz")
    cli.main(["train", "--test", "--config", path, "--device", "cpu"])  # the reference's --test
    cli.main(["generate", "--config", path, "--ckpt", os.path.join(exp_dir, "checkpoints"),
              "--num-poses", "4", "--steps", "2", "--device", "cpu", "--out", out])
    assert np.load(out)["pose"].shape == (4, 21, 4)


def test_matched_head_init_is_the_jax_packages():
    cfg = JaxConfig()
    cfg.dfnet.dims = DIMS
    jm = cfg.make_model()
    params = jm.init(jax.random.key(0), jnp.zeros((1, 21, 4)))["params"]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(256, 21, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    labels = (0.02 + 0.01 * rng.random(256)).astype(np.float32)
    want, want_stats = jax_matched_head(jm, params, jnp.asarray(q), labels)
    got, stats = moment_matched_head_init(PoseNDF(dfnet_dims=DIMS), params_from_jax(params),
                                          torch.from_numpy(q), labels)
    for k in want_stats:
        np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-4, err_msg=k)
    for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray, want)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    gained = he_gain(params_from_jax(params))
    assert torch.equal(gained["enc.b1"], params_from_jax(params)["enc.b1"])
    avg = RunningAverage()
    for v in (1.0, 2.0, 6.0):
        avg.update(v)
    assert avg.avg == 3.0 and avg.count == 3
