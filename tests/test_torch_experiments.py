"""The port's experiments against the JAX package's, on the CPU.

The annealed-Adam engine against optax step by step; the denoiser's
schedules, noise estimate, solves (serial and batched), benchmark grid and
sweep; interpolation; mesh export; the ``denoise`` / ``denoise-bench`` /
``interpolate`` CLI; and the ``space="joints"`` labelling. Small sizes: a
seeded softplus field of DFNet widths (64, 64) (the JAX package's own
experiment fixture, weights doubled and the head bias lifted so the
distances vary), an 80-vertex synthetic body, 8-frame clips. The trained
full-width field ``docs/quality/ckpt_l8_best.msgpack`` with the 128-vertex
body is held to ``tests/data/torch_port_denoise_expected.npz``
(``scripts/make_torch_port_denoise_golden.py``), the file ``chip_smoke.py``
holds the card to.

Bars, each beside the deviation it measured on the CPU (fp32 on both sides,
sums in another order):
  * the engine: params and history rtol 2e-5, atol 1e-7 (measured 3.9e-6
    relative); a masked dof equal to the bit;
  * the small field's 2 x 5 solves: pose atol 2e-5, history rtol 1e-4 and
    atol 1e-7 (measured 2.5e-6 in the pose, 1.0e-5 relative in the history);
    its noise statistics rtol 1e-5 (measured 4.1e-7 relative);
  * the trained field's 2 x 5 solve of 60 frames: pose atol 5e-5, history
    rtol 1e-4 and atol 1e-7 (measured 8.1e-6, 1.2e-5); the noise statistics
    atol 1e-6 in d and 1e-4 in s (measured 2.0e-8, 3.0e-7); the
    interpolation's path and distances atol 1e-5 (measured 1.2e-7, 1.5e-8);
  * batched against serial solves: the bar of ``tests/test_experiments.py``
    (pose atol 2e-5; metrics atol 1e-4, rtol 1e-3).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.experiments import MotionDenoiser as JaxDenoiser  # noqa: E402
from posendf_tpu.experiments import interpolate as jax_interpolate  # noqa: E402
from posendf_tpu.experiments import optim as jax_optim  # noqa: E402
from posendf_tpu.experiments import denoise as jax_denoise  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.smpl import BodyModel as JaxBodyModel  # noqa: E402
from posendf_tpu.smpl import synthetic_model as jax_synthetic_model  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.checkpoints import params_from_jax, smpl_model_from_jax  # noqa: E402
from posendf_torch.experiments import denoise, optim  # noqa: E402
from posendf_torch.experiments.denoise import MotionDenoiser  # noqa: E402
from posendf_torch.experiments.interpolate import interpolate  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.quat import axis_angle_to_quaternion  # noqa: E402
from posendf_torch.parallel import make_mesh  # noqa: E402
from posendf_torch.smpl import BodyModel  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
DENOISE_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_denoise_expected.npz")
GOLDEN = os.path.join(ROOT, "examples", "golden")
STAT_KEYS = ("s", "s_field", "s_temporal", "d_input", "d_floor", "d_probe")


@pytest.fixture(scope="module")
def pair():
    """(JAX module, JAX params, port Field) of one seeded softplus field."""
    jm = JaxPoseNDF(dfnet_dims=(64, 64), activation="softplus")
    params = jm.init(jax.random.key(0), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(2.0), params)
    params["dfnet"]["b2"] = np.abs(params["dfnet"]["b2"]) + np.float32(0.05)
    tm = PoseNDF(dfnet_dims=(64, 64), activation="softplus")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, posendf_torch.Field(tm)


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_model(num_vertices=80, seed=1)
    return JaxBodyModel(model=jm), BodyModel(model=smpl_model_from_jax(jm), device="cpu")


def _clip(seed, frames=8, scale=0.25):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=scale, size=(frames, 69)).astype(np.float32),
            rng.normal(scale=0.2, size=(frames, 69)).astype(np.float32))


# ---------------------------------------------------------------- the engine

ENGINE_SPECS = {
    "fit": optim.AnnealSpec(scale=1.0, power=1, anneal=-1.0),
    "reg": optim.AnnealSpec(scale=0.5, power=2, anneal=+1.0, active_after=0),
}
ENGINE_CASES = {
    "gating": {},
    "runtime": {"anneal_runtime": {"reg": {"scale": 2.0, "active_after": 1.0},
                                   "fit": {"anneal": -0.5}}},
    "lr_runtime": {"lr_runtime": 0.3},
    "param_mask": {"param_mask": np.asarray([[1.0, 0.0, 1.0, 0.0]] * 3, np.float32),
                   "lr_runtime": 0.5},
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_annealed_adam_matches_optax_step_by_step(case):
    """Every step's terms and weighted total, and the final params, against
    the JAX engine (optax.adam); masked dofs stay at their start, to the bit."""
    target = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    x0 = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    extra = ENGINE_CASES[case]

    def terms(x, aux, mod):
        return {"fit": mod.sum((x - aux["target"]) ** 2), "reg": mod.sum(x ** 4) * 0.1}

    jaux = {"target": jnp.asarray(target)}
    taux = {"target": torch.from_numpy(target)}
    for k, v in extra.items():
        if k == "anneal_runtime":
            jaux[k] = {t: {n: jnp.float32(x) for n, x in d.items()} for t, d in v.items()}
            taux[k] = v
        else:
            jaux[k] = jnp.asarray(v)
            taux[k] = torch.as_tensor(v)
    jspecs = {k: jax_optim.AnnealSpec(*v) for k, v in ENGINE_SPECS.items()}
    jsolve = jax_optim.make_annealed_solver(lambda x, a: terms(x, a, jnp), jspecs,
                                            iterations=3, steps_per_iter=4, lr=0.05)
    tsolve = optim.make_annealed_solver(lambda x, a: terms(x, a, torch), ENGINE_SPECS,
                                        iterations=3, steps_per_iter=4, lr=0.05)
    jx, jhist = jsolve(jnp.asarray(x0), jaux)
    tx, thist = tsolve(torch.from_numpy(x0), taux)
    assert set(thist) == set(jhist) == {"fit", "reg", "total"}
    for k in jhist:
        assert tuple(thist[k].shape) == (12,)
        np.testing.assert_allclose(thist[k].numpy(), np.asarray(jhist[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-5, atol=1e-7)
    if "param_mask" in extra:
        frozen = extra["param_mask"] == 0.0
        assert np.array_equal(tx.numpy()[frozen], x0[frozen])
        assert not np.array_equal(tx.numpy()[~frozen], x0[~frozen])
    if case == "gating":
        # 'reg' is gated off in iteration 0: the total is 'fit' / (1 + 0)
        np.testing.assert_allclose(thist["total"][:4].numpy(), thist["fit"][:4].numpy())


def test_run_annealed_adam_minimizes_a_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    x, hist = optim.run_annealed_adam(lambda x: {"data": torch.sum((x - target) ** 2)},
                                      torch.zeros(3), {"data": optim.AnnealSpec(scale=1.0)},
                                      iterations=4, steps_per_iter=100, lr=0.05)
    assert float(hist["data"][-1]) < 1e-2
    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=0.2)


@pytest.mark.parametrize("s", [-0.5, 0.0, 0.3, 0.5, 1.0, 1.5])
def test_adaptive_runtime_matches_jax(s):
    """The runtime overrides and step-size factor, float32 values equal to
    JAX's; s = 1 is the reference schedule, s = 0 the near-clean endpoint."""
    want = jax_denoise.adaptive_runtime(s, prior_gain=0.5)
    got = denoise.adaptive_runtime(s, prior_gain=0.5)
    for term, vals in want.items():
        for k, v in vals.items():
            assert np.float32(got[term][k]) == np.float32(v), (term, k)
    lr = np.float32(10.0 ** (2.0 * (float(np.clip(s, 0.0, 1.0)) - 1.0)))
    assert np.float32(denoise._lr_runtime(s)) == lr
    one = denoise.adaptive_runtime(1.0)
    assert one == {"pose_pr": {"scale": 1e7}, "temp": {"scale": 10.0},
                   "data": {"anneal": -1.0, "active_after": 0.0}}
    zero = denoise.adaptive_runtime(0.0)
    assert zero["pose_pr"]["scale"] == 1e4 and zero["data"]["active_after"] == -1.0


# ------------------------------------------------------------- the denoiser

def test_estimate_clip_noise_matches_jax(pair):
    """Fed the probe noise JAX drew (key 0), the port's statistics are JAX's."""
    jm, params, field = pair
    noisy, _ = _clip(2, frames=12)
    q = np.asarray(axis_angle_to_quaternion(torch.from_numpy(noisy[:, :63]).reshape(12, 21, 3)))
    want = jax_denoise.estimate_clip_noise(jm, params, jnp.asarray(q))
    probe = 0.1 * np.asarray(jax.random.uniform(jax.random.key(0), q.shape))
    got = denoise.estimate_clip_noise(field, q, probe_noise=probe)
    for k in STAT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    many = denoise.estimate_clip_noise_many(field, np.stack([q, q[::-1].copy()]),
                                            probe_noise=probe)
    assert many[0] == pytest.approx(got, rel=1e-6, abs=1e-9)
    rev = denoise.estimate_clip_noise(field, q[::-1].copy(), probe_noise=probe)
    assert many[1] == pytest.approx(rev, rel=1e-6, abs=1e-9)


def _histories(jden, tden, noisy, iterations, steps_per_iter, **kw):
    """Both packages' solves of one clip through their solver objects:
    (JAX pose, JAX history, port pose, port history)."""
    jinit = jden.body_model(pose_body=jnp.asarray(noisy))
    jaux = {"params": jden.params, "smpl": jden.body_model.model, "betas": jinit.betas,
            "init_joints": jinit.Jtr}
    tinit = tden.body_model(pose_body=noisy)
    taux = {"betas": tinit.betas, "init_joints": tinit.Jtr[None]}
    if "data_joint_mask" in kw:
        jaux["data_joint_mask"] = jnp.asarray(kw["data_joint_mask"])
        taux["data_joint_mask"] = torch.from_numpy(kw["data_joint_mask"])
    if "param_mask" in kw:
        pm = np.broadcast_to(kw["param_mask"], jinit.body_pose.shape)
        jaux["param_mask"] = jnp.asarray(pm)
        taux["param_mask"] = torch.from_numpy(pm.copy())[None]
    jp, jh = jden._solver(iterations, steps_per_iter)(jinit.body_pose, jaux)
    tp, th = tden._solve(tinit.body_pose[None], taux, iterations, steps_per_iter)
    return np.asarray(jp), {k: np.asarray(v) for k, v in jh.items()}, tp[0].numpy(), \
        {k: v[:, 0].numpy() for k, v in th.items()}


@pytest.mark.parametrize("specs", ["reference", "balanced", "masked"])
def test_optimize_matches_jax(pair, bodies, specs):
    """A 2 x 5 solve of 8 frames: every step's terms and total, the final
    pose and the metrics; 'masked' anchors 20 of the 24 joints and freezes
    the first 9 dofs (equal to the input, to the bit)."""
    jm, params, field = pair
    jb, tb = bodies
    noisy, gt = _clip(3)
    kw = {}
    if specs == "masked":
        kw = {"data_joint_mask": np.r_[np.ones(20), np.zeros(4)].astype(np.float32),
              "param_mask": np.r_[np.zeros(9), np.ones(60)].astype(np.float32)}
    name = "reference" if specs == "masked" else specs
    jden = JaxDenoiser(jm, params, jb, specs=name)
    tden = MotionDenoiser(field, tb, specs=name)
    jp, jh, tp, th = _histories(jden, tden, noisy, 2, 5, **kw)
    assert set(th) == set(jh)
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-5)
    want_pose, want_m = jden.optimize(jnp.asarray(noisy), jnp.asarray(gt), iterations=2,
                                      steps_per_iter=5, **kw)
    got_pose, got_m = tden.optimize(noisy, gt, iterations=2, steps_per_iter=5, **kw)
    np.testing.assert_array_equal(got_pose.numpy(), tp)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, atol=1e-6, err_msg=k)
    if specs == "masked":
        assert np.array_equal(got_pose.numpy()[:, :9], noisy[:, :9])


def test_optimize_many_matches_serial(pair, bodies):
    """The batched solve of 3 clips reproduces their serial solves, the
    adaptive schedule's per-clip noise estimates and step sizes included."""
    _, _, field = pair
    _, tb = bodies
    rng = np.random.default_rng(17)
    clips = rng.normal(scale=0.25, size=(3, 5, 69)).astype(np.float32)
    gt = rng.normal(scale=0.2, size=(3, 5, 69)).astype(np.float32)
    for specs in (None, "adaptive"):
        den = MotionDenoiser(field, tb, specs=specs)
        many_pose, many_m = den.optimize_many(clips, gt, iterations=2, steps_per_iter=4)
        assert tuple(many_pose.shape) == (3, 5, 69)
        for c in range(3):
            pose_c, m_c = den.optimize(clips[c], gt[c], iterations=2, steps_per_iter=4)
            np.testing.assert_allclose(many_pose[c].numpy(), pose_c.numpy(), atol=2e-5)
            for k in ("v2v_cm", "v2v_input_cm", "final_pose_pr"):
                np.testing.assert_allclose(many_m[k][c], m_c[k], atol=1e-4, rtol=1e-3)
            if specs == "adaptive":
                np.testing.assert_allclose(many_m["noise_level_s"][c], m_c["noise_level_s"],
                                           atol=1e-6)
    with pytest.raises(ValueError, match="clips, frames, dofs"):
        MotionDenoiser(field, tb).optimize_many(clips[0])


def test_single_frame_stays_finite(pair, bodies):
    _, _, field = pair
    _, tb = bodies
    noisy, _ = _clip(4, frames=1)
    pose, m = MotionDenoiser(field, tb).optimize(noisy, iterations=2, steps_per_iter=3)
    assert tuple(pose.shape) == (1, 69) and bool(torch.isfinite(pose).all())
    assert m["final_temp"] == 0.0 and np.isfinite(m["v2v_vs_input_cm"])


def test_named_specs_and_refusals(pair, bodies):
    _, _, field = pair
    _, tb = bodies
    assert MotionDenoiser(field, tb, specs="reference").specs == denoise.DENOISE_SPECS
    assert MotionDenoiser(field, tb, specs="balanced").specs == denoise.BALANCED_SPECS
    ad = MotionDenoiser(field, tb, specs="adaptive")
    assert ad.adaptive and ad.specs == denoise.ADAPTIVE_SPECS
    assert MotionDenoiser(field.module, tb).specs == denoise.DENOISE_SPECS
    with pytest.raises(ValueError, match="unknown specs name 'refrence'"):
        MotionDenoiser(field, tb, specs="refrence")
    den = MotionDenoiser(field, tb)
    noisy, gt = _clip(5)
    with pytest.raises(ValueError, match="mesh axis"):   # a mesh along another axis
        den.optimize(noisy, mesh=make_mesh(("seq",), device="cpu"))
    with pytest.raises(ValueError, match="frames"):
        den.optimize(noisy, gt[:4])
    with pytest.raises(ValueError, match="data_joint_mask"):
        den.optimize(noisy, data_joint_mask=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="param_mask"):
        den.optimize(noisy, param_mask=np.ones(5, np.float32))


# ------------------------------------------- the benchmark grid and sweep

def test_synthesize_grid_matches_jax(tmp_path):
    """The same files as JAX's grid, to the float32 rounding of the
    axis-angle conversion (measured 2.4e-7)."""
    from posendf_tpu.experiments.denoise_benchmark import synthesize_grid as jax_grid

    from posendf_torch.experiments.denoise_benchmark import synthesize_grid

    grid = ((0.05, 6), (0.1, 7))
    jax_grid(str(tmp_path / "j"), grid=grid, seqs_per_level=2, seed=4, family_seed=11)
    synthesize_grid(str(tmp_path / "t"), grid=grid, seqs_per_level=2, seed=4, family_seed=11)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 8
    for rel in files:
        with np.load(tmp_path / "j" / rel) as a, np.load(tmp_path / "t" / rel) as b:
            assert a["pose_body"].dtype == b["pose_body"].dtype == np.float32
            np.testing.assert_allclose(b["pose_body"], a["pose_body"], rtol=0, atol=1e-6)


def test_run_sweep_batched_matches_serial(tmp_path, pair, bodies):
    from posendf_torch.experiments.denoise_benchmark import run_sweep, synthesize_grid

    _, _, field = pair
    _, tb = bodies
    root = synthesize_grid(str(tmp_path / "g"), grid=((0.1, 6),), seqs_per_level=3, seed=4,
                           family_seed=11)
    # a sequence with no ground truth is scored against its input, apart
    os.remove(os.path.join(root, "noise_0.1_6", "seq02", "gt_results.npz"))
    den = MotionDenoiser(field, tb)
    serial = run_sweep(den, root, iterations=1, steps_per_iter=3, batch_clips=False)
    out = str(tmp_path / "table.npz")
    batched = run_sweep(den, root, iterations=1, steps_per_iter=3, out_path=out)
    assert set(serial) == set(batched) == {"noise_0.1_6", "noise_0.1_6__vs_input"}
    assert len(batched["noise_0.1_6"]) == 2 and len(batched["noise_0.1_6__vs_input"]) == 1
    for k in serial:
        np.testing.assert_allclose(batched[k], serial[k], atol=1e-4, rtol=1e-3)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["noise_0.1_6"], batched["noise_0.1_6"])


# ------------------------------------------- interpolation and mesh export

def test_interpolate_matches_jax(pair):
    jm, params, field = pair
    rng = np.random.default_rng(9)
    a, b = (q / np.linalg.norm(q, axis=-1, keepdims=True)
            for q in rng.normal(size=(2, 21, 4)).astype(np.float32))
    want_path, want_d = jax_interpolate(jm, params, jnp.asarray(a), jnp.asarray(b),
                                        num_steps=6, projection_steps=4)
    path, d = interpolate(field, a, b, num_steps=6, projection_steps=4)
    np.testing.assert_allclose(path.numpy(), np.asarray(want_path), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)


def test_mesh_export_matches_jax(tmp_path, bodies):
    """OBJ text and renders of the same poses equal the JAX package's."""
    from posendf_tpu.experiments import render as jax_render

    from posendf_torch.experiments import render

    jb, tb = bodies
    poses = _clip(6, frames=2)[0]
    render.export_pose_meshes(str(tmp_path / "t"), tb, [("out", torch.from_numpy(poses))],
                              save_mesh=True, render=True)
    jax_render.export_pose_meshes(str(tmp_path / "j"), jb, [("out", jnp.asarray(poses))],
                                  save_mesh=True, render=False)
    for i in range(2):
        t_obj = (tmp_path / "t" / "meshes" / f"out_{i:04d}.obj").read_text()
        j_obj = (tmp_path / "j" / "meshes" / f"out_{i:04d}.obj").read_text()
        assert t_obj.count("\nf ") == 64 and t_obj.startswith("v ")
        t_v = np.array([list(map(float, ln.split()[1:])) for ln in t_obj.splitlines()
                        if ln.startswith("v ")])
        j_v = np.array([list(map(float, ln.split()[1:])) for ln in j_obj.splitlines()
                        if ln.startswith("v ")])
        np.testing.assert_allclose(t_v, j_v, atol=2e-6)
        assert [ln for ln in t_obj.splitlines() if ln.startswith("f ")] == \
            [ln for ln in j_obj.splitlines() if ln.startswith("f ")]
    renders = sorted(os.listdir(tmp_path / "t" / "render"))
    assert len(renders) == 2 and renders[0].startswith("out_0000.")
    verts = tb(pose_body=poses).vertices[0].numpy()
    np.testing.assert_array_equal(render.render_mesh(verts, tb.model.faces, image_size=64),
                                  jax_render.render_mesh(verts, tb.model.faces, image_size=64))


# -------------------------------------------------------------------- CLI

def _golden_args():
    return ["--ckpt", os.path.join(GOLDEN, "golden.msgpack"),
            "--config", os.path.join(GOLDEN, "golden.yaml"), "--device", "cpu"]


def test_cli_denoise_and_bench_on_the_golden_field(tmp_path, capsys):
    """``cli denoise`` on the CPU writes the pose the API gives and the
    reference denoiser's metrics, and its meshes; ``denoise-bench
    --synthesize`` writes the table of a grid it made. The CLI and the API
    run the same short 2 x 5-step horizon: that they write the same thing
    holds at any horizon."""
    noisy, gt = _clip(10, frames=6, scale=0.1)
    np.savez(tmp_path / "noisy.npz", pose_body=noisy[:, :63])
    np.savez(tmp_path / "gt.npz", pose_body=gt[:, :63])
    out = str(tmp_path / "den.npz")
    cli.main(["denoise", *_golden_args(), "--motion-data", str(tmp_path / "noisy.npz"),
              "--gt-data", str(tmp_path / "gt.npz"), "--out", out, "--specs", "adaptive",
              "--iterations", "2", "--steps-per-iter", "5",
              "--save-mesh", "--mesh-dir", str(tmp_path / "m")])
    printed = capsys.readouterr().out
    assert "v2v_cm:" in printed and "noise_level_s:" in printed
    field = posendf_torch.load_field(os.path.join(GOLDEN, "golden.msgpack"),
                                     config=os.path.join(GOLDEN, "golden.yaml"), device="cpu")
    pad = np.zeros((6, 69), np.float32)
    want_pose, want_m = MotionDenoiser(field, BodyModel(device="cpu"), specs="adaptive").optimize(
        noisy * np.r_[np.ones(63), np.zeros(6)].astype(np.float32) + pad,
        gt * np.r_[np.ones(63), np.zeros(6)].astype(np.float32), iterations=2, steps_per_iter=5)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["pose_body"], want_pose.numpy())
        assert set(z.files) == {"pose_body"} | set(want_m)
    assert len(os.listdir(tmp_path / "m" / "meshes")) == 12

    table = str(tmp_path / "table.npz")
    cli.main(["denoise-bench", *_golden_args(), "--data-root", str(tmp_path / "grid"),
              "--synthesize", "--seqs-per-level", "2", "--iterations", "1",
              "--steps-per-iter", "2", "--out", table])
    with np.load(table) as z:
        assert sorted(z.files) == ["noise_0.01_60", "noise_0.05_60", "noise_0.1_60",
                                   "noise_0.5_60"]
        assert all(z[k].shape == (2,) and np.isfinite(z[k]).all() for k in z.files)


def test_cli_interpolate_matches_jax(tmp_path, capsys):
    """``cli interpolate`` between two pose files: the JAX CLI's path."""
    from posendf_tpu.cli import main as jax_main

    rng = np.random.default_rng(12)
    for name in ("a", "b"):
        np.savez(tmp_path / f"{name}.npz", pose_body=rng.normal(scale=0.3, size=(1, 63)))
    args = ["interpolate", "--ckpt", os.path.join(GOLDEN, "golden.msgpack"), "--config",
            os.path.join(GOLDEN, "golden.yaml"), "--num-steps", "5",
            "--pose-a", str(tmp_path / "a.npz"), "--pose-b", str(tmp_path / "b.npz")]
    jax_main(args + ["--out", str(tmp_path / "j.npz")])
    cli.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    assert "field distance per waypoint" in capsys.readouterr().out
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        np.testing.assert_allclose(t["path"], j["path"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(t["dist"], j["dist"], rtol=0, atol=1e-5)
    cli.main(args[:5] + ["--device", "cpu"])   # random endpoints
    assert "RANDOM poses" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="together"):
        cli.main(args[:9] + ["--device", "cpu"])


# ------------------------------------------------- space="joints" labelling

def test_space_joints_labelling_matches_jax():
    """Candidates among the posed joints (72-D on the 128-vertex body), then
    the exact re-rank: the JAX package's labels of the same queries."""
    from posendf_tpu.data import prepare as jax_prepare

    from posendf_torch.data import prepare
    from posendf_torch.data.synthetic import synthetic_manifold_poses

    corpus = synthetic_manifold_poses(np.random.default_rng(21), 512)
    jbm = JaxBodyModel(model=jax_synthetic_model(seed=3))
    tbm = BodyModel(model=smpl_model_from_jax(jbm.model), device="cpu")
    emb_j = jax_prepare._fk_joint_embedding(corpus[:64], jbm)
    emb_t = prepare._fk_joint_embedding(corpus[:64], tbm)
    assert tuple(emb_t.shape) == (64, 72)
    np.testing.assert_allclose(emb_t.numpy(), emb_j, rtol=0, atol=1e-5)
    kw = dict(num_queries=40, k=3, k_candidates=24, space="joints", precision="highest")
    want = jax_prepare.label_sequence(corpus[:16], jnp.asarray(corpus), body_model=jbm,
                                      rng=np.random.default_rng(5), fused=False, **kw)
    got = prepare.label_sequence(corpus[:16], corpus, body_model=tbm,
                                 rng=np.random.default_rng(5), device="cpu", **kw)
    np.testing.assert_array_equal(got["pose"], want["pose"])
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["nn_pose"], want["nn_pose"])


def test_space_joints_label_split_matches_jax(tmp_path):
    """``label_split(space="joints")``: the corpus embedded once for the
    split; the files JAX's writes."""
    from posendf_tpu.data import prepare as jax_prepare

    from posendf_torch.data import prepare
    from posendf_torch.data.synthetic import synthetic_manifold_poses

    rng = np.random.default_rng(22)
    for i in range(2):
        os.makedirs(tmp_path / "sampled" / "ACCAD", exist_ok=True)
        np.savez(tmp_path / "sampled" / "ACCAD" / f"s{i}.npz",
                 pose=synthetic_manifold_poses(rng, 200))
    jbm = JaxBodyModel(model=jax_synthetic_model(seed=3))
    tbm = BodyModel(model=smpl_model_from_jax(jbm.model), device="cpu")
    kw = dict(num_queries=6, runs=2, k=3, k_candidates=16, space="joints", seed=4)
    jax_prepare.label_split(str(tmp_path / "sampled"), str(tmp_path / "j"), ["ACCAD"],
                            body_model=jbm, fused=False, **kw)
    prepare.label_split(str(tmp_path / "sampled"), str(tmp_path / "t"), ["ACCAD"],
                        body_model=tbm, device="cpu", **kw)
    for i in range(2):
        with np.load(tmp_path / "j" / "ACCAD" / f"s{i}.npz") as j, \
                np.load(tmp_path / "t" / "ACCAD" / f"s{i}.npz") as t:
            np.testing.assert_array_equal(t["pose"], j["pose"])
            np.testing.assert_allclose(t["dist"], j["dist"], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(t["nn_pose"], j["nn_pose"])


# ------------------------------------------- the trained field, the golden

@pytest.fixture(scope="module")
def l8():
    field = posendf_torch.load_field(L8, device="cpu")
    return MotionDenoiser(field, BodyModel(device="cpu")), np.load(DENOISE_EXPECTED)


def test_l8_solve_matches_jax(l8):
    den, ref = l8
    init = den.body_model(pose_body=ref["noisy"])
    pose, hist = den._solve(init.body_pose[None], {"betas": init.betas,
                                                   "init_joints": init.Jtr[None]}, 2, 5)
    np.testing.assert_allclose(pose[0].numpy(), ref["solve_pose"], rtol=0, atol=5e-5)
    for k in ("pose_pr", "temp", "data", "total"):
        np.testing.assert_allclose(hist[k][:, 0].numpy(), ref[f"hist_{k}"], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got, _ = den.optimize(ref["noisy"], ref["gt"], iterations=2, steps_per_iter=5)
    np.testing.assert_array_equal(got.numpy(), pose[0].numpy())


def test_l8_noise_estimate_and_interpolation_match_jax(l8):
    den, ref = l8
    q = axis_angle_to_quaternion(torch.from_numpy(ref["noisy"][:, :63]).reshape(60, 21, 3))
    got = denoise.estimate_clip_noise(den.field, q, probe_noise=ref["probe_noise"])
    for k, want in zip(STAT_KEYS, ref["noise_stats"]):
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-4 if k[0] == "s" else 1e-6,
                                   err_msg=k)
    path, d = interpolate(den.field, ref["interp_a"], ref["interp_b"], num_steps=10,
                          projection_steps=10)
    np.testing.assert_allclose(path.numpy(), ref["interp_path"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), ref["interp_dist"], rtol=0, atol=1e-5)
