"""The port's camera and image fitting against the JAX package's, on the CPU.

``init_camera`` and ``project_points`` (the depth guard with a negative z
too), stage 1's gradient at ``cam_rot = 0`` against ``jax.grad`` (through
``axis_angle_to_matrix`` at the zero rotation), the three-stage
``ImageFitter.optimize`` for both prior forms and with the camera's rotation
fixed (2 x 5 steps a stage; the port given JAX's stage-2 draw), the OpenPose
tables of the 24-row and the 45-row body, ``project_result_keypoints``,
``save_keypoint_overlay``, ``cli fit-image`` against the JAX CLI on the
golden field, and the trained field ``docs/quality/ckpt_l8_best.msgpack``
with the 128-vertex body against ``tests/data/torch_port_partial_expected.npz``
(``scripts/make_torch_port_partial_golden.py``). Small sizes otherwise: the
seeded softplus field of ``tests/test_torch_experiments.py``, an 80-vertex
synthetic body; keypoints rendered from known poses through a camera
rotated ~17 degrees, as ``tests/test_experiments.py`` renders them.

Bars, each beside the deviation it measured on the CPU (fp32 on both sides,
sums in another order):
  * the projection rtol 1e-6 and atol 1e-3 pixels of values up to ~1e3
    (measured 3.3e-7 relative, 3.7e-4 pixels; the guarded depths 2.1e-7
    relative);
  * stage 1's gradient atol 1e-4 of each leaf's largest entry (measured
    1.1e-7 relative), axis_angle_to_matrix's Jacobian at the zero rotation
    rtol 1e-6 (measured 1.2e-7);
  * the fit ('reference' prior, the camera's rotation free or fixed): every
    result atol 2e-5 (measured 1.6e-6 in the pose), metrics rtol 1e-4
    (measured 9.5e-6 relative);
  * the 'self' prior: stages 1 and 2 as above (measured 5.0e-5 relative in
    stage 2's final prior, of 1.4e-11), but stage 3 starts where the
    self-weighted prior's gradient (~1e-13) is far below Adam's eps and the
    data term sits at its smoothed kink, so its first steps' directions are
    rounding: a one-ulp change of the keypoints moves JAX's final pose by
    1.7e-3 (B = 1) to 3.0e-2 (B = 2), and the port's likewise. Its final
    pose is held to JAX's within twice the port's own one-ulp spread
    (measured 7.6e-3);
  * the CLI: every result atol 2e-5 (measured 9.5e-7), metrics rtol 1e-4
    (measured 1.9e-7);
  * the trained field: the result atol 5e-5 (measured 1.3e-7), the metrics
    rtol 1e-4 (measured 1.4e-7).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.experiments import ImageFitter as JaxFitter  # noqa: E402
from posendf_tpu.experiments import camera as jax_camera  # noqa: E402
from posendf_tpu.experiments import fit_image as jax_fit  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.quat import axis_angle_to_matrix as jax_aa_to_matrix  # noqa: E402
from posendf_tpu.smpl import BodyModel as JaxBodyModel  # noqa: E402
from posendf_tpu.smpl import synthetic_model as jax_synthetic_model  # noqa: E402
from posendf_tpu.smpl.lbs import lbs_forward as jax_lbs  # noqa: E402
from posendf_tpu.smpl.lbs import with_landmarks as jax_with_landmarks  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.checkpoints import params_from_jax, smpl_model_from_jax  # noqa: E402
from posendf_torch.experiments import camera, fit_image  # noqa: E402
from posendf_torch.experiments.fit_image import ImageFitter  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.quat import axis_angle_to_matrix  # noqa: E402
from posendf_torch.smpl import BodyModel  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
PARTIAL_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_partial_expected.npz")
GOLDEN = os.path.join(ROOT, "examples", "golden")
RESULT_KEYS = ("pose_body", "global_orient", "betas", "camera_translation", "camera_rotation")
CAM_ROT = (0.2, -0.15, 0.1)
CENTER = np.asarray([64.0, 48.0], np.float32)


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
    """(JAX, port) bodies: 80 vertices (24 Jtr rows) and SMPL's 6,890 (45)."""
    out = {}
    for name, verts in (("24", 80), ("45", 6890)):
        jm = jax_synthetic_model(num_vertices=verts, seed=1)
        out[name] = (JaxBodyModel(model=jm), BodyModel(model=smpl_model_from_jax(jm), device="cpu"))
    return out


def _keypoints(jbody, B, seed=3):
    """(B, 25, 3) keypoints of B poses rendered through a camera 10 m away,
    rotated by the axis-angle CAM_ROT, with CENTER the principal point."""
    gt_pose = np.random.default_rng(seed).normal(scale=0.15, size=(B, 69)).astype(np.float32)
    cam = {"rotation": jnp.tile(jax_aa_to_matrix(jnp.asarray([CAM_ROT])), (B, 1, 1)),
           "translation": jnp.tile(jnp.asarray([[0.0, 0.0, 10.0]]), (B, 1))}
    table = jax_fit.SMPL_TO_OPENPOSE
    gather = np.where(table >= 0, table, 0)
    xy = np.asarray(jax_camera.project_points(cam, jbody(pose_body=jnp.asarray(gt_pose)).Jtr[
        :, gather], 5000.0, jnp.tile(jnp.asarray(CENTER)[None], (B, 1))))
    conf = np.broadcast_to((table >= 0).astype(np.float32)[None, :, None], (B, 25, 1))
    return np.concatenate([xy, conf], axis=2).astype(np.float32)


def _jax_draw(B):
    return np.asarray(1e-2 * jax.random.normal(jax.random.key(0), (B, 69)))


class DrawFitter(ImageFitter):
    """The port's fitter given JAX's stage-2 draw."""

    def _stage2_pose(self, B):
        return torch.from_numpy(_jax_draw(B)).to(self.device)


# ----------------------------------------------------------------- camera

def test_project_points_matches_jax():
    """Random points, depths of 1e-9, -1e-9, -2e-8 and 0 among them (a
    depth within 1e-8 of 0, either sign, is taken as +1e-8), with and
    without a principal point."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 9, 3)).astype(np.float32)
    pts[..., 2] += 10.0
    pts[0, :4, 2] = [1e-9, -1e-9, -2e-8, 0.0]
    cam_np = {"rotation": np.array(jax_aa_to_matrix(jnp.asarray(
        rng.normal(scale=0.3, size=(3, 3)).astype(np.float32)))),
        "translation": np.zeros((3, 3), np.float32)}
    center = rng.normal(scale=50.0, size=(3, 2)).astype(np.float32)
    for c in (None, center):
        want = np.asarray(jax_camera.project_points(
            {k: jnp.asarray(v) for k, v in cam_np.items()}, jnp.asarray(pts), 5000.0,
            None if c is None else jnp.asarray(c)))
        got = camera.project_points({k: torch.from_numpy(v) for k, v in cam_np.items()},
                                    torch.from_numpy(pts), 5000.0,
                                    None if c is None else torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-6, atol=1e-3)
        # the guarded depths: x / 1e-8 for |z| < 1e-8, x / z beyond
        np.testing.assert_allclose(got[0, :4], want[0, :4], rtol=1e-6)
    guarded = camera.project_points({"rotation": torch.eye(3)[None],
                                     "translation": torch.zeros((1, 3))},
                                    torch.tensor([[[1.0, 1.0, -1e-9]]]), 1.0)
    np.testing.assert_allclose(guarded.numpy(), [[[1e8, 1e8]]], rtol=1e-6)


def test_init_camera_matches_jax():
    want = jax_camera.init_camera(4)
    got = camera.init_camera(4, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            camera.init_camera(1)


# ------------------------------------------------ stage 1 at cam_rot = 0

def test_axis_angle_to_matrix_jacobian_at_zero_matches_jax():
    """The double-where guard: finite, and JAX's derivative, at the zero
    rotation (the skew generators) and just off it."""
    for aa in (np.zeros(3, np.float32), np.asarray([1e-7, -2e-7, 5e-8], np.float32)):
        want = np.asarray(jax.jacfwd(jax_aa_to_matrix)(jnp.asarray(aa)))
        got = torch.autograd.functional.jacobian(axis_angle_to_matrix, torch.from_numpy(aa))
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_stage1_gradient_at_zero_rotation_matches_jax(pair, bodies):
    """Stage 1's weighted total (data + 100 depth at iteration 0) at its
    start, ``cam_rot`` exact zeros: every leaf's gradient against
    ``jax.grad`` of the same terms written with the JAX package."""
    _, _, field = pair
    jb, tb = bodies["24"]
    kp = _keypoints(jb, 2)
    B = 2
    p0 = {"translation": np.tile(np.asarray([[0.0, 0.0, 10.0]], np.float32), (B, 1)),
          "global_orient": np.zeros((B, 3), np.float32), "cam_rot": np.zeros((B, 3), np.float32)}
    torso = np.asarray(jax_fit.TORSO_OPENPOSE_IDXS)
    center = np.tile(CENTER[None], (B, 1))
    jfitter = JaxFitter(None, None, jb)

    def jax_total(p):
        verts, joints = jax_lbs(jb.model, jnp.zeros((B, 10)), p["global_orient"],
                                jnp.zeros((B, 69)))
        joints = jax_with_landmarks(verts, joints)
        cam = {"rotation": jax_aa_to_matrix(p["cam_rot"]), "translation": p["translation"]}
        proj = jax_camera.project_points(cam, jfitter._mapped_joints(joints), 5000.0,
                                         jnp.asarray(center))
        err = jnp.sum((proj[:, torso] - jnp.asarray(kp[..., :2])[:, torso]) ** 2)
        return err + 100.0 * jnp.sum((p["translation"][:, 2] - 10.0) ** 2)

    want = jax.jit(jax.grad(jax_total))({k: jnp.asarray(v) for k, v in p0.items()})
    fitter = ImageFitter(field, tb)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p0.items()}
    terms = fitter._stage1_terms(p, {"center": torch.from_numpy(center),
                                     "gt_xy": torch.from_numpy(kp[..., :2])})
    assert set(terms) == set(fit_image.STAGE1_SPECS)
    total = terms["data"] + 100.0 * terms["depth"]
    np.testing.assert_allclose(float(total.detach()), float(jax.jit(jax_total)(
        {k: jnp.asarray(v) for k, v in p0.items()})), rtol=1e-6)
    grads = torch.autograd.grad(total, list(p.values()))
    for k, g in zip(p, grads):
        w = np.asarray(want[k])
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert np.abs(np.asarray(want["cam_rot"])).max() > 0


# ------------------------------------------------------------------ the fit

def _ulp_spread(fit, kp):
    base = fit(kp)
    moved = (fit(np.nextafter(kp, np.float32(s)).astype(np.float32)) for s in (np.inf, -np.inf))
    return max(float(np.abs(m - base).max()) for m in moved)


@pytest.mark.parametrize("form, rot, B", [("reference", True, 2), ("self", True, 1),
                                          ("reference", False, 1)])
def test_fit_matches_jax(pair, bodies, form, rot, B):
    """The three stages, 2 x 5 steps each, of B keypoint sets: the result
    and the metrics; stage 1 leaves the identity when the rotation is free
    and its torso error falls below its start."""
    jm, params, field = pair
    jb, tb = bodies["24"]
    kp = _keypoints(jb, B)
    kw = dict(iterations=2, steps_per_iter=5, center=CENTER)
    want, want_m = JaxFitter(jm, params, jb, prior_form=form,
                             optimize_camera_rotation=rot).optimize(kp, **kw)
    fitter = DrawFitter(field, tb, prior_form=form, optimize_camera_rotation=rot)
    got, got_m = fitter.optimize(kp, **kw)
    assert set(got) == set(want) == set(RESULT_KEYS)
    assert set(fitter._solvers) == {(B, 2, 5)}
    for k in RESULT_KEYS:
        bar = 2e-5
        if form == "self" and k == "pose_body":
            bar = max(bar, 2 * _ulp_spread(lambda x: fitter.optimize(x, **kw)[0][k].numpy(), kp))
        assert tuple(got[k].shape) == tuple(np.shape(want[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=bar,
                                   err_msg=k)
    for k in want_m:
        if form == "self" and k == "stage3_final_prior":
            continue
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, atol=1e-12, err_msg=k)
    rot_out = got["camera_rotation"].numpy()
    assert rot == (not np.allclose(rot_out, np.eye(3), atol=1e-3))
    # stage 1's torso error at its start (identity camera, zero orientation)
    start = fitter._stage1_terms(
        {"translation": torch.tensor([[0.0, 0.0, 10.0]] * B),
         "global_orient": torch.zeros((B, 3)), "cam_rot": torch.zeros((B, 3))},
        {"rot0": torch.eye(3).repeat(B, 1, 1), "center": torch.from_numpy(np.tile(CENTER, (B, 1))),
         "gt_xy": torch.from_numpy(kp[..., :2])})["data"]
    assert got_m["stage1_final_data"] < float(start)


def test_fitter_refusals_and_cache(pair, bodies):
    _, _, field = pair
    _, tb = bodies["24"]
    with pytest.raises(ValueError, match="prior_form"):
        ImageFitter(field, tb, prior_form="linear")
    fitter = ImageFitter(field, tb)
    a = fitter._get_solvers(1, 2, 3)
    assert fitter._get_solvers(1, 2, 3) is a and fitter._get_solvers(2, 2, 3) is not a
    draw = fitter._stage2_pose(3)
    assert tuple(draw.shape) == (3, 69) and float(draw.abs().max()) < 0.1
    assert torch.equal(draw, ImageFitter(field, tb)._stage2_pose(3))


# ------------------------------------------------ tables and keypoints

@pytest.mark.parametrize("rows", ["24", "45"])
def test_mapped_joints_and_result_keypoints_match_jax(bodies, rows):
    """The table is chosen by the Jtr rows (45: every BODY_25 slot real);
    ``project_result_keypoints`` of a result through its camera."""
    jb, tb = bodies[rows]
    rng = np.random.default_rng(5)
    B = 2
    result = {"pose_body": rng.normal(scale=0.2, size=(B, 69)).astype(np.float32),
              "global_orient": rng.normal(scale=0.2, size=(B, 3)).astype(np.float32),
              "betas": rng.normal(scale=0.5, size=(B, 10)).astype(np.float32),
              "camera_translation": np.tile(np.asarray([[0.1, -0.2, 9.0]], np.float32), (B, 1)),
              "camera_rotation": np.asarray(jax_aa_to_matrix(jnp.asarray([CAM_ROT] * B)))}
    jfitter, tfitter = JaxFitter(None, None, jb), ImageFitter(posendf_torch.Field(PoseNDF()), tb)
    joints = rng.normal(size=(B, int(rows), 3)).astype(np.float32)
    np.testing.assert_array_equal(tfitter._mapped_joints(torch.from_numpy(joints)).numpy(),
                                  np.asarray(jfitter._mapped_joints(jnp.asarray(joints))))
    want = jax_fit.project_result_keypoints(jfitter, {k: jnp.asarray(v) for k, v in result.items()},
                                            center=CENTER)
    got = fit_image.project_result_keypoints(
        tfitter, {k: torch.from_numpy(v) for k, v in result.items()}, center=CENTER)
    assert got.shape == (B, 25, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


def test_save_keypoint_overlay(tmp_path, monkeypatch):
    pil = pytest.importorskip("PIL.Image")
    pil.new("RGB", (64, 48)).save(tmp_path / "img.jpg")
    xy = np.asarray([[[10.0, 12.0], [np.nan, 3.0], [40.0, 30.0]]], np.float32)
    out = fit_image.save_keypoint_overlay(str(tmp_path / "img.jpg"), str(tmp_path / "o.png"), xy,
                                          gt_xy=xy + 2.0)
    assert out == str(tmp_path / "o.png") and os.path.exists(out)
    img = np.asarray(pil.open(out))
    assert img.shape == (48, 64, 3) and img.max() > 0
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert fit_image.save_keypoint_overlay(str(tmp_path / "img.jpg"), str(tmp_path / "n.png"),
                                           xy) is None


# -------------------------------------------------------------------- CLI

def test_cli_fit_image_matches_jax(tmp_path, capsys, monkeypatch):
    """``cli fit-image`` (10 x 10 steps a stage, the 'reference' prior) on
    the golden field, the draw patched on the class: the result JAX's CLI
    writes, the metrics it prints; ``img.jpg`` sets the principal point."""
    from posendf_tpu.cli import main as jax_main

    pil = pytest.importorskip("PIL.Image")
    folder = tmp_path / "img"
    folder.mkdir()
    kp = _keypoints(JaxBodyModel(), 1, seed=6)[0] - np.asarray([*CENTER, 0.0], np.float32) \
        + np.asarray([40.0, 30.0, 0.0], np.float32)
    np.savez(folder / "kpts.npz", **{"0": kp})
    pil.new("RGB", (80, 60)).save(folder / "img.jpg")
    monkeypatch.setattr(ImageFitter, "_stage2_pose",
                        lambda self, B: torch.from_numpy(_jax_draw(B)).to(self.device))
    args = ["fit-image", "--ckpt", os.path.join(GOLDEN, "golden.msgpack"), "--config",
            os.path.join(GOLDEN, "golden.yaml"), "--image-folder", str(folder)]
    jax_main(args + ["--out", str(tmp_path / "j.npz")])
    jax_out = capsys.readouterr().out
    cli.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu", "--save-mesh",
                     "--mesh-dir", str(tmp_path / "m")])
    out = capsys.readouterr().out
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert set(t.files) == set(j.files) == set(RESULT_KEYS)
        for k in RESULT_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=2e-5, err_msg=k)

    def metrics(text):
        return {ln.split(":")[0]: float(ln.split(":")[1]) for ln in text.splitlines()
                if ln.startswith("stage")}

    want, got = metrics(jax_out), metrics(out)
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-12, err_msg=k)
    assert os.listdir(tmp_path / "m" / "meshes") == ["fit_0000.obj"]
    assert os.path.exists(tmp_path / "m" / "overlay.png")


# ------------------------------------------- the trained field, the golden

def test_l8_fit_matches_jax():
    ref = np.load(PARTIAL_EXPECTED)
    field = posendf_torch.load_field(L8, device="cpu")

    class GoldenDraw(ImageFitter):
        def _stage2_pose(self, B):
            return torch.from_numpy(ref["stage2_draw"][:B])

    got, got_m = GoldenDraw(field, BodyModel(device="cpu")).optimize(
        ref["keypoints"], iterations=2, steps_per_iter=5, center=ref["center"])
    for k in RESULT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[f"fit_{k}"], rtol=0, atol=5e-5, err_msg=k)
    for k, want in zip(("stage1_final_data", "stage2_final_data", "stage2_final_prior",
                        "stage3_final_prior"), ref["fit_metrics"]):
        np.testing.assert_allclose(got_m[k], want, rtol=1e-4, atol=1e-12, err_msg=k)
