"""The port's main path end to end against the JAX package.

checkpoint -> ``load_field`` -> ``distance_and_grad`` -> ``project``
(module path and ``fused=True``) -> ``cli generate``, on the CPU, where the
fused paths run their kernels' plain versions. The trained full-width field
``docs/quality/ckpt_l8_best.msgpack`` is held to the JAX-made values in
``tests/data/torch_port_l8_expected.npz`` (``scripts/make_torch_port_golden.py``)
-- the same file ``chip_smoke.py`` holds the CUDA kernels to -- and the small
golden field to ``examples/golden/expected.npz``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import posendf_tpu  # noqa: E402
from posendf_tpu.projection import project as jax_project  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.projection import make_projector, project, random_poses  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
L8_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_l8_expected.npz")
GOLDEN = os.path.join(ROOT, "examples", "golden")
PROJ = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def l8():
    return posendf_torch.load_field(L8, device="cpu"), np.load(L8_EXPECTED)


def test_import_loads_no_jax():
    code = ("import sys, posendf_torch, posendf_torch.field, posendf_torch.projection, "
            "posendf_torch.cli, posendf_torch.checkpoints, posendf_torch.losses, "
            "posendf_torch.ops.fused_encoder, posendf_torch.ops.fused_train, "
            "posendf_torch.ops.train_grad, posendf_torch.data.synthetic, "
            "posendf_torch.data.splits, posendf_torch.data.pipeline, "
            "posendf_torch.training.metrics, posendf_torch.training.checkpoints, "
            "posendf_torch.training.init_utils, posendf_torch.training.trainer, "
            "posendf_torch.ops.fused_int8, posendf_torch.ops.int8_probe, posendf_torch.export, "
            "posendf_torch.models.pos_encoder, posendf_torch.models.dfnet, "
            "posendf_torch.ops.fused_model, posendf_torch.ops.fused_grad, "
            "posendf_torch.quat, posendf_torch.smpl, posendf_torch.smpl.lbs, "
            "posendf_torch.smpl.body_model, posendf_torch.experiments, "
            "posendf_torch.experiments.optim, posendf_torch.experiments.denoise, "
            "posendf_torch.experiments.denoise_benchmark, "
            "posendf_torch.experiments.interpolate, posendf_torch.experiments.render\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "{'jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'yaml', 'PIL', 'posendf_tpu'})\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_l8_distance_and_grad_reproduce_jax(l8):
    field, ref = l8
    probes = torch.from_numpy(ref["probes"])
    d, g = field.distance_and_grad(probes)
    np.testing.assert_allclose(d.detach().numpy(), ref["dist"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.detach().numpy(), ref["grad"], atol=1e-5, rtol=0)
    d, g = field.distance_and_grad_fused(probes)
    np.testing.assert_allclose(d.numpy(), ref["dist"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), ref["grad"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(field.distance_fused(probes).detach().numpy(), ref["dist"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_l8_projection_reproduces_jax(l8, fused):
    field, ref = l8
    steps = ref["proj_hist"].shape[0]
    out, hist = project(field, torch.from_numpy(ref["probes"]), steps=steps, fused=fused)
    np.testing.assert_allclose(out.numpy(), ref["proj_out"], **PROJ)
    np.testing.assert_allclose(hist.numpy(), ref["proj_hist"], **PROJ)
    assert hist[-1].mean() < hist[0].mean()


def test_golden_field_reproduces_recorded_distances():
    """The same bar as ``tests/test_golden.py`` holds the JAX package to."""
    expected = np.load(os.path.join(GOLDEN, "expected.npz"))
    field = posendf_torch.load_field(os.path.join(GOLDEN, "golden.msgpack"),
                                     config=os.path.join(GOLDEN, "golden.yaml"), device="cpu")
    probes = torch.from_numpy(expected["probes"])
    d = field.distance(probes).detach().numpy()
    np.testing.assert_allclose(d, expected["dist"], atol=2e-4, rtol=2e-4)
    _, hist = project(field, probes[64:80], steps=20, fused=True)
    assert float(hist[-1].mean()) < 0.5 * float(hist[0].mean())


@pytest.mark.parametrize("mode", ["renorm", "no-renorm-fused"])
def test_cli_generate_matches_jax(tmp_path, mode):
    """``python -m posendf_torch.cli generate`` writes the poses it drew and
    their projection; the JAX package projects the same poses alike."""
    out = str(tmp_path / "gen.npz")
    argv = ["generate", "--ckpt", os.path.join(GOLDEN, "golden.msgpack"),
            "--config", os.path.join(GOLDEN, "golden.yaml"), "--num-poses", "24",
            "--steps", "4", "--seed", "3", "--out", out, "--device", "cpu"]
    if mode == "no-renorm-fused":
        argv += ["--no-renorm", "--fused"]
    cli.main(argv)
    got = np.load(out)
    jfield = posendf_tpu.load_field(os.path.join(GOLDEN, "golden.msgpack"),
                                    config=os.path.join(GOLDEN, "golden.yaml"))
    project_jit = jax.jit(jax_project, static_argnames=("module", "steps", "renormalize"))
    want_out, want_hist = project_jit(jfield.module, jfield.params,
                                      jnp.asarray(got["pose_init"]), steps=4,
                                      renormalize=mode == "renorm")
    np.testing.assert_allclose(got["pose"], np.asarray(want_out), **PROJ)
    np.testing.assert_allclose(got["dist_history"], np.asarray(want_hist), **PROJ)


def test_random_poses_and_projector():
    a = random_poses(torch.Generator().manual_seed(5), 8)
    b = random_poses(torch.Generator().manual_seed(5), 8, device="cpu")
    assert a.shape == (8, 21, 4) and torch.equal(a, b)
    torch.testing.assert_close(a.norm(dim=-1), torch.ones(8, 21))
    field = posendf_torch.load_field(os.path.join(GOLDEN, "golden.msgpack"),
                                     config=os.path.join(GOLDEN, "golden.yaml"), device="cpu")
    out, hist = make_projector(field, steps=3, fused=True)(a)
    ref_out, ref_hist = project(field, a, steps=3)
    torch.testing.assert_close(out, ref_out, **PROJ)
    torch.testing.assert_close(hist, ref_hist, **PROJ)
    empty_out, empty_hist = project(field, a, steps=0, fused=True)
    assert torch.equal(empty_out, a) and empty_hist.shape == (0, 8)


def test_cli_generate_writes_jax_meshes_and_renders(tmp_path, monkeypatch):
    """``generate --save-mesh --render`` on the golden field with the
    128-vertex ``BodyModel()``: the files JAX's ``generate`` writes for the
    same poses (its draw of the initial poses replaced by the port's), the
    same names, the meshes' vertices within 1e-5 and the faces equal."""
    import posendf_tpu.projection as jax_projection
    from posendf_tpu import cli as jax_cli

    common = ["--ckpt", os.path.join(GOLDEN, "golden.msgpack"), "--config",
              os.path.join(GOLDEN, "golden.yaml"), "--num-poses", "3", "--steps", "4",
              "--seed", "3", "--save-mesh", "--render"]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    cli.main(["generate", *common, "--device", "cpu", "--mesh-dir", str(port_dir),
              "--out", str(tmp_path / "gen.npz")])
    init = jnp.asarray(np.load(tmp_path / "gen.npz")["pose_init"])
    monkeypatch.setattr(jax_projection, "random_poses", lambda key, n: init)
    jax_cli.main(["generate", *common, "--mesh-dir", str(jax_dir)])

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    names = files(port_dir)
    assert names == files(jax_dir)
    assert [n for n in names if n.startswith("meshes/")] == [
        f"meshes/{p}_{i:04d}.obj" for p in ("init", "out") for i in range(3)]
    assert len([n for n in names if n.startswith("render/")]) == 6

    def obj(path):
        lines = path.read_text().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        f = [ln for ln in lines if ln.startswith("f ")]
        return v, f

    for n in names:
        if n.endswith(".obj"):
            (v, f), (jv, jf) = obj(port_dir / n), obj(jax_dir / n)
            assert v.shape == jv.shape and len(v) == 128 and f == jf
            np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5, err_msg=n)
