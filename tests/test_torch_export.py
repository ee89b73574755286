"""Serving export of the port (``posendf_torch/export.py`` and ``cli
export``), as ``tests/test_export.py`` holds the JAX package's: an artifact
round-trips through disk and reproduces the live plain paths it was traced
from (within 1e-6, the JAX tests' bar; the traced program runs the same
operations), with a symbolic or a static batch.

The traces take 2 example poses (torch.export would specialize an example
of size 0 or 1); a symbolic artifact then serves any batch, one pose too.
The artifacts are traced on the CPU (``--device cpu``); on the card they
are traced and served there (``chip_smoke.py`` phase 16).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch.cli import main  # noqa: E402
from posendf_torch.config import PoseNDFConfig  # noqa: E402
from posendf_torch.export import (export_forward, export_forward_int8,  # noqa: E402
                                  export_project, load_artifact, save_artifact)
from posendf_torch.field import Field, load_field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.projection import project  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "amass.yaml")
ATOL = 1e-6


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


def _model():
    return PoseNDF(activation="softplus", dfnet_dims=(32, 48),
                   generator=torch.Generator().manual_seed(3))


def _roundtrip(exp, tmp_path, name):
    path = str(tmp_path / name)
    save_artifact(exp, path)
    return load_artifact(path).module()


@pytest.mark.parametrize("batch", [None, 12])
def test_forward_artifact_roundtrip(batch, tmp_path):
    """Symbolic batch (the same artifact serves 12, 5 and 1 poses) and a
    static batch of 12."""
    m = _model()
    q = _poses(0, 12)
    served = _roundtrip(export_forward(m, batch=batch), tmp_path, "fwd.pt2")
    with torch.no_grad():
        torch.testing.assert_close(served(q), m(q), rtol=0, atol=ATOL)
        if batch is None:
            torch.testing.assert_close(served(q[:5]), m(q[:5]), rtol=0, atol=ATOL)
            torch.testing.assert_close(served(q[:1]), m(q[:1]), rtol=0, atol=ATOL)


def test_project_artifact_matches_live_solver(tmp_path):
    m = _model()
    q = _poses(1, 12)
    served = _roundtrip(export_project(m, steps=4), tmp_path, "proj.pt2")
    out, hist = served(q)
    ref_out, ref_hist = project(Field(m), q, steps=4, fused=False)
    assert hist.shape == (4, 12)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=ATOL)
    torch.testing.assert_close(hist, ref_hist, rtol=0, atol=ATOL)


def test_int8_artifact_roundtrip_symbolic_batch(tmp_path):
    """The int8 forward's artifact reproduces ``distance_ref`` at three batch
    sizes (one pose among them) and stays near the fp32 field (absolute bar of
    ``tests/test_export.py``: a fresh live-head field is near-constant)."""
    cfg = PoseNDFConfig()
    cfg.dfnet.live_head = True
    field = Field(cfg.make_model())
    qfield = field.quantize_int8(_poses(7, 512))
    served = _roundtrip(export_forward_int8(qfield), tmp_path, "int8.pt2")
    q = _poses(2, 24)
    torch.testing.assert_close(served(q), qfield.distance_ref(q), rtol=0, atol=ATOL)
    torch.testing.assert_close(served(q[:7]), qfield.distance_ref(q[:7]), rtol=0, atol=ATOL)
    torch.testing.assert_close(served(q[:1]), qfield.distance_ref(q[:1]), rtol=0, atol=ATOL)
    with torch.no_grad():
        assert float((served(q) - field.distance(q)).abs().mean()) < 1e-4


def test_load_rejects_foreign_files(tmp_path):
    path = str(tmp_path / "junk.bin")
    with open(path, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="artifact"):
        load_artifact(path)


def test_cli_export_and_serve(tmp_path, capsys):
    out = str(tmp_path / "model.pt2")
    main(["export", "-c", CFG, "--device", "cpu", "--out", out, "--what", "forward"])
    assert "exported forward" in capsys.readouterr().out
    d = load_artifact(out).module()(torch.ones((3, 21, 4)) / 2.0)
    assert d.shape == (3, 1) and bool((d >= 0).all())


def test_cli_export_int8_and_quantized_roundtrip(tmp_path, capsys):
    """Quantize + export + save in one call, then export again from the saved
    field: identical artifacts' outputs."""
    art1, art2 = str(tmp_path / "m.int8.pt2"), str(tmp_path / "m2.int8.pt2")
    qpath, calib = str(tmp_path / "field.int8.msgpack"), str(tmp_path / "calib.npz")
    np.savez(calib, pose=_poses(3, 256).numpy())
    main(["export", "-c", CFG, "--device", "cpu", "--out", art1, "--int8", "--calib", calib,
          "--save-quantized", qpath])
    out = capsys.readouterr().out
    assert "exported int8 forward" in out and "saved quantized field" in out
    main(["export", "--device", "cpu", "--out", art2, "--quantized", qpath])
    assert "exported int8 forward" in capsys.readouterr().out
    probe = torch.ones((3, 21, 4)) / 2.0
    d1, d2 = load_artifact(art1).module()(probe), load_artifact(art2).module()(probe)
    assert d1.shape == (3, 1)
    assert torch.equal(d1, d2)


def test_cli_export_int8_without_calib_warns(tmp_path, capsys):
    main(["export", "-c", CFG, "--device", "cpu", "--out", str(tmp_path / "w.pt2"), "--int8",
          "--batch", "4"])
    assert "WARNING: no --calib" in capsys.readouterr().out
    assert load_artifact(str(tmp_path / "w.pt2")).module()(_poses(0, 4)).shape == (4, 1)


def test_cli_export_int8_rejects_project(tmp_path):
    with pytest.raises(SystemExit, match="value"):
        main(["export", "-c", CFG, "--device", "cpu", "--out", str(tmp_path / "x"), "--int8",
              "--what", "project"])


def test_export_fused_config_is_portable(tmp_path):
    """A ``strenc.fused`` config exports through the plain encoder, with the
    same math, and keeps its fused flag afterwards."""
    cfg = PoseNDFConfig()
    cfg.dfnet.dims = [32, 48]
    cfg.dfnet.act = cfg.strenc.act = "softplus"
    cfg.strenc.fused = True
    field = load_field(config=cfg, device="cpu")
    assert field.module.enc.use_fused
    served = _roundtrip(export_forward(field.module), tmp_path, "fused_cfg.pt2")
    assert field.module.enc.use_fused
    q = _poses(4, 8)
    field.module.enc.use_fused = False
    with torch.no_grad():
        torch.testing.assert_close(served(q), field.module(q), rtol=0, atol=ATOL)


def test_cli_export_calib_key_and_width_handling(tmp_path, capsys):
    """AMASS 'poses' keys with 72-wide axis-angle rows (body joints from
    index 3) give the same quantization as the 63-wide 'pose_body' slice;
    unknown keys and widths exit with a message."""
    r = np.random.default_rng(9)
    full = r.normal(scale=0.2, size=(64, 72)).astype(np.float32)
    calib_full, calib_body = str(tmp_path / "full.npz"), str(tmp_path / "body.npz")
    np.savez(calib_full, poses=full)
    np.savez(calib_body, pose_body=full[:, 3:66])
    a1, a2 = str(tmp_path / "a1.pt2"), str(tmp_path / "a2.pt2")
    main(["export", "-c", CFG, "--device", "cpu", "--out", a1, "--int8", "--calib", calib_full])
    main(["export", "-c", CFG, "--device", "cpu", "--out", a2, "--int8", "--calib", calib_body])
    capsys.readouterr()
    probe = torch.ones((2, 21, 4)) / 2.0
    assert torch.equal(load_artifact(a1).module()(probe), load_artifact(a2).module()(probe))

    bad_key = str(tmp_path / "bad_key.npz")
    np.savez(bad_key, thetas=full)
    with pytest.raises(SystemExit, match="no recognized pose key"):
        main(["export", "-c", CFG, "--device", "cpu", "--out", str(tmp_path / "x"), "--int8",
              "--calib", bad_key])
    bad_width = str(tmp_path / "bad_width.npz")
    np.savez(bad_width, pose=full[:, :56])
    with pytest.raises(SystemExit, match="width"):
        main(["export", "-c", CFG, "--device", "cpu", "--out", str(tmp_path / "y"), "--int8",
              "--calib", bad_width])
