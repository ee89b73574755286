"""The port's int8 serving path against the JAX package on the same inputs.

``posendf_torch.ops.fused_int8`` (quantization, the plain int8 forward the
CUDA kernel is held to on the card), ``QuantizedField`` and its files,
``checkpoints.msgpack_serialize`` and ``quat.axis_angle_to_quaternion``.
JAX's Pallas int8 kernel runs here in TPU interpret mode, as
``tests/test_fused_int8.py`` runs it.

Tolerances:
  * int8 distances within 1e-5 (JAX's own kernel-vs-reference bar), except
    poses with an input of the first int8 layer within 3e-5 of a rounding
    boundary (``fused_int8.boundary_flips``): the two packages' fp32 sums of
    the encoder and layer 0 differ in order, and such an input can round to
    the next level; those poses are held, within 1e-5, to the port's d with
    that level moved. Each test prints how many poses needed it.
  * quantization: dq within rtol 1e-6; the activation scales sa = 1/inv_sa
    within 1e-6 x the layer's largest (the calibration maxima are fp32 sums
    whose rounding is relative to their terms, not to a small result: a
    nearly dead channel's scale moves by more than 1e-6 of itself); wq equal
    but for a few entries one level apart (a folded weight on a rounding
    boundary).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.field import Field as JaxField  # noqa: E402
from posendf_tpu.field import QuantizedField as JaxQuantizedField  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.ops import fused_int8 as jax_int8  # noqa: E402
from posendf_tpu.quat import axis_angle_to_quaternion as jax_aa2q  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import msgpack_serialize, params_from_jax  # noqa: E402
from posendf_torch.field import Field, QuantizedField  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_int8  # noqa: E402
from posendf_torch.quat import axis_angle_to_quaternion  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_int8_expected.npz")
DIMS = (128, 256, 128)   # window (1, 3): layers 128->256 and 256->128 in int8
D_ATOL = 1e-5


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def small():
    """(JAX module, JAX params, port PoseNDF) with identical weights, a live
    head (a fresh lrelu head is 0 everywhere), and JAX's qparams on 512
    calibration poses."""
    jm = JaxPoseNDF(dfnet_dims=DIMS, live_head=True)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = PoseNDF(dfnet_dims=DIMS, live_head=True)
    tm.load_state_dict(params_from_jax(params))
    calib = _poses(7, 512)
    jq = jax_int8.quantize_posendf(params["enc"], params["dfnet"], jnp.asarray(calib),
                                   parents=jm.parents, activation=jm.activation, beta=jm.beta)
    return jm, params, tm, calib, jq


def _hold(d, d_ref, q, qparams, name):
    r = fused_int8.hold_to_ref(torch.as_tensor(np.array(d)), torch.as_tensor(np.array(d_ref)),
                               torch.as_tensor(q), qparams, parents=posendf_torch.PoseNDF().parents,
                               atol=D_ATOL)
    print(f"{name}: max |err| {r['max_abs_err']:.3e}; {r['one_level']} poses held to a moved "
          f"level (up to {r['one_level_max']:.3e})")
    return r


def _check_qparams(port, jq, max_level_flips):
    """The port's quantization of the same weights and poses against JAX's
    (tolerances in the module docstring)."""
    assert port["window"] == tuple(jq["window"])
    assert port["report"]["floored_channels"] == list(jq["report"]["floored_channels"])
    np.testing.assert_allclose(port["report"]["w_absmax"], jq["report"]["w_absmax"], rtol=0)
    flips = 0
    for lp, lj in zip(port["layers"], jq["layers"]):
        if "w" in lj:
            np.testing.assert_array_equal(lp["w"].numpy(), np.asarray(lj["w"]))
            continue
        np.testing.assert_allclose(lp["dq"].numpy(), np.asarray(lj["dq"]), rtol=1e-6, atol=0)
        sa_p, sa_j = 1.0 / lp["inv_sa"].double().numpy(), 1.0 / np.asarray(lj["inv_sa"], np.float64)
        assert np.abs(sa_p - sa_j).max() <= 1e-6 * sa_j.max()
        diff = np.abs(lp["wq"].numpy().astype(int) - np.asarray(lj["wq"]).astype(int))
        assert diff.max() <= 1
        flips += int(diff.sum())
    print(f"wq entries one level apart: {flips}")
    assert flips <= max_level_flips


@pytest.mark.parametrize("dims_in,dims_out,want", [
    ([126, 256, 512, 1024, 512, 256, 64], [256, 512, 1024, 512, 256, 64, 1], (1, 5)),
    ([126, 128, 256, 128, 64], [128, 256, 128, 64, 1], (1, 3)),
    ([126, 60], [60, 1], (0, 0)),
    ([128, 128, 64, 128, 256, 256], [128, 64, 128, 256, 256, 1], (3, 5)),
])
def test_int8_window_matches_jax(dims_in, dims_out, want):
    assert fused_int8.int8_window(dims_in, dims_out) == want
    assert jax_int8.int8_window(dims_in, dims_out) == want


def test_quantize_matches_jax(small):
    jm, params, tm, calib, jq = small
    enc = {k: getattr(tm.enc, k) for k in ("w1", "b1", "w2", "b2")}
    dfnet = dict(tm.dfnet.named_parameters())
    port = fused_int8.quantize_posendf(enc, dfnet, torch.from_numpy(calib), parents=tm.parents,
                                       activation=tm.activation, beta=tm.beta)
    assert port["window"] == (1, 3)
    for l in (1, 2):
        assert port["layers"][l]["wq"].dtype == torch.int8
        assert port["layers"][l]["dq"].shape == (1, DIMS[l])
        assert port["layers"][l]["inv_sa"].shape == (1, DIMS[l - 1])
    _check_qparams(port, jax.tree_util.tree_map(np.asarray, jq), max_level_flips=8)


def test_plain_forward_matches_jax_reference_and_kernel(small):
    """The plain int8 forward on JAX's own qparams (carried over) against
    ``reference_int8_forward`` and the interpret-mode Pallas kernel; B = 300
    is ragged for the tile of 128."""
    jm, params, tm, calib, jq = small
    qp = fused_int8.qparams_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    q = _poses(1, 300)
    kw = dict(parents=jm.parents, activation=jm.activation, beta=jm.beta)
    want = np.asarray(jax_int8.reference_int8_forward(jnp.asarray(q), jq, **kw))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jax_int8.fused_posendf_forward_int8(jnp.asarray(q), jq, tile_b=128, **kw))
    got = fused_int8.fused_posendf_forward_int8(torch.from_numpy(q), qp, **kw)
    assert got.shape == (300, 1) and np.ptp(want) > 1e-6
    _hold(got, want, q, qp, "plain vs reference_int8_forward")
    _hold(got, kern, q, qp, "plain vs the interpret-mode kernel")


def test_quantized_field_api_and_roundtrip(small, tmp_path):
    jm, params, tm, calib, jq = small
    qfield = Field(tm).quantize_int8(torch.from_numpy(calib[:256]))
    assert qfield.qparams["window"] == (1, 3)
    q = torch.from_numpy(_poses(4, 64))
    d = qfield.distance(q)
    assert d.shape == (64, 1)
    torch.testing.assert_close(d, qfield.distance_ref(q), rtol=0, atol=0)
    assert qfield.distance(q.reshape(64, 84)).shape == (64, 1)
    path = str(tmp_path / "field.int8.msgpack")
    qfield.save(path)
    assert not os.path.exists(path + ".tmp")
    loaded = QuantizedField.load(path, device="cpu")
    assert loaded.qparams["window"] == (1, 3)
    assert loaded.qparams["report"] == qfield.qparams["report"]
    assert loaded.module.parents == tuple(tm.parents)
    for a, b in zip(loaded.qparams["layers"], qfield.qparams["layers"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(loaded.distance(q), d)
    with pytest.raises(RuntimeError, match="value-only"):
        qfield.distance(q.clone().requires_grad_(True))


def test_quantized_field_files_cross_packages(small, tmp_path):
    """A JAX-saved file loads in the port (same arrays, and the port writes
    it back to the byte), and a port-saved file loads in the JAX package."""
    jm, params, tm, calib, jq = small
    jfield = JaxField(jm, params).quantize_int8(jnp.asarray(calib))
    jpath = str(tmp_path / "jax.int8.msgpack")
    jfield.save(jpath)
    ported = QuantizedField.load(jpath, device="cpu")
    for a, b in zip(ported.qparams["layers"], jfield.qparams["layers"]):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    ppath = str(tmp_path / "port.int8.msgpack")
    ported.save(ppath)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()

    own = Field(tm).quantize_int8(torch.from_numpy(calib))
    own.save(ppath)
    back = JaxQuantizedField.load(ppath)
    assert tuple(back.qparams["window"]) == (1, 3)
    assert back.module.parents == tuple(tm.parents)
    q = _poses(6, 128)
    d_jax = np.asarray(back.distance_xla(jnp.asarray(q)))
    np.testing.assert_allclose(own.distance(torch.from_numpy(q)).numpy(), d_jax, atol=D_ATOL, rtol=0)


def test_quantized_field_load_rejects_other_files(tmp_path):
    path = str(tmp_path / "notafield.msgpack")
    with open(path, "wb") as f:
        f.write(b"\x82\xa5magic\xa3nah\xa1x\x01")
    with pytest.raises(ValueError, match="int8 field"):
        QuantizedField.load(path, device="cpu")
    with open(path, "wb") as f:
        f.write(b"not msgpack at all")
    with pytest.raises(ValueError, match="int8 field"):
        QuantizedField.load(path, device="cpu")
    with pytest.raises(ValueError, match="int8 field"):    # an fp32 checkpoint
        QuantizedField.load(L8, device="cpu")


def test_msgpack_serialize_writes_flax_bytes():
    from flax.serialization import msgpack_serialize as flax_serialize

    tree = {"magic": "posendf-int8-v1", "n": 21, "neg": -5, "big": 70_000, "nbig": -200,
            "beta": 100.0, "flag": True, "none": None, "name": "x" * 40,
            "lst": [-1, 0, 0] + list(range(20)), "f32": np.float32(2.5),
            "arr": {str(i): np.arange(-64, 64, dtype=np.int8).reshape(8, 16) for i in range(3)},
            "w": np.linspace(-1, 1, 21 * 100, dtype=np.float32).reshape(21, 10, 10)}
    assert msgpack_serialize(tree) == flax_serialize(tree)


def test_trained_checkpoint_survives_quantization():
    """The bars of ``tests/test_fused_int8.py:190-201`` on the port's own
    quantization and plain int8 forward of the trained L = 8 field."""
    field = posendf_torch.load_field(L8, device="cpu")
    rng = np.random.default_rng(11)
    qfield = field.quantize_int8(torch.from_numpy(_poses_rng(rng, 1024)))
    assert qfield.qparams["window"] == (1, 5)
    probes = torch.from_numpy(_poses_rng(rng, 2048))
    with torch.no_grad():
        d32 = field.distance(probes).numpy().ravel()
    d8 = qfield.distance(probes).numpy().ravel()
    mae = float(np.mean(np.abs(d8 - d32)))
    assert mae < 0.03 * max(float(np.std(d32)), 1e-6), mae
    assert float(np.corrcoef(d8, d32)[0, 1]) > 0.998
    r32, r8 = (np.argsort(np.argsort(v)).astype(np.float64) for v in (d32, d8))
    assert float(np.corrcoef(r32, r8)[0, 1]) > 0.995


def _poses_rng(rng, n):
    q = rng.normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_expected_file_from_the_jax_package():
    """``tests/data/torch_port_int8_expected.npz`` (the file ``chip_smoke.py``
    holds the kernel to): the plain forward on JAX's carried qparams against
    JAX's reference and interpret-mode kernel, and the port's quantization
    of the trained field against JAX's on the same calibration poses."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_int8_golden", os.path.join(ROOT, "scripts", "make_torch_port_int8_golden.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    z = np.load(EXPECTED)
    jq = {k[3:]: z[k] for k in z.files if k.startswith("qp/")}
    qp = fused_int8.qparams_from_numpy(jq)
    probes = z["probes"]
    np.testing.assert_array_equal(probes, golden.probe_poses())
    got = QuantizedField(posendf_torch.load_field(L8, device="cpu").module, qp).distance(
        torch.from_numpy(probes))
    _hold(got, z["d_ref"], probes, qp, "plain vs JAX reference (expected file)")
    _hold(got, z["d_kernel"], probes, qp, "plain vs JAX interpret kernel (expected file)")
    own = posendf_torch.load_field(L8, device="cpu").quantize_int8(
        torch.from_numpy(golden.calib_poses(int(z["seed"]), int(z["calib"]))))
    _check_qparams(own.qparams, fused_int8.qparams_to_numpy(qp), max_level_flips=16)


def test_axis_angle_to_quaternion_matches_jax():
    rng = np.random.default_rng(5)
    aa = np.concatenate([rng.normal(scale=1.5, size=(200, 3)), np.zeros((1, 3)),
                         rng.normal(scale=1e-8, size=(4, 3))]).astype(np.float32)
    want = np.asarray(jax_aa2q(jnp.asarray(aa)))
    got = axis_angle_to_quaternion(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_int8_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, small, tmp_path):
    """``QuantizedField.load`` and ``cli export`` default to the card and
    raise without one; the CPU asked for by name works."""
    from posendf_torch import cli

    jm, params, tm, calib, jq = small
    path = str(tmp_path / "f.int8.msgpack")
    Field(tm).quantize_int8(torch.from_numpy(calib[:64])).save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantizedField.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export", "--out", str(tmp_path / "a.pt2"), "--quantized", path])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export", "--out", str(tmp_path / "b.pt2")])
    assert QuantizedField.load(path, device="cpu").device.type == "cpu"
