"""The encoder kernel ``posendf_encoder`` (``posendf_torch/csrc/
train_kernels.cu``), its packed weights and its split walk modelled on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 7 holds it to its
plain version there, ``ENC_ATOL = 1e-6``). Here:

  * ``fused_encoder.pack_encoder`` reads back to w1, b1, w2, b2 (a row of
    float4s a hidden unit or feature: its E input weights, its bias, zeros),
    and the wrapper's cache packs anew after an in-place change of any of
    them (as an optimizer step makes);
  * :func:`model_walk` runs the kernel's walk on numpy: two threads a pose,
    thread r summing the hidden units r, r + 2, ... and then the features
    r, r + 2, ... from the packed rows, one FMA a term in index order and
    then the bias (an FMA modelled as the float64 product and sum rounded
    once to float32), the hidden units exchanged whole between the two, the
    features of a joint read by its children. On the trained field's
    encoder weights it matches JAX's Pallas ``_encoder_kernel`` in TPU
    interpret mode within ``ENC_ATOL``, and the port's plain version too,
    for lrelu, relu and softplus (JAX sums each unit in another order:
    measured up to 8.3e-7 at features up to 2.9); on seeded weights of
    feature widths 1 and 8 it matches the plain version.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.kinematics import REFERENCE_PARENTS  # noqa: E402
from posendf_tpu.ops.fused_encoder import fused_structure_encoder as jax_fused_encoder  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.ops import fused_encoder  # noqa: E402
from posendf_torch.ops.fused_model import packed_once  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
SRC = os.path.join(ROOT, "posendf_torch", "csrc", "train_kernels.cu")
ENC_ATOL = 1e-6       # chip_smoke.py's bar of the kernel against its plain version


def _parts() -> int:
    for line in open(SRC):
        if line.startswith("constexpr int kEncParts = "):
            return int(line.split("=")[1].split(";")[0])
    raise AssertionError("kEncParts not found")


PARTS = _parts()


def _weights(seed=3, J=21, F=6):
    E = 4 + F
    rng = np.random.default_rng(seed)
    return [(s * rng.normal(size=shape)).astype(np.float32)
            for s, shape in ((0.5, (J, E, E)), (0.1, (J, E)), (0.5, (J, E, F)), (0.1, (J, F)))]


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _act(name, beta=np.float32(100.0)):
    if name == "lrelu":
        return lambda z: np.where(z >= 0, z, np.float32(0.01) * z).astype(np.float32)
    if name == "relu":
        return lambda z: np.where(z > 0, z, np.float32(0.0)).astype(np.float32)

    def softplus(z):
        bz = beta * z
        return ((np.maximum(bz, 0) + np.log1p(np.exp(-np.abs(bz)))) / beta).astype(np.float32)

    return softplus


def _unit(inp: np.ndarray, row: np.ndarray) -> np.ndarray:
    """z = sum_i in[i] row[i] from 0, one FMA a term in index order, then +
    the bias row[E]: inp (P, E), row (R,) -> (P,) float32."""
    E = inp.shape[1]
    z = np.zeros(inp.shape[0], np.float32)
    for i in range(E):
        z = (z.astype(np.float64) + inp[:, i].astype(np.float64) * np.float64(row[i])).astype(np.float32)
    return (z + row[E]).astype(np.float32)


def model_walk(q: np.ndarray, packed: np.ndarray, parents, act: str) -> np.ndarray:
    """The kernel's walk over poses q (P, J, 4) with the packed weights
    (J, E + F, R) -> (P, J * F) float32."""
    P, J = q.shape[:2]
    F = (packed.shape[1] - 4) // 2                 # E + F = 2 F + 4 rows a joint
    E = 4 + F
    f = _act(act)
    feats = np.zeros((P, J, F), np.float32)
    for j in range(J):
        par = parents[j]
        inp = np.concatenate([q[:, j], feats[:, par] if par >= 0 else np.zeros((P, F), np.float32)], 1)
        hid = np.zeros((P, E), np.float32)            # the pose's row of the exchange
        for r in range(PARTS):
            for u in range(r, E, PARTS):
                hid[:, u] = f(_unit(inp, packed[j, u]))
        for r in range(PARTS):
            for k in range(r, F, PARTS):
                feats[:, j, k] = f(_unit(hid, packed[j, E + k]))
    return feats.reshape(P, J * F)


def test_pack_reads_back():
    w1, b1, w2, b2 = map(torch.from_numpy, _weights())
    J, E, F = 21, 10, 6
    packed = fused_encoder.pack_encoder(w1, b1, w2, b2)
    assert packed.shape == (J, E + F, 12) and packed.is_contiguous()
    for j in range(J):
        for u in range(E):
            assert torch.equal(packed[j, u, :E], w1[j, :, u]) and packed[j, u, E] == b1[j, u]
        for k in range(F):
            assert torch.equal(packed[j, E + k, :E], w2[j, :, k]) and packed[j, E + k, E] == b2[j, k]
    assert not packed[:, :, E + 1:].any()


def test_pack_is_cached_and_follows_in_place_changes():
    w = tuple(torch.from_numpy(a).requires_grad_() for a in _weights(seed=5))

    def packed():
        return packed_once(fused_encoder._PACKED, w, fused_encoder.pack_encoder)

    first = packed()
    assert packed() is first
    with torch.no_grad():
        w[2][4, 3, 1] += 1.0                          # as an optimizer step changes a weight
    again = packed()
    assert again is not first
    assert torch.equal(again, fused_encoder.pack_encoder(*w))
    assert again[4, 10 + 1, 3] == w[2][4, 3, 1]


@pytest.fixture(scope="module")
def trained():
    """The trained field's encoder weights, which phase 7 holds the kernel
    with on the card (features up to about 3)."""
    enc = posendf_torch.load_field(L8, device="cpu").module.enc
    return [t.detach().numpy() for t in (enc.w1, enc.b1, enc.w2, enc.b2)]


@pytest.mark.parametrize("act", ["lrelu", "relu", "softplus"])
def test_model_of_the_split_walk_matches_jax(act, trained):
    q = _poses(0, 130)
    packed = fused_encoder.pack_encoder(*map(torch.from_numpy, trained)).numpy()
    got = model_walk(q, packed, REFERENCE_PARENTS, act)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_encoder(jnp.asarray(q), *trained, parents=REFERENCE_PARENTS,
                                            activation=act, tile_b=128))
    plain = fused_encoder.fused_structure_encoder(
        torch.from_numpy(q), *map(torch.from_numpy, trained), parents=REFERENCE_PARENTS,
        activation=act).numpy()
    err_jax, err_plain = np.abs(got - want).max(), np.abs(got - plain).max()
    print(f"{act}: model vs JAX {err_jax:.3e}, vs the plain version {err_plain:.3e}")
    assert np.abs(want).max() > 1.0
    assert err_jax <= ENC_ATOL and err_plain <= ENC_ATOL


@pytest.mark.parametrize("F", [1, 8])
def test_model_at_other_feature_widths(F):
    """The kernel's template widths at the ends of its range, against the
    plain version."""
    w = _weights(seed=F, F=F)
    q = _poses(1, 9)
    packed = fused_encoder.pack_encoder(*map(torch.from_numpy, w)).numpy()
    assert packed.shape[-1] == (4 + F + 4) // 4 * 4
    got = model_walk(q, packed, REFERENCE_PARENTS, "lrelu")
    plain = fused_encoder.fused_structure_encoder(
        torch.from_numpy(q), *map(torch.from_numpy, w), parents=REFERENCE_PARENTS).numpy()
    np.testing.assert_allclose(got, plain, atol=ENC_ATOL, rtol=0)
