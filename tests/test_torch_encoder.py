"""The port's fused structure encoder against the JAX package's, on the CPU.

``fused_structure_encoder`` runs its CUDA kernel for CUDA tensors and its
plain version (the level-scheduled encoder) for CPU tensors; the plain
version is held here to JAX's Pallas ``_encoder_kernel`` in TPU interpret
mode, as ``tests/test_fused_encoder.py`` runs it (a ragged batch of 300 at
tile 128, every activation, atol 1e-5). ``strenc.fused`` models give the
non-fused forward, and their gradients, the eikonal term's gradient of a
gradient included. The kernel runs only on the card (``chip_smoke.py``
phase 7 holds it to the plain version there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.kinematics import REFERENCE_PARENTS  # noqa: E402
from posendf_tpu.ops.fused_encoder import fused_structure_encoder as jax_fused_encoder  # noqa: E402
from tests.test_torch_training import _t, make_case  # noqa: E402

from posendf_torch.config import PoseNDFConfig  # noqa: E402
from posendf_torch.losses import training_loss  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_encoder  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _weights(seed=3):
    rng = np.random.default_rng(seed)
    return [(s * rng.normal(size=shape)).astype(np.float32)
            for s, shape in ((0.5, (21, 10, 10)), (0.1, (21, 10)), (0.5, (21, 10, 6)),
                             (0.1, (21, 6)))]


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("act", ["lrelu", "relu", "softplus"])
def test_fused_encoder_matches_jax_kernel(act):
    w = _weights()
    q = _poses(0, 300)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_encoder(jnp.asarray(q), *w, parents=REFERENCE_PARENTS,
                                            activation=act, tile_b=128))
    launches = fused_encoder.LAUNCHES
    got = fused_encoder.fused_structure_encoder(_t(q), *map(_t, w), parents=REFERENCE_PARENTS,
                                                activation=act)
    assert fused_encoder.LAUNCHES == launches
    assert got.shape == (300, 126)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_fused_encoder_rejects_what_the_kernel_does_not_take():
    w = [_t(a) for a in _weights()]
    q = _t(_poses(1, 4))
    with pytest.raises(ValueError, match="shape"):
        fused_encoder.fused_structure_encoder(q.reshape(4, 84), *w, parents=REFERENCE_PARENTS)
    with pytest.raises(TypeError, match="float32"):
        fused_encoder.fused_structure_encoder(q.double(), *w, parents=REFERENCE_PARENTS)
    with pytest.raises(ValueError, match="CUDA"):
        fused_encoder.fused_structure_encoder(q.to("meta"), *w, parents=REFERENCE_PARENTS)


def test_strenc_fused_forward_equals_non_fused():
    cfg = PoseNDFConfig()
    cfg.dfnet.dims = [32, 48]
    plain = cfg.make_model()
    cfg.strenc.fused = True
    fused = cfg.make_model()
    assert fused.enc.use_fused and not plain.enc.use_fused
    q = _t(_poses(2, 37))
    for normalize in (True, False):
        torch.testing.assert_close(fused(q, normalize), plain(q, normalize), rtol=0, atol=0)


@pytest.mark.parametrize("act", ["lrelu", "softplus"])
def test_strenc_fused_training_gradient_equals_non_fused(act):
    """Autodiff training through the fused encoder differentiates it twice
    (the eikonal term): the plain encoder's parameter gradient, up to the
    order of fp32 sums in the replayed backward (1e-6 x max|leaf|)."""
    _, params, plain, pose, gt, man = make_case(act)
    fused = PoseNDF(dfnet_dims=(32, 48, 16), activation=act, use_fused=True)
    fused.load_state_dict(plain.state_dict())
    out = []
    for m in (plain, fused):
        total, _ = training_loss(m, _t(pose), _t(gt), _t(man))
        out.append(torch.autograd.grad(total, list(m.parameters())))
    for (name, _), a, b in zip(plain.named_parameters(), *out):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * float(a.abs().max()), msg=name)
