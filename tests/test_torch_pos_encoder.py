"""The port's positional encoding (``ff_enc``) against the JAX package.

``posendf_torch/models/pos_encoder.py`` is the port's own copy of
``posendf_tpu/models/pos_encoder.py``: ``positional_encoding`` on numpy-seeded
inputs at several octave counts, with and without the identity, and
``encoded_dim``; then an ``ff_enc`` model (the code lifted to 2 octaves of
Fourier features before a small DFNet) with the same weights in both
packages: d and the pose gradient of the module path. fp32 on both sides:
1e-6 on the encoding (sin and cos of the same fp32 arguments), 1e-5 on d
and g (those of ``tests/test_fused_grad.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.field import distance_and_grad as jax_distance_and_grad  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.models.pos_encoder import encoded_dim as jax_encoded_dim  # noqa: E402
from posendf_tpu.models.pos_encoder import positional_encoding as jax_pe  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.field import distance_and_grad  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.models.pos_encoder import encoded_dim, positional_encoding  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("freqs,identity", [(0, True), (1, True), (4, True), (1, False),
                                             (4, False)])
def test_positional_encoding_matches_jax(freqs, identity):
    x = np.random.default_rng(freqs).normal(size=(5, 3, 7)).astype(np.float32)
    want = np.asarray(jax_pe(jnp.asarray(x), freqs, include_identity=identity))
    got = positional_encoding(torch.from_numpy(x), freqs, include_identity=identity).numpy()
    assert got.shape == want.shape == (5, 3, encoded_dim(7, freqs, identity))
    assert encoded_dim(7, freqs, identity) == jax_encoded_dim(7, freqs, identity)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("act", ["lrelu", "softplus"])
def test_ff_enc_model_matches_jax(act):
    jm = JaxPoseNDF(dfnet_dims=(32, 16), activation=act, ff_enc=True, ff_freqs=2)
    params = jm.init(jax.random.key(5), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(1.5), params)
    params["dfnet"]["b2"] = params["dfnet"]["b2"] + np.float32(0.2)
    tm = PoseNDF(dfnet_dims=(32, 16), activation=act, ff_enc=True, ff_freqs=2)
    tm.load_state_dict(params_from_jax(params))
    assert tm.dfnet.w0.shape == (126 * 5, 32)
    q = np.random.default_rng(1).normal(size=(40, 21, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    d_ref, g_ref = jax_distance_and_grad(jm, params, jnp.asarray(q))
    d, g = distance_and_grad(tm, torch.from_numpy(q))
    assert float(np.abs(np.asarray(d_ref)).mean()) > 1e-3   # the comparison has signal
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(d_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), atol=1e-5, rtol=0)
