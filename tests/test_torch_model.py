"""The PyTorch port's model against the JAX package's, on identical weights.

Weights come from the JAX modules' own init and cross over through
``posendf_torch.checkpoints.params_from_jax``; inputs are numpy-seeded.
Widths are small (DFNet 24 -> 32) and every activation is covered. The bar
is 1e-5: both sides are fp32 on the CPU and differ only in summation order.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.models.dfnet import DFNet as JaxDFNet  # noqa: E402
from posendf_tpu.models.activations import make_activation as jax_activation  # noqa: E402
from posendf_tpu.models.encoder import structure_encoder_apply as jax_encoder  # noqa: E402
from posendf_tpu.field import distance_and_grad as jax_distance_and_grad  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.config import PoseNDFConfig, load_config  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.models.activations import act_grad, make_activation  # noqa: E402
from posendf_torch.models.encoder import structure_encoder_apply  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (24, 32)
ACTS = ["lrelu", "relu", "softplus"]
TOL = 1e-5


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pair(act, use_encoder=True, seed=0):
    """(JAX module, numpy params, port module) with the same weights, scaled
    up and with the head bias lifted so every field varies over poses (a
    fresh lrelu/relu head is often identically zero)."""
    jm = JaxPoseNDF(dfnet_dims=DIMS, activation=act, use_encoder=use_encoder)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(2.0), params)
    last = max(int(k[1:]) for k in params["dfnet"] if k.startswith("b"))
    params["dfnet"][f"b{last}"] = np.abs(params["dfnet"][f"b{last}"]) + np.float32(0.2)
    tm = PoseNDF(dfnet_dims=DIMS, activation=act, use_encoder=use_encoder)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_posendf_matches_jax(act, normalize):
    jm, params, tm = _pair(act)
    q = _poses(1, 37)
    want = np.asarray(jax.jit(jm.apply, static_argnames="normalize_input")(
        {"params": params}, jnp.asarray(q), normalize_input=normalize))
    got = tm(torch.from_numpy(q), normalize_input=normalize).detach().numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_posendf_without_encoder_matches_jax():
    jm, params, tm = _pair("softplus", use_encoder=False)
    q = _poses(2, 16)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(q)))
    np.testing.assert_allclose(tm(torch.from_numpy(q)).detach().numpy(), want, atol=TOL)


@pytest.mark.parametrize("act", ACTS)
def test_encoder_matches_jax(act):
    rng = np.random.default_rng(3)
    w1 = rng.normal(size=(21, 10, 10)).astype(np.float32) * 0.5
    b1 = rng.normal(size=(21, 10)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(21, 10, 6)).astype(np.float32) * 0.5
    b2 = rng.normal(size=(21, 6)).astype(np.float32) * 0.1
    q = _poses(4, 25)
    parents = posendf_torch.kinematics.REFERENCE_PARENTS
    encode = jax.jit(lambda *a: jax_encoder(*a, parents=parents, activation=act))
    want = np.asarray(encode(jnp.asarray(q), w1, b1, w2, b2))
    got = structure_encoder_apply(torch.from_numpy(q), *map(torch.from_numpy, (w1, b1, w2, b2)),
                                  parents=parents, activation=act)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("act", ACTS)
def test_dfnet_matches_jax(act):
    jm, params, tm = _pair(act)
    code = np.random.default_rng(8).normal(size=(29, 126)).astype(np.float32)
    head = JaxDFNet(dims=DIMS, activation=act)
    want = np.asarray(jax.jit(head.apply)({"params": params["dfnet"]}, jnp.asarray(code)))
    got = tm.dfnet(torch.from_numpy(code)).detach().numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("act", ACTS)
def test_distance_and_grad_matches_jax(act):
    jm, params, tm = _pair(act)
    q = _poses(5, 33)
    d_want, g_want = jax.jit(lambda p, x: jax_distance_and_grad(jm, p, x))(params, jnp.asarray(q))
    d, g = posendf_torch.make_field(tm).distance_and_grad(torch.from_numpy(q))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(d_want), atol=TOL)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_want), atol=TOL)


def test_distance_and_grad_is_differentiable_like_jax():
    """create_graph=True: an eikonal-style loss of the gradient has the same
    parameter gradient as JAX's grad-of-vjp."""
    jm, params, tm = _pair("softplus")
    q = _poses(6, 20)

    def jax_loss(p):
        _, g = jax_distance_and_grad(jm, p, jnp.asarray(q))
        return jnp.sum((jnp.linalg.norm(g.reshape(g.shape[0], -1), axis=-1) - 1.0) ** 2)

    want = jax.jit(jax.grad(jax_loss))(params)
    _, g = posendf_torch.make_field(tm).distance_and_grad(torch.from_numpy(q))
    loss = torch.sum((g.reshape(g.shape[0], -1).norm(dim=-1) - 1.0) ** 2)
    loss.backward()
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    scale = max(np.abs(np.asarray(v)).max() for v in jax.tree_util.tree_leaves(want))
    for name, arr in params_from_jax(want).items():
        np.testing.assert_allclose(got[name], arr.numpy(), atol=1e-5 * scale, err_msg=name)


def test_tar_checkpoint_round_trip(tmp_path):
    """A reference-layout .tar written by the JAX package's exporter loads
    into the port with the same distances (root BoneMLP weights padded)."""
    from posendf_tpu.training.torch_import import save_torch_checkpoint

    jm, params, _ = _pair("lrelu")
    path = str(tmp_path / "ckpt.tar")
    save_torch_checkpoint(path, params, epoch=7)
    cfg = PoseNDFConfig()
    cfg.dfnet.dims = list(DIMS)
    field = posendf_torch.load_field(path, config=cfg, device="cpu")
    q = _poses(7, 19)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(q)))
    np.testing.assert_allclose(field.distance(torch.from_numpy(q)).detach().numpy(), want,
                               atol=TOL)
    assert float(field.module.enc.w1.detach()[0, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("act", ["lrelu", "relu", "softplus"])
def test_activation_derivative_at_zero_matches_jax(act):
    """lrelu'(0) = 1 (JAX's where(z >= 0, ...)), relu'(0) = 0, softplus'(0) = 1/2."""
    z = np.array([0.0, -0.5, 0.5, -3.0, 2.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jax_activation(act, 100.0)))(jnp.asarray(z)))
    x = torch.from_numpy(z).requires_grad_(True)
    (got,) = torch.autograd.grad(make_activation(act, 100.0)(x).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    np.testing.assert_allclose(act_grad(act, 100.0, torch.from_numpy(z)).numpy(), want, atol=1e-7)


def test_softplus_formula_matches_jax():
    """logaddexp(beta x, 0) / beta, without torch.nn.Softplus's threshold."""
    z = np.linspace(-2.0, 2.0, 401, dtype=np.float32)
    want = np.asarray(jax_activation("softplus", 100.0)(jnp.asarray(z)))
    got = make_activation("softplus", 100.0)(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_fresh_init_layout_matches_jax():
    """Same parameter names and shapes as the JAX tree; root pad rows zero;
    one seed gives one set of weights; live_head lifts the last bias."""
    shapes = jax.eval_shape(JaxPoseNDF().init, jax.random.key(0),
                            jnp.zeros((1, 21, 4)))["params"]
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    a = PoseNDF(generator=torch.Generator().manual_seed(3))
    b = PoseNDF(generator=torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == want
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    for j, p in enumerate(a.parents):
        assert (p == -1) == (float(a.enc.w1.detach()[j, 4:].abs().max()) == 0.0)
    live = PoseNDF(live_head=True, generator=torch.Generator().manual_seed(3))
    assert float(live.dfnet.b6.detach()) == pytest.approx(0.1)


def test_unported_options_raise():
    """Every option is ported now: ff_enc and bf16 construct (their values
    are held to JAX in tests/test_torch_bf16.py and test_torch_pos_encoder.py)
    and an unknown compute dtype raises; strenc.fused builds the encoder on
    its kernel, with the same weights as the plain encoder."""
    ff = PoseNDF(ff_enc=True, ff_freqs=2)
    assert ff.dfnet.w0.shape == (126 * 5, 256) and ff.ff_freqs == 2
    assert PoseNDF(compute_dtype="bfloat16").dfnet.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        PoseNDF(compute_dtype="float16")
    cfg = PoseNDFConfig()
    cfg.strenc.fused = True
    fused = cfg.make_model()
    assert fused.enc.use_fused
    for k, v in PoseNDFConfig().make_model().state_dict().items():
        assert torch.equal(fused.state_dict()[k], v), k


def test_config_yaml_matches_defaults():
    cfg = load_config(os.path.join(ROOT, "configs", "amass.yaml"))
    default = PoseNDFConfig()
    assert cfg.dfnet.dims == default.dfnet.dims and cfg.dfnet.act == default.dfnet.act
    assert cfg.strenc.out_dim == default.strenc.out_dim
    golden = load_config(os.path.join(ROOT, "examples", "golden", "golden.yaml"))
    assert golden.dfnet.act == "softplus" and golden.dfnet.dims == [64, 64]
