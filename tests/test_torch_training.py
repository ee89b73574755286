"""The port's training math against the JAX package's, on the CPU.

The same numpy-seeded poses and the same weights (carried across by
``params_from_jax``) go through both packages: ``training_loss`` under
autograd against ``jax.value_and_grad``, ``manual_train_grads`` against
JAX's, ``fused_train_grads`` on CPU tensors (the train kernels' plain
version, ``manual_train_grads``) against JAX's Pallas kernel in TPU interpret
mode (``tests/test_torch_fused_train.py``), and one
``make_train_step`` step against JAX's. Bars as in ``tests/test_fused_train.py``
and ``tests/test_train_grad.py``: rtol 1e-5 on loss terms, 2e-5 x max|leaf|
on every gradient leaf. Then the port's plain path at full width against the
JAX-made ``tests/data/torch_port_train_expected.npz``
(``scripts/make_torch_port_train_golden.py``), the file ``chip_smoke.py``
holds the CUDA train kernels to.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from posendf_tpu.kinematics import REFERENCE_PARENTS  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.losses import training_loss as jax_training_loss  # noqa: E402
from posendf_tpu.ops.train_grad import manual_train_grads as jax_manual_train_grads  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.losses import training_loss  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_train  # noqa: E402
from posendf_torch.ops.train_grad import manual_train_grads  # noqa: E402
from posendf_torch.training.trainer import make_optimizer, make_train_step  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
TRAIN_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_train_expected.npz")
RELU_TRAIN_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_relu_train_expected.npz")
GRAD_TOL = 2e-5
DIMS = (32, 48, 16)
WEIGHTS = dict(weight_dist=0.7, weight_man=2.5, weight_eikonal=0.3)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def make_case(act, *, B=24, M=16, dims=DIMS, seed=0):
    """(JAX module, JAX params, port module, pose, labels, manifold poses),
    all drawn with numpy: generic weights (normal, 0.3) whose head bias is
    lifted until both branches have some d > 1e-3, so no comparison is
    vacuous (a ReLU head can be 0 everywhere, a softplus one ~1e-30)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (0.3 * rng.normal(size=shape)).astype(np.float32)

    J, F, H = 21, 6, 10
    widths = [J * F, *dims, 1]
    params = {"enc": {"w1": normal(J, H, H), "b1": normal(J, H), "w2": normal(J, H, F),
                      "b2": normal(J, F)},
              "dfnet": {}}
    for l in range(len(widths) - 1):
        params["dfnet"][f"w{l}"] = normal(widths[l], widths[l + 1])
        params["dfnet"][f"b{l}"] = normal(widths[l + 1])

    def unit(n):
        q = rng.normal(size=(n, J, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    pose, man = unit(B), unit(M)
    gt = np.abs(rng.normal(size=B)).astype(np.float32)
    tm = PoseNDF(dfnet_dims=dims, activation=act)
    head = f"b{len(widths) - 2}"
    for _ in range(16):
        tm.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            if (tm(_t(pose)).max() > 1e-3) and (tm(_t(man), normalize_input=False).max() > 1e-3):
                break
        params["dfnet"][head] = params["dfnet"][head] + np.float32(0.5)
    jm = JaxPoseNDF(dfnet_dims=tuple(dims), activation=act)
    return jm, params, tm, pose, gt, man


def _jax_autodiff(jm, params, pose, gt, man, loss_type):
    """``jax.value_and_grad(losses.training_loss)``, jitted: ((total, terms), grads)."""
    return jax.jit(jax.value_and_grad(
        lambda p: jax_training_loss(jm, p, pose, gt, man, loss_type=loss_type, **WEIGHTS),
        has_aux=True))(params)


def _assert_grads_close(got, want_tree, tol=GRAD_TOL):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    assert any(float(w.abs().max()) > 0 for w in want.values())
    for k, w in want.items():
        scale = max(1e-6, float(w.abs().max()))
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0,
                                   atol=tol * scale, err_msg=k)


def _assert_terms_close(total, terms, want_total, want_terms):
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5, atol=1e-8)
    for k in want_terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(want_terms[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("act", ["lrelu", "relu", "softplus"])
def test_training_loss_and_manual_grads_match_jax(act, loss_type):
    """The autograd loss (values and parameter gradients, the eikonal term's
    gradient of a gradient included) and ``manual_train_grads`` against
    ``jax.value_and_grad``; for lrelu/relu also ``manual_train_grads``
    against JAX's own manual chain. (For softplus JAX's chain is no sharper
    reference than autodiff: act'' amplifies the order of the fp32 sums by
    beta = 100, and at this point it is itself 4.6e-5 x max|leaf| off.)"""
    jm, params, tm, pose, gt, man = make_case(act)
    (want_total, want_terms), want = _jax_autodiff(jm, params, pose, gt, man, loss_type)

    total, terms = training_loss(tm, _t(pose), _t(gt), _t(man), loss_type=loss_type, **WEIGHTS)
    grads = dict(zip([n for n, _ in tm.named_parameters()],
                     torch.autograd.grad(total, list(tm.parameters()))))
    _assert_terms_close(total, terms, want_total, want_terms)
    _assert_grads_close(grads, want)

    total, terms, grads = manual_train_grads(
        params_from_jax(params), _t(pose), _t(gt), _t(man), parents=REFERENCE_PARENTS,
        activation=act, loss_type=loss_type, **WEIGHTS)
    _assert_terms_close(total, terms, want_total, want_terms)
    _assert_grads_close(grads, want)
    if act != "softplus":
        _, _, want = jax.jit(lambda p: jax_manual_train_grads(
            p, pose, gt, man, parents=REFERENCE_PARENTS, activation=act, loss_type=loss_type,
            **WEIGHTS))(params)
        _assert_grads_close(grads, want)


def test_training_loss_remat_is_the_same_math():
    _, _, tm, pose, gt, man = make_case("softplus")
    out = []
    for remat in (False, True):
        total, _ = training_loss(tm, _t(pose), _t(gt), _t(man), remat=remat)
        out.append(torch.autograd.grad(total, list(tm.parameters())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def _golden_inputs():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_train_golden",
        os.path.join(ROOT, "scripts", "make_torch_port_train_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_inputs


def _assert_summaries(prefix, leaves, ref, tol):
    """A leaf's sum (to tol x sum|leaf|), L2 norm (rtol tol) and sampled
    values (tol x max|leaf|) against the JAX-made file."""
    for k, v in leaves.items():
        a = v.detach().double().reshape(-1)
        scale = float(ref[f"{prefix}_max_{k}"])
        np.testing.assert_allclose(float(a.sum()), float(ref[f"{prefix}_sum_{k}"]), rtol=0,
                                   atol=tol * float(ref[f"{prefix}_abssum_{k}"]), err_msg=k)
        np.testing.assert_allclose(float(a.norm()), float(ref[f"{prefix}_norm_{k}"]), rtol=tol,
                                   err_msg=k)
        np.testing.assert_allclose(a[torch.from_numpy(ref[f"idx_{k}"]).long()].numpy(),
                                   ref[f"{prefix}_at_{k}"], rtol=0, atol=tol * scale, err_msg=k)


def test_plain_path_reproduces_the_jax_train_golden():
    """Full width (the trained lrelu field), 2,048 + 2,048 poses: the train
    kernels' plain version, then three fused Adam steps (lr 1e-4, weight
    decay 1e-4), against the JAX package's autodiff values."""
    ref = np.load(TRAIN_EXPECTED)
    make_inputs = _golden_inputs()
    field = posendf_torch.load_field(L8, device="cpu")
    seed, rows = int(ref["seed"]), int(ref["rows"])
    pose, dist, man = map(torch.from_numpy, make_inputs(seed, rows))
    total, terms, grads = fused_train.fused_train_grads(field.weights(), pose, dist, man)
    np.testing.assert_allclose(float(total), float(ref["grad_total"]), rtol=1e-5)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(ref[f"grad_term_{k}"]), rtol=1e-5)
    _assert_summaries("grad", grads, ref, GRAD_TOL)

    module = field.module
    step = make_train_step(module, make_optimizer(module.parameters(), float(ref["lr"]),
                                                  float(ref["weight_decay"])),
                           loss_type="l1", weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0},
                           fused=True)
    hist = []
    for s in range(int(ref["steps"])):
        b = dict(zip(("pose", "dist", "man_poses"),
                     map(torch.from_numpy, make_inputs(seed + 1 + s, rows))))
        m = step(b)
        hist.append([float(m[k]) for k in ("total", "dist", "man_loss", "eikonal")])
    np.testing.assert_allclose(np.asarray(hist), ref["step_terms"], rtol=1e-5)
    # An Adam step moves a weight by lr * m / (sqrt(v) + eps): about lr
    # wherever |g| is well above eps, and by a fraction of lr that the order
    # of the fp32 sums decides where g is near 0. So every sampled weight is
    # within the 2 * steps * lr two runs can part, and 99% within lr / 20.
    lr, steps = float(ref["lr"]), int(ref["steps"])
    for k, v in module.state_dict().items():
        a = v.double().reshape(-1)
        err = np.abs(a[torch.from_numpy(ref[f"idx_{k}"]).long()].numpy() - ref[f"param_at_{k}"])
        assert err.max() <= 2 * steps * lr and np.mean(err > lr / 20) <= 0.01, k
        np.testing.assert_allclose(float(a.norm()), float(ref[f"param_norm_{k}"]), rtol=1e-6,
                                   err_msg=k)


def test_plain_path_reproduces_the_jax_relu_train_golden():
    """The trained weights with relu activations (the field that runs the
    train tile kernel's relu instance on the card), 2,048 + 2,048 poses: the
    train kernels' plain version against the JAX package's autodiff
    gradient (``scripts/make_torch_port_train_golden.py --relu``), at the
    bars of the lrelu golden."""
    from posendf_torch.config import PoseNDFConfig

    ref = np.load(RELU_TRAIN_EXPECTED)
    cfg = PoseNDFConfig()
    cfg.dfnet.act = cfg.strenc.act = "relu"
    field = posendf_torch.load_field(L8, config=cfg, device="cpu")
    assert field.module.activation == "relu"
    pose, dist, man = map(torch.from_numpy, _golden_inputs()(int(ref["seed"]), int(ref["rows"])))
    total, terms, grads = fused_train.fused_train_grads(field.weights(), pose, dist, man)
    np.testing.assert_allclose(float(total), float(ref["grad_total"]), rtol=1e-5)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(ref[f"grad_term_{k}"]), rtol=1e-5)
    _assert_summaries("grad", grads, ref, GRAD_TOL)
