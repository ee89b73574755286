"""The port's fused training gradient and train step against the JAX package.

``fused_train_grads`` on CPU tensors runs the CUDA train kernels' plain
version, ``manual_train_grads``; it is held to JAX's Pallas ``_train_kernel``
in TPU interpret mode, as ``tests/test_fused_train.py`` runs it, over several
JAX tiles with a padded tail (B = 300 at tile 128), B != M and non-unit
weights. Bars of that file: rtol 1e-5 on the loss terms, 2e-5 x max|leaf| on
every gradient leaf. The per-kernel plain versions that ``chip_smoke.py``
holds each kernel to (``branch_ref``, ``reduce_ref``) are held to
``manual_train_grads`` here. Then one ``make_train_step`` step, autodiff and
fused, against JAX's. The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phases 7 and 10).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.kinematics import REFERENCE_PARENTS  # noqa: E402
from posendf_tpu.ops.fused_train import fused_train_grads as jax_fused_train_grads  # noqa: E402
from posendf_tpu.training.trainer import make_optimizer as jax_make_optimizer  # noqa: E402
from posendf_tpu.training.trainer import make_train_step as jax_make_train_step  # noqa: E402
from tests.test_torch_training import (  # noqa: E402
    GRAD_TOL, WEIGHTS, _assert_grads_close, _assert_terms_close, _t, make_case)

from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_train  # noqa: E402
from posendf_torch.ops.fused_model import FieldWeights  # noqa: E402
from posendf_torch.ops.train_grad import manual_train_grads  # noqa: E402
from posendf_torch.training.trainer import make_optimizer, make_train_step  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("act", ["lrelu", "relu"])
def test_fused_train_grads_matches_jax_kernel(act, loss_type):
    """The CPU path launches nothing and gives JAX's kernel's terms and
    gradient."""
    jm, params, tm, pose, gt, man = make_case(act, B=300, M=200)
    with pltpu.force_tpu_interpret_mode():
        want_total, want_terms, want = jax_fused_train_grads(
            params, pose, gt, man, parents=REFERENCE_PARENTS, activation=act,
            loss_type=loss_type, tile_b=128, **WEIGHTS)
    launches = (fused_train.TILE_LAUNCHES, fused_train.REDUCE_LAUNCHES)
    total, terms, grads = fused_train.fused_train_grads(
        FieldWeights.from_module(tm), _t(pose), _t(gt), _t(man), loss_type=loss_type, **WEIGHTS)
    assert (fused_train.TILE_LAUNCHES, fused_train.REDUCE_LAUNCHES) == launches
    assert not any(g.requires_grad for g in grads.values())
    _assert_terms_close(total, terms, want_total, want_terms)
    _assert_grads_close(grads, want)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("act", ["lrelu", "relu"])
def test_kernel_plain_parts_compose_to_manual_train_grads(act, loss_type):
    """``branch_ref`` per branch, then ``reduce_ref``: the tile kernel's and
    the reduction's plain versions give ``manual_train_grads``'s loss sums
    and gradient (B != M, non-unit weights)."""
    _, _, tm, pose, gt, man = make_case(act, B=40, M=24)
    w = FieldWeights.from_module(tm)
    pose, gt, man = _t(pose), _t(gt), _t(man)
    kw_n, kw_m = fused_train.branch_args(w, pose, gt, man, loss_type, **WEIGHTS)
    with torch.no_grad():
        noisy = fused_train.branch_ref(w, pose, gt, **kw_n)
        manifold = fused_train.branch_ref(w, man, torch.zeros_like(man[:, 0, 0]), **kw_m)
        grads, loss = fused_train.reduce_ref(w, noisy, manifold)
    want_total, want_terms, want = manual_train_grads(
        tm.state_dict(), pose, gt, man, parents=tm.parents, activation=act,
        loss_type=loss_type, **WEIGHTS)
    B, M, J = pose.shape[0], man.shape[0], w.num_joints
    terms = {"dist": loss[0] / B, "man_loss": loss[2] / M, "eikonal": loss[1] / (B * J)}
    for k in want_terms:
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]), rtol=1e-5, err_msg=k)
    assert set(grads) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=0,
                                   atol=GRAD_TOL * max(1e-6, float(v.abs().max())), err_msg=k)


def test_fused_train_grads_refuses_what_the_kernels_do_not_take():
    """JAX's refusals (softplus, non-fp32), and malformed inputs."""
    _, _, tm, pose, gt, man = make_case("softplus", B=8, M=8)
    w = FieldWeights.from_module(tm)
    with pytest.raises(ValueError, match="lrelu/relu"):
        fused_train.fused_train_grads(w, _t(pose), _t(gt), _t(man))
    _, _, tm, pose, gt, man = make_case("lrelu", B=8, M=8)
    w = FieldWeights.from_module(tm)
    with pytest.raises(ValueError, match="fp32 only"):
        fused_train.fused_train_grads(w, _t(pose), _t(gt), _t(man), compute_dtype="bfloat16")
    with pytest.raises(TypeError, match="float32"):
        fused_train.fused_train_grads(w, _t(pose).double(), _t(gt), _t(man))
    with pytest.raises(ValueError, match="dist_gt"):
        fused_train.fused_train_grads(w, _t(pose), _t(gt)[:3], _t(man))
    with pytest.raises(ValueError, match="loss_type"):
        fused_train.fused_train_grads(w, _t(pose), _t(gt), _t(man), loss_type="huber")
    with pytest.raises(ValueError, match="lrelu/relu"):
        make_train_step(PoseNDF(activation="softplus"), None, loss_type="l1",
                        weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}, fused=True)


class _WalkLib:
    """Stands in for the train library's ``posendf_train_tile_walk``: answers
    ``code`` and records the widths asked."""

    def __init__(self, code):
        self.code, self.asked = code, []

    def posendf_train_tile_walk(self, feature_size):
        self.asked.append(feature_size)
        return self.code


@pytest.mark.parametrize("feature_size, code, width",
                         [(6, 1, "compiled"), (8, 0, "runtime"), (8, 1, "compiled")])
def test_tile_walk_width_bookkeeping(feature_size, code, width):
    """``walk_width`` keys ``TILE_WALK_LAUNCHES`` by the walk the library says
    its tile takes for the width (no width of its own: a library compiled for
    8 makes 8 the compiled walk), and the CPU path, which launches nothing,
    moves neither count."""
    lib = _WalkLib(code)
    assert fused_train.walk_width(feature_size, lib) == width
    assert lib.asked == [feature_size]
    assert set(fused_train.TILE_WALK_LAUNCHES) == {"compiled", "runtime"}
    _, _, tm, pose, gt, man = make_case("lrelu", B=8, M=8)
    walks = dict(fused_train.TILE_WALK_LAUNCHES)
    fused_train.fused_train_grads(FieldWeights.from_module(tm), _t(pose), _t(gt), _t(man))
    assert fused_train.TILE_WALK_LAUNCHES == walks


@pytest.mark.parametrize("feature_size", [0, 9])
def test_tile_walk_width_refuses_what_the_kernel_does_not_take(feature_size):
    """A width the library's tile takes not (its answer -1) is refused before
    a launch."""
    with pytest.raises(ValueError, match=f"no feature size {feature_size}"):
        fused_train.walk_width(feature_size, _WalkLib(-1))


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(fused):
    """One Adam step (coupled L2): the metrics and the new weights. Adam's
    first step moves each weight by lr * g / (|g| + eps), so the new weights
    are held to 1e-3 x lr (plus 1e-6 of their size)."""
    lr, wd = 1e-3, 1e-4
    jm, params, tm, pose, gt, man = make_case("lrelu", B=64, M=48)
    weights = {"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}
    opt = jax_make_optimizer(lr, wd)
    step = jax.jit(jax_make_train_step(jm, opt, loss_type="l1", weights=weights, fused=fused,
                                       fused_tile=128))
    with pltpu.force_tpu_interpret_mode():
        want_params, _, want_metrics = step(params, opt.init(params),
                                            {"pose": pose, "dist": gt, "man_poses": man})
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    t_step = make_train_step(tm, make_optimizer(tm.parameters(), lr, wd), loss_type="l1",
                             weights=weights, fused=fused)
    metrics = t_step({"pose": _t(pose), "dist": _t(gt), "man_poses": _t(man)})
    _assert_terms_close(metrics["total"], metrics, want_metrics["total"],
                        {k: want_metrics[k] for k in ("dist", "man_loss", "eikonal")})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-3 * lr,
                                   err_msg=k)
    assert any(not torch.equal(v, before[k]) for k, v in tm.state_dict().items())
