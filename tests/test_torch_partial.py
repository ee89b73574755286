"""The port's partial-observation completion against the JAX package's, on the CPU.

The masks (``dof_mask``, ``observation_mask`` on the 24-row and the 45-row
body), the annealed-Adam engine on a dict of parameters against optax step
by step, the anchor and inpaint solves and their guards, the retrieval
(``complete_by_retrieval``: its search through ``fused_geodesic_topk``,
which runs the kNN kernel's plain version ``knn_topk_ref`` on the CPU) and
its refusals, ``cli partial`` in its three modes, and the trained field
``docs/quality/ckpt_l8_best.msgpack`` with the 128-vertex body against
``tests/data/torch_port_partial_expected.npz``
(``scripts/make_torch_port_partial_golden.py``), the file ``chip_smoke.py``
holds the card to. Small sizes otherwise: the seeded softplus field of
``tests/test_torch_experiments.py`` (DFNet widths (64, 64)), an 80-vertex
synthetic body, 8-frame clips.

Bars, each beside the deviation it measured on the CPU (fp32 on both sides,
sums in another order):
  * the dict engine: params and history rtol 2e-5, atol 1e-7 (measured
    6.6e-7 relative); masked dofs and a leaf the loss does not read equal
    to the bit;
  * the small field's 2 x 5 solves: pose atol 2e-5, history rtol 1e-4 and
    atol 1e-7 (measured 2.6e-6 in the pose, 8.9e-6 relative in the
    history); metrics rtol 1e-4 (measured 5.7e-6 relative);
  * the trained field's 2 x 5 solves of 60 frames: history rtol 1e-4 and
    atol 1e-7, the bars of the denoise golden (measured 3.8e-6 relative);
    the pose atol 5e-5 or twice JAX's own one-ulp spread (the golden's
    ``<mode>_ulp_spread``), the larger: the heavily corrupted arm puts the
    anchor solve where a one-ulp change of its input moves JAX's pose by
    7.9e-5 (measured 6.1e-5 against JAX; the inpaint solve 8.9e-7);
  * the retrieval: the same neighbours as JAX's search; distances atol 1e-6
    (measured 4.8e-7); the completed sequence atol 1e-6 (measured 1.2e-7);
    the visible joints to the bit;
  * the CLI: the port's API to the bit; against JAX's CLI the inpaint
    mode's pose atol 2e-5 (measured 3.0e-6), the retrieval's atol 1e-5
    (two axis-angle conversions, each package its own; measured 0), the
    anchor mode's 5e-2, twice JAX's own one-ulp spread (the test's
    docstring says why; measured 1.75e-2).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.data.synthetic import manifold_family as jax_manifold_family  # noqa: E402
from posendf_tpu.experiments import PartialCompleter as JaxCompleter  # noqa: E402
from posendf_tpu.experiments import optim as jax_optim  # noqa: E402
from posendf_tpu.experiments import partial as jax_partial  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.ops.knn import geodesic_topk as jax_geodesic_topk  # noqa: E402
from posendf_tpu.smpl import BodyModel as JaxBodyModel  # noqa: E402
from posendf_tpu.smpl import synthetic_model as jax_synthetic_model  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.checkpoints import params_from_jax, smpl_model_from_jax  # noqa: E402
from posendf_torch.data.synthetic import (manifold_family, synthetic_manifold_poses,  # noqa: E402
                                          synthetic_motion_sequence)
from posendf_torch.experiments import optim, partial  # noqa: E402
from posendf_torch.experiments.partial import PartialCompleter  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_knn, knn  # noqa: E402
from posendf_torch.quat import quaternion_to_axis_angle  # noqa: E402
from posendf_torch.smpl import BodyModel  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
PARTIAL_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_partial_expected.npz")
GOLDEN = os.path.join(ROOT, "examples", "golden")
OCC = [12, 15, 17, 19]
TERMS = ("pose_pr", "temp", "data", "total")


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
    """(JAX, port) bodies: the 80-vertex body (24 Jtr rows) and one of
    SMPL's 6,890 vertices (45 rows: the 24 joints and 21 landmarks)."""
    out = {}
    for name, verts in (("24", 80), ("45", 6890)):
        jm = jax_synthetic_model(num_vertices=verts, seed=1)
        out[name] = (JaxBodyModel(model=jm), BodyModel(model=smpl_model_from_jax(jm), device="cpu"))
    return out


def _clip(seed, frames=8):
    return np.random.default_rng(seed).normal(scale=0.2, size=(frames, 69)).astype(np.float32)


# ------------------------------------------------------------------ the masks

@pytest.mark.parametrize("occluded", [[0], [15], [0, 20], OCC, [2, 5, 8, 11, 22]])
def test_dof_mask_matches_jax(occluded):
    got = partial.dof_mask(occluded)
    np.testing.assert_array_equal(got, jax_partial.dof_mask(occluded))
    assert got.dtype == np.float32 and got.sum() == 3 * len(set(occluded))
    with pytest.raises(ValueError, match="out of range"):
        partial.dof_mask([23])


@pytest.mark.parametrize("rows", ["24", "45"])
@pytest.mark.parametrize("occluded", [[15], OCC, [0, 1], [2, 13, 20]])
def test_observation_mask_matches_jax(bodies, rows, occluded):
    """Ancestors through the kinematic tree; the 21 landmark rows only on
    the mesh that covers ``SMPL_VERTEX_LANDMARKS``, each with its carrier."""
    jb, tb = bodies[rows]
    got = partial.observation_mask(tb, occluded)
    want = jax_partial.observation_mask(jb, occluded)
    assert got.shape == (int(rows),) == tb(pose_body=np.zeros((1, 69))).Jtr.shape[1:2]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="body-pose joint indices"):
        partial.observation_mask(tb, [23])


# ---------------------------------------------------- the engine on a dict

@pytest.mark.parametrize("case", ["plain", "masked"])
def test_dict_engine_matches_optax_step_by_step(case):
    """Each leaf its own Adam moments: every step's terms and total, and the
    final leaves, against optax on the same pytree; ``param_mask`` and
    ``lr_runtime`` on every leaf; frozen columns, and a leaf the loss does
    not read (a zero gradient in JAX), keep their bits."""
    rng = np.random.default_rng(3)
    x0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(2, 4)).astype(np.float32),
          "unused": rng.normal(size=(1, 4)).astype(np.float32)}
    target = rng.normal(size=(3, 4)).astype(np.float32)
    specs = {"fit": optim.AnnealSpec(scale=1.0, power=1, anneal=-1.0),
             "reg": optim.AnnealSpec(scale=0.5, power=2, anneal=+1.0, active_after=0)}
    extra = ({} if case == "plain" else
             {"param_mask": np.asarray([1.0, 0.0, 1.0, 1.0], np.float32), "lr_runtime": 0.5})

    def terms(p, aux, mod):
        return {"fit": mod.sum((p["a"] - aux["target"]) ** 2) + mod.sum(p["b"] ** 2) * 0.3,
                "reg": mod.sum(p["a"] ** 4) * 0.1 + mod.sum(p["b"] * p["a"][:2])}

    jaux = {"target": jnp.asarray(target), **{k: jnp.asarray(v) for k, v in extra.items()}}
    taux = {"target": torch.from_numpy(target), **{k: torch.as_tensor(v) for k, v in extra.items()}}
    jspecs = {k: jax_optim.AnnealSpec(*v) for k, v in specs.items()}
    jsolve = jax_optim.make_annealed_solver(lambda p, a: terms(p, a, jnp), jspecs, iterations=3,
                                            steps_per_iter=4, lr=0.05)
    tsolve = optim.make_annealed_solver(lambda p, a: terms(p, a, torch), specs, iterations=3,
                                        steps_per_iter=4, lr=0.05)
    jx, jhist = jsolve({k: jnp.asarray(v) for k, v in x0.items()}, jaux)
    tx, thist = tsolve({k: torch.from_numpy(v) for k, v in x0.items()}, taux)
    assert isinstance(tx, dict) and set(tx) == set(x0)
    for k in jhist:
        np.testing.assert_allclose(thist[k].numpy(), np.asarray(jhist[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    for k in x0:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(tx["unused"].numpy(), x0["unused"])
    if case == "masked":
        for k in ("a", "b"):
            np.testing.assert_array_equal(tx[k].numpy()[:, 1], x0[k][:, 1])
            assert not np.array_equal(tx[k].numpy()[:, 0], x0[k][:, 0])


# ------------------------------------------------------ the anchor and inpaint solves

def _solves(jcomp, tcomp, pose, mode, iterations=2, steps_per_iter=5):
    """Both packages' solves of one clip through their solver objects, the
    masks as ``optimize`` sets them: (JAX pose, JAX history, port pose,
    port history)."""
    jinit = jcomp.body_model(pose_body=jnp.asarray(pose))
    jaux = {"params": jcomp.params, "smpl": jcomp.body_model.model, "betas": jinit.betas,
            "init_joints": jinit.Jtr,
            "data_joint_mask": jnp.asarray(jax_partial.observation_mask(jcomp.body_model, OCC))}
    tinit = tcomp.body_model(pose_body=pose)
    taux = {"betas": tinit.betas, "init_joints": tinit.Jtr[None],
            "data_joint_mask": torch.from_numpy(partial.observation_mask(tcomp.body_model, OCC))}
    if mode == "inpaint":
        pm = np.broadcast_to(partial.dof_mask(OCC), (len(pose), 69))
        jaux["param_mask"] = jnp.asarray(pm)
        taux["param_mask"] = torch.from_numpy(pm.copy())[None]
    jp, jh = jcomp._solver(iterations, steps_per_iter)(jinit.body_pose, jaux)
    tp, th = tcomp._solve(tinit.body_pose[None], taux, iterations, steps_per_iter)
    return np.asarray(jp), {k: np.asarray(v) for k, v in jh.items()}, tp[0].numpy(), \
        {k: v[:, 0].numpy() for k, v in th.items()}


@pytest.mark.parametrize("mode", ["anchor", "inpaint"])
def test_partial_solve_matches_jax(pair, bodies, mode):
    """A 2 x 5 solve of 8 frames with the left arm occluded: every step's
    terms and total, the final pose and the metrics; under inpaint every
    observed dof keeps its input's bits."""
    jm, params, field = pair
    jb, tb = bodies["24"]
    pose = _clip(3)
    jspecs = jax_partial.INPAINT_SPECS if mode == "inpaint" else None
    tspecs = partial.INPAINT_SPECS if mode == "inpaint" else None
    jcomp, tcomp = JaxCompleter(jm, params, jb, specs=jspecs), PartialCompleter(field, tb, tspecs)
    jp, jh, tp, th = _solves(jcomp, tcomp, pose, mode)
    assert set(th) == set(jh)
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-5)
    _, want_m = jcomp.optimize(jnp.asarray(pose), iterations=2, steps_per_iter=5,
                               occluded_joints=OCC, mode=mode)
    got, got_m = tcomp.optimize(pose, iterations=2, steps_per_iter=5, occluded_joints=OCC,
                                mode=mode)
    np.testing.assert_array_equal(got.numpy(), tp)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, atol=1e-7, err_msg=k)
    occ_dofs = np.asarray(partial.dof_mask(OCC), bool)
    if mode == "inpaint":
        np.testing.assert_array_equal(got.numpy()[:, ~occ_dofs], pose[:, ~occ_dofs])
        assert not np.allclose(got.numpy()[:, occ_dofs], pose[:, occ_dofs])
    else:
        assert not np.allclose(got.numpy()[:, ~occ_dofs], pose[:, ~occ_dofs])


def test_partial_completer_guards(pair, bodies):
    """The guards of JAX's completer: an int for the ground truth (the
    older positional iterations), inpaint without occluded joints and an
    unknown mode; without occluded joints the anchor mode is the
    reference's anchor-everything solve."""
    _, _, field = pair
    _, tb = bodies["24"]
    comp = PartialCompleter(field, tb)
    assert comp.specs == partial.PARTIAL_SPECS
    pose = _clip(4, frames=3)
    with pytest.raises(TypeError, match="gt_pose_body"):
        comp.optimize(pose, 5, 10)
    with pytest.raises(ValueError, match="requires occluded_joints"):
        comp.optimize(pose, mode="inpaint")
    with pytest.raises(ValueError, match="'anchor' or 'inpaint'"):
        comp.optimize(pose, mode="retrieval", occluded_joints=OCC)
    plain, _ = comp.optimize(pose, iterations=1, steps_per_iter=3)
    from posendf_torch.experiments.denoise import MotionDenoiser

    want, _ = MotionDenoiser(field, tb, specs=partial.PARTIAL_SPECS).optimize(
        pose, iterations=1, steps_per_iter=3)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())


# ---------------------------------------------------------------- retrieval

@pytest.fixture(scope="module")
def retrieval_case():
    """A 4,096-pose corpus of one manifold and an 8-frame clip of it whose
    left arm is corrupted (JAX's own retrieval test, through the port's
    byte-identical copy of the synthetic manifold)."""
    rng = np.random.default_rng(7)
    family = manifold_family(rng, 21, latents=2)
    for a, b in zip(family, jax_manifold_family(np.random.default_rng(7), 21, latents=2)):
        np.testing.assert_array_equal(a, b)
    corpus = synthetic_manifold_poses(rng, 4096, family=family)
    gt = synthetic_motion_sequence(rng, 8, family=family)
    bad = gt.copy()
    bad[:, OCC] += rng.normal(scale=0.5, size=(8, len(OCC), 4)).astype(np.float32)
    bad[:, OCC] /= np.linalg.norm(bad[:, OCC], axis=-1, keepdims=True)
    return corpus, gt, bad


def _occ_err(q, gt):
    return float(np.mean(1.0 - np.abs(np.sum(q[:, OCC] * gt[:, OCC], -1))))


@pytest.mark.parametrize("k, window", [(5, 5), (1, 1), (3, 3)])
def test_complete_by_retrieval_matches_jax(retrieval_case, k, window):
    """The zero-weight search through ``fused_geodesic_topk`` (the kernel's
    plain version on the CPU) finds JAX's neighbours; the completion is
    JAX's; the visible joints come back to the bit and the occluded error
    falls."""
    corpus, gt, bad = retrieval_case
    w, occ = partial.retrieval_weights(OCC)
    assert occ.tolist() == OCC and (w[OCC] == 0).all() and abs(np.linalg.norm(w) - 1) < 1e-6
    want_d, want_i = jax_geodesic_topk(jnp.asarray(bad), jnp.asarray(corpus), k=k,
                                       weights=jnp.asarray(w), precision="highest")
    got_d, got_i = fused_knn.fused_geodesic_topk(torch.from_numpy(bad), torch.from_numpy(corpus),
                                                 k, weights=w, dot_impl="vpu")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)
    want = jax_partial.complete_by_retrieval(corpus, bad, OCC, k=k, temporal_window=window)
    got = partial.complete_by_retrieval(corpus, bad, OCC, k=k, temporal_window=window,
                                        device="cpu")
    assert got.dtype == np.float32 and got.shape == bad.shape
    vis = [j for j in range(21) if j not in OCC]
    np.testing.assert_array_equal(got[:, vis], bad[:, vis])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert _occ_err(got, gt) < 0.5 * _occ_err(bad, gt)


def test_complete_by_retrieval_tensor_inputs_and_bf16(retrieval_case):
    """Tensors in, numpy out, the same completion; ``precision="default"``
    runs the bf16 engine (the plain version's bf16 arithmetic)."""
    corpus, _, bad = retrieval_case
    want = partial.complete_by_retrieval(corpus, bad, OCC, device="cpu")
    got = partial.complete_by_retrieval(torch.from_numpy(corpus), torch.from_numpy(bad), OCC,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)
    w, _ = partial.retrieval_weights(OCC)
    qf, cf, wj, wt = fused_knn.kernel_operands(torch.from_numpy(bad), torch.from_numpy(corpus), w,
                                               "mxu_bf16")
    _, idx = fused_knn.knn_topk_ref(qf, cf, 5, weights=wj, w_total=wt, dot_impl="mxu_bf16")
    nn = corpus[idx.numpy()]
    mean_q = partial._aligned_quat_mean(nn, nn[:, :1])
    bf16 = partial.complete_by_retrieval(corpus, bad, OCC, temporal_window=1,
                                         precision="default", device="cpu")
    np.testing.assert_array_equal(bf16[:, OCC], mean_q[:, OCC])


@pytest.mark.parametrize("occluded, match", [
    (list(range(21)), "proper nonempty subset"), ([], "proper nonempty subset"),
    ([3, 21], "proper nonempty subset"), ([-1, 4], "proper nonempty subset")])
def test_complete_by_retrieval_refuses_bad_subsets(retrieval_case, occluded, match):
    corpus, _, bad = retrieval_case
    with pytest.raises(ValueError, match=match):
        jax_partial.complete_by_retrieval(corpus, bad, occluded)
    with pytest.raises(ValueError, match=match):
        partial.complete_by_retrieval(corpus, bad, occluded, device="cpu")


def test_complete_by_retrieval_refusals(retrieval_case):
    """An even window, a corpus smaller than k, an unknown precision; no
    silent fall back to the CPU when the card is asked for and absent. And
    more neighbours than the kernel keeps (k = 33) is no refusal: it takes
    the streamed search of ``ops/knn.py``, whose neighbours are JAX's XLA
    search's (distances within 1e-6) and whose completion is JAX's within
    1e-6."""
    corpus, _, bad = retrieval_case
    for w in (2, 4):
        with pytest.raises(ValueError, match="must be odd"):
            partial.complete_by_retrieval(corpus, bad, OCC, temporal_window=w, device="cpu")
    with pytest.raises(ValueError, match="at least k=5"):
        partial.complete_by_retrieval(corpus[:4], bad, OCC, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        partial.complete_by_retrieval(corpus, bad, OCC, precision="fast", device="cpu")
    # the kNN kernel keeps at most 32 neighbours; JAX's XLA search takes any k
    w, _ = partial.retrieval_weights(OCC)
    want_d, want_i = jax_geodesic_topk(jnp.asarray(bad), jnp.asarray(corpus), k=33,
                                       weights=jnp.asarray(w), precision="highest")
    got_d, got_i = knn.geodesic_topk(torch.from_numpy(bad), torch.from_numpy(corpus), 33,
                                     weights=torch.from_numpy(w), precision="highest")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)
    want = jax_partial.complete_by_retrieval(corpus, bad, OCC, k=33)
    got = partial.complete_by_retrieval(corpus, bad, OCC, k=33, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            partial.complete_by_retrieval(corpus, bad, OCC)


def test_complete_by_retrieval_exact_recovery(retrieval_case):
    """A clip that is in the corpus comes back exactly at k = 1 (up to the
    quaternion double cover)."""
    corpus, _, _ = retrieval_case
    gt = corpus[64:72]
    bad = gt.copy()
    rng = np.random.default_rng(13)
    bad[:, OCC] = rng.normal(size=(8, len(OCC), 4)).astype(np.float32)
    bad[:, OCC] /= np.linalg.norm(bad[:, OCC], axis=-1, keepdims=True)
    done = partial.complete_by_retrieval(corpus, bad, OCC, k=1, temporal_window=1, device="cpu")
    np.testing.assert_allclose(np.abs(np.sum(done[:, OCC] * gt[:, OCC], -1)), 1.0, atol=1e-5)


# -------------------------------------------------------------------- CLI

def _golden_args():
    return ["--ckpt", os.path.join(GOLDEN, "golden.msgpack"),
            "--config", os.path.join(GOLDEN, "golden.yaml")]


@pytest.mark.parametrize("mode", ["anchor", "inpaint", "retrieval"])
def test_cli_partial_matches_jax(tmp_path, capsys, mode):
    """``cli partial`` on the CPU writes the pose the port's API gives, to
    the bit, and the pose the JAX CLI writes. The CLI solves 10 x 10 steps;
    the anchor mode's solve on the golden field then depends on rounding
    (its prior reaches the field's zero region, ~1e-37): a one-ulp change
    of the input moves JAX's pose by 2.5e-2 (up; 1.6e-2 down) and the
    port's by 2.1e-2, and the two packages end 1.8e-2 apart. So the anchor
    mode is held to JAX within 5e-2, twice JAX's own one-ulp spread; the
    inpaint mode (spread 1.0e-6) at atol 2e-5, its metrics at rtol 1e-4."""
    from posendf_tpu.cli import main as jax_main

    rng = np.random.default_rng(4)
    motion = str(tmp_path / "motion.npz")
    raw = rng.normal(scale=0.2, size=(6, 63)).astype(np.float32)
    np.savez(motion, pose_body=raw)
    args = ["partial", *_golden_args(), "--motion-data", motion, "--max-frames", "4",
            "--occluded-joints", "15", "17", "--mode", mode]
    if mode == "retrieval":
        q = rng.normal(size=(256, 21, 4)).astype(np.float32)
        np.savez(tmp_path / "corpus.npz", pose=q / np.linalg.norm(q, axis=-1, keepdims=True))
        args += ["--corpus", str(tmp_path / "corpus.npz"), "--retrieval-k", "3"]
    jax_main(args + ["--out", str(tmp_path / "j.npz")])
    jax_out = capsys.readouterr().out
    cli.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote" in out
    pose = np.zeros((4, 69), np.float32)
    pose[:, :63] = raw[:4]
    field = posendf_torch.load_field(os.path.join(GOLDEN, "golden.msgpack"),
                                     config=os.path.join(GOLDEN, "golden.yaml"), device="cpu")
    body = BodyModel(device="cpu")
    if mode == "retrieval":
        with np.load(tmp_path / "corpus.npz") as z:
            corpus = z["pose"]
        q = torch.from_numpy(raw[:4].reshape(4, 21, 3))
        from posendf_torch.quat import axis_angle_to_quaternion

        done = partial.complete_by_retrieval(corpus, axis_angle_to_quaternion(q), [15, 17], k=3,
                                             device="cpu")
        pose[:, :63] = quaternion_to_axis_angle(torch.from_numpy(done)).reshape(4, 63).numpy()
        api = pose
    else:
        specs = partial.INPAINT_SPECS if mode == "inpaint" else None
        api = PartialCompleter(field, body, specs=specs).optimize(
            pose, occluded_joints=[15, 17], mode=mode)[0].numpy()
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert t["pose_body"].shape == j["pose_body"].shape == (4, 69)
        np.testing.assert_array_equal(t["pose_body"], api)
        bar = {"retrieval": 1e-5, "inpaint": 2e-5, "anchor": 5e-2}[mode]
        np.testing.assert_allclose(t["pose_body"], j["pose_body"], rtol=0, atol=bar)

    def metrics(text):
        return {ln.split(":")[0]: float(ln.split(":")[1]) for ln in text.splitlines()
                if ln.startswith(("final_", "v2v"))}

    want, got = metrics(jax_out), metrics(out)
    assert set(got) == set(want) == (set() if mode == "retrieval" else
                                     {"v2v_vs_input_cm", "final_pose_pr", "final_temp"})
    if mode == "inpaint":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    with pytest.raises(SystemExit, match="requires --corpus"):
        cli.main(["partial", *_golden_args(), "--motion-data", motion, "--mode", "retrieval",
                  "--device", "cpu"])


def test_cli_partial_mesh_output(tmp_path):
    motion = str(tmp_path / "motion.npz")
    np.savez(motion, pose_body=_clip(5, frames=4)[:, :63])
    cli.main(["partial", *_golden_args(), "--device", "cpu", "--motion-data", motion,
              "--max-frames", "2", "--save-mesh", "--mesh-dir", str(tmp_path / "po")])
    assert sorted(os.listdir(tmp_path / "po" / "meshes")) == [
        "init_0000.obj", "init_0001.obj", "out_0000.obj", "out_0001.obj"]


# ------------------------------------------- the trained field, the golden

@pytest.fixture(scope="module")
def l8():
    field = posendf_torch.load_field(L8, device="cpu")
    return field, BodyModel(device="cpu"), np.load(PARTIAL_EXPECTED)


@pytest.mark.parametrize("mode", ["anchor", "inpaint"])
def test_l8_partial_solve_matches_jax(l8, mode):
    field, body, ref = l8
    specs = partial.INPAINT_SPECS if mode == "inpaint" else None
    comp = PartialCompleter(field, body, specs=specs)
    pose = ref["pose"]
    init = body(pose_body=pose)
    aux = {"betas": init.betas, "init_joints": init.Jtr[None],
           "data_joint_mask": torch.from_numpy(partial.observation_mask(body, OCC))}
    if mode == "inpaint":
        aux["param_mask"] = torch.from_numpy(partial.dof_mask(OCC)).expand(len(pose), 69)[None]
    got, hist = comp._solve(init.body_pose[None], aux, 2, 5)
    bar = max(5e-5, 2 * float(ref[f"{mode}_ulp_spread"]))
    np.testing.assert_allclose(got[0].numpy(), ref[f"{mode}_pose"], rtol=0, atol=bar)
    for k in TERMS:
        if f"{mode}_hist_{k}" in ref:
            np.testing.assert_allclose(hist[k][:, 0].numpy(), ref[f"{mode}_hist_{k}"], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    final, _ = comp.optimize(pose, iterations=2, steps_per_iter=5, occluded_joints=OCC, mode=mode)
    np.testing.assert_array_equal(final.numpy(), got[0].numpy())


def test_l8_retrieval_matches_jax(l8):
    """The golden's corpus and clip rebuilt from their seeds: the same
    neighbours and completion as JAX's."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_torch_port_partial_golden import K, WINDOW, make_inputs
    finally:
        sys.path.pop(0)
    _, _, ref = l8
    clean, bad, corpus = make_inputs()
    np.testing.assert_allclose(
        quaternion_to_axis_angle(torch.from_numpy(bad)).reshape(-1, 63).numpy(),
        ref["pose"][:, :63], rtol=0, atol=1e-6)
    w, _ = partial.retrieval_weights(OCC)
    d, idx = fused_knn.fused_geodesic_topk(torch.from_numpy(bad), torch.from_numpy(corpus), K,
                                           weights=w)
    np.testing.assert_array_equal(idx.numpy(), ref["retrieval_idx"])
    np.testing.assert_allclose(d.numpy(), ref["retrieval_dist"], rtol=0, atol=1e-6)
    done = partial.complete_by_retrieval(corpus, bad, OCC, k=K, temporal_window=WINDOW,
                                         device="cpu")
    np.testing.assert_allclose(done, ref["retrieval_out"], rtol=0, atol=1e-6)
    assert _occ_err(done, clean) < 0.2 * _occ_err(bad, clean)
