"""The quality drivers (``scripts/torch_quality_grid.py``,
``torch_interp_quality.py``, ``torch_partial_quality.py``,
``torch_fit_image_quality.py``) against the JAX package's scripts, stage by
stage, on the CPU.

The JAX side of the noise grid is ``scripts/make_torch_port_quality_golden.py``:
``scripts/quality_grid.py``'s stages as functions (its ``main`` checks they
reproduce the script). Sizes: the JAX script's micro test
(``tests/test_quality_grid.py``: corpus 512, queries 1,024, 4 latents,
frequencies 0.3-0.8, 25% structured noise); the closed loops with one seed
and one pair, clip or batch, short solves and a 30-frame clip.
Bars: data to the bit where both draw from numpy, distances and field values
within 1e-6, train terms at ``tests/test_torch_training.py``'s, a 2 x 4-step
solve's pose within 2e-5 and its metrics within rtol 1e-3.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.config import PoseNDFConfig  # noqa: E402
from posendf_torch.experiments import quality  # noqa: E402
from posendf_torch.experiments.interpolate import interpolate  # noqa: E402
from posendf_torch.experiments.partial import complete_by_retrieval  # noqa: E402
from posendf_torch.smpl import BodyModel  # noqa: E402
from posendf_torch.training.trainer import make_optimizer  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
MICRO = ["--preset", "smoke", "--device", "cpu", "--corpus", "512", "--queries", "1024",
         "--latents", "4", "--freq", "0.3", "0.8", "--structured-frac", "0.25"]
SOLVE_POSE_ATOL, METRIC_RTOL, METRIC_ATOL = 2e-5, 1e-3, 1e-4


def _load(name: str):
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qg = _load("torch_quality_grid")
ref = _load("make_torch_port_quality_golden")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=METRIC_RTOL, atol=METRIC_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def micro():
    """Both packages' stage 1 at the micro size, and JAX's he-matched
    initial parameters on its labels."""
    args = qg.parse_args(MICRO)
    sz = qg.sizes(args)
    fam = qg.gentle_family(123, 0.3, 0.8, 4)
    port = qg.manufacture(args, fam, sz["N"], sz["Q"], "cpu")
    jfam = ref.family(0, 4, (0.3, 0.8))
    jax_data = ref.manufacture(0, jfam, sz["N"], sz["Q"], structured_frac=0.25)
    module, init = ref.model()
    matched = ref.matched_init(module, init, jax_data["q_pose"], jax_data["q_dist"])
    return {"args": args, "fam": fam, "jfam": jfam, "port": port, "jax": jax_data,
            "module": module, "init": init, "matched": matched}


def _port_module(params):
    module = PoseNDFConfig().make_model()
    module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return module


# ------------------------------------------------------------ the noise grid

def test_manufacture_matches_jax(micro):
    """Family, corpus, labelled and held sets: poses to the bit, distances
    within 1e-6."""
    for a, b in zip(micro["fam"], micro["jfam"]):
        np.testing.assert_array_equal(a, b)
    p, j = micro["port"], micro["jax"]
    np.testing.assert_array_equal(p["corpus_np"], j["corpus_np"])
    for k in ("q_pose", "h_pose"):
        assert p[k].shape == j[k].shape
        np.testing.assert_array_equal(_np(p[k]), j[k], err_msg=k)
    np.testing.assert_allclose(_np(p["q_dist"]), j["q_dist"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(p["h_dist"], j["h_dist"], rtol=0, atol=1e-6)
    assert float(j["q_dist"].max()) > 0 and len(j["h_pose"]) > 200


@pytest.mark.parametrize("steps", [1, 300, 499, 500, 501, 1000, 4000, 12000, 20000])
def test_curriculum_matches_jax(steps):
    """Each chunk's manifold weight and the chunks' lengths, as the JAX
    script's loop (``CURRICULUM`` and ``CHUNK`` read from its source)."""
    plan = qg.chunk_plan(steps)
    assert [w for _, w in plan] == ref.curriculum_weights(steps)
    assert sum(n for n, _ in plan) == steps
    assert qg.CURRICULUM == ref.script_constants()["CURRICULUM"]


def test_gate_should_swap_matches_jax():
    jax_gate = ref.jax_script().gate_should_swap
    for best, final, want in ((0.95, float("nan"), True), (0.95, 0.30, True),
                              (0.95, 0.96, False), (0.5, 0.5, False),
                              (-np.inf, float("nan"), True)):
        assert qg.gate_should_swap(best, final) is want
        assert bool(jax_gate(best, final)) is want


def test_init_and_field_quality_match_jax(micro):
    """The he-matched init from JAX's initial weights, and the field quality
    of JAX's he-matched weights carried across, within 1e-6."""
    module = _port_module(micro["init"])
    qg.init_params(micro["args"], module, torch.from_numpy(micro["jax"]["q_pose"]),
                   torch.from_numpy(micro["jax"]["q_dist"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, micro["matched"]))
    for k, v in module.state_dict().items():
        scale = max(1e-6, float(want[k].abs().max()))
        np.testing.assert_allclose(_np(v), _np(want[k]), rtol=0, atol=1e-6 * scale, err_msg=k)

    j = micro["jax"]
    field = posendf_torch.Field(_port_module(micro["matched"]))
    got = qg.field_quality(field, torch.from_numpy(j["h_pose"]), j["h_dist"], j["corpus_np"],
                           fused=False)
    want = ref.field_quality(micro["module"], micro["matched"], j["h_pose"], j["h_dist"],
                             j["corpus_np"])
    assert 0 < want["live_frac"] and np.isfinite(want["corr"])
    for k in want:
        _close(got[k], want[k], rtol=0, atol=1e-6, msg=k)


def test_train_chunk_matches_jax(micro):
    """A 5-step chunk (w_man 0.3, w_eikonal 0.1, lr 1e-4) from JAX's
    he-matched weights on JAX's batch indices: every step's terms at rtol
    1e-5, the weights within the 2 x steps x lr two Adam runs can part and
    99% of them within lr / 20 (``tests/test_torch_training.py``)."""
    j, steps, batch, lr, wman = micro["jax"], 5, 64, 1e-4, 0.3
    args = qg.parse_args(MICRO + ["--w-eikonal", "0.1"])
    indices = ref.chunk_indices(jax.random.split(jax.random.key(3), 2)[0], steps, batch,
                                len(j["q_pose"]), len(j["corpus_np"]))
    want_params, want_terms = ref.train_chunk(micro["module"], micro["matched"], lr, wman, 0.1,
                                              j["q_pose"], j["q_dist"], j["corpus_np"], indices)
    module = _port_module(micro["matched"])
    cfg = PoseNDFConfig()
    opt = make_optimizer(module.parameters(), lr, cfg.train.weight_decay)
    step = qg.make_steps(module, opt, cfg, args, fused=False)[wman]
    traj = qg.train_chunk(step, torch.from_numpy(j["q_pose"]), torch.from_numpy(j["q_dist"]),
                          torch.from_numpy(j["corpus_np"]), steps, batch, indices=indices)
    got = np.stack([traj[k] for k in ("dist", "eikonal", "man_loss", "total")], 1)
    np.testing.assert_allclose(got, want_terms, rtol=1e-5, atol=1e-8)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    for k, v in module.state_dict().items():
        err = np.abs(_np(v).astype(np.float64) - _np(want[k]))
        assert err.max() <= 2 * steps * lr and np.mean(err > lr / 20) <= 0.01, k


@pytest.fixture(scope="module")
def l8():
    """The trained field in both packages, and its family."""
    module, init = ref.model()
    params, _ = ref.load_params(module, init, L8)
    return {"module": module, "params": params, "fam": ref.family(0, 8, (0.5, 1.2)),
            "field": posendf_torch.load_field(L8, device="cpu"), "init": init}


def test_grid_clip_matches_jax(l8):
    """One clip of the eval stream (12 frames, sigma 0.1) at a 2 x 4-step
    horizon: the clip within 1e-6, the pose within 2e-5, the grid row
    (prior on and off) within rtol 1e-3."""
    args = qg.parse_args(["--device", "cpu", "--clips", "1", "--frames", "12", "--sigmas", "0.1",
                          "--ablate-prior", "--latents", "8", "--freq", "0.5", "1.2"])
    fam = qg.gentle_family(123, 0.5, 1.2, 8)
    gt, noisy = qg.eval_clip(qg.make_rng(0, 7), fam, 12, 0.1)
    ((_, jgt, jnoisy),) = ref.eval_clips(0, l8["fam"], [0.1], 1, 12)
    np.testing.assert_allclose(gt, jgt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(noisy, jnoisy, rtol=0, atol=1e-6)

    body = BodyModel(device="cpu")
    den, _ = qg.make_denoisers(l8["field"], body, "reference", ablate=False)
    pose, m = den.optimize(noisy, gt, iterations=2, steps_per_iter=4)
    jden, _ = ref.denoisers(l8["module"], l8["params"], ablate=False)
    jpose, jm = jden.optimize(jnp.asarray(jnoisy), jnp.asarray(jgt), iterations=2,
                              steps_per_iter=4)
    np.testing.assert_allclose(_np(pose), np.asarray(jpose), rtol=0, atol=SOLVE_POSE_ATOL)
    for k in ("v2v_cm", "v2v_input_cm", "final_pose_pr"):
        _close(m[k], jm[k], msg=k)

    (row,) = qg.run_grid(l8["field"], body, fam, args, 2, 4)
    (jrow,) = ref.grid_rows(l8["module"], l8["params"], [(0.1, jgt, jnoisy)], ablate=True,
                            iterations=2, steps_per_iter=4)
    for k in ref.ROW_KEYS:
        _close(row[k], jrow[k], msg=k)
    assert row["prior_v2v_gain_cm"] == row["v2v_out_noprior_cm"] - row["v2v_out_cm"]


def test_micro_end_to_end_and_reload(tmp_path, monkeypatch):
    """The whole script at the micro size (10 steps, a 1 x 2-step grid): the
    JAX script's result keys plus the device's, finite stages; its
    ``--load-ckpt`` rerun reproduces ``field_mae`` exactly."""
    monkeypatch.setattr(qg, "GRID_SCHEDULE", (1, 2))
    ckpt = str(tmp_path / "qg.msgpack")
    common = MICRO + ["--batch", "64", "--clips", "1", "--frames", "6", "--sigmas", "0.1"]
    result = qg.main(common + ["--steps", "10", "--ablate-prior", "--save-ckpt", ckpt,
                               "--out", str(tmp_path / "qg.json")])
    keys, row_keys = ref.script_keys()
    assert set(result) == keys | {"device", "card"}
    assert result["device"] == "cpu" and result["card"] is None
    assert json.load(open(tmp_path / "qg.json")) == json.loads(json.dumps(result))
    (row,) = result["grid"]
    assert set(row) == row_keys - {"noise_level_s"}
    assert result["steps"] == 10 and result["train_s"] > 0 and result["label_s"] > 0
    assert result["fused"] is False and result["val_gate"] is True
    assert np.isfinite(result["field_mae"]) and np.isfinite(row["v2v_out_cm"])

    loaded = qg.main(common + ["--steps", "10", "--load-ckpt", ckpt])
    assert loaded["steps"] == 0 and loaded["train_s"] == 0.0 and loaded["init"] == "loaded"
    assert loaded["field_mae"] == result["field_mae"]
    assert loaded["loaded_ckpt"] == ckpt


def test_checkpoint_crosses_both_ways(tmp_path, l8):
    """JAX's ``flax.serialization`` reads the port's ``--save-ckpt`` and
    gives the same field values (within 1e-6); the port reads JAX's bytes
    to the bit."""
    from flax import serialization as fser

    path = str(tmp_path / "port.msgpack")
    qg.save_ckpt(path, l8["field"].module, 7)
    params, epoch = ref.load_params(l8["module"], l8["init"], path)
    assert int(epoch) == 7
    probes = np.random.default_rng(0).normal(size=(64, 21, 4)).astype(np.float32)
    want = np.asarray(l8["module"].apply({"params": params}, jnp.asarray(probes)))
    with torch.no_grad():
        got = _np(l8["field"].distance(torch.from_numpy(probes)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    jpath = str(tmp_path / "jax.msgpack")
    with open(jpath, "wb") as f:
        f.write(fser.to_bytes({"epoch": 3, "state": {"params": l8["params"]}}))
    module = PoseNDFConfig().make_model()
    assert qg.load_ckpt(jpath, module) == 3
    for k, v in module.state_dict().items():
        assert torch.equal(v, l8["field"].module.state_dict()[k]), k


# -------------------------------------------------------- the closed loops

def test_interp_closed_loop_matches_jax(l8):
    """One seed, one pair of each condition (20 waypoints and 50 projection
    steps, the defaults; a 32,768-pose oracle corpus): endpoints to the
    bit, the projected path and distances at the projection's bars, the
    oracle's values within 1e-6, the row's measurements within rtol 1e-4."""
    from posendf_tpu.data.synthetic import synthetic_manifold_poses as jax_poses
    from posendf_tpu.experiments.interpolate import interpolate as jax_interpolate
    from posendf_tpu.ops.knn import geodesic_topk as jax_topk
    from posendf_tpu.quat import quat_slerp as jax_slerp

    iq = _load("torch_interp_quality")
    args = iq.parse_args(["--device", "cpu", "--seeds", "1", "--pairs", "1", "--corpus-size",
                          "32768"])
    fam = quality.gentle_family(123, 0.5, 1.2, 8)
    corpus = iq.make_corpus(fam, args.corpus_size, "cpu")
    jcorpus = jnp.asarray(jax_poses(np.random.default_rng(777), args.corpus_size,
                                    family=l8["fam"]))
    np.testing.assert_array_equal(_np(corpus), np.asarray(jcorpus))
    rows = iq.run_rows(l8["field"], corpus, fam, args)
    rng = np.random.default_rng([1, 602])
    t = jnp.linspace(0.0, 1.0, args.num_steps)
    for cond, row in zip(iq.CONDITIONS, rows):
        e = iq.endpoints(rng, cond, fam, args.noise_sigma)
        a, b = jnp.asarray(e[0]), jnp.asarray(e[1])
        raw = jax_slerp(a, b, t)
        proj, d_proj = jax_interpolate(l8["module"], l8["params"], a, b,
                                       num_steps=args.num_steps,
                                       projection_steps=args.projection_steps)
        path, dist = interpolate(
            l8["field"], e[0], e[1], num_steps=args.num_steps,
            projection_steps=args.projection_steps)
        np.testing.assert_allclose(_np(path), np.asarray(proj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(dist), np.asarray(d_proj), rtol=0, atol=1e-5)
        tr = np.asarray(jax_topk(raw, jcorpus, k=5, precision="highest")[0]).mean(-1)
        np.testing.assert_allclose(
            quality.true_knn_mean(np.asarray(raw), corpus), tr,
            rtol=0, atol=1e-6)
        tp = np.asarray(jax_topk(proj, jcorpus, k=5, precision="highest")[0]).mean(-1)
        want = {"true_raw_mean": tr.mean(), "true_raw_max": tr.max(),
                "true_proj_mean": tp.mean(), "true_proj_max": tp.max(),
                "field_raw_mean": float(jnp.mean(l8["module"].apply({"params": l8["params"]},
                                                                      raw))),
                "field_proj_mean": float(np.asarray(d_proj).mean()),
                "sep": float(jnp.mean(1 - jnp.abs(jnp.sum(a * b, -1))))}
        for k, v in want.items():
            _close(row[k], v, rtol=1e-4, atol=1e-6, msg=f"{cond} {k}")
    summary = iq.summarize(rows)
    assert summary["noisy"]["n"] == 1 and set(summary) == set(iq.CONDITIONS)


def test_partial_closed_loop_matches_jax(l8):
    """One seed, one clip of 30 frames of each condition (a 131,072-pose
    corpus, the default), the solves cut to 2 x 4 steps: the
    corrupted clip within 1e-6, the probe within 1e-6, the retrieval's
    completion within 1e-5 and its errors within 1e-3 degrees, each solve's
    v2v within rtol 1e-3 and its pose within ``tests/test_torch_partial.py``'s
    bar: 5e-5, or twice the larger spread of either package's solve under a
    one-ulp change of the input where that is larger (a zeroed arm sits at the joint-axis normalization's
    directional singularity, where the prior's gradient is huge)."""
    from posendf_tpu.data.synthetic import synthetic_manifold_poses as jax_poses
    from posendf_tpu.data.synthetic import synthetic_motion_sequence as jax_sequence
    from posendf_tpu.experiments.partial import INPAINT_SPECS, PARTIAL_SPECS, PartialCompleter
    from posendf_tpu.experiments.partial import complete_by_retrieval as jax_retrieval
    from posendf_tpu.ops.knn import geodesic_topk as jax_topk
    from posendf_tpu.quat import axis_angle_to_quaternion as jax_aa2q
    from posendf_tpu.quat import quaternion_to_axis_angle as jax_q2aa
    from posendf_tpu.smpl import BodyModel as JaxBody

    pq = _load("torch_partial_quality")
    args = pq.parse_args(["--device", "cpu", "--seeds", "1", "--clips", "1", "--frames", "30"])
    fam = quality.gentle_family(123, 0.5, 1.2, 8)
    corpus_np = jax_poses(np.random.default_rng(777), args.corpus_size, family=l8["fam"])
    corpus = torch.from_numpy(corpus_np)
    schedules = {"anchor": (2, 4), "inpaint": (2, 4)}
    body, jbody = BodyModel(device="cpu"), JaxBody()
    solvers = pq.make_solvers(l8["field"], body)

    def jspecs(specs, on):
        s = dict(specs)
        if not on:
            s["pose_pr"] = s["pose_pr"]._replace(scale=0.0)
        return s

    jsolvers = {(m, on): PartialCompleter(l8["module"], l8["params"], jbody,
                                          specs=jspecs(PARTIAL_SPECS if m == "anchor"
                                                       else INPAINT_SPECS, on))
                for (m, on) in solvers}
    rng, jrng = np.random.default_rng([1, 501]), np.random.default_rng([1, 501])
    for cond, (occ, kind) in pq.CONDITIONS.items():
        vis = np.asarray([j for j in range(21) if j not in set(occ.tolist())], int)
        gt_q, gt63, bad63 = pq.corrupt_clip(rng, fam, args.frames, occ, kind, args.noise_sigma)
        jgt_q = jax_sequence(jrng, args.frames, family=l8["fam"])
        jgt63 = np.asarray(jax_q2aa(jnp.asarray(jgt_q))).reshape(args.frames, 63)
        jbad = jgt63.copy().reshape(args.frames, 21, 3)
        if kind == "zero":
            jbad[:, occ] = 0.0
        else:
            jbad[:, occ] += args.noise_sigma * jrng.standard_normal((args.frames, len(occ), 3))
        jbad63 = jbad.reshape(args.frames, 63).astype(np.float32)
        np.testing.assert_array_equal(gt_q, jgt_q)
        np.testing.assert_allclose(bad63, jbad63, rtol=0, atol=1e-6)

        got = pq.probe(l8["field"], corpus, gt63, bad63)
        for tag, p63 in (("gt", jgt63), ("corrupted", jbad63)):
            q = jax_aa2q(jnp.asarray(p63).reshape(-1, 21, 3))
            _close(got[f"field_d_{tag}"],
                   float(jnp.mean(l8["module"].apply({"params": l8["params"]}, q))), rtol=0,
                   atol=1e-6)
            _close(got[f"true_5nn_{tag}"],
                   float(jnp.mean(jax_topk(q, jnp.asarray(corpus_np), k=5,
                                           precision="highest")[0])), rtol=0, atol=1e-6)

        out = pq.complete_clip(l8["field"], body, solvers, corpus_np, gt_q, gt63, bad63, occ,
                               vis, args.retrieval_k, schedules)
        jq_bad = np.asarray(jax_aa2q(jnp.asarray(jbad63).reshape(args.frames, 21, 3)))
        jdone = jax_retrieval(corpus_np, jq_bad, occ.tolist(), k=args.retrieval_k)
        pdone = complete_by_retrieval(
            corpus_np, pq.to_quats(bad63, "cpu").numpy(), occ.tolist(), k=args.retrieval_k,
            device="cpu")
        np.testing.assert_allclose(pdone, np.asarray(jdone), rtol=0, atol=1e-5)
        jout63 = np.asarray(jax_q2aa(jnp.asarray(jdone))).reshape(args.frames, 63)
        for k, v in zip(("occ_retrieval", "vis_retrieval"),
                        pq.joint_deg(jout63, jgt_q, occ, vis)):
            _close(out[k], v, rtol=0, atol=1e-3, msg=f"{cond} {k}")
        for (mode, on), solver in jsolvers.items():
            def jsolve(x):
                return solver.optimize(jnp.asarray(x), jnp.asarray(jgt63), iterations=2,
                                       steps_per_iter=4, occluded_joints=occ.tolist(),
                                       mode=mode)

            pose, m = jsolve(jbad63)
            tag = f"{mode}_{'on' if on else 'off'}"
            _close(out[f"v2v_{tag}"], m["v2v_cm"], msg=f"{cond} {tag}")
            def psolve(x):
                return _np(solvers[(mode, on)].optimize(
                    x, gt63, iterations=2, steps_per_iter=4, occluded_joints=occ.tolist(),
                    mode=mode)[0])

            port_pose = psolve(bad63)
            # the bar of tests/test_torch_partial.py and test_torch_fit_image.py: 5e-5, or
            # twice the larger one-ulp spread of the two packages' solves (measured only
            # where 5e-5 does not hold)
            bar = 5e-5
            if float(np.abs(port_pose - np.asarray(pose)).max()) > bar:
                bar = 2 * max(max(float(np.abs(np.asarray(jsolve(np.nextafter(
                    jbad63, np.float32(d)).astype(np.float32))[0]) - np.asarray(pose)).max()),
                    float(np.abs(psolve(np.nextafter(bad63, np.float32(d)).astype(np.float32))
                                 - port_pose).max())) for d in (np.inf, -np.inf))
            np.testing.assert_allclose(port_pose, np.asarray(pose), rtol=0, atol=bar,
                                       err_msg=f"{cond} {tag}")
        assert out["occ_retrieval"] < out["occ_in"]


def test_fit_image_closed_loop_matches_jax(l8, monkeypatch):
    """One seed, one batch of 2 poses, each condition, 2 x 3 steps a stage,
    JAX's stage-2 draw: the ground truth's keypoints within 1e-3 px, the
    corruption to the bit beside them, the fits' joint-angle and joint
    errors and 2D residual within rtol 1e-3."""
    from posendf_tpu.experiments.camera import project_points as jax_project
    from posendf_tpu.experiments.fit_image import ImageFitter as JaxFitter
    from posendf_tpu.smpl import BodyModel as JaxBody
    from posendf_tpu.smpl.lbs import lbs_forward as jax_lbs
    from posendf_tpu.smpl.lbs import with_landmarks as jax_landmarks
    from posendf_torch.experiments.fit_image import ImageFitter

    fq = _load("torch_fit_image_quality")
    B = 2
    monkeypatch.setattr(ImageFitter, "_stage2_pose", lambda self, n: torch.from_numpy(
        np.asarray(1e-2 * jax.random.normal(jax.random.key(0), (n, 69)))).to(self.device))
    args = fq.parse_args(["--device", "cpu", "--seeds", "1", "--batch", str(B),
                          "--iterations", "2", "--steps-per-iter", "3"])
    fam = quality.gentle_family(123, 0.5, 1.2, 8)
    fitters = fq.make_fitters(l8["field"], BodyModel(device="cpu"), args.prior_form)
    rows = fq.run_rows(fitters, fam, args)

    jbody = JaxBody()
    jfit = {"on": JaxFitter(l8["module"], l8["params"], jbody, prior_form=args.prior_form),
            "off": JaxFitter(l8["module"], l8["params"], jbody, prior_scale=0.0,
                             prior_form=args.prior_form)}
    rng = np.random.default_rng([1, 77])
    gt_quats, gt_pose, gt_xy = fq.ground_truth(np.random.default_rng([1, 77]), fam,
                                               fitters["on"], B)
    from posendf_tpu.data.synthetic import synthetic_manifold_poses as jax_poses
    from posendf_tpu.quat import quaternion_to_axis_angle as jax_q2aa

    jq = jax_poses(rng, B, family=l8["fam"])
    jpose = np.zeros((B, 69), np.float32)
    jpose[:, :63] = np.asarray(jax_q2aa(jnp.asarray(jq))).reshape(B, 63)
    orient = rng.normal(scale=0.2, size=(B, 3)).astype(np.float32)
    trans = np.zeros((B, 3), np.float32)
    trans[:, :2] = rng.uniform(-0.3, 0.3, (B, 2))
    trans[:, 2] = 10.0 + rng.uniform(-1.0, 1.0, B)
    verts, joints = jax_lbs(jbody.model, jnp.zeros((B, jbody.num_betas)), jnp.asarray(orient),
                            jnp.asarray(jpose))
    cam = {"rotation": jnp.tile(jnp.eye(3)[None], (B, 1, 1)), "translation": jnp.asarray(trans)}
    jxy = np.asarray(jax_project(cam, jfit["on"]._mapped_joints(jax_landmarks(verts, joints)),
                                 jfit["on"].focal_length,
                                 jnp.tile(jnp.asarray(fq.CENTER)[None], (B, 1))))
    np.testing.assert_array_equal(gt_quats, jq)
    np.testing.assert_allclose(gt_xy, jxy, rtol=0, atol=1e-3)

    for cond, sig_px, n_drop in (("clean", 0.0, 0), ("noise", args.noise_px, 0),
                                 ("occluded", args.noise_px, args.drop)):
        kp = fq.corrupt(rng, jxy, sig_px, n_drop)
        for label in ("on", "off"):
            res, m = jfit[label].optimize(kp, iterations=2, steps_per_iter=3, center=fq.CENTER)
            deg, cm = fq.pose_metrics(fitters["on"].body_model, np.asarray(res["pose_body"]),
                                      gt_pose, gt_quats)
            (row,) = [r for r in rows if r["condition"] == cond and r["prior"] == label]
            _close(row["pose_err_deg"], deg, atol=2e-3, msg=f"{cond} {label} deg")
            _close(row["joint_err_cm"], cm, atol=2e-3, msg=f"{cond} {label} cm")
            _close(row["stage2_px_residual"], m["stage2_final_data"], atol=2e-3,
                   msg=f"{cond} {label} px")
    summary = fq.summarize(rows, 1)
    assert [s["condition"] for s in summary] == ["clean", "noise", "occluded"]
