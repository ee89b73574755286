"""Write the JAX package's expected values for the port's partial-completion
and image-fitting path.

Runs the reference (``posendf_tpu``, JAX on the CPU) on the trained
full-width lrelu field ``docs/quality/ckpt_l8_best.msgpack`` (at
``precision="highest"``) and the 128-vertex ``synthetic_model`` body. The
inputs come from :func:`make_inputs` (numpy only, through the port's copy of
``data/synthetic.py``, so the port's tests and ``chip_smoke.py`` rebuild
them and the file stores no corpus): a 60-frame clip of the field's
training manifold (seed 123, 8 latents, frequencies 0.5-1.2, as
``scripts/quality_grid.py`` builds it) whose left arm (body joints 12, 15,
17, 19) is corrupted by N(0, 0.5) per quaternion component and
renormalized, and a 16,384-pose corpus of the same manifold. Stored in
``tests/data/torch_port_partial_expected.npz``:

  pose              (60, 69)     the corrupted clip, axis-angle, hands zero
  anchor_pose, inpaint_pose  (60, 69)  ``PartialCompleter.optimize`` of it,
                                 ``mode="anchor"`` (``PARTIAL_SPECS``) and
                                 ``mode="inpaint"`` (``INPAINT_SPECS``),
                                 2 x 5 steps
  anchor_hist_<term>, inpaint_hist_<term>  (10,)  their histories
  anchor_ulp_spread, inpaint_ulp_spread  ()  how far each solve's pose moves
                                 when every input float moves one unit in
                                 the last place (up or down, the larger):
                                 JAX's own sensitivity to rounding, the
                                 floor of any bar that holds another
                                 implementation to it
  retrieval_idx     (60, 5)      the visible-joint search's neighbours
  retrieval_dist    (60, 5)      and distances
  retrieval_out     (60, 21, 4)  ``complete_by_retrieval``, k 5, window 5
  keypoints         (2, 25, 3)   frames 0 and 30 of the clean clip rendered
                                 through a camera 10 m away, rotated by the
                                 axis-angle (0.2, -0.15, 0.1) (~17 degrees)
  center            (2,)         the principal point
  stage2_draw       (2, 69)      1e-2 x ``jax.random.normal(key(0))``
  fit_<key>         ``ImageFitter.optimize``'s result, 2 x 5 steps a stage
  fit_metrics       (4,)         its metrics, in FIT_METRICS order

``tests/test_torch_partial.py`` and ``tests/test_torch_fit_image.py`` hold
the port's CPU path to these and ``chip_smoke.py`` its path on the card.
Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_partial_golden.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_partial_expected.npz")
FAMILY_SEED, LATENTS, FREQ = 123, 8, (0.5, 1.2)
CLIP_SEED, FRAMES, CORRUPTION = 11, 60, 0.5
CORPUS_SEED, CORPUS_ROWS = 12, 16_384
OCCLUDED = (12, 15, 17, 19)       # l_collar, l_shoulder, l_elbow, l_wrist
ITERATIONS, STEPS_PER_ITER, K, WINDOW = 2, 5, 5, 5
CAM_ROT, CAM_DEPTH, CENTER = (0.2, -0.15, 0.1), 10.0, (64.0, 48.0)
FIT_FRAMES = (0, 30)
FIT_METRICS = ("stage1_final_data", "stage2_final_data", "stage2_final_prior",
               "stage3_final_prior")


def make_inputs():
    """(clean clip (60, 21, 4), corrupted clip (60, 21, 4), corpus (16384,
    21, 4)) float32 quaternions, numpy only."""
    import numpy as np

    from posendf_torch.data.synthetic import (manifold_family, synthetic_manifold_poses,
                                              synthetic_motion_sequence)

    family = manifold_family(np.random.default_rng(FAMILY_SEED), 21, latents=LATENTS,
                             freq_range=FREQ)
    rng = np.random.default_rng(CLIP_SEED)
    clean = synthetic_motion_sequence(rng, FRAMES, family=family)
    bad = clean.copy()
    occ = list(OCCLUDED)
    bad[:, occ] += CORRUPTION * rng.standard_normal((FRAMES, len(occ), 4)).astype(np.float32)
    bad[:, occ] /= np.linalg.norm(bad[:, occ], axis=-1, keepdims=True)
    corpus = synthetic_manifold_poses(np.random.default_rng(CORPUS_SEED), CORPUS_ROWS,
                                      family=family)
    return clean, bad, corpus


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.experiments import ImageFitter, PartialCompleter, project_points
    from posendf_tpu.experiments.fit_image import SMPL_TO_OPENPOSE
    from posendf_tpu.experiments.partial import (INPAINT_SPECS, complete_by_retrieval,
                                                 dof_mask, observation_mask)
    from posendf_tpu.field import load_field
    from posendf_tpu.ops.knn import geodesic_topk
    from posendf_tpu.quat import axis_angle_to_matrix, quaternion_to_axis_angle
    from posendf_tpu.smpl import BodyModel

    cfg = PoseNDFConfig()
    cfg.dfnet.precision = "highest"
    field = load_field(CKPT, config=cfg)
    body = BodyModel()
    clean, bad, corpus = make_inputs()
    pose = np.zeros((FRAMES, 69), np.float32)
    pose[:, :63] = np.asarray(quaternion_to_axis_angle(jnp.asarray(bad))).reshape(FRAMES, 63)
    out = {"pose": pose}

    occ = list(OCCLUDED)
    for mode, specs in (("anchor", None), ("inpaint", INPAINT_SPECS)):
        comp = PartialCompleter(field.module, field.params, body, specs=specs)
        final, _ = comp.optimize(jnp.asarray(pose), iterations=ITERATIONS,
                                 steps_per_iter=STEPS_PER_ITER, occluded_joints=occ, mode=mode)
        # the history: the solver the completer just built, on the same inputs
        init = comp.body_model(pose_body=jnp.asarray(pose))
        aux = {"params": field.params, "smpl": comp.body_model.model, "betas": init.betas,
               "init_joints": init.Jtr,
               "data_joint_mask": jnp.asarray(observation_mask(body, occ))}
        if mode == "inpaint":
            aux["param_mask"] = jnp.broadcast_to(jnp.asarray(dof_mask(occ)), init.body_pose.shape)
        final2, hist = comp._solver(ITERATIONS, STEPS_PER_ITER)(init.body_pose, aux)
        assert np.array_equal(np.asarray(final), np.asarray(final2))
        out[f"{mode}_pose"] = np.asarray(final)
        out[f"{mode}_ulp_spread"] = np.float64(max(
            float(np.abs(np.asarray(comp.optimize(
                jnp.asarray(np.nextafter(pose, np.float32(d)).astype(np.float32)),
                iterations=ITERATIONS, steps_per_iter=STEPS_PER_ITER, occluded_joints=occ,
                mode=mode)[0]) - out[f"{mode}_pose"]).max()) for d in (np.inf, -np.inf)))
        out.update({f"{mode}_hist_{k}": np.asarray(v) for k, v in hist.items()})

    w = np.ones(21, np.float32)
    w[occ] = 0.0
    w /= np.linalg.norm(w)
    dist, idx = geodesic_topk(jnp.asarray(bad), jnp.asarray(corpus), k=K, weights=jnp.asarray(w),
                              precision="highest")
    out["retrieval_idx"] = np.asarray(idx)
    out["retrieval_dist"] = np.asarray(dist)
    out["retrieval_out"] = complete_by_retrieval(corpus, bad, occ, k=K, temporal_window=WINDOW)

    # keypoints of two clean frames through a known camera, the 24-joint table
    gt_pose = np.zeros((len(FIT_FRAMES), 69), np.float32)
    gt_pose[:, :63] = np.asarray(quaternion_to_axis_angle(
        jnp.asarray(clean[list(FIT_FRAMES)]))).reshape(len(FIT_FRAMES), 63)
    B = len(FIT_FRAMES)
    cam = {"rotation": jnp.tile(axis_angle_to_matrix(jnp.asarray([CAM_ROT])), (B, 1, 1)),
           "translation": jnp.tile(jnp.asarray([[0.0, 0.0, CAM_DEPTH]]), (B, 1))}
    gather = np.where(SMPL_TO_OPENPOSE >= 0, SMPL_TO_OPENPOSE, 0)
    center = np.asarray(CENTER, np.float32)
    xy = np.asarray(project_points(cam, body(pose_body=jnp.asarray(gt_pose)).Jtr[:, gather],
                                   5000.0, jnp.tile(jnp.asarray(center)[None], (B, 1))))
    conf = np.broadcast_to((SMPL_TO_OPENPOSE >= 0).astype(np.float32)[None, :, None], (B, 25, 1))
    keypoints = np.concatenate([xy, conf], axis=2).astype(np.float32)
    fitter = ImageFitter(field.module, field.params, body)
    result, metrics = fitter.optimize(keypoints, iterations=ITERATIONS,
                                      steps_per_iter=STEPS_PER_ITER, center=center)
    out.update(keypoints=keypoints, center=center,
               stage2_draw=np.asarray(1e-2 * jax.random.normal(jax.random.key(0), (B, 69))),
               fit_metrics=np.asarray([metrics[k] for k in FIT_METRICS], np.float64),
               **{f"fit_{k}": np.asarray(v) for k, v in result.items()})

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)

    def occ_err(q):
        return float(np.mean(1.0 - np.abs(np.sum(q[:, occ] * clean[:, occ], -1))))

    print(f"wrote {OUT}: anchor pose_pr {float(out['anchor_hist_pose_pr'][0]):.6f} -> "
          f"{float(out['anchor_hist_pose_pr'][-1]):.6f}; retrieval occluded error "
          f"{occ_err(bad):.4f} -> {occ_err(out['retrieval_out']):.4f}; fit "
          f"{dict(zip(FIT_METRICS, np.round(out['fit_metrics'], 6).tolist()))}")


if __name__ == "__main__":
    main()
