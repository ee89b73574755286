"""Write the JAX package's expected values for the port's motion-denoising path.

Runs the reference (``posendf_tpu``, JAX on the CPU) on the trained
full-width lrelu field ``docs/quality/ckpt_l8_best.msgpack`` (at
``precision="highest"``) and the 128-vertex ``synthetic_model`` body, on one
60-frame clip of the field's training manifold (the family of
``docs/quality/run_l8_12k_ablation.json``: seed 123, 8 latents, frequencies
0.5-1.2, as ``scripts/quality_grid.py`` builds it) with sigma-0.1 noise on
its 63 body dofs, and stores into
``tests/data/torch_port_denoise_expected.npz``:

  noisy, gt            (60, 69)   the clip, axis-angle, hands zero
  solve_pose           (60, 69)   ``MotionDenoiser.optimize`` of ``noisy``,
                                  the reference schedule, 2 x 5 steps
  hist_pose_pr, hist_temp, hist_data, hist_total  (10,)  its history
  probe_noise          (60, 21, 4)  sigma_ref 0.1 times the uniform draw
                                  of ``jax.random.key(0)`` (the estimator's
                                  default)
  noise_stats          (6,)       ``estimate_clip_noise`` of the clip:
                                  s, s_field, s_temporal, d_input, d_floor,
                                  d_probe
  interp_a, interp_b   (21, 4)    the clean clip's first and last frames
  interp_path, interp_dist  (10, 21, 4), (10,)  ``interpolate`` between
                                  them, 10 waypoints, 10 projection steps

``tests/test_torch_experiments.py`` holds the port's CPU path to these and
``chip_smoke.py`` its path on the card. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_denoise_golden.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_denoise_expected.npz")
FAMILY_SEED, LATENTS, FREQ = 123, 8, (0.5, 1.2)
CLIP_SEED, FRAMES, SIGMA = 7, 60, 0.1
ITERATIONS, STEPS_PER_ITER = 2, 5
STAT_KEYS = ("s", "s_field", "s_temporal", "d_input", "d_floor", "d_probe")


def make_clip():
    """(noisy, gt) (60, 69) float32 axis-angle, and the clean clip's (60, 21, 4)
    quaternions: numpy only, so the port's tests and ``chip_smoke.py`` can
    rebuild the clip with the port's own ``data.synthetic`` copy."""
    import numpy as np

    from posendf_torch.data.synthetic import manifold_family, synthetic_motion_sequence

    family = manifold_family(np.random.default_rng(FAMILY_SEED), 21, latents=LATENTS,
                             freq_range=FREQ)
    rng = np.random.default_rng(CLIP_SEED)
    quats = synthetic_motion_sequence(rng, FRAMES, family=family)
    noise = rng.standard_normal((FRAMES, 63)).astype(np.float32)
    return quats, noise


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.experiments import MotionDenoiser, interpolate
    from posendf_tpu.experiments.denoise import estimate_clip_noise
    from posendf_tpu.field import load_field
    from posendf_tpu.quat import axis_angle_to_quaternion, quaternion_to_axis_angle
    from posendf_tpu.smpl import BodyModel

    cfg = PoseNDFConfig()
    cfg.dfnet.precision = "highest"
    field = load_field(CKPT, config=cfg)
    quats, noise = make_clip()
    gt = np.zeros((FRAMES, 69), np.float32)
    gt[:, :63] = np.asarray(quaternion_to_axis_angle(jnp.asarray(quats))).reshape(FRAMES, 63)
    noisy = gt.copy()
    noisy[:, :63] += SIGMA * noise

    den = MotionDenoiser(field.module, field.params, BodyModel())
    pose, _ = den.optimize(jnp.asarray(noisy), jnp.asarray(gt), iterations=ITERATIONS,
                           steps_per_iter=STEPS_PER_ITER)
    # the history: the solver the denoiser just built, on the same inputs
    init = den.body_model(pose_body=jnp.asarray(noisy))
    aux = {"params": field.params, "smpl": den.body_model.model, "betas": init.betas,
           "init_joints": init.Jtr}
    pose2, hist = den._solver(ITERATIONS, STEPS_PER_ITER)(init.body_pose, aux)
    assert np.array_equal(np.asarray(pose), np.asarray(pose2))

    in_quats = axis_angle_to_quaternion(jnp.asarray(noisy[:, :63]).reshape(FRAMES, 21, 3))
    stats = estimate_clip_noise(field.module, field.params, in_quats)
    probe_noise = 0.1 * jax.random.uniform(jax.random.key(0), in_quats.shape)

    path, dist = interpolate(field.module, field.params, jnp.asarray(quats[0]),
                             jnp.asarray(quats[-1]), num_steps=10, projection_steps=10)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, noisy=noisy, gt=gt, solve_pose=np.asarray(pose),
             **{f"hist_{k}": np.asarray(v) for k, v in hist.items()},
             probe_noise=np.asarray(probe_noise),
             noise_stats=np.asarray([stats[k] for k in STAT_KEYS], np.float64),
             interp_a=quats[0], interp_b=quats[-1], interp_path=np.asarray(path),
             interp_dist=np.asarray(dist))
    print(f"wrote {OUT}: pose_pr {float(hist['pose_pr'][0]):.6f} -> "
          f"{float(hist['pose_pr'][-1]):.6f}, s {stats['s']:.4f}, "
          f"interpolation d {np.asarray(dist).round(5).tolist()}")


if __name__ == "__main__":
    main()
