"""Write the JAX package's expected values for the port's multi-device paths.

Runs the reference (``posendf_tpu``, JAX on the CPU) on a mesh of 4 virtual
CPU devices (``--xla_force_host_platform_device_count=4``) and stores into
``tests/data/torch_port_parallel_expected.npz``:

  train_init/<name>         the initial weights of a small lrelu field
                            (dims 32, 48, live head; the JAX trainer's
                            ``key(0)`` init), as the port's state dict
  train_batch{0,1}_{pose,dist,man_poses}  two 64-row batches (seeded numpy)
  ragged_{pose,dist,man_poses}            a 66-row batch (does not divide
                            over 4 ranks; the port's tests only)
  fused_metrics, auto_metrics  (2, 4)  total, dist, man_loss, eikonal of two
                            steps of the mesh trainer, fused (the Pallas
                            kernel in interpret mode under ``shard_map`` +
                            ``pmean``) and autodiff (the SPMD step)
  fused_params/<name>, auto_params/<name>  the weights after the two steps
  label_clean, label_corpus  (32, 21, 4), (300, 21, 4)  the labelling inputs
  label_dist, label_pose    ``label_sequence(num_queries=100, k=5,
                            rng=default_rng(1), mesh=mesh)`` (the XLA scan)
  den_params/<name>         a seeded softplus field, dims (32,)
  den_noisy, den_pose       (16, 69)  ``MotionDenoiser.optimize`` of a
                            noisy clip on the 64-vertex synthetic body,
                            1 x 4 steps, frames sharded over the mesh
  den_final_pose_pr         its last prior term

``tests/test_torch_parallel.py`` holds the port's sharded paths (4 gloo CPU
ranks) to these. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_parallel_golden.py
"""

from __future__ import annotations

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_parallel_expected.npz")
DEVICES = 4
DIMS = [32, 48]
LR = 1e-3
TERMS = ("total", "dist", "man_loss", "eikonal")


def make_batches():
    """Two 64-row batches and a 66-row one: unit-quaternion poses, |N(0,1)|
    x 0.1 labels (numpy only)."""
    import numpy as np

    rng = np.random.default_rng(11)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    def batch(n):
        return {"pose": unit(n), "dist": (np.abs(rng.normal(size=n)) * 0.1).astype(np.float32),
                "man_poses": unit(n)}

    return [batch(64), batch(64)], batch(66)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={DEVICES}")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu

    from posendf_torch.checkpoints import params_from_jax
    from posendf_torch.data.synthetic import synthetic_manifold_poses
    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.data.prepare import label_sequence
    from posendf_tpu.experiments import MotionDenoiser
    from posendf_tpu.models import PoseNDF
    from posendf_tpu.parallel import make_mesh
    from posendf_tpu.smpl import BodyModel, synthetic_model
    from posendf_tpu.training.trainer import Trainer

    assert len(jax.devices()) == DEVICES, jax.devices()
    mesh = make_mesh(("data",))
    out = {}

    def state(params, prefix):
        for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray, params)).items():
            out[f"{prefix}/{k}"] = v.numpy()

    # ---- training: two fused and two autodiff steps on the mesh -----------
    batches, ragged = make_batches()
    for i, b in enumerate(batches):
        for k, v in b.items():
            out[f"train_batch{i}_{k}"] = v
    for k, v in ragged.items():
        out[f"ragged_{k}"] = v
    for fused in (True, False):
        cfg = PoseNDFConfig()
        cfg.experiment.root_dir = tempfile.mkdtemp(prefix="posendf_parallel_golden_")
        cfg.dfnet.dims = list(DIMS)
        cfg.dfnet.live_head = True
        cfg.train.optimizer_param = LR
        cfg.train.continue_train = False
        cfg.train.fused_grads = fused
        trainer = Trainer(cfg, mesh=mesh)
        if fused:
            state(trainer.params, "train_init")
        with pltpu.force_tpu_interpret_mode():
            metrics = [trainer.train_step({k: jnp.asarray(v) for k, v in b.items()})
                       for b in batches]
        name = "fused" if fused else "auto"
        out[f"{name}_metrics"] = np.asarray([[float(m[k]) for k in TERMS] for m in metrics])
        state(trainer.params, f"{name}_params")

    # ---- labelling: queries sharded, corpus replicated ----------------------
    rng = np.random.default_rng(5)
    clean = synthetic_manifold_poses(rng, 32)
    corpus = synthetic_manifold_poses(rng, 300)
    lab = label_sequence(clean, jnp.asarray(corpus), num_queries=100, k=5,
                         rng=np.random.default_rng(1), mesh=mesh)
    out.update(label_clean=clean, label_corpus=corpus, label_dist=np.asarray(lab["dist"]),
               label_pose=np.asarray(lab["pose"]))

    # ---- frame-sharded denoising ------------------------------------------------
    module = PoseNDF(dfnet_dims=(32,), activation="softplus")
    params = module.init(jax.random.key(0), jnp.zeros((1, 21, 4)))["params"]
    body = BodyModel(model=synthetic_model(num_vertices=64, seed=2))
    noisy = np.random.default_rng(7).normal(scale=0.2, size=(16, 69)).astype(np.float32)
    pose, m = MotionDenoiser(module, params, body).optimize(
        jnp.asarray(noisy), iterations=1, steps_per_iter=4, mesh=mesh)
    state(params, "den_params")
    out.update(den_noisy=noisy, den_pose=np.asarray(pose),
               den_final_pose_pr=np.float64(m["final_pose_pr"]))

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}: fused total {out['fused_metrics'][:, 0].tolist()}, autodiff total "
          f"{out['auto_metrics'][:, 0].tolist()}, {len(lab['pose'])} labelled queries, "
          f"denoise prior {m['final_pose_pr']:.6g}")


if __name__ == "__main__":
    main()
