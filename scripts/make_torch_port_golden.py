"""Write the JAX package's expected values for the PyTorch port's checks.

Runs the reference (``posendf_tpu``, JAX on the CPU) on the trained
full-width lrelu field ``docs/quality/ckpt_l8_best.msgpack`` at
``precision="highest"`` and stores, for 256 numpy-seeded probe poses:

  probes      (256, 21, 4)  half uniform-[0, 1) quaternions (as
                            ``random_poses`` draws them), half Gaussian ones,
                            each normalized per joint
  dist, grad  (256, 1), (256, 21, 4)  from ``Field.distance_and_grad``
  proj_out, proj_hist  (256, 21, 4), (10, 256)  a 10-step renormalized
                            projection (``projection.project``)

into ``tests/data/torch_port_l8_expected.npz``. ``chip_smoke.py`` holds the
port's kernels to these values on the GPU and ``tests/test_torch_slice.py``
holds its CPU path to them. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_l8_expected.npz")
SEED = 20221023
NUM_PROBES = 256
PROJ_STEPS = 10


def probes(seed: int = SEED, n: int = NUM_PROBES):
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.uniform(size=(n // 2, 21, 4)),
                        rng.normal(size=(n - n // 2, 21, 4))]).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.field import load_field
    from posendf_tpu.projection import project

    cfg = PoseNDFConfig()
    cfg.dfnet.precision = "highest"
    field = load_field(CKPT, config=cfg)
    q = jnp.asarray(probes())
    d, g = field.distance_and_grad(q)
    out, hist = project(field.module, field.params, q, steps=PROJ_STEPS)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, probes=np.asarray(q), dist=np.asarray(d), grad=np.asarray(g),
             proj_out=np.asarray(out), proj_hist=np.asarray(hist))
    print(f"wrote {OUT}: mean d {float(d.mean()):.6f}, "
          f"projection mean d {float(hist[0].mean()):.6f} -> {float(hist[-1].mean()):.6f}")


if __name__ == "__main__":
    main()
