"""Write the JAX package's bf16 values for the PyTorch port's checks.

Runs the reference (``posendf_tpu``, JAX on the CPU, the Pallas kernels in
interpret mode) on the trained full-width lrelu field
``docs/quality/ckpt_l8_best.msgpack`` loaded with
``compute_dtype="bfloat16"``, on the 256 probe poses of
``scripts/make_torch_port_golden.py`` (the same poses as
``tests/data/torch_port_l8_expected.npz``, whose fp32 values give the
bf16-vs-fp32 gap), and stores:

  probes          (256, 21, 4)  the probe poses
  fwd_dist        (256, 1)      the fused forward (``_model_kernel``, bf16)
  vag_dist, vag_grad  (256, 1), (256, 21, 4)  the fused value-and-grad
                                (``_vag_kernel``, bf16)
  proj_out, proj_hist  (256, 21, 4), (10, 256)  a 10-step fused projection
                                (``_proj_kernel``, bf16, renormalized)
  module_dist     (256, 1)      the bf16 module path (``PoseNDF.apply``: the
                                DFNet in bf16, the encoder in fp32)

into ``tests/data/torch_port_bf16_expected.npz``. ``chip_smoke.py`` holds the
port's bf16 kernels to these values on the GPU and
``tests/test_torch_bf16.py`` holds its plain versions to them. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_bf16_golden.py
"""

from __future__ import annotations

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_bf16_expected.npz")
PROJ_STEPS = 10
TILE = 128


def probes():
    """The probe poses of ``make_torch_port_golden.py``."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden", os.path.join(ROOT, "scripts", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.probes()


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.field import load_field
    from posendf_tpu.ops.fused_grad import fused_distance_and_grad, fused_project
    from posendf_tpu.ops.fused_model import fused_posendf_forward

    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    field = load_field(CKPT, config=cfg)
    m, p = field.module, field.params
    kw = dict(parents=m.parents, activation=m.activation, beta=m.beta, tile_b=TILE,
              compute_dtype="bfloat16")
    q = jnp.asarray(probes())
    with pltpu.force_tpu_interpret_mode():
        fwd = fused_posendf_forward(q, p["enc"], p["dfnet"], **kw)
        d, g = fused_distance_and_grad(q, p["enc"], p["dfnet"], **kw)
        out, hist = fused_project(q, p["enc"], p["dfnet"], steps=PROJ_STEPS, **kw)
    module_d = field.distance(q)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, probes=np.asarray(q), fwd_dist=np.asarray(fwd), vag_dist=np.asarray(d),
             vag_grad=np.asarray(g), proj_out=np.asarray(out), proj_hist=np.asarray(hist),
             module_dist=np.asarray(module_d))
    print(f"wrote {OUT}: mean d {float(d.mean()):.6f}, projection mean d "
          f"{float(hist[0].mean()):.6f} -> {float(hist[-1].mean()):.6f}")


if __name__ == "__main__":
    main()
