"""Write the JAX package's expected values for the port's int8 serving checks.

Runs the reference (``posendf_tpu``, JAX on the CPU) on the trained
full-width lrelu field ``docs/quality/ckpt_l8_best.msgpack`` and stores in
``tests/data/torch_port_int8_expected.npz``:

  qp/...        ``quantize_posendf``'s qparams on CALIB numpy-seeded
                calibration poses (``calib_poses``), flattened to
                "/"-joined keys (``posendf_torch.ops.fused_int8.
                qparams_from_numpy`` reads them)
  probes        (256, 21, 4)  numpy-seeded probe poses (``probe_poses``)
  d_ref         (256, 1)  ``reference_int8_forward`` of the probes
  d_kernel      (256, 1)  the Pallas int8 kernel in TPU interpret mode
  bf16_out      (PROBE_B, 512) bf16 bits as uint16: ``scripts/int8_probe.py``
                ``run_bf16`` in interpret mode at B = PROBE_B on
                ``probe_chain_inputs``
  int8_out      (PROBE_B, 512) int8: its ``run_int8`` on the same seed

``chip_smoke.py`` holds the port's kernels and its quantization to these on
the GPU; ``tests/test_torch_int8.py`` holds the CPU path to them. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_int8_golden.py
"""

from __future__ import annotations

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_int8_expected.npz")
SEED = 8
CALIB = 4096
NUM_PROBES = 256
PROBE_SEED, PROBE_B, PROBE_TILE, PROBE_LAYERS = 9, 256, 128, 8


def unit_poses(rng, n):
    import numpy as np

    q = rng.normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def calib_poses(seed: int = SEED, n: int = CALIB):
    import numpy as np

    return unit_poses(np.random.default_rng(seed), n)


def probe_poses(seed: int = SEED + 1, n: int = NUM_PROBES):
    import numpy as np

    return unit_poses(np.random.default_rng(seed), n)


def probe_chain_inputs(seed: int = PROBE_SEED, rows: int = PROBE_B, layers: int = PROBE_LAYERS):
    """float32 x (rows, 512) and w (layers, 512, 512) to round to bf16 (as
    ``scripts/int8_probe.py`` draws them: normal, w x 0.05), int8 x and w
    (uniform in [-127, 127]) and s = 1/64 (1, layers)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(rows, 512)).astype(np.float32)
    wb = (rng.normal(size=(layers, 512, 512)) * 0.05).astype(np.float32)
    xi = rng.integers(-127, 128, size=(rows, 512)).astype(np.int8)
    wi = rng.integers(-127, 128, size=(layers, 512, 512)).astype(np.int8)
    si = np.full((1, layers), 1.0 / 64.0, np.float32)
    return xb, wb, xi, wi, si


def load_probe_script():
    spec = importlib.util.spec_from_file_location("int8_probe_script",
                                                  os.path.join(ROOT, "scripts", "int8_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flat_qparams(qp) -> dict:
    """JAX's qparams (numpy) as "qp/"-prefixed, "/"-joined npz keys."""
    import numpy as np

    out = {f"qp/enc/{k}": v for k, v in qp["enc"].items()}
    for i, lyr in enumerate(qp["layers"]):
        out.update({f"qp/layers/{i}/{k}": v for k, v in lyr.items()})
    out["qp/window"] = np.asarray(qp["window"])
    out.update({f"qp/report/{k}": np.asarray(v) for k, v in qp["report"].items()})
    return out


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu

    from posendf_tpu.field import load_field
    from posendf_tpu.ops.fused_int8 import fused_posendf_forward_int8, reference_int8_forward

    field = load_field(CKPT)
    m = field.module
    qfield = field.quantize_int8(jnp.asarray(calib_poses()))
    qp = jax.tree_util.tree_map(np.asarray, qfield.qparams)
    q = jnp.asarray(probe_poses())
    kw = dict(parents=m.parents, activation=m.activation, beta=m.beta)
    d_ref = np.asarray(reference_int8_forward(q, qfield.qparams, **kw))
    with pltpu.force_tpu_interpret_mode():
        d_kernel = np.asarray(fused_posendf_forward_int8(q, qfield.qparams, tile_b=128, **kw))

    probe = load_probe_script()
    probe.B, probe.TILE, probe.LAYERS = PROBE_B, PROBE_TILE, PROBE_LAYERS
    xb, wb, xi, wi, si = probe_chain_inputs()
    with pltpu.force_tpu_interpret_mode():
        bf16_out = np.asarray(probe.run_bf16(jnp.asarray(xb, jnp.bfloat16),
                                             jnp.asarray(wb, jnp.bfloat16)))
        int8_out = np.asarray(probe.run_int8(jnp.asarray(xi), jnp.asarray(wi), jnp.asarray(si)))

    arrays = flat_qparams(qp)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, **arrays, seed=SEED, calib=CALIB, probes=np.asarray(q), d_ref=d_ref,
        d_kernel=d_kernel, probe_seed=PROBE_SEED, probe_b=PROBE_B, probe_layers=PROBE_LAYERS,
        bf16_out=bf16_out.view(np.uint16), int8_out=int8_out.astype(np.int8))
    print(f"wrote {OUT}: window {qp['window']}, floored {qp['report']['floored_channels']}, "
          f"mean d {float(d_ref.mean()):.6f}, kernel vs reference "
          f"{float(np.abs(d_kernel - d_ref).max()):.3e}")


if __name__ == "__main__":
    main()
