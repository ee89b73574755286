"""Write the JAX package's expected training values for the PyTorch port.

Runs the reference (``posendf_tpu``, JAX on the CPU, ``precision="highest"``)
on the trained full-width lrelu field ``docs/quality/ckpt_l8_best.msgpack``:

  * ``jax.value_and_grad(losses.training_loss)`` (L1, unit weights) at
    2,048 noisy + 2,048 manifold poses: the three loss terms and the total,
    and per gradient leaf its sum, sum of |values|, L2 norm, max |value| and
    the values at up to 4,096 seeded positions (``idx_<leaf>``);
  * three train steps (``make_train_step``, Adam, lr 1e-4, weight decay 1e-4)
    on three seeded batches of the same size: each step's loss terms, and the
    same per-leaf summaries of the final parameters.

The steps run JAX's autodiff step; its fused step is the same math
(``tests/test_fused_train.py``), and the Pallas kernel's interpret mode is
too slow at full width on the CPU. The poses are not stored: both sides
draw them from the stored seeds with :func:`make_inputs`, numpy only.
Output: ``tests/data/torch_port_train_expected.npz`` (under 1 MB).
``chip_smoke.py`` holds the port's CUDA train kernels to it, and
``tests/test_torch_training.py`` the port's CPU path.

With ``--relu``, only the gradient (the loss terms, the total and the
per-leaf summaries) of the same checkpoint's weights with relu activations
(encoder and DFNet), at the same poses, into
``tests/data/torch_port_relu_train_expected.npz``: the field that runs the
train tile kernel's relu instance. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_train_golden.py [--relu]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_train_expected.npz")
RELU_OUT = os.path.join(ROOT, "tests", "data", "torch_port_relu_train_expected.npz")
SEED = 20261016
ROWS = 2048          # noisy poses, and manifold poses, per batch
STEPS = 3
LR = WEIGHT_DECAY = 1e-4
SAMPLES = 4096


def make_inputs(seed: int, rows: int = ROWS):
    """(noisy poses, their labels, manifold poses) as float32 numpy arrays:
    per-joint unit quaternions from a normal draw, labels |N(0, 0.1^2)|."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    pose = unit(rows)
    dist = (np.abs(rng.normal(size=rows)) * 0.1).astype(np.float32)
    return pose, dist, unit(rows)


def summarize(prefix: str, leaves, out: dict) -> None:
    """Per leaf (keyed like the port's state dict): sum, sum |x|, L2 norm,
    max |x| and the values at the stored positions ``idx_<leaf>``."""
    import numpy as np

    for name, a in sorted(leaves.items()):
        a = np.asarray(a, np.float64).ravel()
        idx = out.setdefault(f"idx_{name}", np.sort(
            np.random.default_rng([SEED, a.size]).choice(a.size, min(a.size, SAMPLES),
                                                         replace=False)).astype(np.int32))
        out[f"{prefix}_sum_{name}"] = a.sum()
        out[f"{prefix}_abssum_{name}"] = np.abs(a).sum()
        out[f"{prefix}_norm_{name}"] = np.sqrt((a * a).sum())
        out[f"{prefix}_max_{name}"] = np.abs(a).max()
        out[f"{prefix}_at_{name}"] = a[idx].astype(np.float32)


def _flat(tree) -> dict:
    return {f"{top}.{k}": v for top, sub in tree.items() for k, v in sub.items()}


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.field import load_field
    from posendf_tpu.losses import training_loss
    from posendf_tpu.training.trainer import make_optimizer, make_train_step

    relu = "--relu" in sys.argv[1:]
    cfg = PoseNDFConfig()
    cfg.dfnet.precision = "highest"
    if relu:
        cfg.dfnet.act = cfg.strenc.act = "relu"
    field = load_field(CKPT, config=cfg)
    module, params = field.module, field.params
    out = {"seed": np.int64(SEED), "rows": np.int64(ROWS), "steps": np.int64(STEPS),
           "lr": np.float64(LR), "weight_decay": np.float64(WEIGHT_DECAY)}

    pose, dist, man = map(jnp.asarray, make_inputs(SEED))
    (total, terms), grads = jax.jit(jax.value_and_grad(
        lambda p: training_loss(module, p, pose, dist, man, loss_type="l1"), has_aux=True))(params)
    out["grad_total"] = np.float64(total)
    for k, v in terms.items():
        out[f"grad_term_{k}"] = np.float64(v)
    summarize("grad", _flat(grads), out)
    if relu:
        np.savez_compressed(RELU_OUT, **out)
        print(f"wrote {RELU_OUT} ({os.path.getsize(RELU_OUT)} bytes): total {float(total):.6f}, "
              f"terms {[float(v) for v in terms.values()]}")
        return

    opt = make_optimizer(LR, WEIGHT_DECAY)
    step = jax.jit(make_train_step(module, opt, loss_type="l1",
                                   weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}))
    p, state = params, opt.init(params)
    hist = []
    for s in range(STEPS):
        b_pose, b_dist, b_man = make_inputs(SEED + 1 + s)
        p, state, metrics = step(p, state, {"pose": b_pose, "dist": b_dist, "man_poses": b_man})
        hist.append([float(metrics[k]) for k in ("total", "dist", "man_loss", "eikonal")])
    out["step_terms"] = np.asarray(hist, np.float64)   # (steps, [total, dist, man_loss, eikonal])
    summarize("param", _flat(p), out)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): total {float(total):.6f}, "
          f"terms {[float(v) for v in terms.values()]}, steps {hist}")


if __name__ == "__main__":
    main()
