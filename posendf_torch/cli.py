"""Command line of the PyTorch port: ``generate`` (pose sampling by manifold
projection), as ``posendf_tpu/cli.py generate`` without the mesh output.

Usage::

    python -m posendf_torch.cli generate --ckpt docs/quality/ckpt_l8_best.msgpack \\
        --num-poses 100 --steps 200 --fused --device cuda --out poses.npz
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["build_parser", "main"]


def cmd_generate(args) -> None:
    import numpy as np
    import torch

    from posendf_torch.field import load_field
    from posendf_torch.projection import project, random_poses

    field = load_field(args.ckpt, config=args.config, device=args.device)
    noisy = random_poses(torch.Generator().manual_seed(args.seed), args.num_poses,
                         device=args.device)
    out, hist = project(field, noisy, steps=args.steps, renormalize=not args.no_renorm,
                        fused=args.fused)
    if args.steps > 0:
        print(f"projected {args.num_poses} poses, {args.steps} steps: "
              f"mean dist {float(hist[0].mean()):.6f} -> {float(hist[-1].mean()):.6f}")
        if float(hist[0].max()) == 0.0 and field.module.activation in ("lrelu", "relu"):
            print("WARNING: the field is identically zero on every input (untrained "
                  "weights, or the lrelu/relu init coin flip); projection is a no-op. "
                  "Load a trained checkpoint with --ckpt.")
    else:
        print(f"projected {args.num_poses} poses, 0 steps (passthrough)")
    if args.out:
        np.savez(args.out, pose=out.cpu().numpy(), pose_init=noisy.cpu().numpy(),
                 dist_history=hist.cpu().numpy())
        print(f"wrote {args.out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m posendf_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("generate", help="sample poses by manifold projection")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint: the JAX package's .msgpack or the reference's .tar")
    p.add_argument("--config", "-c", default=None,
                   help="config YAML (default: the configs/amass.yaml hyperparameters)")
    p.add_argument("--num-poses", type=int, default=10)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-renorm", action="store_true",
                   help="reference-exact mode: skip per-step re-normalization")
    p.add_argument("--fused", action="store_true",
                   help="one CUDA kernel launch per projection step")
    p.add_argument("--out", default=None, help="output .npz path")
    p.add_argument("--device", default="cpu", help="torch device, e.g. cpu or cuda")
    p.set_defaults(fn=cmd_generate)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
