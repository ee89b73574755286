"""Command line of the PyTorch port, as ``posendf_tpu/cli.py``: ``train``
(the distance field, on one device or data-parallel under ``torchrun``),
``generate`` (pose sampling by
manifold projection, without the mesh output), ``prepare-data`` (AMASS
sampling and kNN distance labelling), ``export`` (a ``torch.export``
artifact of the forward, the int8 forward or a whole projection),
``denoise`` (a motion clip optimized under the prior), ``partial``
(completion of a partly observed clip), ``fit-image`` (SMPL fitted to
OpenPose keypoints), ``denoise-bench`` (the noise-grid sweep) and
``interpolate`` (slerp + projection between two poses).

Usage::

    python -m posendf_torch.cli train --config run.json --fused-grads --max-epoch 10
    torchrun --standalone --nproc-per-node 4 -m posendf_torch train --config run.json
    python -m posendf_torch.cli generate --ckpt docs/quality/ckpt_l8_best.msgpack \\
        --num-poses 100 --steps 200 --fused --out poses.npz
    python -m posendf_torch.cli prepare-data --amass-raw raw/ --out-dir data/ --stage label
    python -m posendf_torch.cli export --ckpt docs/quality/ckpt_l8_best.msgpack --int8 \
        --calib poses.npz --save-quantized field.int8.msgpack --out model.int8.pt2
    python -m posendf_torch.cli denoise --ckpt docs/quality/ckpt_l8_best.msgpack \
        --motion-data noisy.npz --gt-data gt.npz --specs adaptive --out denoised.npz
    python -m posendf_torch.cli partial --ckpt docs/quality/ckpt_l8_best.msgpack \
        --motion-data clip.npz --occluded-joints 12 15 17 19 --mode retrieval \
        --corpus corpus.npz --out completed.npz
    python -m posendf_torch.cli fit-image --ckpt docs/quality/ckpt_l8_best.msgpack \
        --image-folder img/ --prior-form self --out fit.npz
    python -m posendf_torch.cli denoise-bench --ckpt docs/quality/ckpt_l8_best.msgpack \
        --data-root grid/ --synthesize --out table.npz
    python -m posendf_torch.cli interpolate --ckpt docs/quality/ckpt_l8_best.msgpack \
        --pose-a a.npz --pose-b b.npz --num-steps 10 --out path.npz

Each runs on the card unless ``--device cpu`` is given (under ``torchrun``,
``train`` takes one card a rank with NCCL, or gloo on the CPU).
``python -m posendf_torch`` is the same command line.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["build_parser", "main"]


def cmd_train(args) -> None:
    import torch.distributed
    from posendf_torch.config import PoseNDFConfig, load_config
    from posendf_torch.data.pipeline import TrainingBatcher
    from posendf_torch.parallel import init_distributed, make_mesh
    from posendf_torch.training.trainer import Trainer
    from posendf_torch.utils import enable_nan_debugging, trace

    if args.test:
        # the reference CLI's `trainer.py --test` generates poses
        argv = ["generate", "--device", args.device]
        argv += ["--config", args.config] if args.config else []
        argv += ["--ckpt", args.ckpt] if args.ckpt else []
        gen_args = build_parser().parse_args(argv)
        return gen_args.fn(gen_args)
    if args.debug_nans:
        enable_nan_debugging()
    # under torchrun: one rank a device; a plain run creates no group
    init_distributed(device=args.device)
    mesh = make_mesh(device=args.device) if torch.distributed.is_initialized() else None
    cfg = load_config(args.config) if args.config else PoseNDFConfig()
    if args.max_epoch is not None:
        cfg.train.max_epoch = args.max_epoch
    if args.fused_grads:
        cfg.train.fused_grads = True
    if args.early_stop_patience is not None:
        cfg.train.early_stop_patience = args.early_stop_patience
    if cfg.train.early_stop_patience:
        cfg.experiment.val = True  # patience means nothing without validation
    if args.val_every is not None:
        cfg.experiment.val_every = args.val_every
    t = cfg.train
    batcher = TrainingBatcher(cfg.data.data_dir, cfg.data.amass_dir, batch_size=t.batch_size,
                              num_pts=t.num_pts, flip=t.flip)
    val_batcher = None
    if cfg.experiment.val:
        try:
            val_batcher = TrainingBatcher(cfg.data.data_dir, cfg.data.amass_dir, split="vald",
                                          batch_size=t.batch_size, num_pts=t.num_pts, flip=t.flip)
        except FileNotFoundError as e:
            if t.early_stop_patience:
                raise SystemExit(
                    "early-stop patience requires validation data, but no vald-split files "
                    f"were found ({e}); provide a vald split under data.data_dir or drop the "
                    "flag/config key") from e
            print("experiment.val=True but no vald-split data found; skipping validation")
    trainer = Trainer(cfg, device=args.device, config_path=args.config, mesh=mesh)
    say = print if trainer.is_main else (lambda *a, **k: None)
    if args.matched_head_init:
        stats = trainer.matched_head_init(batcher.sample_batch())
        if stats is None:
            say("matched-head init skipped: resuming from a checkpoint")
        else:
            say(f"matched-head init: z {stats['z_mean']:+.4f} +- {stats['z_std']:.4f} -> "
                  f"x{stats['scale']:.4f}, head bias {stats['new_bias']:+.4f} (labels "
                  f"{stats['label_mean']:.4f} +- {stats['label_std']:.4f})")
    epochs = t.max_epoch - trainer.epoch
    say(f"training {cfg.exp_name()} from epoch {trainer.epoch} for {epochs} epochs "
        f"on {1 if mesh is None else mesh.size} device(s) ({trainer.device})")
    with trace(args.profile):
        trainer.fit(batcher, epochs=epochs, val_batcher=val_batcher,
                    val_every=cfg.experiment.val_every, early_stop_patience=t.early_stop_patience)
    if val_batcher is not None:
        info = trainer.store.best_info()
        if info:
            say(f"best checkpoint: epoch {info['epoch']} ({info['mode']} "
                  f"total={info['metric']:.6f}) -> {trainer.store.directory}/checkpoint_best.tar")


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
    if args.save_mesh or args.render:
        # the reference projection script's meshes and renders
        # (sample_poses.py:59-62,79-82): the initial and the projected poses
        from posendf_torch.experiments.render import export_pose_meshes
        from posendf_torch.quat import quaternion_to_axis_angle
        from posendf_torch.smpl import BodyModel

        bm = BodyModel(bm_path=args.bm_path, device=args.device)
        out_dir = args.mesh_dir or "./generated"
        export_pose_meshes(out_dir, bm, [(name, quaternion_to_axis_angle(q).reshape(-1, 63))
                                         for name, q in (("init", noisy), ("out", out))],
                           save_mesh=args.save_mesh, render=args.render)
        print(f"wrote meshes/renders -> {out_dir}")


def cmd_prepare_data(args) -> None:
    from posendf_torch.data.prepare import run_cli

    run_cli(args)


def cmd_export(args) -> None:
    from posendf_torch.export import (export_forward, export_forward_int8, export_project,
                                      save_artifact)
    from posendf_torch.field import load_field

    batch = args.batch if args.batch is not None else "symbolic"
    if args.int8 or args.quantized:
        if args.what != "forward":
            raise SystemExit("--int8 exports the forward only (the int8 path is value-only; "
                             "projection needs the fp32 gradient paths)")
        qfield = _load_quantized(args)
        save_artifact(export_forward_int8(qfield, batch=args.batch), args.out)
        start, stop = qfield.qparams["window"]
        print(f"exported int8 forward (quantized layers {start}..{stop - 1}, batch={batch}, "
              f"device={qfield.device}) -> {args.out}")
        return
    field = load_field(args.ckpt, config=args.config, device=args.device)
    if args.what == "forward":
        exp = export_forward(field.module, batch=args.batch)
    else:
        exp = export_project(field.module, steps=args.steps, batch=args.batch,
                             renormalize=not args.no_renorm)
    save_artifact(exp, args.out)
    print(f"exported {args.what} (batch={batch}, device={args.device}) -> {args.out}")


def cmd_denoise(args) -> None:
    from posendf_torch.experiments.denoise import run_cli

    run_cli(args)


def cmd_partial(args) -> None:
    from posendf_torch.experiments.partial import run_cli

    run_cli(args)


def cmd_fit_image(args) -> None:
    from posendf_torch.experiments.fit_image import run_cli

    run_cli(args)


def cmd_denoise_bench(args) -> None:
    from posendf_torch.experiments.denoise import BALANCED_SPECS, MotionDenoiser
    from posendf_torch.experiments.denoise_benchmark import run_sweep, synthesize_grid
    from posendf_torch.field import load_field
    from posendf_torch.smpl import BodyModel

    field = load_field(args.ckpt, config=args.config, device=args.device)
    bm = BodyModel(bm_path=args.bm_path, device=args.device)
    data_root = args.data_root
    if args.synthesize:
        data_root = synthesize_grid(args.data_root, seqs_per_level=args.seqs_per_level,
                                    family_seed=args.family_seed)
    specs = {"balanced": BALANCED_SPECS, "adaptive": "adaptive"}.get(args.specs)
    denoiser = MotionDenoiser(field, bm, specs=specs)
    run_sweep(denoiser, data_root, iterations=args.iterations,
              steps_per_iter=args.steps_per_iter, out_path=args.out,
              batch_clips=not args.serial_clips)


def cmd_interpolate(args) -> None:
    from posendf_torch.experiments.interpolate import run_cli

    run_cli(args)


CALIB_KEYS = ("pose", "pose_body", "quats", "poses")


def _load_quantized(args):
    """The int8 source of ``export --int8``: a saved quantized field
    (--quantized), or post-training quantization of the loaded checkpoint on
    the --calib poses (4,096 random poses with a warning otherwise)."""
    import numpy as np
    import torch

    from posendf_torch.field import QuantizedField, load_field
    from posendf_torch.projection import random_poses
    from posendf_torch.quat import axis_angle_to_quaternion

    if args.quantized:
        return QuantizedField.load(args.quantized, device=args.device)
    field = load_field(args.ckpt, config=args.config, device=args.device)
    J = field.module.num_joints
    if args.calib:
        with np.load(args.calib) as z:
            key = next((k for k in CALIB_KEYS if k in z), None)
            if key is None:
                raise SystemExit(f"--calib {args.calib}: no recognized pose key; found "
                                 f"{sorted(z.files)}, expected one of {'/'.join(CALIB_KEYS)}")
            calib = np.asarray(z[key], np.float32)
        if calib.ndim == 2 and calib.shape[1] in (63, 69, 72, 156):
            # 72/156: the full pose with the root; the body joints start at index 3
            # (the reference slices 3:72, data/sample_poses.py:48-56)
            start = 3 if calib.shape[1] in (72, 156) else 0
            calib = axis_angle_to_quaternion(torch.from_numpy(
                calib[:, start:start + 63].reshape(len(calib), 21, 3).copy())).numpy()
        elif calib.ndim == 2 and calib.shape[1] != J * 4:
            raise SystemExit(f"--calib {args.calib}: key {key!r} has width {calib.shape[1]}; "
                             f"expected axis-angle 63/69/72/156 or quaternion {J * 4}")
        try:
            calib = calib.reshape(-1, J, 4)
        except ValueError:
            raise SystemExit(f"--calib {args.calib}: key {key!r} shape {calib.shape} does not "
                             f"reshape to (-1, {J}, 4) quaternions") from None
        calib = torch.from_numpy(calib)
    else:
        print("WARNING: no --calib set; calibrating activation scales on 4096 uniform random "
              "poses (pass a representative pose file for tighter scales)")
        calib = random_poses(torch.Generator().manual_seed(0), 4096)
    qfield = field.quantize_int8(calib)
    if args.save_quantized:
        qfield.save(args.save_quantized)
        print(f"saved quantized field -> {args.save_quantized}")
    return qfield


def _add_common(p: argparse.ArgumentParser,
                device_help: str = "torch device (default cuda; raises without a card): "
                                   "cuda or cpu") -> None:
    p.add_argument("--config", "-c", default=None,
                   help="config, YAML or JSON (default: the configs/amass.yaml hyperparameters)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint: the JAX package's .msgpack, the reference's .tar or a "
                        "training run's checkpoint directory")
    p.add_argument("--device", default="cuda", help=device_help)


def _add_mesh_out(p: argparse.ArgumentParser, default_dir: str) -> None:
    """Mesh and render output flags (the reference renders before/after
    meshes in every experiment, exp_utils.py:30-63)."""
    p.add_argument("--save-mesh", action="store_true",
                   help=f"write OBJ meshes (default dir: {default_dir})")
    p.add_argument("--render", action="store_true",
                   help="write PNG renders (PIL) or .npy grayscale")
    p.add_argument("--mesh-dir", default=None,
                   help=f"mesh/render output dir (default {default_dir})")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m posendf_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train the distance field")
    _add_common(p)
    p.add_argument("--max-epoch", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the training into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise in the backward pass at the operation that made a NaN")
    p.add_argument("--test", action="store_true",
                   help="reference-CLI parity: generate poses instead of training")
    p.add_argument("--matched-head-init", action="store_true",
                   help="from-scratch aid: moment-match the distance head to the first "
                        "batch's labels (training/init_utils.py); ignored when resuming")
    p.add_argument("--fused-grads", action="store_true",
                   help="loss and gradient from the CUDA train kernels (lrelu/relu, fp32)")
    p.add_argument("--early-stop-patience", type=int, default=None, metavar="N",
                   help="stop after N consecutive non-improving validations "
                        "(enables experiment.val)")
    p.add_argument("--val-every", type=int, default=None, metavar="E",
                   help="validation cadence in epochs (default 100, the reference cadence)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("generate", help="sample poses by manifold projection")
    _add_common(p)
    p.add_argument("--num-poses", type=int, default=10)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-renorm", action="store_true",
                   help="reference-exact mode: skip per-step re-normalization")
    p.add_argument("--fused", action="store_true",
                   help="one CUDA kernel launch per projection step")
    p.add_argument("--out", default=None, help="output .npz path")
    _add_mesh_out(p, "./generated")
    p.add_argument("--bm-path", default=None,
                   help="SMPL model file (default: the 128-vertex synthetic body)")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("prepare-data", help="AMASS sampling + kNN distance labelling")
    _add_common(p)
    p.add_argument("--amass-raw", required=True, help="raw AMASS root")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--stage", choices=["sample", "label", "all"], default="all")
    p.add_argument("--split", default="train")
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--k-candidates", type=int, default=0,
                   help="0 (default): exact single-stage top-k; >0: the reference-shaped "
                        "two-stage search (L2 candidates of this width, then exact re-rank)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--metric", choices=["geo", "euc"], default="geo")
    p.add_argument("--weighted", action="store_true",
                   help="joint-rank-weighted distance (dist_utils.py:39)")
    p.add_argument("--space", choices=["quat", "joints"], default="quat",
                   help="candidate-search embedding: raw quats or the SMPL joint positions "
                        "(forward kinematics of --bm-path's model)")
    p.add_argument("--bm-path", default=None, help="SMPL model for --space joints")
    p.add_argument("--knn-precision", choices=["auto", "highest", "high", "default", "fast"],
                   default="auto",
                   help="search engine: 'auto' (default) takes the faster engine that gives "
                        "exact labels: exact 'highest' on the card and the CPU, the bound "
                        "prescreen only on a device type of data/prepare.py "
                        "FAST_ENGINE_BACKENDS (none) where its corpus probe passes; "
                        "'highest' is exact fp32; "
                        "'fast' is the bound prescreen + exact rerank; "
                        "'default' rounds the distance products' inputs to bf16")
    p.add_argument("--fused-knn", choices=["auto", "on", "off"], default="auto",
                   help="the CUDA kNN kernel (auto: single-stage geodesic searches on the card)")
    p.add_argument("--per-pose-noise", action="store_true",
                   help="an independent noise draw per query pose (default: the reference's "
                        "one (21, 4) draw per sigma group, create_data.py:88)")
    p.add_argument("--structured-frac", type=float, default=0.0,
                   help="fraction of queries given limb-structured noise instead of the "
                        "sigma grid (0.0 = the reference's sampler)")
    p.add_argument("--structured-sigma", type=float, nargs=2, default=[0.3, 1.0],
                   help="per-query sigma range of structured chain noise")
    p.set_defaults(fn=cmd_prepare_data)

    p = sub.add_parser("export", help="serialize the model to a torch.export artifact")
    _add_common(p, device_help="torch device the artifact is traced on and runs on (default "
                               "cuda; raises without a card): cuda or cpu. It takes the place "
                               "of the JAX CLI's --platforms")
    p.add_argument("--out", required=True, help="artifact path")
    p.add_argument("--what", choices=["forward", "project"], default="forward")
    p.add_argument("--steps", type=int, default=10, help="projection steps (--what project)")
    p.add_argument("--batch", type=int, default=None,
                   help="static batch size (default: symbolic, any batch, one pose included)")
    p.add_argument("--no-renorm", action="store_true",
                   help="projection without per-step renormalization")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 forward (post-training quantization on --calib)")
    p.add_argument("--calib", default=None,
                   help="calibration poses for --int8: an .npz with a pose/pose_body/quats/"
                        "poses key, (N, 21, 4) or (N, 84) quaternions or (N, 63/69/72/156) "
                        "axis-angle. Without it, 4,096 random poses from "
                        "torch.Generator().manual_seed(0): other poses than the JAX CLI's "
                        "(the two packages' generators differ)")
    p.add_argument("--save-quantized", default=None,
                   help="also write the quantized field (posendf-int8-v1 msgpack) here")
    p.add_argument("--quantized", default=None,
                   help="export the int8 forward of a saved quantized field (implies --int8)")
    p.set_defaults(fn=cmd_export)

    specs_help = ("anneal schedule: 'reference' = motion_denoise.py:31-34 exact; 'balanced' = "
                  "gentler prior and temporal weights for near-manifold inputs; 'adaptive' = a "
                  "per-clip schedule scaled by the field's own noise estimate")
    p = sub.add_parser("denoise", help="motion denoising with the field prior")
    _add_common(p)
    p.add_argument("--motion-data", required=True)
    p.add_argument("--gt-data", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--bm-path", default=None,
                   help="SMPL model file (.pkl/.npz); default: the synthetic 128-vertex body")
    p.add_argument("--specs", choices=("reference", "balanced", "adaptive"),
                   default="reference", help=specs_help)
    p.add_argument("--iterations", type=int, default=10,
                   help="outer iterations of the annealed schedule (the reference's 10)")
    p.add_argument("--steps-per-iter", type=int, default=50,
                   help="Adam steps per iteration (the reference's 50)")
    _add_mesh_out(p, "./denoised")
    p.set_defaults(fn=cmd_denoise)

    p = sub.add_parser("partial", help="partial-observation completion")
    _add_common(p)
    p.add_argument("--motion-data", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--bm-path", default=None,
                   help="SMPL model file (.pkl/.npz); default: the synthetic 128-vertex body")
    p.add_argument("--max-frames", type=int, default=120)
    p.add_argument("--occluded-joints", type=int, nargs="+", default=None,
                   help="body-pose joint indices known to be unobserved; the data term "
                        "anchors only the observed joints (observation_mask). Default: the "
                        "reference's anchor-everything solve")
    p.add_argument("--mode", choices=("anchor", "inpaint", "retrieval"), default="anchor",
                   help="'anchor': the reference solve (occlusion-aware with "
                        "--occluded-joints); 'inpaint': the observed dofs frozen, only the "
                        "occluded limb completed (INPAINT_SPECS); 'retrieval': the occluded "
                        "joints spliced from the --corpus poses nearest in the visible joints "
                        "(the kNN kernel)")
    p.add_argument("--corpus", default=None,
                   help=".npz of manifold poses ('pose' (N, 21, 4) quaternions) for "
                        "--mode retrieval")
    p.add_argument("--retrieval-k", type=int, default=5)
    p.add_argument("--temporal-window", type=int, default=5)
    _add_mesh_out(p, "./partial_out")
    p.set_defaults(fn=cmd_partial)

    p = sub.add_parser("interpolate", help="slerp + projection between poses")
    _add_common(p)
    p.add_argument("--num-steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random endpoints (without --pose-a/-b), from "
                        "torch.Generator: other poses than the JAX CLI's")
    p.add_argument("--pose-a", default=None, help=".npz endpoint (pose or pose_body)")
    p.add_argument("--pose-b", default=None, help=".npz endpoint (pose or pose_body)")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_interpolate)

    p = sub.add_parser("fit-image", help="image-based SMPL fitting with the prior")
    _add_common(p)
    p.add_argument("--image-folder", required=True,
                   help="folder with kpts.npz (OpenPose BODY_25 (25, 3) or (B, 25, 3)) and, "
                        "optionally, img.jpg (its center is the principal point)")
    p.add_argument("--out", default=None)
    p.add_argument("--bm-path", default=None,
                   help="SMPL model file (.pkl/.npz); default: the synthetic 128-vertex body")
    p.add_argument("--prior-form", choices=("reference", "self"), default="reference",
                   help="stage 2-3 prior weighting: 'reference' = linear 1e2*L/(1+it) "
                        "(image_fitting.py:40); 'self' = the denoise schedule's self-weighted "
                        "1e7*L^2/(1+it), which escapes the zero-region pinning of the linear "
                        "form on trained relu-head fields")
    _add_mesh_out(p, "the image folder")
    p.set_defaults(fn=cmd_fit_image)

    p = sub.add_parser("denoise-bench",
                       help="motion-denoising benchmark sweep (HuMoR-style grid)")
    _add_common(p)
    p.add_argument("--data-root", required=True,
                   help="grid root: <root>/<level>/<seq>/observations.npz")
    p.add_argument("--synthesize", action="store_true",
                   help="write a synthetic noise grid under --data-root first")
    p.add_argument("--family-seed", type=int, default=0,
                   help="with --synthesize: the manifold family's seed; must match the seed "
                        "the checkpoint's synthetic training set was written with")
    p.add_argument("--seqs-per-level", type=int, default=2)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--steps-per-iter", type=int, default=50)
    p.add_argument("--serial-clips", action="store_true",
                   help="solve clips one at a time instead of one batched solve per level")
    p.add_argument("--specs", choices=("reference", "balanced", "adaptive"),
                   default="reference", help=specs_help)
    p.add_argument("--bm-path", default=None)
    p.add_argument("--out", default=None, help="aggregate results .npz")
    p.set_defaults(fn=cmd_denoise_bench)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
