"""Multi-device demo of the PyTorch port: every sharded path, end to end.

The four stages of ``examples/multichip.py`` on ``posendf_torch``, one
process a device under ``torchrun`` (NCCL on the cards, or gloo on the CPU
with ``--device cpu``); hermetic (a synthetic manifold and the synthetic
body model)::

    torchrun --standalone --nproc-per-node 4 examples/torch_multichip.py --device cpu
    torchrun --standalone --nproc-per-node 1 examples/torch_multichip.py

Stages:
  1. sharded kNN labelling: queries split over the ranks, the corpus on
     every rank, the labels gathered back in rank order (the kNN kernel on
     the card);
  2. data-parallel training: every rank draws the same global batch and
     takes its rows; one all-reduce of loss and gradients a step;
  3. frame-sharded motion denoising: frames split over the ranks, the
     temporal term's one neighbour frame through ``parallel/halo.py``;
  4. sharded projection: each rank projects its share of random poses
     through the projection-step kernel, and the histories are gathered;
     the mean distance falls.

Run alone (no ``torchrun``) it is the one-process mesh of the same code.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    from posendf_torch import Field, project
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.pipeline import TrainingBatcher
    from posendf_torch.data.prepare import label_sequence
    from posendf_torch.data.synthetic import write_synthetic_dataset
    from posendf_torch.experiments import MotionDenoiser
    from posendf_torch.parallel import (barrier, broadcast_object, gather_rows,
                                        init_distributed, make_mesh, shard_batch)
    from posendf_torch.projection import random_poses
    from posendf_torch.smpl import BodyModel
    from posendf_torch.smpl.lbs import synthetic_model
    from posendf_torch.training.trainer import Trainer

    init_distributed(device=args.device)
    mesh = make_mesh(("data",), device=args.device)
    n = mesh.size
    say = print if mesh.is_main else (lambda *a, **k: None)
    say(f"== mesh: {n} x {mesh.device.type} over axis 'data' ({mesh.backend or 'no group'})")

    workdir = args.workdir
    if workdir is None:
        workdir = broadcast_object(mesh, tempfile.mkdtemp(prefix="posendf_torch_multichip_")
                                   if mesh.is_main else None)

    # ---- 1. sharded kNN labelling -----------------------------------------
    if mesh.is_main:
        write_synthetic_dataset(workdir)
    barrier(mesh)
    labeled, amass = os.path.join(workdir, "labeled"), os.path.join(workdir, "amass")
    rng = np.random.default_rng(0)
    corpus = rng.random((4096, 21, 4)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    clean = corpus[:256]
    out = label_sequence(clean, torch.from_numpy(corpus).to(mesh.device), num_queries=n * 64,
                         k=5, mesh=mesh, rng=rng)
    say(f"== 1. sharded labelling: {out['pose'].shape[0]} queries x {len(corpus)} corpus -> "
        f"dist {out['dist'].shape}, mean top-1 {out['dist'][:, 0].mean():.4f}")

    # ---- 2. data-parallel training ------------------------------------------
    cfg = PoseNDFConfig()
    cfg.data.data_dir, cfg.data.amass_dir = labeled, amass
    cfg.experiment.root_dir = workdir
    cfg.dfnet.dims = [64, 64]
    cfg.dfnet.act = cfg.strenc.act = "softplus"
    cfg.train.optimizer_param = 1e-3
    cfg.train.continue_train = False
    trainer = Trainer(cfg, mesh=mesh)
    batcher = TrainingBatcher(labeled, amass, batch_size=2, num_pts=64 * n, seed=0)
    # the head's moments matched to one batch's labels (rank 0's weights,
    # broadcast), so a short run does not start and stay at the d = 0 field
    trainer.matched_head_init(batcher.sample_batch())
    stats = None
    for _ in range(max(args.epochs, 1)):
        stats = trainer.train_epoch(iter([batcher.sample_batch() for _ in range(2)]))
        trainer.epoch += 1
    say(f"== 2. data-parallel training ({max(args.epochs, 1)} epochs): "
        f"total={stats['total']:.5f} dist={stats['dist']:.5f}")

    # ---- 3. frame-sharded denoising -----------------------------------------
    body = BodyModel(model=synthetic_model(num_vertices=96, seed=1), device=mesh.device)
    den = MotionDenoiser(trainer.module, body)
    frames = 8 * n  # divisible by the ranks, so the frames split evenly
    noisy = rng.normal(scale=0.1, size=(frames, 69)).astype(np.float32)
    _, metrics = den.optimize(noisy, iterations=3, steps_per_iter=10, mesh=mesh)
    say(f"== 3. frame-sharded denoise ({frames} frames over {n} ranks): final prior "
        f"{metrics['final_pose_pr']:.3e}, moved {metrics['v2v_vs_input_cm']:.3f} cm v2v from "
        "the noisy input")

    # ---- 4. sharded projection ----------------------------------------------
    poses = random_poses(torch.Generator().manual_seed(1), 128 * n, device=mesh.device)
    mine = shard_batch(mesh, poses, even=True)
    _, hist = project(Field(trainer.module), mine, steps=20, fused=True)
    hist = gather_rows(mesh, hist.T.contiguous()).T
    say(f"== 4. sharded projection ({poses.shape[0]} poses): mean distance "
        f"{float(hist[0].mean()):.5f} -> {float(hist[-1].mean()):.5f}")
    say("== done")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
