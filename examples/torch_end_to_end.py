"""End-to-end demo of the PyTorch port: manufacture data -> train -> project
-> denoise -> complete an occluded limb.

The five steps of ``examples/end_to_end.py`` on ``posendf_torch``, on the
card unless ``--device cpu`` is given; hermetic (a synthetic manifold and
the synthetic body model, no licensed data)::

    python examples/torch_end_to_end.py [--epochs 40] [--workdir DIR] [--device cpu]

The data pipeline labels noisy poses with exact kNN geodesic distances, the
trainer fits the field, random quaternions project onto the learned
manifold through the fused projection (the distance falls), a noisy motion
denoises under the trained prior, and a clip whose left arm was lost is
completed by visible-joint retrieval against the clean corpus (the kNN
kernel on the card; the occluded-joint error falls).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    from posendf_torch import Field, project
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.pipeline import TrainingBatcher
    from posendf_torch.data.prepare import build_corpus
    from posendf_torch.data.synthetic import synthetic_manifold_poses, write_synthetic_dataset
    from posendf_torch.experiments import MotionDenoiser, complete_by_retrieval
    from posendf_torch.field import resolve_device
    from posendf_torch.projection import random_poses
    from posendf_torch.quat import quaternion_to_axis_angle
    from posendf_torch.smpl import BodyModel
    from posendf_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="posendf_torch_demo_")
    print(f"== workdir {workdir}; device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    print("== 1. manufacturing synthetic dataset (clean manifold + kNN-labeled noisy poses)")
    labeled, amass = write_synthetic_dataset(workdir, poses_per_seq=512, queries_per_seq=512)

    cfg = PoseNDFConfig()
    cfg.data.data_dir, cfg.data.amass_dir = labeled, amass
    cfg.experiment.root_dir = os.path.join(workdir, "runs")
    cfg.dfnet.dims = [64, 64]
    cfg.dfnet.act = cfg.strenc.act = "softplus"
    cfg.train.optimizer_param = 1e-3
    cfg.train.batch_size = 2
    cfg.train.num_pts = 256

    print(f"== 2. training {args.epochs} epochs on {device}")
    batcher = TrainingBatcher(labeled, amass, batch_size=2, num_pts=512)
    trainer = Trainer(cfg, device=device)
    # the head's moments matched to one batch's labels, so a short run does
    # not start (and stay) at the d = 0 field (training/init_utils.py)
    trainer.matched_head_init(batcher.sample_batch())
    trainer.fit(batcher, epochs=args.epochs, log_every=10)
    field = Field(trainer.module)

    print("== 3. projecting 64 random poses onto the learned manifold (fused projection)")
    noisy = random_poses(torch.Generator().manual_seed(0), 64, device=device)
    _, hist = project(field, noisy, steps=20, fused=True)
    d0, d1 = float(hist[0].mean()), float(hist[-1].mean())
    print(f"   mean field distance: {d0:.5f} -> {d1:.5f}")
    assert d1 < d0

    print("== 4. denoising a 12-frame synthetic motion under the trained prior")
    rng = np.random.default_rng(0)
    clean = synthetic_manifold_poses(rng, 12)
    aa = quaternion_to_axis_angle(torch.from_numpy(clean)).reshape(12, 63).numpy()
    noisy_seq = aa + 0.1 * rng.standard_normal(aa.shape).astype(np.float32)
    body = BodyModel(device=device)  # the synthetic stand-in; bm_path= for a real SMPL file
    denoiser = MotionDenoiser(field, body)
    _, metrics = denoiser.optimize(noisy_seq, aa, iterations=3, steps_per_iter=10)
    print(f"   v2v vs ground truth: {metrics['v2v_cm']:.3f} cm "
          f"(prior at end: {metrics['final_pose_pr']:.5f})")

    print("== 5. completing an occluded limb by visible-joint retrieval")
    # the tracker lost the left arm: match the OBSERVED joints against the
    # clean manifold corpus (experiments/partial.py::complete_by_retrieval)
    corpus, _ = build_corpus(amass, ("ACCAD", "CMU"))
    occ = [12, 15, 17, 19]  # l_collar, l_shoulder, l_elbow, l_wrist
    observed = clean.copy()
    observed[:, occ] += rng.standard_normal((12, len(occ), 4)).astype(np.float32)
    observed[:, occ] /= np.linalg.norm(observed[:, occ], axis=-1, keepdims=True)
    completed = complete_by_retrieval(corpus, observed, occ, k=5, device=device)

    def occ_err(q):
        return float(np.mean(1 - np.abs(np.sum(q[:, occ] * clean[:, occ], -1))))

    vis = [j for j in range(21) if j not in occ]
    assert np.array_equal(completed[:, vis], observed[:, vis])
    print(f"   occluded-joint geodesic error: {occ_err(observed):.4f} -> "
          f"{occ_err(completed):.4f} (visible joints bit-exact)")
    assert occ_err(completed) < occ_err(observed)
    print("== done")


if __name__ == "__main__":
    main()
