"""Serving demo of the PyTorch port: batch pose generation on the card.

The production inference pattern of the pose prior, as ``examples/serving.py``
runs it on the JAX package: a large batch of candidate poses (random here;
in practice network predictions or retrieval results) projected onto the
learned manifold by the fused projection kernel (``posendf_project_step``,
one launch a step), and with ``--int8`` the batch scored by the int8
forward kernel (``QuantizedField.distance``) beside the fp32 one::

    python examples/torch_serving.py [--batch 131072] [--steps 50] [--ckpt PATH] [--int8]

On the card, each time is the mean over a window of calls between two CUDA
events, after a warm-up call, the window doubled until it spans at least
200 ms, and the median of three windows is printed beside the card's name
and power limit (``nvidia-smi``). With ``--device cpu`` the
same path runs the kernels' plain versions, timed on the host's clock.
Without ``--ckpt`` an untrained softplus field (seeded 0) shows the
mechanics; with it, a JAX ``.msgpack``, a reference ``.tar`` or a training
run's checkpoint directory of the ``configs/amass.yaml`` architecture.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MIN_WINDOW_MS = 200.0   # the shortest timing window: a 131,072-pose call is a few ms


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def window_ms(fn, device, windows: int = 3) -> float:
    """Milliseconds a call of ``fn``: the median over ``windows`` windows of
    the mean of n calls, n doubled from 1 until a window spans at least
    MIN_WINDOW_MS; one warm-up call first."""
    import torch

    cuda = device.type == "cuda"

    def timed(n):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3

    fn()
    if cuda:
        torch.cuda.synchronize()
    n = 1
    while True:
        ms = timed(n)
        if ms > 0 and ms >= MIN_WINDOW_MS:
            break
        n *= 2
    means = [ms / n] + [timed(n) / n for _ in range(windows - 1)]
    if min(means) <= 0:
        raise RuntimeError(f"a timing window of {n} calls measured {min(means)} ms")
    return statistics.median(means)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None,
                    help="a JAX .msgpack, a reference .tar or a run's checkpoint directory")
    ap.add_argument("--int8", action="store_true",
                    help="also score the batch through the int8 forward kernel (post-training "
                         "quantization on a slice of the batch) beside the fp32 one")
    ap.add_argument("--quantized", default=None,
                    help="a saved QuantizedField file (cli export --save-quantized); implies "
                         "--int8, skips calibration")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from posendf_torch import QuantizedField, load_field, project
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.field import resolve_device
    from posendf_torch.projection import random_poses

    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    config = None
    if args.ckpt is None:
        # the untrained demo field: softplus, so its values are not all zero
        config = PoseNDFConfig()
        config.dfnet.act = config.strenc.act = "softplus"
    field = load_field(args.ckpt, config=config, device=device)
    where = (f"{torch.cuda.get_device_name(device)}; nvidia-smi: {card_name()}"
             if device.type == "cuda" else "the CPU (the kernels' plain versions, host clock)")
    print(f"device: {where}")
    print(f"batch {args.batch} x {args.steps} projection steps, field "
          f"{args.ckpt or 'untrained softplus (seed 0)'}")
    poses = random_poses(torch.Generator().manual_seed(1), args.batch, device=device)

    _, hist = project(field, poses, steps=args.steps, fused=True)
    d0, d1 = float(hist[0].mean()), float(hist[-1].mean())
    print(f"mean field distance: {d0:.3e} -> {d1:.3e}")
    if not d1 <= d0:
        raise SystemExit(f"the projection raised the mean distance ({d0} -> {d1})")
    ms = window_ms(lambda: project(field, poses, steps=args.steps, fused=True), device)
    rate = args.batch * args.steps / ms * 1e3
    print(f"fused projection: {ms:.4f} ms a call of {args.steps} steps -> {rate / 1e6:.2f}M "
          f"pose-steps/s  [{where}]")

    if args.int8 or args.quantized:
        if args.quantized:
            qf = QuantizedField.load(args.quantized, device=device)
            print(f"loaded quantized field from {args.quantized}")
        else:
            # calibrated on a slice of the serving batch itself
            qf = field.quantize_int8(poses[: min(args.batch, 8192)])
        win = tuple(qf.qparams["window"])
        print(f"int8 window: layers {win[0]}..{win[1] - 1} quantized")
        with torch.no_grad():
            ms32 = window_ms(lambda: field.distance_fused(poses), device)
            ms8 = window_ms(lambda: qf.distance(poses), device)
            d32, d8 = field.distance_fused(poses), qf.distance(poses)
        err = (d8 - d32).abs()
        std = float(d32.std()) or 1.0
        print(f"value path: fp32 {args.batch / ms32 / 1e3:.2f}M evals/s ({ms32:.4f} ms), int8 "
              f"{args.batch / ms8 / 1e3:.2f}M evals/s ({ms8:.4f} ms), {ms32 / ms8:.2f}x  "
              f"[{where}]")
        print(f"int8 agreement: MAE {float(err.mean()):.2e} "
              f"({100 * float(err.mean()) / std:.2f}% of the fp32 std), max {float(err.max()):.2e}")


if __name__ == "__main__":
    main()
