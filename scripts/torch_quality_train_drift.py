"""Two trainings of ``torch_quality_grid.py``'s run-of-record recipe from the
same weights on the same batches, one with the fused train step (the train
kernels, 3xTF32 products) and one with the autodiff step (fp32
``torch.matmul``): how far the kernels' rounding carries a run.

Both runs go through the grid driver's own stages (``chunk_plan``,
``make_steps``, ``train_chunk``) over the chunks from ``--from-step`` to
``--from-step + --steps`` of a ``--run-steps``-step run's curriculum (by
default the run of record's 12,000 steps: w_man 0 to step 2,000, 0.3 to
4,000, then 1.0). Each run draws its batches from its own generator on the
same seed, so both see the same batches. They start from the recipe's init,
or from ``--load-ckpt`` (a ``--save-ckpt`` file of the grid driver; Adam's
moments start at zero).

Per chunk it prints the chunk's manifold weight, both runs' held-out
correlation (the validation gate's reading), the largest weight difference
between them in units of the learning rate, and the largest relative
difference of a step's loss terms; at the end each run's milliseconds a step
(host clock around each chunk, which ends in one copy).

Run (the card). The start of a run (w_man 0):
    python scripts/torch_quality_train_drift.py --steps 1500 --out drift.json
Across the curriculum's switches, from a run of record's kept field:
    python scripts/torch_quality_train_drift.py --load-ckpt ckpt.msgpack \\
        --from-step 3000 --steps 2000 --out drift_switch.json
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

_TERMS = ("total", "dist", "eikonal")


def grid_module():
    """``scripts/torch_quality_grid.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_quality_grid", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "torch_quality_grid.py"))
    qg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qg)
    return qg


def main(argv=None) -> dict:
    from posendf_torch.experiments.quality import add_device_arg, card_fields, write_result
    from posendf_torch.field import Field, resolve_device
    from posendf_torch.training.trainer import make_optimizer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--from-step", type=int, default=0,
                    help="the first step of the run's curriculum to train (a multiple of 500)")
    ap.add_argument("--run-steps", type=int, default=12000,
                    help="the length of the run whose curriculum the chunks follow")
    ap.add_argument("--load-ckpt", default=None, help="start both runs from this field")
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    opts, rest = ap.parse_known_args(argv)
    qg = grid_module()
    args = qg.parse_args(qg.RUN_OF_RECORD + ["--device", opts.device] + rest)
    plan = qg.chunk_plan(opts.run_steps)
    first = opts.from_step // qg.CHUNK
    last = first + (opts.steps + qg.CHUNK - 1) // qg.CHUNK
    if opts.from_step % qg.CHUNK or last > len(plan):
        raise SystemExit(f"--from-step {opts.from_step} --steps {opts.steps} is not a run of "
                         f"whole chunks inside a {opts.run_steps}-step run")
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sz = qg.sizes(args)
    family = qg.gentle_family(123, *args.freq, args.latents)
    data = qg.manufacture(args, family, sz["N"], sz["Q"], dev)
    cfg, module = qg.build_module(args, dev)
    if opts.load_ckpt:
        qg.load_ckpt(opts.load_ckpt, module)
    else:
        qg.init_params(args, module, data["q_pose"], data["q_dist"])
    runs = {}
    for name, fused in (("fused", True), ("autodiff", False)):
        m = copy.deepcopy(module)
        opt = make_optimizer(m.parameters(), sz["LR"], cfg.train.weight_decay)
        runs[name] = {"module": m, "steps": qg.make_steps(m, opt, cfg, args, fused),
                      "field": Field(m), "gen": qg.make_generator(args.seed, 3, dev), "s": 0.0}
    chunks, done = [], opts.from_step
    for n, wman in plan[first:last]:
        traj = {}
        for k, r in runs.items():
            t0 = time.perf_counter()
            traj[k] = qg.train_chunk(r["steps"][wman], data["q_pose"], data["q_dist"],
                                     data["corpus"], n, sz["BATCH"], generator=r["gen"])
            r["s"] += time.perf_counter() - t0
        done += n
        tf, ta = (np.stack([traj[k][t] for t in _TERMS], 1).astype(np.float64)
                  for k in ("fused", "autodiff"))
        dw = max(float((a - b).abs().max()) for a, b in zip(
            runs["fused"]["module"].state_dict().values(),
            runs["autodiff"]["module"].state_dict().values()))
        row = {"step": done, "w_man": wman, "max_dw_over_lr": dw / sz["LR"],
               "max_term_rel": float((np.abs(tf - ta) / np.maximum(np.abs(ta), 1e-30)).max()),
               "total_last": {k: float(t[-1, 0]) for k, t in (("fused", tf), ("autodiff", ta))}}
        for k, r in runs.items():
            pred = qg.field_values(r["field"], data["h_pose"], fused=False)
            row[f"corr_{k}"] = qg.held_corr(pred, data["h_dist"])
        chunks.append(row)
        print(json.dumps(row), flush=True)
    steps = done - opts.from_step
    result = {"steps": steps, "from_step": opts.from_step, "run_steps": opts.run_steps,
              "load_ckpt": opts.load_ckpt, "chunk": qg.CHUNK, "batch": sz["BATCH"],
              "lr": sz["LR"], "ms_a_step": {k: 1e3 * r["s"] / steps for k, r in runs.items()},
              "chunks": chunks, **card_fields(dev)}
    print(json.dumps(result), flush=True)
    write_result(result, opts.out)
    return result


if __name__ == "__main__":
    main()
