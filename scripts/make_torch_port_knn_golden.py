"""Write the JAX package's expected kNN and labelling values for the PyTorch port.

Runs the reference (``posendf_tpu``, JAX on the CPU, the Pallas kernel in
interpret mode) on a 16,384-pose corpus and 510 noisy queries (512 asked of
the sampler, whose five sigma groups round to 102 each), both made by
:func:`make_inputs` from a seed with numpy (the synthetic manifold of
``data/synthetic.py`` with 8 latents, and the reference's query sampler),
so the file stores no poses:

  * ``geodesic_topk`` (exact fp32), unweighted and joint-rank weighted, k = 5;
  * ``fused_geodesic_topk`` for ``dot_impl="vpu"`` (the distance) and
    ``"mxu_fast"`` (the prescreen bound), k = 5;
  * ``fused_geodesic_topk_fast`` (bound prescreen + exact rerank), k = 5;
  * ``probe_fast_safety``'s statistics on the corpus;
  * the ``dist`` of ``label_sequence(precision="highest")`` of 500 queries
    drawn from the first 512 corpus poses.

Output: ``tests/data/torch_port_knn_expected.npz`` (tens of KB).
``chip_smoke.py`` holds the port's CUDA kNN kernel and labelling to it. Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_knn_golden.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_knn_expected.npz")
SEED = 20261017
N_CORPUS, N_QUERIES, LATENTS, K = 16384, 512, 8, 5
LABEL_QUERIES = 500


def make_inputs(seed: int = SEED):
    """(corpus (16384, 21, 4), queries (510, 21, 4)) float32, numpy only."""
    import numpy as np

    from posendf_tpu.data.prepare import NoiseSpec, sample_noisy_queries
    from posendf_tpu.data.synthetic import manifold_family, synthetic_manifold_poses

    rng = np.random.default_rng(seed)
    family = manifold_family(rng, latents=LATENTS)
    corpus = synthetic_manifold_poses(rng, N_CORPUS, family=family)
    queries = sample_noisy_queries(corpus, N_QUERIES, NoiseSpec(), rng)
    return corpus, queries


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu

    from posendf_tpu.data.prepare import label_sequence, probe_fast_safety
    from posendf_tpu.ops.fused_knn import fused_geodesic_topk, fused_geodesic_topk_fast
    from posendf_tpu.ops.knn import geodesic_topk
    from posendf_tpu.quat import SMPL_JOINT_RANK

    corpus, queries = make_inputs()
    q, c = jnp.asarray(queries), jnp.asarray(corpus)
    w = (np.asarray(SMPL_JOINT_RANK, np.float32) / np.linalg.norm(SMPL_JOINT_RANK))
    out = dict(seed=np.int64(SEED), k=np.int64(K), label_queries=np.int64(LABEL_QUERIES),
               n_corpus=np.int64(N_CORPUS), n_queries=np.int64(N_QUERIES),
               latents=np.int64(LATENTS))
    for name, (d, i) in (("geo", geodesic_topk(q, c, K)),
                         ("geo_w", geodesic_topk(q, c, K, weights=jnp.asarray(w)))):
        out[f"{name}_d"], out[f"{name}_i"] = np.asarray(d), np.asarray(i)
    with pltpu.force_tpu_interpret_mode():
        for engine in ("vpu", "mxu_fast"):
            d, i = fused_geodesic_topk(q, c, K, dot_impl=engine, interpret=True)
            out[f"{engine}_d"], out[f"{engine}_i"] = np.asarray(d), np.asarray(i)
        d, i = fused_geodesic_topk_fast(q, c, K, interpret=True)
        out["fast_d"], out["fast_i"] = np.asarray(d), np.asarray(i)
    stats = probe_fast_safety(corpus, np.random.default_rng(SEED + 1))
    for key, v in stats.items():
        out[f"probe_{key}"] = np.asarray(v)
    labels = label_sequence(corpus[:512], c, num_queries=LABEL_QUERIES, k=K,
                            rng=np.random.default_rng(SEED + 2), precision="highest",
                            fused=False)
    out["label_dist"] = labels["dist"]
    out["label_pose_sum"] = np.float64(labels["pose"].astype(np.float64).sum())
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes); probe {stats}")


if __name__ == "__main__":
    main()
