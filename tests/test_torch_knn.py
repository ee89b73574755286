"""``posendf_torch/ops/knn.py`` against ``posendf_tpu/ops/knn.py`` on the same
numpy inputs (JAX on the CPU, ``precision="highest"``).

Both stream the corpus in tiles and keep equal distances lowest index first,
so indices agree exactly on random data and on duplicated rows; distances
agree to fp32 summation order: 1e-6 for the geodesic and per-joint-L2
metrics (values ~0.4, sums of 21 terms), 1e-4 for the squared L2 distances
(values ~150 in 75 dimensions). ``"default"`` precision rounds the product
inputs to bf16 in the port, where JAX on the CPU stays fp32: it is held to
a numpy emulation instead.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from posendf_tpu.ops import knn as jknn  # noqa: E402
from posendf_tpu.quat import SMPL_JOINT_RANK as JAX_RANK  # noqa: E402

from posendf_torch.ops import knn  # noqa: E402
from posendf_torch.quat import JOINT_WEIGHTS, SMPL_JOINT_RANK  # noqa: E402

W = (np.asarray(JAX_RANK, np.float32) / np.linalg.norm(JAX_RANK)).astype(np.float32)


def _unit(rng, n):
    q = rng.normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pair(seed, Q=37, N=501):
    rng = np.random.default_rng(seed)
    return _unit(rng, Q), _unit(rng, N)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_same(got, want, atol):
    d, i = got
    dw, iw = (np.asarray(x) for x in want)
    assert i.dtype == torch.int64
    np.testing.assert_allclose(d.numpy(), dw, rtol=0, atol=atol)
    np.testing.assert_array_equal(i.numpy(), iw)


def test_joint_weights_are_the_jax_weights():
    """The same float32 bits as ``prepare.py`` computes them (numpy) and as
    ``label_sequence`` does (jnp)."""
    np.testing.assert_array_equal(SMPL_JOINT_RANK.numpy(), np.asarray(JAX_RANK))
    np.testing.assert_array_equal(JOINT_WEIGHTS.numpy(), W)
    jw = np.asarray(jnp.asarray(JAX_RANK) / jnp.linalg.norm(jnp.asarray(JAX_RANK)))
    np.testing.assert_array_equal(JOINT_WEIGHTS.numpy(), jw)


@pytest.mark.parametrize("n,tile", [(10, 4096), (300, 128), (1000, 8192), (129, 128)])
def test_clamp_tile_matches_jax(n, tile):
    for k in (1, 5, 200):
        assert knn._clamp_tile(tile, k, n) == jknn._clamp_tile(tile, k, n)


def test_smallest_k_orders_ties_as_lax_top_k():
    import jax

    v = np.array([[3.0, 1.0, 2.0, 1.0, 1.0, 0.5, 2.0]], np.float32)
    neg, arg = jax.lax.top_k(-jnp.asarray(v), 5)
    d, i = knn.smallest_k(_t(v), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(arg))
    np.testing.assert_array_equal(d.numpy(), -np.asarray(neg))
    _, j = knn.smallest_k(_t(v), 3, index=_t(np.arange(7)[None] * 10))
    np.testing.assert_array_equal(j.numpy(), [[50, 10, 30]])


def test_l2_topk_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(37, 75)).astype(np.float32)
    c = rng.normal(size=(501, 75)).astype(np.float32)
    want = jknn.l2_topk(jnp.asarray(q), jnp.asarray(c), k=5, corpus_tile=128)
    _assert_same(knn.l2_topk(_t(q), _t(c), 5, corpus_tile=128), want, atol=1e-4)


def test_l2_topk_default_precision_rounds_to_bf16():
    """bf16-rounded product inputs, fp32 everything else: the k smallest of
    the numpy emulation's distances (1e-4, fp32 sums of 75 terms)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(9, 75)).astype(np.float32)
    c = rng.normal(size=(300, 75)).astype(np.float32)

    def r(x):
        u = x.view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32)

    dist = (q * q).sum(-1)[:, None] + (c * c).sum(-1)[None] - 2.0 * (r(q) @ r(c).T)
    order = np.argsort(dist, axis=1, kind="stable")[:, :4]
    d, i = knn.l2_topk(_t(q), _t(c), 4, corpus_tile=128, precision="default")
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(dist, order, 1), atol=1e-4)
    with pytest.raises(ValueError, match="precision"):
        knn.l2_topk(_t(q), _t(c), 4, precision="fp8")


@pytest.mark.parametrize("weighted", [False, True])
def test_geodesic_topk_matches_jax(weighted):
    q, c = _pair(3)
    wj = jnp.asarray(W) if weighted else None
    wt = _t(W) if weighted else None
    want = jknn.geodesic_topk(jnp.asarray(q), jnp.asarray(c), 7, corpus_tile=128, weights=wj)
    _assert_same(knn.geodesic_topk(_t(q), _t(c), 7, corpus_tile=128, weights=wt), want,
                 atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_euclidean_topk_matches_jax(weighted):
    q, c = _pair(4)
    wj = jnp.asarray(W) if weighted else None
    wt = _t(W) if weighted else None
    want = jknn.euclidean_topk(jnp.asarray(q), jnp.asarray(c), 5, corpus_tile=128, weights=wj)
    _assert_same(knn.euclidean_topk(_t(q), _t(c), 5, corpus_tile=128, weights=wt), want,
                 atol=1e-6)


@pytest.mark.parametrize("metric", ["geo", "euc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_reranks_match_jax(metric, weighted):
    """Candidates from the L2 search (both packages' own), re-ranked."""
    q, c = _pair(5, Q=9, N=200)
    _, cand = jknn.l2_topk(jnp.asarray(q.reshape(9, 84)), jnp.asarray(c.reshape(200, 84)),
                           k=60, corpus_tile=128)
    _, cand_t = knn.l2_topk(_t(q.reshape(9, 84)), _t(c.reshape(200, 84)), 60, corpus_tile=128)
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand))
    jfn, tfn = {"geo": (jknn.geodesic_rerank, knn.geodesic_rerank),
                "euc": (jknn.euclidean_rerank, knn.euclidean_rerank)}[metric]
    want = jfn(jnp.asarray(q), jnp.asarray(c), cand, 5,
               jnp.asarray(W) if weighted else None)
    _assert_same(tfn(_t(q), _t(c), cand_t, 5, _t(W) if weighted else None), want, atol=1e-6)


def test_corpus_smaller_than_a_tile():
    q, c = _pair(6, Q=4, N=10)
    want = jknn.geodesic_topk(jnp.asarray(q), jnp.asarray(c), 3, corpus_tile=4096)
    _assert_same(knn.geodesic_topk(_t(q), _t(c), 3, corpus_tile=4096), want, atol=1e-6)
    want = jknn.l2_topk(jnp.asarray(q.reshape(4, 84)), jnp.asarray(c.reshape(10, 84)), 3)
    _assert_same(knn.l2_topk(_t(q.reshape(4, 84)), _t(c.reshape(10, 84)), 3), want, atol=1e-5)


def test_k_beyond_the_corpus_raises_as_in_jax():
    q, c = _pair(7, Q=4, N=3)
    for fn in (lambda: knn.geodesic_topk(_t(q), _t(c), 5),
               lambda: knn.euclidean_topk(_t(q), _t(c), 5),
               lambda: knn.l2_topk(_t(q.reshape(4, -1)), _t(c.reshape(3, -1)), 5),
               lambda: knn.geodesic_rerank(_t(q), _t(c), torch.zeros((4, 2), dtype=torch.int64),
                                           5)):
        with pytest.raises(ValueError, match="at least k"):
            fn()
    with pytest.raises(ValueError, match="at least k"):
        jknn.geodesic_topk(jnp.asarray(q), jnp.asarray(c), k=5)


def test_duplicate_rows_return_jax_indices():
    """Exact ties: copies of the queries at several corpus rows, across tile
    borders, come lowest index first in both."""
    q, c = _pair(8, Q=6, N=400)
    for r in (5, 130, 131, 260, 399):
        c[r] = q[0]
    c[200] = c[10]
    c[300] = c[10]
    q[1] = c[10]
    for weighted in (False, True):
        wj = jnp.asarray(W) if weighted else None
        wt = _t(W) if weighted else None
        want = jknn.geodesic_topk(jnp.asarray(q), jnp.asarray(c), 6, corpus_tile=128,
                                  weights=wj)
        got = knn.geodesic_topk(_t(q), _t(c), 6, corpus_tile=128, weights=wt)
        _assert_same(got, want, atol=1e-6)
        assert got[1][0, :5].tolist() == [5, 130, 131, 260, 399]
        assert got[1][1, :3].tolist() == [10, 200, 300]
