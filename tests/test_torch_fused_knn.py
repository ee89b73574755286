"""The kNN kernel's plain version (``knn_topk_ref``) and its wrapper on the CPU
against the JAX package's Pallas kernel in TPU interpret mode, as
``tests/test_fused_knn.py`` runs it (tiles 8 x 128).

Bars:
  * ``vpu``: indices equal, distances 1e-6 (the JAX kernel sums the joints
    in the same order; XLA may fuse its multiply-adds);
  * ``mxu_fast`` (the bound, not the distance): 1e-5, fp32 summation order
    of the 84-term products; indices equal wherever the gap to the
    neighbouring ranks is above the bar (a tie-aware check);
  * ``mxu_bf16``: JAX's interpret mode runs it in full fp32, so it is held
    to a numpy emulation of bf16-rounded operands (the same bits), and to
    the exact engine by the bar rounding allows: each bf16 operand is off by
    at most 2^-9 relative, so a per-joint dot of unit quaternions moves by at
    most (2 * 2^-9 + 2^-18) * sum_d |q_d c_d| <= 2^-8 + 2^-18, the distance
    by that times sum_j w_j, and each rank of the sorted top-k by no more
    (order statistics are 1-Lipschitz); plus 1e-6 for fp32 rounding.
The kernel itself runs only on the card, where ``chip_smoke.py`` holds it to
this plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.ops import fused_knn as jfk  # noqa: E402
from posendf_tpu.quat import SMPL_JOINT_RANK  # noqa: E402

from posendf_torch.ops import fused_knn  # noqa: E402
from posendf_torch.ops.knn import geodesic_topk  # noqa: E402

W = (np.asarray(SMPL_JOINT_RANK, np.float32) / np.linalg.norm(SMPL_JOINT_RANK)).astype(np.float32)
Q, N = 64, 1000          # N is ragged against the 128-row JAX tile
KS = [1, 5, 13, 32]
TILES = dict(tile_q=8, tile_t=128)


def _unit(rng, n):
    q = rng.normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _manifold(rng, n_base, per_base, sigma):
    """Clusters of small perturbations of pose-like base poses (theta <= 2
    rad, so w = cos(theta / 2) > 0): the bound prescreen's regime."""
    axis = rng.normal(size=(n_base, 21, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = rng.uniform(0.0, 2.0, size=(n_base, 21, 1)).astype(np.float32)
    base = np.concatenate([np.cos(theta / 2), np.sin(theta / 2) * axis], axis=-1)
    q = np.repeat(base, per_base, axis=0)
    q = q + sigma * rng.normal(size=q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def assert_topk_close(d, i, d_ref, i_ref, atol, d_next=None):
    """Distances within ``atol`` rank by rank; indices equal wherever the
    reference's distance is more than ``atol`` from both neighbouring ranks
    (``d_next``: the reference's next distance after the last rank, if
    known)."""
    d, i, d_ref, i_ref = (np.asarray(x) for x in (d, i, d_ref, i_ref))
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=atol)
    nxt = np.full((len(d_ref), 1), -np.inf if d_next is None else 0.0)
    if d_next is not None:
        nxt[:, 0] = d_next
    gap_prev = np.diff(d_ref, axis=1, prepend=-np.inf)
    gap_next = np.diff(np.concatenate([d_ref, nxt], axis=1), axis=1)
    if d_next is None:
        gap_next[:, -1] = 0.0
    sure = (gap_prev > atol) & (gap_next > atol)
    np.testing.assert_array_equal(i[sure], i_ref[sure])
    return float(sure.mean())


def _jax_kernel(q, c, k, dot_impl, weights=None):
    with pltpu.force_tpu_interpret_mode():
        d, i = jfk.fused_geodesic_topk(jnp.asarray(q), jnp.asarray(c), k, weights=weights,
                                       dot_impl=dot_impl, interpret=True, **TILES)
    return np.asarray(d), np.asarray(i)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return _unit(rng, Q), _unit(rng, N)


@pytest.fixture(scope="module")
def jax_unweighted(data):
    """JAX's kernel at k = 32 for the two ported engines with a distinct
    arithmetic (two interpret-mode calls); smaller k are its prefixes."""
    q, c = data
    return {e: _jax_kernel(q, c, 32, e) for e in ("vpu", "mxu_fast")}


def _port(q, c, k, dot_impl, weights=None):
    """Through the wrapper (CPU tensors: the plain version), checked against
    ``knn_topk_ref`` on the wrapper's operands, with no launch."""
    before = dict(fused_knn.LAUNCHES)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    d, i = fused_knn.fused_geodesic_topk(qt, ct, k, weights=weights, dot_impl=dot_impl)
    qf, cf, wj, wt = fused_knn.kernel_operands(qt, ct, weights, dot_impl)
    d_r, i_r = fused_knn.knn_topk_ref(qf, cf, k, weights=wj, w_total=wt,
                                      dot_impl=dot_impl)
    assert torch.equal(d, d_r) and torch.equal(i, i_r)
    assert fused_knn.LAUNCHES == before
    assert d.shape == (len(q), k) and i.dtype == torch.int64
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("k", KS)
def test_exact_engine_matches_jax_kernel(data, jax_unweighted, k):
    q, c = data
    d_ref, i_ref = jax_unweighted["vpu"]
    d, i = _port(q, c, k, "vpu")
    np.testing.assert_allclose(d, d_ref[:, :k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i, i_ref[:, :k])


@pytest.mark.parametrize("k", KS)
def test_bound_engine_matches_jax_kernel(data, jax_unweighted, k):
    q, c = data
    d_ref, i_ref = jax_unweighted["mxu_fast"]
    d, i = _port(q, c, k, "mxu_fast")
    sure = assert_topk_close(d, i, d_ref[:, :k], i_ref[:, :k], 1e-5,
                             d_ref[:, k] if k < 32 else None)
    assert sure > 0.9
    # the bound is an upper bound of the distance of every returned row
    dots = np.sum(q[:, None] * c[i], axis=-1)
    assert np.all(d >= np.mean(1.0 - np.abs(dots), axis=-1) - 1e-6)


def test_weighted_engines_match_jax_kernel(data):
    """Two interpret-mode calls: the exact engine at k = 13 and the bound at
    k = 8, with the joint-rank weights."""
    q, c = data
    d_ref, i_ref = _jax_kernel(q, c, 13, "vpu", W)
    d, i = _port(q, c, 13, "vpu", W)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i, i_ref)
    d_ref, i_ref = _jax_kernel(q, c, 8, "mxu_fast", W)
    d, i = _port(q, c, 8, "mxu_fast", torch.from_numpy(W))
    assert_topk_close(d, i, d_ref, i_ref, 1e-5)


def _bf16(x):
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_engine_is_its_numpy_emulation(data, weighted):
    q, c = data
    w = W if weighted else np.full(21, np.float32(1.0 / 21), np.float32)
    qb, cb = _bf16(q), _bf16(c)
    geo = None
    for j in range(21):
        dot = qb[:, None, j, 0] * cb[None, :, j, 0]
        for dd in range(1, 4):
            dot = dot + qb[:, None, j, dd] * cb[None, :, j, dd]
        term = w[j] * (np.float32(1.0) - np.abs(dot))
        geo = term if geo is None else geo + term
    order = np.argsort(geo, axis=1, kind="stable")[:, :32]
    d, i = _port(q, c, 32, "mxu_bf16", W if weighted else None)
    np.testing.assert_array_equal(d, np.take_along_axis(geo, order, 1))
    np.testing.assert_array_equal(i, order)
    d_exact, _ = _port(q, c, 32, "vpu", W if weighted else None)
    bar = (2.0 ** -8 + 2.0 ** -18) * float(w.sum()) + 1e-6
    err = np.abs(d - d_exact).max()
    assert 0 < err <= bar, (err, bar)


@pytest.mark.parametrize("weighted", [False, True])
def test_geodesic_bound_scores_match_jax(data, weighted):
    q, c = data
    want = np.asarray(jfk.geodesic_bound_scores(jnp.asarray(q), jnp.asarray(c),
                                                weights=W if weighted else None))
    got = fused_knn.geodesic_bound_scores(torch.from_numpy(q), torch.from_numpy(c),
                                          weights=W if weighted else None)
    # scores scale with W = sum_j w_j (4.21 weighted): 1e-6 x W, fp32 sums of 84 terms
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * (float(W.sum()) if weighted else 1.0))
    exact = geodesic_topk(torch.from_numpy(q), torch.from_numpy(c), 1,
                          weights=torch.from_numpy(W) if weighted else None)[0]
    assert bool((got.min(dim=1).values >= exact[:, 0] - 1e-6).all())


def test_fast_path_matches_jax():
    """Prescreen + exact rerank on a clustered pose-like corpus: the exact
    top-k, as JAX's composite returns it (one interpret-mode call)."""
    rng = np.random.default_rng(1)
    c = _manifold(rng, 12, 40, 0.05)
    q = np.repeat(c[::40], 4, axis=0)
    q = q + 0.05 * rng.normal(size=q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    with pltpu.force_tpu_interpret_mode():
        d_ref, i_ref = map(np.asarray, jfk.fused_geodesic_topk_fast(
            jnp.asarray(q), jnp.asarray(c), 5, interpret=True, **TILES))
    d, i = fused_knn.fused_geodesic_topk_fast(torch.from_numpy(q), torch.from_numpy(c), 5)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    d_x, i_x = geodesic_topk(torch.from_numpy(q), torch.from_numpy(c), 5)
    np.testing.assert_array_equal(i.numpy(), i_x.numpy())
    dw, iw = fused_knn.fused_geodesic_topk_fast(torch.from_numpy(q), torch.from_numpy(c), 4,
                                                weights=W)
    d_x, i_x = geodesic_topk(torch.from_numpy(q), torch.from_numpy(c), 4,
                             weights=torch.from_numpy(W))
    np.testing.assert_array_equal(iw.numpy(), i_x.numpy())
    np.testing.assert_allclose(dw.numpy(), d_x.numpy(), rtol=0, atol=1e-6)


def test_duplicate_rows_lowest_index_first():
    rng = np.random.default_rng(2)
    q, c = _unit(rng, 4), _unit(rng, 300)
    c[10] = c[150] = c[290] = q[0]
    for engine in ("vpu", "mxu_bf16", "mxu_fast"):
        d, i = _port(q, c, 3, engine)
        assert i[0].tolist() == [10, 150, 290], engine
        assert d[0, 0] == d[0, 1] == d[0, 2]


def test_checks_raise_as_in_jax():
    rng = np.random.default_rng(3)
    q, c = _unit(rng, 4), _unit(rng, 64)
    cases = [(dict(k=33), "k <= 32"), (dict(k=5, c=c[:3]), "corpus of at least"),
             (dict(k=5, weights=np.ones(7, np.float32)), "weights"),
             (dict(k=5, dot_impl="mxu_int8"), "dot_impl")]
    for kw, match in cases:
        kw = dict(kw)
        cc = kw.pop("c", c)
        with pytest.raises(ValueError, match=match):
            jfk.fused_geodesic_topk(jnp.asarray(q), jnp.asarray(cc), interpret=True, **kw)
        with pytest.raises(ValueError, match=match):
            fused_knn.fused_geodesic_topk(torch.from_numpy(q), torch.from_numpy(cc), **kw)
    with pytest.raises(ValueError, match="prescreen_k"):
        jfk.fused_geodesic_topk_fast(jnp.asarray(q), jnp.asarray(c), 9, prescreen_k=8,
                                     interpret=True)
    with pytest.raises(ValueError, match="prescreen_k"):
        fused_knn.fused_geodesic_topk_fast(torch.from_numpy(q), torch.from_numpy(c), 9,
                                           prescreen_k=8)


def test_mxu_engine_is_not_ported():
    rng = np.random.default_rng(4)
    q, c = torch.from_numpy(_unit(rng, 4)), torch.from_numpy(_unit(rng, 64))
    with pytest.raises(ValueError, match="not ported"):
        fused_knn.fused_geodesic_topk(q, c, 5, dot_impl="mxu")


def test_wrapper_takes_only_the_cpu_or_a_cuda_device():
    rng = np.random.default_rng(5)
    q, c = torch.from_numpy(_unit(rng, 4)), torch.from_numpy(_unit(rng, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fused_knn.fused_geodesic_topk(q.to("meta"), c.to("meta"), 5)
    with pytest.raises(ValueError, match="corpus on"):
        fused_knn.fused_geodesic_topk(q, c.to("meta"), 5)
