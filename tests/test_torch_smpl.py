"""The port's SMPL body model against the JAX package's, and against a naive
oracle of the SMPL paper's equations.

``synthetic_model`` must give the JAX package's arrays to the bit (the same
numpy draws). ``lbs_forward`` / ``BodyModel`` and their pose gradient are
held to JAX's at 1e-5 (measured apart by at most 2.4e-7 in vertices and
joints, and 3.8e-6 in the gradient, whose entries reach 13.7: fp32 sums in
another order). The
naive oracle (per-sample float64 loops, 4 x 4 homogeneous chains; the copy
of ``tests/test_smpl.py``'s) holds the port at the bars the JAX package's
test uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu.smpl import BodyModel as JaxBodyModel  # noqa: E402
from posendf_tpu.smpl import lbs as jax_lbs  # noqa: E402

from posendf_torch.checkpoints import smpl_model_from_jax  # noqa: E402
from posendf_torch.smpl import BodyModel, lbs  # noqa: E402

TOL = 1e-5
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")


def _inputs(seed, B, n_betas=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(B, n_betas)).astype(np.float32),
            rng.normal(scale=0.6, size=(B, 3)).astype(np.float32),
            rng.normal(scale=0.4, size=(B, 69)).astype(np.float32))


@pytest.mark.parametrize("num_vertices,seed", [(128, 0), (80, 1), (300, 5)])
def test_synthetic_model_is_jax_bits(num_vertices, seed):
    j = jax_lbs.synthetic_model(num_vertices=num_vertices, seed=seed)
    t = lbs.synthetic_model(num_vertices=num_vertices, seed=seed)
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(j.faces, t.faces) and tuple(j.parents) == t.parents
    c = smpl_model_from_jax(j)
    for f in FIELDS:
        assert torch.equal(getattr(c, f), getattr(t, f)), f


@pytest.mark.parametrize("betas_kind", ["per_frame", "per_subject", "vector"])
def test_lbs_forward_matches_jax(betas_kind):
    jm = jax_lbs.synthetic_model(num_vertices=128, seed=2)
    tm = smpl_model_from_jax(jm)
    betas, orient, pose = _inputs(3, 5)
    betas = {"per_frame": betas, "per_subject": betas[:1], "vector": betas[0]}[betas_kind]
    vj, jj = jax_lbs.lbs_forward(jm, jnp.asarray(betas), jnp.asarray(orient), jnp.asarray(pose))
    vt, jt = lbs.lbs_forward(tm, torch.from_numpy(betas), torch.from_numpy(orient),
                             torch.from_numpy(pose))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=TOL)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="does not match pose batch"):
        lbs.lbs_forward(tm, torch.zeros((3, 10)), torch.from_numpy(orient),
                        torch.from_numpy(pose))


def test_body_model_with_landmarks_matches_jax():
    """A mesh as large as SMPL's gets smplx's 21 landmarks after the 24
    joints (Jtr (B, 45, 3)); the hands are padded from a (B, 63) pose."""
    jm = jax_lbs.synthetic_model(num_vertices=6900, seed=4)
    jb = JaxBodyModel(model=jm)
    tb = BodyModel(model=smpl_model_from_jax(jm), device="cpu")
    betas, orient, pose = _inputs(5, 3)
    for pb in (pose, pose[:, :63]):
        want = jb(root_orient=jnp.asarray(orient), pose_body=jnp.asarray(pb),
                  betas=jnp.asarray(betas))
        got = tb(root_orient=orient, pose_body=pb, betas=betas)
        assert tuple(got.Jtr.shape) == (3, 45, 3)
        for k in ("vertices", "Jtr", "body_pose", "full_pose"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=0, atol=TOL, err_msg=k)
        np.testing.assert_array_equal(got.Jtr[:, 24:].numpy(),
                                      got.vertices[:, lbs.SMPL_VERTEX_LANDMARKS].numpy())
    small = BodyModel(device="cpu")(pose_body=pose)
    assert tuple(small.Jtr.shape) == (3, 24, 3) and small.vertices.shape[1] == 128
    with pytest.raises(ValueError, match="63|69"):
        tb(pose_body=np.zeros((2, 50), np.float32))


def test_pose_gradient_matches_jax():
    """d(weighted vertices and joints)/d(pose) against jax.grad, the hand
    dofs at the zero rotation as every caller pads them."""
    jm = jax_lbs.synthetic_model(num_vertices=128, seed=6)
    tm = smpl_model_from_jax(jm)
    betas, orient, pose = _inputs(7, 4)
    pose[:, 63:] = 0.0
    rng = np.random.default_rng(8)
    wv = rng.normal(size=(4, 128, 3)).astype(np.float32)
    wj = rng.normal(size=(4, 24, 3)).astype(np.float32)

    def jax_loss(p):
        v, j = jax_lbs.lbs_forward(jm, jnp.asarray(betas), jnp.asarray(orient), p)
        return jnp.sum(v * wv) + jnp.sum(j * wj)

    want = jax.grad(jax_loss)(jnp.asarray(pose))
    p = torch.from_numpy(pose).requires_grad_(True)
    v, j = lbs.lbs_forward(tm, torch.from_numpy(betas), torch.from_numpy(orient), p)
    (g,) = torch.autograd.grad((v * torch.from_numpy(wv)).sum() + (j * torch.from_numpy(wj)).sum(),
                               p)
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_load_smpl_model_npz(tmp_path):
    """A model file in the SMPL layout (posedirs (V, 3, 207), a kintree table)
    written from the synthetic model loads back to its arrays."""
    m = lbs.synthetic_model(num_vertices=96, seed=9)
    V = m.num_vertices
    path = str(tmp_path / "smpl.npz")
    np.savez(path, v_template=m.v_template.numpy(), shapedirs=m.shapedirs.numpy(),
             posedirs=m.posedirs.numpy().T.reshape(V, 3, 207),
             J_regressor=m.j_regressor.numpy(), weights=m.lbs_weights.numpy(), f=m.faces,
             kintree_table=np.stack([np.asarray(m.parents), np.arange(24)]))
    got = lbs.load_smpl_model(path, num_betas=10)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(m, f)), f
    assert np.array_equal(got.faces, m.faces) and got.parents == m.parents
    jm = jax_lbs.load_smpl_model(path, num_betas=10)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jm, f)), getattr(got, f).numpy()), f
    assert BodyModel(bm_path=path, device="cpu").model.num_vertices == V


# --------------------------------------------------------------------------
# The naive equation oracle of tests/test_smpl.py (SMPL paper, Loper et al.
# 2015, eqs. 2-7): per-sample loops, scratch Rodrigues, per-joint 4x4
# homogeneous chains. It shares no code with posendf_torch/smpl/lbs.py.
# --------------------------------------------------------------------------

def _naive_rodrigues(aa):
    theta = float(np.linalg.norm(aa))
    if theta < 1e-12:
        return np.eye(3)
    k = np.asarray(aa, np.float64) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _naive_smpl_forward(v_template, shapedirs, posedirs_v3p, j_regressor, weights, parents,
                        betas, full_pose_aa):
    V, J = v_template.shape[0], len(parents)
    v_shaped = v_template + shapedirs @ betas
    j_rest = j_regressor @ v_shaped
    R = np.stack([_naive_rodrigues(full_pose_aa[k]) for k in range(J)])
    pose_feat = np.concatenate([(R[k] - np.eye(3)).ravel() for k in range(1, J)])
    v_posed = v_shaped + posedirs_v3p @ pose_feat
    G = np.zeros((J, 4, 4))
    G[0] = np.eye(4)
    G[0][:3, :3] = R[0]
    G[0][:3, 3] = j_rest[0]
    for k in range(1, J):
        local = np.eye(4)
        local[:3, :3] = R[k]
        local[:3, 3] = j_rest[k] - j_rest[parents[k]]
        G[k] = G[parents[k]] @ local
    joints_posed = G[:, :3, 3].copy()
    Gp = np.zeros_like(G)
    for k in range(J):
        undo = np.eye(4)
        undo[:3, 3] = -j_rest[k]
        Gp[k] = G[k] @ undo
    verts = np.zeros((V, 3))
    for v in range(V):
        T = np.zeros((4, 4))
        for k in range(J):
            T += weights[v, k] * Gp[k]
        verts[v] = (T @ np.append(v_posed[v], 1.0))[:3]
    return verts, joints_posed


def _oracle_vs_port(model, rng, n_betas, atol):
    B = 2
    betas = rng.normal(scale=0.5, size=(B, n_betas)).astype(np.float32)
    orient = rng.normal(scale=0.6, size=(B, 3)).astype(np.float32)
    pose = rng.normal(scale=0.4, size=(B, 69)).astype(np.float32)
    verts, joints = lbs.lbs_forward(model, torch.from_numpy(betas), torch.from_numpy(orient),
                                    torch.from_numpy(pose))
    v_t = model.v_template.double().numpy()
    pd = model.posedirs.double().numpy().T.reshape(len(v_t), 3, 207)
    for b in range(B):
        full = np.concatenate([orient[b].reshape(1, 3), pose[b].reshape(23, 3)]).astype(np.float64)
        v_ref, j_ref = _naive_smpl_forward(
            v_t, model.shapedirs.double().numpy(), pd, model.j_regressor.double().numpy(),
            model.lbs_weights.double().numpy(), model.parents, betas[b].astype(np.float64), full)
        np.testing.assert_allclose(verts[b].numpy(), v_ref, atol=atol)
        np.testing.assert_allclose(joints[b].numpy(), j_ref, atol=atol)


def test_naive_equation_oracle_synthetic_model():
    _oracle_vs_port(lbs.synthetic_model(), np.random.default_rng(42), 10, atol=1e-5)


def test_naive_equation_oracle_random_full_rank_model():
    """A dense random model on a randomized tree: a transposed rotation, a
    swapped parent and child, a wrong blend order or a mispacked posedirs
    cannot cancel."""
    rng = np.random.default_rng(7)
    V, J = 40, lbs.NUM_JOINTS
    parents = tuple([-1] + [int(rng.integers(0, j)) for j in range(1, J)])
    w = np.abs(rng.normal(size=(V, J))) + 1e-3
    w /= w.sum(axis=1, keepdims=True)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    model = lbs.SMPLModel(
        v_template=f32(rng.normal(scale=0.5, size=(V, 3))),
        shapedirs=f32(rng.normal(scale=0.05, size=(V, 3, 6))),
        posedirs=f32(rng.normal(scale=0.01, size=(V, 3, 207)).reshape(V * 3, 207).T),
        j_regressor=f32(rng.normal(size=(J, V)) / V),
        lbs_weights=f32(w), faces=np.zeros((1, 3), np.int32), parents=parents)
    _oracle_vs_port(model, np.random.default_rng(8), 6, atol=2e-5)
