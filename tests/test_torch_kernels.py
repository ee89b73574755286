"""Plain versions of the port's CUDA kernels against the JAX package's Pallas
kernels, which run here in TPU interpret mode as ``tests/test_fused_grad.py``
runs them.

Each kernel module of ``posendf_torch.ops`` holds a plain PyTorch version
of its kernel (``fused_posendf_forward_ref``, ``fused_distance_and_grad_ref``,
``project_step_ref``); on a CPU tensor the wrappers run it. The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them to these plain
versions there). Small widths, every activation, a ragged batch (150 is not a
multiple of the JAX tile of 128) and a zero pose. Bars as in
``tests/test_fused_grad.py``: 1e-5 on d and g, rtol 1e-4 / atol 1e-5 on
projections.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.ops.fused_grad import fused_distance_and_grad as jax_vag  # noqa: E402
from posendf_tpu.ops.fused_grad import fused_project as jax_project  # noqa: E402
from posendf_tpu.ops.fused_model import fused_posendf_forward as jax_forward  # noqa: E402

from posendf_torch import _build  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.field import Field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_grad, fused_model  # noqa: E402
from posendf_torch.ops.fused_model import FieldWeights  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIMS = (24, 32)
ACTS = ["lrelu", "relu", "softplus"]
B = 150
TILE = 128


def _poses(seed, n, zero_at=None):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if zero_at is not None:
        q[zero_at] = 0.0
    return q


@pytest.fixture(scope="module", params=ACTS)
def pair(request):
    """(activation, JAX params, port FieldWeights) with identical weights."""
    act = request.param
    jm = JaxPoseNDF(dfnet_dims=DIMS, activation=act)
    params = jm.init(jax.random.key(1), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(2.0), params)
    params["dfnet"]["b2"] = np.abs(params["dfnet"]["b2"]) + np.float32(0.2)
    tm = PoseNDF(dfnet_dims=DIMS, activation=act)
    tm.load_state_dict(params_from_jax(params))
    return act, params, FieldWeights.from_module(tm)


def _jax_kw(act, params):
    return dict(enc_params=params["enc"], dfnet_params=params["dfnet"],
                parents=JaxPoseNDF().parents, activation=act, beta=100.0, tile_b=TILE)


def test_forward_ref_matches_jax_kernel(pair):
    act, params, w = pair
    q = _poses(0, B)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_forward(jnp.asarray(q), **_jax_kw(act, params)))
    got = fused_model.fused_posendf_forward_ref(torch.from_numpy(q), w).detach().numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_value_and_grad_ref_matches_jax_kernel(pair):
    """Including a zero pose, where g = gx / 1e-12 is huge but finite in
    both (hence the relative bar on that pose)."""
    act, params, w = pair
    q = _poses(1, B, zero_at=5)
    with pltpu.force_tpu_interpret_mode():
        d_want, g_want = map(np.asarray, jax_vag(jnp.asarray(q), **_jax_kw(act, params)))
    d, g = fused_grad.fused_distance_and_grad_ref(torch.from_numpy(q), w)
    d, g = d.detach().numpy(), g.detach().numpy()
    np.testing.assert_allclose(d, d_want, atol=1e-5, rtol=0)
    rows = np.arange(B) != 5
    np.testing.assert_allclose(g[rows], g_want[rows], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g[5], g_want[5], rtol=1e-4, atol=1e-5)
    assert np.isfinite(g).all()


@pytest.mark.parametrize("mode", ["renorm", "no-renorm", "tangent", "scaled"])
def test_project_matches_jax_kernel(mode):
    """Every projection mode goes through the same step math (lrelu field)."""
    jm = JaxPoseNDF(dfnet_dims=DIMS)
    params = jm.init(jax.random.key(2), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(2.0), params)
    params["dfnet"]["b2"] = np.abs(params["dfnet"]["b2"]) + np.float32(0.2)
    tm = PoseNDF(dfnet_dims=DIMS)
    tm.load_state_dict(params_from_jax(params))
    kw = {"renorm": {}, "no-renorm": dict(renormalize=False),
          "tangent": dict(tangent=True), "scaled": dict(step_scale=0.5)}[mode]
    q = _poses(3, B)
    with pltpu.force_tpu_interpret_mode():
        out_want, hist_want = map(np.asarray, jax_project(
            jnp.asarray(q), steps=3, **_jax_kw("lrelu", params), **kw))
    out, hist = fused_grad.fused_project(torch.from_numpy(q), FieldWeights.from_module(tm),
                                         steps=3, **kw)
    assert hist.shape == (3, B) and out.shape == (B, 21, 4)
    np.testing.assert_allclose(out.numpy(), out_want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), hist_want, rtol=1e-4, atol=1e-5)
    one = fused_grad.project_step_ref(torch.from_numpy(q), FieldWeights.from_module(tm), **kw)
    np.testing.assert_allclose(one[0][:, 0].detach().numpy(), hist_want[0], rtol=1e-4, atol=1e-5)


def test_wrappers_run_the_plain_version_on_cpu(pair):
    """CPU tensors take the plain versions and launch nothing; the forward
    stays differentiable, with the module path's gradient."""
    act, params, w = pair
    q = torch.from_numpy(_poses(5, 33))
    before = (fused_model.LAUNCHES, fused_grad.VAG_LAUNCHES, fused_grad.PROJ_LAUNCHES)
    d = fused_model.fused_posendf_forward(q, w)
    torch.testing.assert_close(d, fused_model.fused_posendf_forward_ref(q, w), rtol=0, atol=0)
    dv, gv = fused_grad.fused_distance_and_grad(q, w)
    d_ref, g_ref = fused_grad.fused_distance_and_grad_ref(q, w)
    torch.testing.assert_close(gv, g_ref, rtol=0, atol=0)
    assert not gv.requires_grad and not dv.requires_grad
    ds, qs = fused_grad.project_step(q, w, tangent=True)
    torch.testing.assert_close(qs, fused_grad.project_step_ref(q, w, tangent=True)[1],
                               rtol=0, atol=0)
    assert (fused_model.LAUNCHES, fused_grad.VAG_LAUNCHES, fused_grad.PROJ_LAUNCHES) == before

    qq = q.clone().requires_grad_(True)
    (g_fused,) = torch.autograd.grad(fused_model.fused_posendf_forward(qq, w).sum(), qq)
    np.testing.assert_allclose(g_fused.numpy(), g_ref.detach().numpy(), atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(pair):
    _, _, w = pair
    q = torch.from_numpy(_poses(6, 8))
    with pytest.raises(TypeError, match="float32"):
        fused_grad.fused_distance_and_grad(q.double(), w)
    with pytest.raises(ValueError, match="shape"):
        fused_model.fused_posendf_forward(q.reshape(8, 84), w)
    with pytest.raises(ValueError, match="CUDA"):
        fused_grad.project_step(q.to("meta"), w)


def test_packed_layout_is_what_the_kernels_read():
    """The buffers the kernels index besides the weight slabs: the layer
    table, each layer's (in, out), and the encoder's w1 | b1 | w2 | b2."""
    tm = PoseNDF(dfnet_dims=(24, 32), generator=torch.Generator().manual_seed(0))
    field = Field(tm)
    pk = field.weights().packed()
    assert pk.num_layers == 3 and pk.meta.dtype == torch.int32
    assert pk.parents.tolist() == list(tm.parents)
    assert pk.meta.tolist() == pk.meta_host.tolist() == \
        [list(w.shape) for w, _ in tm.dfnet.layers()] == [[126, 24], [24, 32], [32, 1]]
    enc = torch.cat([p.detach().reshape(-1) for p in (tm.enc.w1, tm.enc.b1, tm.enc.w2,
                                                      tm.enc.b2)])
    assert torch.equal(pk.enc, enc)
    # the cache follows in-place parameter updates
    assert field.weights().packed() is pk
    with torch.no_grad():
        tm.dfnet.b0.add_(1.0)
    assert field.weights().packed() is not pk


def test_build_needs_nvcc_and_keys_on_the_source(monkeypatch):
    """Without a CUDA toolkit the build raises (there is no CPU fallback for
    a CUDA tensor); the kernel signatures cover every launcher of every
    source, and the library's name follows its source and the shared header."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    assert set(_build._SIGNATURES) == set(_build.SOURCES)
    for lib, source in _build.SOURCES.items():
        src = source.read_text()
        assert '#include "common.cuh"' in src, lib
        for name in _build._SIGNATURES[lib]:
            assert f"{name}(" in src, name
        assert _build._target(lib).name.startswith(f"{lib}_")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_every_included_header_keys_the_build(lib):
    """Each header a source includes, and each one those include, is in
    ``_build.HEADERS``, whose bytes the library's hash covers: an edited
    header rebuilds every library, a stale one is never loaded."""
    seen, todo = set(), [_build.SOURCES[lib]]
    while todo:
        for name in re.findall(r'^#include "([^"]+)"', todo.pop().read_text(), re.M):
            path = _build.CSRC / name
            assert path in _build.HEADERS, (lib, name)
            if path not in seen:
                seen.add(path)
                todo.append(path)
    assert _build.CSRC / "common.cuh" in seen


@pytest.mark.parametrize("lib", ["int8", "field", "train", "knn"])
def test_breakdown_cuts_match_the_sources(lib):
    """Every variant of ``python -m posendf_torch.ops.breakdown`` finds the
    statements its cuts replace in the library's source (a cut that no
    longer matches stops the tool on the card)."""
    from posendf_torch.ops import breakdown

    assert set(breakdown.VARIANTS) == set(_build.SOURCES)
    base = _build.SOURCES[lib].read_text()
    for name, cuts in breakdown.VARIANTS[lib].items():
        assert (breakdown.variant_source(lib, name) == base) == (not cuts), name


def test_fused_forward_backward_is_the_module_gradient():
    """distance_fused's backward (the plain formula under autograd) gives the
    module path's parameter and pose gradients, frozen parameters included."""
    tm = PoseNDF(dfnet_dims=DIMS, activation="softplus",
                 generator=torch.Generator().manual_seed(4))
    field = Field(tm)
    q = torch.from_numpy(_poses(9, 12))
    field.distance_fused(q).sum().backward()
    fused = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    field.distance(q).sum().backward()
    for n, p in tm.named_parameters():
        torch.testing.assert_close(fused[n], p.grad, rtol=1e-5, atol=1e-7)
    tm.zero_grad()
    tm.enc.requires_grad_(False)
    qq = q.clone().requires_grad_(True)
    field.distance_fused(qq).sum().backward()
    assert qq.grad is not None and tm.enc.w1.grad is None and tm.dfnet.w0.grad is not None


@pytest.mark.parametrize("act", ["lrelu", "softplus"])
def test_distance_fused_is_differentiable_twice_like_jax(act):
    """An eikonal-style loss of the pose gradient of ``distance_fused`` has
    the module path's parameter gradient and the one JAX takes through its
    fused forward's custom VJP (interpret mode). The norm carries the
    ``losses.py`` epsilon (a pose whose ReLU head is off has g == 0)."""
    from tests.test_torch_training import make_case

    jm, params, tm, q, _, _ = make_case(act, B=20, dims=DIMS, seed=11)

    def eikonal(g, norm, sqrt):
        return ((sqrt(norm(g.reshape(g.shape[0], -1)) + 1e-12) - 1.0) ** 2).sum()

    def jax_loss(p):
        fwd = lambda x: jax_forward(x, p["enc"], p["dfnet"], parents=jm.parents,  # noqa: E731
                                    activation=act, beta=100.0, tile_b=TILE)
        d, pull = jax.vjp(fwd, jnp.asarray(q))
        (g,) = pull(jnp.ones_like(d))
        return eikonal(g, lambda x: jnp.sum(x * x, axis=-1), jnp.sqrt)

    with pltpu.force_tpu_interpret_mode():
        want = params_from_jax(jax.grad(jax_loss)(params))

    field = Field(tm)
    got = {}
    for name, fn in (("fused", field.distance_fused), ("module", field.distance)):
        qq = torch.from_numpy(q).requires_grad_(True)
        d = fn(qq)
        (g,) = torch.autograd.grad(d, qq, torch.ones_like(d), create_graph=True)
        assert g.grad_fn is not None
        loss = eikonal(g, lambda x: torch.sum(x * x, dim=-1), torch.sqrt)
        got[name] = dict(zip([n for n, _ in tm.named_parameters()],
                             torch.autograd.grad(loss, list(tm.parameters()))))
    assert max(float(w.abs().max()) for w in want.values()) > 1e-3
    for k, w in want.items():
        scale = max(1e-6, float(w.abs().max()))
        torch.testing.assert_close(got["fused"][k], got["module"][k], rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got["fused"][k].numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """No silent CPU fallback: ``load_field``, ``cli generate``, the
    ``Trainer``, ``label_split``, ``cli prepare-data``, ``probe_fast_safety``
    and ``resolve_knn_precision('auto')`` default to the card and raise
    without one."""
    import posendf_torch
    from posendf_torch import cli
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.prepare import label_split, probe_fast_safety, resolve_knn_precision
    from posendf_torch.data.synthetic import synthetic_manifold_poses
    from posendf_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        posendf_torch.load_field()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate", "--num-poses", "2", "--steps", "1"])
    cfg = PoseNDFConfig()
    cfg.experiment.root_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["prepare-data", "--amass-raw", str(tmp_path), "--out-dir",
                  str(tmp_path / "prep"), "--stage", "label"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        label_split(str(tmp_path), str(tmp_path / "labeled"), ["ACCAD"])
    corpus = synthetic_manifold_poses(np.random.default_rng(0), 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_fast_safety(corpus, n_queries=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_knn_precision("auto", corpus, verbose=False)
    assert resolve_knn_precision("auto", corpus, device="cpu", verbose=False) == ("highest", None)
    field = posendf_torch.load_field(device="cpu")
    assert field.module.dfnet.w0.device.type == "cpu"
