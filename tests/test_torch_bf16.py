"""The port's bf16 compute mode against the JAX package, on the CPU.

``compute_dtype="bfloat16"`` is two functions in JAX, and the port mirrors
each:

* the module path (``PoseNDF`` / ``distance_and_grad``): the DFNet's
  products on bf16 operands with fp32 sums, each hidden output rounded to
  bf16, the structure encoder in fp32 (``posendf_tpu/models/dfnet.py``);
  its gradient is autodiff of that, the cotangent rounded where the forward
  rounds (JAX's transpose of ``astype``);
* the fused kernels' mode (``_model_kernel``, ``_vag_kernel``,
  ``_proj_kernel``): every product, the encoder's and the output layer's
  included, forward and backward, on bf16 operands with fp32 sums. The
  port's plain versions (``fused_posendf_forward_ref``,
  ``fused_distance_and_grad_ref``, ``project_step_ref``) compute it, and
  are held here to JAX's Pallas kernels in interpret mode, as
  ``tests/test_fused_grad.py`` runs them.

Fields: lrelu, relu and softplus at the default widths, seeded, weights
scaled by 1.5 and the head bias lifted by 0.2 so that d has signal (as
``tests/test_fused_grad.py:139-143``), 128 numpy-seeded poses, 2 projection
steps; and the trained field against ``tests/data/torch_port_bf16_expected.npz``
(``scripts/make_torch_port_bf16_golden.py``, 256 probes, 10 steps).

The bars (``fused_model.bf16_hold``, whose comment derives them): both
sides round the same operands, but their fp32 sums differ in order, so a
value within a few fp32 units of a bf16 rounding tie rounds to neighbouring
bf16 values on the two sides, and that pose moves by up to the order of
the bf16-vs-fp32 gap. So a pose is off beyond atol = 1e-6 on d and g (and
rtol 1e-5 on the projection), the fp32 paths' agreement (they meet at
about 1e-7); at most 45% of the poses may be off while at least 80% of
them are that far between bf16 and fp32 (asserted: the bar tells a bf16
result from an fp32 one, and each atol is at most half the gap's median
pose); the mean pose error is at most 0.2 of the gap's and the largest
error at most twice the largest gap (``fused_model`` gives the readings
each bar sits between). The gap is JAX's
bf16 result against the port's fp32 plain version on the same poses (the
fp32 versions are held to JAX's within 1e-5 in ``tests/test_torch_kernels.py``
and ``test_torch_slice.py``). Each check also holds the fp32 result to the
same rule and expects it to fail, and a result with one rounding left out
(planted in the plain versions: the encoder's, the output layer's operand,
the cast of the backward's cotangent before one transposed product) fails
it too.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.field import distance_and_grad as jax_distance_and_grad  # noqa: E402
from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.ops.fused_grad import fused_distance_and_grad as jax_vag  # noqa: E402
from posendf_tpu.ops.fused_grad import fused_project as jax_project  # noqa: E402
from posendf_tpu.ops.fused_model import fused_posendf_forward as jax_forward  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch import cli  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.config import PoseNDFConfig, save_config  # noqa: E402
from posendf_torch.field import Field, distance_and_grad  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.models.dfnet import bf16_round  # noqa: E402
from posendf_torch.ops import fused_grad, fused_model, fused_train  # noqa: E402
from posendf_torch.ops.fused_model import (  # noqa: E402
    BF16_SLAB, BF16_SLAB_K, FieldWeights, bf16_hold, bf16_slab_offsets,
)
from posendf_torch.projection import project  # noqa: E402
from posendf_torch.training.trainer import make_optimizer, make_train_step  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
L8_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_l8_expected.npz")
BF16_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_bf16_expected.npz")
ACTS = ["lrelu", "relu", "softplus"]
N_POSES, STEPS, TILE = 128, 2, 128
ATOL = 1e-6                   # d and g: the fp32 paths' agreement (module docstring)
PROJ_RTOL, PROJ_ATOL = 1e-5, 1e-6


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pair(act, compute_dtype):
    """JAX module and params, and the port's module with the same weights."""
    jm = JaxPoseNDF(activation=act, compute_dtype=compute_dtype)
    params = jm.init(jax.random.key(3), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(1.5), params)
    params["dfnet"]["b6"] = params["dfnet"]["b6"] + np.float32(0.2)
    tm = PoseNDF(activation=act, compute_dtype=compute_dtype)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _fp32(module):
    """The same weights in an fp32 module."""
    m = PoseNDF(dfnet_dims=module.dfnet.widths[1:-1], activation=module.activation,
                beta=module.beta)
    m.load_state_dict(module.state_dict())
    return m


@pytest.fixture(scope="module", params=ACTS)
def case(request):
    """One JAX evaluation per field: the bf16 module path's d and g, the bf16
    kernels' forward, value-and-grad and 2-step projection (interpret mode);
    the port's module, and its fp32 twin."""
    act = request.param
    jm, params, tm = _pair(act, "bfloat16")
    q = _poses(11, N_POSES)
    d, g = jax_distance_and_grad(jm, params, jnp.asarray(q))
    kw = dict(parents=jm.parents, activation=act, beta=jm.beta, tile_b=TILE,
              compute_dtype="bfloat16")
    with pltpu.force_tpu_interpret_mode():
        fwd = jax_forward(jnp.asarray(q), params["enc"], params["dfnet"], **kw)
        vd, vg = jax_vag(jnp.asarray(q), params["enc"], params["dfnet"], **kw)
        out, hist = jax_project(jnp.asarray(q), params["enc"], params["dfnet"], steps=STEPS,
                                **kw)
    jax_out = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        d=d, g=g, fwd=fwd, vd=vd, vg=vg, out=out, hist=hist).items()}
    return act, torch.from_numpy(q), tm, _fp32(tm), jax_out


def _hold_and_refuse_fp32(name, got, want, fp32, **bars):
    """``got`` passes the bf16 hold against ``want``; the fp32 result fails it."""
    st = bf16_hold(name, got, want, fp32, **bars)
    with pytest.raises(AssertionError):
        bf16_hold(name + " (fp32)", fp32, want, fp32, **bars)
    return st


def test_bf16_module_path_matches_jax(case):
    """d and the autograd gradient of the port's bf16 module against JAX's
    ``PoseNDF(compute_dtype="bfloat16")`` and ``distance_and_grad``."""
    act, q, tm, tm32, ref = case
    d, g = distance_and_grad(tm, q)
    d32, g32 = distance_and_grad(tm32, q)
    _hold_and_refuse_fp32(f"{act} module d", d, ref["d"], d32, atol=ATOL)
    _hold_and_refuse_fp32(f"{act} module g", g, ref["g"], g32, atol=ATOL)


def test_bf16_plain_versions_match_jax_kernels(case):
    """The bf16 plain versions of the forward, value-and-grad and projection
    step kernels against JAX's bf16 Pallas kernels: d, g and a 2-step
    projection (poses and history)."""
    act, q, tm, tm32, ref = case
    w, w32 = FieldWeights.from_module(tm), FieldWeights.from_module(tm32)
    assert w.bf16 and not w32.bf16
    with torch.no_grad():
        fwd = fused_model.fused_posendf_forward(q, w)
        d, g = fused_grad.fused_distance_and_grad(q, w)
        out, hist = fused_grad.fused_project(q, w, steps=STEPS)
        fwd32 = fused_model.fused_posendf_forward(q, w32)
        d32, g32 = fused_grad.fused_distance_and_grad(q, w32)
        out32, hist32 = fused_grad.fused_project(q, w32, steps=STEPS)
    _hold_and_refuse_fp32(f"{act} forward", fwd, ref["fwd"], fwd32, atol=ATOL)
    _hold_and_refuse_fp32(f"{act} value-and-grad d", d, ref["vd"], d32, atol=ATOL)
    _hold_and_refuse_fp32(f"{act} value-and-grad g", g, ref["vg"], g32, atol=ATOL)
    _hold_and_refuse_fp32(f"{act} projection poses", out, ref["out"], out32, atol=PROJ_ATOL,
                          rtol=PROJ_RTOL)
    _hold_and_refuse_fp32(f"{act} projection history", hist.t(), ref["hist"].t(), hist32.t(),
                          atol=PROJ_ATOL, rtol=PROJ_RTOL)


def test_bf16_plain_versions_match_jax_golden():
    """The trained field in bf16 against ``torch_port_bf16_expected.npz``: the
    forward, value-and-grad and a 10-step projection of the 256 probes, and
    the module path's d; the fp32 values of ``torch_port_l8_expected.npz``
    (the same probes) give the gap."""
    ref, ref32 = np.load(BF16_EXPECTED), np.load(L8_EXPECTED)
    assert np.array_equal(ref["probes"], ref32["probes"])
    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    field = posendf_torch.load_field(L8, config=cfg, device="cpu")
    assert field.weights().bf16
    q = torch.from_numpy(ref["probes"])
    t = {k: torch.from_numpy(ref[k]) for k in ref.files}
    t32 = {k: torch.from_numpy(ref32[k]) for k in ref32.files}
    steps = t["proj_hist"].shape[0]
    with torch.no_grad():
        fwd = field.distance_fused(q)
        d, g = field.distance_and_grad_fused(q)
        out, hist = project(field, q, steps=steps, fused=True)
        module_d = field.distance(q)
    bf16_hold("trained forward", fwd, t["fwd_dist"], t32["dist"], atol=ATOL)
    bf16_hold("trained value-and-grad d", d, t["vag_dist"], t32["dist"], atol=ATOL)
    bf16_hold("trained value-and-grad g", g, t["vag_grad"], t32["grad"], atol=ATOL)
    bf16_hold("trained projection poses", out, t["proj_out"], t32["proj_out"],
              atol=PROJ_ATOL, rtol=PROJ_RTOL)
    bf16_hold("trained projection history", hist.t(), t["proj_hist"].t(), t32["proj_hist"].t(),
              atol=PROJ_ATOL, rtol=PROJ_RTOL)
    bf16_hold("trained module d", module_d, t["module_dist"], t32["dist"], atol=ATOL)


def _drop_rounding(monkeypatch, module, skip):
    """``module``'s product operands stay unrounded wherever ``skip(t)``."""
    rounding = module.operand

    def operand(weights):
        c = rounding(weights)
        return lambda t: t if skip(t) else c(t)

    monkeypatch.setattr(module, "operand", operand)


FAULT_POSES = 200   # of the golden file's probes: no weight of the trained field has 200 rows


@pytest.mark.parametrize("fault", ["encoder", "output_layer", "backward_cast"])
def test_bf16_hold_fails_a_dropped_rounding(fault, monkeypatch):
    """Each result with one rounding of the bf16 kernels' arithmetic left out
    fails ``bf16_hold`` against ``torch_port_bf16_expected.npz`` on the
    share or mean rule (not on the rule that tells bf16 from fp32): the
    module path's d, whose encoder stays fp32, against the kernel's; the
    forward with the output layer's 64-wide operand unrounded; the gradient
    with the cotangent unrounded before the 1024-wide layer's transposed
    product."""
    ref, ref32 = np.load(BF16_EXPECTED), np.load(L8_EXPECTED)
    n = FAULT_POSES
    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    field = posendf_torch.load_field(L8, config=cfg, device="cpu")
    assert all(w.shape[0] != n for w, _ in field.weights().layers)
    q = torch.from_numpy(ref["probes"][:n])
    with torch.no_grad():
        if fault == "encoder":
            got, want, fp32 = field.distance(q), ref["fwd_dist"], ref32["dist"]
        elif fault == "output_layer":
            _drop_rounding(monkeypatch, fused_model, lambda t: tuple(t.shape) == (n, 64))
            got, want, fp32 = field.distance_fused(q), ref["fwd_dist"], ref32["dist"]
        else:
            _drop_rounding(monkeypatch, fused_grad, lambda t: tuple(t.shape) == (n, 1024))
            got, want, fp32 = field.distance_and_grad_fused(q)[1], ref["vag_grad"], ref32["grad"]
    want, fp32 = torch.from_numpy(want[:n]), torch.from_numpy(fp32[:n])
    with pytest.raises(AssertionError) as fail:
        bf16_hold(f"{fault} left unrounded", got, want, fp32, atol=ATOL)
    assert "does not tell" not in str(fail.value)


def test_bf16_pack_is_the_rounded_weights():
    """``pack_bf16`` against its layout, read back by hopper.cuh's
    ``sw128_offset`` formula: each slab (the order of ``tc_schedule(widths,
    BF16_SLAB_K)``) is its block of the zero-padded W^T (forward) or W
    (backward) rounded to bf16, a 128-column slab 64 of K a line, a
    64-column one (a chain's first product) 128 of K in two tiles of 64
    lines; every element of a slab is a weight (zero only where the weight
    is padding); the output layer's w rounded, the biases not; the program
    of pack_tc, half its slabs; the encoder walks' rows (``pack_walk``),
    w1 and w2 rounded in bf16 and not in fp32."""
    # 126 -> 200 -> 700 -> 96 -> 1: padded to 128, 256, 768 (chained), 512
    tm = PoseNDF(dfnet_dims=(200, 700, 96), compute_dtype="bfloat16",
                 generator=torch.Generator().manual_seed(5))
    w = FieldWeights.from_module(tm)
    tc = w.tc_packed()
    tc32 = fused_model.pack_tc(FieldWeights.from_module(_fp32(tm)))
    assert tc.bf16 and tc.slabs.dtype == torch.bfloat16 and tc.slabs.shape[1] == BF16_SLAB
    assert tc.widths == tc32.widths == (128, 256, 768, 512)
    _, _, _, fslabs, bslabs = fused_model.tc_schedule(tc.widths, BF16_SLAB_K)
    assert tc.order == fslabs + bslabs and (tc.nfwd, tc.nbwd) == (len(fslabs), len(bslabs))
    assert 2 * tc.nfwd == tc32.nfwd and 2 * tc.nbwd == tc32.nbwd
    assert torch.equal(tc.prog, tc32.prog) and tc.slabs.shape[0] == tc.nfwd + tc.nbwd
    mats, pads = {}, {}
    for l, (wl, _) in enumerate(w.layers[:-1]):
        m = torch.zeros(tc.widths[l], tc.widths[l + 1])
        m[:wl.shape[0], :wl.shape[1]] = bf16_round(wl.detach())
        pad = torch.ones(tc.widths[l], tc.widths[l + 1], dtype=torch.bool)
        pad[:wl.shape[0], :wl.shape[1]] = False
        mats["w", l], mats["wt", l] = m, m.t()
        pads["w", l], pads["wt", l] = pad, pad.t()
    seen = {key: torch.zeros_like(m, dtype=torch.int32) for key, m in mats.items()}
    for slab, (kind, l, kb, cg, cols) in zip(tc.slabs, tc.order):
        kl = BF16_SLAB // cols
        off = bf16_slab_offsets(cols, kl).reshape(-1)
        assert torch.equal(off.sort().values, torch.arange(BF16_SLAB))   # every element in use
        block = (slice(cg * cols, (cg + 1) * cols), slice(kb * kl, (kb + 1) * kl))
        assert torch.equal(slab[off].float().reshape(cols, kl), mats[kind, l][block]), \
            (kind, l, kb, cg)
        # an element that is not a weight (padding) is zero
        assert not bool(slab[off].reshape(cols, kl)[pads[kind, l][block]].any())
        seen[kind, l][block] += 1
    assert all(bool((n == 1).all()) for n in seen.values())   # each block once
    # the formula: K 64h + k of column r at line r + cols h, sw128 chunk (k / 8) ^ (line % 8)
    for cols, kl in ((128, 64), (64, 128)):
        off = bf16_slab_offsets(cols, kl)
        for r, k in ((0, 0), (5, 17), (cols - 1, kl - 1), (9, 70 % kl)):
            line, kk = r + cols * (k // 64), k % 64
            assert int(off[r, k]) * 2 == (line // 8) * 1024 + (line % 8) * 128 + \
                (((kk * 2) // 16) ^ (line % 8)) * 16 + (kk * 2) % 16
    n_out = w.layers[-1][0].numel()
    o0 = sum(tc.widths[1:])
    assert torch.equal(tc.vec[o0:o0 + n_out], bf16_round(w.layers[-1][0].detach()).reshape(-1))
    assert torch.equal(tc.vec[:o0], tc32.vec[:o0])
    # the encoder walks' rows (pack_walk), read back by their formula: w1 and w2 rounded in
    # bf16, not in fp32; the biases as they are
    enc = tm.enc
    for wf, rnd in ((w, bf16_round), (FieldWeights.from_module(_fp32(tm)), lambda t: t)):
        w1, b1, w2, b2 = (t.detach() for t in (enc.w1, enc.b1, enc.w2, enc.b2))
        J, E, F = w1.shape[0], w1.shape[-1], w2.shape[-1]
        R, RF, RE = 4 * -(-(E + 1) // 4), 4 * -(-F // 4), 4 * -(-E // 4)
        walk = wf.walk_packed()
        assert walk.numel() == J * ((E + F) * R + E * RF + E * RE)
        rows = walk[:J * (E + F) * R].view(J, E + F, R)
        assert torch.equal(rows[:, :E, :E], rnd(w1).transpose(1, 2))
        assert torch.equal(rows[:, :E, E], b1) and torch.equal(rows[:, E:, E], b2)
        assert torch.equal(rows[:, E:, :E], rnd(w2).transpose(1, 2))
        assert not bool(rows[..., E + 1:].any())
        r2 = walk[J * (E + F) * R:J * ((E + F) * R + E * RF)].view(J, E, RF)
        r1 = walk[J * ((E + F) * R + E * RF):].view(J, E, RE)
        assert torch.equal(r2[..., :F], rnd(w2)) and not bool(r2[..., F:].any())
        assert torch.equal(r1[..., :E], rnd(w1)) and not bool(r1[..., E:].any())
    # the common arguments pick the bf16 route and the walks' rows
    args = fused_model.common_args(torch.zeros(1, 21, 4), w)
    assert args[-1] == 1 and args[2] == w.walk_packed().data_ptr()
    assert fused_model.common_args(torch.zeros(1, 21, 4), FieldWeights.from_module(_fp32(tm)))[-1] == 0
    with pytest.raises(ValueError, match="bfloat16"):
        fused_model.pack_bf16(FieldWeights.from_module(_fp32(tm)))
    with pytest.raises(ValueError, match="pack_bf16"):
        fused_model.pack_tc(w)


def test_bf16_and_ff_enc_refusals_mirror_jax(tmp_path):
    """JAX's refusals: the bf16 fused forward's backward raises; the fused
    paths refuse ff_enc; the fused train step and gradient refuse bf16. A
    bf16 config loads and ``cli generate`` runs on the CPU when asked to."""
    tm = PoseNDF(dfnet_dims=(24, 32), activation="softplus", compute_dtype="bfloat16")
    field = Field(tm)
    q = torch.from_numpy(_poses(2, 8)).requires_grad_(True)
    d = field.distance_fused(q)
    with pytest.raises(NotImplementedError, match="bf16|bfloat16"):
        d.sum().backward()
    ff = Field(PoseNDF(dfnet_dims=(24, 32), ff_enc=True))
    for fn in (ff.distance_fused, ff.distance_and_grad_fused,
               lambda p: project(ff, p, steps=1, fused=True)):
        with pytest.raises(ValueError, match="ff_enc=False"):
            fn(q.detach())
    with pytest.raises(ValueError, match="ff_enc"):
        FieldWeights.from_module(ff.module)
    relu = PoseNDF(dfnet_dims=(24, 32), activation="relu", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="fp32"):
        make_train_step(relu, make_optimizer(relu.parameters(), 1e-3), loss_type="l1",
                        weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}, fused=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_train.fused_train_grads(FieldWeights.from_module(relu), q.detach(),
                                      torch.zeros(8), q.detach())
    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    path = str(tmp_path / "bf16.json")
    save_config(cfg, path)
    loaded = posendf_torch.load_field(L8, config=path, device="cpu")
    assert loaded.module.dfnet.compute_dtype == "bfloat16" and loaded.weights().bf16
    out = str(tmp_path / "poses.npz")
    cli.main(["generate", "--device", "cpu", "--ckpt", L8, "--config", path, "--num-poses", "6",
              "--steps", "2", "--fused", "--out", out])
    got = np.load(out)
    assert got["pose"].shape == (6, 21, 4) and np.isfinite(got["dist_history"]).all()
