"""The field kernels' tensor-core layout and arithmetic, on the CPU.

``posendf_forward``, ``posendf_value_and_grad`` and ``posendf_project_step``
(``csrc/field_kernels.cu``) run every DFNet product as 3xTF32 ``wgmma``: A
(the activations) split in registers, B (the weights) split once per field
by ``fused_model.pack_tc`` into slabs of 128 output columns x 32 of K (64
x 64 for the first product of a chain), each TF32 half in the K-major
128-byte swizzle, K permuted within each 8-group (``TC_KPERM``), read in
the order of a program (``tc_schedule``): layers, and the 1024-wide layer
chained with the next 64 columns at a time.

* The packed slabs, read back through ``hopper.cuh``'s ``sw128_offset``
  formula (``tc_slab_offsets``) and the K permutation, are the TF32 split
  of the zero-padded W^T (forward) and W (backward) of every layer, each
  block once; hi + lo is the weight within 2^-22 of itself.
* A model of the kernels (``tests/tc_model.py``, shared with the train
  tile kernel's test) that walks the program, takes the slabs from the
  packed stream in order (every one, none left) and sums each product as
  lo.hi' + hi.lo' + hi.hi' of ``fused_train.tf32_split``, k8 step by k8
  step into fp32 accumulators that round toward zero (the tensor cores'
  accumulation as modelled here), a fresh one a slab added to the layer's
  sums in fp32 as the kernels fold them, held to the plain versions on 256
  numpy-seeded poses with the card's bars: d and g ``atol=1e-5``, a
  projection step ``rtol=1e-4, atol=1e-5``. The trained field
  (``docs/quality/ckpt_l8_best.msgpack``); a seeded relu field of its
  widths, where relu's kink takes a unit's whole gradient, so a sum left
  unfolded over K shows; and a seeded softplus field whose widths need
  padding and a chain of another width. The model's backward multiplies by
  the derivative state as the kernels keep it: lrelu's and relu's act' from
  a bit, softplus's slope sigmoid(beta z) as the forward makes it from its
  one exp (``common.cuh``'s ``softplus_slope``: ``kernel_slope`` here).
* That slope, against float64 sigmoid over a dense grid of beta z in
  [-120, 120] with the edges of exp's range: for beta z >= 0 it is the slope
  from the pre-activation, ``1 / (1 + exp(-beta z))``, to the bit, and below
  no more than an ulp further from sigmoid than that form at worst.

The kernels themselves run on the card only (``chip_smoke.py`` holds them
to the plain versions there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch.field import Field, load_field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.models.activations import (  # noqa: E402
    act_grad, out_act_grad_from_value, resolve,
)
from posendf_torch.ops import fused_grad, fused_model  # noqa: E402
from posendf_torch.ops.fused_model import TC_SLAB_K  # noqa: E402
from posendf_torch.ops.fused_train import tf32_split  # noqa: E402
from tests import tc_model  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

CKPT = "docs/quality/ckpt_l8_best.msgpack"
D_ATOL = G_ATOL = 1e-5
PROJ_RTOL, PROJ_ATOL = 1e-4, 1e-5
N_POSES = 256


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


def kernel_slope(beta: float, z: torch.Tensor) -> torch.Tensor:
    """softplus's slope sigmoid(beta z) as the field kernels make and keep it
    (``common.cuh``'s ``softplus_slope``), in fp32: t = exp(-|beta z|) from
    the forward's exp, then 1 / (1 + t) for beta z >= 0 and t / (1 + t)
    below."""
    bz = beta * z
    t = torch.exp(-bz.abs())
    return torch.where(bz >= 0, 1.0 / (1.0 + t), t / (1.0 + t))


def state_grad(name: str, beta: float, z: torch.Tensor) -> torch.Tensor:
    """act'(z) as the field kernels' backward takes it from their derivative
    state: lrelu's and relu's from a bit (exactly ``act_grad``), softplus's
    the kept slope."""
    return kernel_slope(beta, z) if name == "softplus" else act_grad(name, beta, z)


@pytest.fixture(scope="module", params=["trained", "softplus", "relu"])
def weights(request):
    if request.param == "trained":
        return load_field(CKPT, device="cpu").weights()
    if request.param == "relu":   # the trained widths, seeded weights doubled
        tm = PoseNDF(activation="relu", generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            for p in tm.dfnet.parameters():
                p.mul_(2.0)
        return Field(tm).weights()
    # 126 -> 200 -> 700 -> 96 -> 1: padded to 256, 768 (chained with the next), 512
    tm = PoseNDF(dfnet_dims=(200, 700, 96), activation="softplus", beta=20.0,
                 generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in tm.dfnet.parameters():
            p.mul_(2.0)
    return Field(tm).weights()


def test_packed_slabs_are_the_split_weights(weights):
    tc = weights.tc_packed()
    D = tc.widths
    blocks = tc_model.slab_blocks(tc)
    assert len(blocks) == tc.nfwd + tc.nbwd == len(tc.order)
    for kind in ("wt", "w"):
        for l, (wl, _) in enumerate(weights.layers[:-1]):
            w = torch.zeros(D[l], D[l + 1])
            w[:wl.shape[0], :wl.shape[1]] = wl.detach()
            want = w.t() if kind == "wt" else w                  # (N, K)
            hi, lo = torch.full_like(want, float("nan")), torch.full_like(want, float("nan"))
            seen = 0
            for i, (k, ll, kb, cg, cols) in enumerate(tc.order):
                if k != kind or ll != l:
                    continue
                assert (i < tc.nfwd) == (kind == "wt")
                for h, half in enumerate(blocks[i]):
                    rows = slice(cg * cols, (cg + 1) * cols)
                    k0 = (kb * len(blocks[i]) + h) * TC_SLAB_K
                    assert bool(hi[rows, k0:k0 + TC_SLAB_K].isnan().all())   # each block once
                    hi[rows, k0:k0 + TC_SLAB_K] = tc_model.features(half[0])
                    lo[rows, k0:k0 + TC_SLAB_K] = tc_model.features(half[1])
                    seen += cols * TC_SLAB_K
            assert seen == want.numel(), (kind, l)
            h, lw = tf32_split(want)
            assert torch.equal(hi, h) and torch.equal(lo, lw), (kind, l)
            assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
            exact = want.double()
            assert bool(((hi.double() + lo.double() - exact).abs()
                         <= 2.0 ** -22 * exact.abs()).all()), (kind, l)
            pad = torch.ones(D[l], D[l + 1], dtype=torch.bool)
            pad[:wl.shape[0], :wl.shape[1]] = False
            if kind == "wt":
                pad = pad.t()
            assert not bool(hi[pad].any() or lo[pad].any()), (kind, l)


def _model(q, weights):
    """The field kernels' arithmetic: the plain encoder and normalization, the
    DFNet by the program with each product in 3xTF32 from the packed slabs
    (``tests/tc_model.py``). Returns d (B, 1) and g (B, J, 4)."""
    tc = weights.tc_packed()
    name, beta = weights.activation, weights.beta
    act, out_act = resolve(name, beta)
    head, fwd, bwd = tc_model.program(tc)
    stream = tc_model.SlabStream(tc)
    vec = tc.vec
    B = q.shape[0]
    z, width = {}, tc_model.z_widths(tc)

    def fwd_epi(acc, b, zo, cols):
        z.setdefault(zo, torch.zeros(B, width[zo]))[:, cols] = acc + vec[b + cols.start:b + cols.stop]
        return act(z[zo][:, cols])

    def bwd_epi(acc, _, zo, cols):
        return acc * state_grad(name, beta, z[zo][:, cols]) if zo >= 0 else acc

    # the encoder and the normalization, as the plain version computes them
    s = torch.sum(q * q, dim=1, keepdim=True)
    n = s.clamp_min(1e-24).sqrt()
    _, (zh, zf, _) = fused_model.field_forward_ref(q / n, weights, keep=True)
    code = torch.cat([act(zz) for zz in zf], dim=-1)
    x = torch.cat([code, code.new_zeros(B, head[2] - code.shape[1])], dim=-1)
    x, _ = tc_model.run(stream, x, fwd, fwd_epi)
    K = head[3]
    d = out_act(x[:, :K] @ vec[head[4]:head[4] + K][:, None] + vec[head[5]])
    g = (out_act_grad_from_value(name, beta, d) * vec[head[4]:head[4] + K]) * \
        state_grad(name, beta, z[head[6]])
    g, _ = tc_model.run(stream, g, bwd, bwd_epi)
    assert stream.pos == len(stream.blocks)   # every slab read
    # the encoder's reverse walk and the normalization's VJP, as the plain version
    J, F = weights.num_joints, weights.feature_size
    gfeat = list(g[:, :J * F].reshape(B, J, F).unbind(1))
    w1, w2 = weights.enc["w1"], weights.enc["w2"]
    gx = [None] * J
    for j in range(J - 1, -1, -1):
        gf = gfeat[j] * state_grad(name, beta, zf[j])
        gh = torch.matmul(gf, w2[j].t()) * state_grad(name, beta, zh[j])
        gin = torch.matmul(gh, w1[j].t())
        gx[j] = gin[:, :4]
        if weights.parents[j] >= 0:
            gfeat[weights.parents[j]] = gfeat[weights.parents[j]] + gin[:, 4:]
    gx = torch.stack(gx, dim=1)
    dot = torch.sum(gx * q, dim=1, keepdim=True)
    scale = torch.where(s >= 1e-24, dot / (n * n * n), torch.zeros_like(dot))
    return d, gx / n - q * scale


@torch.no_grad()
def test_3xtf32_model_holds_the_bars(weights):
    q = _poses(11, N_POSES)
    d, g = _model(q, weights)
    torch.testing.assert_close(d, fused_model.fused_posendf_forward_ref(q, weights),
                               rtol=0, atol=D_ATOL)
    d_ref, g_ref = fused_grad.fused_distance_and_grad_ref(q, weights)
    torch.testing.assert_close(d, d_ref, rtol=0, atol=D_ATOL)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=G_ATOL)
    # one projection step from the model's d and g, as the kernel takes it
    q_next = q - d[:, :, None] * g
    q_next = q_next / q_next.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    _, q_ref = fused_grad.project_step_ref(q, weights)
    torch.testing.assert_close(q_next, q_ref, rtol=PROJ_RTOL, atol=PROJ_ATOL)


def _slope_grid(beta: float) -> np.ndarray:
    """fp32 z whose beta z covers [-120, 120] densely, with both zeros, the
    subnormals' and the normals' edges, and where exp over- and underflows
    (|beta z| near 88.72, 87.34 and 103.97), and the infinities."""
    bz = [np.linspace(-120.0, 120.0, 2_400_001, dtype=np.float32),
          np.linspace(-1e-3, 1e-3, 200_001, dtype=np.float32)]
    edges = np.array([0.0, np.finfo(np.float32).smallest_subnormal, np.finfo(np.float32).tiny,
                      1e-30, 1e-7, 0.5, 1.0, 16.635532, 17.0, 87.33655, 88.72284, 103.97208,
                      104.0], dtype=np.float32)
    steps = np.arange(-64, 65).astype(np.float32)
    for x in edges:   # each edge and the 64 floats either side of it
        bz.append((x + steps * np.spacing(x)).astype(np.float32))
    bz.append(np.array([np.inf], dtype=np.float32))
    bz = np.concatenate(bz + [-x for x in bz])
    return (bz / np.float32(beta)).astype(np.float32)


@pytest.mark.parametrize("beta", [100.0, 20.0])
def test_softplus_slope_state(beta):
    """The slope the field kernels keep for softplus (``kernel_slope``, as
    ``softplus_slope`` makes it) against float64 sigmoid(beta z) and against
    the slope from the pre-activation, 1 / (1 + exp(-beta z)) in fp32."""
    z = torch.from_numpy(_slope_grid(beta))
    b = torch.tensor(beta, dtype=torch.float32)
    new = kernel_slope(beta, z)
    old = 1.0 / (1.0 + torch.exp(-b * z))   # -beta * z as CUDA C reads it: (-beta) z
    bz = (b * z).double()
    zero = z == 0
    assert bool(torch.signbit(z[zero]).any()) and not bool(torch.signbit(z[zero]).all())
    exact = torch.sigmoid(bz)   # float64
    up, down = bz >= 0, bz < 0
    assert torch.equal(new[up].view(torch.int32), old[up].view(torch.int32))   # to the bit
    assert bool(((new >= 0) & (new <= 1)).all())
    assert float(new[zero].min()) == float(new[zero].max()) == 0.5

    def ulps(got, mask):   # |got - sigmoid| in fp32 ulps at sigmoid (2^-149 at and below subnormals)
        want = exact[mask]
        spacing = torch.from_numpy(np.spacing(want.float().numpy()).astype(np.float64))
        return (got[mask].double() - want).abs() / spacing

    normal = down & (exact >= float(np.finfo(np.float32).tiny))
    for mask in (down, normal):   # every unit below 0, and those whose slope is a normal float
        worst_new, worst_old = float(ulps(new, mask).max()), float(ulps(old, mask).max())
        assert worst_new <= worst_old + 1.0, (worst_new, worst_old)
    assert float(ulps(new, normal).max()) <= 3.0   # t, 1 + t and the division: a few ulps


def test_schedule_pads_chains_and_refuses():
    assert [fused_model.tc_width(n) for n in (1, 126, 129, 300, 512, 513, 1024)] == \
        [128, 128, 256, 512, 512, 640, 1024]
    assert fused_model.tc_widths((126, 200, 700, 96)) == (128, 256, 768, 512)
    head, fwd, bwd, fslabs, bslabs = fused_model.tc_schedule((128, 256, 512, 1024, 512, 256, 128))
    assert [s[0] for s in fwd] == [0, 0, 1, 0, 0] and [s[0] for s in bwd] == [0, 0, 1, 0, 0]
    assert len(fslabs) == len(bslabs) == 336   # the trained field: 11 MB a pass
    assert head == [5, 5, 128, 128, 2688, 2816, 2560, 2688]
    for bad in ((640, 128, 128), (128, 1024), (128, 1024, 1024, 128, 128),
                (128, 128, 768, 640, 128), (128, 1024, 256, 128)):
        with pytest.raises(ValueError):
            fused_model.tc_schedule(bad)
