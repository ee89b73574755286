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
* A model of the kernels that walks the program, takes the slabs from the
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
  padding and a chain of another width.

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
from posendf_torch.ops.fused_model import TC_CHUNK, TC_KPERM, TC_SLAB_K, TC_SLAB_N  # noqa: E402
from posendf_torch.ops.fused_train import tf32_split  # noqa: E402

CKPT = "docs/quality/ckpt_l8_best.msgpack"
D_ATOL = G_ATOL = 1e-5
PROJ_RTOL, PROJ_ATOL = 1e-4, 1e-5
N_POSES = 256


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


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


def _blocks(tc):
    """Each slab read back by the swizzle's formula: a list of (halves, 2,
    rows, 32) tensors in K-position order (hi and lo of each 32 of K)."""
    out = []
    for slab, (_, _, _, _, cols) in zip(tc.slabs, tc.order):
        off = fused_model.tc_slab_offsets(cols).reshape(-1)
        halves = slab.reshape(-1, 2, cols * TC_SLAB_K)[:, :, off]
        out.append(halves.reshape(-1, 2, cols, TC_SLAB_K))
    return out


def _features(block):
    """K positions -> features within each 8-group (the inverse of TC_KPERM)."""
    out = torch.empty_like(block)
    out.reshape(*block.shape[:-1], -1, 8)[..., list(TC_KPERM)] = \
        block.reshape(*block.shape[:-1], -1, 8)
    return out


def test_packed_slabs_are_the_split_weights(weights):
    tc = weights.tc_packed()
    D = tc.widths
    blocks = _blocks(tc)
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
                    hi[rows, k0:k0 + TC_SLAB_K] = _features(half[0])
                    lo[rows, k0:k0 + TC_SLAB_K] = _features(half[1])
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


def _toward_zero(t):
    """float64 -> float32, rounded toward zero."""
    t32 = t.float()
    return torch.where(t32.double().abs() > t.abs(), torch.nextafter(t32, torch.zeros_like(t32)),
                       t32)


def _model(q, weights):
    """The field kernels' arithmetic: the plain encoder and normalization, the
    DFNet by the program with each product in 3xTF32 from the packed slabs:
    each k8 step's 8 products of a pass summed exactly and added to an fp32
    accumulator rounding toward zero (the tensor cores' accumulation, as
    modelled here), a fresh accumulator a slab added to the layer's sums in
    fp32. Returns d (B, 1) and g (B, J, 4)."""
    tc = weights.tc_packed()
    name, beta = weights.activation, weights.beta
    act, out_act = resolve(name, beta)
    prog = tc.prog.tolist()
    head, steps = prog[:fused_model.TC_HEAD], prog[fused_model.TC_HEAD:]
    steps = [steps[i:i + fused_model.TC_STEP] for i in range(0, len(steps), fused_model.TC_STEP)]
    fwd, bwd = steps[:head[0]], steps[head[0]:]
    assert len(bwd) == head[1]
    stream = iter(_blocks(tc))
    vec = tc.vec
    B = q.shape[0]

    def prod(a, K, N, cols=TC_SLAB_N):
        tot = torch.zeros(B, N)
        per = TC_SLAB_N // cols   # K blocks a slab: 1, or 2 in a chain's first product
        for kb in range(0, K // TC_SLAB_K, per):
            for cg in range(N // cols):
                halves = next(stream)
                c = slice(cg * cols, (cg + 1) * cols)
                for h, (bh, bl) in enumerate(halves):
                    k = slice((kb + h) * TC_SLAB_K, (kb + h + 1) * TC_SLAB_K)
                    apos = a[:, k].reshape(B, -1, 8)[..., list(TC_KPERM)]
                    ah, al = (t.double() for t in tf32_split(apos.reshape(B, TC_SLAB_K)))
                    bh, bl = bh.double(), bl.double()
                    acc = torch.zeros(B, cols)
                    for kk in range(TC_SLAB_K // 8):
                        k8 = slice(8 * kk, 8 * kk + 8)
                        for x, y in ((al, bh), (ah, bl), (ah, bh)):   # the small terms first
                            acc = _toward_zero(acc.double() + x[:, k8] @ y[:, k8].t())
                    tot[:, c] = tot[:, c] + acc
        return tot

    # the encoder and the normalization, as the plain version computes them
    s = torch.sum(q * q, dim=1, keepdim=True)
    n = s.clamp_min(1e-24).sqrt()
    _, (zh, zf, _) = fused_model.field_forward_ref(q / n, weights, keep=True)
    code = torch.cat([act(z) for z in zf], dim=-1)
    x = torch.cat([code, code.new_zeros(B, head[2] - code.shape[1])], dim=-1)
    z = {}
    for chain, K, N, N2, b1, z1, b2, z2 in fwd:
        if chain:
            y, z[z1] = 0, torch.zeros(B, N)
            for c in range(N // TC_CHUNK):
                cols = slice(c * TC_CHUNK, (c + 1) * TC_CHUNK)
                z[z1][:, cols] = prod(x, K, TC_CHUNK, TC_CHUNK) + vec[b1:b1 + N][cols]
                y = y + prod(act(z[z1][:, cols]), TC_CHUNK, N2)
            z[z2] = y + vec[b2:b2 + N2]
            x = act(z[z2])
        else:
            z[z1] = prod(x, K, N) + vec[b1:b1 + N]
            x = act(z[z1])
    K = head[3]
    d = out_act(x[:, :K] @ vec[head[4]:head[4] + K][:, None] + vec[head[5]])
    g = (out_act_grad_from_value(name, beta, d) * vec[head[4]:head[4] + K]) * \
        act_grad(name, beta, z[head[6]])
    for chain, K, N, N2, _, z1, _, z2 in bwd:
        if chain:
            y = 0
            for c in range(N // TC_CHUNK):
                cols = slice(c * TC_CHUNK, (c + 1) * TC_CHUNK)
                h = prod(g, K, TC_CHUNK, TC_CHUNK) * act_grad(name, beta, z[z1][:, cols])
                y = y + prod(h, TC_CHUNK, N2)
            g = y * act_grad(name, beta, z[z2]) if z2 >= 0 else y
        else:
            acc = prod(g, K, N)
            g = acc * act_grad(name, beta, z[z1]) if z1 >= 0 else acc
    assert next(stream, None) is None   # every slab read
    # the encoder's reverse walk and the normalization's VJP, as the plain version
    J, F = weights.num_joints, weights.feature_size
    gfeat = list(g[:, :J * F].reshape(B, J, F).unbind(1))
    w1, w2 = weights.enc["w1"], weights.enc["w2"]
    gx = [None] * J
    for j in range(J - 1, -1, -1):
        gf = gfeat[j] * act_grad(name, beta, zf[j])
        gh = torch.matmul(gf, w2[j].t()) * act_grad(name, beta, zh[j])
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
