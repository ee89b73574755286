"""The train tile kernel's tensor-core arithmetic and its weights' pack, on the CPU.

``posendf_train_tile`` (``csrc/train_kernels.cu``) runs both branches of
the training gradient in 64-pose CTAs: the DFNet forward, the inner pullback
and (noisy branch) the e-chain as 3xTF32 ``wgmma`` from the field kernels'
weight slabs (``fused_model.pack_tc``: the forward's, the backward's, the
forward's again), the encoder's walks, the output layer and the eikonal
term on the CUDA cores, act'(z) kept from the forward as one bit a pose and
unit. A model of that arithmetic (the products slab by slab in the
program's order, ``tests/tc_model.py``: A and B split by ``tf32_split``,
the tensor cores' sums rounding toward zero, a fresh accumulator each 32 of
K folded into fp32 totals; the rest plain fp32; the encoder's gradient
summed over each 64-pose CTA, then over the CTAs in order) is held to the
tile's plain version ``branch_ref``: the rows a_l and c_l, dd, the encoder
gradient and the loss sums, at 64 and a ragged 130 poses a branch; and both
branches' rows through ``reduce_ref`` to ``manual_train_grads`` at the
card's leaf bar (``chip_smoke.py``'s LEAF_TOL = 1e-4 x max|leaf|). Fields:
the trained one (``docs/quality/ckpt_l8_best.msgpack``), a seeded lrelu
field whose widths need padding and a chain of another width, and a seeded
relu field at the trained widths (relu's kink takes a unit's whole
gradient).

The bars of the rows: the model's 3xTF32 sums keep ~21 bits a product, and
each layer's are some 1e-7 of its scale from fp32's (as the field
kernels' are, PERF.md §6); each row block is held within ROW_TOL = 1e-5 x
its max |value|, and dd, the encoder's gradient and the loss sums as the
card holds them (TERM_RTOL = 1e-5 for the sums).

The pack: every training step packs the slabs anew from the step's
weights, by one gather from an index made once per structure; it must be
the slab-by-slab construction it replaced, to the bit, before and after an
Adam step moves the weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch.field import Field, load_field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_model, fused_train  # noqa: E402
from posendf_torch.ops.fused_model import TC_KPERM, TC_SLAB_FLOATS, TC_SLAB_K  # noqa: E402
from posendf_torch.ops.fused_train import BranchRows, tf32_split  # noqa: E402
from posendf_torch.ops.train_grad import manual_train_grads  # noqa: E402
from tests import tc_model  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

CKPT = "docs/quality/ckpt_l8_best.msgpack"
LEAF_TOL = 1e-4     # x max|leaf|: chip_smoke.py's bar of the card's gradient
TERM_RTOL = 1e-5
ROW_TOL = 1e-5      # x max|block| of a row block; the reason is in the docstring
CTA = 64            # poses a CTA of the tile kernel
KW = dict(weight_dist=0.7, weight_man=1.3, weight_eikonal=0.9)


def _inputs(seed, rows):
    rng = np.random.default_rng(seed)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))

    pose = unit(rows)
    dist = torch.from_numpy((np.abs(rng.normal(size=rows)) * 0.1).astype(np.float32))
    return pose, dist, unit(rows)


def _doubled(module):
    with torch.no_grad():
        for p in module.dfnet.parameters():
            p.mul_(2.0)
    return Field(module).weights()


@pytest.fixture(scope="module", params=["trained", "lrelu", "relu"])
def weights(request):
    if request.param == "trained":
        return load_field(CKPT, device="cpu").weights()
    if request.param == "relu":   # the trained widths, seeded weights doubled
        return _doubled(PoseNDF(activation="relu", generator=torch.Generator().manual_seed(3)))
    # 126 -> 200 -> 700 -> 96 -> 1: padded to 256, 768 (chained with the next), 512
    return _doubled(PoseNDF(dfnet_dims=(200, 700, 96), activation="lrelu",
                            generator=torch.Generator().manual_seed(5)))


def _cta_sum(left, right):
    """sum_p left[p]^T right[p] over each CTA's poses, then over the CTAs in order."""
    tot = None
    for c0 in range(0, left.shape[0], CTA):
        part = left[c0:c0 + CTA].T @ right[c0:c0 + CTA]
        tot = part if tot is None else tot + part
    return tot


def tile_model(w, q, gt, *, eikonal, l2, dd_coef, eik_coef) -> BranchRows:
    """The tile kernel's arithmetic for one branch (``branch_ref``'s
    arguments), in ``branch_ref``'s layout."""
    tc = w.tc_packed()
    relu = w.activation == "relu"
    act = torch.relu if relu else (lambda z: torch.where(z >= 0, z, 0.01 * z))

    def d1(z):
        return (z > 0).to(z.dtype) if relu else torch.where(z >= 0, 1.0, 0.01).to(z.dtype)

    head, fwd, bwd = tc_model.program(tc)
    stream = tc_model.SlabStream(tc)
    vec, width = tc.vec, tc_model.z_widths(tc)
    zoff = sorted(width)                       # hidden layer l's z offset
    w1, b1, w2, b2 = (w.enc[k] for k in ("w1", "b1", "w2", "b2"))
    L, J, F, R = len(w.layers), w.num_joints, w.feature_size, q.shape[0]
    outs = [wl.shape[1] for wl, _ in w.layers]

    # normalization and encoder walk (CUDA cores: plain fp32)
    if eikonal:
        s = torch.sum(q * q, dim=1, keepdim=True)
        n = torch.sqrt(torch.clamp_min(s, 1e-24))
        x = q / n
    else:
        x = q
    feat, inp, zh, zf = [None] * J, [None] * J, [None] * J, [None] * J
    for j in range(J):
        p = w.parents[j]
        inp[j] = torch.cat([x[:, j], q.new_zeros((R, F)) if p < 0 else feat[p]], dim=-1)
        zh[j] = inp[j] @ w1[j] + b1[j]
        zf[j] = act(zh[j]) @ w2[j] + b2[j]
        feat[j] = act(zf[j])
    code = torch.cat(feat, dim=-1)

    # the DFNet's passes from the slabs; act'(z) from the forward's z
    z = {}

    def fwd_epi(acc, b, zo, cols):
        zz = acc + vec[b + cols.start:b + cols.stop]
        z.setdefault(zo, torch.zeros(R, width[zo]))[:, cols] = zz
        return act(zz)

    def grad_epi(acc, _, zo, cols):
        return acc * d1(z[zo][:, cols]) if zo >= 0 else acc

    def padded(t, cols):
        return torch.cat([t, t.new_zeros(R, cols - t.shape[1])], dim=-1)

    last, xo = tc_model.run(stream, padded(code, head[2]), fwd, fwd_epi)
    K = head[3]
    d = torch.relu(last[:, :K] @ vec[head[4]:head[4] + K] + vec[head[5]])
    res = d - gt
    if l2:
        lsum, dd = torch.sum(res * res), dd_coef * 2.0 * res
    else:
        lsum, dd = torch.sum(torch.abs(res)), dd_coef * torch.sign(res)
    c_last = (d > 0).to(q.dtype)[:, None]
    g = (c_last * vec[head[4]:head[4] + K]) * d1(z[head[6]])
    gcode, co = tc_model.run(stream, g, bwd, grad_epi)
    assert stream.pos == tc.nfwd + tc.nbwd
    xs = [code] + [xo[zoff[l]][:, :outs[l]] for l in range(L - 1)]
    cs = [co[zoff[l]][:, :outs[l]] for l in range(L - 2)] + [g[:, :outs[L - 2]], c_last]

    # the encoder's reverse walk (plain fp32)
    gfeat = list(gcode[:, :J * F].reshape(R, J, F).unbind(1))
    gx, gh, gf = [None] * J, [None] * J, [None] * J
    for j in range(J - 1, -1, -1):
        gf[j] = gfeat[j] * d1(zf[j])
        gh[j] = (gf[j] @ w2[j].T) * d1(zh[j])
        gin = gh[j] @ w1[j].T
        gx[j] = gin[:, :4]
        if w.parents[j] >= 0:
            gfeat[w.parents[j]] = gfeat[w.parents[j]] + gin[:, 4:]
    l1 = [dd[:, None] * inp[j] for j in range(J)]
    l2v = [dd[:, None] * act(zh[j]) for j in range(J)]
    a_rows = [dd[:, None] * xl for xl in xs]
    esum = q.new_zeros(())
    if eikonal:
        # the normalization's VJP, the eikonal term, its cotangent (plain fp32)
        gx = torch.stack(gx, dim=1)
        coef = (s >= 1e-24).to(q.dtype) / (n * n * n)
        gq = gx / n - q * (torch.sum(gx * q, dim=1, keepdim=True) * coef)
        gn = torch.sqrt(torch.sum(gq * gq, dim=-1) + 1e-12)
        esum = torch.sum((gn - 1.0) ** 2)
        ggq = eik_coef * ((gn - 1.0) / gn)[..., None] * gq
        ggx = ggq / n - q * (torch.sum(ggq * q, dim=1, keepdim=True) * coef)
        efeat = [None] * J
        for j in range(J):
            p = w.parents[j]
            egin = torch.cat([ggx[:, j], q.new_zeros((R, F)) if p < 0 else efeat[p]], dim=-1)
            ea = (egin @ w1[j]) * d1(zh[j])
            efeat[j] = (ea @ w2[j]) * d1(zf[j])
            l1[j] = l1[j] + egin
            l2v[j] = l2v[j] + ea
        # the e-chain's DFNet half: the forward's slabs again
        stream.restart()
        ecx0 = torch.cat(efeat, dim=-1)
        _, eo = tc_model.run(stream, padded(ecx0, head[2]), fwd, grad_epi)
        assert stream.pos == tc.nfwd
        a_rows[0] = a_rows[0] + ecx0
        for l in range(L - 1):
            a_rows[l + 1] = a_rows[l + 1] + eo[zoff[l]][:, :outs[l]]
    ddc = dd[:, None]
    enc = {"w1": torch.stack([_cta_sum(l1[j], gh[j]) for j in range(J)]),
           "b1": torch.stack([_cta_sum(ddc, gh[j])[0] for j in range(J)]),
           "w2": torch.stack([_cta_sum(l2v[j], gf[j]) for j in range(J)]),
           "b2": torch.stack([_cta_sum(ddc, gf[j])[0] for j in range(J)])}
    return BranchRows(a=a_rows, c=cs, dd=dd, enc=enc, loss=torch.stack([lsum, esum]))


def _close(name, got, want, *, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol * max(scale, 1e-30), \
        f"{name}: max |err| {err:.3e} > {tol} x {scale:.3e}"


@torch.no_grad()
@pytest.mark.parametrize("rows", [64, 130])
def test_tile_model_holds_the_bars(weights, rows):
    pose, dist, man = _inputs(rows, rows)
    lt = "l1" if rows == 64 else "l2"
    kw_n, kw_m = fused_train.branch_args(weights, pose, dist, man, lt, **KW)
    model = (tile_model(weights, pose, dist, **kw_n),
             tile_model(weights, man, torch.zeros(rows), **kw_m))
    plain = (fused_train.branch_ref(weights, pose, dist, **kw_n),
             fused_train.branch_ref(weights, man, torch.zeros(rows), **kw_m))
    assert float((plain[0].c[-1] > 0).float().mean()) > 0.2   # d > 0: the rows are not all zero
    for name, m, p in zip(("noisy", "manifold"), model, plain):
        for l in range(len(weights.layers)):
            _close(f"{name} a[{l}]", m.a[l], p.a[l], tol=ROW_TOL)
            _close(f"{name} c[{l}]", m.c[l], p.c[l], tol=ROW_TOL)
        _close(f"{name} dd", m.dd, p.dd, tol=TERM_RTOL)
        for k in m.enc:
            _close(f"{name} encoder {k}", m.enc[k], p.enc[k], tol=ROW_TOL)
        torch.testing.assert_close(m.loss, p.loss, rtol=TERM_RTOL, atol=0.0)
    # both branches through the plain reduction, against the plain gradient
    grads, _ = fused_train.reduce_ref(weights, *model)
    _, _, want = manual_train_grads(fused_train.state_dict(weights), pose, dist, man,
                                    parents=weights.parents, activation=weights.activation,
                                    loss_type=lt, **KW)
    for k, v in want.items():
        _close(f"leaf {k}", grads[k], v, tol=LEAF_TOL)


def _pack_slab_by_slab(w):
    """pack_tc's slabs as they were cut before the gather: each (matrix,
    layer, columns) zero-padded, split to TF32 hi / lo, swizzled, and the
    slabs stacked in the program's order one by one."""
    widths = w.tc_packed().widths
    _, _, _, fslabs, bslabs = fused_model.tc_schedule(widths)
    mats = {}
    for l, (wl, _) in enumerate(w.layers[:-1]):
        m = wl.new_zeros(widths[l], widths[l + 1])
        m[:wl.shape[0], :wl.shape[1]] = wl.detach().float()
        mats["w", l], mats["wt", l] = m, m.t()

    def cut(m, cols):
        N, K = m.shape
        kl = TC_SLAB_FLOATS // 2 // cols
        b = m.reshape(N // cols, cols, K // kl, kl // TC_SLAB_K, TC_SLAB_K).permute(2, 0, 3, 1, 4)
        b = b.reshape(*b.shape[:-1], TC_SLAB_K // 8, 8)[..., list(TC_KPERM)]
        hi, lo = tf32_split(b.reshape(*b.shape[:-3], cols * TC_SLAB_K))
        off = fused_model.tc_slab_offsets(cols).reshape(-1)
        out = b.new_zeros(*hi.shape[:-1], 2, cols * TC_SLAB_K)
        out[..., 0, off] = hi
        out[..., 1, off] = lo
        return out.reshape(K // kl, N // cols, TC_SLAB_FLOATS)

    order = fslabs + bslabs
    cuts = {key: cut(mats[key[:2]], key[2]) for key in {(k, l, c) for k, l, _, _, c in order}}
    return torch.stack([cuts[k, l, c][kb, cg] for k, l, kb, cg, c in order])


def test_pack_gather_is_the_slab_by_slab_pack_before_and_after_a_step():
    """The pack by one gather equals the slab-by-slab one to the bit, for the
    trained field before and after an Adam step, and for a field whose
    widths need padding and a chain of another width."""
    module = load_field(CKPT, device="cpu").module
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    pose, dist, man = _inputs(9, 64)
    fields = [module, None,
              PoseNDF(dfnet_dims=(200, 700, 96), generator=torch.Generator().manual_seed(5))]
    for i, m in enumerate(fields):
        if m is None:   # one Adam step of the fused gradient moves the trained weights
            before = [p.detach().clone() for p in module.parameters()]
            _, _, grads = fused_train.fused_train_grads(
                fused_model.FieldWeights.from_module(module), pose, dist, man)
            for name, p in module.named_parameters():
                p.grad = grads[name]
            opt.step()
            assert all(not torch.equal(a, p) for a, p in zip(before, module.parameters()))
            m = module
        w = fused_model.FieldWeights.from_module(m)
        tc = fused_model.pack_tc(w)
        assert torch.equal(tc.slabs.view(torch.int32), _pack_slab_by_slab(w).view(torch.int32)), i
        assert tc.slabs.shape == (tc.nfwd + tc.nbwd, TC_SLAB_FLOATS)
