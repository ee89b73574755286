"""The field kernels' launch plan (``fused_model.launch_plan``) and, on the
card, the split launch against the unsplit one.

A field kernel's tile is 64 poses on one CTA, and one CTA fills an SM, so the
last, partial wave of tiles leaves most SMs idle. The plan splits that
wave's tiles by output columns across the CTAs of a thread-block cluster,
each rank streaming only its columns' weights and storing its outputs into
every rank's shared memory; every sum keeps its order, so a split tile's
results are the unsplit tile's to the bit. With them, on the card, the
derivative state the backward reads (``fused_model.state_kind``): a softplus
field's value-and-grad and projection step, whose backward multiplies by the
slope its forward keeps, against their plain versions at ``chip_smoke.py``'s
bars, and the launches counted by that state.

This file imports no JAX: on the card (where there is none) run it as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_split_launch.py``;
the ``card`` tests skip without a CUDA device.
"""

import pytest

torch = pytest.importorskip("torch")

from posendf_torch.ops import fused_grad, fused_model  # noqa: E402
from posendf_torch.ops.fused_model import LaunchPlan, launch_plan  # noqa: E402


def slots(s1: int, s2: int):
    return ((1, s1), (2, s2))


# (B, S without clusters, S of clusters of 2) -> (tiles T, full tiles F, split tiles R, c),
# worked by hand from the rule: R = T mod S_2 (T when T < S_2), R x 2 <= S_2, fewer full
# waves T // S_2 than ceil(T / S_1); else c = 1 (F = T, R = 0)
PLANS = [
    (1, 132, 132, (1, 0, 1, 2)),
    (63, 132, 132, (1, 0, 1, 2)),
    (1000, 132, 132, (16, 0, 16, 2)),
    (8448, 132, 132, (132, 132, 0, 1)),         # one full wave: no remainder
    (8449, 132, 132, (133, 132, 1, 2)),
    (10000, 132, 132, (157, 132, 25, 2)),
    (131072, 132, 132, (2048, 2048, 0, 1)),     # R = 68: 68 x 2 > 132
    (4224, 132, 132, (66, 0, 66, 2)),           # 66 x 2 fits, to the CTA
    (4288, 132, 132, (67, 67, 0, 1)),           # 67 x 2 > 132
    (1, 128, 128, (1, 0, 1, 2)),
    (63, 128, 128, (1, 0, 1, 2)),
    (1000, 128, 128, (16, 0, 16, 2)),
    (8448, 128, 128, (132, 128, 4, 2)),
    (8449, 128, 128, (133, 128, 5, 2)),
    (10000, 128, 128, (157, 128, 29, 2)),
    (131072, 128, 128, (2048, 2048, 0, 1)),     # 16 waves of 128: no remainder
    # clusters keeping fewer CTAs than a launch without them
    (8448, 132, 128, (132, 132, 0, 1)),         # R = 4 fits, but 132 fit one wave unsplit
    (8449, 132, 128, (133, 128, 5, 2)),         # one full wave either way, then 5 split
    (10000, 132, 120, (157, 120, 37, 2)),
    (131072, 132, 120, (2048, 2048, 0, 1)),     # R = 8 fits, but 17 full waves of 120 > 16 of 132
    (1000, 132, 1, (16, 16, 0, 1)),             # no cluster of 2 fits
]


@pytest.mark.parametrize("B,s1,s2,want", PLANS)
def test_launch_plan(B, s1, s2, want):
    plan = launch_plan(B, slots(s1, s2), (2,))
    T, F, R, c = want
    assert (plan.tiles, plan.full, plan.rem, plan.split) == (T, F, R, c)
    assert plan.ctas == F + R * c
    if c > 1:
        assert F % c == 0 and R * c <= s2


@pytest.mark.parametrize("sizes,want", [((2,), (157, 132, 25, 2)), ((), (157, 157, 0, 1)),
                                        ((4,), (157, 157, 0, 1))])
def test_launch_plan_sizes(sizes, want):
    """The sizes a plan may take at 10,000 poses on 132 SMs: none (what the
    card tests patch ``SPLIT_SIZES`` to, for the unsplit launch), or one the
    slots do not list, are a CTA a tile."""
    plan = launch_plan(10000, slots(132, 132), sizes)
    assert (plan.tiles, plan.full, plan.rem, plan.split) == want


def test_launch_plan_defaults_and_bf16():
    """The module's sizes are what the plan tries by default, and the one
    the kernel splits across (kSplit); a plan with no slots (a bf16 field's)
    is a CTA a tile."""
    from posendf_torch import _build

    assert launch_plan(10000, slots(132, 132)) == launch_plan(10000, slots(132, 132),
                                                               fused_model.SPLIT_SIZES)
    assert fused_model.SPLIT_SIZES == (2,)
    assert "constexpr int kSplit = 2;" in _build.SOURCES["field"].read_text()
    assert launch_plan(10000, ()) == LaunchPlan(157, 157, 0, 1, 157)


@pytest.mark.parametrize("c", [2, 4])
def test_split_slabs_are_each_ranks_pieces(c):
    """``TcPacked.split_slabs(c)``: rank r's share of slab g is the r-th
    8 KB / c of each of the slab's four 8 KB blocks, in block order, and
    nothing else; the pack is made once."""
    from posendf_torch.models import PoseNDF

    w = fused_model.FieldWeights.from_module(PoseNDF(generator=torch.Generator().manual_seed(3)))
    tc = w.tc_packed()
    got = tc.split_slabs(c)
    assert got is tc.split_slabs(c)
    n, piece = tc.slabs.shape[0], 2048 // c
    assert got.shape == (n, c, 4, piece) and got.is_contiguous()
    slabs = tc.slabs.view(n, 4, 2048)
    for r in range(c):
        for b in range(4):
            assert torch.equal(got[:, r, b], slabs[:, b, r * piece:(r + 1) * piece])
    assert torch.equal(got.flatten().sort().values, tc.slabs.flatten().sort().values)


@pytest.mark.parametrize("act,kind", [("lrelu", "bits"), ("relu", "bits"), ("softplus", "slope")])
def test_state_kind(act, kind):
    """The derivative state a field's value-and-grad and projection-step
    launches keep, by its activation, in both routes; ``STATE_LAUNCHES``
    counts launches by it, and the plain versions a CPU tensor takes count
    nothing."""
    from posendf_torch.models import PoseNDF

    w = fused_model.FieldWeights.from_module(_module(act, False))
    w16 = fused_model.FieldWeights.from_module(PoseNDF(activation=act, compute_dtype="bfloat16"))
    assert w16.bf16 and fused_model.state_kind(w) == fused_model.state_kind(w16) == kind
    before = dict(fused_model.STATE_LAUNCHES)
    assert set(before) == {"bits", "slope"}
    q = torch.nn.functional.normalize(torch.rand((3, 21, 4), generator=torch.Generator().manual_seed(1)),
                                      dim=-1)
    fused_grad.fused_distance_and_grad(q, w)
    fused_grad.project_step(q, w)
    assert fused_model.STATE_LAUNCHES == before


def test_softplus_backward_takes_the_kept_slope():
    """The field kernels' softplus backward multiplies by the slope its
    forward keeps (``softplus_slope``): no act' is computed from a
    pre-activation in the field source or the header it shares."""
    from posendf_torch import _build

    src = _build.SOURCES["field"].read_text() + "".join(h.read_text() for h in _build.HEADERS)
    assert "softplus_slope(" in src and "act_grad(" not in src


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(act: str, wide: bool):
    return fused_model.FieldWeights.from_module(_module(act, wide).cuda())


def _module(act: str, wide: bool):
    from posendf_torch.models import PoseNDF

    if wide:   # 32 joints of 8 features: the encoder walks at the run-time width
        parents = (-1,) + tuple((j - 1) // 2 for j in range(1, 32))
        module = PoseNDF(num_joints=32, parents=parents, feature_size=8, dfnet_dims=(200, 300),
                         activation=act, generator=torch.Generator().manual_seed(4))
    else:      # the published widths: 21 joints of 6 features, the 1024-wide chained layer
        module = PoseNDF(activation=act, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in module.dfnet.parameters():
            p.mul_(2.0)
    return module


def _unsplit(monkeypatch, fn):
    """fn() with no cluster size to split across: every tile a CTA."""
    with monkeypatch.context() as m:
        m.setattr(fused_model, "SPLIT_SIZES", ())
        return fn()


@pytest.mark.card
@pytest.mark.parametrize("wide", [False, True], ids=["21x6", "32x8"])
@pytest.mark.parametrize("act", ["lrelu", "relu", "softplus"])
def test_split_launch_equals_unsplit(card, monkeypatch, act, wide):
    """Forward, value-and-grad and projection step, split as the plan has
    it and unsplit: the same bits, at 1,000 poses (every tile split),
    8,449 (one) and 10,000 (the last wave)."""
    w = _field(act, wide)
    gen = torch.Generator().manual_seed(21)
    J = w.num_joints
    counts = dict(fused_model.SPLIT_LAUNCHES)
    states = dict(fused_model.STATE_LAUNCHES)
    split_launches = 0
    for B in (1000, 8449, 10000):
        q = torch.nn.functional.normalize(torch.rand((B, J, 4), generator=gen) - 0.5, dim=-1).to(card)
        plan = fused_model.plan_launch(q, w)
        assert plan.split > 1 and plan.rem > 0, plan
        split_launches += 3
        def run():
            with torch.no_grad():
                return (fused_model.fused_posendf_forward(q, w),
                        *fused_grad.fused_distance_and_grad(q, w),
                        *fused_grad.project_step(q, w, step_scale=100.0))

        runs = [run(), _unsplit(monkeypatch, run)]
        torch.cuda.synchronize()
        for name, got, want in zip(("forward d", "value-and-grad d", "g", "step d", "step q"),
                                   *runs):
            assert bool(torch.isfinite(want).all()), (act, B, name)
            assert torch.equal(got, want), (act, wide, B, name, float((got - want).abs().max()))
    moved = {c: fused_model.SPLIT_LAUNCHES[c] - counts[c] for c in counts}
    assert moved == {1: split_launches, 2: split_launches}
    # the value-and-grad and step launches (two of each three), by their derivative state
    kind = "slope" if act == "softplus" else "bits"
    moved = {k: fused_model.STATE_LAUNCHES[k] - states[k] for k in states}
    assert moved == {"bits": 0, "slope": 0, kind: 2 * 2 * split_launches // 3}


@pytest.mark.card
@pytest.mark.parametrize("B", [10000, 8449])
def test_softplus_slope_state_holds_the_bars(card, B):
    """A softplus field at the published widths, whose backward multiplies by
    the slope sigmoid(beta z) its forward keeps: the value-and-grad kernel
    and the projection step at the main path's 10,000 poses (25 tiles split)
    and at 8,449 (one), against ``fused_distance_and_grad_ref`` and
    ``project_step_ref`` at ``chip_smoke.py``'s bars, a pose beyond a bar held
    to float64 as there (``assert_rows_close``); each launch counted as
    "slope" state."""
    import copy

    from chip_smoke import (D_ATOL, G_ATOL, PROJ_ATOL, PROJ_RTOL, assert_close,
                            assert_rows_close)

    module = _module("softplus", False).to(card)
    w = fused_model.FieldWeights.from_module(module)
    w64 = fused_model.FieldWeights.from_module(copy.deepcopy(module).double())
    gen = torch.Generator().manual_seed(22)
    q = torch.nn.functional.normalize(torch.rand((B, 21, 4), generator=gen) - 0.5, dim=-1).to(card)
    assert fused_model.plan_launch(q, w).rem > 0
    states = dict(fused_model.STATE_LAUNCHES)
    with torch.no_grad():
        d_k, g_k = fused_grad.fused_distance_and_grad(q, w)
        s_k = fused_grad.project_step(q, w, step_scale=100.0)
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
        s_p = fused_grad.project_step_ref(q, w, step_scale=100.0)
        q64 = q.double()
        _, g_64 = fused_grad.fused_distance_and_grad_ref(q64, w64)
        s_64 = fused_grad.project_step_ref(q64, w64, step_scale=100.0)
        x64 = q64 / (q64 ** 2).sum(1, keepdim=True).clamp_min(1e-24).sqrt()
        _, (_, _, zs) = fused_model.field_forward_ref(x64, w64, keep=True)
    torch.cuda.synchronize()
    assert {k: fused_model.STATE_LAUNCHES[k] - states[k] for k in states} == {"bits": 0, "slope": 2}
    kink = torch.cat(zs, 1).abs().amin(1)
    assert_close("softplus value-and-grad d", d_k, d_p, atol=D_ATOL)
    assert_rows_close("softplus value-and-grad g", g_k, g_p, g_64, atol=G_ATOL, kink=kink)
    assert_close("softplus step d", s_k[0], s_p[0], atol=D_ATOL)
    assert_rows_close("softplus step q", s_k[1], s_p[1], s_64[1], rtol=PROJ_RTOL, atol=PROJ_ATOL,
                      kink=kink)


@pytest.mark.card
def test_split_projection_equals_unsplit(card, monkeypatch):
    """A 20-step fused projection of 10,000 poses, split and unsplit: the
    same poses and history to the bit (the split's scratch and its two pose
    buffers across launches)."""
    w = _field("lrelu", False)
    q = torch.nn.functional.normalize(
        torch.rand((10000, 21, 4), generator=torch.Generator().manual_seed(5)), dim=-1).to(card)
    got = fused_grad.fused_project(q, w, steps=20, step_scale=100.0)
    want = _unsplit(monkeypatch, lambda: fused_grad.fused_project(q, w, steps=20, step_scale=100.0))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
