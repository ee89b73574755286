"""The plain reference against the program's plain CPU path, at a tiny size.

Both are given the benchmark's weights and inputs; the reference runs in
float64, the program in fp32 on the CPU (its kernels' plain versions)."""

import pytest
import torch

from benchmark import compare, inputs, manifest
from benchmark.program import build_module
from benchmark.reference import posendf_ref

BENCH = manifest.load()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _setup(name, seed=3, batch=16):
    cfg = manifest.config(BENCH, name)
    spec = inputs.model_spec(cfg)
    gen = torch.Generator().manual_seed(seed)
    w = inputs.make_weights(spec, gen)
    module = build_module(cfg, spec, w, torch.device("cpu"))
    model = dict(parents=spec["parents"], activation=spec["activation"], beta=spec["beta"])
    return cfg, spec, w, module, model, inputs.random_poses(gen, (batch, 21))


@pytest.mark.parametrize("name", CONFIGS)
def test_distance_and_pose_gradient(name):
    from posendf_torch.field import distance_and_grad

    _, _, w, module, model, q = _setup(name)
    d, g = distance_and_grad(module, q)
    rd, rg = posendf_ref.distance_and_grad(posendf_ref.cast(w, torch.float64), q.double(), **model)
    assert torch.allclose(d[:, 0].double(), rd, rtol=1e-5, atol=1e-7)
    assert torch.allclose(g.double(), rg, rtol=1e-4, atol=1e-8)
    assert torch.count_nonzero(rd) > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_fused_projection_plain_path(name):
    from posendf_torch import make_field
    from posendf_torch.projection import project

    _, _, w, module, model, q = _setup(name)
    got_q, got_h = project(make_field(module), q, steps=6, fused=True)
    ref_q, ref_h = posendf_ref.project(posendf_ref.cast(w, torch.float64), q.double(), steps=6,
                                       **model)
    assert torch.allclose(got_h.double(), ref_h, rtol=1e-5, atol=1e-7)
    assert torch.allclose(got_q.double(), ref_q, atol=1e-6)
    assert (ref_q - q.double()).abs().max() > 1e-6      # the poses move


@pytest.mark.parametrize("name", CONFIGS)
def test_step_gap_reads_an_error_of_the_step(name):
    """A gradient off by a thousandth reads as a thousandth of the
    displacement in ``step_gap``, at the projection mix's step scale."""
    _, _, w, _, model, q = _setup(name, batch=8)
    w64, q64 = posendf_ref.cast(w, torch.float64), q.double()
    kw = dict(steps=20, step_scale=100.0, **model)
    ref_q, ref_h = posendf_ref.project(w64, q64, **kw)
    assert compare.projection(ref_q, ref_h, ref_q, ref_h, q64)["step_gap"] == 0.0
    kw["step_scale"] *= 1.001
    off_q, off_h = posendf_ref.project(w64, q64, **kw)
    gap = compare.projection(off_q, off_h, ref_q, ref_h, q64)["step_gap"]
    assert 0.5e-3 < gap < 2e-3


def test_training_loss_and_gradient():
    from posendf_torch.losses import training_loss

    _, _, w, module, model, _ = _setup("posendf-amass-lrelu")
    b = inputs.training_pool(torch.Generator().manual_seed(4), 1, 24, 20, 21, [0.05, 0.25])[0]
    loss = dict(loss_type="l1", weight_dist=1.0, weight_man=1.0, weight_eikonal=1.0)
    total, _ = training_loss(module, b["pose"], b["dist"], b["man_poses"], **loss)
    total.backward()
    opt = posendf_ref.Adam(posendf_ref.cast(w, torch.float64), lr=1e-5, weight_decay=1e-4,
                           loss=loss, model=model)
    ref_total, ref_grads = opt.grad({k: v.double() for k, v in b.items()})
    assert float(total.detach()) == pytest.approx(float(ref_total), rel=1e-6)
    for n, p in module.named_parameters():
        g = ref_grads[n]
        assert torch.allclose(p.grad.double(), g, rtol=1e-3, atol=1e-5 * g.abs().max()), n


def test_adam_is_the_programs():
    from posendf_torch.training.trainer import make_optimizer

    _, spec, w, module, model, _ = _setup("posendf-amass-lrelu")
    opt = make_optimizer(module.parameters(), 1e-3, 1e-4)
    ref = posendf_ref.Adam(posendf_ref.cast(w, torch.float64), lr=1e-3, weight_decay=1e-4,
                           loss={}, model=model)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=gen) for n, p in module.named_parameters()}
        for n, p in module.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        ref.update({n: g.double() for n, g in grads.items()})
    for n, p in module.named_parameters():
        assert torch.allclose(p.detach().double(), ref.p[n], atol=1e-7), n
