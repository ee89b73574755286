"""The frozen operation counts against the published widths and an independent count."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import costs, inputs, manifest
from benchmark.reference import posendf_ref

BENCH = manifest.load()
SPEC = inputs.model_spec(manifest.config(BENCH, "posendf-amass-lrelu"))


def test_published_multiply_adds():
    assert costs.encoder_macs(21, 6) == 3_360
    assert costs.dfnet_macs(SPEC["widths"]) == 1_359_424
    assert costs.pose_macs(SPEC) == 1_362_784
    assert costs.forward_flops(SPEC, 1) == 2_725_568
    assert costs.project_step_flops(SPEC, 1) == 5_451_136


def test_param_count_is_the_models():
    w = inputs.make_weights(SPEC, torch.Generator().manual_seed(0))
    assert costs.param_count(SPEC) == sum(t.numel() for t in w.values())


def test_train_step_count_as_derived():
    P, D = costs.pose_macs(SPEC), costs.dfnet_macs(SPEC["widths"])
    n, m = 20_000, 20_000
    assert costs.train_step_flops(SPEC, n, m) == 2 * P * (4 * n + 3 * m)
    assert costs.train_step_flops(SPEC, n, m) == pytest.approx(381.58e9, rel=1e-4)
    assert costs.train_reduce_flops(SPEC, n, m) == 2 * D * (n + m)
    assert (costs.train_tile_flops(SPEC, n, m) + costs.train_reduce_flops(SPEC, n, m)
            == costs.train_step_flops(SPEC, n, m))


def _matmul_flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _tiny():
    gen = torch.Generator().manual_seed(1)
    w = inputs.make_weights(SPEC, gen)
    model = dict(parents=SPEC["parents"], activation="lrelu", beta=100.0)
    return w, model, inputs.random_poses(gen, (8, 21))


def test_forward_and_projection_step_counts_are_the_products_autograd_runs():
    w, model, q = _tiny()
    w = {k: v.detach() for k, v in w.items()}
    assert _matmul_flops(lambda: posendf_ref.forward(w, q, **model)) == costs.forward_flops(SPEC, 8)
    assert (_matmul_flops(lambda: posendf_ref.distance_and_grad(w, q, **model))
            == costs.project_step_flops(SPEC, 8))


def test_train_step_count_is_at_most_what_autodiff_runs():
    """The count is the least the mathematics needs: autodiff of the
    published objective runs at least as many products."""
    w, model, _ = _tiny()
    pool = inputs.training_pool(torch.Generator().manual_seed(2), 1, 8, 8, 21, [0.1])
    loss = dict(loss_type="l1", weight_dist=1.0, weight_man=1.0, weight_eikonal=1.0)
    opt = posendf_ref.Adam(w, lr=1e-5, weight_decay=1e-4, loss=loss, model=model)
    assert costs.train_step_flops(SPEC, 8, 8) <= _matmul_flops(lambda: opt.grad(pool[0]))


def test_rooflines_are_bounded_by_operations_or_bytes():
    rows = 10_000
    t = costs.least_seconds(costs.project_step_flops(SPEC, rows), costs.project_step_bytes(SPEC, rows))
    assert t == pytest.approx(5_451_136 * rows / 494.7e12)
    n = m = 20_000
    t = costs.least_seconds(costs.train_reduce_flops(SPEC, n, m), costs.train_reduce_bytes(SPEC, n, m))
    assert t == pytest.approx(2 * 1_359_424 * (n + m) / 494.7e12)
    # the model's bytes alone: the reduction writes the gradient, whatever the tile hands it
    assert costs.train_reduce_bytes(SPEC, n, m) == costs.train_reduce_bytes(SPEC, 1, 1)


def test_softplus_training_is_not_counted():
    spec = inputs.model_spec(manifest.config(BENCH, "posendf-amass-softplus"))
    with pytest.raises(ValueError):
        costs.train_step_flops(spec, 1, 1)
