"""The probe chains' plain versions (``posendf_torch/ops/int8_probe.py``)
against the Pallas kernels of ``scripts/int8_probe.py`` in TPU interpret
mode, on the same numpy-drawn inputs at B = 256 (the script is imported by
path and its module constants B and TILE set with monkeypatch, which edits
no file).

Bars: the int8 chain bitwise (every product and sum is an exact integer in
fp32 and s = 1/64 is a power of two). bf16: after one layer every element
within one bf16 spacing of JAX's plus both fp32 sums' worst-case rounding,
2 K 2^-24 sum_k |x_k w_k| (``int8_probe.bf16_layer_excess``): both sum the
same exact products in fp32, in another order, then round to nearest even,
and where a sum cancels its rounding is relative to the terms, not to the
small result (measured: 0.011% of elements differ, up to 0.89 of the bar).
Over 8 layers such differences are fed forward and grow; the share of
elements more than one spacing apart is held under 4% (measured 2.53% on
these inputs and 2.61% on the expected file's).
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_torch.ops import int8_probe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_int8_expected.npz")
B, TILE, LAYERS = 256, 128, 8
BEYOND_ULP_SHARE = 0.04


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return _load("make_torch_port_int8_golden").probe_chain_inputs(seed=21, rows=B, layers=LAYERS)


@pytest.fixture
def script(monkeypatch):
    mod = _load("int8_probe")
    monkeypatch.setattr(mod, "B", B)
    monkeypatch.setattr(mod, "TILE", TILE)
    return mod


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _bf16_jax(script, xb, wb, layers, monkeypatch):
    monkeypatch.setattr(script, "LAYERS", layers)
    with pltpu.force_tpu_interpret_mode():
        out = script.run_bf16(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wb[:layers], jnp.bfloat16))
    return _bf16(np.asarray(out).view(np.uint16))


@pytest.mark.parametrize("layers", [1, LAYERS])
def test_bf16_chain_matches_jax(layers, inputs, script, monkeypatch):
    xb, wb = inputs[:2]
    want = _bf16_jax(script, xb, wb, layers, monkeypatch)
    got = int8_probe.run_bf16(torch.from_numpy(xb).bfloat16(), torch.from_numpy(wb).bfloat16(),
                              layers)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 512)
    ulps = int8_probe.bf16_ulps(got, want)
    share = float((ulps > 1.0).float().mean())
    print(f"{layers} layers: {float((ulps > 0).float().mean()):.4%} of elements differ, "
          f"{share:.4%} by more than one spacing")
    if layers == 1:
        excess = int8_probe.bf16_layer_excess(got, want, torch.from_numpy(xb).bfloat16(),
                                              torch.from_numpy(wb[0]).bfloat16())
        print(f"  largest difference {float(excess.max()):.3f} of its bar")
        assert float(excess.max()) <= 1.0
    else:
        assert share < BEYOND_ULP_SHARE


@pytest.mark.parametrize("layers", [1, LAYERS])
def test_int8_chain_matches_jax_bitwise(layers, inputs, script, monkeypatch):
    _, _, xi, wi, si = inputs
    monkeypatch.setattr(script, "LAYERS", layers)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script.run_int8(jnp.asarray(xi), jnp.asarray(wi[:layers]),
                                          jnp.asarray(si[:, :layers])))
    got = int8_probe.run_int8(torch.from_numpy(xi), torch.from_numpy(wi), torch.from_numpy(si),
                              layers)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_chains_match_the_expected_file():
    """The JAX outputs ``chip_smoke.py`` holds the kernels to, on their own
    seed: int8 bitwise, bf16 under the 8-layer bar."""
    z = np.load(EXPECTED)
    rows, layers = int(z["probe_b"]), int(z["probe_layers"])
    xb, wb, xi, wi, si = _load("make_torch_port_int8_golden").probe_chain_inputs(
        seed=int(z["probe_seed"]), rows=rows, layers=layers)
    got = int8_probe.run_int8(torch.from_numpy(xi), torch.from_numpy(wi), torch.from_numpy(si))
    np.testing.assert_array_equal(got.numpy(), z["int8_out"].astype(np.float32))
    got = int8_probe.run_bf16(torch.from_numpy(xb).bfloat16(), torch.from_numpy(wb).bfloat16())
    share = float((int8_probe.bf16_ulps(got, _bf16(z["bf16_out"])) > 1.0).float().mean())
    print(f"8 layers: {share:.4%} of elements more than one spacing apart")
    assert share < BEYOND_ULP_SHARE


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 512), dtype=torch.bfloat16)
    w = torch.zeros((2, 512, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="layers"):
        int8_probe.run_bf16(x, w, 3)
    with pytest.raises(TypeError, match="int8"):
        int8_probe.run_int8(x, w, torch.ones(1, 2), 1)
    with pytest.raises(ValueError, match="512"):
        int8_probe.run_bf16(x[:, :256], w, 1)
    assert int8_probe.run_bf16(x, w, 2).shape == (4, 512)
