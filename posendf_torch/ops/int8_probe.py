"""Probe: does an int8 tensor-core product chain beat bf16 on this card?

Counterpart of ``scripts/int8_probe.py``, whose two Pallas kernels become
``probe_bf16_chain`` and ``probe_int8_chain`` in ``csrc/int8_kernels.cu``.
Both run ``layers`` products of a (rows, 512) activation tile with 512 x 512
weights, at DFNet-like widths, the tile kept on chip across the layers, on
the same route to the tensor cores: Hopper's ``wgmma`` fed by a
``cp.async.bulk`` ring of weight slabs, so their speed ratio is the card's
int8 / bf16 answer for this chain.

  * bf16: x @ w_l with fp32 sums, rounded back to bf16 (the activation
    boundary);
  * int8: x @ w_l in int32, times s_l, rounded half to even, clipped to
    +-127, back to int8 (the requantization an int8 serving path pays);
    the output is the last layer's int8 values as fp32.

:func:`run_bf16` / :func:`run_int8` launch the kernels for CUDA tensors and
run their plain versions (:func:`run_bf16_ref`, :func:`run_int8_ref`) for
CPU tensors; ``LAUNCHES`` counts the kernel launches by name. The int8
chain's int32 sums are exact and kernel and plain version take the same
fp32 product and rounding, so they agree to the bit for any s.

Run on the card::

    python -m posendf_torch.ops.int8_probe

prints one line for each chain at (131,072, 512) x 8 layers: the time
(the median of CUDA-event means over several rounds, after warm-up), the
rate and its share of the card's dense tensor-core peak, 989 TFLOP/s bf16
and 1,979 TOP/s int8 (an H100 SXM's data sheet), and the int8/bf16 speed
ratio.

Both kernels read their weights transposed in the wgmma layout
(``fused_int8.pack_sw128``: :func:`pack_bf16` in slabs of 256 output
channels, :func:`pack_int8` in slabs of 128); :func:`run_bf16` and
:func:`run_int8` pack them once per tensor and keep the last few packings
(rebuilt if the tensor changed in place).
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict

import torch

from posendf_torch import _build
from posendf_torch.ops.fused_int8 import pack_sw128
from posendf_torch.ops.fused_model import packed_once

__all__ = ["run_bf16", "run_int8", "run_bf16_ref", "run_int8_ref", "pack_bf16", "pack_int8",
           "bf16_ulps",
           "bf16_layer_excess", "LAUNCHES", "B", "W", "LAYERS", "PEAK_BF16", "PEAK_INT8"]

B = 131_072
W = 512
LAYERS = 8
PEAK_BF16 = 989e12     # H100 SXM, dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12    # H100 SXM, dense int8 tensor-core OP/s

# launches of each kernel since its count was last set to 0
LAUNCHES: Dict[str, int] = {"bf16": 0, "int8": 0}
INT8_SLAB = 128        # output channels a slab of the int8 kernel's weights

_PACKED: Dict[tuple, tuple] = {}   # the last few packings of w (fused_model.packed_once)


def run_bf16_ref(x: torch.Tensor, w: torch.Tensor, layers: int = LAYERS) -> torch.Tensor:
    """Plain version of ``probe_bf16_chain``: bf16 products are exact in
    fp32, summed in fp32, rounded to bf16 after each layer."""
    for l in range(layers):
        x = torch.matmul(x.float(), w[l].float()).to(torch.bfloat16)
    return x


def run_int8_ref(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                 layers: int = LAYERS) -> torch.Tensor:
    """Plain version of ``probe_int8_chain``; the fp32 product of int8
    values is exact (|sum| <= 512 x 127^2 < 2^24)."""
    s = s.reshape(-1)
    for l in range(layers):
        f = torch.matmul(x.float(), w[l].float()) * s[l]
        x = torch.clamp(torch.round(f), -127.0, 127.0).to(torch.int8)
    return x.float()


def _check(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, layers: int) -> None:
    if x.dim() != 2 or x.shape[1] != W or w.dim() != 3 or w.shape[1:] != (W, W):
        raise ValueError(f"x must be (rows, {W}) and w (layers, {W}, {W}); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"x and w must be {dtype}, got {x.dtype} and {w.dtype}")
    if not 1 <= layers <= w.shape[0]:
        raise ValueError(f"layers must be 1..{w.shape[0]}, got {layers}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x on {x.device}, w on {w.device}: one CPU or CUDA device")
    if x.device.type == "cuda" and not (x.is_contiguous() and w.is_contiguous()
                                        and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        raise ValueError("the CUDA kernels take contiguous, 16-byte aligned x and w")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pack_bf16(w: torch.Tensor) -> torch.Tensor:
    """w (layers, 512, 512) -> each layer's w^T in the wgmma layout: slabs of
    256 output channels x 64 of K, channels 0-255 K block by K block, then
    256-511 (``sw128_kmajor_offsets`` with nc = 256), the layers in order."""
    return torch.stack([pack_sw128(wl, 256) for wl in w])


def pack_int8(w: torch.Tensor) -> torch.Tensor:
    """w (layers, 512, 512) int8 -> each layer's w^T in the wgmma layout:
    slabs of 128 output channels x 128 of K (16 KB), a quarter of the
    channels K block by K block, then the next quarter
    (``sw128_kmajor_offsets`` with nc = 128), the layers in order."""
    return torch.stack([pack_sw128(wl, INT8_SLAB) for wl in w])


def run_bf16(x: torch.Tensor, w: torch.Tensor, layers: int = LAYERS) -> torch.Tensor:
    """The bf16 chain: x (rows, 512) bf16, w (>= layers, 512, 512) bf16 ->
    (rows, 512) bf16."""
    _check(x, w, torch.bfloat16, layers)
    if x.device.type == "cpu":
        return run_bf16_ref(x, w, layers)
    wp = packed_once(_PACKED, (w,), pack_bf16)
    out = torch.empty_like(x)
    _build.check(_build.library("int8").probe_bf16_chain(
        x.data_ptr(), wp.data_ptr(), x.shape[0], layers, out.data_ptr(), _stream(x)),
        "probe_bf16_chain", "int8")
    LAUNCHES["bf16"] += 1
    return out


def run_int8(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
             layers: int = LAYERS) -> torch.Tensor:
    """The int8 chain: x (rows, 512) int8, w (>= layers, 512, 512) int8,
    s (1, >= layers) fp32 -> (rows, 512) fp32."""
    _check(x, w, torch.int8, layers)
    if s.dtype != torch.float32 or s.numel() < layers or s.device != x.device:
        raise ValueError("s must be float32 with a scale per layer, on x's device")
    if x.device.type == "cpu":
        return run_int8_ref(x, w, s, layers)
    s = s.reshape(-1).contiguous()
    wp = packed_once(_PACKED, (w,), pack_int8)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.check(_build.library("int8").probe_int8_chain(
        x.data_ptr(), wp.data_ptr(), s.data_ptr(), x.shape[0], layers, out.data_ptr(), _stream(x)),
        "probe_int8_chain", "int8")
    LAUNCHES["int8"] += 1
    return out


def _bf16_spacing(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at the larger magnitude of g and v: 2^(e - 7) for a
    value in [2^e, 2^(e+1))."""
    e = torch.floor(torch.log2(torch.clamp_min(torch.maximum(g.abs(), v.abs()), 2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 spacings at the larger magnitude of the two."""
    g, v = got.float(), want.float()
    return (g - v).abs() / _bf16_spacing(g, v)


def bf16_layer_excess(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """|got - want| of two bf16 roundings of one layer's product x @ w (fp32
    sums of the same exact products, in two orders) over its bar: one bf16
    spacing at the larger value plus both sums' worst-case rounding,
    2 K 2^-24 sum_k |x_k w_k|. Where the sum cancels, that rounding is
    relative to the terms and not to the small result, so a pure ulp count
    is no bar there. Every element must come out <= 1."""
    g, v = got.float(), want.float()
    absum = torch.matmul(x.float().abs(), w.float().abs())
    return (g - v).abs() / (_bf16_spacing(g, v) + 2 * x.shape[-1] * 2.0 ** -24 * absum)


def cuda_ms(fn: Callable[[], object], reps: int = 10, rounds: int = 5) -> tuple:
    """(median, min, max) over ``rounds`` of the mean milliseconds of ``reps``
    calls, timed with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), min(times), max(times)


def probe_inputs(rows: int = B, layers: int = LAYERS, device="cuda", seed: int = 0):
    """The probe's operands, as ``scripts/int8_probe.py`` draws them (x
    normal, w normal x 0.05; int8 values uniform in [-127, 127], s = 1/64),
    from a torch generator on ``device``: (xb, wb, xi, wi, si)."""
    g = torch.Generator(device=device).manual_seed(seed)
    xb = torch.randn((rows, W), generator=g, device=device).to(torch.bfloat16)
    wb = (torch.randn((layers, W, W), generator=g, device=device) * 0.05).to(torch.bfloat16)
    xi = torch.randint(-127, 128, (rows, W), generator=g, device=device, dtype=torch.int8)
    wi = torch.randint(-127, 128, (layers, W, W), generator=g, device=device, dtype=torch.int8)
    si = torch.full((1, layers), 1.0 / 64.0, device=device)
    return xb, wb, xi, wi, si


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_probe: torch.cuda.is_available() is false; the probe needs a card")
    xb, wb, xi, wi, si = probe_inputs()
    flops = 2.0 * B * W * W * LAYERS
    t, lo, hi = cuda_ms(lambda: run_bf16(xb, wb))
    print(f"bf16 (wgmma): {t:.4f} ms/iter [{lo:.4f}-{hi:.4f}], "
          f"{flops / t / 1e9:.1f} TFLOP/s ({flops / t * 1e3 / PEAK_BF16 * 100:.1f}% of the bf16 "
          f"dense peak)", flush=True)
    t8, lo, hi = cuda_ms(lambda: run_int8(xi, wi, si))
    print(f"int8 (wgmma): {t8:.4f} ms/iter [{lo:.4f}-{hi:.4f}], "
          f"{flops / t8 / 1e9:.1f} TOP/s ({flops / t8 * 1e3 / PEAK_INT8 * 100:.1f}% of the int8 "
          f"dense peak), speed vs bf16 {t / t8:.2f}x  "
          f"[{torch.cuda.get_device_name(0)}]", flush=True)


if __name__ == "__main__":
    main()
