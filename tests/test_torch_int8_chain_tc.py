"""``probe_int8_chain`` on s8 wgmma (``posendf_torch/csrc/int8_kernels.cu``),
its layout and its arithmetic modelled on the CPU.

The kernel runs only on the card, so this file holds what it reads and what
it does to a numpy model written from the kernel's own formulas:

  * ``int8_probe.pack_int8`` (slabs of 128 output channels x 128 bytes of K,
    ``fused_int8.sw128_kmajor_offsets`` with nc = 128) is read back by
    ``tests/test_torch_int8_layout.py::test_probe_weights_read_back``; here
    its cache (``fused_model.packed_once``) packs anew after an in-place
    change of w.
  * :func:`model_chain` runs the kernel's program slab by slab: the x tile
    of a CTA (kQRows rows, zeros past B) in the 128-byte swizzle; per layer
    and quarter of the outputs the s32 sums of its four slabs (A read
    through the swizzle, B from the packed slabs), requantized from the
    accumulator fragment of each consumer warpgroup (register 4 q + e of
    thread t: row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 q +
    2 (t % 4) + e % 2) as ``probe_convert`` does (the int32 sum to fp32, one
    rounded product by s_l, rint half to even, clamps), four int8 packed
    into a word and held; after the layer's last product the four quarters
    stored as two 16-bit halves into K blocks 0-3 of the tile, which the
    next layer reads as A; the last layer's values as fp32 rows, rows past
    B never written. The fragment formula itself is
    the one every wgmma kernel of the port reads its sums by
    (``csrc/hopper.cuh``); what this holds is the program around it.
Over 1 and 8 layers and rows that cut the CTAs the model equals
``run_int8_ref`` and JAX's Pallas ``_int8_kernel`` (``scripts/int8_probe.py``
in TPU interpret mode) bitwise: every sum is an exact integer, and the three
take the same fp32 product and rounding.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_torch.ops import int8_probe  # noqa: E402
from posendf_torch.ops.fused_model import packed_once  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "posendf_torch", "csrc", "int8_kernels.cu")
W = 512
NC = int8_probe.INT8_SLAB


def _constant(name: str) -> int:
    """A ``constexpr int`` of the kernel source given as a literal."""
    for line in open(SRC):
        if line.startswith(f"constexpr int {name} = "):
            return int(line.split("=")[1].split(";")[0])
    raise AssertionError(f"{name} not found in {SRC}")


CW = _constant("kQCW")      # consumer warpgroups a CTA
ROWS = 64 * CW


def sw128(r, b):
    return (r // 8) * 1024 + (r % 8) * 128 + (((b // 16) ^ (r % 8)) * 16) + b % 16


def _fragment():
    """(row, column) of every accumulator register of a CTA's consumers, for
    one quarter: arrays of shape (CW, 128, 64), register 4 q + e of thread t
    of warpgroup wg."""
    wg, t, i = np.meshgrid(np.arange(CW), np.arange(128), np.arange(64), indexing="ij")
    q, e = i // 4, i % 4
    row = 64 * wg + 16 * (t // 32) + (t % 32) // 4 + 8 * (e // 2)
    col = 8 * q + 2 * (t % 4) + e % 2
    return row, col


ROW, COL = _fragment()


def probe_convert(acc: np.ndarray, s: np.float32) -> np.ndarray:
    v = np.rint(acc.astype(np.float32) * np.float32(s))
    return np.clip(v, -127, 127).astype(np.int8)


def quant_words(acc: np.ndarray, s, qs) -> np.ndarray:
    """quant4 of register groups qs of every thread: (CW, 128, len(qs))
    words, byte e of group q from register 4 q + e."""
    regs = acc[ROW, COL]                                   # (CW, 128, 64)
    qv = probe_convert(regs, s).view(np.uint8).astype(np.uint32)
    return sum(qv[..., [4 * q + e for q in qs]] << (8 * e) for e in range(4))


def store_words(xs: np.ndarray, blk: int, words: np.ndarray, qs) -> None:
    """store_word: the low half to row, the high half to row + 8, bytes c
    and c + 1 (c = 8 q + 2 (t % 4)) of K block blk."""
    block = ROWS * 128
    for j, q in enumerate(qs):
        r, c = ROW[..., 4 * q], COL[..., 4 * q]
        for half, rr in ((words[..., j] & 0xFFFF, r), (words[..., j] >> 16, r + 8)):
            dst = blk * block + sw128(rr, c)
            xs[dst] = (half & 0xFF).astype(np.uint8)
            xs[dst + 1] = (half >> 8).astype(np.uint8)


def store_rows(out: np.ndarray, acc: np.ndarray, s, part: int, qs, row0: int) -> None:
    """store_rows: the last layer's values as fp32, rows past B not written."""
    qv = probe_convert(acc[ROW, COL], s).astype(np.float32)
    for q in qs:
        for e in range(4):
            r, c = ROW[..., 4 * q + e] + row0, COL[..., 4 * q + e] + NC * part
            keep = r < out.shape[0]
            out[r[keep], c[keep]] = qv[..., 4 * q + e][keep]


def model_chain(x: np.ndarray, wp: np.ndarray, s: np.ndarray, layers: int) -> np.ndarray:
    """The kernel's program on numpy, slab by slab in its order: x (B, 512)
    int8, wp the packed weights (layers, 256 KB) int8, s (layers,) fp32 ->
    (B, 512) fp32, NaN where the kernel writes nothing. Every warpgroup
    runs the same program on its own 64 rows (their turns at the tensor
    cores order nothing between them), so the model runs all rows at once;
    a slab's products may read their A until the quarter's last wait, and
    every store is checked to come after the last product that reads the
    bytes it overwrites."""
    B = x.shape[0]
    out = np.full((B, W), np.nan, np.float32)
    block = ROWS * 128                        # one K block of the x tile
    m, k = np.meshgrid(np.arange(ROWS), np.arange(128), indexing="ij")
    a_idx = sw128(m, k)                       # A (rows, 128 of K) of a K block
    n, kk = np.meshgrid(np.arange(NC), np.arange(128), indexing="ij")
    b_idx = sw128(n, kk)                      # B (128 channels, 128 of K) of a slab
    slabs = wp.reshape(layers, -1)
    for row0 in range(0, B, ROWS):
        xs = np.zeros(4 * block, np.uint8)
        rows = min(ROWS, B - row0)
        for ch in range(W // 16):             # row m's 16-byte chunk ch
            dst = (ch // 8) * block + sw128(np.arange(ROWS)[:, None], (ch % 8) * 16 + np.arange(16))
            src = np.zeros((ROWS, 16), np.int8)
            src[:rows] = x[row0:row0 + rows, 16 * ch:16 * ch + 16]
            xs[dst] = src.view(np.uint8)
        for l in range(layers):
            last = l == layers - 1
            held = []
            reads = []                         # (K block, bytes) each product of the layer read
            for p in range(4):
                acc = np.zeros((ROWS, NC), np.int64)
                for kb in range(4):
                    a_bytes = xs[kb * block + a_idx].copy()
                    reads.append((kb, a_bytes))
                    b = slabs[l, (4 * p + kb) * NC * 128 + b_idx].view(np.int8).astype(np.int64)
                    acc += a_bytes.view(np.int8).astype(np.int64) @ b.T
                if last:
                    store_rows(out, acc, s[l], p, range(16), row0)
                else:
                    held.append(quant_words(acc, s[l], range(16)))
            if last:
                break
            for kb, a_bytes in reads:          # the layer's products are all done
                assert np.array_equal(xs[kb * block + a_idx], a_bytes)
            for p, words in enumerate(held):   # quarter p is K block p of the next A
                store_words(xs, p, words, range(16))
    return out


def _inputs(seed: int, rows: int, layers: int):
    """x and w uniform in [-127, 127]; scales that keep most levels inside
    the clamp (one not a power of two), so the rounding is exercised."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=(rows, W)).astype(np.int8)
    w = rng.integers(-127, 128, size=(layers, W, W)).astype(np.int8)
    s = np.array([2.0 ** -11, 3e-4, 2.0 ** -10, 4.4e-4] * 2, np.float32)[None, :layers]
    return x, w, s


def _script(monkeypatch, rows, tile, layers):
    spec = importlib.util.spec_from_file_location("int8_probe_script",
                                                  os.path.join(ROOT, "scripts", "int8_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "B", rows)
    monkeypatch.setattr(mod, "TILE", tile)
    monkeypatch.setattr(mod, "LAYERS", layers)
    return mod


@pytest.mark.parametrize("layers", [1, 8])
def test_model_of_the_kernel_equals_plain_and_jax_bitwise(layers, monkeypatch):
    rows = 256                                 # 192 + 64: the second CTA cut
    x, w, s = _inputs(7 + layers, rows, layers)
    wp = int8_probe.pack_int8(torch.from_numpy(w)).numpy()
    got = model_chain(x, wp, s[0], layers)
    plain = int8_probe.run_int8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
                                layers).numpy()
    script = _script(monkeypatch, rows, 128, layers)
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.asarray(script.run_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    inside = (np.abs(plain) < 127).mean()
    print(f"{layers} layer(s): {inside:.2%} of the outputs inside the clamp, std {plain.std():.1f}")
    assert inside > 0.5 and plain.std() > 10     # levels spread, not all clamped
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("rows", [1, ROWS - 1, ROWS + 1])
def test_model_at_rows_that_cut_the_ctas(rows):
    x, w, s = _inputs(30 + rows, rows, 2)
    wp = int8_probe.pack_int8(torch.from_numpy(w)).numpy()
    got = model_chain(x, wp, s[0], 2)
    want = int8_probe.run_int8_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s), 2)
    np.testing.assert_array_equal(got, want.numpy())


def test_packing_is_cached_and_follows_in_place_changes():
    """``run_int8`` packs w through ``fused_model.packed_once``: once per
    tensor, anew after an in-place change."""
    w = torch.from_numpy(_inputs(3, 1, 2)[1])

    def packed():
        return packed_once(int8_probe._PACKED, (w,), int8_probe.pack_int8)

    first = packed()
    assert packed() is first
    w[1, 5, 9] = -w[1, 5, 9] if w[1, 5, 9] != 0 else 1
    again = packed()
    assert again is not first
    assert torch.equal(again, int8_probe.pack_int8(w))
    assert not torch.equal(again, first)


def test_the_kernel_is_the_only_int8_chain():
    """``probe_int8_chain`` is the s8 wgmma kernel: no wmma left in the
    source."""
    text = open(SRC).read()
    assert "wmma::" not in text and "<mma.h>" not in text
    assert "wgmma_m64n128k32_s8" in text
