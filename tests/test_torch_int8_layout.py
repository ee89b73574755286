"""The weight layout of the port's wgmma kernels, read back on the CPU.

``posendf_forward_int8``, ``probe_bf16_chain`` and ``probe_int8_chain``
(``posendf_torch/csrc/int8_kernels.cu``) read their weights transposed, as
wgmma's K-major B, in slabs of the 128-byte swizzle; one slab is one
contiguous bulk copy. The wrappers lay them out with
``fused_int8.sw128_kmajor_offsets``. Here a reader written from the
documented formula (the one the kernels' descriptors encode,
``csrc/hopper.cuh``) takes every element back out of the packed buffers and
must give the weights exactly: every int8 layer of the trained checkpoint
(256x512, 512x1024, 1024x512, 512x256) and of a small config, and the
probe's bf16 and int8 weights.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import posendf_torch  # noqa: E402
from posendf_torch.field import Field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.ops import fused_int8, int8_probe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")


def read(buf: np.ndarray, K: int, N: int, nc: int, k, n):
    """Element (k, n) of a (K, N) matrix packed at the start of ``buf``
    (bytes as a 1-D array of the element type): N in chunks of nc output
    channels, each chunk's K in 128-byte blocks, slab (chunk, block) after
    slab; inside a slab row r = n % nc, byte b of its 128, at (r // 8) * 1024
    + (r % 8) * 128 + ((b // 16) xor (r % 8)) * 16 + b % 16."""
    eb = buf.dtype.itemsize
    e = 128 // eb
    c, r = n // nc, n % nc
    kb, b = k // e, (k % e) * eb
    slab = (c * (K // e) + kb) * nc * 128
    inside = (r // 8) * 1024 + (r % 8) * 128 + (((b // 16) ^ (r % 8)) * 16) + b % 16
    return buf[(slab + inside) // eb]


def _poses(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


def _field(which):
    if which == "checkpoint":
        return posendf_torch.load_field(L8, device="cpu")
    torch.manual_seed(0)
    return Field(PoseNDF(dfnet_dims=(128, 256, 128), live_head=True))


@pytest.mark.parametrize("which,shapes", [
    ("checkpoint", [(256, 512), (512, 1024), (1024, 512), (512, 256)]),
    ("small", [(128, 256), (256, 128)]),
])
def test_int8_layers_read_back(which, shapes):
    f = _field(which)
    q8 = f.quantize_int8(_poses(3, 256))
    pk = fused_int8._pack(q8.qparams, f.module.parents)
    qw = pk.qw.numpy()
    meta = pk.meta.numpy()
    got = []
    for l, lyr in enumerate(q8.qparams["layers"]):
        if "wq" not in lyr:
            assert meta[l, 2] == 0
            continue
        K, N, kind, off, *_, nc = meta[l].tolist()
        assert kind == 1 and off % 1024 == 0, "int8 layer offsets are 1024-byte aligned"
        assert nc == (256 if N % 256 == 0 else 128)
        k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        np.testing.assert_array_equal(read(qw[off:], K, N, nc, k, n), lyr["wq"].numpy())
        got.append((K, N))
    assert got == shapes
    assert qw.size == sum(K * N for K, N in shapes)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_probe_weights_read_back(dtype):
    """The probe chains' weights: bf16 in slabs of 256 output channels x 64
    of K, int8 in slabs of 128 x 128 of K; each layer's slabs at l x its
    512 x 512 elements."""
    g = torch.Generator().manual_seed(0)
    if dtype == "bf16":
        w = (torch.randn(3, 512, 512, generator=g) * 0.05).bfloat16()
        packed, nc = int8_probe.pack_bf16(w).view(torch.int16).numpy(), 256
        want = w.view(torch.int16).numpy()
    else:
        w = torch.randint(-127, 128, (3, 512, 512), generator=g, dtype=torch.int8)
        packed, nc = int8_probe.pack_int8(w).numpy(), int8_probe.INT8_SLAB
        want = w.numpy()
    k, n = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    for l in range(3):
        assert packed[l].nbytes == 512 * 512 * w.element_size()
        np.testing.assert_array_equal(read(packed[l], 512, 512, nc, k, n), want[l])


@pytest.mark.parametrize("K,N,nc,eb", [(128, 128, 128, 1), (256, 512, 256, 1),
                                       (1024, 512, 256, 1), (512, 512, 512, 2), (64, 16, 8, 2)])
def test_offsets_are_a_permutation_of_whole_slabs(K, N, nc, eb):
    """Every element has its own place, and each slab (nc rows x 128 bytes)
    fills one contiguous run of bytes, in slab order."""
    off = fused_int8.sw128_kmajor_offsets(K, N, nc, eb).numpy() * eb
    assert np.array_equal(np.sort(off.ravel()), np.arange(0, K * N * eb, eb))
    e = 128 // eb
    for c in range(N // nc):
        for kb in range(K // e):
            block = off[kb * e:(kb + 1) * e, c * nc:(c + 1) * nc]
            start = (c * (K // e) + kb) * nc * 128
            assert block.min() == start and block.max() == start + nc * 128 - eb


def test_pack_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="slabs"):
        fused_int8.sw128_kmajor_offsets(100, 128, 128, 1)
    f = _field("small")
    q8 = f.quantize_int8(_poses(4, 64))
    layers = list(q8.qparams["layers"])
    layers[0] = {"wq": torch.zeros(layers[0]["w"].shape, dtype=torch.int8),
                 "dq": torch.ones(1, layers[0]["w"].shape[1]), "b": layers[0]["b"],
                 "inv_sa": torch.ones(1, layers[0]["w"].shape[0])}
    with pytest.raises(ValueError, match="first layer"):
        fused_int8._pack(dict(q8.qparams, layers=layers), f.module.parents)
