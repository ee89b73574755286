"""The int8 serving forward: the whole distance field in one CUDA kernel,
with the DFNet's wide layers quantized to int8.

Port of ``posendf_tpu/ops/fused_int8.py``. The kernel is
``posendf_forward_int8`` in ``csrc/int8_kernels.cu`` (it replaces the TPU
kernel ``_int8_kernel``); its plain PyTorch version is
:func:`fused_posendf_forward_int8_ref` (the counterpart of JAX's
``reference_int8_forward``). The scheme is JAX's, static post-training
symmetric quantization:

  * which layers: the longest run of DFNet layers whose widths are
    multiples of 128 and that are not the output layer
    (:func:`int8_window`; layers 1..4 of 126-256-512-1024-512-256-64-1);
  * activations: per-input-channel scales from a calibration batch,
    ``sa[i] = max|x[:, i]| / 127``, folded into the weights
    (``x @ w == (x / sa) @ (sa w)``);
  * weights: per-output-channel symmetric int8 of the folded matrix,
    ``sw[j] = max_i |sa[i] w[i, j]| / 127``;
  * a layer: ``x_q = clip(round(x inv_sa), +-127)`` (round half to even),
    ``x_q @ w_q`` in int32, ``* dq + b``, activation.

The plain version computes the int8 product as an fp32 product of the int8
values: every partial sum is an integer below 2^24 (K * 127^2 < 2^24 for
K <= 1040), so it is exact in any order, even under TF32, whose significand
holds |v| <= 127. ``torch.matmul`` has no integer product on CUDA; that is
why the product goes through floats. Wider layers raise.

:func:`fused_posendf_forward_int8` launches the kernel for a CUDA tensor and
runs the plain version for a CPU tensor. It is forward-only, as in JAX
(``fused_int8.py:274-276``): it raises for poses that require grad, rather
than returning the gradient of a staircase. :func:`qparams_from_numpy`
carries JAX's quantized parameters (as numpy arrays) over to the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from posendf_torch import _build
from posendf_torch.models.activations import make_activation, resolve
from posendf_torch.models.encoder import structure_encoder_apply
from posendf_torch.ops.fused_model import (FieldWeights, aligned_contiguous, field_forward_ref,
                                          int_table, stream_handle)
from posendf_torch.quat import joint_axis_normalize

__all__ = [
    "int8_window", "quant_sym", "sw128_kmajor_offsets", "pack_sw128", "quantize_posendf",
    "qparams_from_numpy", "qparams_to_numpy",
    "int8_layers_ref", "fused_posendf_forward_int8_ref", "fused_posendf_forward_int8",
    "boundary_flips", "hold_to_ref", "LAUNCHES",
]

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

MAX_INT8_K = 1040   # K * 127^2 < 2^24: fp32 sums of the int8 products stay exact
_ROWS = 64          # poses a CTA of the kernel


def sw128_kmajor_offsets(K: int, N: int, nc: int, elem_bytes: int) -> torch.Tensor:
    """Where the kernels keep element (k, n) of a (K, N) weight matrix, in
    elements from the start of the packed matrix: (K, N) int64.

    The matrix is stored transposed (a row per output channel n, K
    contiguous), as wgmma's K-major B, in slabs: N in chunks of ``nc``
    channels, each chunk's K in blocks of 128 bytes (``e = 128 /
    elem_bytes`` elements), slab (c, kb) at ``(c * (K / e) + kb) * nc * 128``
    bytes, the chunks in order and the K blocks in order inside a chunk. A
    slab is nc rows x 128 bytes in the 128-byte swizzle (``hopper.cuh``):
    byte b of row r at ``(r // 8) * 1024 + (r % 8) * 128 + ((b // 16) ^ (r %
    8)) * 16 + b % 16``, with r = n % nc and b = (k % e) * elem_bytes. One
    slab is one ring slot, copied as one run of bytes."""
    e = 128 // elem_bytes
    if K % e or N % nc or nc % 8:
        raise ValueError(f"{K} x {N} does not split into slabs of {nc} x {e}")
    k = torch.arange(K, dtype=torch.int64)[:, None]
    n = torch.arange(N, dtype=torch.int64)[None, :]
    c, r = n // nc, n % nc
    kb, b = k // e, (k % e) * elem_bytes
    byte = ((c * (K // e) + kb) * nc * 128 + (r // 8) * 1024 + (r % 8) * 128
            + (((b // 16) ^ (r % 8)) * 16) + b % 16)
    return byte // elem_bytes


def pack_sw128(w: torch.Tensor, nc: int) -> torch.Tensor:
    """w (K, N) -> its K * N elements at :func:`sw128_kmajor_offsets`, flat,
    on w's device."""
    K, N = w.shape
    idx = sw128_kmajor_offsets(K, N, nc, w.element_size()).to(w.device)
    out = torch.empty(K * N, dtype=w.dtype, device=w.device)
    out[idx.reshape(-1)] = w.reshape(-1)
    return out


def int8_window(dims_in: Sequence[int], dims_out: Sequence[int]) -> Tuple[int, int]:
    """[start, stop) of the longest contiguous run of quantizable layers: in
    and out widths multiples of 128, and not the output layer. (0, 0) when
    none qualifies; the first of equally long runs wins."""
    n = len(dims_in)
    ok = [dims_in[l] % 128 == 0 and dims_out[l] % 128 == 0 and l < n - 1 for l in range(n)]
    best, start = (0, 0), None
    for l in range(n + 1):
        if l < n and ok[l]:
            if start is None:
                start = l
        else:
            if start is not None and (l - start) > (best[1] - best[0]):
                best = (start, l)
            start = None
    return best


def quant_sym(x: torch.Tensor, inv_scale) -> torch.Tensor:
    """Symmetric int8: round half to even, then clip to [-127, 127]."""
    return torch.clamp(torch.round(x * inv_scale), -127.0, 127.0).to(torch.int8)


def _dfnet_layers(dfnet_params: Mapping[str, torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    layers, l = [], 0
    while f"w{l}" in dfnet_params:
        layers.append((dfnet_params[f"w{l}"], dfnet_params[f"b{l}"]))
        l += 1
    return layers


def quantize_posendf(enc_params: Mapping[str, torch.Tensor], dfnet_params: Mapping[str, torch.Tensor],
                     calib_poses: torch.Tensor, *, parents: Tuple[int, ...],
                     activation: str = "lrelu", beta: float = 100.0) -> Dict[str, Any]:
    """Post-training quantization of the DFNet stack, as JAX's
    ``quantize_posendf``, calibrated on the port's plain fp32 forward
    (``ops/fused_model.py::field_forward_ref``) over ``calib_poses``
    (N, J, 4), on their device. Returns JAX's tree, in JAX's layout::

        {"enc": {"w1" (J, 4+F, H), "b1", "w2", "b2"} fp32,
         "layers": [{"w" (in, out), "b"} fp32 or
                    {"wq" (in, out) int8, "dq" (1, out), "b", "inv_sa" (1, in)}],
         "window": (start, stop),
         "report": {"sa_max", "w_absmax", "floored_channels", "window"}}

    ``report["floored_channels"]`` counts, per quantized layer, the input
    channels whose calibration max sat below the floor (1e-6 of the layer's
    largest): a channel the calibration set leaves dead.
    """
    layers_in = _dfnet_layers(dfnet_params)
    dims_in = [w.shape[0] for w, _ in layers_in]
    dims_out = [w.shape[1] for w, _ in layers_in]
    start, stop = int8_window(dims_in, dims_out)
    with torch.no_grad():
        enc = {k: enc_params[k].detach().float().clone() for k in ("w1", "b1", "w2", "b2")}
        weights = FieldWeights(parents=tuple(parents), activation=activation, beta=float(beta),
                               enc=enc, layers=[(w.detach().float(), b.detach().float())
                                                for w, b in layers_in])
        _, (_, zf, zs) = field_forward_ref(joint_axis_normalize(calib_poses), weights, keep=True)
        act = make_activation(activation, beta)
        inputs = [torch.cat([act(z) for z in zf], dim=-1)] + [act(z) for z in zs]
        layers: List[Dict[str, torch.Tensor]] = []
        report: Dict[str, Any] = {"sa_max": [], "w_absmax": [], "floored_channels": [],
                                  "window": (start, stop)}
        for l, (w, b) in enumerate(weights.layers):
            if start <= l < stop:
                raw_absmax = inputs[l].abs().amax(dim=0)                 # (in,)
                floor = torch.clamp_min(1e-6 * raw_absmax.max(), 1e-12)
                absmax = torch.maximum(raw_absmax, floor)
                sa = absmax / 127.0
                w_folded = sa[:, None] * w
                sw = torch.clamp_min(w_folded.abs().amax(dim=0), 1e-12) / 127.0
                layers.append({"wq": quant_sym(w_folded, 1.0 / sw[None, :]),
                               "dq": sw[None, :].contiguous(), "b": b.clone(),
                               "inv_sa": (1.0 / sa)[None, :].contiguous()})
                report["sa_max"].append(float(sa.max() * 127.0))
                report["w_absmax"].append(float(w.abs().max()))
                report["floored_channels"].append(int((raw_absmax < floor).sum()))
            else:
                layers.append({"w": w.clone(), "b": b.clone()})
    return {"enc": enc, "layers": layers, "window": (start, stop), "report": report}


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def qparams_from_numpy(tree: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX's qparams as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    qparams)``, the ``layers`` a list or a dict keyed "0", "1", ... as in a
    saved file, or the whole tree flattened to "/"-joined keys) -> the
    port's qparams on ``device``."""
    if "enc" not in tree:
        tree = _nest(tree)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    raw = tree["layers"]
    if isinstance(raw, Mapping):
        raw = [raw[str(i)] for i in range(len(raw))]
    layers = []
    for lyr in raw:
        if "wq" in lyr:
            layers.append({"wq": torch.from_numpy(np.array(lyr["wq"], dtype=np.int8)).to(device),
                           "dq": f32(lyr["dq"]), "b": f32(lyr["b"]), "inv_sa": f32(lyr["inv_sa"])})
        else:
            layers.append({"w": f32(lyr["w"]), "b": f32(lyr["b"])})
    window = tuple(int(v) for v in np.asarray(tree["window"]).reshape(-1))
    report = {k: np.asarray(v).tolist() for k, v in dict(tree.get("report", {})).items()}
    report["window"] = tuple(int(v) for v in report.get("window", window))
    return {"enc": {k: f32(tree["enc"][k]) for k in ("w1", "b1", "w2", "b2")},
            "layers": layers, "window": window, "report": report}


def qparams_to_numpy(qparams: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`qparams_from_numpy`: the arrays as numpy (on
    the host), the layers a list."""
    def host(t):
        return t.detach().cpu().numpy()

    return {"enc": {k: host(v) for k, v in qparams["enc"].items()},
            "layers": [{k: host(v) for k, v in lyr.items()} for lyr in qparams["layers"]],
            "window": tuple(qparams["window"]), "report": dict(qparams["report"])}


def int8_layers_ref(h: torch.Tensor, layers: Sequence[Mapping[str, torch.Tensor]], activation: str,
                    beta: float, start: int = 0, stop: Optional[int] = None,
                    xq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain DFNet layers [start, stop) of the mixed fp32/int8 stack from
    their fp32 input h (B, in); the output activation after the last layer.
    ``xq`` replaces layer ``start``'s requantized input, if that layer is an
    int8 one."""
    act, out_act = resolve(activation, beta)
    L = len(layers)
    stop = L if stop is None else stop
    for l in range(start, stop):
        lyr = layers[l]
        if "wq" in lyr:
            if lyr["wq"].shape[0] > MAX_INT8_K:
                raise ValueError(f"int8 layer {l} is {lyr['wq'].shape[0]} wide; the fp32 product of "
                                 f"int8 values is exact up to {MAX_INT8_K}")
            q = xq if (xq is not None and l == start) else quant_sym(h, lyr["inv_sa"])
            y = torch.matmul(q.float(), lyr["wq"].float()) * lyr["dq"] + lyr["b"]
        else:
            y = torch.matmul(h, lyr["w"]) + lyr["b"]
        h = out_act(y) if l == L - 1 else act(y)
    return h


def _encode_ref(quat: torch.Tensor, qparams: Mapping[str, Any], parents, activation: str,
                beta: float) -> torch.Tensor:
    enc = qparams["enc"]
    return structure_encoder_apply(joint_axis_normalize(quat), enc["w1"], enc["b1"], enc["w2"], enc["b2"],
                                   parents=tuple(parents), activation=activation, beta=beta)


def fused_posendf_forward_int8_ref(quat: torch.Tensor, qparams: Mapping[str, Any], *,
                                   parents: Tuple[int, ...], activation: str = "lrelu",
                                   beta: float = 100.0) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: (B, J, 4) -> (B, 1), the
    joint-axis normalization included."""
    h = _encode_ref(quat, qparams, parents, activation, beta)
    return int8_layers_ref(h, qparams["layers"], activation, beta)


@dataclass
class Int8Packed:
    """A quantized field as the kernel reads it, on one device."""

    enc: torch.Tensor        # w1 | b1 | w2 | b2, flat fp32
    parents: torch.Tensor    # (J,) int32
    fw: torch.Tensor         # fp32 layers: W (in, out) | b; int8 layers: b | dq | inv_sa
    qw: torch.Tensor         # int8 layers' wq in slabs (sw128_kmajor_offsets), 1024-aligned
    meta: torch.Tensor       # (L, 8) int32: in, out, kind, off W / wq, off b, dq, inv_sa, slab channels
    num_layers: int
    x_bytes: Tuple[int, int]  # activation buffers: the inputs of the even / odd layers (the
                              # odd one first stages the encoder's poses and weights)
    maxn: int                 # widest int8 layer output (0 without one)


def _pack(qparams: Mapping[str, Any], parents: Tuple[int, ...]) -> Int8Packed:
    layers = qparams["layers"]
    enc = qparams["enc"]
    dev = enc["w1"].device
    J, F = len(parents), enc["w2"].shape[-1]
    last = layers[-1]
    if "wq" in last or last["w"].shape[1] != 1:
        raise ValueError("the last DFNet layer must be fp32 with one output")
    if "wq" in layers[0]:
        raise ValueError("the kernel takes an fp32 first layer (its input is the encoder's code)")
    with torch.no_grad():
        fchunks: List[torch.Tensor] = []
        qchunks: List[torch.Tensor] = []
        foff = qoff = 0

        def put(t: torch.Tensor) -> int:
            nonlocal foff
            flat = t.detach().reshape(-1).float()
            pad = (-flat.numel()) % 4
            fchunks.append(flat)
            if pad:
                fchunks.append(flat.new_zeros(pad))
            start, foff = foff, foff + flat.numel() + pad
            return start

        meta, x_bytes, maxn = [], [0, 0], 0
        for l, lyr in enumerate(layers):
            if "wq" in lyr:
                wq = lyr["wq"]
                K, N = wq.shape
                if K % 128 or N % 128 or K > MAX_INT8_K:
                    raise ValueError(f"int8 layer {l} is {K} x {N}: the kernel takes K and N "
                                     f"multiples of 128, K up to {MAX_INT8_K}")
                nc = 256 if N % 256 == 0 else 128    # output channels a slab: m64n64 a warpgroup
                qchunks.append(pack_sw128(wq, nc))
                meta.append([K, N, 1, qoff, put(lyr["b"]), put(lyr["dq"]), put(lyr["inv_sa"]), nc])
                qoff += K * N                    # a multiple of 128 x 128: 1024-aligned
                maxn = max(maxn, N)
                x_bytes[l % 2] = max(x_bytes[l % 2], _ROWS * K)
            else:
                K, N = lyr["w"].shape
                meta.append([K, N, 0, put(lyr["w"]), put(lyr["b"]), 0, 0, 0])
                x_bytes[l % 2] = max(x_bytes[l % 2], 4 * _ROWS * K)
        qw = torch.cat(qchunks) if qchunks else torch.zeros(16, dtype=torch.int8, device=dev)
        enc_flat = torch.cat([enc[k].reshape(-1).float() for k in ("w1", "b1", "w2", "b2")])
        # the odd layers' buffer first holds the encoder's poses and weights
        x_bytes[1] = max(x_bytes[1], 16 * _ROWS * J + 4 * enc_flat.numel())
        meta = tuple(map(tuple, meta))
        return Int8Packed(enc=enc_flat.contiguous(), parents=int_table(tuple(parents), str(dev)),
                          fw=torch.cat(fchunks).contiguous(), qw=qw.contiguous(),
                          meta=int_table(meta, str(dev)), num_layers=len(layers),
                          x_bytes=(x_bytes[0], x_bytes[1]), maxn=maxn)


_PACKED: Dict[int, Tuple[Mapping[str, Any], tuple, Int8Packed]] = {}
_PACKED_MAX = 4


def _tensors(qparams: Mapping[str, Any]) -> List[torch.Tensor]:
    return list(qparams["enc"].values()) + [t for lyr in qparams["layers"] for t in lyr.values()]


def packed(qparams: Mapping[str, Any], parents: Tuple[int, ...]) -> Int8Packed:
    """The kernel's buffers for ``qparams``, built once and rebuilt if a
    tensor was replaced or changed in place since. The cache keeps the
    last few trees alive, so the id of a cached tree is never reused."""
    key = (tuple(parents),) + tuple((t.data_ptr(), t._version) for t in _tensors(qparams))
    hit = _PACKED.pop(id(qparams), None)
    if hit is None or hit[1] != key:
        hit = (qparams, key, _pack(qparams, tuple(parents)))
    _PACKED[id(qparams)] = hit                 # most recent last
    while len(_PACKED) > _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    return hit[2]


def _check(quat: torch.Tensor, qparams: Mapping[str, Any], parents) -> None:
    J = len(parents)
    if quat.dim() != 3 or quat.shape[1:] != (J, 4):
        raise ValueError(f"poses must have shape (B, {J}, 4), got {tuple(quat.shape)}")
    if quat.dtype != torch.float32:
        raise TypeError(f"poses must be float32, got {quat.dtype}")
    if quat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"poses must be on the CPU or a CUDA device, got {quat.device}")
    dev = qparams["enc"]["w1"].device
    if quat.device != dev:
        raise ValueError(f"poses on {quat.device} but the quantized weights on {dev}")
    if quat.requires_grad:
        raise RuntimeError("the int8 forward is value-only: its gradient would be that of a "
                           "staircase; take gradients on the fp32 paths")


def fused_posendf_forward_int8(quat: torch.Tensor, qparams: Mapping[str, Any], *,
                               parents: Tuple[int, ...], activation: str = "lrelu",
                               beta: float = 100.0) -> torch.Tensor:
    """int8 whole-model forward: (B, J, 4) -> (B, 1) distances, the
    joint-axis normalization folded in. A CUDA tensor goes through the
    kernel, a CPU tensor through the plain version."""
    global LAUNCHES
    _check(quat, qparams, parents)
    if quat.device.type == "cpu":
        with torch.no_grad():
            return fused_posendf_forward_int8_ref(quat, qparams, parents=parents,
                                                  activation=activation, beta=beta)
    quat = aligned_contiguous(quat)
    pk = packed(qparams, parents)
    lib = _build.library("int8")
    out = torch.empty((quat.shape[0], 1), dtype=torch.float32, device=quat.device)
    _build.check(lib.posendf_forward_int8(
        quat.data_ptr(), quat.shape[0], pk.enc.data_ptr(), pk.parents.data_ptr(), len(parents),
        qparams["enc"]["w2"].shape[-1], pk.fw.data_ptr(), pk.qw.data_ptr(), pk.meta.data_ptr(),
        pk.num_layers, pk.x_bytes[0], pk.x_bytes[1], pk.maxn, _build.ACT_CODES[activation],
        float(beta), out.data_ptr(), stream_handle(quat)), "posendf_forward_int8", "int8")
    LAUNCHES += 1
    return out


def boundary_flips(quat: torch.Tensor, qparams: Mapping[str, Any], *, parents: Tuple[int, ...],
                   activation: str = "lrelu", beta: float = 100.0,
                   xtol: float = 3e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward of each pose with requantized inputs of the first
    int8 layer moved to the other side of their rounding: for a pose whose
    fp32 inputs x lie within ``xtol`` of a rounding boundary (x inv_sa = n +
    1/2) in n channels, each nonempty subset of them flipped when n <= 4,
    else each one alone. Returns (pose index (P,), d (P, 1)); empty without
    an int8 layer.

    Two computations of the same field that differ only in the fp32 sums of
    the encoder and of the fp32 layers before the window (another order, an
    absolute difference of a few 1e-7 on inputs of order 1) requantize the
    same levels unless an input lies that close to a boundary: from the
    first int8 layer on every int8 sum is exact. Such a pose's d is then one
    of these alternatives, to the rounding of the fp32 tail."""
    start, stop = qparams["window"]
    empty = (torch.zeros(0, dtype=torch.long), quat.new_zeros((0, 1)))
    if start == stop:
        return empty
    layers = qparams["layers"]
    with torch.no_grad():
        h = int8_layers_ref(_encode_ref(quat, qparams, parents, activation, beta), layers,
                            activation, beta, 0, start)
        inv_sa = layers[start]["inv_sa"]
        v = h * inv_sa
        lo = torch.floor(v)
        near = ((v - lo - 0.5).abs() < xtol * inv_sa) & (v.abs() < 127.5)
        xq = quant_sym(h, inv_sa).float()
        other = torch.clamp(2 * lo + 1 - xq, -127.0, 127.0)
        index, rows = [], []
        for p in near.any(dim=1).nonzero().reshape(-1).tolist():
            chs = near[p].nonzero().reshape(-1).tolist()
            subsets = ([[c for i, c in enumerate(chs) if mask >> i & 1]
                        for mask in range(1, 1 << len(chs))] if len(chs) <= 4 else [[c] for c in chs])
            for sub in subsets:
                row = xq[p].clone()
                row[sub] = other[p, sub]
                rows.append(row)
                index.append(p)
        if not rows:
            return empty
        index = torch.tensor(index, dtype=torch.long)
        d = int8_layers_ref(h[index.to(h.device)], layers, activation, beta, start,
                            xq=torch.stack(rows).to(torch.int8))
    return index, d


def hold_to_ref(d: torch.Tensor, d_ref: torch.Tensor, quat: torch.Tensor, qparams: Mapping[str, Any],
                *, parents: Tuple[int, ...], activation: str = "lrelu", beta: float = 100.0,
                atol: float = 1e-5, xtol: float = 3e-5) -> Dict[str, float]:
    """Hold int8 distances ``d`` to the plain version's ``d_ref`` of the same
    poses: each within ``atol``, or, for a pose with inputs of the first
    int8 layer within ``xtol`` of a rounding boundary, within ``atol`` of the
    plain d with those levels on the other side (:func:`boundary_flips`).
    Raises AssertionError otherwise; returns the largest error of the poses
    within ``atol``, how many poses needed a moved level and the largest
    such difference."""
    err = (d.detach().float() - d_ref.detach().float()).abs().reshape(-1).cpu()
    if d.shape != d_ref.shape or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"shape {tuple(d.shape)} vs {tuple(d_ref.shape)}, or non-finite")
    off = (err > atol).nonzero().reshape(-1)
    moved = 0.0
    if off.numel():
        pose, d_alt = boundary_flips(quat[off.to(quat.device)], qparams, parents=parents,
                                     activation=activation, beta=beta, xtol=xtol)
        d_off = d.detach().float().reshape(-1)[off.to(d.device)].cpu()
        ok = torch.zeros(len(off), dtype=torch.bool)
        if pose.numel():
            close = (d_alt.reshape(-1).cpu() - d_off[pose]).abs() <= atol
            ok[pose[close]] = True
        if not bool(ok.all()):
            bad = off[~ok]
            raise AssertionError(f"{len(bad)} poses off by up to {float(err[bad].max()):.3e} (atol "
                                 f"{atol}) and not explained by requantized levels within "
                                 f"{xtol} of a rounding boundary")
        moved = float(err[off].max())
    within = err[err <= atol]
    return {"max_abs_err": float(within.max()) if within.numel() else 0.0,
            "one_level": int(off.numel()), "one_level_max": moved}
