"""The whole distance field in one CUDA kernel (forward only).

Port of ``posendf_tpu/ops/fused_model.py::_model_kernel``. The kernel is
``posendf_forward`` in ``csrc/field_kernels.cu``: joint-axis normalization,
the 21-joint encoder walk and every DFNet layer for a tile of 64 poses in
one program, the DFNet's products as 3xTF32 ``wgmma`` on the tensor cores;
only the poses come in and d goes out through device memory. A field whose
module computes in bf16 (``compute_dtype="bfloat16"``) runs the kernels'
bf16 route, as the TPU kernel's ``compute_dtype`` does: every product, the
encoder's and the output layer's included, on operands rounded to bf16,
summed in fp32; biases, activations and derivative state in fp32.

``fused_posendf_forward`` launches it for a CUDA tensor and runs its plain
PyTorch version, ``fused_posendf_forward_ref``, for a CPU tensor. Under
autograd it is a ``torch.autograd.Function`` whose backward differentiates
the plain version, as the JAX kernel's ``custom_vjp`` differentiates the
XLA formula; that backward is itself differentiable (in bf16 it raises,
as JAX's does). This module also holds :class:`FieldWeights`, the view of a
model that the kernels read, and its packing into device buffers:
:class:`Packed` for the train kernels and :class:`TcPacked` for the three
field kernels (:func:`pack_tc` in fp32, :func:`pack_bf16` in bf16; the
encoder walks' rows :func:`pack_walk`), and the three field kernels' launch
plan (:func:`launch_plan`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from posendf_torch import _build
from posendf_torch.models.activations import resolve
from posendf_torch.models.dfnet import bf16_round
from posendf_torch.quat import joint_axis_normalize

__all__ = ["FieldWeights", "fused_posendf_forward", "fused_posendf_forward_ref", "replay_backward",
           "int_table", "aligned_contiguous", "TcPacked", "pack_tc", "pack_bf16", "tc_width",
           "tc_widths", "tc_schedule", "tc_slab_offsets", "bf16_slab_offsets", "pack_walk", "operand",
           "bf16_hold", "TC_CHUNK", "BF16_SLAB", "BF16_SLAB_K", "LAUNCHES", "LaunchPlan",
           "launch_plan", "plan_launch", "SPLIT_SIZES", "SPLIT_LAUNCHES", "STATE_LAUNCHES",
           "state_kind"]

# launches of the forward kernel since the count was last set to 0
LAUNCHES = 0
# launches of the three field kernels by the cluster size of their split tiles
# (1: a CTA a tile), since the counts were last set to 0
SPLIT_LAUNCHES: Dict[int, int] = {1: 0, 2: 0}
# value-and-grad and projection-step launches by the derivative state their
# backward reads (state_kind), since the counts were last set to 0
STATE_LAUNCHES: Dict[str, int] = {"bits": 0, "slope": 0}

_MAX_JOINTS, _MAX_FEATURE, _MAX_LAYERS = 32, 8, 16


@dataclass
class Packed:
    """A field's encoder and layer table as the kernels read them, on one device."""

    enc: torch.Tensor        # w1 | b1 | w2 | b2, flat fp32
    parents: torch.Tensor    # (J,) int32
    meta: torch.Tensor       # (L, 2) int32: each layer's in, out
    meta_host: torch.Tensor  # the same table on the CPU
    num_layers: int


@dataclass
class FieldWeights:
    """What the fused kernels need from a PoseNDF: the parent table, the
    activation, the parameter tensors themselves (not copies, so the plain
    versions always see the current values) and the module's compute dtype,
    "float32" or "bfloat16"."""

    parents: Tuple[int, ...]
    activation: str
    beta: float
    enc: Dict[str, torch.Tensor]
    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    compute_dtype: str = "float32"
    _packed: Optional[Packed] = field(default=None, repr=False)
    _tc: Optional["TcPacked"] = field(default=None, repr=False)
    _walk: Optional[torch.Tensor] = field(default=None, repr=False)

    @classmethod
    def from_module(cls, module) -> "FieldWeights":
        if not module.use_encoder or module.ff_enc:
            raise ValueError("the fused kernels support the standard encoder+DFNet "
                             "architecture (use_encoder=True, ff_enc=False)")
        enc = module.enc
        return cls(parents=tuple(module.parents), activation=module.activation,
                   beta=float(module.beta),
                   enc={"w1": enc.w1, "b1": enc.b1, "w2": enc.w2, "b2": enc.b2},
                   layers=module.dfnet.layers(), compute_dtype=module.compute_dtype)

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == "bfloat16"

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def feature_size(self) -> int:
        return self.enc["w2"].shape[-1]

    @property
    def device(self) -> torch.device:
        return self.enc["w1"].device

    def tensors(self) -> List[torch.Tensor]:
        return [self.enc[k] for k in ("w1", "b1", "w2", "b2")] + \
            [p for wb in self.layers for p in wb]

    def packed(self) -> Packed:
        """The device buffers the kernels read, built once and reused."""
        if self._packed is None:
            self._packed = _pack(self)
        return self._packed

    def tc_packed(self) -> "TcPacked":
        """The field kernels' weights (:func:`pack_tc`, or :func:`pack_bf16`
        in bf16), built once and reused."""
        if self._tc is None:
            self._tc = pack_bf16(self) if self.bf16 else pack_tc(self)
        return self._tc

    def walk_packed(self) -> torch.Tensor:
        """The field kernels' encoder weights (:func:`pack_walk`), built once
        and reused."""
        if self._walk is None:
            self._walk = pack_walk(self)
        return self._walk


@functools.lru_cache(maxsize=None)
def int_table(values: tuple, device: str) -> torch.Tensor:
    """An int32 table (the parents, a layer table) on ``device``, made once:
    each copy from the host would make the host wait for the stream."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _pack(w: FieldWeights) -> Packed:
    J, F, L = w.num_joints, w.feature_size, len(w.layers)
    if J > _MAX_JOINTS or F > _MAX_FEATURE or L > _MAX_LAYERS:
        raise ValueError(f"the kernels take at most {_MAX_JOINTS} joints, feature size "
                         f"{_MAX_FEATURE} and {_MAX_LAYERS} layers; got {J}, {F}, {L}")
    if w.layers[-1][0].shape[1] != 1:
        raise ValueError("the last DFNet layer must have one output")
    with torch.no_grad():
        enc = torch.cat([w.enc[k].detach().reshape(-1).float()
                         for k in ("w1", "b1", "w2", "b2")]).contiguous()
    meta = tuple(tuple(wl.shape) for wl, _ in w.layers)
    return Packed(enc=enc, parents=int_table(tuple(w.parents), str(enc.device)),
                  meta=int_table(meta, str(enc.device)), meta_host=int_table(meta, "cpu"),
                  num_layers=L)


# ---- the field kernels' weights (csrc/field_kernels.cu) ----
#
# The kernels run each DFNet product as 3xTF32 wgmma, the weights as the B
# operand from a ring of slabs in shared memory. A slab is 128 output
# columns (64 for each of the two consumer warpgroups) x 32 of K (one
# 128-byte line of tf32): the TF32 hi part, then the lo part, each 128 rows
# x 128 bytes in the K-major 128-byte swizzle of csrc/hopper.cuh, 32 KB in
# all; for the first product of a chain, 64 columns x 64 of K, two such
# pairs of 64 rows. Within each 8-group of K, position p holds feature TC_KPERM[p], so
# that a thread's A fragment (K positions t%4 and t%4 + 4) is the adjacent
# pair of features 2(t%4), 2(t%4) + 1 that an accumulator fragment holds.

TC_SLAB_N, TC_SLAB_K = 128, 32               # output columns x K of one slab
TC_SLAB_FLOATS = 2 * TC_SLAB_N * TC_SLAB_K   # hi | lo: 32 KB
TC_XMAX = 512                                # widest activation a CTA keeps whole
TC_CHUNK = 64                                # a chained layer's output, columns at a time
TC_HEAD, TC_STEP = 8, 8                      # ints of the program's header and of a step
TC_KPERM = (0, 2, 4, 6, 1, 3, 5, 7)          # the feature at K position p of an 8-group


def tc_width(n: int) -> int:
    """A width as the field kernels pad it: 128, 256 or 512, or a multiple of
    128 above 512 (the output of a layer that wide is made and used 128
    columns at a time, chained with the next layer)."""
    for w in (128, 256, 512):
        if n <= w:
            return w
    return -(-n // 128) * 128


def tc_widths(dims) -> Tuple[int, ...]:
    """The padded widths of a code width and hidden widths: each to
    :func:`tc_width`, and the width after a chained one (above 512) to 512,
    the one output width of a chain."""
    D = [tc_width(n) for n in dims]
    for l in range(1, len(D) - 1):
        if D[l] > TC_XMAX and D[l + 1] <= TC_XMAX:
            D[l + 1] = TC_XMAX
    return tuple(D)


def tc_schedule(widths: Tuple[int, ...], slab_k: int = TC_SLAB_K):
    """The field kernels' program and slab order for padded widths
    D[0..L-1] (D[0] the code, D[l + 1] layer l's output; layer L-1, the
    output layer, runs on the CUDA cores), for slabs of ``slab_k`` of K
    (32 for the 3xTF32 route, 64 for the bf16 route: BF16_SLAB_K).

    Returns (header, forward steps, backward steps, forward slabs, backward
    slabs). A step is [chain, K, N, N2, bias1, z1, bias2, z2]: a layer
    (chain 0: K -> N, every N column from one pass over K) or a chain of
    two (chain 1: K -> N -> N2, N made TC_CHUNK columns at a time and at
    once taken as K of the second product). bias: offset in ``vec`` of a
    forward epilogue's bias, -1 in the backward; z: offset, in units a
    pose, of the derivative state (act', ``state_kind``) the forward keeps
    or the backward reads, -1 for none. A slab is (matrix, layer, K block,
    column group, columns): matrix "wt" = W^T (out, in) for the forward,
    "w" = W (in, out) for the backward, both (N, K); 128 columns x ``slab_k`` of K, or,
    for the first product of a chain, TC_CHUNK = 64 columns x 2 ``slab_k``
    of K (blocks and groups counted in those units). The program does not
    depend on ``slab_k``, only the slabs do. The header is [forward steps, backward
    steps, D[0], D[L-1], offset of the output layer's w, of its b, z offset
    of layer L-2, zsum]."""
    D, n = list(widths), len(widths) - 1
    chain = [D[l + 1] > TC_XMAX for l in range(n)]
    if D[0] > TC_XMAX:
        raise ValueError(f"the field kernels take a code of at most {TC_XMAX} features")
    for l in range(n):
        if chain[l] and not (l + 1 < n and D[l] <= TC_XMAX and D[l + 2] == TC_XMAX):
            raise ValueError(f"the field kernels take a layer wider than {TC_XMAX} only "
                             f"between a hidden layer of at most {TC_XMAX} and one of "
                             f"{TC_XMAX} (padded): widths {D}")
    zoff = [sum(D[1:l + 1]) for l in range(n)]
    zsum = sum(D[1:])
    kbs = lambda k: range(k // slab_k)             # noqa: E731
    cgs = lambda k: range(k // TC_SLAB_N)          # noqa: E731
    ck = TC_CHUNK // slab_k                        # K blocks of a chunk

    def chain_slabs(m, first, second, K, N, N2):
        out = []
        for c in range(N // TC_CHUNK):
            out += [(m, first, k, c, TC_CHUNK) for k in range(K // (2 * slab_k))]
            out += [(m, second, ck * c + k, g, TC_SLAB_N) for k in range(ck) for g in cgs(N2)]
        return out

    fwd, bwd, fslabs, bslabs = [], [], [], []
    l = 0
    while l < n:
        if chain[l]:
            fwd.append([1, D[l], D[l + 1], D[l + 2], zoff[l], zoff[l], zoff[l + 1], zoff[l + 1]])
            fslabs += chain_slabs("wt", l, l + 1, D[l], D[l + 1], D[l + 2])
            l += 2
        else:
            fwd.append([0, D[l], D[l + 1], 0, zoff[l], zoff[l], -1, -1])
            fslabs += [("wt", l, k, g, TC_SLAB_N) for k in kbs(D[l]) for g in cgs(D[l + 1])]
            l += 1
    zprev = lambda m: zoff[m] if m >= 0 else -1    # noqa: E731
    l = n - 1
    while l >= 0:
        if l >= 1 and chain[l - 1]:
            bwd.append([1, D[l + 1], D[l], D[l - 1], -1, zoff[l - 1], -1, zprev(l - 2)])
            bslabs += chain_slabs("w", l, l - 1, D[l + 1], D[l], D[l - 1])
            l -= 2
        else:
            bwd.append([0, D[l + 1], D[l], 0, -1, zprev(l - 1), -1, -1])
            bslabs += [("w", l, k, g, TC_SLAB_N) for k in kbs(D[l + 1]) for g in cgs(D[l])]
            l -= 1
    header = [len(fwd), len(bwd), D[0], D[n], zsum, zsum + D[n], zoff[n - 1], zsum]
    return header, fwd, bwd, fslabs, bslabs


def tc_slab_offsets(rows: int = TC_SLAB_N) -> torch.Tensor:
    """Where a slab half of ``rows`` rows keeps element (row r, K position
    k): (rows, 32) float offsets, byte 4k of row r at csrc/hopper.cuh's
    sw128_offset."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(TC_SLAB_K)[None, :]
    return (r // 8) * 256 + (r % 8) * 32 + (((k // 4) ^ (r % 8)) * 4) + k % 4


def _slab_ids(m: torch.Tensor, cols: int, lo_shift: int, zero: int) -> torch.Tensor:
    """Every slab of an (N, K) matrix of element ids as the kernels read it:
    (K / kl, N / cols, TC_SLAB_FLOATS) ids, kl = the slab's K; a weight's hi
    half keeps its id, its lo half the id + ``lo_shift``, padding ``zero``.
    A 128-column slab is hi | lo of one 128 x 32 block; a 64-column slab (the
    first product of a chain) is hi | lo of its first 32 of K, then of its
    second; within each 8-group of K, position p holds feature TC_KPERM[p],
    and each half is in the 128-byte swizzle (:func:`tc_slab_offsets`)."""
    N, K = m.shape
    kl = TC_SLAB_FLOATS // 2 // cols          # 32 or 64
    b = m.reshape(N // cols, cols, K // kl, kl // TC_SLAB_K, TC_SLAB_K)
    b = b.permute(2, 0, 3, 1, 4)              # (K / kl, N / cols, halves, cols, 32)
    b = b.reshape(*b.shape[:-1], TC_SLAB_K // 8, 8)[..., list(TC_KPERM)]
    hi = b.reshape(*b.shape[:-3], cols * TC_SLAB_K)
    lo = torch.where(hi == zero, hi, hi + lo_shift)
    off = tc_slab_offsets(cols).reshape(-1)
    out = torch.empty(*hi.shape[:-1], 2, cols * TC_SLAB_K, dtype=hi.dtype)
    out[..., 0, off] = hi
    out[..., 1, off] = lo
    return out.reshape(K // kl, N // cols, TC_SLAB_FLOATS)


@dataclass(frozen=True)
class _TcPlan:
    """What :func:`pack_tc` needs of a structure, made once: the program and
    where each float of the slabs comes from."""

    index: torch.Tensor   # (slabs x TC_SLAB_FLOATS,) int32: into hi | lo | 0 of the flat weights
    widths: Tuple[int, ...]
    prog: torch.Tensor
    nfwd: int
    nbwd: int
    zsum: int
    order: List[Tuple[str, int, int, int, int]]


def _weight_ids(shapes: Tuple[Tuple[int, int], ...], widths: Tuple[int, ...], zero: int) -> dict:
    """The ids of the weights W_l of ``shapes`` (in, out), flattened one after
    another, as each padded matrix the slabs cut: {("w", l): (D_l, D_l+1),
    ("wt", l): its transpose}, padding ``zero``."""
    mats, base = {}, 0
    for l, (i, o) in enumerate(shapes):
        m = torch.full((widths[l], widths[l + 1]), zero, dtype=torch.int64)
        m[:i, :o] = torch.arange(base, base + i * o).view(i, o)
        mats["w", l], mats["wt", l] = m, m.t()
        base += i * o
    return mats


@functools.lru_cache(maxsize=None)
def _tc_plan(shapes: Tuple[Tuple[int, int], ...], device: str) -> _TcPlan:
    """The plan of hidden layers of ``shapes`` (in, out) on ``device``: the
    weights W_l flattened one after another (``total`` floats) are split to
    hi | lo and followed by one zero; slab float f is element index[f] of
    that."""
    widths = tc_widths([shapes[0][0]] + [o for _, o in shapes])
    header, fwd, bwd, fslabs, bslabs = tc_schedule(widths)
    total = sum(i * o for i, o in shapes)
    zero = 2 * total
    mats = _weight_ids(shapes, widths, zero)
    order = fslabs + bslabs
    cut = {key: _slab_ids(mats[key[:2]], key[2], total, zero)
           for key in {(kind, l, cols) for kind, l, _, _, cols in order}}
    index = torch.stack([cut[kind, l, cols][kb, cg] for kind, l, kb, cg, cols in order])
    prog = tuple(header + [v for step in fwd + bwd for v in step])
    return _TcPlan(index=index.reshape(-1).to(device=device, dtype=torch.int32), widths=widths,
                   prog=int_table(prog, device), nfwd=len(fslabs), nbwd=len(bslabs),
                   zsum=header[-1], order=order)


@dataclass
class TcPacked:
    """A field's weights as the field kernels read them, on one device."""

    slabs: torch.Tensor           # (nfwd + nbwd, TC_SLAB_FLOATS) fp32, in the order they are
                                  # read; bf16: (nfwd + nbwd, BF16_SLAB) bf16
    vec: torch.Tensor             # padded biases of layers 0..L-2 | output layer's w (padded) | b
    prog: torch.Tensor            # int32: the header, the forward's steps, the backward's
    widths: Tuple[int, ...]       # padded widths D[0..L-1]
    nfwd: int                     # slabs of the forward
    nbwd: int                     # slabs of the backward
    zsum: int                     # units of derivative state a pose (padded hidden widths)
    order: List[Tuple[str, int, int, int, int]]   # (matrix, layer, K block, column group, columns)
    bf16: bool = False
    _split: Dict[int, torch.Tensor] = field(default_factory=dict, repr=False)

    def split_slabs(self, c: int) -> torch.Tensor:
        """The slabs as the CTAs of a tile split across c read them (made
        once): a slab is four 8 KB blocks (hi and lo, each two warpgroups'
        rows; a chunk's two K halves' hi and lo), rank r's columns are the
        r-th 8 KB / c of each, and rank r's four pieces go together, so
        each rank copies a slab's share in one copy: (slabs, c, 4, 2048 / c)
        floats, the same bytes as ``slabs``."""
        if c not in self._split:
            n = self.slabs.shape[0]
            self._split[c] = self.slabs.view(n, 4, c, -1).transpose(1, 2).contiguous()
        return self._split[c]


def _tc_check(w: FieldWeights) -> Tuple[Tuple[int, int], ...]:
    """The hidden layers' shapes (in, out), once the field kernels are known
    to take the field."""
    J, F, L = w.num_joints, w.feature_size, len(w.layers)
    if J > _MAX_JOINTS or F > _MAX_FEATURE or L > _MAX_LAYERS or L < 2:
        raise ValueError(f"the field kernels take at most {_MAX_JOINTS} joints, feature size "
                         f"{_MAX_FEATURE} and 2 to {_MAX_LAYERS} layers; got {J}, {F}, {L}")
    if w.layers[-1][0].shape[1] != 1:
        raise ValueError("the last DFNet layer must have one output")
    return tuple(tuple(wl.shape) for wl, _ in w.layers[:-1])


def _tc_vec(w: FieldWeights, widths: Tuple[int, ...]) -> torch.Tensor:
    """The padded biases of the hidden layers | the output layer's w (padded;
    rounded to bf16 in bf16) | its b, fp32."""
    def pad(t: torch.Tensor, n: int) -> torch.Tensor:
        flat = t.detach().reshape(-1).float()
        return torch.cat([flat, flat.new_zeros(n - flat.numel())])

    w_out, b_out = w.layers[-1]
    return torch.cat([pad(b, widths[l + 1]) for l, (_, b) in enumerate(w.layers[:-1])] +
                     [pad(operand(w)(w_out.detach()), widths[-1]), pad(b_out, 4)]).contiguous()


def pack_tc(w: FieldWeights) -> TcPacked:
    """The field kernels' weights: every DFNet product layer's W^T (the
    forward's B) and W (the backward's B), zero-padded to :func:`tc_width`,
    split to TF32 hi / lo and cut into slabs in the order the kernels read
    them (:func:`tc_schedule`); the biases and the output layer in fp32.
    The slabs are one gather from the split weights by an index made once
    per structure (:func:`_tc_plan`), so packing each training step costs a
    few launches."""
    from posendf_torch.ops.fused_train import tf32_split

    if w.bf16:
        raise ValueError("pack_tc packs an fp32 field; a bf16 one is pack_bf16's")
    plan = _tc_plan(_tc_check(w), str(w.device))
    with torch.no_grad():
        hi, lo = tf32_split(torch.cat([wl.detach().reshape(-1).float()
                                       for wl, _ in w.layers[:-1]]))
        src = torch.cat([hi, lo, hi.new_zeros(1)])
        slabs = torch.index_select(src, 0, plan.index).view(-1, TC_SLAB_FLOATS)
        vec = _tc_vec(w, plan.widths)
    return TcPacked(slabs=slabs, vec=vec, prog=plan.prog, widths=plan.widths, nfwd=plan.nfwd,
                    nbwd=plan.nbwd, zsum=plan.zsum, order=plan.order)


# ---- the field kernels' bf16 weights ----
#
# The bf16 route reads the slabs of the same program (tc_schedule), each a
# whole 16 KB of weights rounded to bf16 (BF16_SLAB elements, no padding but
# the zero-padded widths'): 128 output columns x 64 of K, one 128-byte line a
# column in the K-major 128-byte swizzle (a k16 step reads 32 bytes of each
# line; warpgroup w takes lines 64w..64w+63); for the first product of a
# chain, 64 columns x 128 of K, two such tiles of 64 lines (K 0-63, then
# 64-127; warpgroup w takes lines 32w..32w+31 of each). So a pass reads half
# the slabs of the 3xTF32 route's 32 of K (tc_schedule with slab_k =
# BF16_SLAB_K: 168 a pass for the trained field, 336 in 3xTF32). K is in
# feature order: a thread's bf16 A registers hold features 2(t%4), +1, +8,
# +9 of a k16 step, the columns its accumulators hold in two adjacent
# 8-column groups. The kernels' fresh accumulator spans a slab (64 of K)
# before it is added to the layer's fp32 sums.

BF16_SLAB = 8192      # bf16 elements a slab: 16 KB, 128 lines of 128 bytes
BF16_SLAB_K = 64      # K of a 128-column bf16 slab: one 128-byte line


def bf16_slab_offsets(rows: int, kl: int) -> torch.Tensor:
    """Where a bf16 slab of ``rows`` output columns x ``kl`` of K (rows x kl
    = BF16_SLAB) keeps element (column r, K position k): (rows, kl)
    offsets in bf16 elements. K 64h..64h+63 of column r is line r + rows h,
    byte 2 (k % 64) of that line at csrc/hopper.cuh's sw128_offset."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(kl)[None, :]
    line, kk = r + rows * (k // BF16_SLAB_K), k % BF16_SLAB_K
    return (line // 8) * 512 + (line % 8) * 64 + ((kk // 8) ^ (line % 8)) * 8 + kk % 8


def _bf16_slab_ids(m: torch.Tensor, cols: int) -> torch.Tensor:
    """Every bf16 slab of an (N, K) matrix of element ids: (K / kl, N / cols,
    BF16_SLAB) ids, kl = BF16_SLAB / cols (64 for 128 columns, 128 for the
    64 of a chain's first product)."""
    N, K = m.shape
    kl = BF16_SLAB // cols
    b = m.reshape(N // cols, cols, K // kl, kl).permute(2, 0, 1, 3)
    out = torch.empty((K // kl, N // cols, BF16_SLAB), dtype=m.dtype)
    out[..., bf16_slab_offsets(cols, kl).reshape(-1)] = b.reshape(K // kl, N // cols, -1)
    return out


@dataclass(frozen=True)
class _Bf16Plan:
    """What :func:`pack_bf16` needs of a structure, made once."""

    index: torch.Tensor   # (slabs x BF16_SLAB,) int32: into the flat weights and one zero
    nfwd: int
    nbwd: int
    order: List[Tuple[str, int, int, int, int]]


@functools.lru_cache(maxsize=None)
def _bf16_plan(shapes: Tuple[Tuple[int, int], ...], device: str) -> _Bf16Plan:
    """The bf16 slabs of hidden layers of ``shapes`` (in, out) as one gather:
    slab element f is element index[f] of the weights W_l flattened one after
    another and followed by one zero; the slabs in the order of
    ``tc_schedule(widths, BF16_SLAB_K)``."""
    widths = tc_widths([shapes[0][0]] + [o for _, o in shapes])
    _, _, _, fslabs, bslabs = tc_schedule(widths, BF16_SLAB_K)
    total = sum(i * o for i, o in shapes)
    mats = _weight_ids(shapes, widths, total)
    order = fslabs + bslabs
    cut = {key: _bf16_slab_ids(mats[key[:2]], key[2])
           for key in {(kind, l, cols) for kind, l, _, _, cols in order}}
    index = torch.stack([cut[kind, l, cols][kb, cg] for kind, l, kb, cg, cols in order])
    return _Bf16Plan(index=index.reshape(-1).to(device=device, dtype=torch.int32),
                     nfwd=len(fslabs), nbwd=len(bslabs), order=order)


def pack_bf16(w: FieldWeights) -> TcPacked:
    """The field kernels' bf16 weights: :func:`pack_tc`'s program, the slabs
    of ``tc_schedule(widths, BF16_SLAB_K)`` in their order, each its block
    of the zero-padded W^T (forward) or W (backward) rounded to bf16 (the
    layout above); the biases in fp32, the output layer's w rounded to bf16
    (kept as fp32) and its b. (The encoder's rounded weights are
    :func:`pack_walk`'s.)"""
    if not w.bf16:
        raise ValueError("pack_bf16 packs a field whose compute_dtype is 'bfloat16'")
    shapes = _tc_check(w)
    plan, bp = _tc_plan(shapes, str(w.device)), _bf16_plan(shapes, str(w.device))
    with torch.no_grad():
        flat = torch.cat([wl.detach().reshape(-1).to(torch.bfloat16) for wl, _ in w.layers[:-1]])
        src = torch.cat([flat, flat.new_zeros(1)])
        slabs = torch.index_select(src, 0, bp.index).view(-1, BF16_SLAB)
        vec = _tc_vec(w, plan.widths)
    return TcPacked(slabs=slabs, vec=vec, prog=plan.prog, widths=plan.widths, nfwd=bp.nfwd,
                    nbwd=bp.nbwd, zsum=plan.zsum, order=bp.order, bf16=True)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def pack_walk(w: FieldWeights) -> torch.Tensor:
    """The field kernels' encoder weights, as their walks read them (float4
    rows, csrc/field_kernels.cu's Walk), flat fp32: the forward walk's rows
    (J, E + F, R), for each joint its E hidden units then its F features,
    each a row of its E input weights, its bias and zeros to R = 4 ceil((E
    + 1) / 4) (``fused_encoder.pack_encoder``'s rows); then the reverse
    walk's rows of W2 (J, E, 4 ceil(F / 4)) and of W1 (J, E, 4 ceil(E / 4)),
    zero-padded. In bf16 w1 and w2 are rounded to bf16 (the products'
    operands), the biases not."""
    from posendf_torch.ops.fused_encoder import pack_encoder

    c = operand(w)
    with torch.no_grad():
        w1, w2 = (c(w.enc[k].detach().float()) for k in ("w1", "w2"))
        E, F = w1.shape[-1], w2.shape[-1]
        rows = pack_encoder(w1, w.enc["b1"], w2, w.enc["b2"])
        pad = torch.nn.functional.pad
        return torch.cat([rows.reshape(-1), pad(w2, (0, _round4(F) - F)).reshape(-1),
                          pad(w1, (0, _round4(E) - E)).reshape(-1)]).contiguous()


# How a bf16 result is held to a reference computed in bf16 elsewhere (the
# kernel to its plain version, the port to JAX). Both round the same operands
# to bf16, but their fp32 sums differ in order by a few units in the last
# place, and where a value lies that close to a bf16 rounding tie (or an
# activation's kink) the two round it to neighbouring bf16 values: the pose's
# result then moves by what one bf16 spacing of one operand carries to it,
# up to the order of the bf16-vs-fp32 gap itself. No per-pose bar both admits
# that and stays tight, so the hold is on shares and means, each against the
# gap (the same reference's distance from the fp32 result on the same poses).
# Each bar sits between the largest reading of a sound result and the
# smallest of a result with one rounding left out (CPU: the port's plain
# versions and module path against JAX's, 128 poses of seeded lrelu, relu
# and softplus fields and the trained field's 256 probes, with planted
# faults; H100: the kernels against their plain versions):
#  * a pose is off where any of its values differs by more than
#    atol + rtol |want| (the fp32 bars: summation order only); at most
#    BF16_OFF_SHARE of the poses may be off. Sound: up to 0.289 (the port's
#    module path g against JAX's on the seeded softplus field, whose g is
#    small), 0.172 for the plain kernel versions, 0.128 for the kernels on
#    the card. One rounding left out: 0.766 and more on what it touches (the
#    g cast before the 1024-wide layer's transposed product; the output
#    layer's operand; the encoder's), 1.0 for an fp32 result. At least
#    BF16_GAP_SHARE of the poses must be that far from the fp32 result, and
#    atol at most half the gap's median pose (asserted: the bar tells bf16
#    from fp32);
#  * the mean over poses of each pose's largest error is at most
#    BF16_MEAN_RATIO of the same mean of the gap. Sound: up to 0.103 (CPU,
#    as above), 0.051 on the card; the encoder's operands unrounded 0.58 and
#    more, an fp32 result 1.0. One cast dropped elsewhere can read as little
#    as 0.045 (the backward's) or 0.164 (the output layer's, on the trained
#    field): the share catches those;
#  * the largest error is at most BF16_MAX_RATIO of the largest gap: one
#    tie moves a pose by up to about the gap (sound: up to 0.685 on the
#    CPU), so a pose beyond twice the gap is a fault, not a tie.
# A fault in one CTA alone (a ragged tail, a later wave) can stay under the
# shares; the card checks those by moving the poses between CTAs
# (``chip_smoke.hold_reversed``, to the bit).
BF16_OFF_SHARE, BF16_GAP_SHARE, BF16_MEAN_RATIO, BF16_MAX_RATIO = 0.45, 0.8, 0.2, 2.0


def bf16_hold(name: str, got: torch.Tensor, want: torch.Tensor, fp32: torch.Tensor, *,
              atol: float, rtol: float = 0.0) -> dict:
    """Hold ``got`` to ``want`` (both bf16 results; the first dimension is
    the pose) by the rule above, ``fp32`` being the fp32 result on the same
    poses. Returns the measured shares and means; raises AssertionError."""
    got, want, fp32 = (t.detach().double().cpu().reshape(t.shape[0], -1)
                       for t in (got, want, fp32))
    if got.shape != want.shape or fp32.shape != want.shape:
        raise AssertionError(f"{name}: shapes {tuple(got.shape)}, {tuple(want.shape)}, "
                             f"{tuple(fp32.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    bar = atol + rtol * want.abs()
    err, gap = (got - want).abs(), (fp32 - want).abs()
    st = dict(off=float((err > bar).any(1).double().mean()),
              gap_off=float((gap > bar).any(1).double().mean()),
              mean=float(err.amax(1).mean()), gap_mean=float(gap.amax(1).mean()),
              max=float(err.max()), gap_max=float(gap.max()),
              gap_median=float(gap.amax(1).median()))
    msg = (f"{name}: {st['off']:.4f} of the poses beyond atol={atol} rtol={rtol} (bf16 vs fp32: "
           f"{st['gap_off']:.4f}); mean pose error {st['mean']:.3e} (gap {st['gap_mean']:.3e}); "
           f"max {st['max']:.3e} (gap {st['gap_max']:.3e})")
    if st["gap_off"] < BF16_GAP_SHARE or 2 * atol > st["gap_median"]:
        raise AssertionError(f"{msg}: the bar does not tell bf16 from fp32 "
                             f"(median gap {st['gap_median']:.3e})")
    if (st["off"] > BF16_OFF_SHARE or st["mean"] > BF16_MEAN_RATIO * st["gap_mean"]
            or st["max"] > BF16_MAX_RATIO * st["gap_max"]):
        raise AssertionError(msg)
    return st


# ---- the field kernels' launch plan ----
#
# A tile of 64 poses is one CTA, and one CTA fills an SM (255 registers a
# thread, ~226 KB of shared memory), so B poses take ceil(B / 64) tiles in
# waves of the SMs the kernel can hold; a last wave of a few tiles leaves
# most SMs idle for a whole tile's time. The plan launches the tiles of that
# wave split by output columns across the two CTAs of a thread-block
# cluster (csrc/field_kernels.cu, kSplit), in the same launch as the others.

TILE_POSES = 64          # poses a tile: one wgmma M
SPLIT_SIZES = (2,)       # the cluster sizes a plan may split a tile across


class LaunchPlan(NamedTuple):
    """A field kernel's launch over ``tiles`` tiles of 64 poses: the first
    ``full`` tiles a CTA each, then ``rem`` tiles each split across a cluster
    of ``split`` CTAs (``split`` 1: every tile a CTA, ``full`` = ``tiles``);
    ``ctas`` CTAs in all."""

    tiles: int
    full: int
    rem: int
    split: int
    ctas: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, slots: Tuple[Tuple[int, int], ...],
                sizes: Tuple[int, ...] = SPLIT_SIZES) -> LaunchPlan:
    """The launch plan of B poses, where ``slots`` gives (c, S) pairs: the
    CTAs S that clusters of c keep resident at once (c = 1: a launch without
    clusters). With T tiles, a cluster size c of ``sizes`` may split the
    remainder R = T mod S_c (T itself when T < S_c) if R c <= S_c and the
    full waves before it, T // S_c, are fewer than a launch without clusters
    takes, ceil(T / S_1) (a cluster launch holds all its CTAs, the full
    tiles' too, to S_c, which may be below S_1). Of those, the fewest full
    waves, then the largest c; the T - R full tiles (a multiple of S_c, so of
    c) go first, a CTA each. With none, every tile is a CTA (``split`` 1)."""
    tiles = -(-B // TILE_POSES)
    have = dict(slots)
    plain = have.get(1, 0)
    best = None
    for c in sizes:
        S = have.get(c, 0)
        if c < 2 or S < c or plain < 1:
            continue
        rem = tiles % S if tiles >= S else tiles
        waves = tiles // S
        if rem == 0 or rem * c > S or waves >= -(-tiles // plain):
            continue
        if best is None or (waves, -c) < (best[0], -best[1]):
            best = (waves, c, rem)
    if best is None:
        return LaunchPlan(tiles, tiles, 0, 1, tiles)
    _, c, rem = best
    return LaunchPlan(tiles, tiles - rem, rem, c, tiles - rem + rem * c)


_SLOTS: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]] = {}


def _cluster_slots(device: torch.device, act: int) -> Tuple[Tuple[int, int], ...]:
    """(c, S) for c = 1 and each of ``SPLIT_SIZES``: the resident CTAs of the
    3xTF32 kernel of ``act`` without clusters and in clusters of c on
    ``device``, asked of the runtime once."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), act)
    if key not in _SLOTS:
        lib = _build.library()
        with torch.cuda.device(key[0]):
            slots = tuple((c, lib.posendf_field_cluster_slots(act, c)) for c in (1,) + SPLIT_SIZES)
        for c, S in slots:
            if S < 0:
                _build.check(-S, f"posendf_field_cluster_slots(cluster={c})")
        _SLOTS[key] = slots
    return _SLOTS[key]


def plan_launch(quat: torch.Tensor, weights: "FieldWeights") -> LaunchPlan:
    """The launch plan of the field kernels for these CUDA poses and field
    (cached): :func:`launch_plan` over ``SPLIT_SIZES`` for the 3xTF32 route;
    a CTA a tile for a bf16 field."""
    B = quat.shape[0]
    if weights.bf16:
        return launch_plan(B, ())
    slots = _cluster_slots(quat.device, _build.ACT_CODES[weights.activation])
    return launch_plan(B, slots, SPLIT_SIZES)


def state_kind(weights: "FieldWeights") -> str:
    """The derivative state the value-and-grad and projection-step kernels
    keep for the backward, by the field's activation (both routes): "bits",
    one a unit and pose (lrelu and relu, whose act' takes two values), or
    "slope", softplus's act'(z) = sigmoid(beta z) in fp32, made from the exp
    its forward takes (``common.cuh``'s ``softplus_slope``)."""
    return "slope" if weights.activation == "softplus" else "bits"


def check_poses(quat: torch.Tensor, weights: FieldWeights) -> None:
    """Raise on any pose tensor the kernels (or their plain versions) do not take."""
    J = weights.num_joints
    if quat.dim() != 3 or quat.shape[1:] != (J, 4):
        raise ValueError(f"poses must have shape (B, {J}, 4), got {tuple(quat.shape)}")
    if quat.dtype != torch.float32:
        raise TypeError(f"poses must be float32, got {quat.dtype}")
    if quat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"poses must be on the CPU or a CUDA device, got {quat.device}")
    if quat.device != weights.device:
        raise ValueError(f"poses on {quat.device} but the field's weights on {weights.device}")


def aligned_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read their inputs: contiguous and 16-byte
    aligned. A strided or permuted view (or a view at an odd offset) is
    copied, as JAX takes any array; the copy is differentiable."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def common_args(quat: torch.Tensor, weights: FieldWeights, plan: LaunchPlan) -> list:
    """The launchers' leading arguments, shared by the three kernels (the
    encoder's weights as :func:`pack_walk` rows): then the route (0: 3xTF32,
    1: bf16), the launch plan's full tiles and cluster size and, for a split,
    :meth:`TcPacked.split_slabs`."""
    pk, tc = weights.packed(), weights.tc_packed()
    split_slabs = tc.split_slabs(plan.split).data_ptr() if plan.split > 1 else None
    return [quat.data_ptr(), quat.shape[0], weights.walk_packed().data_ptr(),
            pk.parents.data_ptr(), weights.num_joints, weights.feature_size, tc.slabs.data_ptr(), tc.vec.data_ptr(),
            tc.prog.data_ptr(), tc.nfwd, tc.nbwd, _build.ACT_CODES[weights.activation],
            weights.beta, int(tc.bf16), plan.full, plan.split, split_slabs]


def packed_once(cache: Dict[tuple, tuple], tensors: Tuple[torch.Tensor, ...], pack,
                limit: int = 4) -> torch.Tensor:
    """``pack(*tensors)``, cached in ``cache`` by the tensors' addresses,
    shapes and device and by ``pack``; the entry holds the tensors, so their
    addresses are not reused while it is cached, and an in-place change of
    any of them (its ``_version``, as an optimizer step makes) packs them
    anew. The last ``limit`` packings are kept."""
    key = (pack.__name__,) + tuple((t.data_ptr(), tuple(t.shape), str(t.device)) for t in tensors)
    version = tuple(t._version for t in tensors)
    hit = cache.pop(key, None)
    if hit is None or hit[1] != version:
        hit = (tensors, version, pack(*tensors))
    cache[key] = hit
    while len(cache) > limit:
        del cache[next(iter(cache))]
    return hit[2]


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def operand(weights: FieldWeights):
    """How the kernels take a product's operands: as they are (fp32), or
    rounded to bf16 (:func:`~posendf_torch.models.dfnet.bf16_round`)."""
    return bf16_round if weights.bf16 else (lambda t: t)


def field_forward_ref(x: torch.Tensor, weights: FieldWeights, keep: bool = False):
    """Plain forward over pre-normalized poses x (B, J, 4), walking the joints
    in index order as the kernel does. Returns d (B, 1) and, with ``keep``,
    the pre-activations the backward needs: (encoder h, encoder f, DFNet z).
    In bf16 both operands of every product are rounded to bf16 (the poses, a
    parent's feature, h, every DFNet input; the weights) and their products
    summed in fp32, as the TPU kernel's ``cast`` rounds them."""
    act, out_act = resolve(weights.activation, weights.beta)
    c = operand(weights)
    w1, b1, w2, b2 = (weights.enc[k] for k in ("w1", "b1", "w2", "b2"))
    w1, w2 = c(w1), c(w2)
    B, F = x.shape[0], weights.feature_size
    zero = x.new_zeros((B, F))
    feats, zh, zf = [], [], []
    for j, p in enumerate(weights.parents):
        inp = torch.cat([x[:, j], zero if p == -1 else feats[p]], dim=-1)   # (B, 4+F)
        zh.append(torch.matmul(c(inp), w1[j]) + b1[j])
        zf.append(torch.matmul(c(act(zh[j])), w2[j]) + b2[j])
        feats.append(act(zf[j]))
    h = torch.cat(feats, dim=-1)
    zs = []
    L = len(weights.layers)
    for l, (w, b) in enumerate(weights.layers):
        z = torch.matmul(c(h), c(w)) + b
        if l < L - 1:
            zs.append(z)
            h = act(z)
        else:
            h = out_act(z)
    return (h, (zh, zf, zs)) if keep else h


def fused_posendf_forward_ref(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (B, J, 4) -> (B, 1)."""
    return field_forward_ref(joint_axis_normalize(quat), weights)


def _launch_forward(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty((quat.shape[0], 1), dtype=torch.float32, device=quat.device)
    lib = _build.library()
    plan = plan_launch(quat, weights)
    _build.check(lib.posendf_forward(*common_args(quat, weights, plan), out.data_ptr(),
                                     stream_handle(quat)), "posendf_forward")
    LAUNCHES += 1
    SPLIT_LAUNCHES[plan.split] += 1
    return out


def replay_backward(plain, inp: torch.Tensor, params: List[torch.Tensor], grad: torch.Tensor,
                    needs_inp: bool) -> tuple:
    """Backward of a kernel's ``autograd.Function``: differentiate its plain
    version ``plain(inp)`` (which reads ``params``) at the saved input.

    With grad mode on inside the backward (an outer ``create_graph=True``,
    as the eikonal term's gradient-of-a-gradient takes it), the gradients
    are built with ``create_graph`` from the caller's own input, so they can
    be differentiated again, with respect to the parameters and the input.
    Returns the input's gradient (None unless ``needs_inp``), then one per
    parameter (None for a frozen one)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = inp if (create and inp.requires_grad) else inp.detach().requires_grad_(True)
        live = [p for p in params if p.requires_grad]
        out = plain(x)
        grads = iter(torch.autograd.grad(out, [x] + live, grad, allow_unused=True,
                                         create_graph=create))
    g_inp = next(grads)
    return (g_inp if needs_inp else None,) + tuple(
        next(grads) if p.requires_grad else None for p in params)


class _FusedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quat, weights, *params):
        ctx.weights = weights
        ctx.save_for_backward(quat)
        if quat.device.type == "cpu":
            return fused_posendf_forward_ref(quat, weights)
        return _launch_forward(quat, weights)

    @staticmethod
    def backward(ctx, grad):
        (quat,) = ctx.saved_tensors
        weights = ctx.weights
        if weights.bf16:
            # as JAX's custom_vjp refuses it: its fallback is the fp32 function's gradient
            raise NotImplementedError(
                "differentiating through the fused whole-model forward with "
                "compute_dtype='bfloat16' is unsupported; use the module path "
                "(Field.distance / distance_and_grad) for gradients")
        g_quat, *g_params = replay_backward(
            lambda q: fused_posendf_forward_ref(q, weights), quat, weights.tensors(), grad,
            ctx.needs_input_grad[0])
        return (g_quat, None, *g_params)


def fused_posendf_forward(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    """Whole-model forward: (B, J, 4) -> (B, 1) distances.

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version; both are differentiable, twice (the backward is the plain
    version's, see :func:`replay_backward`), but for a bf16 field, whose
    backward raises, as JAX's does.
    """
    check_poses(quat, weights)
    if quat.device.type == "cuda":
        quat = aligned_contiguous(quat)
    return _FusedForward.apply(quat, weights, *weights.tensors())
