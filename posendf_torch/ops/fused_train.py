"""The full training gradient in two CUDA kernels per step.

Port of ``posendf_tpu/ops/fused_train.py::_train_kernel`` (its
``fused_train_grads``): ``(total, terms, grads)`` of
``losses.training_loss``, with the gradient keyed like the port's
``PoseNDF.state_dict()``. The kernels are ``posendf_train_tile`` (both
branches in one launch, the noisy CTAs first) and ``posendf_train_reduce`` in
``csrc/train_kernels.cu``; the source's header explains the split and why
one batch product per branch suffices for lrelu/relu.

Both kernels run the DFNet's products on the tensor cores in 3xTF32 (each
operand split as :func:`tf32_split` models it): the tile kernel in 64-pose
CTAs from the field kernels' weight slabs (``fused_model.pack_tc``, packed
anew for every step's weights), the reduction from the scratch rows.
``fused_train_grads`` launches them for CUDA tensors. For CPU tensors it
runs their plain version, ``ops/train_grad.manual_train_grads``, which the
tests hold to the JAX kernel. Each kernel also has a plain version of its
own part, which ``chip_smoke.py`` holds it to on the card: ``branch_ref``
(the tile kernel's per-row products a_l = dd x_l + ecx_l and c_l, the
encoder gradient and the loss sums of one branch, as :class:`BranchRows`)
and ``reduce_ref`` (the batch products).

Like the JAX kernel: lrelu/relu and fp32 only; the term weights apply to the
gradient, ``terms`` are unweighted; the outputs carry no autograd graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from posendf_torch import _build
from posendf_torch.ops.fused_model import FieldWeights, aligned_contiguous, stream_handle
from posendf_torch.ops.train_grad import manual_train_grads

__all__ = ["fused_train_grads", "BranchRows", "branch_args",
           "branch_ref", "reduce_ref", "tf32_split", "TileOut", "launch_tiles", "launch_reduce",
           "TILE_LAUNCHES", "TILE_WALK_LAUNCHES", "REDUCE_LAUNCHES", "walk_width"]

# launches of each kernel since its count was last set to 0; the tile's also
# by the walk its encoder phases took (walk_width)
TILE_LAUNCHES = 0
TILE_WALK_LAUNCHES = {"compiled": 0, "runtime": 0}
REDUCE_LAUNCHES = 0

_EPS2 = 1e-24     # joint_axis_normalize guard (eps = 1e-12 squared)
_EIK_EPS = 1e-12  # the eikonal norm's epsilon (losses.py)


def walk_width(feature_size: int, lib=None) -> str:
    """Which walk the tile kernel's encoder phases take for a feature width,
    as the train library (``lib``, by default the built one) says:
    ``"compiled"`` (the width its walks know at compile time, the SMPL
    fields' 6) or ``"runtime"`` (any other width it takes)."""
    code = (lib or _build.library("train")).posendf_train_tile_walk(feature_size)
    if code < 0:
        raise ValueError(f"the train tile kernel takes no feature size {feature_size}")
    return "compiled" if code else "runtime"


def _check_args(w: FieldWeights, pose, dist_gt, man_poses, loss_type: str,
                compute_dtype: str) -> None:
    if w.activation not in ("lrelu", "relu"):
        raise ValueError(
            f"fused_train_grads supports lrelu/relu (got {w.activation!r}); "
            "use ops.train_grad.manual_train_grads or autodiff for softplus")
    if compute_dtype != "float32" or w.bf16:
        raise ValueError(
            "fused_train_grads computes parameter gradients in fp32 only "
            f"(got compute_dtype={compute_dtype!r}, a field of "
            f"{w.compute_dtype!r}); bf16 buys no speed "
            "here and corrupts near-cancelling gradient sums")
    if loss_type not in ("l1", "l2"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    J = w.num_joints
    for name, t in (("pose", pose), ("man_poses", man_poses)):
        if t.dim() != 3 or t.shape[1:] != (J, 4) or t.shape[0] < 1:
            raise ValueError(f"{name} must have shape (N >= 1, {J}, 4), got {tuple(t.shape)}")
    if dist_gt.shape != (pose.shape[0],):
        raise ValueError(f"dist_gt must have shape ({pose.shape[0]},), got {tuple(dist_gt.shape)}")
    for name, t in (("pose", pose), ("dist_gt", dist_gt), ("man_poses", man_poses)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} on {t.device} but the field's weights on {w.device}")


@dataclass
class BranchRows:
    """What one branch leaves for the reduction, in the plain layout."""

    a: List[torch.Tensor]        # per layer (rows, in_l): dd x_l (+ ecx_l on the noisy branch)
    c: List[torch.Tensor]        # per layer (rows, out_l): c_l
    dd: torch.Tensor             # (rows,) the loss's cotangent on d
    enc: Dict[str, torch.Tensor]  # the branch's encoder gradient, w1 b1 w2 b2
    loss: torch.Tensor           # (2,) sum of the distance term, of the eikonal term


def branch_ref(w: FieldWeights, q, gt, *, eikonal: bool, l2: bool, dd_coef: float,
               eik_coef: float) -> BranchRows:
    """Plain version of the tile kernel: one branch, vectorized over all its
    rows (``eikonal=True``: the noisy poses with labels ``gt``; ``False``: the
    manifold poses, unnormalized, ``gt`` zeros)."""
    relu = w.activation == "relu"
    act = torch.relu if relu else (lambda z: torch.where(z >= 0, z, 0.01 * z))

    def d1(z):
        return (z > 0).to(z.dtype) if relu else torch.where(z >= 0, 1.0, 0.01).to(z.dtype)

    w1, b1, w2, b2 = (w.enc[k] for k in ("w1", "b1", "w2", "b2"))
    Ws = [wl for wl, _ in w.layers]
    bs = [bl for _, bl in w.layers]
    L, J, F, R = len(Ws), w.num_joints, w.feature_size, q.shape[0]

    # A. normalization, encoder and DFNet forward
    if eikonal:
        s = torch.sum(q * q, dim=1, keepdim=True)
        n = torch.sqrt(torch.clamp_min(s, _EPS2))
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
    xs, ss = [torch.cat(feat, dim=-1)], []
    for l in range(L):
        z = xs[-1] @ Ws[l] + bs[l]
        if l < L - 1:
            ss.append(d1(z))
            xs.append(act(z))
    d = torch.relu(z)[:, 0]

    # A/B. distance loss and its cotangent
    r = d - gt
    if l2:
        lsum, dd = torch.sum(r * r), dd_coef * 2.0 * r
    else:
        lsum, dd = torch.sum(torch.abs(r)), dd_coef * torch.sign(r)

    # A. inner pullback, unit cotangent
    cs = [None] * L
    cs[L - 1] = (d > 0).to(q.dtype)[:, None]
    for l in range(L - 1, 0, -1):
        cs[l - 1] = (cs[l] @ Ws[l].T) * ss[l - 1]
    gfeat = list((cs[0] @ Ws[0].T).reshape(R, J, F).unbind(1))
    gx, gh, gf = [None] * J, [None] * J, [None] * J
    for j in range(J - 1, -1, -1):
        gf[j] = gfeat[j] * d1(zf[j])
        gh[j] = (gf[j] @ w2[j].T) * d1(zh[j])
        gin = gh[j] @ w1[j].T
        gx[j] = gin[:, :4]
        if w.parents[j] >= 0:
            gfeat[w.parents[j]] = gfeat[w.parents[j]] + gin[:, 4:]

    # encoder per-pose vectors: L1 = dd inp (+ egin), L2 = dd h (+ ea)
    l1 = [dd[:, None] * inp[j] for j in range(J)]
    l2v = [dd[:, None] * act(zh[j]) for j in range(J)]
    a_rows = [dd[:, None] * xl for xl in xs]
    esum = q.new_zeros(())
    if eikonal:
        # B. normalization VJP, eikonal term, its cotangent through the adjoint
        gx = torch.stack(gx, dim=1)
        guard = (s >= _EPS2).to(q.dtype)
        coef = guard / (n * n * n)
        gq = gx / n - q * (torch.sum(gx * q, dim=1, keepdim=True) * coef)
        gn = torch.sqrt(torch.sum(gq * gq, dim=-1) + _EIK_EPS)
        esum = torch.sum((gn - 1.0) ** 2)
        Ggq = eik_coef * ((gn - 1.0) / gn)[..., None] * gq
        Ggx = Ggq / n - q * (torch.sum(Ggq * q, dim=1, keepdim=True) * coef)
        # C. e-chain: encoder half, then DFNet half (a_l += ecx_l)
        efeat = [None] * J
        for j in range(J):
            p = w.parents[j]
            egin = torch.cat([Ggx[:, j], q.new_zeros((R, F)) if p < 0 else efeat[p]], dim=-1)
            ea = (egin @ w1[j]) * d1(zh[j])
            efeat[j] = (ea @ w2[j]) * d1(zf[j])
            l1[j] = l1[j] + egin
            l2v[j] = l2v[j] + ea
        ecx = torch.cat(efeat, dim=-1)
        for l in range(L):
            a_rows[l] = a_rows[l] + ecx
            if l < L - 1:
                ecx = (ecx @ Ws[l]) * ss[l]

    enc = {"w1": torch.stack([l1[j].T @ gh[j] for j in range(J)]),
           "b1": torch.stack([dd @ gh[j] for j in range(J)]),
           "w2": torch.stack([l2v[j].T @ gf[j] for j in range(J)]),
           "b2": torch.stack([dd @ gf[j] for j in range(J)])}
    return BranchRows(a=a_rows, c=cs, dd=dd, enc=enc, loss=torch.stack([lsum, esum]))


def reduce_ref(w: FieldWeights, noisy: BranchRows, man: BranchRows):
    """Plain version of the reduction: the gradient keyed like the state
    dict, and the three loss sums (noisy distance, noisy eikonal, manifold
    distance)."""
    grads = {f"enc.{k}": noisy.enc[k] + man.enc[k] for k in ("w1", "b1", "w2", "b2")}
    for l in range(len(w.layers)):
        grads[f"dfnet.w{l}"] = noisy.a[l].T @ noisy.c[l] + man.a[l].T @ man.c[l]
        grads[f"dfnet.b{l}"] = noisy.dd @ noisy.c[l] + man.dd @ man.c[l]
    return grads, torch.stack([noisy.loss[0], noisy.loss[1], man.loss[0]])


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction kernel's 3xTF32 split of fp32 values: hi = tf32(x) and
    lo = tf32(x - hi), where tf32 rounds to 10 mantissa bits, to nearest
    with ties away from zero (``cvt.rna.tf32.f32``; ``csrc/hopper.cuh``
    ``tf32_round``), kept as fp32 with the low 13 bits zero. The kernel sums
    lo.hi' + hi.lo' + hi.hi' for each product of x and x'."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def branch_args(w: FieldWeights, pose, dist_gt, man_poses, loss_type, weight_dist, weight_man,
              weight_eikonal):
    """The two branches' keyword arguments: the loss's per-row scales."""
    B, M, J = pose.shape[0], man_poses.shape[0], w.num_joints
    return (dict(eikonal=True, l2=loss_type == "l2", dd_coef=weight_dist / B,
                 eik_coef=2.0 * weight_eikonal / (B * J)),
            dict(eikonal=False, l2=False, dd_coef=weight_man / M, eik_coef=0.0))


def state_dict(w: FieldWeights) -> Dict[str, torch.Tensor]:
    """The weights keyed like ``PoseNDF.state_dict()``."""
    params = {f"enc.{k}": v for k, v in w.enc.items()}
    for l, (wl, bl) in enumerate(w.layers):
        params[f"dfnet.w{l}"], params[f"dfnet.b{l}"] = wl, bl
    return params


def _terms(loss, B, M, J, weight_dist, weight_man, weight_eikonal):
    terms = {"dist": loss[0] / B, "man_loss": loss[2] / M, "eikonal": loss[1] / (B * J)}
    total = (weight_dist * terms["dist"] + weight_man * terms["man_loss"]
             + weight_eikonal * terms["eikonal"])
    return total, terms


@dataclass
class TileOut:
    """What the tile kernel leaves for the reduction, for one branch."""

    a_scr: torch.Tensor     # per layer a (rows, in_l) block: a_l (noisy) or x_l (manifold)
    c_scr: torch.Tensor     # per layer a (rows, out_l) block: c_l
    dd: torch.Tensor        # (rows,) the loss's cotangent on d
    enc_slot: torch.Tensor  # (CTAs, encoder floats): each CTA's encoder gradient
    loss_slot: torch.Tensor  # (CTAs, 2): each CTA's distance and eikonal sums
    rows: int
    eikonal: bool

    def branch_rows(self, w: FieldWeights) -> BranchRows:
        """The same values in the plain layout (views of the scratch; the
        manifold rows scaled by dd as the reduction scales them), so the
        plain reduction can run on what the kernel wrote."""
        a, c, oa, oc = [], [], 0, 0
        for wl, _ in w.layers:
            fan_in, fan_out = wl.shape
            x = self.a_scr[oa:oa + self.rows * fan_in].view(self.rows, fan_in)
            a.append(x if self.eikonal else self.dd[:, None] * x)
            c.append(self.c_scr[oc:oc + self.rows * fan_out].view(self.rows, fan_out))
            oa, oc = oa + self.rows * fan_in, oc + self.rows * fan_out
        enc, flat, off = {}, self.enc_slot.sum(0), 0
        for k in ("w1", "b1", "w2", "b2"):
            n = w.enc[k].numel()
            enc[k] = flat[off:off + n].view(w.enc[k].shape)
            off += n
        return BranchRows(a=a, c=c, dd=self.dd, enc=enc, loss=self.loss_slot.sum(0))


def launch_tiles(w: FieldWeights, pose: torch.Tensor, gt: torch.Tensor, man: torch.Tensor,
                 kw_n: dict, kw_m: dict) -> Tuple[TileOut, TileOut]:
    """The tile kernel over both branches in one launch: the noisy poses
    ``pose`` with labels ``gt`` and the manifold poses ``man``, each with its
    :func:`branch_args`."""
    global TILE_LAUNCHES
    pk, tc = w.packed(), w.tc_packed()
    lib = _build.library("train")
    J, F = w.num_joints, w.feature_size
    width = walk_width(F, lib)
    ins = sum(wl.shape[0] for wl, _ in w.layers)
    outs = sum(wl.shape[1] for wl, _ in w.layers)
    args, tiles = [], []
    for q, labels, kw in ((pose, gt, kw_n), (man, None, kw_m)):
        rows, dev = q.shape[0], q.device
        ctas = lib.posendf_train_tile_ctas(rows)
        out = TileOut(a_scr=torch.empty(rows * ins, dtype=torch.float32, device=dev),
                      c_scr=torch.empty(rows * outs, dtype=torch.float32, device=dev),
                      dd=torch.empty(rows, dtype=torch.float32, device=dev),
                      enc_slot=torch.empty((ctas, pk.enc.numel()), dtype=torch.float32,
                                           device=dev),
                      loss_slot=torch.empty((ctas, 2), dtype=torch.float32, device=dev),
                      rows=rows, eikonal=kw["eikonal"])
        scratch = torch.empty(lib.posendf_train_tile_scratch_floats(rows, J, F, tc.zsum),
                              dtype=torch.float32, device=dev)
        args += [q.data_ptr(), rows, None if labels is None else labels.data_ptr(),
                 float(kw["dd_coef"]), out.a_scr.data_ptr(), out.c_scr.data_ptr(),
                 out.dd.data_ptr(), out.enc_slot.data_ptr(), out.loss_slot.data_ptr(),
                 scratch.data_ptr()]
        tiles.append((out, scratch))
    _build.check(lib.posendf_train_tile(
        pk.enc.data_ptr(), pk.parents.data_ptr(), J, F, tc.slabs.data_ptr(), tc.vec.data_ptr(),
        tc.prog.data_ptr(), tc.nfwd, tc.nbwd, pk.meta.data_ptr(), pk.num_layers,
        _build.ACT_CODES[w.activation], int(kw_n["l2"]), float(kw_n["eik_coef"]), *args,
        stream_handle(pose)), "posendf_train_tile", "train")
    TILE_LAUNCHES += 1
    TILE_WALK_LAUNCHES[width] += 1
    return tiles[0][0], tiles[1][0]


def launch_reduce(w: FieldWeights, noisy: TileOut, man: TileOut):
    """The reduction over both branches: the flat gradient (encoder, then
    per layer W and b) and the three loss sums (noisy distance, noisy
    eikonal, manifold distance)."""
    global REDUCE_LAUNCHES
    pk = w.packed()
    dev = noisy.dd.device
    lib = _build.library("train")
    n = pk.enc.numel() + sum(wl.numel() + bl.numel() for wl, bl in w.layers)
    flat = torch.empty(n, dtype=torch.float32, device=dev)
    loss = torch.empty(3, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.posendf_train_reduce_partial_floats(
        pk.meta_host.data_ptr(), pk.num_layers, noisy.rows, man.rows),
        dtype=torch.float32, device=dev)
    # the reduction sums the noisy CTAs' slots, then the manifold's
    enc_slot = torch.cat([noisy.enc_slot, man.enc_slot])
    loss_slot = torch.cat([noisy.loss_slot, man.loss_slot])
    _build.check(lib.posendf_train_reduce(
        pk.meta.data_ptr(), pk.meta_host.data_ptr(), pk.num_layers, noisy.a_scr.data_ptr(),
        noisy.c_scr.data_ptr(), noisy.dd.data_ptr(), noisy.rows, man.a_scr.data_ptr(),
        man.c_scr.data_ptr(), man.dd.data_ptr(), man.rows, enc_slot.data_ptr(),
        loss_slot.data_ptr(), noisy.enc_slot.shape[0], man.enc_slot.shape[0], w.num_joints,
        w.feature_size, partial.data_ptr(), flat.data_ptr(), loss.data_ptr(),
        stream_handle(flat)), "posendf_train_reduce", "train")
    REDUCE_LAUNCHES += 1
    return flat, loss


def _launch(w: FieldWeights, pose, dist_gt, man_poses, *, loss_type: str, weight_dist: float,
            weight_man: float, weight_eikonal: float):
    kw_n, kw_m = branch_args(w, pose, dist_gt, man_poses, loss_type, weight_dist, weight_man,
                           weight_eikonal)
    noisy, man = launch_tiles(w, aligned_contiguous(pose), dist_gt.contiguous(),
                              aligned_contiguous(man_poses), kw_n, kw_m)
    flat, loss = launch_reduce(w, noisy, man)
    grads, off = {}, 0
    for k in ("w1", "b1", "w2", "b2"):
        n = w.enc[k].numel()
        grads[f"enc.{k}"] = flat[off:off + n].view(w.enc[k].shape)
        off += n
    for l, (wl, bl) in enumerate(w.layers):
        grads[f"dfnet.w{l}"] = flat[off:off + wl.numel()].view(wl.shape)
        off += wl.numel()
        grads[f"dfnet.b{l}"] = flat[off:off + bl.numel()].view(bl.shape)
        off += bl.numel()
    return _terms(loss, pose.shape[0], man_poses.shape[0], w.num_joints, weight_dist,
                  weight_man, weight_eikonal) + (grads,)


def fused_train_grads(w: FieldWeights, pose: torch.Tensor, dist_gt: torch.Tensor,
                      man_poses: torch.Tensor, *, loss_type: str = "l1",
                      weight_dist: float = 1.0, weight_man: float = 1.0,
                      weight_eikonal: float = 1.0, compute_dtype: str = "float32"
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Fused equivalent of autodiff of ``losses.training_loss`` over the
    noisy poses ``pose`` (B, J, 4) with labels ``dist_gt`` (B,) and the
    manifold poses ``man_poses`` (M, J, 4): returns ``(total, terms,
    grads)``, ``grads`` keyed like ``PoseNDF.state_dict()``.

    CUDA tensors go through the two kernels (one tile launch, the reduction's
    two), CPU tensors through the plain version, ``manual_train_grads``.
    Deterministic: two calls give the same bits.
    """
    J = w.num_joints
    pose = pose.reshape(-1, J, 4)
    man_poses = man_poses.reshape(-1, J, 4)
    dist_gt = dist_gt.reshape(-1)
    _check_args(w, pose, dist_gt, man_poses, loss_type, compute_dtype)
    kw = dict(loss_type=loss_type, weight_dist=weight_dist, weight_man=weight_man,
              weight_eikonal=weight_eikonal)
    if pose.device.type == "cpu":
        return manual_train_grads(state_dict(w), pose, dist_gt, man_poses, parents=w.parents,
                                  activation=w.activation, beta=w.beta, **kw)
    return _launch(w, pose, dist_gt, man_poses, **kw)
