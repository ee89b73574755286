"""Hand-derived parameter gradients of the full training objective.

Port of ``posendf_tpu/ops/train_grad.py::manual_train_grads``: ``(total,
terms, dL/dparams)`` of ``losses.training_loss`` (distance + manifold +
eikonal) with every derivative written out as explicit matmul chains, no
autograd. In the JAX package it is the oracle the fused train kernel is
pinned to; here it is the plain version that ``chip_smoke.py`` holds the
CUDA train kernels to on the card, and it covers softplus, which the kernels
refuse.

The four traversals (see the JAX module for the derivation):

  A. primal forward through the joint-axis normalization, and the inner
     pullback with a unit cotangent on d (c_l, and the encoder's gh, gf, gx);
  B. the loss cotangents: dd on d, and the eikonal term's pose-gradient
     cotangent taken back through the (symmetric) normalization VJP;
  C. the e-chain: reverse mode through the pullback, walked in the primal
     direction, emitting the second-order weight-gradient terms (and, for
     softplus, act'' cotangents fed into D);
  D. the combined downward backward, plus the first-order manifold branch.

Parameters and gradients are keyed like the port's ``PoseNDF.state_dict()``
(``enc.w1``, ..., ``dfnet.w0``, ``dfnet.b0``, ...).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["manual_train_grads", "num_layers"]

_EPS2 = 1e-24   # joint_axis_normalize guard (eps = 1e-12 squared)
_EIK_EPS = 1e-12


def _act_fns(activation: str, beta: float):
    """(act, act', act'', out_act', out_act'', out_act) with the derivative
    conventions of JAX's autodiff (lrelu'(0) = 1, relu'(0) = 0)."""
    if activation == "lrelu":
        def act(z):
            return torch.where(z >= 0, z, 0.01 * z)

        def d1(z):
            return torch.where(z >= 0, 1.0, 0.01).to(z.dtype)

        def od1(z):
            return (z > 0).to(z.dtype)

        return act, d1, None, od1, None, torch.relu
    if activation == "relu":
        def d1(z):
            return (z > 0).to(z.dtype)

        return torch.relu, d1, None, d1, None, torch.relu
    if activation == "softplus":
        def act(z):
            return torch.logaddexp(beta * z, torch.zeros_like(z)) / beta

        def d1(z):
            return torch.sigmoid(beta * z)

        def d2(z):
            s = torch.sigmoid(beta * z)
            return beta * s * (1.0 - s)

        return act, d1, d2, d1, d2, act
    raise ValueError(f"unknown activation {activation!r}")


def num_layers(params: Mapping[str, torch.Tensor]) -> int:
    n = 0
    while f"dfnet.w{n}" in params:
        n += 1
    return n


@torch.no_grad()
def manual_train_grads(params: Mapping[str, torch.Tensor], pose: torch.Tensor,
                       dist_gt: torch.Tensor, man_poses: torch.Tensor, *,
                       parents: Tuple[int, ...], activation: str = "lrelu", beta: float = 100.0,
                       loss_type: str = "l1", weight_dist: float = 1.0, weight_man: float = 1.0,
                       weight_eikonal: float = 1.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Explicit-chain equivalent of autodiff of ``losses.training_loss``:
    returns ``(total, terms, grads)``, fp32."""
    act, d1, d2, od1, od2, out_act = _act_fns(activation, beta)
    L = num_layers(params)
    J = len(parents)
    w1, b1, w2, b2 = (params[f"enc.{k}"] for k in ("w1", "b1", "w2", "b2"))
    W = [params[f"dfnet.w{l}"] for l in range(L)]
    bias = [params[f"dfnet.b{l}"] for l in range(L)]
    pose = pose.reshape(-1, J, 4)
    man_poses = man_poses.reshape(-1, J, 4)
    dist_gt = dist_gt.reshape(-1)
    B, M, F = pose.shape[0], man_poses.shape[0], w2.shape[-1]

    # ---------------- A. primal: normalize + forward + inner pullback -----
    s_n = torch.sum(pose * pose, dim=1, keepdim=True)               # (B, 1, 4)
    n = torch.sqrt(torch.clamp_min(s_n, _EPS2))
    x_in = pose / n

    def enc_forward(x, rows):
        feat, inp, h, zh, zf = [None] * J, [None] * J, [None] * J, [None] * J, [None] * J
        for j in range(J):
            p = parents[j]
            pf = x.new_zeros((rows, F)) if p < 0 else feat[p]
            inp[j] = torch.cat([x[:, j, :], pf], dim=-1)
            zh[j] = inp[j] @ w1[j] + b1[j]
            h[j] = act(zh[j])
            zf[j] = h[j] @ w2[j] + b2[j]
            feat[j] = act(zf[j])
        return feat, inp, h, zh, zf

    feat, inp, h, zh, zf = enc_forward(x_in, B)
    sh = [d1(z) for z in zh]
    sf = [d1(z) for z in zf]
    xs, ss, zs = [torch.cat(feat, dim=-1)], [], []
    for l in range(L):
        z = xs[-1] @ W[l] + bias[l]
        zs.append(z)
        if l < L - 1:
            ss.append(d1(z))
            xs.append(act(z))
    d = out_act(zs[-1])                                             # (B, 1)

    c, cx = [None] * L, [None] * L
    c[L - 1] = od1(zs[-1])
    for l in range(L - 1, 0, -1):
        cx[l] = c[l] @ W[l].T
        c[l - 1] = cx[l] * ss[l - 1]
    cx[0] = c[0] @ W[0].T
    gfeat = list(cx[0].reshape(B, J, F).unbind(1))
    gx, gh, gf = [None] * J, [None] * J, [None] * J
    for j in range(J - 1, -1, -1):
        gf[j] = gfeat[j] * sf[j]
        gh[j] = (gf[j] @ w2[j].T) * sh[j]
        gin = gh[j] @ w1[j].T
        gx[j] = gin[:, :4]
        if parents[j] >= 0:
            gfeat[parents[j]] = gfeat[parents[j]] + gin[:, 4:]
    gx = torch.stack(gx, dim=1)                                     # (B, J, 4)

    guard = (s_n >= _EPS2).to(pose.dtype)
    dot = torch.sum(gx * pose, dim=1, keepdim=True)
    gq = gx / n - pose * (dot * guard / (n * n * n))

    # ---------------- losses ----------------------------------------------
    r = d[:, 0] - dist_gt
    if loss_type == "l1":
        loss_dist = torch.mean(torch.abs(r))
        dd = torch.sign(r)[:, None] / B
    elif loss_type == "l2":
        loss_dist = torch.mean(r * r)
        dd = (2.0 * r)[:, None] / B
    else:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    gn = torch.sqrt(torch.sum(gq * gq, dim=-1) + _EIK_EPS)           # (B, J)
    loss_eik = torch.mean((gn - 1.0) ** 2)

    # ---------------- B. loss cotangents ----------------------------------
    dd = weight_dist * dd
    Ggq = weight_eikonal * (2.0 / (B * J)) * ((gn - 1.0) / gn)[..., None] * gq
    dotG = torch.sum(Ggq * pose, dim=1, keepdim=True)
    Ggx = Ggq / n - pose * (dotG * guard / (n * n * n))

    gw1 = [torch.zeros_like(w1[0]) for _ in range(J)]
    gb1 = [torch.zeros_like(b1[0]) for _ in range(J)]
    gw2 = [torch.zeros_like(w2[0]) for _ in range(J)]
    gb2 = [torch.zeros_like(b2[0]) for _ in range(J)]
    gW = [torch.zeros_like(w) for w in W]
    gb = [torch.zeros_like(b) for b in bias]

    # ---------------- C. e-chain (reverse mode through the pullback) ------
    efeat, zcot2_h, zcot2_f = [None] * J, [None] * J, [None] * J
    for j in range(J):
        p = parents[j]
        egin = torch.cat([Ggx[:, j, :], efeat[p] if p >= 0 else pose.new_zeros((B, F))], dim=-1)
        gw1[j] = gw1[j] + egin.T @ gh[j]
        egh = egin @ w1[j]
        ea = egh * sh[j]
        gw2[j] = gw2[j] + ea.T @ gf[j]
        egf = ea @ w2[j]
        efeat[j] = egf * sf[j]
        if d2 is not None:
            zcot2_h[j] = egh * (gf[j] @ w2[j].T) * d2(zh[j])
            zcot2_f[j] = egf * gfeat[j] * d2(zf[j])

    zcot2 = [None] * L
    ecx = torch.cat(efeat, dim=-1)
    for l in range(L):
        gW[l] = gW[l] + ecx.T @ c[l]
        ec = ecx @ W[l]
        if l < L - 1:
            if d2 is not None:
                zcot2[l] = ec * cx[l + 1] * d2(zs[l])
            ecx = ec * ss[l]
        elif od2 is not None:
            zcot2[l] = ec * od2(zs[l])

    # ---------------- D. combined downward backward ------------------------
    cot = dd * c[L - 1]
    if zcot2[L - 1] is not None:
        cot = cot + zcot2[L - 1]
    for l in range(L - 1, -1, -1):
        gW[l] = gW[l] + xs[l].T @ cot
        gb[l] = gb[l] + torch.sum(cot, dim=0)
        if l > 0:
            cot = (cot @ W[l].T) * ss[l - 1]
            if zcot2[l - 1] is not None:
                cot = cot + zcot2[l - 1]
    gfeat2 = list((cot @ W[0].T).reshape(B, J, F).unbind(1))
    for j in range(J - 1, -1, -1):
        czf = gfeat2[j] * sf[j]
        if zcot2_f[j] is not None:
            czf = czf + zcot2_f[j]
        gw2[j] = gw2[j] + h[j].T @ czf
        gb2[j] = gb2[j] + torch.sum(czf, dim=0)
        czh = (czf @ w2[j].T) * sh[j]
        if zcot2_h[j] is not None:
            czh = czh + zcot2_h[j]
        gw1[j] = gw1[j] + inp[j].T @ czh
        gb1[j] = gb1[j] + torch.sum(czh, dim=0)
        if parents[j] >= 0:
            gfeat2[parents[j]] = gfeat2[parents[j]] + (czh @ w1[j].T)[:, 4:]

    # ---------------- manifold branch (first order, NO normalization) -----
    featm, inpm, hm, zhm, zfm = enc_forward(man_poses, M)
    shm = [d1(z) for z in zhm]
    sfm = [d1(z) for z in zfm]
    xm = torch.cat(featm, dim=-1)
    xsm, ssm = [xm], []
    for l in range(L):
        z = xm @ W[l] + bias[l]
        if l < L - 1:
            ssm.append(d1(z))
            xm = act(z)
            xsm.append(xm)
        else:
            zlast = z
    d_man = out_act(zlast)
    loss_man = torch.mean(torch.abs(d_man))
    cotm = weight_man * torch.sign(d_man) / M * od1(zlast)
    for l in range(L - 1, -1, -1):
        gW[l] = gW[l] + xsm[l].T @ cotm
        gb[l] = gb[l] + torch.sum(cotm, dim=0)
        if l > 0:
            cotm = (cotm @ W[l].T) * ssm[l - 1]
    gfeatm = list((cotm @ W[0].T).reshape(M, J, F).unbind(1))
    for j in range(J - 1, -1, -1):
        czf = gfeatm[j] * sfm[j]
        gw2[j] = gw2[j] + hm[j].T @ czf
        gb2[j] = gb2[j] + torch.sum(czf, dim=0)
        czh = (czf @ w2[j].T) * shm[j]
        gw1[j] = gw1[j] + inpm[j].T @ czh
        gb1[j] = gb1[j] + torch.sum(czh, dim=0)
        if parents[j] >= 0:
            gfeatm[parents[j]] = gfeatm[parents[j]] + (czh @ w1[j].T)[:, 4:]

    total = weight_dist * loss_dist + weight_man * loss_man + weight_eikonal * loss_eik
    terms = {"dist": loss_dist, "man_loss": loss_man, "eikonal": loss_eik}
    grads = {"enc.w1": torch.stack(gw1), "enc.b1": torch.stack(gb1),
             "enc.w2": torch.stack(gw2), "enc.b2": torch.stack(gb2)}
    for l in range(L):
        grads[f"dfnet.w{l}"] = gW[l]
        grads[f"dfnet.b{l}"] = gb[l]
    return total, terms, grads
