"""Plain PyTorch reference of the PoseNDF field, its projection and its training step.

Written from the published model (garvita-tiwari/PoseNDF,
``model/network/net_modules.py`` and ``model/posendf.py``) and from nothing of
the program under test: it imports only ``torch`` and ``math``. Every function
takes the weights as the benchmark made them (a dict keyed like the model's
``state_dict``: ``enc.w1`` (J, 4+F, 4+F), ``enc.b1`` (J, 4+F), ``enc.w2``
(J, 4+F, F), ``enc.b2`` (J, F), ``dfnet.w{l}`` (in, out), ``dfnet.b{l}``
(out,)) and computes in the dtype of the tensors it is given. Gradients come
from autograd. Matrix products follow ``torch.backends.cuda.matmul.allow_tf32``:
the benchmark runs this module in float64 as the truth, and in float32 with
TF32 on as the control.

The model:

* input: the pose (B, J, 4) normalized across the JOINT axis
  (``F.normalize(pose, dim=1)`` in the published code), except for the
  manifold branch of the training loss;
* structure encoder: joint j reads its quaternion and its parent's feature
  (zeros for a root) through two linear layers with the hidden activation;
* DFNet: linear layers with the hidden activation between them, then ReLU
  (lrelu, relu) or softplus (softplus) on the output;
* lrelu(z) = z for z >= 0, 0.01 z below; softplus(z) = log(1 + exp(beta z)) / beta.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Weights = Dict[str, torch.Tensor]

__all__ = ["forward", "distance_and_grad", "project", "training_loss", "Adam", "adam_steps",
           "num_layers", "cast"]

_EPS = 1e-12


def num_layers(w: Weights) -> int:
    return sum(1 for k in w if k.startswith("dfnet.w"))


def cast(w: Weights, dtype: torch.dtype) -> Weights:
    """A copy of the weights in ``dtype``, leaves that autograd can differentiate."""
    return {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in w.items()}


def _hidden(name: str, beta: float):
    if name == "lrelu":
        return lambda z: torch.where(z >= 0, z, 0.01 * z)
    if name == "relu":
        return torch.relu
    if name == "softplus":
        return lambda z: (torch.clamp_min(beta * z, 0.0)
                          + torch.log1p(torch.exp(-torch.abs(beta * z)))) / beta
    raise ValueError(f"unknown activation {name!r}")


def _output(name: str, beta: float):
    return _hidden("softplus", beta) if name == "softplus" else torch.relu


def forward(w: Weights, pose: torch.Tensor, *, parents: Sequence[int], activation: str,
            beta: float, normalize: bool = True) -> torch.Tensor:
    """d(pose): (B, J, 4) -> (B,)."""
    act, out = _hidden(activation, beta), _output(activation, beta)
    x = pose
    if normalize:
        n = torch.sqrt(torch.clamp_min(torch.sum(pose * pose, dim=1, keepdim=True), _EPS * _EPS))
        x = pose / n
    F = w["enc.w2"].shape[-1]
    zero = x.new_zeros((x.shape[0], F))
    feats: List[torch.Tensor] = []
    for j, p in enumerate(parents):
        inp = torch.cat([x[:, j], zero if p < 0 else feats[p]], dim=-1)
        h = act(inp @ w["enc.w1"][j] + w["enc.b1"][j])
        feats.append(act(h @ w["enc.w2"][j] + w["enc.b2"][j]))
    h = torch.cat(feats, dim=-1)
    L = num_layers(w)
    for l in range(L):
        z = h @ w[f"dfnet.w{l}"] + w[f"dfnet.b{l}"]
        h = act(z) if l < L - 1 else out(z)
    return h[:, 0]


def distance_and_grad(w: Weights, pose: torch.Tensor, *, create_graph: bool = False,
                      **model) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d (B,), dd/dpose (B, J, 4)), the gradient through the normalization."""
    with torch.enable_grad():
        p = pose if pose.requires_grad else pose.detach().requires_grad_(True)
        d = forward(w, p, **model)
        (g,) = torch.autograd.grad(d, p, torch.ones_like(d), create_graph=create_graph)
    return d, g


def project(w: Weights, poses: torch.Tensor, *, steps: int, renormalize: bool = True,
            step_scale: float = 1.0, **model) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient descent onto the zero level set, ``q <- q - step_scale d grad d``,
    each joint's quaternion renormalized after every step: returns the final
    poses (B, J, 4) and the distance before each step (steps, B)."""
    w = {k: v.detach() for k, v in w.items()}
    q = poses
    history = []
    for _ in range(steps):
        d, g = distance_and_grad(w, q, **model)
        d = d.detach()
        q = q - step_scale * d[:, None, None] * g
        if renormalize:
            q = q / torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True),
                                               _EPS * _EPS))
        q = q.detach()
        history.append(d)
    return q, torch.stack(history)


def training_loss(w: Weights, pose: torch.Tensor, dist_gt: torch.Tensor, man_poses: torch.Tensor,
                  *, loss_type: str, weight_dist: float, weight_man: float,
                  weight_eikonal: float, **model) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The published objective: the distance term (L1 or L2 against the label)
    on the noisy poses, mean |d| on the manifold poses (not normalized, as
    the published code leaves them), and the eikonal term, the mean over
    poses and joints of (||dd/dq_j|| - 1)^2; differentiable with respect to
    ``w``."""
    d, g = distance_and_grad(w, pose, create_graph=True, **model)
    r = d - dist_gt
    dist = torch.mean(torch.abs(r)) if loss_type == "l1" else torch.mean(r * r)
    man = torch.mean(torch.abs(forward(w, man_poses, normalize=False, **model)))
    eik = torch.mean((torch.sqrt(torch.sum(g * g, dim=-1) + 1e-12) - 1.0) ** 2)
    total = weight_dist * dist + weight_man * man + weight_eikonal * eik
    return total, {"dist": dist, "man_loss": man, "eikonal": eik}


class Adam:
    """Adam with coupled L2 (``weight_decay * p`` added to the gradient before
    the moments, as ``torch.optim.Adam``) on the training objective: ``p``
    the weights, ``m`` and ``v`` the moments, ``t`` the steps taken."""

    def __init__(self, w: Weights, *, lr: float, weight_decay: float, loss: dict, model: dict,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p = {k: v.detach().clone() for k, v in w.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.loss, self.model = loss, model

    def grad(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Weights]:
        """The total loss at the current weights and its gradient."""
        leaves = {k: x.clone().requires_grad_(True) for k, x in self.p.items()}
        total, _ = training_loss(leaves, batch["pose"], batch["dist"], batch["man_poses"],
                                 **self.loss, **self.model)
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        return total.detach(), dict(zip(names, grads))

    def update(self, grads: Weights) -> None:
        b1, b2 = self.betas
        self.t += 1
        with torch.no_grad():
            for k, g in grads.items():
                g = g + self.wd * self.p[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t) + self.eps
                self.p[k] = self.p[k] - (self.lr / (1 - b1 ** self.t)) * self.m[k] / denom

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        total, grads = self.grad(batch)
        self.update(grads)
        return total


def adam_steps(w: Weights, batches, **kw):
    """Adam (:class:`Adam`) over ``batches``, each a dict of ``pose``,
    ``dist``, ``man_poses``. Returns the total loss of each step (before its
    update), the first step's gradient (without the decay) and the weights
    after the last step."""
    opt = Adam(w, **kw)
    losses, first = [], None
    for batch in batches:
        total, grads = opt.grad(batch)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.update(grads)
        losses.append(total)
    return torch.stack(losses), first, opt.p
