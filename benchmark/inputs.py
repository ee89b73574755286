"""What a run is given, made from ``--seed`` on the run's device.

One ``torch.Generator`` on the device, seeded with the run's seed, draws in
turn the field's weights and then the cell's input pool, each in a few large
calls. Every seed draws the same sizes, so only the values change from seed to
seed. A second generator on the host, seeded alike, picks what the check samples.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["model_spec", "make_weights", "random_poses", "training_pool"]


def model_spec(config: dict) -> dict:
    """The sizes a run needs, from a configuration file."""
    model = config["model"]
    dfnet, strenc = model["DFNet"], model["StrEnc"]
    parents = tuple(config["kinematic_tree"])
    if len(parents) != strenc["num_part"] or strenc["in_dim"] != 4 * strenc["num_part"]:
        raise ValueError("the kinematic tree, StrEnc.num_part and StrEnc.in_dim disagree")
    if dfnet["act"] != strenc["act"] or dfnet["beta"] != strenc["beta"]:
        raise ValueError("DFNet and StrEnc must share the activation")
    return dict(parents=parents, feature=int(strenc["out_dim"]), activation=dfnet["act"],
                beta=float(dfnet["beta"]),
                widths=(int(dfnet["in_dim"]),) + tuple(int(d) for d in dfnet["dims"]) + (1,),
                live_head=bool(dfnet.get("live_head", False)))


def _shapes(spec: dict) -> List[Tuple[str, Tuple[int, ...], List[float]]]:
    """(name, shape, per-row bound) of every weight, in the order they are drawn:
    torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in 4 for a root
    joint's first layer (its parent-feature rows are zero)."""
    parents, F = spec["parents"], spec["feature"]
    J, E = len(parents), 4 + spec["feature"]
    first = [1 / math.sqrt(4 if p < 0 else E) for p in parents]
    out = [("enc.w1", (J, E, E), first), ("enc.b1", (J, E), first),
           ("enc.w2", (J, E, F), [1 / math.sqrt(E)] * J), ("enc.b2", (J, F), [1 / math.sqrt(E)] * J)]
    widths = spec["widths"]
    for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(f"dfnet.w{l}", (i, o), [1 / math.sqrt(i)]), (f"dfnet.b{l}", (o,), [1 / math.sqrt(i)])]
    return out


def make_weights(spec: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The field's fp32 weights, on the generator's device, in one draw."""
    shapes = _shapes(spec)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.rand(total, generator=gen, device=gen.device, dtype=torch.float32) * 2 - 1
    out, at = {}, 0
    for name, shape, bounds in shapes:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        scale = torch.tensor(bounds, dtype=torch.float32, device=gen.device)
        out[name] = (t * scale.view((-1,) + (1,) * (len(shape) - 1)) if len(bounds) > 1
                     else t * bounds[0]).contiguous()
    for j, p in enumerate(spec["parents"]):
        if p < 0:
            out["enc.w1"][j, 4:] = 0.0
    if spec["live_head"]:
        # dfnet.live_head: the head's bias starts at 0.1, so that a ReLU head is live
        out[f"dfnet.b{len(spec['widths']) - 2}"].fill_(0.1)
    return out


def random_poses(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Unit-quaternion poses as the published sampler draws them: each
    component uniform in [0, 1), then each joint's quaternion normalized."""
    q = torch.rand(tuple(shape) + (4,), generator=gen, device=gen.device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _family(gen: torch.Generator, J: int) -> Tuple[torch.Tensor, ...]:
    """A smooth two-parameter pose family: per joint a rotation axis, two
    latent frequencies and a phase."""
    dev = gen.device
    axes = torch.randn((J, 3), generator=gen, device=dev)
    axes = axes / torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    freq = 0.5 + 1.5 * torch.rand((J, 2), generator=gen, device=dev)
    phase = 2 * math.pi * torch.rand((J,), generator=gen, device=dev)
    return axes, freq, phase


def _on_family(family, gen: torch.Generator, n: int) -> torch.Tensor:
    axes, freq, phase = family
    uv = 2 * math.pi * torch.rand((n, 2), generator=gen, device=gen.device)
    angle = (0.6 * torch.sin(freq[None, :, 0] * uv[:, :1] + phase[None])
             + 0.4 * torch.cos(freq[None, :, 1] * uv[:, 1:]))
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axes[None]], dim=-1)


def training_pool(gen: torch.Generator, batches: int, noisy: int, manifold: int, J: int,
                  sigmas: Sequence[float]) -> List[Dict[str, torch.Tensor]]:
    """``batches`` training batches: ``manifold`` poses on one smooth family,
    and ``noisy`` poses, each another pose of the family plus sigma x U[0, 1)
    on every component (sigma drawn from ``sigmas``), renormalized, labelled
    with its geodesic distance to the pose it came from,
    mean_j (1 - |<q_j, p_j>|)."""
    family = _family(gen, J)
    sig = torch.tensor(list(sigmas), dtype=torch.float32, device=gen.device)
    out = []
    for _ in range(batches):
        man = _on_family(family, gen, manifold)
        base = _on_family(family, gen, noisy)
        s = sig[torch.randint(len(sigmas), (noisy,), generator=gen, device=gen.device)]
        q = base + s[:, None, None] * torch.rand(base.shape, generator=gen, device=gen.device)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        dist = torch.mean(1.0 - torch.abs(torch.sum(q * base, dim=-1)), dim=-1)
        out.append({"pose": q.contiguous(), "dist": dist.contiguous(),
                    "man_poses": man.contiguous()})
    return out
