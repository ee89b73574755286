"""From-scratch initialization that survives the dead-ReLU-head attractor.

Port of ``posendf_tpu/training/init_utils.py`` (see there for the measured
failure mode): under torch's default linear init the head pre-activation is
nearly constant across poses with a spread far above the distance labels,
the L1 force pushes every prediction below 0, and the final ReLU clamps the
field to the absorbing constant 0. ``moment_matched_head_init`` scales the
last layer so the pre-activation spread matches the label spread and
recentres its bias just under the label mean. Opt-in; the torch-faithful
init stays the default.

Parameters are state dicts keyed like ``PoseNDF.state_dict()``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch.func import functional_call

__all__ = ["HE_GAIN", "he_gain", "moment_matched_head_init"]

# torch's default Linear init draws U(+-1/sqrt(fan_in)), variance 1/(3n); He's
# ReLU-family variance is 2/n: a sqrt(6) gain turns one into the other.
HE_GAIN = math.sqrt(6.0)


def he_gain(params: Mapping[str, torch.Tensor], gain: float = HE_GAIN) -> Dict[str, torch.Tensor]:
    """Every weight matrix (a key whose last part starts with ``w``) times
    ``gain``; biases unchanged."""
    return {k: (v * gain if k.rsplit(".", 1)[-1].startswith("w") else v)
            for k, v in params.items()}


def _head_layer_index(params: Mapping[str, torch.Tensor]) -> int:
    return max(int(k[len("dfnet.w"):]) for k in params if k.startswith("dfnet.w"))


@torch.no_grad()
def moment_matched_head_init(module, params: Mapping[str, torch.Tensor],
                             probe_poses: torch.Tensor, labels, *, gain: float = HE_GAIN,
                             mean_frac: float = 0.8) -> Tuple[Dict[str, torch.Tensor], dict]:
    """He-gain ``params`` and moment-match the head layer to ``labels``.

    ``probe_poses`` (B, 21, 4) are training poses and ``labels`` (B,) their
    distance labels. ``mean_frac`` < 1 starts the mean pre-activation just
    under the label mean, so the initial L1 force points away from the dead
    zone. Returns ``(new_params, stats)`` with the measured moments."""
    params = he_gain(params, gain)
    li = _head_layer_index(params)
    b_key, w_key = f"dfnet.b{li}", f"dfnet.w{li}"
    b_arr = params[b_key]
    b_last = float(b_arr.reshape(-1)[0])

    # the unclamped head pre-activation, read through a +100 bias shift (the
    # output activation is the identity far above 0)
    shifted = dict(params, **{b_key: b_arr + 100.0})
    z = (functional_call(module, shifted, (probe_poses,)) - 100.0).reshape(-1)
    z = z.cpu().numpy()
    lbl = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels).ravel()
    if float(lbl.std()) < 1e-9:
        raise ValueError(
            "moment_matched_head_init: the probe labels have ~zero spread "
            f"(std={float(lbl.std()):.3g}); matching the head to them would zero the weight "
            "matrix. Check the label pipeline.")
    scale = float(lbl.std()) / max(float(z.std()), 1e-9)
    new_mean = scale * (float(z.mean()) - b_last) + b_last
    new_bias = b_last + float(mean_frac * lbl.mean() - new_mean)
    params[w_key] = params[w_key] * scale
    params[b_key] = torch.full_like(b_arr, new_bias)
    stats = {"z_mean": float(z.mean()), "z_std": float(z.std()),
             "label_mean": float(lbl.mean()), "label_std": float(lbl.std()),
             "scale": scale, "new_bias": new_bias}
    return params, stats
