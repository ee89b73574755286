"""The field kernels' bf16 route, modelled on the CPU and held to the JAX
package's bf16 kernels.

``posendf_forward``, ``posendf_value_and_grad`` and ``posendf_project_step``
(``csrc/field_kernels.cu``, ``field_kernel<Act, true>``) run a bf16 field's
DFNet products as bf16 ``wgmma`` from the 16 KB slabs of
``fused_model.pack_bf16``: 128 output columns x 64 of K (64 x 128 for a
chain's first product), read in the order of ``tc_schedule(widths,
BF16_SLAB_K)``, each slab's four k16 steps into a fresh accumulator added
to the layer's fp32 sums. The kernels run on the card only; this is the
CPU's check that the layout, the program and the fold agree.

A model of the kernels (``tests/tc_model.py``) walks the program, takes the
slabs from the packed stream in order (every one, none left), reads each
back by ``bf16_slab_offsets``, rounds A to bf16 and sums each k16 step into
an fp32 accumulator that rounds toward zero (the tensor cores' accumulation
as modelled there), folded every 64 of K; the encoder, the output layer,
the backward's start and the encoder's reverse walk round their operands as
the kernels do. Its d and g are held by ``fused_model.bf16_hold`` (the bars
of ``tests/test_torch_bf16.py``: atol 1e-6, shares and means against the
bf16-vs-fp32 gap):

* the trained field (``docs/quality/ckpt_l8_best.msgpack``: a 1024-wide
  layer chained with the next) on the first probes of
  ``tests/data/torch_port_bf16_expected.npz``, against JAX's bf16 forward
  and value-and-grad kernels there, the gap from the fp32 values of
  ``torch_port_l8_expected.npz``;
* a narrow seeded lrelu field (126 -> 40 -> 200 -> 24 -> 1, padded to 128,
  128, 256, 128) against JAX's bf16 value-and-grad kernel in interpret
  mode, the gap from the port's fp32 plain version.

Both also against the port's bf16 plain versions.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from posendf_tpu.models import PoseNDF as JaxPoseNDF  # noqa: E402
from posendf_tpu.ops.fused_grad import fused_distance_and_grad as jax_vag  # noqa: E402

import posendf_torch  # noqa: E402
from posendf_torch.checkpoints import params_from_jax  # noqa: E402
from posendf_torch.config import PoseNDFConfig  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.models.activations import (  # noqa: E402
    act_grad, out_act_grad_from_value, resolve,
)
from posendf_torch.models.dfnet import bf16_round  # noqa: E402
from posendf_torch.ops import fused_grad, fused_model  # noqa: E402
from posendf_torch.ops.fused_model import FieldWeights, bf16_hold  # noqa: E402
from tests import tc_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L8 = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
L8_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_l8_expected.npz")
BF16_EXPECTED = os.path.join(ROOT, "tests", "data", "torch_port_bf16_expected.npz")
ATOL = 1e-6           # d and g: the fp32 paths' agreement (tests/test_torch_bf16.py)
N_PROBES = 128        # of the golden file's 256
NARROW = (40, 200, 24)


def _model(q, weights):
    """The bf16 kernels' arithmetic: d (B, 1) and g (B, J, 4)."""
    tc = weights.tc_packed()
    assert tc.bf16
    c = bf16_round
    name, beta = weights.activation, weights.beta
    act, out_act = resolve(name, beta)
    head, fwd, bwd = tc_model.program(tc)
    stream = tc_model.SlabStream(tc)
    vec = tc.vec
    B = q.shape[0]
    z, width = {}, tc_model.z_widths(tc)

    def fwd_epi(acc, b, zo, cols):
        z.setdefault(zo, torch.zeros(B, width[zo]))[:, cols] = acc + vec[b + cols.start:b + cols.stop]
        return act(z[zo][:, cols])

    def bwd_epi(acc, _, zo, cols):
        return acc * act_grad(name, beta, z[zo][:, cols]) if zo >= 0 else acc

    # the encoder (operands rounded) and the normalization, as the plain version computes them
    s = torch.sum(q * q, dim=1, keepdim=True)
    n = s.clamp_min(1e-24).sqrt()
    _, (zh, zf, _) = fused_model.field_forward_ref(q / n, weights, keep=True)
    code = torch.cat([act(zz) for zz in zf], dim=-1)
    x = torch.cat([code, code.new_zeros(B, head[2] - code.shape[1])], dim=-1)
    x, _ = tc_model.run(stream, x, fwd, fwd_epi)
    K = head[3]
    w_out = vec[head[4]:head[4] + K]                # rounded by the pack
    d = out_act(c(x[:, :K]) @ w_out[:, None] + vec[head[5]])
    # the backward's start: out_act'(d) rounded, times w, times act'(z)
    g = (c(out_act_grad_from_value(name, beta, d)) * w_out) * act_grad(name, beta, z[head[6]])
    g, _ = tc_model.run(stream, g, bwd, bwd_epi)
    assert stream.pos == len(stream.blocks)   # every slab read
    # the encoder's reverse walk (gf, gh rounded) and the normalization's VJP
    J, F = weights.num_joints, weights.feature_size
    gfeat = list(g[:, :J * F].reshape(B, J, F).unbind(1))
    w1, w2 = c(weights.enc["w1"]), c(weights.enc["w2"])
    gx = [None] * J
    for j in range(J - 1, -1, -1):
        gf = gfeat[j] * act_grad(name, beta, zf[j])
        gh = torch.matmul(c(gf), w2[j].t()) * act_grad(name, beta, zh[j])
        gin = torch.matmul(c(gh), w1[j].t())
        gx[j] = gin[:, :4]
        if weights.parents[j] >= 0:
            gfeat[weights.parents[j]] = gfeat[weights.parents[j]] + gin[:, 4:]
    gx = torch.stack(gx, dim=1)
    dot = torch.sum(gx * q, dim=1, keepdim=True)
    scale = torch.where(s >= 1e-24, dot / (n * n * n), torch.zeros_like(dot))
    return d, gx / n - q * scale


def _hold_all(name, q, w, d, g, want, fp32):
    """The model's d and g against JAX's (``want``) and the plain bf16
    versions, each by ``bf16_hold`` with the fp32 results for the gap."""
    with torch.no_grad():
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
    for what, got, ref in (("d vs JAX", d, want["d"]), ("g vs JAX", g, want["g"]),
                           ("d vs plain", d, d_p), ("g vs plain", g, g_p)):
        bf16_hold(f"{name} model {what}", got, ref, fp32[what[0]], atol=ATOL)


@torch.no_grad()
def test_bf16_model_holds_to_jax_golden():
    """The trained field: the model against JAX's bf16 kernels' values."""
    ref, ref32 = np.load(BF16_EXPECTED), np.load(L8_EXPECTED)
    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    w = posendf_torch.load_field(L8, config=cfg, device="cpu").weights()
    assert w.tc_packed().widths == (128, 256, 512, 1024, 512, 256, 128)
    q = torch.from_numpy(ref["probes"][:N_PROBES])
    d, g = _model(q, w)
    bf16_hold("trained model forward d vs JAX", d, torch.from_numpy(ref["fwd_dist"][:N_PROBES]),
              torch.from_numpy(ref32["dist"][:N_PROBES]), atol=ATOL)
    _hold_all("trained", q, w, d, g,
              {"d": torch.from_numpy(ref["vag_dist"][:N_PROBES]),
               "g": torch.from_numpy(ref["vag_grad"][:N_PROBES])},
              {"d": torch.from_numpy(ref32["dist"][:N_PROBES]),
               "g": torch.from_numpy(ref32["grad"][:N_PROBES])})


@torch.no_grad()
def test_bf16_model_holds_to_jax_narrow_field():
    """A narrow seeded field (no chain; padding in every width): the model
    against JAX's bf16 value-and-grad kernel (interpret mode)."""
    jm = JaxPoseNDF(dfnet_dims=NARROW, activation="lrelu", compute_dtype="bfloat16")
    params = jm.init(jax.random.key(7), jnp.zeros((1, 21, 4)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(1.5), params)
    params["dfnet"]["b3"] = params["dfnet"]["b3"] + np.float32(0.2)   # d with signal
    rows = np.random.default_rng(17).normal(size=(128, 21, 4)).astype(np.float32)
    qn = rows / np.linalg.norm(rows, axis=-1, keepdims=True)
    with pltpu.force_tpu_interpret_mode():
        jd, jg = jax_vag(jnp.asarray(qn), params["enc"], params["dfnet"], parents=jm.parents,
                         activation="lrelu", beta=jm.beta, tile_b=128, compute_dtype="bfloat16")
    mods = {}
    for cd in ("bfloat16", "float32"):
        mods[cd] = PoseNDF(dfnet_dims=NARROW, activation="lrelu", compute_dtype=cd)
        mods[cd].load_state_dict(params_from_jax(params))
    w, w32 = (FieldWeights.from_module(mods[cd]) for cd in ("bfloat16", "float32"))
    assert w.tc_packed().widths == (128, 128, 256, 128)
    q = torch.from_numpy(qn)
    d, g = _model(q, w)
    d32, g32 = fused_grad.fused_distance_and_grad_ref(q, w32)
    _hold_all("narrow", q, w, d, g,
              {"d": torch.from_numpy(np.array(jd)), "g": torch.from_numpy(np.array(jg))},
              {"d": d32, "g": g32})
