"""The port's msgpack decoder against flax's, and the state-dict mapping.

``posendf_torch.checkpoints`` reads the JAX package's checkpoint files with
a small pure-Python decoder (the GPU host has neither ``msgpack`` nor
``flax``); it must give exactly what ``flax.serialization.msgpack_restore``
gives, on the committed checkpoints and on every type flax writes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flax.serialization import msgpack_restore as flax_restore  # noqa: E402
from flax.serialization import msgpack_serialize  # noqa: E402

from posendf_torch.checkpoints import (  # noqa: E402
    load_msgpack_params, msgpack_restore, params_from_jax,
)
from posendf_torch.models import PoseNDF  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {
    "golden": os.path.join(ROOT, "examples", "golden", "golden.msgpack"),
    "l8_best": os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack"),
}


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(FILES))
def test_decoder_matches_flax_on_checkpoints(name):
    with open(FILES[name], "rb") as f:
        data = f.read()
    _assert_same_tree(msgpack_restore(data), flax_restore(data))


def test_decoder_matches_flax_on_every_type():
    rng = np.random.default_rng(0)
    payload = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**63],
        "floats": [0.0, -1.5, 3.141592653589793, 1e300],
        "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "pose ü"],
        "blob": b"\x00\x01" * 200,
        "arrays": {
            "f32": rng.normal(size=(3, 5)).astype(np.float32),
            "f64": rng.normal(size=(7,)),
            "i32": np.arange(-5, 5, dtype=np.int32).reshape(2, 5),
            "u8": np.arange(250, dtype=np.uint8),
            "scalar_shape": np.zeros((), np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "big": rng.normal(size=(300, 300)).astype(np.float32),
        },
        "npscalar": np.float32(2.5),
        "many": {str(i): i for i in range(40)},
        "long_list": list(range(20)),
    }
    data = msgpack_serialize(payload)
    _assert_same_tree(msgpack_restore(data), flax_restore(data))


def test_decoder_rejects_truncated_and_trailing_bytes():
    data = msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")


def test_checkpoint_loads_into_the_model():
    """The l8 checkpoint's tree maps onto the port's state dict one to one
    (same names, same shapes, no transpose)."""
    state, epoch = load_msgpack_params(FILES["l8_best"])
    assert epoch == 12000
    model = PoseNDF()
    model.load_state_dict(state, strict=True)
    with open(FILES["l8_best"], "rb") as f:
        params = flax_restore(f.read())["state"]["params"]
    np.testing.assert_array_equal(model.dfnet.w2.detach().numpy(), params["dfnet"]["w2"])
    np.testing.assert_array_equal(model.enc.w1.detach().numpy(), params["enc"]["w1"])
    assert set(params_from_jax(params)) == set(model.state_dict())
