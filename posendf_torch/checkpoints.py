"""Checkpoint loading: the JAX package's msgpack files and the reference's
``.tar`` files, into a :class:`~posendf_torch.models.PoseNDF` state dict.

The port's parameter names are the JAX tree's paths joined by dots
(``enc.w1``, ``dfnet.w0``, ...) and its arrays have the same layouts, so
:func:`params_from_jax` is a copy with no transpose. ``.tar`` checkpoints
go through the same key mapping as ``posendf_tpu/training/torch_import.py``
(torch ``Linear`` weights transpose; root BoneMLP weights (10, 4) are
zero-padded to 10 input rows).

:func:`smpl_model_from_jax` carries a JAX package ``SMPLModel``'s arrays
over into the port's body model.

The msgpack files are read by a small decoder of the subset flax writes
(``flax.serialization.msgpack_serialize``) and written by a matching
encoder (:func:`msgpack_serialize`), so neither ``msgpack`` nor ``flax`` is
needed.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from posendf_torch import kinematics

__all__ = [
    "msgpack_restore", "msgpack_serialize", "load_msgpack_params", "params_from_jax",
    "params_from_torch_state_dict", "torch_state_dict_from_params", "load_torch_checkpoint",
    "smpl_model_from_jax",
]

# flax's msgpack extension type codes
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder of one msgpack object stream (the subset flax writes: maps,
    arrays, str, bin, ints, floats, nil/bool and flax's ext types)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _seq(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int) -> Any:
        data = bytes(self._take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buffer = _Reader(data).read()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            if dtype == "bfloat16":
                raise ValueError("bfloat16 arrays are not supported by this decoder")
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode()
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):                         # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):                         # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xD3:                               # (u)int 8..64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:                               # fixext 1..16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                         # str 8/16/32
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return bytes(self._take(n)).decode()
        if b in (0xDC, 0xDD):                               # array 16/32
            return self._seq(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):                               # map 16/32
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-written msgpack bytes into dicts, lists, scalars and
    numpy arrays, as ``flax.serialization.msgpack_restore`` does."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


class _Writer:
    """Encoder of the same subset, in flax's layout: a numpy array is ext type
    1 whose payload is the msgpack of ``[shape, dtype name, C-order bytes]``,
    a numpy scalar ext type 3 with the same payload, tuples are lists, floats
    are float64, map keys are sorted. Each object takes msgpack's shortest
    form, as the ``msgpack`` package writes it."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n: int, fix: Optional[int], fix_max: int, codes: Tuple[int, ...]) -> None:
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
        elif len(codes) == 3 and n < 1 << 8:
            self.out += struct.pack(">BB", codes[0], n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", codes[-2], n)
        else:
            self.out += struct.pack(">BI", codes[-1], n)

    def _ext(self, code: int, data: bytes) -> None:
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out += struct.pack(">Bb", fixed[n], code)
        else:
            self._head(n, None, -1, (0xC7, 0xC8, 0xC9))
            self.out += struct.pack(">b", code)
        self.out += data

    @staticmethod
    def _array_payload(arr: np.ndarray) -> bytes:
        return msgpack_serialize([list(arr.shape), arr.dtype.name, arr.tobytes("C")])

    def write(self, x: Any) -> None:
        if isinstance(x, np.ndarray):          # before float: np.float64 is a float
            self._ext(_EXT_NDARRAY, self._array_payload(x))
        elif isinstance(x, np.generic):
            self._ext(_EXT_NPSCALAR, self._array_payload(np.asarray(x)))
        elif x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.out += struct.pack(">Bd", 0xCB, x)
        elif isinstance(x, str):
            b = x.encode()
            self._head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.out += b
        elif isinstance(x, bytes):             # an array's payload
            self._head(len(x), None, -1, (0xC4, 0xC5, 0xC6))
            self.out += x
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 15, (0xDC, 0xDD))
            for v in x:
                self.write(v)
        elif isinstance(x, Mapping):
            self._head(len(x), 0x80, 15, (0xDE, 0xDF))
            for k in sorted(x):               # flax's tree copy sorts the keys
                self.write(k)
                self.write(x[k])
        else:
            raise TypeError(f"cannot serialize {type(x).__name__} to msgpack")

    def _int(self, x: int) -> None:
        if 0 <= x <= 0x7F:
            self.out.append(x)
        elif -32 <= x < 0:
            self.out.append(x & 0xFF)
        elif x >= 0:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if x < lim:
                    self.out += struct.pack(">B" + fmt[1], code, x)
                    return
            raise OverflowError(x)
        else:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if x >= -lim:
                    self.out += struct.pack(">B" + fmt[1], code, x)
                    return
            raise OverflowError(x)


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts, lists, tuples, scalars and numpy arrays as
    ``flax.serialization.msgpack_serialize`` does (arrays below its 1 GiB
    chunking size), so the JAX package reads the bytes back."""
    w = _Writer()
    w.write(tree)
    return bytes(w.out)


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params tree ``{"enc": {...}, "dfnet": {...}}`` of arrays -> state
    dict of the port's :class:`PoseNDF` (``"enc.w1"``, ``"dfnet.w0"``, ...)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def load_msgpack_params(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """A JAX package checkpoint file (``{"epoch", "state": {"params"}}``)
    -> (state dict, epoch)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if "state" not in payload or "params" not in payload["state"]:
        raise ValueError(f"{path!r} holds no state.params tree")
    epoch = payload.get("epoch")
    return params_from_jax(payload["state"]["params"]), (None if epoch is None else int(epoch))


def params_from_torch_state_dict(
    state_dict: Mapping[str, Any], *,
    parents: Sequence[int] = kinematics.REFERENCE_PARENTS,
    feature_size: int = 6,
) -> Dict[str, torch.Tensor]:
    """A reference state dict (``enc.net.{i}.net.{0,2}.*``,
    ``dfnet.lin{l}.*``) -> state dict of the port's :class:`PoseNDF`."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32) for k, v in state_dict.items()}
    J, H = len(parents), 4 + feature_size
    out: Dict[str, torch.Tensor] = {}
    if any(k.startswith("enc.") for k in sd):
        w1 = torch.zeros(J, H, H)
        for j in range(J):
            tw1 = sd[f"enc.net.{j}.net.0.weight"]               # (H, fan_in)
            w1[j, :tw1.shape[1], :] = tw1.T
        out["enc.w1"] = w1
        out["enc.b1"] = torch.stack([sd[f"enc.net.{j}.net.0.bias"] for j in range(J)])
        out["enc.w2"] = torch.stack([sd[f"enc.net.{j}.net.2.weight"].T for j in range(J)])
        out["enc.b2"] = torch.stack([sd[f"enc.net.{j}.net.2.bias"] for j in range(J)])
    l = 0
    while f"dfnet.lin{l}.weight" in sd:
        out[f"dfnet.w{l}"] = sd[f"dfnet.lin{l}.weight"].T.contiguous()
        out[f"dfnet.b{l}"] = sd[f"dfnet.lin{l}.bias"]
        l += 1
    if l == 0:
        raise ValueError("state dict has no dfnet.lin* keys: not a PoseNDF checkpoint")
    return out


def torch_state_dict_from_params(
    params: Mapping[str, torch.Tensor], *,
    parents: Sequence[int] = kinematics.REFERENCE_PARENTS,
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_torch_state_dict`: the port's state dict
    -> the reference's keys and layouts (CPU tensors); root BoneMLP weights
    are cut back to their 4 input columns."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in params.items()}
    out: Dict[str, torch.Tensor] = {}
    if "enc.w1" in sd:
        for j, p in enumerate(parents):
            fan_in = 4 if p == -1 else sd["enc.w1"].shape[1]
            out[f"enc.net.{j}.net.0.weight"] = sd["enc.w1"][j, :fan_in, :].T.contiguous()
            out[f"enc.net.{j}.net.0.bias"] = sd["enc.b1"][j].clone()
            out[f"enc.net.{j}.net.2.weight"] = sd["enc.w2"][j].T.contiguous()
            out[f"enc.net.{j}.net.2.bias"] = sd["enc.b2"][j].clone()
    l = 0
    while f"dfnet.w{l}" in sd:
        out[f"dfnet.lin{l}.weight"] = sd[f"dfnet.w{l}"].T.contiguous()
        out[f"dfnet.lin{l}.bias"] = sd[f"dfnet.b{l}"].clone()
        l += 1
    return out


def load_torch_checkpoint(path: str, **kwargs) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """A reference ``checkpoint_epoch_best.tar`` -> (state dict, epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model_state_dict", ckpt)
    epoch = ckpt.get("epoch")
    return params_from_torch_state_dict(state_dict, **kwargs), epoch


SMPL_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")


def smpl_model_from_jax(model, device="cpu"):
    """The JAX package's ``SMPLModel`` (or any object with its fields:
    ``v_template``, ``shapedirs``, ``posedirs`` (207, V*3), ``j_regressor``,
    ``lbs_weights`` as arrays, ``faces``, ``parents``) -> the port's
    :class:`~posendf_torch.smpl.SMPLModel` on ``device``, the same float32
    values in the same layouts."""
    from posendf_torch.smpl.lbs import SMPLModel

    arrays = {f: torch.from_numpy(np.array(getattr(model, f), dtype=np.float32)).to(device)
              for f in SMPL_FIELDS}
    return SMPLModel(**arrays, faces=np.asarray(model.faces, np.int32),
                     parents=tuple(int(p) for p in model.parents))
