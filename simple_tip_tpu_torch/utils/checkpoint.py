"""The port's own codec for flax msgpack checkpoints (no msgpack needed).

``flax.serialization.to_bytes(tree)``, which the JAX package's
``CaseStudy.save_params`` writes to ``models/{cs}/{id}.msgpack``, is
``msgpack.packb`` of the nested dict of parameters, each array as msgpack
ext type 1 whose payload is ``packb((shape, dtype name, C-order bytes))``.
``to_bytes`` writes the same bytes for a tree whose keys are sorted at
every level (the order a jitted flax ``init`` and ``bridge.params_to_jax``
give); ``from_bytes`` reads flax-written bytes back into a nested dict of
numpy arrays. So a run trained by either package can be scored by the
other. flax splits arrays above 2**30 bytes into chunks; no model here
comes near, and both directions refuse them (the chunked form carries a
boolean, a type the reader does not take).
"""

import struct
from typing import Any, Dict

import numpy as np

_ARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray
MAX_ARRAY_BYTES = 2**30


def _sized(n: int, t8, t16: int, t32: int) -> bytes:
    """A msgpack type byte with an 8-, 16- or 32-bit length (``t8`` None
    where the type has no 8-bit form)."""
    if n < 2**8 and t8 is not None:
        return bytes([t8, n])
    if n < 2**16:
        return bytes([t16]) + struct.pack(">H", n)
    return bytes([t32]) + struct.pack(">I", n)


def _int(n: int) -> bytes:
    if not 0 <= n < 2**64:
        raise ValueError(f"checkpoint codec: integer {n} out of range")
    if n < 128:
        return bytes([n])
    for code, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32)):
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    return bytes([0xCF]) + struct.pack(">Q", n)


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    head = bytes([0xA0 | len(raw)]) if len(raw) < 32 else _sized(len(raw), 0xD9, 0xDA, 0xDB)
    return head + raw


def _bin(raw: bytes) -> bytes:
    return _sized(len(raw), 0xC4, 0xC5, 0xC6) + raw


def _array_header(n: int) -> bytes:
    return bytes([0x90 | n]) if n < 16 else _sized(n, None, 0xDC, 0xDD)


def _ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        return bytes([fixed[len(payload)], code]) + payload
    return _sized(len(payload), 0xC7, 0xC8, 0xC9) + bytes([code]) + payload


def _ndarray(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError("checkpoint codec: object and structured arrays are not supported")
    if a.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"checkpoint codec: array of {a.nbytes} bytes needs flax's chunking")
    payload = (
        _array_header(3)
        + _array_header(a.ndim) + b"".join(_int(int(d)) for d in a.shape)
        + _str(a.dtype.name)
        + _bin(a.tobytes("C"))
    )
    return _ext(_ARRAY_EXT, payload)


def _encode(node: Any) -> bytes:
    if isinstance(node, dict):
        n = len(node)
        head = bytes([0x80 | n]) if n < 16 else _sized(n, None, 0xDE, 0xDF)
        return head + b"".join(_str(str(k)) + _encode(v) for k, v in sorted(node.items()))
    if isinstance(node, np.ndarray):
        return _ndarray(node)
    raise TypeError(f"checkpoint codec: cannot write a {type(node).__name__} leaf")


def to_bytes(tree: Dict) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (a
    nested dict of numpy arrays), keys in sorted order."""
    return _encode(tree)


class _Reader:
    """A msgpack reader for what a flax parameter checkpoint holds: maps,
    string keys, and arrays as ext type 1 (shape, dtype name, bytes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("checkpoint codec: truncated data")
        out = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
            n = b & 0x0F if b <= 0x8F else self.unpack(">H" if b == 0xDE else ">I")
            return {self.read(): self.read() for _ in range(n)}
        if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
            n = b & 0x0F if b <= 0x9F else self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        uints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if b in uints:
            return self.unpack(uints[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in sizes or b in fixed:
            n = fixed[b] if b in fixed else self.unpack(sizes[b])
            if 0xC4 <= b <= 0xC6:
                return self.take(n)
            if 0xD9 <= b <= 0xDB:
                return self.take(n).decode("utf-8")
            return self.array(self.unpack(">b"), self.take(n))
        raise ValueError(f"checkpoint codec: unsupported msgpack type byte {b:#x}")

    @staticmethod
    def array(code: int, payload: bytes) -> np.ndarray:
        if code != _ARRAY_EXT:
            raise ValueError(f"checkpoint codec: unsupported ext type {code}")
        shape, dtype, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def from_bytes(data: bytes) -> Dict:
    """The nested dict of numpy arrays that flax (or ``to_bytes``) wrote."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("checkpoint codec: trailing bytes after the tree")
    return tree


def save(path: str, tree: Dict) -> None:
    """Write ``tree`` to ``path`` (flax's bytes)."""
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def load(path: str) -> Dict:
    """Read a flax msgpack checkpoint from ``path``."""
    with open(path, "rb") as f:
        return from_bytes(f.read())
