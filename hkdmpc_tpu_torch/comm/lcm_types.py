"""LCM message definitions at run time — the port's own copy of
`hkdmpc_tpu/comm/lcm_types.py` (numpy and `struct` only).

Parses `.lcm` schema text, computes the wire fingerprint of each struct and
encodes / decodes messages, byte for byte as LCM 1.4's generated code does
for structs of primitives: a replacement for the reference's lcm-gen step
(scripts/make_types.sh), so its `lcmtypes/*.lcm` files load directly.

The type hash follows the public LCM type specification: a signed 64-bit
rolling hash over the member names, the primitive type names and the
dimensions, then rotated left by one for a struct without nested types.
`tests/test_torch_comm.py` holds hash, fingerprint and bytes equal to the
JAX package's codec on fixed- and variable-length schemas.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Dict, List, Tuple

import numpy as np

# LCM primitive -> (struct code, bytes); everything is big-endian on the wire
_PRIMS = {
    "int8_t": ("b", 1), "byte": ("B", 1), "boolean": ("b", 1),
    "int16_t": ("h", 2), "int32_t": ("i", 4), "int64_t": ("q", 8),
    "float": ("f", 4), "double": ("d", 8),
}
_M64 = (1 << 64) - 1
_HASH_SEED = 0x12345678
_CONST_DIM, _VAR_DIM = 0, 1


def _hash_update(v: int, c: int) -> int:
    """One step of lcm-gen's hash: v as a signed 64-bit value, shifted
    arithmetically."""
    sv = v - (1 << 64) if v & (1 << 63) else v
    return ((((sv << 8) & _M64) ^ ((sv >> 55) & _M64)) + c) & _M64


def _hash_string(v: int, s: str) -> int:
    v = _hash_update(v, len(s))
    for ch in s:
        v = _hash_update(v, ord(ch))
    return v


@dataclasses.dataclass
class Member:
    name: str
    type: str
    # per dimension (mode, size): _CONST_DIM with the size literal, or
    # _VAR_DIM with the name of the earlier member that holds the length
    dims: List[Tuple[int, str]]


class LCMType:
    """A parsed LCM struct: fingerprint, `encode`, `decode`.

    Messages are dicts of numpy arrays and Python scalars. Members are
    primitives, or arrays of primitives with fixed or length-prefixed
    variable dimensions (every type of the reference's lcmtypes/); strings
    and nested structs are not supported."""

    def __init__(self, name: str, members: List[Member]):
        self.name = name
        self.members = members

    @property
    def base_hash(self) -> int:
        v = _HASH_SEED
        for m in self.members:
            v = _hash_string(v, m.name)
            if m.type in _PRIMS or m.type == "string":
                v = _hash_string(v, m.type)
            v = _hash_update(v, len(m.dims))
            for mode, size in m.dims:
                v = _hash_update(v, mode)
                v = _hash_string(v, size)
        return v

    @property
    def fingerprint(self) -> bytes:
        h = self.base_hash
        return struct.pack(">Q", ((h << 1) & _M64) + (h >> 63))

    def _shape(self, m: Member, values: dict) -> List[int]:
        return [int(size) if mode == _CONST_DIM else int(values[size])
                for mode, size in m.dims]

    def encode(self, values: dict) -> bytes:
        out = [self.fingerprint]
        for m in self.members:
            code, _ = _PRIMS[m.type]
            shape = self._shape(m, values)
            if not shape:
                v = values[m.name]
                if m.type == "boolean":
                    v = 1 if v else 0
                out.append(struct.pack(">" + code, v))
            else:
                flat = np.asarray(values[m.name]).reshape(shape).flatten()
                out.append(struct.pack(f">{flat.size}{code}", *flat.tolist()))
        return b"".join(out)

    def decode(self, buf: bytes) -> dict:
        if buf[:8] != self.fingerprint:
            raise ValueError(
                f"fingerprint mismatch for {self.name}: "
                f"{buf[:8].hex()} != {self.fingerprint.hex()}")
        off = 8
        values: dict = {}
        for m in self.members:
            code, size = _PRIMS[m.type]
            shape = self._shape(m, values)
            if not shape:
                (v,) = struct.unpack_from(">" + code, buf, off)
                off += size
                values[m.name] = bool(v) if m.type == "boolean" else v
            else:
                n = int(np.prod(shape))
                vals = struct.unpack_from(f">{n}{code}", buf, off)
                off += n * size
                values[m.name] = np.array(vals).reshape(shape)
        return values


_STRUCT_RE = re.compile(r"struct\s+(\w+)\s*\{([^}]*)\}", re.S)
_MEMBER_RE = re.compile(r"(\w+)\s+(\w+)((?:\s*\[\s*\w+\s*\])*)\s*;")
_DIM_RE = re.compile(r"\[\s*(\w+)\s*\]")


def parse_lcm_text(text: str) -> Dict[str, LCMType]:
    """Every struct of a schema text, by name (`//` comments dropped)."""
    text = re.sub(r"//[^\n]*", "", text)
    out = {}
    for sm in _STRUCT_RE.finditer(text):
        name, body = sm.group(1), sm.group(2)
        members = [
            Member(mm.group(2), mm.group(1),
                   [(_CONST_DIM if d.isdigit() else _VAR_DIM, d)
                    for d in _DIM_RE.findall(mm.group(3) or "")])
            for mm in _MEMBER_RE.finditer(body)]
        out[name] = LCMType(name, members)
    return out


def parse_lcm_file(path: str) -> Dict[str, LCMType]:
    with open(path) as f:
        return parse_lcm_text(f.read())


def load_reference_types(lcmtypes_dir: str) -> Dict[str, LCMType]:
    """Every struct of every `.lcm` file in a directory (the reference's
    lcmtypes/, or the stand-ins `workload.lcmtypes_dir` writes)."""
    out: Dict[str, LCMType] = {}
    for fn in sorted(os.listdir(lcmtypes_dir)):
        if fn.endswith(".lcm"):
            out.update(parse_lcm_file(os.path.join(lcmtypes_dir, fn)))
    return out
