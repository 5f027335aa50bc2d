"""Minimal TensorFlow ``GraphDef`` protobuf reader and writer — no
TensorFlow needed.  The port's copy of ``ic_gan_tpu/io/graphdef.py``.

The reference's "official" IS/FID path (``data_utils/inception_tf13.py:162-186``)
loads the frozen 2015 Inception graph (``classify_image_graph_def.pb``) with
TF1 and runs it in a Session.  This module decodes the protobuf wire format
directly (GraphDef/NodeDef/AttrValue/TensorProto are stable, frozen schemas).
Its varint and length-delimited helpers also encode the TensorBoard event
files of ``utils/tensorboard.py``.

Only the message fields the frozen classifier graphs actually use are
modeled; unknown fields are skipped structurally (standard protobuf
behavior), so richer GraphDefs still parse.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TF DataType enum values → numpy dtypes (the subset frozen graphs carry).
DTYPES = {
    1: np.float32,   # DT_FLOAT
    2: np.float64,   # DT_DOUBLE
    3: np.int32,     # DT_INT32
    4: np.uint8,     # DT_UINT8
    5: np.int16,     # DT_INT16
    6: np.int8,      # DT_INT8
    9: np.int64,     # DT_INT64
    10: np.bool_,    # DT_BOOL
    19: np.float16,  # DT_HALF
}


# --------------------------------------------------------------------------
# Wire format primitives


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message buffer.

    For wire type 0 the value is the varint; for 2 the (start, end) span of
    the payload; for 1/5 the fixed-width span.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
            yield fnum, wt, val
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield fnum, wt, (pos, pos + ln)
            pos += ln
        elif wt == 5:
            yield fnum, wt, (pos, pos + 4)
            pos += 4
        elif wt == 1:
            yield fnum, wt, (pos, pos + 8)
            pos += 8
        else:
            pos = _skip_field(buf, pos, wt)


def _to_signed64(v: int) -> int:
    # proto int64 varints are two's-complement in 64 bits (not zigzag).
    return v - (1 << 64) if v >= (1 << 63) else v


# --------------------------------------------------------------------------
# Message decoding


def _decode_dim(buf: bytes, span) -> int:
    size = 1
    for fnum, wt, val in _fields(buf[span[0]:span[1]]):
        if fnum == 1 and wt == 0:
            size = _to_signed64(val)
    return size


def _decode_tensor(buf: bytes) -> np.ndarray:
    """TensorProto: dtype=1, tensor_shape=2, tensor_content=4,
    float_val=5, int_val=7, string_val=8, int64_val=10, bool_val=11."""
    dtype = np.float32
    shape: List[int] = []
    content: Optional[bytes] = None
    float_vals: List[float] = []
    int_vals: List[int] = []
    for fnum, wt, val in _fields(buf):
        if fnum == 1 and wt == 0:
            dtype = DTYPES.get(val, np.float32)
        elif fnum == 2 and wt == 2:
            shape = _decode_shape_abs(buf[val[0]:val[1]])
        elif fnum == 4 and wt == 2:
            content = buf[val[0]:val[1]]
        elif fnum == 5:
            if wt == 5:
                float_vals.append(struct.unpack("<f", buf[val[0]:val[1]])[0])
            elif wt == 2:  # packed
                raw = buf[val[0]:val[1]]
                float_vals.extend(struct.unpack(f"<{len(raw)//4}f", raw))
        elif fnum in (7, 10, 11):
            if wt == 0:
                int_vals.append(_to_signed64(val))
            elif wt == 2:  # packed
                raw = buf[val[0]:val[1]]
                pos = 0
                while pos < len(raw):
                    v, pos = _read_varint(raw, pos)
                    int_vals.append(_to_signed64(v))
    if content is not None:
        arr = np.frombuffer(content, dtype=dtype)
    elif float_vals:
        arr = np.asarray(float_vals, dtype=dtype)
    elif int_vals:
        arr = np.asarray(int_vals, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:  # splat-encoded constant
        arr = np.full(n, arr[0], dtype=dtype)
    return arr.reshape(shape) if shape else (arr[0] if arr.size == 1 else arr)


def _decode_shape_abs(buf: bytes) -> List[int]:
    dims = []
    for fnum, wt, val in _fields(buf):
        if fnum == 2 and wt == 2:
            dims.append(_decode_dim(buf, val))
    return dims


@dataclass
class AttrValue:
    s: Optional[bytes] = None
    i: Optional[int] = None
    f: Optional[float] = None
    b: Optional[bool] = None
    type: Optional[int] = None
    shape: Optional[List[int]] = None
    tensor: Optional[np.ndarray] = None
    list_i: List[int] = field(default_factory=list)
    list_s: List[bytes] = field(default_factory=list)
    list_f: List[float] = field(default_factory=list)


def _decode_attr_value(buf: bytes) -> AttrValue:
    """AttrValue: list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8."""
    av = AttrValue()
    for fnum, wt, val in _fields(buf):
        if fnum == 1 and wt == 2:  # ListValue
            lv = buf[val[0]:val[1]]
            for f2, w2, v2 in _fields(lv):
                if f2 == 2 and w2 == 2:
                    av.list_s.append(lv[v2[0]:v2[1]])
                elif f2 == 3:
                    if w2 == 0:
                        av.list_i.append(_to_signed64(v2))
                    elif w2 == 2:  # packed
                        raw = lv[v2[0]:v2[1]]
                        pos = 0
                        while pos < len(raw):
                            x, pos = _read_varint(raw, pos)
                            av.list_i.append(_to_signed64(x))
                elif f2 == 4:
                    if w2 == 5:
                        av.list_f.append(struct.unpack("<f", lv[v2[0]:v2[1]])[0])
                    elif w2 == 2:
                        raw = lv[v2[0]:v2[1]]
                        av.list_f.extend(struct.unpack(f"<{len(raw)//4}f", raw))
        elif fnum == 2 and wt == 2:
            av.s = buf[val[0]:val[1]]
        elif fnum == 3 and wt == 0:
            av.i = _to_signed64(val)
        elif fnum == 4 and wt == 5:
            av.f = struct.unpack("<f", buf[val[0]:val[1]])[0]
        elif fnum == 5 and wt == 0:
            av.b = bool(val)
        elif fnum == 6 and wt == 0:
            av.type = val
        elif fnum == 7 and wt == 2:
            av.shape = _decode_shape_abs(buf[val[0]:val[1]])
        elif fnum == 8 and wt == 2:
            av.tensor = _decode_tensor(buf[val[0]:val[1]])
    return av


@dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, AttrValue]


def _decode_node(buf: bytes) -> NodeDef:
    """NodeDef: name=1, op=2, input=3, device=4, attr=5 (map)."""
    name = op = ""
    inputs: List[str] = []
    attrs: Dict[str, AttrValue] = {}
    for fnum, wt, val in _fields(buf):
        if fnum == 1 and wt == 2:
            name = buf[val[0]:val[1]].decode()
        elif fnum == 2 and wt == 2:
            op = buf[val[0]:val[1]].decode()
        elif fnum == 3 and wt == 2:
            inputs.append(buf[val[0]:val[1]].decode())
        elif fnum == 5 and wt == 2:
            entry = buf[val[0]:val[1]]
            k = None
            v = None
            for f2, w2, v2 in _fields(entry):
                if f2 == 1 and w2 == 2:
                    k = entry[v2[0]:v2[1]].decode()
                elif f2 == 2 and w2 == 2:
                    v = _decode_attr_value(entry[v2[0]:v2[1]])
            if k is not None and v is not None:
                attrs[k] = v
    return NodeDef(name, op, inputs, attrs)


def parse_graphdef(data: bytes) -> List[NodeDef]:
    """GraphDef: node=1 (repeated NodeDef)."""
    nodes = []
    for fnum, wt, val in _fields(data):
        if fnum == 1 and wt == 2:
            nodes.append(_decode_node(data[val[0]:val[1]]))
    return nodes


# --------------------------------------------------------------------------
# Encoding (tests build synthetic graphs; also handy for dumping subgraphs)


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wt: int) -> bytes:
    return _varint((fnum << 3) | wt)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def encode_tensor(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dtype_enum = {v: k for k, v in DTYPES.items()}[arr.dtype.type]
    shape = b"".join(_ld(2, _tag(1, 0) + _varint(int(d))) for d in arr.shape)
    out = _tag(1, 0) + _varint(dtype_enum)
    out += _ld(2, shape)
    out += _ld(4, arr.tobytes())
    return out


def encode_attr(av: Dict) -> bytes:
    """Encode an attr dict: {'i': int} | {'f': float} | {'b': bool} |
    {'s': bytes} | {'type': enum} | {'tensor': ndarray} | {'list_i': [...]}"""
    out = b""
    if "list_i" in av:
        lv = b"".join(_tag(3, 0) + _varint(int(x)) for x in av["list_i"])
        out += _ld(1, lv)
    if "s" in av:
        out += _ld(2, av["s"])
    if "i" in av:
        out += _tag(3, 0) + _varint(int(av["i"]))
    if "f" in av:
        out += _tag(4, 5) + struct.pack("<f", float(av["f"]))
    if "b" in av:
        out += _tag(5, 0) + _varint(int(av["b"]))
    if "type" in av:
        out += _tag(6, 0) + _varint(int(av["type"]))
    if "tensor" in av:
        out += _ld(8, encode_tensor(av["tensor"]))
    return out


def encode_node(name: str, op: str, inputs: List[str],
                attrs: Optional[Dict[str, Dict]] = None) -> bytes:
    out = _ld(1, name.encode()) + _ld(2, op.encode())
    for i in inputs:
        out += _ld(3, i.encode())
    for k, v in (attrs or {}).items():
        entry = _ld(1, k.encode()) + _ld(2, encode_attr(v))
        out += _ld(5, entry)
    return out


def encode_graphdef(nodes: List[bytes]) -> bytes:
    return b"".join(_ld(1, n) for n in nodes)
