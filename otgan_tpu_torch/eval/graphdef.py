"""Minimal protobuf wire-format reader and writer for TF1 frozen GraphDefs
(counterpart of ``otgan_tpu/eval/graphdef.py``, pure numpy; the port keeps
its own copy so that it imports nothing of the JAX package).

The reference downloads the frozen TF-2015 ``classify_image_graph_def.pb``
and executes it through a TF session (``utils/inception.py:55-96`` in
openai/ot-gan). This module lets the rebuild read the *weights* out of that
file with **no TensorFlow dependency**: it implements just enough of the
protobuf wire format (varints + length-delimited fields) to walk

    GraphDef { repeated NodeDef node = 1; }
    NodeDef  { string name = 1; string op = 2; repeated string input = 3;
               map<string, AttrValue> attr = 5; }
    AttrValue { ... TensorProto tensor = 8; ... }
    TensorProto { DataType dtype = 1; TensorShapeProto tensor_shape = 2;
                  bytes tensor_content = 4; repeated float float_val = 5;
                  repeated int32 int_val = 7; }
    TensorShapeProto { repeated Dim dim = 2; }  Dim { int64 size = 1; }

and extract every *numeric* ``Const`` node as a numpy array (non-numeric
consts — e.g. the graph's DT_STRING ``DecodeJpeg/contents`` — are skipped). The inverse encoders are
used by the unit tests to synthesize structurally-identical GraphDefs
(SURVEY.md section 4: the reference has no tests; this path is tested
against self-encoded graphs so the real .pb converts on first contact).

Field numbers verified against the public tensorflow .proto definitions
(graph.proto, node_def.proto, attr_value.proto, tensor.proto,
tensor_shape.proto).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# protobuf wire types
_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5

# TF DataType enum values we support (tensor.proto / types.proto)
DT_FLOAT = 1
DT_INT32 = 3
_DTYPES = {DT_FLOAT: np.float32, DT_INT32: np.int32}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf, start: int, end: int) -> Iterator[Tuple[int, int, object]]:
    """Yield ``(field_number, wire_type, value)`` over a message span.
    LEN fields yield ``(start, end)`` spans into ``buf`` (zero-copy)."""
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            val = (pos, pos + n)
            pos += n
        elif wire == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _span_bytes(buf, span) -> bytes:
    return bytes(buf[span[0] : span[1]])


def _parse_tensor_shape(buf, span) -> Tuple[int, ...]:
    dims = []
    for field, _, val in _iter_fields(buf, *span):
        if field == 2:  # Dim
            size = 0
            for f2, _, v2 in _iter_fields(buf, *val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _parse_tensor(buf, span):
    dtype = DT_FLOAT
    shape: Tuple[int, ...] = ()
    content = b""
    scalar_vals: list = []
    for field, wire, val in _iter_fields(buf, *span):
        if field == 1:  # dtype
            dtype = val
        elif field == 2:  # tensor_shape
            shape = _parse_tensor_shape(buf, val)
        elif field == 4:  # tensor_content
            content = _span_bytes(buf, val)
        elif field == 5:  # repeated float float_val (packed or not)
            if wire == _LEN:
                raw = _span_bytes(buf, val)
                scalar_vals.extend(struct.unpack(f"<{len(raw)//4}f", raw))
            else:
                scalar_vals.append(struct.unpack("<f", bytes(val))[0])
        elif field == 7:  # repeated int32 int_val
            if wire == _LEN:
                p, e = val
                while p < e:
                    v, p = _read_varint(buf, p)
                    scalar_vals.append(v)
            else:
                scalar_vals.append(val)
    if dtype not in _DTYPES:
        # the real classify_image graph carries non-numeric Consts
        # (DT_STRING DecodeJpeg/contents, DT_BOOL switches); the converter
        # only needs the float/int weights, so skip rather than abort
        return None
    np_dtype = _DTYPES[dtype]
    n = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, dtype=np_dtype).copy()
    elif scalar_vals:
        arr = np.asarray(scalar_vals, np_dtype)
        if arr.size == 1 and n > 1:  # protobuf scalar broadcast convention
            arr = np.full((n,), arr[0], np_dtype)
    else:
        arr = np.zeros((n,), np_dtype)
    return arr.reshape(shape)


def _parse_attr_entry(buf, span):
    """map<string, AttrValue> entry -> (key, tensor-or-None)."""
    key, tensor = "", None
    for field, _, val in _iter_fields(buf, *span):
        if field == 1:
            key = _span_bytes(buf, val).decode("utf-8")
        elif field == 2:  # AttrValue
            for f2, _, v2 in _iter_fields(buf, *val):
                if f2 == 8:  # tensor
                    tensor = _parse_tensor(buf, v2)
    return key, tensor


def extract_constants(pb_bytes: bytes) -> Dict[str, np.ndarray]:
    """All ``Const`` nodes of a serialized GraphDef as ``{name: array}``."""
    buf = memoryview(pb_bytes)
    consts: Dict[str, np.ndarray] = {}
    for field, _, span in _iter_fields(buf, 0, len(buf)):
        if field != 1:  # GraphDef.node
            continue
        name, op, tensor = "", "", None
        for f, _, val in _iter_fields(buf, *span):
            if f == 1:
                name = _span_bytes(buf, val).decode("utf-8")
            elif f == 2:
                op = _span_bytes(buf, val).decode("utf-8")
            elif f == 5:
                k, t = _parse_attr_entry(buf, val)
                if k == "value" and t is not None:
                    tensor = t
        if op == "Const" and tensor is not None:
            consts[name] = tensor
    return consts


# ---------------------------------------------------------------------------
# encoding (tests + synthetic GraphDefs)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(payload)) + payload


def encode_tensor(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        dt = DT_FLOAT
    elif arr.dtype == np.int32:
        dt = DT_INT32
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    shape = b"".join(
        _len_field(2, _tag(1, _VARINT) + _varint(int(d))) for d in arr.shape
    )
    return (
        _tag(1, _VARINT)
        + _varint(dt)
        + _len_field(2, shape)
        + _len_field(4, arr.tobytes())
    )


def encode_const_node(name: str, arr: np.ndarray) -> bytes:
    attr_value = _len_field(8, encode_tensor(arr))  # AttrValue.tensor
    entry = _len_field(1, b"value") + _len_field(2, attr_value)
    return (
        _len_field(1, name.encode("utf-8"))
        + _len_field(2, b"Const")
        + _len_field(5, entry)
    )


def encode_graphdef(consts: Dict[str, np.ndarray]) -> bytes:
    return b"".join(
        _len_field(1, encode_const_node(k, v)) for k, v in consts.items()
    )
