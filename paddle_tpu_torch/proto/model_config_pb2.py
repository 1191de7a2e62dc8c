"""The messages of ``model_config.proto`` as plain Python classes, on a
codec of the port's own — counterpart of
``paddle_tpu/proto/model_config_pb2.py``, which protoc generates for
``google.protobuf``.  The port does not use ``google.protobuf``.

The classes are built at import from ``model_config.proto`` beside this
module, so the schema has one source.  For exactly the constructs that
schema uses (proto3; ``int32``, ``int64``, ``uint64``, ``bool``,
``double`` and ``string`` scalars; message fields; ``repeated``; ``oneof``)
they give:

- the binary wire format: ``SerializeToString`` / ``ParseFromString``.
  Scalars at their default are not written (a ``double`` is written unless
  all its bits are zero, so ``-0.0`` is); repeated numbers are packed;
  negative ``int32``/``int64`` are 10-byte varints; a oneof member that was
  set, even to an empty message, is written; fields go in field-number
  order; unknown fields are skipped on parse;
- the text format: ``message_to_string`` / ``parse`` (the reference's
  ``text_format.MessageToString`` / ``text_format.Parse`` with their
  defaults: UTF-8 kept, control characters as octal escapes, ``true`` /
  ``false``, a double's shortest ``repr`` with ``inf``/``-inf``/``nan``);
- the message API the config tier uses: keyword construction, attribute
  access, ``add``/``append``/``extend`` on repeated fields, ``CopyFrom``,
  ``MergeFrom``, ``Clear``, ``ClearField``, ``HasField``, ``SetInParent``,
  ``WhichOneof``, ``ListFields``, ``ByteSize`` and ``==``.

As in ``google.protobuf``, reading a message field never sets it; writing
any field inside it does (and clears the other members of its oneof).
"""

from __future__ import annotations

import operator
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Message", "DecodeError", "ParseError", "message_to_string",
           "parse", "MESSAGES"]

_SCALARS = ("int32", "int64", "uint64", "bool", "double", "string")
_MASK64 = (1 << 64) - 1
_RANGES = {"int32": (-(1 << 31), (1 << 31) - 1),
           "int64": (-(1 << 63), (1 << 63) - 1),
           "uint64": (0, _MASK64)}


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class ParseError(ValueError):
    """Text that is not a valid text-format encoding of the message."""


class _Field:
    __slots__ = ("name", "number", "type", "repeated", "oneof", "cls")

    def __init__(self, name, number, type_, repeated, oneof):
        self.name, self.number, self.type = name, number, type_
        self.repeated, self.oneof = repeated, oneof
        self.cls = None  # the message class of a message field

    @property
    def is_message(self) -> bool:
        return self.cls is not None

    def __repr__(self):
        return f"<field {self.name}={self.number} {self.type}>"


# ---------------------------------------------------------------------------
# scalar values
# ---------------------------------------------------------------------------


def _default(typ: str):
    return {"bool": False, "double": 0.0, "string": ""}.get(typ, 0)


def _coerce(typ: str, value, name: str):
    if typ == "string":
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"field {name!r} takes str, got "
                            f"{type(value).__name__}")
        return value
    if typ == "double":
        if isinstance(value, (str, bytes)) or not hasattr(value, "__float__"):
            raise TypeError(f"field {name!r} takes a number, got "
                            f"{type(value).__name__}")
        return float(value)
    try:
        v = operator.index(value)
    except TypeError:
        raise TypeError(f"field {name!r} takes an integer, got "
                        f"{type(value).__name__}") from None
    if typ == "bool":
        return bool(v)
    lo, hi = _RANGES[typ]
    if not lo <= v <= hi:
        raise ValueError(f"value {v} out of range for {typ} field {name!r}")
    return v


def _nonzero(typ: str, v) -> bool:
    if typ == "double":
        return struct.pack("<d", v) != bytes(8)
    return bool(v)


def _varint(out: bytearray, v: int) -> None:
    v &= _MASK64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(data, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end or shift >= 70:
            raise DecodeError("truncated or overlong varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7


def _encode_scalar(out: bytearray, typ: str, v) -> None:
    """The value alone (no key) in its wire form."""
    if typ == "double":
        out += struct.pack("<d", v)
    elif typ == "string":
        b = v.encode("utf-8")
        _varint(out, len(b))
        out += b
    else:
        _varint(out, int(v))


def _wire_type(typ: str) -> int:
    return {"double": 1, "string": 2}.get(typ, 0)


def _decode_int(typ: str, v: int):
    if typ == "bool":
        return v != 0
    if typ == "int32":
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    if typ == "int64":
        return v - (1 << 64) if v >= 1 << 63 else v
    return v


# ---------------------------------------------------------------------------
# repeated fields
# ---------------------------------------------------------------------------


class _Repeated(list):
    """A repeated field: a list that tells its message when it changes
    (writing into a message field's repeated field sets that field)."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner: "Message", field: _Field):
        super().__init__()
        self._owner, self._field = owner, field

    def _item(self, v):
        f = self._field
        if f.is_message:
            if not isinstance(v, f.cls):
                raise TypeError(f"field {f.name!r} takes {f.cls.__name__}, "
                                f"got {type(v).__name__}")
            m = f.cls()
            m.MergeFrom(v)
            object.__setattr__(m, "_parent", (self._owner, None))
            return m
        return _coerce(f.type, v, f.name)

    def add(self, **kwargs) -> "Message":
        f = self._field
        if not f.is_message:
            raise AttributeError(f"repeated scalar field {f.name!r} has no "
                                 f"add(); use append()")
        m = f.cls(**kwargs)
        object.__setattr__(m, "_parent", (self._owner, None))
        super().append(m)
        self._owner._touch()
        return m

    def append(self, v) -> None:
        super().append(self._item(v))
        self._owner._touch()

    def extend(self, vs) -> None:
        items = [self._item(v) for v in vs]
        super().extend(items)
        if items:
            self._owner._touch()

    def insert(self, i, v) -> None:
        super().insert(i, self._item(v))
        self._owner._touch()

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            super().__setitem__(i, [self._item(x) for x in v])
        else:
            super().__setitem__(i, self._item(v))
        self._owner._touch()

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._owner._touch()

    def pop(self, i=-1):
        v = super().pop(i)
        self._owner._touch()
        return v

    def remove(self, v) -> None:
        super().remove(v)
        self._owner._touch()

    def clear(self) -> None:
        super().clear()
        self._owner._touch()

    def sort(self, *args, **kwargs) -> None:
        super().sort(*args, **kwargs)
        self._owner._touch()


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


class Message:
    """Base of the schema's message classes (built from the ``.proto``)."""

    __slots__ = ("_values", "_present", "_parent")
    _fields: Dict[str, _Field] = {}
    _by_number: Dict[int, _Field] = {}
    _ordered: Tuple[_Field, ...] = ()
    _oneofs: Dict[str, Tuple[str, ...]] = {}

    def __init__(self, **kwargs) -> None:
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for name, v in kwargs.items():
            f = self._field(name)
            if v is None:
                continue
            if f.repeated:
                getattr(self, name).extend(v)
            elif f.is_message:
                getattr(self, name).CopyFrom(v)
            else:
                setattr(self, name, v)

    @classmethod
    def _field(cls, name: str) -> _Field:
        f = cls._fields.get(name)
        if f is None:
            raise AttributeError(f"{cls.__name__} has no field {name!r}")
        return f

    # -- attribute access -------------------------------------------------

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        vals = self._values
        if name in vals:
            return vals[name]
        if f.repeated:
            v = vals[name] = _Repeated(self, f)
            return v
        if f.is_message:
            child = f.cls()
            object.__setattr__(child, "_parent", (self, name))
            vals[name] = child
            return child
        return _default(f.type)

    def __setattr__(self, name: str, value) -> None:
        f = self._field(name)
        if f.repeated or f.is_message:
            raise AttributeError(
                f"assignment not allowed to {'repeated' if f.repeated else 'message'}"
                f" field {name!r} of {type(self).__name__}")
        self._values[name] = _coerce(f.type, value, name)
        self._touch()

    def _touch(self) -> None:
        """A field of this message was written: mark it set in its parent
        (and the parent in its own), as ``google.protobuf`` does."""
        link = self._parent
        if link is None:
            return
        parent, name = link
        if name is not None:
            parent._set_present(name)
        parent._touch()

    def _set_present(self, name: str) -> None:
        if name in self._present:
            return
        f = self._fields[name]
        if f.oneof is not None:
            for other in self._oneofs[f.oneof]:
                if other != name:
                    self._drop(other)
        self._present.add(name)

    def _drop(self, name: str) -> None:
        v = self._values.pop(name, None)
        if isinstance(v, Message):
            object.__setattr__(v, "_parent", None)
        self._present.discard(name)

    # -- the message API --------------------------------------------------

    def HasField(self, name: str) -> bool:
        if name in self._oneofs:
            return self.WhichOneof(name) is not None
        f = self._field(name)
        if not f.is_message or f.repeated:
            raise ValueError(f"field {name!r} of {type(self).__name__} has "
                             f"no presence (proto3 scalar or repeated)")
        return name in self._present

    def WhichOneof(self, oneof: str) -> Optional[str]:
        members = self._oneofs.get(oneof)
        if members is None:
            raise ValueError(f"{type(self).__name__} has no oneof {oneof!r}")
        for m in members:
            if m in self._present:
                return m
        return None

    def ClearField(self, name: str) -> None:
        if name in self._oneofs:
            for m in self._oneofs[name]:
                self._drop(m)
            return
        self._field(name)
        self._drop(name)

    def Clear(self) -> None:
        for name in list(self._values):
            self._drop(name)

    def SetInParent(self) -> None:
        self._touch()

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)
        self._touch()

    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            f"{type(self).__name__}")
        data = other.SerializeToString()
        self._merge(memoryview(data), 0, len(data))
        self._touch()

    def ListFields(self) -> List[Tuple[_Field, Any]]:
        out = []
        for f in self._ordered:
            v = self._values.get(f.name)
            if f.repeated:
                if v:
                    out.append((f, v))
            elif f.is_message:
                if f.name in self._present:
                    out.append((f, v))
            elif v is not None and _nonzero(f.type, v):
                out.append((f, v))
        return out

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    __hash__ = None  # mutable, as google.protobuf's messages

    def __repr__(self) -> str:
        return message_to_string(self)

    # -- binary wire format -----------------------------------------------

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray) -> None:
        for f, v in self.ListFields():
            if f.is_message:
                for m in (v if f.repeated else (v,)):
                    _varint(out, f.number << 3 | 2)
                    body = m.SerializeToString()
                    _varint(out, len(body))
                    out += body
            elif f.repeated and f.type != "string":
                payload = bytearray()  # packed
                for x in v:
                    _encode_scalar(payload, f.type, x)
                _varint(out, f.number << 3 | 2)
                _varint(out, len(payload))
                out += payload
            else:
                for x in (v if f.repeated else (v,)):
                    _varint(out, f.number << 3 | _wire_type(f.type))
                    _encode_scalar(out, f.type, x)

    def ParseFromString(self, data: bytes) -> int:
        self.Clear()
        mv = memoryview(bytes(data))
        self._merge(mv, 0, len(mv))
        self._touch()
        return len(mv)

    def _merge(self, data, pos: int, end: int) -> None:
        while pos < end:
            key, pos = _read_varint(data, pos, end)
            number, wt = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            start = pos
            if wt == 0:
                raw, pos = _read_varint(data, pos, end)
            elif wt == 1:
                pos += 8
            elif wt == 5:
                pos += 4
            elif wt == 2:
                n, start = _read_varint(data, pos, end)
                pos = start + n
            elif wt == 3:
                pos = _skip_group(data, pos, end, number)
            else:
                raise DecodeError(f"unexpected wire type {wt}")
            if pos > end:
                raise DecodeError("truncated message")
            f = self._by_number.get(number)
            if f is None:
                continue  # unknown field: skipped
            self._merge_field(f, wt, data, start, pos,
                              raw if wt == 0 else None)

    def _merge_field(self, f: _Field, wt: int, data, start: int, stop: int,
                     raw: Optional[int]) -> None:
        typ = f.type
        if f.is_message:
            if wt != 2:
                return  # a known number with a foreign wire type: unknown
            if f.repeated:
                child = getattr(self, f.name).add()
            else:
                child = getattr(self, f.name)
                self._set_present(f.name)
            child._merge(data, start, stop)
            return
        if f.repeated and wt == 2 and typ != "string":
            vals = []
            pos = start
            while pos < stop:
                if typ == "double":
                    if pos + 8 > stop:
                        raise DecodeError("truncated packed double")
                    vals.append(struct.unpack_from("<d", data, pos)[0])
                    pos += 8
                else:
                    v, pos = _read_varint(data, pos, stop)
                    vals.append(_decode_int(typ, v))
            list.extend(getattr(self, f.name), vals)
            return
        if wt != _wire_type(typ):
            return
        if typ == "double":
            v = struct.unpack_from("<d", data, start)[0]
        elif typ == "string":
            try:
                v = bytes(data[start:stop]).decode("utf-8")
            except UnicodeDecodeError as e:
                raise DecodeError(f"field {f.name!r}: invalid UTF-8: {e}")
        else:
            v = _decode_int(typ, raw)
        if f.repeated:
            list.append(getattr(self, f.name), v)
        else:
            self._values[f.name] = v


def _skip_group(data, pos: int, end: int, number: int) -> int:
    while True:
        key, pos = _read_varint(data, pos, end)
        wt = key & 7
        if wt == 4:
            if key >> 3 != number:
                raise DecodeError("mismatched end group")
            return pos
        if wt == 0:
            _, pos = _read_varint(data, pos, end)
        elif wt == 1:
            pos += 8
        elif wt == 5:
            pos += 4
        elif wt == 2:
            n, pos = _read_varint(data, pos, end)
            pos += n
        elif wt == 3:
            pos = _skip_group(data, pos, end, key >> 3)
        else:
            raise DecodeError(f"unexpected wire type {wt}")
        if pos > end:
            raise DecodeError("truncated group")


# ---------------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------------

_STR_ESCAPES = {i: "\\%03o" % i for i in range(128) if not 32 <= i < 127}
_STR_ESCAPES.update({ord("\t"): "\\t", ord("\n"): "\\n", ord("\r"): "\\r",
                     ord('"'): '\\"', ord("'"): "\\'", ord("\\"): "\\\\"})


def _text_scalar(typ: str, v) -> str:
    if typ == "string":
        return '"' + v.translate(_STR_ESCAPES) + '"'
    if typ == "bool":
        return "true" if v else "false"
    return str(v)  # a double's shortest repr; inf, -inf, nan


def message_to_string(msg: Message) -> str:
    """The text format of ``msg`` (``text_format.MessageToString`` with
    its defaults)."""
    out: List[str] = []
    _print(msg, out, 0)
    return "".join(out)


def _print(msg: Message, out: List[str], indent: int) -> None:
    pad = " " * indent
    for f, v in msg.ListFields():
        for x in (v if f.repeated else (v,)):
            if f.is_message:
                out.append(f"{pad}{f.name} {{\n")
                _print(x, out, indent + 2)
                out.append(f"{pad}}}\n")
            else:
                out.append(f"{pad}{f.name}: {_text_scalar(f.type, x)}\n")


_TOKEN = re.compile(r"""
    (?P<space>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<punct>[{}<>:\[\],;])
  | (?P<word>[-+]?(?:[\w.]*[eE][-+]?[\w.]+|[\w.]+))
""", re.VERBOSE)


def _tokens(text: str) -> List[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ParseError(f"unexpected character {text[pos]!r} at "
                             f"offset {pos}")
        pos = m.end()
        if m.lastgroup != "space":
            toks.append(m.group())
    return toks


_ESC = {"n": b"\n", "t": b"\t", "r": b"\r", '"': b'"', "'": b"'",
        "\\": b"\\", "a": b"\a", "b": b"\b", "f": b"\f", "v": b"\v",
        "?": b"?"}


def _unescape(body: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        i += 1
        c = body[i]
        if c in _ESC:
            out += _ESC[c]
            i += 1
        elif c in "01234567":
            m = re.match(r"[0-7]{1,3}", body[i:])
            out.append(int(m.group(), 8) & 0xFF)
            i += len(m.group())
        elif c in "xX":
            m = re.match(r"[0-9a-fA-F]{1,2}", body[i + 1:])
            if m is None:
                raise ParseError("\\x escape without hex digits")
            out.append(int(m.group(), 16))
            i += 1 + len(m.group())
        elif c in "uU":
            n = 4 if c == "u" else 8
            out += chr(int(body[i + 1:i + 1 + n], 16)).encode("utf-8")
            i += 1 + n
        else:
            raise ParseError(f"invalid escape \\{c}")
    return bytes(out)


def _parse_int(tok: str) -> int:
    s = tok.lower()
    neg = s.startswith("-")
    digits = s.lstrip("+-")
    if digits.startswith("0x"):
        v = int(digits[2:], 16)
    elif len(digits) > 1 and digits.startswith("0"):
        v = int(digits[1:], 8)
    else:
        v = int(digits, 10)
    return -v if neg else v


def _parse_scalar(f: _Field, toks: List[str], i: int):
    tok = toks[i]
    typ = f.type
    try:
        if typ == "string":
            if tok[:1] not in "\"'":
                raise ParseError(f"field {f.name!r}: expected a string, "
                                 f"got {tok!r}")
            raw = bytearray()
            while i < len(toks) and toks[i][:1] in ("\"", "'"):
                raw += _unescape(toks[i][1:-1])
                i += 1
            return raw.decode("utf-8"), i
        if typ == "bool":
            if tok in ("true", "True", "t", "1"):
                return True, i + 1
            if tok in ("false", "False", "f", "0"):
                return False, i + 1
            raise ParseError(f"field {f.name!r}: expected a bool, got {tok!r}")
        if typ == "double":
            low = tok.lower()
            sign = -1.0 if low.startswith("-") else 1.0
            body = low.lstrip("+-")
            if body in ("inf", "infinity", "inff", "infinityf"):
                return sign * float("inf"), i + 1
            if body in ("nan", "nanf"):
                return float("nan"), i + 1
            return float(low[:-1] if low.endswith("f") else low), i + 1
        v = _parse_int(tok)
        lo, hi = _RANGES[typ]
        if not lo <= v <= hi:
            raise ParseError(f"value {v} out of range for {typ} field "
                             f"{f.name!r}")
        return v, i + 1
    except ValueError as e:
        if isinstance(e, ParseError):
            raise
        raise ParseError(f"field {f.name!r}: cannot parse {tok!r} as "
                         f"{typ}") from None


def _parse_body(msg: Message, toks: List[str], i: int,
                close: Optional[str]) -> int:
    seen = set()
    while True:
        if i >= len(toks):
            if close is None:
                return i
            raise ParseError(f"expected {close!r} before the end of input")
        tok = toks[i]
        if tok == close:
            return i + 1
        f = type(msg)._fields.get(tok)
        if f is None:
            raise ParseError(f"{type(msg).__name__} has no field {tok!r}")
        i += 1
        if not f.repeated:
            if f.name in seen or (f.oneof is not None and
                                  msg.WhichOneof(f.oneof) not in (None,
                                                                 f.name)):
                raise ParseError(f"{type(msg).__name__}: field {f.name!r} "
                                 f"given more than once")
            seen.add(f.name)
        if i < len(toks) and toks[i] == ":":
            i += 1
        elif not f.is_message:
            raise ParseError(f"expected ':' after {f.name!r}")
        if i < len(toks) and toks[i] == "[":
            if not f.repeated:
                raise ParseError(f"list value for non-repeated {f.name!r}")
            i += 1
            while toks[i] != "]":
                i = _parse_value(msg, f, toks, i)
                if toks[i] == ",":
                    i += 1
            i += 1
        else:
            i = _parse_value(msg, f, toks, i)
        if i < len(toks) and toks[i] in (",", ";"):
            i += 1


def _parse_value(msg: Message, f: _Field, toks: List[str], i: int) -> int:
    if i >= len(toks):
        raise ParseError(f"missing value for {f.name!r}")
    if f.is_message:
        opener = toks[i]
        if opener not in ("{", "<"):
            raise ParseError(f"expected '{{' after {f.name!r}, got "
                             f"{opener!r}")
        if f.repeated:
            child = getattr(msg, f.name).add()
        else:
            child = getattr(msg, f.name)
            child.SetInParent()
        return _parse_body(child, toks, i + 1,
                           "}" if opener == "{" else ">")
    v, i = _parse_scalar(f, toks, i)
    if f.repeated:
        getattr(msg, f.name).append(v)
    else:
        setattr(msg, f.name, v)
    return i


def parse(text: str, msg: Message) -> Message:
    """Merge the text format ``text`` into ``msg`` (``text_format.Parse``);
    returns ``msg``."""
    _parse_body(msg, _tokens(text), 0, None)
    return msg


# ---------------------------------------------------------------------------
# the schema, read from model_config.proto
# ---------------------------------------------------------------------------

_PROTO_TOKEN = re.compile(r'\s+|//[^\n]*|/\*.*?\*/|("[^"]*"|[{};=]|[\w.]+)',
                          re.S)


def _load_schema(path: str) -> Dict[str, type]:
    toks = [m.group(1) for m in _PROTO_TOKEN.finditer(open(path).read())
            if m.group(1)]
    specs: Dict[str, List[_Field]] = {}
    i = 0

    def field(i, oneof):
        repeated = toks[i] == "repeated"
        if repeated:
            i += 1
        typ, name, eq, num, semi = toks[i:i + 5]
        if eq != "=" or semi != ";":
            raise SyntaxError(f"{path}: bad field near {name!r}")
        return _Field(name, int(num), typ, repeated, oneof), i + 5

    while i < len(toks):
        if toks[i] in ("syntax", "package"):
            i = toks.index(";", i) + 1
        elif toks[i] == "message":
            name, fields = toks[i + 1], []
            i += 3
            while toks[i] != "}":
                if toks[i] == "oneof":
                    oneof = toks[i + 1]
                    i += 3
                    while toks[i] != "}":
                        f, i = field(i, oneof)
                        fields.append(f)
                    i += 1
                else:
                    f, i = field(i, None)
                    fields.append(f)
            specs[name] = fields
            i += 1
        else:
            raise SyntaxError(f"{path}: unexpected {toks[i]!r}")
    classes: Dict[str, type] = {}
    for name, fields in specs.items():
        oneofs: Dict[str, Tuple[str, ...]] = {}
        for f in fields:
            if f.oneof is not None:
                oneofs[f.oneof] = oneofs.get(f.oneof, ()) + (f.name,)
        classes[name] = type(name, (Message,), {
            "__slots__": (), "__module__": __name__,
            "_fields": {f.name: f for f in fields},
            "_by_number": {f.number: f for f in fields},
            "_ordered": tuple(sorted(fields, key=lambda f: f.number)),
            "_oneofs": oneofs,
        })
    for fields in specs.values():
        for f in fields:
            if f.type not in _SCALARS:
                f.cls = classes[f.type]
    return classes


#: message name -> class, in the order of the ``.proto``
MESSAGES = _load_schema(os.path.join(os.path.dirname(__file__),
                                     "model_config.proto"))
globals().update(MESSAGES)
__all__ += list(MESSAGES)
