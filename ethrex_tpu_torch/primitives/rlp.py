"""RLP encoding/decoding: a copy of `ethrex_tpu/primitives/rlp.py`
(implemented from the RLP spec).

Values are bytes, ints (big-endian minimal), or (possibly nested) lists.
Decoding returns (item, rest) pairs internally; public decode() requires the
input to be fully consumed.
"""

from __future__ import annotations


class RLPError(ValueError):
    pass


def encode_int(v: int) -> bytes:
    if v < 0:
        raise RLPError("cannot RLP-encode negative int")
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def encode(item) -> bytes:
    if isinstance(item, int):
        return encode(encode_int(item))
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _encode_length(len(b), 0x80) + b
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RLPError(f"cannot RLP-encode {type(item)}")


def _encode_length(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = encode_int(n)
    return bytes([offset + 55 + len(nb)]) + nb


def decode(data: bytes):
    """Decode a single item; error if trailing bytes remain."""
    item, rest = decode_prefix(data)
    if rest:
        raise RLPError(f"{len(rest)} trailing bytes after RLP item")
    return item


def decode_prefix(data: bytes):
    """Decode one item from the front; returns (item, remaining_bytes).

    bytes payloads decode to bytes; lists decode to Python lists.
    """
    if not data:
        raise RLPError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes([b0]), data[1:]
    if b0 < 0xB8:                      # short string
        ln = b0 - 0x80
        _need(data, 1 + ln)
        payload = data[1:1 + ln]
        if ln == 1 and payload[0] < 0x80:
            raise RLPError("non-canonical single byte encoding")
        return payload, data[1 + ln:]
    if b0 < 0xC0:                      # long string
        lln = b0 - 0xB7
        _need(data, 1 + lln)
        ln = int.from_bytes(data[1:1 + lln], "big")
        if ln < 56 or (lln > 1 and data[1] == 0):
            raise RLPError("non-canonical length encoding")
        _need(data, 1 + lln + ln)
        return data[1 + lln:1 + lln + ln], data[1 + lln + ln:]
    if b0 < 0xF8:                      # short list
        ln = b0 - 0xC0
        _need(data, 1 + ln)
        return _decode_list(data[1:1 + ln]), data[1 + ln:]
    lln = b0 - 0xF7                    # long list
    _need(data, 1 + lln)
    ln = int.from_bytes(data[1:1 + lln], "big")
    if ln < 56 or (lln > 1 and data[1] == 0):
        raise RLPError("non-canonical length encoding")
    _need(data, 1 + lln + ln)
    return _decode_list(data[1 + lln:1 + lln + ln]), data[1 + lln + ln:]


def _decode_list(payload: bytes) -> list:
    out = []
    while payload:
        item, payload = decode_prefix(payload)
        out.append(item)
    return out


def _need(data: bytes, n: int):
    if len(data) < n:
        raise RLPError("truncated RLP input")


def decode_int(b: bytes) -> int:
    if isinstance(b, list):
        raise RLPError("expected bytes, got list")
    if b and b[0] == 0:
        raise RLPError("leading zero in RLP integer")
    return int.from_bytes(b, "big") if b else 0
