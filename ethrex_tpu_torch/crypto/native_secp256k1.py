"""ctypes wrapper for the native secp256k1 engine (`native/secp256k1.c`)
— the sender-recovery hot path of execution.

Exposes single and batch ecrecover entry points.  ctypes releases the GIL
for the duration of each call, so a thread pool over ``recover_batch``
slices gets real parallelism on multi-core hosts.  Held against
crypto/secp256k1.py's ``recover``, which stays the behavioral oracle:
the native engine accepts exactly the inputs the pure-Python ``recover``
accepts and returns the identical point.  The library is built at first
use by `ethrex_tpu_torch.native`; a failed build raises.
"""

from __future__ import annotations

import ctypes

from .. import native


def _bind(lib) -> None:
    lib.secp256k1_recover.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_char_p]
    lib.secp256k1_recover.restype = ctypes.c_int
    lib.secp256k1_recover_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p]
    lib.secp256k1_recover_batch.restype = ctypes.c_int


def _load():
    return native.load("secp256k1", _bind)


def available() -> bool:
    """True once the engine is built and loaded; a failed build raises
    (`native.BuildError`)."""
    _load()
    return True


def recover(msg_hash: bytes, r: int, s: int, rec_id: int):
    """Native ecrecover; returns the affine point (x, y) or None.

    Same acceptance set as crypto.secp256k1.recover.  Raises
    ``native.BuildError`` if the library does not build or load.
    """
    lib = _load()
    if not (0 <= r < (1 << 256) and 0 <= s < (1 << 256)
            and 0 <= rec_id <= 3):
        return None
    out = ctypes.create_string_buffer(64)
    rc = lib.secp256k1_recover(
        msg_hash, r.to_bytes(32, "big"), s.to_bytes(32, "big"),
        rec_id, out)
    if rc != 1:
        return None
    raw = out.raw
    return (int.from_bytes(raw[:32], "big"),
            int.from_bytes(raw[32:], "big"))


def recover_pubkey_bytes(msg_hash: bytes, r: int, s: int, rec_id: int):
    """Like ``recover`` but returns the raw 64-byte x||y encoding
    (what address derivation hashes), avoiding two int round-trips."""
    lib = _load()
    if not (0 <= r < (1 << 256) and 0 <= s < (1 << 256)
            and 0 <= rec_id <= 3):
        return None
    out = ctypes.create_string_buffer(64)
    rc = lib.secp256k1_recover(
        msg_hash, r.to_bytes(32, "big"), s.to_bytes(32, "big"),
        rec_id, out)
    return out.raw if rc == 1 else None


def recover_batch(items):
    """Batch ecrecover over ``[(msg_hash, r, s, rec_id), ...]``.

    Returns a list aligned with the input: a 64-byte x||y pubkey per
    recovered signature, None per invalid one.  One C call for the whole
    batch — the GIL is released throughout, which is what makes pool
    workers scale.
    """
    lib = _load()
    n = len(items)
    if n == 0:
        return []
    msgs = bytearray(32 * n)
    rs = bytearray(32 * n)
    ss = bytearray(32 * n)
    recs = (ctypes.c_int32 * n)()
    skip = [False] * n
    for i, (msg, r, s, rec_id) in enumerate(items):
        if not (0 <= r < (1 << 256) and 0 <= s < (1 << 256)
                and 0 <= rec_id <= 3):
            skip[i] = True
            rec_id = -1  # native rejects out-of-range rec_id
            r = s = 0
        msgs[32 * i:32 * i + 32] = msg
        rs[32 * i:32 * i + 32] = r.to_bytes(32, "big")
        ss[32 * i:32 * i + 32] = s.to_bytes(32, "big")
        recs[i] = rec_id
    out = ctypes.create_string_buffer(64 * n)
    ok = ctypes.create_string_buffer(n)
    lib.secp256k1_recover_batch(
        bytes(msgs), bytes(rs), bytes(ss), recs, n, out, ok)
    raw, flags = out.raw, ok.raw
    return [raw[64 * i:64 * i + 64] if (flags[i] and not skip[i]) else None
            for i in range(n)]
