"""ctypes wrapper for the native MPT engine (`native/mpt.cpp`) — the
merkleize hot path of execution.

The engine owns a persistent node map mirroring the Python node table and
pulls nodes it lacks through a resolver upcall — one callback per unique
node over the engine's lifetime, so repeated applies touch Python only
for genuinely new paths.  Held against trie/trie.py, which stays the
behavioral oracle.  The library is built at first use by
`ethrex_tpu_torch.native`; a failed build raises.
"""

from __future__ import annotations

import ctypes
import struct

from .. import native
from ..crypto.keccak import keccak256
from .trie import MissingNode

_RESOLVER_TYPE = ctypes.CFUNCTYPE(ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_ubyte))


def _bind(lib) -> None:
    lib.mpt_new.restype = ctypes.c_void_p
    lib.mpt_free.argtypes = [ctypes.c_void_p]
    lib.mpt_set_resolver.argtypes = [ctypes.c_void_p, _RESOLVER_TYPE]
    lib.mpt_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_size_t]
    lib.mpt_load.restype = ctypes.c_int
    lib.mpt_apply.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p]
    lib.mpt_apply.restype = ctypes.c_int
    lib.mpt_missing.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.mpt_missing.restype = ctypes.c_int
    lib.mpt_fresh_size.argtypes = [ctypes.c_void_p]
    lib.mpt_fresh_size.restype = ctypes.c_size_t
    lib.mpt_take_fresh.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.mpt_take_fresh.restype = ctypes.c_int
    lib.mpt_node_count.argtypes = [ctypes.c_void_p]
    lib.mpt_node_count.restype = ctypes.c_size_t


def _load():
    return native.load("mpt", _bind)


def available() -> bool:
    """True once the engine is built and loaded; a failed build raises
    (`native.BuildError`)."""
    _load()
    return True


class NativeMpt:
    """One engine instance per node table (Store or witness)."""

    def __init__(self):
        lib = _load()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.mpt_new())
        self._known: set[bytes] = set()
        self._table = None  # active node table during apply

        def _resolve(hash_ptr):
            h = bytes(hash_ptr[0:32])
            raw = self._table.get(h) if self._table is not None else None
            if raw is None:
                return 0
            raw = bytes(raw)
            buf = struct.pack("<I", len(raw)) + raw
            self._lib.mpt_load(self._h, buf, len(buf))
            self._known.add(h)
            return 1

        # keep a reference: ctypes callbacks die with their wrapper object
        self._resolver_cb = _RESOLVER_TYPE(_resolve)
        lib.mpt_set_resolver(self._h, self._resolver_cb)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mpt_free(h)
            self._h = None

    def _feed(self, raws: list[bytes]) -> None:
        raws = [r for r in raws
                if keccak256(r) not in self._known]
        if not raws:
            return
        buf = b"".join(struct.pack("<I", len(r)) + r for r in raws)
        rc = self._lib.mpt_load(self._h, buf, len(buf))
        if rc < 0:
            raise RuntimeError("mpt_load rejected input")
        for r in raws:
            self._known.add(keccak256(r))

    def apply(self, table, root: bytes, ops: list[tuple[bytes, bytes]]
              ) -> bytes:
        """Apply ordered (key, value) ops (empty value = delete) against
        `root`; commit; persist new nodes back into `table`; return the
        new root.  Raises MissingNode exactly like the Python trie when
        the table lacks a required node."""
        lib = self._lib
        buf = b"".join(
            struct.pack("<I", len(k)) + k + struct.pack("<I", len(v)) + v
            for k, v in ops)
        out = ctypes.create_string_buffer(32)
        self._table = table
        try:
            rc = lib.mpt_apply(self._h, root, buf, len(buf), out)
        finally:
            self._table = None
        if rc == 1:
            miss_buf = ctypes.create_string_buffer(32 * 64)
            n = lib.mpt_missing(self._h, miss_buf, len(miss_buf))
            h = miss_buf.raw[:32] if n else b""
            raise MissingNode(h.hex())
        if rc != 0:
            raise RuntimeError(f"mpt_apply failed rc={rc}")
        size = lib.mpt_fresh_size(self._h)
        if size:
            fresh = ctypes.create_string_buffer(size)
            n = lib.mpt_take_fresh(self._h, fresh, size)
            if n < 0:
                raise RuntimeError("mpt_take_fresh overflow")
            pos = 0
            raw = fresh.raw
            for _ in range(n):
                (ln,) = struct.unpack_from("<I", raw, pos)
                pos += 4
                node = raw[pos:pos + ln]
                pos += ln
                h = keccak256(node)
                table[h] = node
                self._known.add(h)
        return bytes(out.raw)
