"""Merkle Patricia Trie: a copy of `ethrex_tpu/trie/trie.py` (get,
insert, remove, hash, from_nodes; implemented from the MPT specification).

In-memory node objects with lazy resolution from a node store, so the same
type serves two roles:
  * mutable state/storage tries (node store = dict, backed by Storage later)
  * witness tries for stateless execution (`from_nodes`: partial node sets;
    touching a missing node raises MissingNode — mirrors the guest program's
    pruned-trie behavior, reference crates/common/types/block_execution_witness.rs)

Nodes: None (empty), ("leaf", nibbles, value), ("ext", nibbles, child),
("branch", [16 children], value), ("ref", hash_or_inline) unresolved.
Child references: inline RLP if < 32 bytes else keccak256(rlp).
"""

from __future__ import annotations

from ..crypto.keccak import keccak256
from ..primitives import rlp
from ..primitives.account import EMPTY_TRIE_ROOT


class MissingNode(Exception):
    """A referenced node is absent from the node store (pruned witness)."""


def bytes_to_nibbles(key: bytes) -> tuple:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return tuple(out)


def hp_encode(nibbles: tuple, is_leaf: bool) -> bytes:
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2:
        first = bytes([(flag + 1) << 4 | nibbles[0]])
        rest = nibbles[1:]
    else:
        first = bytes([flag << 4])
        rest = nibbles
    return first + bytes(
        (rest[i] << 4) | rest[i + 1] for i in range(0, len(rest), 2)
    )


def hp_decode(data: bytes) -> tuple[tuple, bool]:
    if not data:
        raise ValueError("empty hex-prefix payload")
    flag = data[0] >> 4
    is_leaf = bool(flag & 2)
    nibbles = []
    if flag & 1:
        nibbles.append(data[0] & 0xF)
    for b in data[1:]:
        nibbles.append(b >> 4)
        nibbles.append(b & 0xF)
    return tuple(nibbles), is_leaf


class Trie:
    def __init__(self, nodes: dict | None = None):
        """nodes: hash -> encoded node (the backing store for refs)."""
        self._store = nodes if nodes is not None else {}
        self._root = None

    # ------------------------------------------------------------------
    # construction from a node set (witness / proof)
    # ------------------------------------------------------------------
    @classmethod
    def from_nodes(cls, root_hash: bytes, nodes: list[bytes] | dict,
                   share: bool = False) -> "Trie":
        """share=True uses the given dict as the live backing store (the
        node database of a Store) instead of copying it."""
        if isinstance(nodes, (list, tuple)):
            store = {keccak256(n): bytes(n) for n in nodes}
        else:  # dict-like (incl. recording wrappers)
            store = nodes if share else dict(nodes)
        t = cls(store)
        if root_hash == EMPTY_TRIE_ROOT:
            t._root = None
        else:
            t._root = ("ref", root_hash)
        return t

    # ------------------------------------------------------------------
    # node resolution / encoding
    # ------------------------------------------------------------------
    def _resolve(self, node):
        while node is not None and node[0] == "ref":
            ref = node[1]
            if isinstance(ref, list):
                node = self._decode_node(ref)          # inline embedded node
                continue
            enc = self._store.get(ref)
            if enc is None:
                raise MissingNode(ref.hex() if isinstance(ref, bytes) else str(ref))
            node = self._decode_node(rlp.decode(enc))
        return node

    @staticmethod
    def _decode_node(item):
        if isinstance(item, (bytes, bytearray)):
            if len(item) == 0:
                return None
            return ("ref", bytes(item))
        if len(item) == 17:
            children = []
            for c in item[:16]:
                if isinstance(c, (bytes, bytearray)) and len(c) == 0:
                    children.append(None)
                elif isinstance(c, list):
                    children.append(("ref", c))        # inline node
                else:
                    children.append(("ref", bytes(c)))
            value = bytes(item[16])
            return ("branch", children, value)
        if len(item) == 2:
            nibbles, is_leaf = hp_decode(bytes(item[0]))
            if is_leaf:
                return ("leaf", nibbles, bytes(item[1]))
            child = item[1]
            child = ("ref", child if isinstance(child, list) else bytes(child))
            return ("ext", nibbles, child)
        raise ValueError("malformed trie node")

    def _encode_node(self, node) -> bytes:
        return rlp.encode(self._node_fields(node))

    def _node_fields(self, node):
        kind = node[0]
        if kind == "leaf":
            return [hp_encode(node[1], True), node[2]]
        if kind == "ext":
            return [hp_encode(node[1], False), self._child_ref(node[2])]
        if kind == "branch":
            fields = [self._child_ref(c) if c is not None else b""
                      for c in node[1]]
            fields.append(node[2])
            return fields
        raise ValueError(f"cannot encode {kind}")

    def _child_ref(self, node):
        if node[0] == "ref":
            ref = node[1]
            return ref  # already hash bytes or inline field list
        enc = self._encode_node(node)
        if len(enc) < 32:
            return self._node_fields(node)  # embed inline
        h = keccak256(enc)
        self._store[h] = enc
        return h

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def get(self, key: bytes):
        return self._get(self._root, bytes_to_nibbles(key))

    def _get(self, node, path):
        node = self._resolve(node)
        if node is None:
            return None
        kind = node[0]
        if kind == "leaf":
            return node[2] if node[1] == path else None
        if kind == "ext":
            plen = len(node[1])
            if path[:plen] == node[1]:
                return self._get(node[2], path[plen:])
            return None
        # branch
        if not path:
            return node[2] or None
        child = node[1][path[0]]
        return self._get(child, path[1:]) if child is not None else None

    def insert(self, key: bytes, value: bytes):
        if not value:
            return self.remove(key)
        self._root = self._insert(self._root, bytes_to_nibbles(key),
                                  bytes(value))

    def _insert(self, node, path, value):
        node = self._resolve(node)
        if node is None:
            return ("leaf", path, value)
        kind = node[0]
        if kind == "leaf":
            if node[1] == path:
                return ("leaf", path, value)
            return self._split(node[1], node[2], path, value)
        if kind == "ext":
            epath = node[1]
            common = _common_prefix(epath, path)
            if common == len(epath):
                child = self._insert(node[2], path[len(epath):], value)
                return ("ext", epath, child)
            # split the extension
            children = [None] * 16
            ext_rest = epath[common + 1:]
            sub = node[2] if not ext_rest else ("ext", ext_rest, node[2])
            children[epath[common]] = sub
            if common < len(path):
                children[path[common]] = ("leaf", path[common + 1:], value)
                branch = ("branch", children, b"")
            else:
                branch = ("branch", children, value)
            if common:
                return ("ext", path[:common], branch)
            return branch
        # branch
        children, bval = list(node[1]), node[2]
        if not path:
            return ("branch", children, value)
        idx = path[0]
        child = children[idx]
        children[idx] = self._insert(child, path[1:], value)
        return ("branch", children, bval)

    def _split(self, lpath, lvalue, path, value):
        common = _common_prefix(lpath, path)
        children = [None] * 16
        bval = b""
        for p, v in ((lpath, lvalue), (path, value)):
            rest = p[common:]
            if not rest:
                bval = v
            else:
                children[rest[0]] = ("leaf", rest[1:], v)
        branch = ("branch", children, bval)
        if common:
            return ("ext", lpath[:common], branch)
        return branch

    def remove(self, key: bytes):
        self._root = self._remove(self._root, bytes_to_nibbles(key))

    def _remove(self, node, path):
        node = self._resolve(node)
        if node is None:
            return None
        kind = node[0]
        if kind == "leaf":
            return None if node[1] == path else node
        if kind == "ext":
            plen = len(node[1])
            if path[:plen] != node[1]:
                return node
            child = self._remove(node[2], path[plen:])
            if child is None:
                return None
            return self._merge_ext(node[1], child)
        # branch
        children, bval = list(node[1]), node[2]
        if not path:
            bval = b""
        else:
            idx = path[0]
            if children[idx] is None:
                return node
            children[idx] = self._remove(children[idx], path[1:])
        return self._collapse_branch(children, bval)

    def _merge_ext(self, prefix, child):
        child = self._resolve(child)
        kind = child[0]
        if kind == "leaf":
            return ("leaf", prefix + child[1], child[2])
        if kind == "ext":
            return ("ext", prefix + child[1], child[2])
        return ("ext", prefix, child)

    def _collapse_branch(self, children, bval):
        live = [(i, c) for i, c in enumerate(children) if c is not None]
        if len(live) == 0:
            return ("leaf", (), bval) if bval else None
        if len(live) == 1 and not bval:
            idx, child = live[0]
            return self._merge_ext((idx,), child)
        return ("branch", children, bval)

    # ------------------------------------------------------------------
    # hashing / commitment
    # ------------------------------------------------------------------
    def root_hash(self) -> bytes:
        if self._root is None:
            return EMPTY_TRIE_ROOT
        node = self._root
        if node[0] == "ref" and isinstance(node[1], bytes):
            return node[1]
        enc = self._encode_node(self._resolve(node))
        h = keccak256(enc)
        self._store[h] = enc
        return h

    def commit(self) -> bytes:
        """Encode all in-memory nodes into the store; return the root hash."""
        root = self.root_hash()
        if self._root is not None:
            self._commit_node(self._root)
        return root

    def _commit_node(self, node):
        if node is None or node[0] == "ref":
            return
        if node[0] in ("ext",):
            self._commit_node(node[2])
        elif node[0] == "branch":
            for c in node[1]:
                if c is not None:
                    self._commit_node(c)
        enc = self._encode_node(node)
        if len(enc) >= 32:
            self._store[keccak256(enc)] = enc


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def trie_root_from_items(items: list[tuple[bytes, bytes]]) -> bytes:
    """Root of a fresh trie over (key, value) pairs — tx/receipt/withdrawal
    roots (key = rlp(index))."""
    t = Trie()
    for k, v in items:
        t.insert(k, v)
    return t.root_hash()
