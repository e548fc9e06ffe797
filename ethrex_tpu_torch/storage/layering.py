"""In-memory diff layering over the Store's node table: a copy of
`ethrex_tpu/storage/layering.py`.

The seat of upstream ethrex's `crates/storage/layering.rs`: recent blocks'
trie nodes live in per-block in-memory diff layers stacked over the
durable base table, flattened to the backend only when their block
finalizes (or falls behind the settle window).  What this buys on our
architecture:

  * bounded write batching: one backend write burst per settle instead
    of a per-block durable-log trickle;
  * honest restart: the persistent tail is exactly the settled chain,
    and the unflattened tip re-imports on startup (upstream ethrex makes
    the same trade, ethrex.rs:62-64 "in-memory trie diff-layers
    deliberately re-executed on restart").

Unlike upstream's path-keyed diffs, our node tables are
CONTENT-ADDRESSED (key = node hash) and the native MPT engine
de-duplicates, so per-block layer ATTRIBUTION is approximate — a node
first written while a stale branch was on top may be silently shared by
the canonical chain.  The Store therefore flattens EVERY layer at settle
time (stale branches included; disk garbage over lost nodes) — selective
stale-dropping needs per-node refcounting, which is future work.  The
`demote_layer` primitive exists for callers that can prove exclusivity.

Reads check top-down: layers newest->oldest, the demoted overlay, then
the base table.  Writes go to the top layer (or straight to base when no
layer is open).
"""

from __future__ import annotations

_MISSING = object()


class LayeredTable:
    """Dict-protocol (the subset Store/Trie use) over base + diff layers."""

    def __init__(self, base):
        self.base = base
        self.layers: list[tuple[object, dict]] = []   # (tag, writes)
        self.overlay: dict = {}   # demoted stale-branch writes (RAM only)

    # -- layer management --------------------------------------------------
    def push_layer(self, tag) -> None:
        self.layers.append((tag, {}))

    def layer_tags(self) -> list:
        return [t for t, _ in self.layers]

    def flatten_layer(self, tag) -> int:
        """Write one layer's entries into the base table; returns count."""
        for i, (t, writes) in enumerate(self.layers):
            if t == tag:
                for k, v in writes.items():
                    self.base[k] = v
                del self.layers[i]
                return len(writes)
        return 0

    def demote_layer(self, tag) -> int:
        """Move one layer into the RAM-only overlay (stale branches)."""
        for i, (t, writes) in enumerate(self.layers):
            if t == tag:
                self.overlay.update(writes)
                del self.layers[i]
                return len(writes)
        return 0

    def merge_down(self, tag) -> int:
        """Fold one layer's writes into the layer below it (or the next
        older location: overlay-free, straight merge).  Used when a block
        import fails after opening its layer — the partial writes stay
        attributed to the surrounding context instead of leaking an
        orphaned top layer that would absorb unrelated writes."""
        for i, (t, writes) in enumerate(self.layers):
            if t == tag:
                if i > 0:
                    # duplicate keys carry identical content-addressed
                    # values, so merge precedence is immaterial
                    self.layers[i - 1][1].update(writes)
                else:
                    for k, v in writes.items():
                        self.base[k] = v
                del self.layers[i]
                return len(writes)
        return 0

    def flatten_all(self) -> int:
        n = 0
        for tag in [t for t, _ in self.layers]:
            n += self.flatten_layer(tag)
        return n

    def pending(self) -> tuple[int, int]:
        """(open layers, staged node writes) not yet settled to the
        base — the restart re-import tail a crash right now would pay.
        Health/monitor surface this; Store.close() drains it to zero."""
        snapshot = tuple(self.layers)
        return len(snapshot), sum(len(w) for _, w in snapshot)

    # -- dict protocol -----------------------------------------------------
    def _lookup(self, key):
        # snapshot the layer list: settling (RPC fork-choice thread) may
        # delete entries concurrently with reader threads, and a list
        # iterator racing a del can skip LIVE layers entirely.
        # flatten writes base BEFORE deleting the layer, so a
        # snapshot reader always finds the value in one place or the
        # other.
        for _, writes in reversed(tuple(self.layers)):
            v = writes.get(key, _MISSING)
            if v is not _MISSING:
                return v
        v = self.overlay.get(key, _MISSING)
        if v is not _MISSING:
            return v
        return self.base.get(key, _MISSING)

    def get(self, key, default=None):
        v = self._lookup(key)
        return default if v is _MISSING else v

    def __getitem__(self, key):
        v = self._lookup(key)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self._lookup(key) is not _MISSING

    def __setitem__(self, key, value):
        if self.layers:
            self.layers[-1][1][key] = value
        else:
            self.base[key] = value

    def setdefault(self, key, default=None):
        v = self._lookup(key)
        if v is not _MISSING:
            return v
        self[key] = default
        return default

    def pop(self, key, default=None):
        # node tables are append-mostly; deletion only happens during
        # compaction, which normally runs on the BASE directly.  Honor
        # the dict.pop contract anyway: return the removed value from
        # the topmost location that held it.
        value = _MISSING
        for _, writes in self.layers:
            v = writes.pop(key, _MISSING)
            if v is not _MISSING:
                value = v
        v = self.overlay.pop(key, _MISSING)
        if v is not _MISSING:
            value = v
        if hasattr(self.base, "pop"):
            v = self.base.pop(key, _MISSING)
            if v is not _MISSING and value is _MISSING:
                value = v
        return default if value is _MISSING else value

    def __len__(self):
        # approximate (shared keys counted once per layer); used only by
        # diagnostics
        return len(self.base) + len(self.overlay) + sum(
            len(w) for _, w in self.layers)

    def keys(self):
        seen = set(self.base.keys()) | set(self.overlay.keys())
        for _, w in tuple(self.layers):
            seen |= set(w.keys())
        return seen

    def items(self):
        for k in self.keys():
            yield k, self[k]
