"""The execution witness: `ExecutionWitness` of `ethrex_tpu/guest/witness.py`
and its JSON form.

A witness = the minimal set of trie nodes + contract codes + ancestor headers
needed to statelessly re-execute a batch of blocks.  The sequencer generates
it (`generate_witness`, not copied); the prover only reads it.
"""

from __future__ import annotations

import dataclasses

from ..primitives.block import BlockHeader


@dataclasses.dataclass
class ExecutionWitness:
    """Self-contained input for stateless execution."""

    nodes: list            # encoded trie nodes (state + storage tries)
    codes: list            # contract bytecodes
    block_headers: list    # ancestor headers (for parent + BLOCKHASH)
    first_block_number: int

    def to_json(self) -> dict:
        return {
            "nodes": ["0x" + bytes(n).hex() for n in self.nodes],
            "codes": ["0x" + bytes(c).hex() for c in self.codes],
            "headers": ["0x" + h.encode().hex() for h in self.block_headers],
            "firstBlock": self.first_block_number,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ExecutionWitness":
        return cls(
            nodes=[bytes.fromhex(n[2:]) for n in obj["nodes"]],
            codes=[bytes.fromhex(c[2:]) for c in obj["codes"]],
            block_headers=[
                BlockHeader.decode(bytes.fromhex(h[2:]))
                for h in obj["headers"]],
            first_block_number=obj["firstBlock"],
        )
