"""L2 -> L1 messages (withdrawals): burn-to-bridge on L2, claim on L1 with
a Merkle inclusion proof against the batch's message root.  The parts of
`ethrex_tpu/l2/messages.py` that the batch output needs (the messages and
their root); the inclusion proofs belong to the L1 side and are not
copied.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..primitives.transaction import TYPE_PRIVILEGED

# the L2 bridge predeploy: value sent here is burned on L2 and becomes
# claimable on L1 once the batch is verified
BRIDGE_ADDRESS = b"\xff" * 19 + b"\xfe"


@dataclasses.dataclass(frozen=True)
class L2Message:
    from_addr: bytes     # L2 sender == L1 claimant
    value: int
    tx_hash: bytes       # uniquifies repeated identical withdrawals

    def leaf(self) -> bytes:
        return keccak256(b"ethrex-tpu/l2-message/v1" + self.from_addr
                         + self.value.to_bytes(32, "big") + self.tx_hash)


def collect_messages(blocks, receipts_per_block=None) -> list[L2Message]:
    """Withdrawal messages from a batch: successful value transfers to the
    bridge address.  When receipts are not provided (host committer path),
    tx success is determined by re-derived receipts passed alongside."""
    out = []
    for bi, block in enumerate(blocks):
        receipts = receipts_per_block[bi] if receipts_per_block else None
        for ti, tx in enumerate(block.body.transactions):
            if tx.to != BRIDGE_ADDRESS or tx.value == 0:
                continue
            if tx.tx_type == TYPE_PRIVILEGED:
                continue  # deposits cannot round-trip as withdrawals
            if receipts is not None and not receipts[ti].succeeded:
                continue
            out.append(L2Message(from_addr=tx.sender() or b"\x00" * 20,
                                 value=tx.value, tx_hash=tx.hash))
    return out


# ---------------------------------------------------------------------------
# binary keccak Merkle tree over message leaves
# ---------------------------------------------------------------------------

def message_root(messages) -> bytes:
    leaves = [m.leaf() for m in messages]
    if not leaves:
        return b"\x00" * 32
    level = leaves
    while len(level) > 1:
        if len(level) % 2:
            level = level + [level[-1]]  # duplicate-last padding
        level = [keccak256(level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]
