"""The VM-mode batch's segment types: a copy of the data classes of
`ethrex_tpu/guest/transfer_log.py` (`BlockMeta`, `TokSeg`, `BcCall`,
`VmBatch`).  `build_vm_batch`, which derives them from an executed batch,
belongs to the host stack and is not ported yet."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BlockMeta:
    coinbase: bytes
    base_fee: int
    txs: list


@dataclasses.dataclass
class TokSeg:
    """One token-transfer's storage semantics (models/token_air.py)."""

    amount: int
    kf: int       # from-balance slot (mapping key as int)
    fold: int
    fnew: int
    kt: int       # to-balance slot
    told: int
    tnew: int
    noop: bool = False   # amount == 0: no slot rows


@dataclasses.dataclass
class BcCall:
    """One generic call's circuit witness (models/bytecode_air.py)."""

    steps: list            # bytecode_vm.StepRec
    snaps: list            # bytecode_vm.Snapshot


@dataclasses.dataclass
class VmBatch:
    blocks_log: list       # fine per-tx raw log
    segs: list             # TxSeg/CbSeg stream (account circuit)
    tok_segs: list         # TokSeg stream (storage circuit; may be empty)
    blocks: list           # BlockMeta per block
    bc_calls: list = dataclasses.field(default_factory=list)  # BcCall
