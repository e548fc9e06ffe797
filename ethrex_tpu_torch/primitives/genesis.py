"""Fork schedule and chain configuration: `Fork` and `ChainConfig` of
`ethrex_tpu/primitives/genesis.py` (its genesis-file `Genesis` belongs to
the node, not to the prover, and is not copied)."""

from __future__ import annotations

import dataclasses
import enum


class Fork(enum.IntEnum):
    FRONTIER = 0
    HOMESTEAD = 1
    TANGERINE = 2
    SPURIOUS_DRAGON = 3
    BYZANTIUM = 4
    CONSTANTINOPLE = 5
    PETERSBURG = 6
    ISTANBUL = 7
    BERLIN = 8
    LONDON = 9
    PARIS = 10
    SHANGHAI = 11
    CANCUN = 12
    PRAGUE = 13
    OSAKA = 14


_BLOCK_FORKS = [
    ("homesteadBlock", Fork.HOMESTEAD),
    ("eip150Block", Fork.TANGERINE),
    ("eip155Block", Fork.SPURIOUS_DRAGON),
    ("byzantiumBlock", Fork.BYZANTIUM),
    ("constantinopleBlock", Fork.CONSTANTINOPLE),
    ("petersburgBlock", Fork.PETERSBURG),
    ("istanbulBlock", Fork.ISTANBUL),
    ("berlinBlock", Fork.BERLIN),
    ("londonBlock", Fork.LONDON),
    ("mergeNetsplitBlock", Fork.PARIS),
]
_TIME_FORKS = [
    ("shanghaiTime", Fork.SHANGHAI),
    ("cancunTime", Fork.CANCUN),
    ("pragueTime", Fork.PRAGUE),
    ("osakaTime", Fork.OSAKA),
]
# Forks with no EVM-semantics change that still count as EIP-2124 fork-id
# points (DAO, difficulty-bomb delays, blob-parameter-only forks)
_AUX_BLOCK_FORKS = ["daoForkBlock", "muirGlacierBlock",
                    "arrowGlacierBlock", "grayGlacierBlock"]
_AUX_TIME_FORKS = ["bpo1Time", "bpo2Time", "bpo3Time", "bpo4Time",
                   "bpo5Time"]

# Cancun-default blob parameters (EIP-4844); networks override per fork
# via the genesis "blobSchedule" (EIP-7840)
DEFAULT_BLOB_PARAMS = (393216, 786432, 3338477)  # target, max, fraction


@dataclasses.dataclass
class ChainConfig:
    chain_id: int = 1
    block_forks: dict = dataclasses.field(default_factory=dict)  # Fork -> blk
    time_forks: dict = dataclasses.field(default_factory=dict)   # Fork -> ts
    terminal_total_difficulty: int | None = None
    # EIP-2124-only points (no semantics change): block numbers (DAO,
    # glacier delays) and timestamps (blob-parameter-only forks)
    aux_block_forks: list = dataclasses.field(default_factory=list)
    aux_time_forks: list = dataclasses.field(default_factory=list)
    # EIP-7840 blob schedule: activation timestamp -> (target*GAS_PER_BLOB,
    # max*GAS_PER_BLOB, baseFeeUpdateFraction), sorted by timestamp
    blob_schedule: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_json(cls, cfg: dict) -> "ChainConfig":
        c = cls(chain_id=_num(cfg.get("chainId", 1)))
        for key, fork in _BLOCK_FORKS:
            if cfg.get(key) is not None:
                c.block_forks[fork] = _num(cfg[key])
        for key, fork in _TIME_FORKS:
            if cfg.get(key) is not None:
                c.time_forks[fork] = _num(cfg[key])
        for key in _AUX_BLOCK_FORKS:
            if cfg.get(key) is not None:
                c.aux_block_forks.append(_num(cfg[key]))
        for key in _AUX_TIME_FORKS:
            if cfg.get(key) is not None:
                c.aux_time_forks.append(_num(cfg[key]))
        if cfg.get("terminalTotalDifficulty") is not None:
            c.terminal_total_difficulty = _num(cfg["terminalTotalDifficulty"])
        sched = cfg.get("blobSchedule") or {}
        GAS_PER_BLOB = 131072
        fork_times = {
            "cancun": c.time_forks.get(Fork.CANCUN),
            "prague": c.time_forks.get(Fork.PRAGUE),
            "osaka": c.time_forks.get(Fork.OSAKA),
        }
        for i, key in enumerate(_AUX_TIME_FORKS):
            if cfg.get(key) is not None:
                fork_times[f"bpo{i + 1}"] = _num(cfg[key])
        for name, params in sched.items():
            at = fork_times.get(name.lower())
            if at is None:
                continue
            c.blob_schedule.append((
                at,
                _num(params["target"]) * GAS_PER_BLOB,
                _num(params["max"]) * GAS_PER_BLOB,
                _num(params.get("baseFeeUpdateFraction", 3338477)),
            ))
        c.blob_schedule.sort()
        return c

    def blob_params_at(self, timestamp: int) -> tuple[int, int, int]:
        """(target_blob_gas, max_blob_gas, base_fee_update_fraction) at a
        timestamp — EIP-7840 schedule with Cancun defaults."""
        params = DEFAULT_BLOB_PARAMS
        for at, target, mx, fraction in self.blob_schedule:
            if timestamp >= at:
                params = (target, mx, fraction)
        return params

    def fork_at(self, block_number: int, timestamp: int) -> Fork:
        """Resolve the active fork.

        LIMITATION: for networks with a nonzero terminalTotalDifficulty and
        no mergeNetsplitBlock (mainnet-style), the merge point cannot be
        derived without total-difficulty tracking, so post-merge
        pre-Shanghai blocks resolve to LONDON; set "mergeNetsplitBlock" in
        the config to pin the merge block explicitly.  TTD==0 (dev nets) is
        treated as merged from genesis.
        """
        active = Fork.FRONTIER
        for fork, blk in self.block_forks.items():
            if block_number >= blk and fork > active:
                active = fork
        if (self.terminal_total_difficulty == 0
                and Fork.PARIS > active):
            active = Fork.PARIS
        for fork, ts in self.time_forks.items():
            if timestamp >= ts and fork > active:
                active = fork
        return active

    def is_active(self, fork: Fork, block_number: int, timestamp: int) -> bool:
        return self.fork_at(block_number, timestamp) >= fork


def _num(v) -> int:
    if isinstance(v, int):
        return v
    v = str(v)
    return int(v, 16) if v.startswith("0x") else int(v or "0")
