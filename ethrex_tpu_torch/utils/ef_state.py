"""EF GeneralStateTest fixture runner: a copy of
`ethrex_tpu/utils/ef_state.py`.

Parses standard EF state-test JSON — one file holds named tests, each
with a shared `env`/`pre`/`transaction` and per-fork `post` cases indexed
into the data/gasLimit/value arrays — executes each case through the
port's transaction executor, merkleizes it in the port's `Store`, and
compares the post-state root and the keccak(rlp(logs)) digest
byte-exactly.

It runs the fixtures under `tests/fixtures/ef_state/` (the fork ladder
in `forks/`, Frontier to Prague) or a directory named by the
`EF_STATE_FIXTURES` env var.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..crypto.keccak import keccak256
from ..evm.db import StateDB
from ..evm.executor import InvalidTransaction, execute_tx
from ..evm.vm import BlockEnv
from ..primitives import rlp
from ..primitives.account import Account
from ..primitives.genesis import ChainConfig, Genesis
from ..primitives.transaction import (
    TYPE_ACCESS_LIST,
    TYPE_BLOB,
    TYPE_DYNAMIC_FEE,
    TYPE_LEGACY,
    TYPE_SET_CODE,
    Transaction,
)
from ..storage.store import Store

# Fork name (EF fixture convention) -> ChainConfig JSON enabling it from
# genesis, Frontier..Osaka; pre-Berlin gas/opcode variants live in
# evm/gas.py Schedule + the fork-gated dispatch table.
# pre-Merge forks pin a huge TTD: ChainConfig treats ttd == 0 as merged
# from genesis, which would floor every config at PARIS
_PRE_MERGE_TTD = {"terminalTotalDifficulty": 1 << 70}

_FORK_CONFIGS = {
    "Frontier": {**_PRE_MERGE_TTD},
    "Homestead": {"homesteadBlock": 0, **_PRE_MERGE_TTD},
    "EIP150": {"homesteadBlock": 0, "eip150Block": 0, **_PRE_MERGE_TTD},
    "EIP158": {"homesteadBlock": 0, "eip150Block": 0, "eip155Block": 0,
               **_PRE_MERGE_TTD},
    "Byzantium": {"homesteadBlock": 0, "eip150Block": 0, "eip155Block": 0,
                  "byzantiumBlock": 0, **_PRE_MERGE_TTD},
    "Constantinople": {"homesteadBlock": 0, "eip150Block": 0,
                       "eip155Block": 0, "byzantiumBlock": 0,
                       "constantinopleBlock": 0, **_PRE_MERGE_TTD},
    "ConstantinopleFix": {"homesteadBlock": 0, "eip150Block": 0,
                          "eip155Block": 0, "byzantiumBlock": 0,
                          "constantinopleBlock": 0, "petersburgBlock": 0,
                          **_PRE_MERGE_TTD},
    "Istanbul": {"homesteadBlock": 0, "eip150Block": 0, "eip155Block": 0,
                 "byzantiumBlock": 0, "constantinopleBlock": 0,
                 "petersburgBlock": 0, "istanbulBlock": 0,
                 **_PRE_MERGE_TTD},
    "Berlin": {"berlinBlock": 0, **_PRE_MERGE_TTD},
    "London": {"berlinBlock": 0, "londonBlock": 0, **_PRE_MERGE_TTD},
    "Merge": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0},
    "Paris": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0},
    "Shanghai": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0,
                 "shanghaiTime": 0},
    "Cancun": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0,
               "shanghaiTime": 0, "cancunTime": 0},
    "Prague": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0,
               "shanghaiTime": 0, "cancunTime": 0, "pragueTime": 0},
    "Osaka": {"berlinBlock": 0, "londonBlock": 0, "mergeNetsplitBlock": 0,
              "shanghaiTime": 0, "cancunTime": 0, "pragueTime": 0,
              "osakaTime": 0},
}

SUPPORTED_FORKS = frozenset(_FORK_CONFIGS)


def _num(v, default=0) -> int:
    if v is None:
        return default
    if isinstance(v, int):
        return v
    s = str(v)
    return int(s, 16) if s.startswith("0x") else int(s)


def _hexb(v) -> bytes:
    if not v:
        return b""
    s = str(v).removeprefix("0x")
    return bytes.fromhex("0" + s if len(s) % 2 else s)


def _addr(v) -> bytes:
    return _hexb(v).rjust(20, b"\x00")


@dataclasses.dataclass
class StateTestCase:
    """One (fork, data-index, gas-index, value-index) execution unit."""

    name: str
    fork: str
    tx: Transaction
    pre: dict                # address -> Account
    env: dict
    expected_hash: bytes
    expected_logs: bytes
    expect_exception: str | None
    indexes: tuple


@dataclasses.dataclass
class CaseResult:
    case: StateTestCase
    passed: bool
    detail: str = ""


def _parse_access_list(raw) -> list:
    out = []
    for entry in raw or []:
        out.append((_addr(entry["address"]),
                    [_num(k) for k in entry.get("storageKeys", [])]))
    return out


def _parse_authorizations(raw) -> list:
    out = []
    for a in raw or []:
        out.append((_num(a["chainId"]), _addr(a["address"]), _num(a["nonce"]),
                    _num(a.get("v", a.get("yParity", 0))), _num(a["r"]),
                    _num(a["s"])))
    return out


def _build_tx(raw_tx: dict, indexes: dict) -> Transaction:
    di, gi, vi = (indexes.get("data", 0), indexes.get("gas", 0),
                  indexes.get("value", 0))
    data = _hexb(raw_tx["data"][di])
    access_lists = raw_tx.get("accessLists")
    access_list = _parse_access_list(access_lists[di]) if access_lists else []
    blob_hashes = [_hexb(h).rjust(32, b"\x00")
                   for h in raw_tx.get("blobVersionedHashes", [])]
    auths = _parse_authorizations(raw_tx.get("authorizationList"))

    if blob_hashes or raw_tx.get("maxFeePerBlobGas") is not None:
        tx_type = TYPE_BLOB
    elif auths:
        tx_type = TYPE_SET_CODE
    elif raw_tx.get("maxFeePerGas") is not None:
        tx_type = TYPE_DYNAMIC_FEE
    elif access_lists is not None:
        tx_type = TYPE_ACCESS_LIST
    else:
        tx_type = TYPE_LEGACY

    to_raw = raw_tx.get("to", "")
    tx = Transaction(
        tx_type=tx_type,
        chain_id=1,
        nonce=_num(raw_tx.get("nonce", 0)),
        gas_price=_num(raw_tx.get("gasPrice", 0)),
        max_priority_fee_per_gas=_num(raw_tx.get("maxPriorityFeePerGas", 0)),
        max_fee_per_gas=_num(raw_tx.get("maxFeePerGas", 0)),
        gas_limit=_num(raw_tx["gasLimit"][gi]),
        to=_addr(to_raw) if to_raw else b"",
        value=_num(raw_tx["value"][vi]),
        data=data,
        access_list=access_list,
        max_fee_per_blob_gas=_num(raw_tx.get("maxFeePerBlobGas", 0)),
        blob_versioned_hashes=blob_hashes,
        authorization_list=auths,
    )
    secret = raw_tx.get("secretKey")
    if secret:
        tx = tx.sign(_num(secret))
    return tx


def _parse_pre(pre: dict) -> dict:
    alloc = {}
    for addr_hex, info in pre.items():
        storage = {_num(k): _num(v)
                   for k, v in info.get("storage", {}).items()}
        alloc[_addr(addr_hex)] = Account.new(
            nonce=_num(info.get("nonce", 0)),
            balance=_num(info.get("balance", 0)),
            code=_hexb(info.get("code", "")),
            storage=storage,
        )
    return alloc


def load_fixture_file(path: str) -> list[StateTestCase]:
    """Expand one fixture JSON into the flat case list (forks x indexes)."""
    with open(path) as f:
        fixture = json.load(f)
    cases = []
    for name, test in fixture.items():
        if "transaction" not in test or "post" not in test:
            continue  # e.g. "_info" blocks in some archives
        pre = _parse_pre(test["pre"])
        env = test["env"]
        # (data, gas, value) indexes -> the signed tx, which every fork's
        # case of those indexes shares (signing is the cost of a load)
        txs = {}
        for fork, post_cases in test["post"].items():
            if fork not in _FORK_CONFIGS:
                continue
            for post in post_cases:
                idx = post.get("indexes", {})
                key = (idx.get("data", 0), idx.get("gas", 0),
                       idx.get("value", 0))
                if key not in txs:
                    txs[key] = _build_tx(test["transaction"], idx)
                cases.append(StateTestCase(
                    name=name, fork=fork, tx=txs[key],
                    pre=pre, env=env,
                    expected_hash=_hexb(post["hash"]).rjust(32, b"\x00"),
                    expected_logs=_hexb(post["logs"]).rjust(32, b"\x00"),
                    expect_exception=post.get("expectException"),
                    indexes=key,
                ))
    return cases


def _logs_hash(logs) -> bytes:
    return keccak256(rlp.encode([log.to_fields() for log in logs]))


def execute_case(case: StateTestCase):
    """Execute one case; returns (post_root, logs_hash, error_str|None,
    gas_used).

    On an invalid transaction the post state is the untouched pre state
    (state-test semantics: rejected txs burn nothing), and error_str carries
    the rejection reason.
    """
    cfg_json = dict(_FORK_CONFIGS[case.fork])
    cfg_json.setdefault("terminalTotalDifficulty", 0)
    cfg_json["chainId"] = 1
    config = ChainConfig.from_json(cfg_json)
    store = Store()
    genesis = Genesis(config=config, alloc=case.pre)
    pre_root = store.init_genesis(genesis).state_root

    env = case.env
    from ..primitives.genesis import Fork

    number = _num(env.get("currentNumber", 1), 1)
    timestamp = _num(env.get("currentTimestamp", 1000), 1000)
    pre_london = config.fork_at(number, timestamp) < Fork.LONDON
    block = BlockEnv(
        number=number,
        coinbase=_addr(env.get("currentCoinbase", "0x" + "00" * 20)),
        timestamp=timestamp,
        gas_limit=_num(env.get("currentGasLimit", 30_000_000)),
        prev_randao=_hexb(env.get("currentRandom",
                                  env.get("currentDifficulty",
                                          "0x" + "00" * 32))
                          ).rjust(32, b"\x00"),
        # no base fee before EIP-1559: the whole gas price goes to the
        # coinbase and nothing is burned
        base_fee=0 if pre_london else _num(env.get("currentBaseFee", 10)),
        excess_blob_gas=_num(env.get("currentExcessBlobGas", 0)),
        difficulty=_num(env.get("currentDifficulty", 0)),
    )

    state = store.state_db(pre_root)
    try:
        result = execute_tx(case.tx, state, block, config)
    except InvalidTransaction as exc:
        return pre_root, _logs_hash([]), str(exc), 0
    post_root = store.apply_account_updates(pre_root, state)
    return post_root, _logs_hash(result.logs), None, result.gas_used


def run_case(case: StateTestCase) -> CaseResult:
    """Execute one case and check the post-state root + logs digest."""
    post_root, got_logs, err, _gas = execute_case(case)

    if case.expect_exception is not None:
        if err is None:
            return CaseResult(case, False,
                              f"expected {case.expect_exception}, tx ran")
    elif err is not None:
        return CaseResult(case, False, f"unexpected invalid tx: {err}")

    if post_root != case.expected_hash:
        return CaseResult(
            case, False,
            f"state root 0x{post_root.hex()} != 0x{case.expected_hash.hex()}")
    if got_logs != case.expected_logs:
        return CaseResult(
            case, False,
            f"logs hash 0x{got_logs.hex()} != 0x{case.expected_logs.hex()}")
    return CaseResult(case, True)


def discover_fixture_dirs() -> list[str]:
    dirs = []
    env_dir = os.environ.get("EF_STATE_FIXTURES")
    if env_dir and os.path.isdir(env_dir):
        dirs.append(env_dir)
    repo_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "tests", "fixtures", "ef_state")
    if os.path.isdir(repo_dir):
        dirs.append(repo_dir)
    return dirs


def run_directory(path: str, fork_filter: str | None = None):
    """Run every fixture file under `path`; returns (passed, failed) lists."""
    passed, failed = [], []
    for root, _dirs, files in os.walk(path):
        for fname in sorted(files):
            if not fname.endswith(".json"):
                continue
            for case in load_fixture_file(os.path.join(root, fname)):
                if fork_filter and case.fork != fork_filter:
                    continue
                res = run_case(case)
                (passed if res.passed else failed).append(res)
    return passed, failed
