"""EF BlockchainTest-format runner: import fixture chains block by block
through full validation, expecting declared exceptions, then check the
final head + post state.  A copy of `ethrex_tpu/utils/ef_blockchain.py`,
over the port's block import (`Blockchain.add_block`).

Wire-format parity with upstream ethrex's blockchain suite
(tooling/ef_tests/blockchain/{types.rs,test_runner.rs}):
a fixture file maps test name -> unit with `genesisBlockHeader`,
`genesisRLP`, `blocks` ([{rlp} | {rlp, expectException}]), `pre`,
`lastblockhash`, `postState` | `postStateHash`, `network`.  Public EF
archives (ethereum/tests, execution-spec-tests) plug in unchanged; the
vendored fixtures under tests/fixtures/ef_blockchain are self-generated
smoke units: one valid 3-block chain, and a bad state root, a bad base
fee, a bad gas used and an RLP that does not decode.

Flow mirrors test_runner.rs run_ef_test: decode genesisRLP and demand it
matches the computed genesis header; seed the store from `pre`; import
each block, requiring declared-invalid blocks to fail and valid ones to
succeed; require the last valid hash to equal `lastblockhash`; then
audit `postState` account by account (or `postStateHash` against the
head's state root).
"""

from __future__ import annotations

import json

from ..blockchain.blockchain import Blockchain, InvalidBlock
from ..primitives.block import Block
from ..primitives.genesis import Genesis
from ..primitives.rlp import RLPError
from ..storage.store import Store

# network name -> time-activation config entries (post-merge only, like
# upstream's runner, which skips pre-Merge networks)
_FORK_TIMES = {
    "Paris": {},
    "Merge": {},
    "Shanghai": {"shanghaiTime": 0},
    "Cancun": {"shanghaiTime": 0, "cancunTime": 0},
    "Prague": {"shanghaiTime": 0, "cancunTime": 0, "pragueTime": 0},
    "Osaka": {"shanghaiTime": 0, "cancunTime": 0, "pragueTime": 0,
              "osakaTime": 0},
}


class UnsupportedNetwork(Exception):
    pass


class FixtureFailure(Exception):
    pass


def _hx(v) -> str:
    return v if isinstance(v, str) else hex(v)


def genesis_from_unit(unit: dict) -> Genesis:
    hdr = unit["genesisBlockHeader"]
    network = unit.get("network", "")
    times = _FORK_TIMES.get(network)
    if times is None:
        raise UnsupportedNetwork(network)
    config = {"chainId": 1, "terminalTotalDifficulty": 0, **times}
    alloc = {}
    for addr, acct in unit.get("pre", {}).items():
        alloc[addr] = {
            "balance": _hx(acct.get("balance", "0x0")),
            "nonce": _hx(acct.get("nonce", "0x0")),
            "code": acct.get("code", "0x"),
            "storage": acct.get("storage", {}),
        }
    gjson = {
        "config": config,
        "alloc": alloc,
        "coinbase": hdr.get("coinbase", "0x" + "00" * 20),
        "difficulty": _hx(hdr.get("difficulty", "0x0")),
        "extraData": hdr.get("extraData", "0x"),
        "gasLimit": _hx(hdr.get("gasLimit", "0x0")),
        "nonce": _hx(hdr.get("nonce", "0x0")),
        "mixHash": hdr.get("mixHash", "0x" + "00" * 32),
        "timestamp": _hx(hdr.get("timestamp", "0x0")),
    }
    if "baseFeePerGas" in hdr:
        gjson["baseFeePerGas"] = _hx(hdr["baseFeePerGas"])
    if "excessBlobGas" in hdr:
        gjson["excessBlobGas"] = _hx(hdr["excessBlobGas"])
    if "blobGasUsed" in hdr:
        gjson["blobGasUsed"] = _hx(hdr["blobGasUsed"])
    return Genesis.from_json(gjson)


def run_unit(name: str, unit: dict) -> None:
    """Run one BlockchainTest unit; raises FixtureFailure on divergence."""
    genesis = genesis_from_unit(unit)
    store = Store()
    gh = store.init_genesis(genesis)
    genesis_rlp = bytes.fromhex(unit["genesisRLP"].removeprefix("0x"))
    try:
        decoded = Block.decode(genesis_rlp)
    except (RLPError, ValueError) as e:
        raise FixtureFailure(f"{name}: genesisRLP undecodable: {e}")
    if decoded.header.hash != gh.hash:
        raise FixtureFailure(
            f"{name}: computed genesis {gh.hash.hex()} != fixture "
            f"{decoded.header.hash.hex()}")

    chain = Blockchain(store, genesis.config)
    last_valid = gh.hash
    for i, bwr in enumerate(unit.get("blocks", [])):
        expect_fail = bool(bwr.get("expectException"))
        raw = bytes.fromhex(bwr["rlp"].removeprefix("0x"))
        try:
            block = Block.decode(raw)
        except (RLPError, ValueError):
            if expect_fail:
                continue
            raise FixtureFailure(f"{name}: block {i} undecodable")
        try:
            chain.add_block(block)
        except InvalidBlock as e:
            if expect_fail:
                continue
            raise FixtureFailure(f"{name}: block {i} rejected: {e}")
        if expect_fail:
            raise FixtureFailure(
                f"{name}: block {i} accepted but fixture expects "
                f"{bwr['expectException']}")
        last_valid = block.hash

    want_last = bytes.fromhex(unit["lastblockhash"].removeprefix("0x"))
    if last_valid != want_last:
        raise FixtureFailure(
            f"{name}: last valid {last_valid.hex()} != "
            f"{want_last.hex()}")

    head = store.get_header(last_valid)
    post = unit.get("postState")
    post_hash = unit.get("postStateHash")
    if post_hash is not None:
        want = bytes.fromhex(post_hash.removeprefix("0x"))
        if head.state_root != want:
            raise FixtureFailure(f"{name}: post state hash mismatch")
    if post is not None:
        root = head.state_root
        for addr_hex, want_acct in post.items():
            addr = bytes.fromhex(addr_hex.removeprefix("0x").zfill(40))
            st = store.account_state(root, addr)
            if st is None:
                raise FixtureFailure(
                    f"{name}: post account {addr_hex} absent")
            if st.nonce != int(_hx(want_acct.get("nonce", "0x0")), 16):
                raise FixtureFailure(f"{name}: {addr_hex} nonce mismatch")
            if st.balance != int(_hx(want_acct.get("balance", "0x0")), 16):
                raise FixtureFailure(
                    f"{name}: {addr_hex} balance mismatch")
            for slot_hex, want_v in want_acct.get("storage", {}).items():
                got = store.storage_at(root, addr, int(slot_hex, 16))
                if got != int(want_v, 16):
                    raise FixtureFailure(
                        f"{name}: {addr_hex}[{slot_hex}] storage "
                        f"mismatch: {hex(got)} != {want_v}")


def run_fixture_file(path: str, skip=()) -> dict:
    """Run every unit in a fixture file.  Returns
    {"passed": n, "skipped": n, "failures": [...]}."""
    with open(path) as f:
        units = json.load(f)
    passed = 0
    skipped = 0
    failures = []
    for name, unit in units.items():
        if any(s in name for s in skip):
            skipped += 1
            continue
        try:
            run_unit(name, unit)
            passed += 1
        except UnsupportedNetwork:
            skipped += 1
        except FixtureFailure as e:
            failures.append(str(e))
    return {"passed": passed, "skipped": skipped, "failures": failures}
