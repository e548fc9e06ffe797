"""Committed prover inputs, with the reference's results on them.

`baseline3_program_input.json.gz` is BASELINE-3's batch as the proof
coordinator hands it to a prover: 4 blocks of 125 ETH transfers and 125
token-template calls each, from one sender, as `ProgramInput.to_json()`
in canonical JSON (`canonical_json`), gzipped.  `baseline3_expected.json`
holds what the JAX package computes on it: the digests of the output
bytes, the VM batch's fine write log and its VM metadata, the tree depth,
`seg_periods`, the segment counts and the access records.
`mixed_program_input.json.gz` is one block of two ETH transfers and two
token calls, the small batch the card tests prove.
`tests/test_torch_program_input.py` regenerates them with the JAX package
and checks them (`python -m tests.test_torch_program_input` writes them).
"""

from __future__ import annotations

import gzip
import hashlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def json_sha256(obj) -> str:
    return hashlib.sha256(canonical_json(obj)).hexdigest()


def program_input_json(name: str = "baseline3") -> dict:
    with gzip.open(HERE / f"{name}_program_input.json.gz", "rb") as f:
        return json.loads(f.read())


def load_program_input(name: str = "baseline3"):
    from ..guest.execution import ProgramInput

    return ProgramInput.from_json(program_input_json(name))


def expected(name: str = "baseline3") -> dict:
    return json.loads((HERE / f"{name}_expected.json").read_text())


def proof_summary(proof: dict) -> dict:
    """The entries of a batch-proof dict that `expected` describes: the
    digests of its output, write log and VM metadata, its tree shape, its
    mode and the VM batch's segment counts (each transaction is one
    account segment and one coinbase segment; a token call adds a token
    segment, a generic call a bytecode proof)."""
    vm = proof.get("vm")
    txs = [t for b in vm["blocks"] for t in b["txs"]] if vm else []
    out = {
        "output_sha256": hashlib.sha256(
            bytes.fromhex(proof["output"][2:])).hexdigest(),
        "write_log_sha256": json_sha256(proof["write_log"]),
        "depth": proof["depth"],
        "seg_periods": proof["seg_periods"],
        "mode": vm["mode"] if vm else "claimed",
    }
    if vm:
        out["vm_meta_sha256"] = json_sha256(vm)
        out["segments"] = {
            "transfer": 2 * len(txs),
            "token": sum(t.get("kind") == "tok" for t in txs),
            "generic": sum(t.get("kind") == "gen" for t in txs)}
    return out


def records_summary(records, r_pre, r_post) -> dict:
    """The state-update access records (`guest.access_log.
    build_access_records`) as their count, the two roots and one digest
    over every record's key, values, index, path and bits."""
    rows = [[r.key.hex(), r.old_value.hex(), r.new_value.hex(), r.index,
             [[int(v) for v in s] for s in r.siblings],
             [int(b) for b in r.bits]] for r in records]
    return {"count": len(records), "r_pre": [int(v) for v in r_pre],
            "r_post": [int(v) for v in r_post], "sha256": json_sha256(rows)}
