"""Prover <-> coordinator wire protocol: newline-delimited JSON over TCP,
a copy of `ethrex_tpu/prover/protocol.py` (parity with upstream ethrex's
ProofData<I> protocol, crates/common/types/prover.rs:119-159 — the
plugin seam the prover slots into; message names kept equivalent).

The counterpart is the reference's proof coordinator, unmodified: the
frames, the message names, the backend and format names and
`PROTOCOL_VERSION` are the reference's, byte for byte.  `PROVER_TPU`
is the STARK prover's wire name, whatever its device.
"""

from __future__ import annotations

import json
import socket

from ..utils import faults

# message types (the reference's ProofData variants). The wire carries no
# AUTHENTICATED prover identity, so InputResponse issues a per-assignment
# lease_token; Heartbeat and ProofSubmit must echo it — lease mutations
# only ever act on behalf of the prover the lease was granted to.  A
# prover MAY volunteer a stable `prover_id` string on InputRequest and
# ProofSubmit: it is advisory only (never a capability — the token stays
# the sole authority), feeding the coordinator's fleet scheduler with
# per-prover throughput stats for size-aware placement, work stealing,
# and hedged re-assignment (docs/AGGREGATION.md).  InputRequest MAY also
# carry a boolean `warm`: whether this prover's kernels are already
# built (the port: `GpuBackend.prewarm` built its kernel library and the
# wrap's tables of bases; the reference: its AOT executables hydrated)
# so its next proof runs at steady-state wall rather than paying a cold
# build.  Like prover_id it is advisory — the scheduler uses it only
# to prefer warm provers for the first batches after a restart and to
# keep a cold prover's compile-inclusive first wall out of its EWMA; a
# lying prover gains nothing but a worse placement.  ProofSubmit and
# Heartbeat MAY additionally carry a `spans` object — the prover's
# completed span subtree for the batch's trace, produced by
# tracing.export_wire (bounded + size-capped + version-tagged) and
# merged by the coordinator with tracing.TRACER.ingest so one batch
# renders as one cross-process trace.  Also advisory and
# version-tolerant in both directions: old coordinators ignore the
# field, new coordinators ignore unknown payload versions, and
# ingestion never raises into lease handling
# (docs/OBSERVABILITY.md "Distributed tracing").  The heartbeat copy is
# cumulative — a prover that dies mid-prove still leaves its partial
# subtree from the last beat; the coordinator deduplicates by span ID.
# Heartbeat MAY further carry the prover runtime's advisory state
# (docs/PROVER_RESILIENCE.md "Runtime failures"): `phase` (the job-
# qualified in-flight phase, e.g. "state_proof.quotient") and
# `phase_started` (the prover's wall clock) — the coordinator re-anchors
# its hedging deadline on every observed phase TRANSITION using its own
# clock, so a proof making phase progress is never hedged as a
# straggler; `degraded` ({from, to} mesh labels) — the degradation
# ladder demoted this prover, the scheduler steers heavy batches away
# until restart; and `poison` ({phase, detail}) — the batch produced
# non-finite/out-of-field outputs in the named phase, the coordinator
# quarantines it immediately (token-gated like every lease mutation)
# instead of burning its failure budget on doomed retries.
INPUT_REQUEST = "InputRequest"          # {commit_hash, prover_type
#                                          [, prover_id] [, warm]}
INPUT_RESPONSE = "InputResponse"        # {batch_id, input, format,
#                                          lease_token}
VERSION_MISMATCH = "VersionMismatch"    # {expected}
TYPE_NOT_NEEDED = "ProverTypeNotNeeded"
PROOF_SUBMIT = "ProofSubmit"            # {batch_id, prover_type, proof,
#                                          lease_token [, prover_id]
#                                          [, spans]}
SUBMIT_ACK = "ProofSubmitACK"           # {batch_id}
ERROR = "Error"                         # {message}
# lease keep-alive: a prover mid-way through a long TPU proof extends its
# assignment instead of relying on one fixed coordinator-side timeout
HEARTBEAT = "Heartbeat"                 # {batch_id, prover_type,
#                                          lease_token [, prover_id]
#                                          [, spans] [, phase]
#                                          [, phase_started] [, degraded]
#                                          [, poison]}
HEARTBEAT_ACK = "HeartbeatAck"          # {batch_id, ok}

# proof formats (reference: ProofFormat — Compressed STARK vs Groth16 wrap)
FORMAT_STARK = "stark"            # the two batch STARKs as-is
FORMAT_COMPRESSED = "compressed"  # + recursion: FRI query work aggregated
#                                   into one outer STARK, path data dropped
FORMAT_GROTH16 = "groth16"        # compressed + BN254 MiMC wrap of the
#                                   aggregate digest (one pairing on L1)
FORMATS = (FORMAT_STARK, FORMAT_COMPRESSED, FORMAT_GROTH16)

# prover types (reference: ProverType {Exec, SP1, RISC0, ...} + TPU)
PROVER_EXEC = "exec"
PROVER_TPU = "tpu"

PROTOCOL_VERSION = "ethrex-tpu/prover/v1"


class ProtocolError(ConnectionError):
    """A frame that cannot be trusted: oversized, truncated, or not JSON.
    Subclasses ConnectionError so every existing handler that drops a bad
    connection drops a bad frame the same way."""


def _decode_frame(buf: bytes) -> dict:
    try:
        msg = json.loads(buf.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(f"malformed frame: {e}") from e
    if not isinstance(msg, dict):
        raise ProtocolError("malformed frame: not a JSON object")
    return msg


def send_msg(sock: socket.socket, msg: dict):
    data = json.dumps(msg, separators=(",", ":")).encode() + b"\n"
    data = faults.inject("proto.send", data)
    sock.sendall(data)


def recv_msg(sock: socket.socket, max_size: int = 256 * 1024 * 1024) -> dict:
    buf = bytearray()
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            if not buf:
                raise ConnectionError("peer closed")
            break
        buf.extend(chunk)
        if buf.endswith(b"\n"):
            break
        if len(buf) > max_size:
            raise ProtocolError("message too large")
    data = faults.inject("proto.recv", bytes(buf))
    if not data.endswith(b"\n"):
        raise ProtocolError("truncated frame")
    return _decode_frame(data)


def recv_msg_file(rfile, max_size: int = 256 * 1024 * 1024) -> dict | None:
    line = rfile.readline(max_size)
    if not line:
        return None
    line = faults.inject("proto.recv", line)
    if not line.endswith(b"\n"):
        # readline(max_size) silently returns a partial line when the
        # frame exceeds the cap; a partial line at EOF is a peer that died
        # mid-frame — neither may reach json.loads as if it were complete
        if len(line) >= max_size:
            raise ProtocolError("message too large")
        raise ProtocolError("truncated frame")
    return _decode_frame(line)
