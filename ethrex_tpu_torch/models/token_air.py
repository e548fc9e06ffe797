"""Token VM AIR: EVM storage semantics of template-token transfers,
in-circuit (SLOAD/SSTORE/CALL).

A copy of `ethrex_tpu/models/token_air.py` (the AIR, its honest trace
generator and the public digest).

Companion circuit to models/transfer_air.py: for a batch whose
transactions are plain transfers and canonical-token calls
(guest/token_template.py), the account semantics are proven by the
transfer circuit and THIS circuit proves the storage semantics of every
token transfer — the two balance-slot writes the template's
`transfer(dst, v)` performs:

    balances[caller]:  fnew = fold - v    (11-limb borrow chain, borrow
                                           out of the top limb = 0: the
                                           non-reverting path requires
                                           fold >= v)
    balances[dst]:     tnew = told + v    (carry chain, no 256-bit wrap)

Statement (public inputs, 8 limbs): `tokdigest`, a Poseidon2 sponge over
one 10-chunk segment per token transfer absorbing

    amount(11) || kf(11) || fold(11) || fnew(11) || kt(11) || told(11)
    || tnew(11) || nop(1)     (78 limbs, zero-padded to 80)

where kf/kt are the 32-byte mapping keys as 24-bit limbs (opaque keccak
outputs — the host verifier recomputes them from the claimed sender/dst,
prover/tpu_backend.py) and fold/fnew/told/tnew the raw 32-byte slot
values.  The verifier recomputes tokdigest from the SAME claimed write
log that drives the state proof's commitments, so tampering any slot's
new value leaves NO satisfiable proof (the reference gets this from
executing the guest in the zkVM,
crates/guest-program/src/common/execution.rs:42-209).

Width 117 — deliberately a separate narrow circuit rather than a widening
of the 278-column TransferAir: compile time scales with width, and the
two statements share nothing but the (host-side) claimed log, so the
"segmented narrower AIRs" strategy keeps both under the persistent-cache
width gate (stark/prover.py).

A NOP segment (zero-amount call: the template stores unchanged values and
the executor logs nothing) absorbs nop = 1 with all other limbs zero.
Self-transfers need no circuit special case — the fine log's two rows on
the same slot chain (fold, fold - v), (fold - v, fold) and both chains
hold — but they are only in scope when the slot is touched by ANOTHER
write in the same block: a lone self-transfer nets the slot to its pre
value, the executor's coarse log skips net-zero writes
(storage/store.py), and without a coarse row build_vm_batch cannot seed the
slot's pre state, so the batch falls back to claimed mode.
"""

from __future__ import annotations

import numpy as np

from ..guest.flat_model import int_limbs
from ..ops import babybear as bb
from ..ops import poseidon2 as p2
from ..stark.air import Air
from .poseidon2_air import (PERIOD, ROUNDS, Poseidon2Air,
                            _external_linear_generic, generate_trace)

SEG_PERIODS = 16
SEG_LEN = PERIOD * SEG_PERIODS
NUM_CHUNKS = 10      # 78 data limbs, zero-padded to 80

# column offsets
T = 0
AMT, KF, FOLD, FNEW, KT, TOLD, TNEW = 16, 27, 38, 49, 60, 71, 82
BW, CY = 93, 104
ACT, NOP = 115, 116
WIDTH = 117

_DATA_COLS = (list(range(AMT, AMT + 11)) + list(range(KF, KF + 11))
              + list(range(FOLD, FOLD + 11)) + list(range(FNEW, FNEW + 11))
              + list(range(KT, KT + 11)) + list(range(TOLD, TOLD + 11))
              + list(range(TNEW, TNEW + 11)) + [NOP])

TWO24 = 1 << 24


def seg_limbs(amount, kf, fold, fnew, kt, told, tnew, noop) -> list[int]:
    """The 78 absorbed limbs of one segment (ints -> canonical limbs)."""
    return (int_limbs(amount, 11) + int_limbs(kf, 11)
            + int_limbs(fold, 11) + int_limbs(fnew, 11)
            + int_limbs(kt, 11) + int_limbs(told, 11)
            + int_limbs(tnew, 11) + [1 if noop else 0])


def _seg_chunks(limbs78: list[int]) -> list[list[int]]:
    vals = [int(v) % bb.P for v in limbs78] + [0, 0]
    return [vals[i:i + 8] for i in range(0, 80, 8)]


def segment_count(num_segs: int) -> int:
    need = num_segs + 1            # >= 1 inert tail segment
    return 1 << (need - 1).bit_length()


def tok_digest_stream(items: list, segments: int | None = None) -> list[int]:
    """The public statement digest from (amount, kf, fold, fnew, kt, told,
    tnew, noop) tuples — what a verifier computes from the claimed log +
    tx list alone (prover/tpu_backend.py builds the same tuples)."""
    if segments is None:
        segments = segment_count(len(items))
    state = [0] * 16
    for k in range(segments):
        chunks = _seg_chunks(seg_limbs(*items[k])) if k < len(items) \
            else [None] * SEG_PERIODS
        for j in range(SEG_PERIODS):
            c = chunks[j] if j < len(chunks) else None
            if c is not None:
                state = [(state[i] + c[i]) % bb.P if i < 8 else state[i]
                         for i in range(16)]
            state = p2.permute_ref(state)
    return state[:8]


class TokenAir(Air):
    width = WIDTH
    max_degree = 8
    num_pub_inputs = 8
    # base poseidon2 (19) + sel_pe + markers m0..m8 + sel_seg + sel_first
    num_periodic = Poseidon2Air.num_periodic + 1 + (NUM_CHUNKS - 1) + 1 + 1

    def periodic_columns(self, n: int):
        if n % SEG_LEN:
            raise ValueError("trace length must be a multiple of seg_len")
        base = Poseidon2Air().periodic_columns(PERIOD)
        sel_pe = np.zeros(PERIOD, dtype=np.uint32)
        sel_pe[PERIOD - 1] = 1

        def marker(row):
            col = np.zeros(SEG_LEN, dtype=np.uint32)
            col[row] = 1
            return col

        ms = [marker(PERIOD * (j + 1) - 1) for j in range(NUM_CHUNKS - 1)]
        sel_seg = marker(SEG_LEN - 1)
        sel_first = np.zeros(n, dtype=np.uint32)
        sel_first[0] = 1
        return base + [sel_pe] + ms + [sel_seg, sel_first]

    def _absorbed(self, state, chunk, ops):
        zero = ops.const(0)
        padded = list(chunk) + [zero] * (16 - len(chunk))
        mixed = [ops.add(state[j], padded[j]) for j in range(16)]
        return _external_linear_generic(mixed, ops)

    def constraints(self, local, nxt, periodic, ops):
        nb = Poseidon2Air.num_periodic
        base_p = periodic[:nb]
        sel_pe = periodic[nb]
        m = periodic[nb + 1:nb + NUM_CHUNKS]
        sel_seg = periodic[nb + NUM_CHUNKS]
        sel_first = periodic[nb + NUM_CHUNKS + 1]
        one = ops.const(1)
        zero = ops.const(0)

        tl, ntl = local[T:T + 16], nxt[T:T + 16]
        act, nop = local[ACT], local[NOP]
        n_act = nxt[ACT]
        amt = local[AMT:AMT + 11]
        fold = local[FOLD:FOLD + 11]
        fnew = local[FNEW:FNEW + 11]
        told = local[TOLD:TOLD + 11]
        tnew = local[TNEW:TNEW + 11]
        bw = local[BW:BW + 11]
        cy = local[CY:CY + 11]

        data = [local[c] for c in _DATA_COLS] + [zero, zero]
        chunks = [data[i:i + 8] for i in range(0, 80, 8)]
        n_c0 = [nxt[c] for c in _DATA_COLS[:8]]

        out = []

        # ---- lane T: the tokdigest schedule ------------------------------
        cons = Poseidon2Air.constraints(self, tl, ntl, base_p, ops)
        me = _external_linear_generic(tl, ops)
        hand = [(m[j], self._absorbed(tl, chunks[j + 1], ops), act)
                for j in range(NUM_CHUNKS - 1)]
        hand.append((sel_seg, self._absorbed(tl, n_c0, ops), n_act))
        first_mixed = self._absorbed([zero] * 16, chunks[0], ops)
        for j in range(16):
            c = ops.add(cons[j], ops.mul(sel_pe, ops.sub(tl[j], me[j])))
            for sel, target, gate in hand:
                c = ops.add(c, ops.mul(ops.mul(sel, gate),
                                       ops.sub(me[j], target[j])))
            c = ops.add(c, ops.mul(sel_first,
                                   ops.sub(tl[j], first_mixed[j])))
            out.append(c)

        # ---- segment-constant columns ------------------------------------
        keep = ops.sub(one, sel_seg)
        for col in _DATA_COLS + list(range(BW, BW + 11)) \
                + list(range(CY, CY + 11)) + [ACT]:
            out.append(ops.mul(keep, ops.sub(nxt[col], local[col])))

        # ---- flags + activity pattern ------------------------------------
        for flag in (act, nop):
            out.append(ops.mul(flag, ops.sub(flag, one)))
        out.append(ops.mul(nop, ops.sub(one, act)))
        out.append(ops.mul(sel_seg, ops.mul(n_act, ops.sub(one, act))))

        # inactive segments carry no data
        inactive = ops.sub(one, act)
        for col in _DATA_COLS[:-1] + list(range(BW, BW + 11)) \
                + list(range(CY, CY + 11)):
            out.append(ops.mul(inactive, local[col]))
        # NOP segments: amount and both slots zeroed (flag absorbed = 1)
        gate_nop = ops.mul(act, nop)
        for col in _DATA_COLS[:-1] + list(range(BW, BW + 11)) \
                + list(range(CY, CY + 11)):
            out.append(ops.mul(gate_nop, local[col]))

        # ---- arithmetic (row-local; columns are segment-constant) --------
        liv = ops.mul(act, ops.sub(one, nop))
        two24 = ops.const(TWO24)

        # balances[caller]: fnew = fold - amount  (borrow in {0,1})
        for i in range(10, -1, -1):
            bin_ = bw[i + 1] if i < 10 else zero
            lhs = ops.sub(ops.sub(fold[i], amt[i]), bin_)
            lhs = ops.add(lhs, ops.mul(two24, bw[i]))
            out.append(ops.mul(liv, ops.sub(lhs, fnew[i])))
        for i in range(11):
            out.append(ops.mul(bw[i], ops.sub(bw[i], one)))
        out.append(ops.mul(liv, bw[0]))   # no underflow: fold >= amount

        # balances[dst]: tnew = told + amount  (carry in {0,1})
        for i in range(10, -1, -1):
            cin = cy[i + 1] if i < 10 else zero
            lhs = ops.add(ops.add(told[i], amt[i]), cin)
            lhs = ops.sub(lhs, ops.mul(two24, cy[i]))
            out.append(ops.mul(liv, ops.sub(lhs, tnew[i])))
        for i in range(11):
            out.append(ops.mul(cy[i], ops.sub(cy[i], one)))
        out.append(ops.mul(liv, cy[0]))   # no 256-bit wrap
        return out

    def boundaries(self, pub_inputs, n: int):
        digest = [int(v) % bb.P for v in pub_inputs[:8]]
        return [(n - 1, T + i, digest[i]) for i in range(8)]


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

def generate_token_trace(segs: list,
                         segments: int | None = None) -> np.ndarray:
    """Trace for a TokSeg stream (guest/transfer_log.TokSeg)."""
    if segments is None:
        segments = segment_count(len(segs))
    if segments <= len(segs):
        raise ValueError("need at least one inert tail segment")
    n = segments * SEG_LEN
    tr = np.zeros((n, WIDTH), dtype=np.uint32)

    def absorb(state, chunk):
        return [(state[i] + chunk[i]) % bb.P if i < 8 else state[i]
                for i in range(16)]

    state = [0] * 16
    for k in range(segments):
        seg = segs[k] if k < len(segs) else None
        base = k * SEG_LEN
        chunks = [None] * SEG_PERIODS
        if seg is not None:
            limbs = seg_limbs(seg.amount, seg.kf, seg.fold, seg.fnew,
                              seg.kt, seg.told, seg.tnew, seg.noop)
            for j, c in enumerate(_seg_chunks(limbs)):
                chunks[j] = c
            tr[base:base + SEG_LEN, ACT] = 1
            for col, v in zip(_DATA_COLS, limbs):
                tr[base:base + SEG_LEN, col] = v
            if not seg.noop:
                tr[base:base + SEG_LEN, BW:BW + 11] = \
                    _sub_borrows(int_limbs(seg.fold, 11),
                                 int_limbs(seg.amount, 11))
                tr[base:base + SEG_LEN, CY:CY + 11] = \
                    _add_carries(int_limbs(seg.told, 11),
                                 int_limbs(seg.amount, 11))
        for j in range(SEG_PERIODS):
            if chunks[j] is not None:
                state = absorb(state, chunks[j])
            rows = generate_trace(state)
            rbase = base + j * PERIOD
            tr[rbase:rbase + PERIOD, T:T + 16] = rows
            state = [int(v) for v in rows[ROUNDS]]
    return tr


def _sub_borrows(a, b):
    """Borrow witness for a - b (BE 24-bit limbs), borrows in {0,1}."""
    borrows = [0] * 11
    bin_ = 0
    for i in range(10, -1, -1):
        d = a[i] - b[i] - bin_
        borrows[i] = 1 if d < 0 else 0
        bin_ = borrows[i]
    return borrows


def _add_carries(a, b):
    carries = [0] * 11
    cin = 0
    for i in range(10, -1, -1):
        s = a[i] + b[i] + cin
        carries[i] = 1 if s >= TWO24 else 0
        cin = carries[i]
    return carries


def token_public_inputs(segs: list,
                        segments: int | None = None) -> list[int]:
    items = [(s.amount, s.kf, s.fold, s.fnew, s.kt, s.told, s.tnew,
              s.noop) for s in segs]
    return tok_digest_stream(items, segments)
