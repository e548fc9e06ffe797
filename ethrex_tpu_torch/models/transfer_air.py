"""Transfer VM AIR: EVM semantics of plain ETH transfers, in-circuit.

A copy of `ethrex_tpu/models/transfer_air.py` (the AIR, its segment types,
its honest trace generator and the public digest; the constraints run on the
device through `stark/air_codegen.py`).

Scope of the VM arithmetization: for batches whose
transactions are all plain value transfers, the write log's NEW values are
no longer the executor's unproven claim — this circuit recomputes every
account entry from FIELDS and proves the field arithmetic the EVM dictates
(upstream equivalent: the zkVM executes the guest natively).

Statement (public inputs, 8 limbs): `vmdigest`, a Poseidon2 sponge over a
fixed absorb schedule that interleaves, per transaction:

    txf chunks          value(11) || fee(11) || tip(11) limbs, 5 chunks
    key digests         P2([ACCOUNT_TAG, addr_limbs]) for sender/recipient
    old/new digests     P2(fields_limbs) of each touched account

followed by one coinbase segment per tx (key/old/new digests, tip credit).
The host verifier recomputes vmdigest from the CLAIMED write log and tx
list (prover/tpu_backend.py): since the same log also feeds the state
proof's commitments, digest equality couples "the log the state proof
applies" to "the log this circuit derives from EVM semantics" without
in-circuit lookups.

In-circuit, per tx segment (16 Poseidon2 periods of 32 rows):

    lane HS   sender sponges: key (1 perm), old fields (5), new fields (5)
    lane HR   staggered +1: recipient key / old / new sponges
    lane T    the running vmdigest sponge; absorbs HS/HR lane states at
              the exact period boundaries where their digests sit, and the
              txf chunks from the segment-constant field columns
    fields    segment-constant columns carry the four accounts' 36-limb
              field vectors and the tx's value/fee/tip limbs; balance and
              nonce updates are row-local carry/borrow chains:
                 s_new_bal = s_old_bal - value - fee     (borrow in {0,1,2})
                 r_new_bal = r_old_bal + value           (carry boolean)
                 s_new_nonce = s_old_nonce + 1
                 cb_new_bal = cb_old_bal + tip           (coinbase segment)
              with storage_root/code_hash copied (transfers cannot touch
              them) and created/no-op recipients handled by flags that
              force EIP-161-consistent field values.

No multiplications and no range-check bit columns are needed: every limb
that the chains touch is absorbed into a digest the host recomputes from
canonical in-range encodings, so out-of-range witness limbs change a
sponge input and break the digest equality instead.

Out of scope this round (checked natively in the backend, documented
there): signature validity, tx-list <-> block-hash binding, and the
fee/tip <-> base-fee relation.
"""

from __future__ import annotations

import numpy as np

from ..guest.flat_model import (ACCOUNT_TAG, addr_limbs, fields_limbs,
                                int_limbs, word_limbs24)
from ..ops import babybear as bb
from ..ops import poseidon2 as p2
from ..primitives.account import (EMPTY_CODE_HASH, EMPTY_TRIE_ROOT,
                                  AccountState)
from ..stark.air import Air
from .poseidon2_air import (PERIOD, ROUNDS, Poseidon2Air,
                            _external_linear_generic, pad_rows,
                            perm_rows_np, perm_rows_py)

SEG_PERIODS = 16
SEG_LEN = PERIOD * SEG_PERIODS

# column offsets
HS, HR, T = 0, 16, 32
SOLD, SNEW, ROLD, RNEW = 48, 84, 120, 156
VAL, FEE, TIP = 192, 203, 214
AS_, AR_ = 225, 232
IS_TX, IS_CB, CRE, NOP = 239, 240, 241, 242
BB_, RC, NC, CC = 243, 254, 265, 267
WIDTH = 278

# field vector layout (36 limbs)
F_NONCE, F_BAL, F_SR, F_CH = 0, 3, 14, 25

_EMPTY_SR = word_limbs24(EMPTY_TRIE_ROOT)
_EMPTY_CH = word_limbs24(EMPTY_CODE_HASH)

TWO24 = 1 << 24


def _field_chunks(f36: list[int]) -> list[list[int]]:
    """36 field limbs -> five rate-8 absorb chunks (zero padded)."""
    vals = [int(v) % bb.P for v in f36] + [0] * 4
    return [vals[i:i + 8] for i in range(0, 40, 8)]


def _txf_chunks(value11, fee11, tip11) -> list[list[int]]:
    """value || fee || tip (33 limbs) -> five rate-8 chunks."""
    vals = [int(v) % bb.P for v in
            list(value11) + list(fee11) + list(tip11)] + [0] * 7
    return [vals[i:i + 8] for i in range(0, 40, 8)]


def _key_chunk(addr7: list[int], tag: int = ACCOUNT_TAG) -> list[int]:
    return [tag] + [int(v) % bb.P for v in addr7]


# ---------------------------------------------------------------------------
# Per-segment circuit witness (host side)
# ---------------------------------------------------------------------------

class TxSeg:
    """One transfer: sender/recipient states around it + tx amounts."""

    def __init__(self, sender: bytes, recipient: bytes,
                 s_old: AccountState, s_new: AccountState,
                 r_old: AccountState | None, r_new: AccountState | None,
                 value: int, fee: int, tip: int,
                 r_created: bool, r_noop: bool):
        self.kind = "tx"
        self.as7 = addr_limbs(sender)
        self.ar7 = addr_limbs(recipient)
        self.s_old = fields_limbs(s_old)
        self.s_new = fields_limbs(s_new)
        self.r_old = [0] * 36 if (r_created or r_noop) \
            else fields_limbs(r_old)
        self.r_new = [0] * 36 if r_noop else fields_limbs(r_new)
        self.value = _limbs11(value)
        self.fee = _limbs11(fee)
        self.tip = _limbs11(tip)
        self.created = r_created
        self.noop = r_noop


class CbSeg:
    """The coinbase tip credit after one transfer."""

    def __init__(self, coinbase: bytes, old: AccountState | None,
                 new: AccountState | None, tip: int,
                 created: bool, noop: bool):
        self.kind = "cb"
        self.as7 = addr_limbs(coinbase)
        self.s_old = [0] * 36 if (created or noop) else fields_limbs(old)
        self.s_new = [0] * 36 if noop else fields_limbs(new)
        self.tip = _limbs11(tip)
        self.created = created
        self.noop = noop


def _limbs11(value: int) -> list[int]:
    """u256-ish amount -> 11 limbs (flat_model's canonical limbing)."""
    return int_limbs(value, 11)


def segment_count(num_segs: int) -> int:
    need = num_segs + 1            # >= 1 inert tail segment
    return 1 << (need - 1).bit_length()


# ---------------------------------------------------------------------------
# The public digest definition (host replica of lane T)
# ---------------------------------------------------------------------------

def _sponge(chunks: list[list[int]]) -> list[int]:
    state = [0] * 16
    for c in chunks:
        state = [(state[i] + c[i]) % bb.P if i < 8 else state[i]
                 for i in range(16)]
        state = p2.permute_ref(state)
    return state[:8]


def _seg_schedule(seg, key_dig, old_dig, new_dig,
                  rkey_dig=None, rold_dig=None, rnew_dig=None):
    """The 16 per-period absorb slots of lane T for one segment.
    Index j = chunk absorbed at the START of period j (None = carry)."""
    seq: list = [None] * SEG_PERIODS
    if seg.kind == "tx":
        txf = _txf_chunks(seg.value, seg.fee, seg.tip)
        seq[0] = txf[0]
        seq[1] = key_dig
        seq[2] = rkey_dig
        seq[3], seq[4], seq[5] = txf[1], txf[2], txf[3]
        seq[6] = old_dig
        seq[7] = rold_dig
        seq[8] = txf[4]
        seq[11] = new_dig
        seq[12] = rnew_dig
    else:  # cb
        seq[1] = key_dig
        seq[6] = old_dig
        seq[11] = new_dig
    return seq


def _seg_digests(seg):
    """(key, old, new[, rkey, rold, rnew]) sponge digests of one segment,
    with created/no-op muxing to zero chunks exactly as in-circuit.  The
    CRE/NOP flags describe the recipient in tx segments and the coinbase
    in cb segments; a tx sender always exists, so its digests are real."""
    key = _sponge([_key_chunk(seg.as7)])
    if seg.kind == "tx":
        old = _sponge(_field_chunks(seg.s_old))
        new = _sponge(_field_chunks(seg.s_new))
        rkey = _sponge([_key_chunk(seg.ar7)])
        rold = [0] * 8 if seg.created or seg.noop \
            else _sponge(_field_chunks(seg.r_old))
        rnew = [0] * 8 if seg.noop else _sponge(_field_chunks(seg.r_new))
        return key, old, new, rkey, rold, rnew
    old = [0] * 8 if seg.created or seg.noop \
        else _sponge(_field_chunks(seg.s_old))
    new = [0] * 8 if seg.noop else _sponge(_field_chunks(seg.s_new))
    return key, old, new


class _StreamSeg:
    """Digest-only view of a segment for the verifier-side recompute."""

    def __init__(self, kind: str, txf=None):
        self.kind = kind
        if txf is not None:
            self.value, self.fee, self.tip = txf


def vm_digest_stream(items: list, segments: int | None = None) -> list[int]:
    """The public statement digest from (kind, txf, digests) items —
    what a verifier computes from the claimed log + tx list alone.

    item = ("tx", (value11, fee11, tip11), (key, old, new, rkey, rold,
    rnew)) or ("cb", None, (key, old, new)); every digest is 8 limbs
    (zeros for the absent-account marker)."""
    if segments is None:
        segments = segment_count(len(items))
    state = [0] * 16
    for k in range(segments):
        if k < len(items):
            kind, txf, digs = items[k]
            seq = _seg_schedule(_StreamSeg(kind, txf), *digs)
        else:
            seq = [None] * SEG_PERIODS
        for j in range(SEG_PERIODS):
            if seq[j] is not None:
                state = [(state[i] + seq[j][i]) % bb.P if i < 8
                         else state[i] for i in range(16)]
            state = p2.permute_ref(state)
    return state[:8]


def vm_digest(segs: list, segments: int | None = None) -> list[int]:
    """The public statement digest: lane T's schedule run on the host
    from full segment witnesses (prover side)."""
    items = []
    for seg in segs:
        txf = (seg.value, seg.fee, seg.tip) if seg.kind == "tx" else None
        items.append((seg.kind, txf, _seg_digests(seg)))
    return vm_digest_stream(items, segments)


# ---------------------------------------------------------------------------
# The AIR
# ---------------------------------------------------------------------------

class TransferAir(Air):
    width = WIDTH
    max_degree = 8
    num_pub_inputs = 8
    # base poseidon2 (19) + sel_pe + per-period markers m0..m14 + sel_seg
    # + sel_first
    num_periodic = Poseidon2Air.num_periodic + 1 + 15 + 1 + 1

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

        ms = [marker(PERIOD * (j + 1) - 1) for j in range(15)]
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
        m = periodic[nb + 1:nb + 16]          # m[0] = b0 ... m[14] = b14
        sel_seg = periodic[nb + 16]
        sel_first = periodic[nb + 17]
        one = ops.const(1)
        zero = ops.const(0)

        hs, nhs = local[HS:HS + 16], nxt[HS:HS + 16]
        hr, nhr = local[HR:HR + 16], nxt[HR:HR + 16]
        tl, ntl = local[T:T + 16], nxt[T:T + 16]
        s_old = local[SOLD:SOLD + 36]
        s_new = local[SNEW:SNEW + 36]
        r_old = local[ROLD:ROLD + 36]
        r_new = local[RNEW:RNEW + 36]
        val = local[VAL:VAL + 11]
        fee = local[FEE:FEE + 11]
        tip = local[TIP:TIP + 11]
        ntip = nxt[TIP:TIP + 11]
        as7 = local[AS_:AS_ + 7]
        ar7 = local[AR_:AR_ + 7]
        is_tx, is_cb = local[IS_TX], local[IS_CB]
        n_is_tx, n_is_cb = nxt[IS_TX], nxt[IS_CB]
        cre, nop = local[CRE], local[NOP]
        active = ops.add(is_tx, is_cb)
        n_active = ops.add(n_is_tx, n_is_cb)

        sold_ch = [s_old[0:8], s_old[8:16], s_old[16:24], s_old[24:32],
                   s_old[32:36] + [zero] * 4]
        snew_ch = [s_new[0:8], s_new[8:16], s_new[16:24], s_new[24:32],
                   s_new[32:36] + [zero] * 4]
        rold_ch = [r_old[0:8], r_old[8:16], r_old[16:24], r_old[24:32],
                   r_old[32:36] + [zero] * 4]
        rnew_ch = [r_new[0:8], r_new[8:16], r_new[16:24], r_new[24:32],
                   r_new[32:36] + [zero] * 4]
        txf = list(val) + list(fee) + list(tip) + [zero] * 7
        txf_ch = [txf[i:i + 8] for i in range(0, 40, 8)]
        key_s = [ops.mul(active, one)] + list(as7)
        nkey_s = [ops.mul(n_active, one)] + list(nxt[AS_:AS_ + 7])
        key_r = [ops.mul(is_tx, one)] + list(ar7)

        not_old = ops.sub(ops.sub(one, cre), nop)   # absorb real old digest
        not_new = ops.sub(one, nop)

        out = []

        # ---- lane HS: key perm then old/new sponges ----------------------
        hand_hs = []
        hand_hs.append((m[0], self._absorbed([zero] * 16, sold_ch[0], ops),
                        active))
        for j in range(1, 5):
            hand_hs.append((m[j], self._absorbed(hs, sold_ch[j], ops),
                            active))
        hand_hs.append((m[5], self._absorbed([zero] * 16, snew_ch[0], ops),
                        active))
        for j in range(1, 5):
            hand_hs.append((m[5 + j], self._absorbed(hs, snew_ch[j], ops),
                            active))
        hand_hs.append((sel_seg,
                        self._absorbed([zero] * 16, nkey_s, ops), one))

        # ---- lane HR: staggered recipient sponges (tx segments only) -----
        hand_hr = []
        hand_hr.append((m[0], self._absorbed([zero] * 16, key_r, ops),
                        is_tx))
        hand_hr.append((m[1], self._absorbed([zero] * 16, rold_ch[0], ops),
                        is_tx))
        for j in range(1, 5):
            hand_hr.append((m[1 + j], self._absorbed(hr, rold_ch[j], ops),
                            is_tx))
        hand_hr.append((m[6], self._absorbed([zero] * 16, rnew_ch[0], ops),
                        is_tx))
        for j in range(1, 5):
            hand_hr.append((m[6 + j], self._absorbed(hr, rnew_ch[j], ops),
                            is_tx))
        hand_hr.append((sel_seg, _external_linear_generic(
            [zero] * 16, ops), one))

        # ---- lane T: the vmdigest schedule -------------------------------
        hs8 = hs[:8]
        hr8 = hr[:8]
        gate_ro = [ops.mul(not_old, v) for v in hr8]
        gate_rn = [ops.mul(not_new, v) for v in hr8]
        # cb segments mux the coinbase's old/new digests by cre/nop; the
        # tx sender's digests are never muxed (a sender always exists)
        gate_co = [ops.mul(not_old, v) for v in hs8]
        gate_cn = [ops.mul(not_new, v) for v in hs8]
        hand_t = [
            (m[0], self._absorbed(tl, hs8, ops), active),
            (m[1], self._absorbed(tl, hr8, ops), is_tx),
            (m[2], self._absorbed(tl, txf_ch[1], ops), is_tx),
            (m[3], self._absorbed(tl, txf_ch[2], ops), is_tx),
            (m[4], self._absorbed(tl, txf_ch[3], ops), is_tx),
            (m[5], self._absorbed(tl, hs8, ops), is_tx),
            (m[5], self._absorbed(tl, gate_co, ops), is_cb),
            (m[6], self._absorbed(tl, gate_ro, ops), is_tx),
            (m[7], self._absorbed(tl, txf_ch[4], ops), is_tx),
            (m[10], self._absorbed(tl, hs8, ops), is_tx),
            (m[10], self._absorbed(tl, gate_cn, ops), is_cb),
            (m[11], self._absorbed(tl, gate_rn, ops), is_tx),
        ]
        ntxf0 = [nxt[VAL + i] for i in range(8)]
        hand_t.append((sel_seg, self._absorbed(tl, ntxf0, ops), n_is_tx))

        for st, nst, hands, first_chunk in (
                (hs, nhs, hand_hs, key_s),
                (hr, nhr, hand_hr, [zero] * 8),
                (tl, ntl, hand_t, txf_ch[0])):
            cons = Poseidon2Air.constraints(self, st, nst, base_p, ops)
            me = _external_linear_generic(st, ops)
            first_mixed = self._absorbed([zero] * 16, first_chunk, ops)
            for j in range(16):
                c = ops.add(cons[j],
                            ops.mul(sel_pe, ops.sub(st[j], me[j])))
                for sel, target, gate in hands:
                    c = ops.add(c, ops.mul(ops.mul(sel, gate),
                                           ops.sub(me[j], target[j])))
                c = ops.add(c, ops.mul(sel_first,
                                       ops.sub(st[j], first_mixed[j])))
                out.append(c)

        # handoff overlap correction: a gated handoff with gate 0 must fall
        # back to the default M_E transition — already the case because the
        # gated term vanishes; overlapping selectors never fire together by
        # schedule construction (distinct marker rows).

        # ---- segment-constant columns ------------------------------------
        keep = ops.sub(one, sel_seg)
        const_cols = (list(range(SOLD, SOLD + 36))
                      + list(range(SNEW, SNEW + 36))
                      + list(range(ROLD, ROLD + 36))
                      + list(range(RNEW, RNEW + 36))
                      + list(range(VAL, VAL + 11))
                      + list(range(FEE, FEE + 11))
                      + list(range(TIP, TIP + 11))
                      + list(range(AS_, AS_ + 7))
                      + list(range(AR_, AR_ + 7))
                      + [IS_TX, IS_CB, CRE, NOP]
                      + list(range(BB_, BB_ + 11))
                      + list(range(RC, RC + 11))
                      + [NC, NC + 1]
                      + list(range(CC, CC + 11)))
        for col in const_cols:
            out.append(ops.mul(keep, ops.sub(nxt[col], local[col])))

        # inactive segments carry no data
        inactive = ops.sub(one, active)
        for col in (list(range(SOLD, SOLD + 36))
                    + list(range(SNEW, SNEW + 36))
                    + list(range(VAL, VAL + 11))
                    + list(range(FEE, FEE + 11))
                    + list(range(TIP, TIP + 11))
                    + list(range(AS_, AS_ + 7))
                    + [CRE, NOP]):
            out.append(ops.mul(inactive, local[col]))
        # recipient columns are only meaningful in tx segments
        not_tx = ops.sub(one, is_tx)
        for col in (list(range(ROLD, ROLD + 36))
                    + list(range(RNEW, RNEW + 36))
                    + list(range(AR_, AR_ + 7))):
            out.append(ops.mul(not_tx, local[col]))

        # ---- flags ---------------------------------------------------------
        for flag in (is_tx, is_cb, cre, nop):
            out.append(ops.mul(flag, ops.sub(flag, one)))
        out.append(ops.mul(is_tx, is_cb))
        out.append(ops.mul(cre, nop))
        # segment pattern: every tx is followed by its coinbase segment,
        # and activity never resumes after a pad segment
        out.append(ops.mul(sel_seg, ops.sub(n_is_cb, is_tx)))
        out.append(ops.mul(sel_seg, ops.mul(n_active,
                                            ops.sub(one, active))))
        # the tx's tip is carried into its coinbase segment
        for i in range(11):
            out.append(ops.mul(ops.mul(sel_seg, is_tx),
                               ops.sub(ntip[i], tip[i])))

        # ---- arithmetic (row-local; columns are segment-constant) --------
        two24 = ops.const(TWO24)

        def chain(acc, gate):
            for c in acc:
                out.append(ops.mul(gate, c))

        # sender balance: s_new = s_old - value - fee  (borrow in {0,1,2})
        sb = local[BB_:BB_ + 11]
        cons_sb = []
        for i in range(10, -1, -1):
            bin_ = sb[i + 1] if i < 10 else zero
            lhs = ops.sub(ops.sub(ops.sub(s_old[F_BAL + i], val[i]),
                                  fee[i]), bin_)
            lhs = ops.add(lhs, ops.mul(two24, sb[i]))
            cons_sb.append(ops.sub(lhs, s_new[F_BAL + i]))
        chain(cons_sb, is_tx)
        for i in range(11):
            out.append(ops.mul(sb[i], ops.mul(ops.sub(sb[i], one),
                                              ops.sub(sb[i], ops.const(2)))))
        out.append(ops.mul(is_tx, sb[0]))  # no underflow

        # recipient balance: r_new = r_old + value (skipped for no-op)
        rc = local[RC:RC + 11]
        cons_rc = []
        for i in range(10, -1, -1):
            cin = rc[i + 1] if i < 10 else zero
            lhs = ops.add(ops.add(r_old[F_BAL + i], val[i]), cin)
            lhs = ops.sub(lhs, ops.mul(two24, rc[i]))
            cons_rc.append(ops.sub(lhs, r_new[F_BAL + i]))
        chain(cons_rc, ops.mul(is_tx, not_new))
        for i in range(11):
            out.append(ops.mul(rc[i], ops.sub(rc[i], one)))
        out.append(ops.mul(is_tx, rc[0]))

        # sender nonce + 1
        nc0, nc1 = local[NC], local[NC + 1]
        cons_n = [
            ops.sub(ops.sub(ops.add(s_old[F_NONCE + 2], one),
                            ops.mul(two24, nc1)), s_new[F_NONCE + 2]),
            ops.sub(ops.sub(ops.add(s_old[F_NONCE + 1], nc1),
                            ops.mul(two24, nc0)), s_new[F_NONCE + 1]),
            ops.sub(ops.add(s_old[F_NONCE], nc0), s_new[F_NONCE]),
        ]
        chain(cons_n, is_tx)
        out.append(ops.mul(nc0, ops.sub(nc0, one)))
        out.append(ops.mul(nc1, ops.sub(nc1, one)))

        # sender storage_root / code_hash unchanged
        for i in range(22):
            out.append(ops.mul(is_tx, ops.sub(s_new[F_SR + i],
                                              s_old[F_SR + i])))

        # recipient invariants
        keep_r = ops.mul(is_tx, ops.sub(not_old, zero))
        for i in range(3):
            out.append(ops.mul(keep_r, ops.sub(r_new[F_NONCE + i],
                                               r_old[F_NONCE + i])))
        for i in range(22):
            out.append(ops.mul(keep_r, ops.sub(r_new[F_SR + i],
                                               r_old[F_SR + i])))
        # created recipient: old fields all zero, new gets the EIP-161
        # empty-account constants and nonce 0
        gate_cre = ops.mul(is_tx, cre)
        for i in range(36):
            out.append(ops.mul(gate_cre, r_old[i]))
        for i in range(3):
            out.append(ops.mul(gate_cre, r_new[F_NONCE + i]))
        for i in range(11):
            out.append(ops.mul(gate_cre, ops.sub(
                r_new[F_SR + i], ops.const(_EMPTY_SR[i]))))
            out.append(ops.mul(gate_cre, ops.sub(
                r_new[F_CH + i], ops.const(_EMPTY_CH[i]))))
        # no-op recipient: value is zero and both field vectors zero
        gate_nop = ops.mul(is_tx, nop)
        for i in range(11):
            out.append(ops.mul(gate_nop, val[i]))
        for i in range(36):
            out.append(ops.mul(gate_nop, r_old[i]))
            out.append(ops.mul(gate_nop, r_new[i]))

        # ---- coinbase segment arithmetic (uses the s_* columns) ----------
        cc = local[CC:CC + 11]
        cons_cb = []
        for i in range(10, -1, -1):
            cin = cc[i + 1] if i < 10 else zero
            lhs = ops.add(ops.add(s_old[F_BAL + i], tip[i]), cin)
            lhs = ops.sub(lhs, ops.mul(two24, cc[i]))
            cons_cb.append(ops.sub(lhs, s_new[F_BAL + i]))
        chain(cons_cb, ops.mul(is_cb, not_new))
        for i in range(11):
            out.append(ops.mul(cc[i], ops.sub(cc[i], one)))
        out.append(ops.mul(is_cb, cc[0]))
        for i in range(3):
            out.append(ops.mul(ops.mul(is_cb, not_old),
                               ops.sub(s_new[F_NONCE + i],
                                       s_old[F_NONCE + i])))
        for i in range(22):
            out.append(ops.mul(ops.mul(is_cb, not_old),
                               ops.sub(s_new[F_SR + i], s_old[F_SR + i])))
        gate_ccre = ops.mul(is_cb, cre)
        for i in range(36):
            out.append(ops.mul(gate_ccre, s_old[i]))
        for i in range(3):
            out.append(ops.mul(gate_ccre, s_new[F_NONCE + i]))
        for i in range(11):
            out.append(ops.mul(gate_ccre, ops.sub(
                s_new[F_SR + i], ops.const(_EMPTY_SR[i]))))
            out.append(ops.mul(gate_ccre, ops.sub(
                s_new[F_CH + i], ops.const(_EMPTY_CH[i]))))
        gate_cnop = ops.mul(is_cb, nop)
        for i in range(11):
            out.append(ops.mul(gate_cnop, tip[i]))
        for i in range(36):
            out.append(ops.mul(gate_cnop, s_old[i]))
            out.append(ops.mul(gate_cnop, s_new[i]))
        return out

    def boundaries(self, pub_inputs, n: int):
        digest = [int(v) % bb.P for v in pub_inputs[:8]]
        out = [(n - 1, T + i, digest[i]) for i in range(8)]
        out.append((0, IS_CB, 0))
        return out


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

# The reference builds the trace period by period in Python (three
# Poseidon2 round traces per 32-row period, 48 per segment).  Here lanes HS
# and HR, which restart on every segment, run for all segments at once in
# numpy (one batched permutation per period index); their period ends give
# the segment digests (muxed to zero for created / no-op accounts, as
# in-circuit); lane T, the running vmdigest sponge, is one sequential chain
# in plain Python ints, and its round rows are then filled in one batch.
# The array is the reference's.

_FRESH, _ABS = 1, 2


def _lane_plan(segs: list, segments: int):
    """Per-segment input schedules of lanes HS and HR: (mode, chunk) with
    mode (S, 16) in {carry, fresh, absorb} and chunk (S, 16, 8)."""
    S = segments
    modes = {name: np.zeros((S, SEG_PERIODS), dtype=np.int8)
             for name in ("HS", "HR")}
    chunks = {name: np.zeros((S, SEG_PERIODS, 8), dtype=np.uint64)
              for name in ("HS", "HR")}
    for name in ("HS", "HR"):
        # period 0 starts from a fresh state: the key chunk for HS (the
        # previous segment's end handoff), zeros for HR
        modes[name][:, 0] = _FRESH
    for k, seg in enumerate(segs):
        sold_c = _field_chunks(seg.s_old)
        snew_c = _field_chunks(seg.s_new)
        hs = ([(_FRESH, _key_chunk(seg.as7)), (_FRESH, sold_c[0])]
              + [(_ABS, sold_c[j]) for j in range(1, 5)]
              + [(_FRESH, snew_c[0])]
              + [(_ABS, snew_c[j]) for j in range(1, 5)])
        plans = [("HS", hs)]
        if seg.kind == "tx":
            rold_c = _field_chunks(seg.r_old)
            rnew_c = _field_chunks(seg.r_new)
            hr = ([None, (_FRESH, _key_chunk(seg.ar7)), (_FRESH, rold_c[0])]
                  + [(_ABS, rold_c[j]) for j in range(1, 5)]
                  + [(_FRESH, rnew_c[0])]
                  + [(_ABS, rnew_c[j]) for j in range(1, 5)])
            plans.append(("HR", hr))
        for name, seq in plans:
            for j, step in enumerate(seq):
                if step is not None:
                    modes[name][k, j] = step[0]
                    chunks[name][k, j] = step[1]
    return modes, chunks


def _run_lane(tr_view, col: int, mode, chunk) -> list:
    """Run one restarting lane for every segment at once; writes its rows
    into tr_view (S, 16, 32, WIDTH) and returns its period ends."""
    S = mode.shape[0]
    end = np.zeros((S, 16), dtype=np.uint64)
    ends = []
    for j in range(SEG_PERIODS):
        base = np.where((mode[:, j] == _ABS)[:, None], end,
                        np.zeros_like(end))
        base[:, :8] = (base[:, :8] + chunk[:, j]) % bb.P
        state = np.where((mode[:, j] == 0)[:, None], end, base)
        rows = perm_rows_np(state)                      # (S, 22, 16)
        tr_view[:, j, :, col:col + 16] = pad_rows(rows)
        end = rows[:, ROUNDS]
        ends.append(end)
    return ends


def generate_transfer_trace(segs: list,
                            segments: int | None = None) -> np.ndarray:
    if segments is None:
        segments = segment_count(len(segs))
    if segments <= len(segs):
        raise ValueError("need at least one inert tail segment")
    n = segments * SEG_LEN
    tr = np.zeros((n, WIDTH), dtype=np.uint32)
    view = tr.reshape(segments, SEG_PERIODS, PERIOD, WIDTH)

    for k, seg in enumerate(segs):
        base = k * SEG_LEN
        is_tx = 1 if seg.kind == "tx" else 0
        cols = {
            IS_TX: is_tx, IS_CB: 1 - is_tx,
            CRE: 1 if seg.created else 0,
            NOP: 1 if seg.noop else 0,
        }
        tr[base:base + SEG_LEN, SOLD:SOLD + 36] = seg.s_old
        tr[base:base + SEG_LEN, SNEW:SNEW + 36] = seg.s_new
        tr[base:base + SEG_LEN, TIP:TIP + 11] = seg.tip
        tr[base:base + SEG_LEN, AS_:AS_ + 7] = seg.as7
        if is_tx:
            tr[base:base + SEG_LEN, ROLD:ROLD + 36] = seg.r_old
            tr[base:base + SEG_LEN, RNEW:RNEW + 36] = seg.r_new
            tr[base:base + SEG_LEN, VAL:VAL + 11] = seg.value
            tr[base:base + SEG_LEN, FEE:FEE + 11] = seg.fee
            tr[base:base + SEG_LEN, AR_:AR_ + 7] = seg.ar7
        for col, v in cols.items():
            tr[base:base + SEG_LEN, col] = v
        # carry/borrow witness columns
        sold_b = [int(v) for v in seg.s_old]
        if is_tx:
            bbcols = _sub_borrows(
                sold_b[F_BAL:F_BAL + 11], seg.value, seg.fee)
            tr[base:base + SEG_LEN, BB_:BB_ + 11] = bbcols
            if not seg.noop:
                rccols = _add_carries(
                    [int(v) for v in seg.r_old][F_BAL:F_BAL + 11],
                    seg.value)
                tr[base:base + SEG_LEN, RC:RC + 11] = rccols
            nc1 = 1 if sold_b[F_NONCE + 2] + 1 >= TWO24 else 0
            nc0 = 1 if sold_b[F_NONCE + 1] + nc1 >= TWO24 else 0
            tr[base:base + SEG_LEN, NC] = nc0
            tr[base:base + SEG_LEN, NC + 1] = nc1
        else:
            if not seg.noop:
                cccols = _add_carries(sold_b[F_BAL:F_BAL + 11], seg.tip)
                tr[base:base + SEG_LEN, CC:CC + 11] = cccols

    # lanes HS and HR for every segment at once; the digests are their
    # period ends: key / old / new at HS periods 0 / 5 / 10, recipient key
    # / old / new at HR periods 1 / 6 / 11
    modes, chunks = _lane_plan(segs, segments)
    hs_end = _run_lane(view, HS, modes["HS"], chunks["HS"])
    hr_end = _run_lane(view, HR, modes["HR"], chunks["HR"])

    def dig(ends, j, k, zero=False):
        return [0] * 8 if zero else [int(v) for v in ends[j][k, :8]]

    # lane T: the absorb slots of every period, then one sequential chain
    t_chunk: list = [None] * (segments * SEG_PERIODS)
    for k, seg in enumerate(segs):
        if seg.kind == "tx":
            digs = (dig(hs_end, 0, k), dig(hs_end, 5, k), dig(hs_end, 10, k),
                    dig(hr_end, 1, k),
                    dig(hr_end, 6, k, seg.created or seg.noop),
                    dig(hr_end, 11, k, seg.noop))
        else:
            digs = (dig(hs_end, 0, k),
                    dig(hs_end, 5, k, seg.created or seg.noop),
                    dig(hs_end, 10, k, seg.noop))
        t_chunk[k * SEG_PERIODS:(k + 1) * SEG_PERIODS] = \
            _seg_schedule(seg, *digs)
    t_in = np.zeros((segments * SEG_PERIODS, 16), dtype=np.uint64)
    state = [0] * 16
    for g, c in enumerate(t_chunk):
        if c is not None:
            state = [(state[i] + c[i]) % bb.P if i < 8 else state[i]
                     for i in range(16)]
        t_in[g] = state
        state = perm_rows_py(state)[ROUNDS]
    view[:, :, :, T:T + 16] = pad_rows(perm_rows_np(t_in)).reshape(
        segments, SEG_PERIODS, PERIOD, 16)
    return tr


def _sub_borrows(bal, value, fee):
    """Borrow witness for s_new = bal - value - fee (BE limbs)."""
    borrows = [0] * 11
    bin_ = 0
    for i in range(10, -1, -1):
        d = bal[i] - value[i] - fee[i] - bin_
        b = 0
        while d < 0:
            d += TWO24
            b += 1
        borrows[i] = b
        bin_ = b
    return borrows


def _add_carries(bal, add):
    carries = [0] * 11
    cin = 0
    for i in range(10, -1, -1):
        s = bal[i] + add[i] + cin
        carries[i] = 1 if s >= TWO24 else 0
        cin = carries[i]
    return carries


def transfer_public_inputs(segs: list,
                           segments: int | None = None) -> list[int]:
    return vm_digest(segs, segments)
