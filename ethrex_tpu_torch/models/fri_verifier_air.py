"""FRI-verifier AIR: the recursion/aggregation circuit.

Proves IN-CIRCUIT the expensive part of verifying N inner DEEP-FRI STARKs —
every FRI query's Merkle openings and fold equations across every layer —
so that one outer STARK attests to the whole batch of inner query checks.
A copy of `ethrex_tpu/models/fri_verifier_air.py` (the AIR, the segment
schedule, the digest and the trace generator); the trace generator here is
vectorised with numpy and returns the same array as the reference's
row-by-row loop (tests/test_torch_aggregate.py holds the two equal).

Statement (public inputs, 8 limbs):
    digest — Poseidon2 sponge over every segment's 32-limb message under
    the fixed in-trace absorb schedule.

One SEGMENT verifies one (query, layer) opening of one inner proof:

    leaf = H(lo || hi)                      (1-chunk sponge, lane M)
    fold(leaf, path) == root                (f-gated compress folds, lane M)
    idx  == sum of path bits (LSB first)    (idxacc accumulator)
    #folds == depth                         (facc accumulator)
    carried_in == (s_bit ? hi : lo), raw == idx + s_bit*half   (chaining)
    (carried_out - (lo+hi)/2) * 2x == beta * (lo - hi)         (fold eqn)

and lane T absorbs the segment message

    [first, k, half, depth, x, lo(4), hi(4), beta(4), root(8),
     carried_out(4), idx, s_bit, last]                          (32 limbs)

into the running transcript sponge.  The OUTER verifier (stark/aggregate.py)
re-derives every message limb except lo/hi from the inner proofs' public
data — Fiat-Shamir betas and query indices from the roots, x / half / depth
from the layer structure, carried values from lo/hi/beta/x, the final-layer
polynomial evaluation from the final coefficients — and recomputes the
digest, so a trace that lies about any of them cannot reproduce the public
digest.  What the circuit alone establishes is the EXISTENCE of Merkle
paths: the openings' hash work, which dominates native verification, never
has to be re-executed (and the aggregate proof drops the path data).

Schedule per segment (S periods of 32 rows, uniform lanes):
    period 0:      lane M = fresh sponge absorbing the leaf chunk;
                   lane T absorbs msg chunk 1
    end period 0:  dig <- leaf digest, first compress input loaded
    periods 1..D:  f-gated path folds (f = 1 for the first `depth` slots);
                   lane T absorbs msg chunks 2, 3 at periods 1, 2
    periods D+1..: idle permutations
    segment end:   chain, root and fold-equation checks; registers reset; lanes
                   restart on the next segment's message

Columns (width 90):
    0..15  lane M        49 f (fold flag)    57..88 msg
    16..31 lane T        50 idxacc           89 active
    32..39 dig           51 facc
    40..47 sib           52..55 carried
    48 bit               56 raw
"""

from __future__ import annotations

import numpy as np

from ..ops import babybear as bb
from ..ops import ext as ext_ops
from ..ops import poseidon2 as p2
from ..stark.air import Air
from .poseidon2_air import (PERIOD, ROUNDS, Poseidon2Air, pad_rows,
                            perm_rows_np, perm_rows_py,
                            _external_linear_generic)

M_STATE, T_STATE = 0, 16
DIG, SIB, BIT, FOLD = 32, 40, 48, 49
IDXACC, FACC, CARRIED, RAW = 50, 51, 52, 56
MSG, ACTIVE = 57, 89
WIDTH = 90
MSG_LIMBS = 32

# msg limb offsets
(MF_FIRST, MF_K, MF_HALF, MF_DEPTH, MF_X, MF_LO, MF_HI, MF_BETA, MF_ROOT,
 MF_COUT, MF_IDX, MF_SBIT, MF_LAST) = (0, 1, 2, 3, 4, 5, 9, 13, 17, 25,
                                       29, 30, 31)

_INV2 = bb.inv_host(2)


def _chunks(limbs: list[int]) -> list[list[int]]:
    vals = [int(v) % bb.P for v in limbs]
    assert len(vals) == MSG_LIMBS
    return [vals[i:i + 8] for i in range(0, MSG_LIMBS, 8)]


class FriVerifyAir(Air):
    width = WIDTH
    max_degree = 8
    num_pub_inputs = 8
    # Poseidon2 round selectors + sel_pe, sel_seg_end, sp0..sp2,
    # sel_fold, sel_foldpre, pw2, sel_first
    num_periodic = Poseidon2Air.num_periodic + 9

    def __init__(self, max_depth: int, seg_periods: int | None = None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        need = max_depth + 2
        natural = 1 << (need - 1).bit_length()
        self.seg_periods = seg_periods or natural
        if self.seg_periods < need or self.seg_periods < 8 \
                or self.seg_periods & (self.seg_periods - 1):
            raise ValueError(
                f"seg_periods must be a power of two >= {max(need, 8)}")
        self.max_depth = max_depth
        self.seg_len = PERIOD * self.seg_periods

    def cache_key(self) -> tuple:
        return (type(self), self.width, self.max_degree,
                self.num_pub_inputs, self.max_depth, self.seg_periods)

    def periodic_columns(self, n: int):
        if n % self.seg_len:
            raise ValueError("trace length must be a multiple of seg_len")
        base = Poseidon2Air().periodic_columns(PERIOD)
        sel_pe = np.zeros(PERIOD, dtype=np.uint32)
        sel_pe[PERIOD - 1] = 1
        sl = self.seg_len

        def marker(rows):
            col = np.zeros(sl, dtype=np.uint32)
            for r in rows:
                col[r] = 1
            return col

        sel_seg_end = marker([sl - 1])
        sp = [marker([PERIOD * (j + 1) - 1]) for j in range(3)]
        fold_rows = [PERIOD * (1 + j) + PERIOD - 1
                     for j in range(self.max_depth)]
        sel_fold = marker(fold_rows)
        sel_foldpre = marker(fold_rows[:-1])
        pw2 = np.zeros(sl, dtype=np.uint32)
        for j, r in enumerate(fold_rows):
            pw2[r] = (1 << j) % bb.P
        sel_first = np.zeros(n, dtype=np.uint32)
        sel_first[0] = 1
        return base + [sel_pe, sel_seg_end] + sp \
            + [sel_fold, sel_foldpre, pw2, sel_first]

    def _select(self, dig, sib, bit, ops):
        one = ops.const(1)
        inv = ops.sub(one, bit)
        lo = [ops.add(ops.mul(inv, dig[i]), ops.mul(bit, sib[i]))
              for i in range(8)]
        hi = [ops.add(ops.mul(bit, dig[i]), ops.mul(inv, sib[i]))
              for i in range(8)]
        return lo + hi

    def _absorbed(self, state, chunk, ops):
        zero = ops.const(0)
        padded = list(chunk) + [zero] * (16 - len(chunk))
        mixed = [ops.add(state[j], padded[j]) for j in range(16)]
        return _external_linear_generic(mixed, ops)

    def constraints(self, local, nxt, periodic, ops):
        nb = Poseidon2Air.num_periodic
        base_p = periodic[:nb]
        (sel_pe, sel_seg, sp0, sp1, sp2, sel_fold, sel_foldpre, pw2,
         sel_first) = periodic[nb:]
        one = ops.const(1)
        zero = ops.const(0)
        inv2 = ops.const(_INV2)

        m_st = local[M_STATE:M_STATE + 16]
        m_nst = nxt[M_STATE:M_STATE + 16]
        t_st = local[T_STATE:T_STATE + 16]
        t_nst = nxt[T_STATE:T_STATE + 16]
        dig = local[DIG:DIG + 8]
        ndig = nxt[DIG:DIG + 8]
        sib = local[SIB:SIB + 8]
        nsib = nxt[SIB:SIB + 8]
        bit, nbit = local[BIT], nxt[BIT]
        f, nf = local[FOLD], nxt[FOLD]
        idxacc, nidxacc = local[IDXACC], nxt[IDXACC]
        facc, nfacc = local[FACC], nxt[FACC]
        carried = local[CARRIED:CARRIED + 4]
        ncarried = nxt[CARRIED:CARRIED + 4]
        raw, nraw = local[RAW], nxt[RAW]
        msg = local[MSG:MSG + MSG_LIMBS]
        nmsg = nxt[MSG:MSG + MSG_LIMBS]
        active, nactive = local[ACTIVE], nxt[ACTIVE]

        out = []

        # ---- lane M: leaf sponge + f-gated folds --------------------------
        cons_m = Poseidon2Air.constraints(self, m_st, m_nst, base_p, ops)
        me_m = _external_linear_generic(m_st, ops)
        leaf_next = self._absorbed([zero] * 16, nmsg[MF_LO:MF_LO + 8], ops)
        load = _external_linear_generic(
            self._select(ndig, nsib, nbit, ops), ops)
        for j in range(16):
            c = cons_m[j]
            c = ops.add(c, ops.mul(sel_pe, ops.sub(m_st[j], me_m[j])))
            # end of period 0: next input is the first compress (every
            # ACTIVE layer has depth >= 1; padding segments idle-carry)
            c = ops.add(c, ops.mul(sp0, ops.mul(active,
                                                ops.sub(me_m[j], load[j]))))
            # fold period ends: next input is the next compress when the
            # next period still folds, else the idle carry M_E(state)
            blend = [ops.add(ops.mul(nf, load[i]),
                             ops.mul(ops.sub(one, nf), me_m[i]))
                     for i in range(16)]
            c = ops.add(c, ops.mul(sel_foldpre, ops.sub(me_m[j], blend[j])))
            # segment end: fresh sponge on the next segment's leaf
            c = ops.add(c, ops.mul(sel_seg, ops.sub(me_m[j], leaf_next[j])))
            first_leaf = self._absorbed([zero] * 16,
                                        msg[MF_LO:MF_LO + 8], ops)
            c = ops.add(c, ops.mul(sel_first,
                                   ops.sub(m_st[j], first_leaf[j])))
            out.append(c)

        # ---- lane T: transcript sponge ------------------------------------
        cons_t = Poseidon2Air.constraints(self, t_st, t_nst, base_p, ops)
        me_t = _external_linear_generic(t_st, ops)
        absorbs = [(sp0, msg[8:16]), (sp1, msg[16:24]), (sp2, msg[24:32]),
                   (sel_seg, nmsg[0:8])]
        first_t = self._absorbed([zero] * 16, msg[0:8], ops)
        for j in range(16):
            c = cons_t[j]
            c = ops.add(c, ops.mul(sel_pe, ops.sub(t_st[j], me_t[j])))
            for sel, chunk in absorbs:
                mixed = self._absorbed(t_st, chunk, ops)
                c = ops.add(c, ops.mul(sel, ops.sub(me_t[j], mixed[j])))
            c = ops.add(c, ops.mul(sel_first, ops.sub(t_st[j], first_t[j])))
            out.append(c)

        # ---- dig register: load at sp0, f-gated feed-forward at folds -----
        keep_dig = ops.sub(ops.sub(one, sp0), sel_fold)
        inv_b = ops.sub(one, bit)
        for i in range(8):
            left = ops.add(ops.mul(inv_b, dig[i]), ops.mul(bit, sib[i]))
            ff = ops.add(m_st[i], left)
            folded = ops.add(ops.mul(f, ff),
                             ops.mul(ops.sub(one, f), dig[i]))
            out.append(ops.add(
                ops.add(ops.mul(keep_dig, ops.sub(ndig[i], dig[i])),
                        ops.mul(sp0, ops.sub(ndig[i], m_st[i]))),
                ops.mul(sel_fold, ops.sub(ndig[i], folded))))
        # sib/bit update freely at load rows, hold otherwise
        keep_path = ops.sub(ops.sub(one, sp0), sel_fold)
        for i in range(8):
            out.append(ops.mul(keep_path, ops.sub(nsib[i], sib[i])))
        out.append(ops.mul(keep_path, ops.sub(nbit, bit)))
        out.append(ops.mul(bit, ops.sub(bit, one)))

        # ---- fold flag: boolean, constant per period, prefix-shaped -------
        out.append(ops.mul(f, ops.sub(f, one)))
        out.append(ops.mul(ops.sub(one, sel_pe), ops.sub(nf, f)))
        out.append(ops.mul(sel_foldpre, ops.mul(nf, ops.sub(one, f))))
        # period 1 always folds on active segments
        out.append(ops.mul(sp0, ops.mul(active, ops.sub(one, nf))))

        # ---- accumulators -------------------------------------------------
        keep_acc = ops.sub(ops.sub(one, sel_fold), sel_seg)
        step_idx = ops.mul(f, ops.mul(bit, pw2))
        out.append(ops.add(
            ops.add(ops.mul(keep_acc, ops.sub(nidxacc, idxacc)),
                    ops.mul(sel_fold,
                            ops.sub(nidxacc, ops.add(idxacc, step_idx)))),
            ops.mul(sel_seg, nidxacc)))
        out.append(ops.add(
            ops.add(ops.mul(keep_acc, ops.sub(nfacc, facc)),
                    ops.mul(sel_fold, ops.sub(nfacc, ops.add(facc, f)))),
            ops.mul(sel_seg, nfacc)))

        # ---- segment-end checks (active segments) -------------------------
        seg_act = ops.mul(sel_seg, active)
        # accumulated index / fold count match the absorbed message
        out.append(ops.mul(seg_act, ops.sub(idxacc, msg[MF_IDX])))
        out.append(ops.mul(seg_act, ops.sub(facc, msg[MF_DEPTH])))
        # the path folds to the layer root
        for i in range(8):
            out.append(ops.mul(seg_act, ops.sub(dig[i], msg[MF_ROOT + i])))
        # chaining vs the previous layer (skipped on each query's first)
        chain = ops.mul(seg_act, ops.sub(one, msg[MF_FIRST]))
        sbit = msg[MF_SBIT]
        out.append(ops.mul(seg_act, ops.mul(sbit, ops.sub(sbit, one))))
        for i in range(4):
            got = ops.add(ops.mul(ops.sub(one, sbit), msg[MF_LO + i]),
                          ops.mul(sbit, msg[MF_HI + i]))
            out.append(ops.mul(chain, ops.sub(carried[i], got)))
        out.append(ops.mul(chain, ops.sub(
            raw, ops.add(msg[MF_IDX], ops.mul(sbit, msg[MF_HALF])))))
        # fold equation: (cout - (lo+hi)/2) * 2x == beta * (lo - hi)
        two_x = ops.add(msg[MF_X], msg[MF_X])
        e = [ops.sub(msg[MF_COUT + i],
                     ops.mul(ops.add(msg[MF_LO + i], msg[MF_HI + i]), inv2))
             for i in range(4)]
        d = [ops.sub(msg[MF_LO + i], msg[MF_HI + i]) for i in range(4)]
        beta = [msg[MF_BETA + i] for i in range(4)]
        # quartic ext product beta * d with x^4 = W reduction, generic ops
        w_c = ops.const(ext_ops.W)
        bd = []
        for c_i in range(4):
            acc = zero
            for a_i in range(4):
                b_i = c_i - a_i
                if b_i < 0:
                    b_i += 4
                    term = ops.mul(w_c, ops.mul(beta[a_i], d[b_i]))
                else:
                    term = ops.mul(beta[a_i], d[b_i])
                acc = ops.add(acc, term)
            bd.append(acc)
        for i in range(4):
            out.append(ops.mul(seg_act,
                               ops.sub(ops.mul(e[i], two_x), bd[i])))

        # ---- carried / raw registers --------------------------------------
        keep_seg = ops.sub(one, sel_seg)
        for i in range(4):
            out.append(ops.add(
                ops.mul(keep_seg, ops.sub(ncarried[i], carried[i])),
                ops.mul(sel_seg,
                        ops.sub(ncarried[i], msg[MF_COUT + i]))))
        out.append(ops.add(
            ops.mul(keep_seg, ops.sub(nraw, raw)),
            ops.mul(sel_seg, ops.sub(nraw, msg[MF_IDX]))))

        # ---- message limbs / active flag ----------------------------------
        for i in range(MSG_LIMBS):
            out.append(ops.mul(keep_seg, ops.sub(nmsg[i], msg[i])))
            out.append(ops.mul(ops.sub(one, active), msg[i]))
        out.append(ops.mul(active, ops.sub(active, one)))
        out.append(ops.mul(keep_seg, ops.sub(nactive, active)))
        out.append(ops.mul(ops.mul(sel_seg, nactive), ops.sub(one, active)))
        return out

    def boundaries(self, pub_inputs, n: int):
        digest = [int(v) % bb.P for v in pub_inputs[:8]]
        out = [(n - 1, T_STATE + i, digest[i]) for i in range(8)]
        out += [(0, IDXACC, 0), (0, FACC, 0)]
        return out


# ---------------------------------------------------------------------------
# Host schedule: segment messages, digest, trace generation
#
# The reference builds the trace period by period in Python (two Poseidon2
# round traces per 32-row period).  Here lane M, which restarts on every
# segment, runs for all segments at once in numpy (one batched permutation
# per period index); lane T, the transcript sponge, is one sequential chain
# and runs in plain Python ints; the register columns are filled per
# (segment, period) by broadcasting.  The array is the reference's.
# ---------------------------------------------------------------------------

def segment_count(num_items: int) -> int:
    need = num_items + 1
    return 1 << (need - 1).bit_length()


def transcript_digest(messages: list[list[int]], seg_periods: int,
                      segments: int | None = None) -> list[int]:
    """The public digest: sponge over every segment's 32 limbs under the
    in-trace schedule (4 absorb periods then idle carries per segment)."""
    if segments is None:
        segments = segment_count(len(messages))
    state = [0] * 16
    for k in range(segments):
        limbs = (messages[k] if k < len(messages) else [0] * MSG_LIMBS)
        chunks = _chunks(limbs)
        for j in range(seg_periods):
            if j < 4:
                state = [(state[i] + chunks[j][i]) % bb.P if i < 8
                         else state[i] for i in range(16)]
            state = perm_rows_py(state)[ROUNDS]
    return state[:8]


def generate_fri_verify_trace(items: list[dict], max_depth: int,
                              seg_periods: int,
                              segments: int | None = None) -> np.ndarray:
    """Build the honest trace.  Each item is one (query, layer) check:

        {"msg": [32 limbs], "path": [[8 limbs] per level], "bits": [...]}

    with len(path) == len(bits) == msg[MF_DEPTH].
    """
    if segments is None:
        segments = segment_count(len(items))
    if segments <= len(items):
        raise ValueError("need at least one inert tail segment")
    S = seg_periods
    G = segments
    n = G * S * PERIOD
    n_act = len(items)

    # ---- per-segment inputs ----------------------------------------------
    msg = np.zeros((G, MSG_LIMBS), dtype=np.uint64)
    depth = np.zeros(G, dtype=np.int64)
    dmax = max([int(it["msg"][MF_DEPTH]) % bb.P for it in items] + [1])
    path = np.zeros((G, dmax, 8), dtype=np.uint64)
    bits = np.zeros((G, dmax), dtype=np.uint64)
    for k, it in enumerate(items):
        msg[k] = [int(v) % bb.P for v in it["msg"]]
        d = int(msg[k, MF_DEPTH])
        depth[k] = d
        if d:
            path[k, :d] = [[int(v) % bb.P for v in sib] for sib in
                           it["path"][:d]]
            bits[k, :d] = [int(b) for b in it["bits"][:d]]
    if S < int(depth.max()) + 2:
        raise ValueError("seg_periods too small for the deepest path")
    active = (np.arange(G) < n_act).astype(np.uint64)
    seg_idx = np.arange(G)

    # ---- lane M and the dig register: all segments at once, per period ---
    lane_m = np.zeros((G, S, PERIOD, 16), dtype=np.uint32)
    dig = np.zeros((G, S, 8), dtype=np.uint64)      # value during period j
    m_in = np.zeros((G, 16), dtype=np.uint64)
    m_in[:, :8] = msg[:, MF_LO:MF_LO + 8]
    cur_dig = np.zeros((G, 8), dtype=np.uint64)
    for j in range(S):
        if j >= 1:
            dig[:, j] = cur_dig
        rows = perm_rows_np(m_in)                   # (G, 22, 16)
        lane_m[:, j] = pad_rows(rows)
        end = rows[:, ROUNDS]
        if j == S - 1:
            break
        fold_now = (j >= 1) & (j <= depth)
        if j == 0:
            cur_dig = end[:, :8].copy()
            nxt_fold = depth >= 1
        else:
            cur_dig = np.where(fold_now[:, None],
                               (end[:, :8] + m_in[:, :8]) % bb.P, cur_dig)
            nxt_fold = fold_now & (j + 1 <= depth)
        # the next period consumes path level j
        lvl = min(j, dmax - 1)
        sib_j = path[:, lvl]
        bit_j = bits[:, lvl][:, None]
        sel = np.where(bit_j == 1,
                       np.concatenate([sib_j, cur_dig], axis=1),
                       np.concatenate([cur_dig, sib_j], axis=1))
        m_in = np.where(nxt_fold[:, None], sel, end)
    final_dig = dig[:, S - 1].copy() if S > 1 else cur_dig

    # ---- sib / bit registers: the level in use, held between segments -----
    has_path = depth >= 1
    last_sib = path[seg_idx, np.maximum(depth - 1, 0)]
    last_bit = bits[seg_idx, np.maximum(depth - 1, 0)]
    start_sib = np.zeros((G, 8), dtype=np.uint64)
    start_bit = np.zeros(G, dtype=np.uint64)
    start_dig = np.zeros((G, 8), dtype=np.uint64)
    held_sib = np.zeros(8, dtype=np.uint64)
    held_bit = np.uint64(0)
    for k in range(1, G):
        if has_path[k - 1]:
            held_sib = last_sib[k - 1]
            held_bit = last_bit[k - 1]
        start_sib[k] = held_sib
        start_bit[k] = held_bit
        start_dig[k] = final_dig[k - 1]
    dig[:, 0] = start_dig
    jj = np.arange(S)
    lvl = np.clip(np.minimum(jj[None, :], depth[:, None]) - 1, 0, dmax - 1)
    use_path = (jj[None, :] >= 1) & has_path[:, None]            # (G, S)
    sib = np.where(use_path[..., None], path[seg_idx[:, None], lvl],
                   start_sib[:, None, :])
    bit = np.where(use_path, bits[seg_idx[:, None], lvl], start_bit[:, None])

    # ---- accumulators and flags -----------------------------------------
    fold = ((jj[None, :] >= 1) & (jj[None, :] <= depth[:, None])).astype(
        np.uint64)
    pw = np.array([(1 << max(j - 1, 0)) % bb.P for j in range(S)],
                  dtype=np.uint64)
    step = fold * bit * pw[None, :]
    idxacc = (np.cumsum(step, axis=1) - step) % bb.P
    facc = (np.cumsum(fold, axis=1) - fold).astype(np.uint64)
    carried = np.zeros((G, 4), dtype=np.uint64)
    raw = np.zeros(G, dtype=np.uint64)
    carried[1:] = msg[:-1, MF_COUT:MF_COUT + 4]
    raw[1:] = msg[:-1, MF_IDX]

    # ---- lane T: the transcript sponge, one chain ------------------------
    chunks = msg.reshape(G, 4, 8)
    lane_t = np.zeros((G, S, PERIOD, 16), dtype=np.uint32)
    state = [0] * 16
    zero8 = [0] * 8
    chunk_list = chunks.tolist()
    for k in range(G):
        ck = chunk_list[k]
        seg_rows = []
        for j in range(S):
            add = ck[j] if j < 4 else zero8
            t_in = [(state[i] + add[i]) % bb.P for i in range(8)] + state[8:]
            rows = perm_rows_py(t_in)
            seg_rows.append(rows)
            state = rows[ROUNDS]
        lane_t[k] = pad_rows(np.asarray(seg_rows, dtype=np.uint32))

    # ---- assemble ------------------------------------------------------
    tr = np.empty((G, S, PERIOD, WIDTH), dtype=np.uint32)
    tr[..., M_STATE:M_STATE + 16] = lane_m
    tr[..., T_STATE:T_STATE + 16] = lane_t
    del lane_m, lane_t

    def per_period(col0, vals):
        width = vals.shape[-1]
        tr[..., col0:col0 + width] = vals[:, :, None, :].astype(np.uint32)

    per_period(DIG, dig)
    per_period(SIB, sib)
    per_period(BIT, bit[..., None])
    per_period(FOLD, fold[..., None])
    per_period(IDXACC, idxacc[..., None])
    per_period(FACC, facc[..., None])
    per_seg = np.broadcast_to
    per_period(CARRIED, per_seg(carried[:, None, :], (G, S, 4)))
    per_period(RAW, per_seg(raw[:, None, None], (G, S, 1)))
    per_period(MSG, per_seg(msg[:, None, :], (G, S, MSG_LIMBS)))
    per_period(ACTIVE, per_seg(active[:, None, None], (G, S, 1)))
    return tr.reshape(n, WIDTH)
