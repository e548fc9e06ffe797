"""State-update AIR: the execution proof's state-transition circuit.

A copy of `ethrex_tpu/models/state_update_air.py`: the AIR, its honest
trace generator and the public log digest (host code; the constraints run
on the device through `stark.air.DeviceOps`).

Proves that applying a committed write log to a committed pre-state yields
the committed post-state — the in-circuit analog of the reference guest's
`execute_blocks` state handling (witness tries -> per-block apply ->
final root check), over the prover-internal touched-state Poseidon2 tree
(stark/state_tree.py) instead of the keccak MPT.

Statement (public inputs, 24 limbs):
    r_pre (8)      Poseidon2 root of the touched-state tree before the batch
    r_post (8)     root after every write in the log is applied, in order
    log_digest (8) sponge digest of the write log (key, old, new) limbs
                   under the fixed in-trace absorb schedule (`log_digest`)

For each log entry k the circuit verifies, entirely in-trace:
    leaf_old_k = H(key_k || old_k)        (3-permutation sponge, lane O)
    leaf_new_k = H(key_k || new_k)        (lane N)
    fold(leaf_old_k, path_k) == root_k    (D compress folds, lane O)
    root_{k+1} = fold(leaf_new_k, path_k) (lane N, same siblings/bits)
    root_0 = r_pre,  root_K = r_post      (cur_root chain + boundaries)
and lane L absorbs every entry's 33 limbs into the running log sponge whose
final state is bound to log_digest.  The path position is witness, but each
leaf binds its own key, so opening a different position for a logged key
would require a Poseidon2 sponge collision.

Trace layout: one SEGMENT of `seg_periods` (S) 32-row Poseidon2 periods per
log entry, plus >= 1 inert tail segment, padded to a power-of-two segment
count.  EVERY lane runs a full permutation EVERY period (uniform schedule —
one shared set of round-constant periodic columns, tiled with period 32);
the default transition between periods is one more permutation of the
carried state, and lanes differ only in their period-boundary handoffs:

    period:        0     1     2     3      4 ..  2+D      3+D .. S-1
    lane O/N:  [- leaf sponge -]  [------- path folds ------]  idle perms
    lane L:    absorb chunks 1..4 of the entry  idle perms (state carries)
    segment end (row 32S-1): lanes O/N reset to a fresh sponge absorbing
    the NEXT entry's first key chunk; lane L absorbs the next entry's
    chunk 0; cur_root advances to the new-lane root (gated by `active`;
    padding segments have all-zero msg limbs, enforced in-circuit, so
    they can alter neither the digest nor the root chain).

Columns (width 115):
    0..15  lane O state     48..55 dig_old   72  bit        114 active
    16..31 lane N state     56..63 dig_new   73..80 cur_root
    32..47 lane L state     64..71 sib       81..113 msg (33 limbs)
"""

from __future__ import annotations

import numpy as np

from ..ops import babybear as bb
from ..ops import poseidon2 as p2
from ..stark.air import Air
from ..stark.state_tree import AccessRecord
from .poseidon2_air import (PERIOD, ROUNDS, Poseidon2Air,
                            _external_linear_generic, generate_trace)

# column offsets
O_STATE, N_STATE, L_STATE = 0, 16, 32
DIG_OLD, DIG_NEW, SIB = 48, 56, 64
BIT, CUR_ROOT, MSG, ACTIVE = 72, 73, 81, 114
WIDTH = 115
MSG_LIMBS = 33  # key(11) || old(11) || new(11)


def _pad40(limbs: list[int]) -> list[list[int]]:
    """33 entry limbs -> five rate-8 chunks for the log sponge lane."""
    vals = [int(v) % bb.P for v in limbs] + [0] * (40 - len(limbs))
    return [vals[i:i + 8] for i in range(0, 40, 8)]


def _leaf_chunks(key11: list[int], val11: list[int]) -> list[list[int]]:
    """pad24(key || value) -> three rate-8 chunks for a leaf sponge lane
    (matches ops/merkle.hash_leaf_ref's padding of the 22-limb leaf)."""
    vals = [int(v) % bb.P for v in key11 + val11] + [0, 0]
    return [vals[i:i + 8] for i in range(0, 24, 8)]


class StateUpdateAir(Air):
    width = WIDTH
    max_degree = 8
    num_pub_inputs = 24
    num_periodic = Poseidon2Air.num_periodic + 8
    # + sel_pe, sel_seg_end, sel_p0..sel_p3, sel_fold, sel_first

    def __init__(self, depth: int, seg_periods: int = 16):
        if seg_periods & (seg_periods - 1) or seg_periods < 8:
            raise ValueError("seg_periods must be a power of two >= 8")
        # the last fold handoff (end of period 2+depth) must precede the
        # segment-end handoff (end of period S-1)
        if not 1 <= depth <= seg_periods - 4:
            raise ValueError(f"depth {depth} needs seg_periods > {depth + 3}")
        self.depth = depth
        self.seg_periods = seg_periods
        self.seg_len = PERIOD * seg_periods

    def cache_key(self) -> tuple:
        return (type(self), self.width, self.max_degree,
                self.num_pub_inputs, self.depth, self.seg_periods)

    def periodic_columns(self, n: int):
        if n % self.seg_len:
            raise ValueError("trace length must be a multiple of seg_len")
        base = Poseidon2Air().periodic_columns(PERIOD)
        sel_pe = np.zeros(PERIOD, dtype=np.uint32)
        sel_pe[PERIOD - 1] = 1  # every period-boundary row
        sl = self.seg_len

        def marker(rows):
            col = np.zeros(sl, dtype=np.uint32)
            for r in rows:
                col[r] = 1
            return col

        sel_seg_end = marker([sl - 1])
        sel_p = [marker([PERIOD * (j + 1) - 1]) for j in range(4)]
        sel_fold = marker([PERIOD * (4 + j) - 1 for j in range(self.depth)])
        sel_first = np.zeros(n, dtype=np.uint32)
        sel_first[0] = 1
        return base + [sel_pe, sel_seg_end] + sel_p + [sel_fold, sel_first]

    # -- constraint helpers -------------------------------------------------

    def _select(self, dig, sib, bit, ops):
        """Compression input halves by direction bit (left = our digest
        when bit = 0), as in ops/merkle.fold_path_canonical."""
        one = ops.const(1)
        inv = ops.sub(one, bit)
        lo = [ops.add(ops.mul(inv, dig[i]), ops.mul(bit, sib[i]))
              for i in range(8)]
        hi = [ops.add(ops.mul(bit, dig[i]), ops.mul(inv, sib[i]))
              for i in range(8)]
        return lo + hi

    def _absorbed(self, state, chunk, ops):
        """M_E(state + [chunk, 0^8]) — the duplex absorb handoff target."""
        zero = ops.const(0)
        padded = list(chunk) + [zero] * (16 - len(chunk))
        mixed = [ops.add(state[j], padded[j]) for j in range(16)]
        return _external_linear_generic(mixed, ops)

    def constraints(self, local, nxt, periodic, ops):
        nb = Poseidon2Air.num_periodic
        base_p = periodic[:nb]
        (sel_pe, sel_seg, sp0, sp1, sp2, sp3, sel_fold,
         sel_first) = periodic[nb:]
        one = ops.const(1)
        zero = ops.const(0)

        lanes = {
            "O": (local[O_STATE:O_STATE + 16], nxt[O_STATE:O_STATE + 16]),
            "N": (local[N_STATE:N_STATE + 16], nxt[N_STATE:N_STATE + 16]),
            "L": (local[L_STATE:L_STATE + 16], nxt[L_STATE:L_STATE + 16]),
        }
        dig_o = local[DIG_OLD:DIG_OLD + 8]
        ndig_o = nxt[DIG_OLD:DIG_OLD + 8]
        dig_n = local[DIG_NEW:DIG_NEW + 8]
        ndig_n = nxt[DIG_NEW:DIG_NEW + 8]
        sib = local[SIB:SIB + 8]
        nsib = nxt[SIB:SIB + 8]
        bit, nbit = local[BIT], nxt[BIT]
        cur = local[CUR_ROOT:CUR_ROOT + 8]
        ncur = nxt[CUR_ROOT:CUR_ROOT + 8]
        msg = local[MSG:MSG + MSG_LIMBS]
        nmsg = nxt[MSG:MSG + MSG_LIMBS]
        active, nactive = local[ACTIVE], nxt[ACTIVE]

        # per-lane within-segment absorb wirings (local msg columns)
        absorbs = {
            "O": [(sp0, msg[8:16]), (sp1, msg[16:22] + [zero, zero])],
            "N": [(sp0, msg[8:11] + msg[22:27]),
                  (sp1, msg[27:33] + [zero, zero])],
            "L": [(sp0, msg[8:16]), (sp1, msg[16:24]), (sp2, msg[24:32]),
                  (sp3, [msg[32]] + [zero] * 7)],
        }
        sel_load = ops.add(sp2, sel_fold)
        loads = {
            "O": _external_linear_generic(
                self._select(ndig_o, nsib, nbit, ops), ops),
            "N": _external_linear_generic(
                self._select(ndig_n, nsib, nbit, ops), ops),
        }

        out = []
        for name, (st, nst) in lanes.items():
            cons = Poseidon2Air.constraints(self, st, nst, base_p, ops)
            me = _external_linear_generic(st, ops)
            # default period transition: one more permutation of the
            # carried state, i.e. nxt = M_E(state) at every period end;
            # specific handoffs then replace M_E(state) with their target
            hand = list((sel, self._absorbed(st, chunk, ops))
                        for sel, chunk in absorbs[name])
            if name == "L":
                hand.append((sel_seg, self._absorbed(st, nmsg[0:8], ops)))
            else:
                hand.append((sel_seg,
                             self._absorbed([zero] * 16, nmsg[0:8], ops)))
                hand.append((sel_load, loads[name]))
            first_mixed = self._absorbed([zero] * 16, msg[0:8], ops)
            for j in range(16):
                c = ops.add(cons[j],
                            ops.mul(sel_pe, ops.sub(st[j], me[j])))
                for sel, mixed in hand:
                    c = ops.add(c, ops.mul(sel, ops.sub(me[j], mixed[j])))
                # row 0: every lane is a fresh sponge absorbing the first
                # entry's key chunk (local constraint on the row-0 state)
                c = ops.add(c, ops.mul(sel_first,
                                       ops.sub(st[j], first_mixed[j])))
                out.append(c)

        # digest registers: copy by default, load the leaf-sponge digest at
        # the end of period 2, compress feed-forward at fold handoffs
        keep_dig = ops.sub(ops.sub(one, sp2), sel_fold)
        inv_b = ops.sub(one, bit)
        for digs, ndigs, st in ((dig_o, ndig_o, lanes["O"][0]),
                                (dig_n, ndig_n, lanes["N"][0])):
            for i in range(8):
                ff = ops.add(st[i], ops.add(ops.mul(inv_b, digs[i]),
                                            ops.mul(bit, sib[i])))
                out.append(ops.add(
                    ops.add(ops.mul(keep_dig, ops.sub(ndigs[i], digs[i])),
                            ops.mul(sp2, ops.sub(ndigs[i], st[i]))),
                    ops.mul(sel_fold, ops.sub(ndigs[i], ff))))
        for i in range(8):
            out.append(ops.mul(keep_dig, ops.sub(nsib[i], sib[i])))
        out.append(ops.mul(keep_dig, ops.sub(nbit, bit)))
        out.append(ops.mul(bit, ops.sub(bit, one)))

        # root chain: within-segment copy; at segment end the next root is
        # the new-lane fold result (active) or carried unchanged (padding)
        keep_seg = ops.sub(one, sel_seg)
        for i in range(8):
            shift = ops.mul(active, ops.sub(dig_n[i], cur[i]))
            out.append(ops.add(
                ops.mul(keep_seg, ops.sub(ncur[i], cur[i])),
                ops.mul(sel_seg, ops.sub(ops.sub(ncur[i], cur[i]), shift))))
            # the old-lane fold must land on the current root
            out.append(ops.mul(ops.mul(sel_seg, active),
                               ops.sub(dig_o[i], cur[i])))

        # message limbs: constant within a segment, zero when inactive
        for i in range(MSG_LIMBS):
            out.append(ops.mul(keep_seg, ops.sub(nmsg[i], msg[i])))
            out.append(ops.mul(ops.sub(one, active), msg[i]))

        # active flag: boolean, constant within a segment, non-increasing
        out.append(ops.mul(keep_seg, ops.sub(nactive, active)))
        out.append(ops.mul(active, ops.sub(active, one)))
        out.append(ops.mul(ops.mul(sel_seg, nactive),
                           ops.sub(one, active)))
        return out

    def boundaries(self, pub_inputs, n: int):
        r_pre = [int(v) % bb.P for v in pub_inputs[:8]]
        r_post = [int(v) % bb.P for v in pub_inputs[8:16]]
        digest = [int(v) % bb.P for v in pub_inputs[16:24]]
        out = [(0, CUR_ROOT + i, r_pre[i]) for i in range(8)]
        out += [(n - 1, CUR_ROOT + i, r_post[i]) for i in range(8)]
        out += [(n - 1, L_STATE + i, digest[i]) for i in range(8)]
        return out


# ---------------------------------------------------------------------------
# Host schedule: trace generation + the public log digest definition
# ---------------------------------------------------------------------------

def segment_count(num_accesses: int) -> int:
    """Power-of-two segment count with >= 1 inert tail segment (the last
    segment's end-of-trace handoff row is excluded from transition
    constraints, so the final active update must land on an interior
    segment boundary)."""
    need = num_accesses + 1
    return 1 << (need - 1).bit_length()


def log_digest(accesses: list[AccessRecord], seg_periods: int = 16,
               segments: int | None = None) -> list[int]:
    """The public log commitment: a Poseidon2 sponge over every entry's
    33 limbs under the exact in-trace schedule — 5 absorb-then-permute
    periods followed by seg_periods - 5 carry permutations per segment;
    padding segments absorb zeros."""
    if segments is None:
        segments = segment_count(len(accesses))
    state = [0] * 16
    for k in range(segments):
        limbs = (accesses[k].msg_limbs() if k < len(accesses)
                 else [0] * MSG_LIMBS)
        chunks = _pad40(limbs)
        for j in range(seg_periods):
            if j < 5:
                state = [(state[i] + chunks[j][i]) % bb.P if i < 8
                         else state[i] for i in range(16)]
            state = p2.permute_ref(state)
    return state[:8]


def generate_state_update_trace(accesses: list[AccessRecord],
                                initial_root: list[int], depth: int,
                                seg_periods: int = 16,
                                segments: int | None = None) -> np.ndarray:
    """Build the honest trace for a write log (AccessRecords from
    TouchedStateTree.update, applied in order starting at initial_root)."""
    if segments is None:
        segments = segment_count(len(accesses))
    if segments <= len(accesses):
        raise ValueError("need at least one inert tail segment")
    S = seg_periods
    n = segments * S * PERIOD
    tr = np.zeros((n, WIDTH), dtype=np.uint32)

    # lane inputs for the upcoming period (generate_trace applies M_E)
    lane_in = {"O": None, "N": None, "L": [0] * 16}
    # registers carried across rows (updated only at handoffs)
    dig = {"O": [0] * 8, "N": [0] * 8}
    sib_reg, bit_reg = [0] * 8, 0
    cur_root = [int(v) % bb.P for v in initial_root]
    zero33 = [0] * MSG_LIMBS

    for k in range(segments):
        active = 1 if k < len(accesses) else 0
        rec = accesses[k] if active else None
        limbs = rec.msg_limbs() if active else zero33
        key11, old11, new11 = limbs[:11], limbs[11:22], limbs[22:33]
        chunks = {
            "O": _leaf_chunks(key11, old11),
            "N": _leaf_chunks(key11, new11),
            "L": _pad40(limbs),
        }
        sibs = rec.siblings if active else [[0] * 8] * depth
        bits = rec.bits if active else [0] * depth
        seg0 = k * S * PERIOD
        if k == 0:
            for name in lane_in:
                lane_in[name] = [limbs[i] % bb.P if i < 8 else 0
                                 for i in range(16)]
        for j in range(S):
            base = seg0 + j * PERIOD
            rows_slice = slice(base, base + PERIOD)
            # registers DURING period j (set by the handoff into it)
            tr[rows_slice, DIG_OLD:DIG_OLD + 8] = dig["O"]
            tr[rows_slice, DIG_NEW:DIG_NEW + 8] = dig["N"]
            tr[rows_slice, SIB:SIB + 8] = sib_reg
            tr[rows_slice, BIT] = bit_reg
            tr[rows_slice, CUR_ROOT:CUR_ROOT + 8] = cur_root
            tr[rows_slice, MSG:MSG + MSG_LIMBS] = \
                [v % bb.P for v in limbs]
            tr[rows_slice, ACTIVE] = active
            ends = {}
            for name, col in (("O", O_STATE), ("N", N_STATE),
                              ("L", L_STATE)):
                rows = generate_trace(lane_in[name])
                tr[rows_slice, col:col + 16] = rows
                ends[name] = [int(v) for v in rows[ROUNDS]]
            # --- handoffs into period j+1 -------------------------------
            if j == S - 1:
                break  # segment-end handoff handled after the loop
            lane_in["L"] = list(ends["L"])
            if j < 4:
                lane_in["L"] = [
                    (lane_in["L"][i] + chunks["L"][j + 1][i]) % bb.P
                    if i < 8 else lane_in["L"][i] for i in range(16)]
            for name in ("O", "N"):
                end = ends[name]
                if j < 2:        # leaf sponge absorbs chunks 1, 2
                    lane_in[name] = [
                        (end[i] + chunks[name][j + 1][i]) % bb.P
                        if i < 8 else end[i] for i in range(16)]
                elif j == 2 or 3 <= j <= 2 + depth:
                    if j == 2:   # leaf digest ready
                        dig[name] = end[:8]
                    else:        # fold: compress feed-forward
                        inp = lane_in[name]
                        dig[name] = [(end[i] + inp[i]) % bb.P
                                     for i in range(8)]
                    # load the next compression input
                    lvl = j - 2 if j - 2 < depth else depth - 1
                    if name == "N":  # update shared path registers once
                        sib_reg = list(sibs[lvl])
                        bit_reg = bits[lvl]
                    d, s, b = dig[name], sibs[lvl], bits[lvl]
                    lane_in[name] = (list(s) + list(d)) if b \
                        else (list(d) + list(s))
                else:
                    lane_in[name] = list(end)
        # --- segment-end handoff ---------------------------------------
        if active:
            cur_root = list(dig["N"])
        if k + 1 < segments:
            nxt_limbs = (accesses[k + 1].msg_limbs()
                         if k + 1 < len(accesses) else zero33)
            for name in ("O", "N"):
                lane_in[name] = [nxt_limbs[i] % bb.P if i < 8 else 0
                                 for i in range(16)]
            endL = ends["L"]
            lane_in["L"] = [(endL[i] + (nxt_limbs[i] % bb.P)) % bb.P
                            if i < 8 else endL[i] for i in range(16)]
    return tr


def state_update_public_inputs(accesses: list[AccessRecord],
                               initial_root: list[int],
                               final_root: list[int],
                               seg_periods: int = 16,
                               segments: int | None = None) -> list[int]:
    return ([int(v) % bb.P for v in initial_root]
            + [int(v) % bb.P for v in final_root]
            + log_digest(accesses, seg_periods, segments))
