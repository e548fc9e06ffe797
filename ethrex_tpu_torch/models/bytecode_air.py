"""Generic bytecode VM AIR: EVM stack-machine semantics of arbitrary
(subset) bytecode, in-circuit.

A copy of `ethrex_tpu/models/bytecode_air.py` (the AIR, its honest trace
generator and the public digest).

Where the transfer/token circuits prove FIXED transaction shapes, this
circuit interprets a bytecode program step by step: one trace segment per
executed instruction, with the machine state (pc, a 14-slot stack window
of 11x24-bit limbs, a 4-word memory file, halt flag) held in
segment-constant columns and every inter-segment transition constrained
by the executed opcode's small-step semantics:

    PUSHk/CALLER/CALLVALUE/CALLDATASIZE/DUPn   shift down, inject value
    ISZERO/CALLDATALOAD/MLOAD/SLOAD            replace top
    ADD/SUB/LT/GT/EQ                           pop 2 push result (carry/
                                               borrow chains; EQ via
                                               limb-inverse witnesses)
    POP/JUMP                                   shift up 1
    MSTORE/SSTORE/JUMPI                        shift up 2
    SWAPn                                      window exchange 0 <-> n
    JUMPDEST                                   no-op
    STOP/RETURN                                set the sticky halt flag

plus pc arithmetic (sequential pc+1+pushlen; JUMP/JUMPI redirect to the
stack top, JUMPI muxed by an in-circuit ISZERO of the condition), depth
tracking as a one-hot column bank with underflow/overflow guards, and a
one-hot memory-word selector binding MLOAD/MSTORE offsets.

Statement (public inputs, 8 limbs): `bcdigest`, a Poseidon2 sponge over
one 8-period segment per step absorbing

    [pc, op, pushlen] || imm(11) || rec_a(11) || rec_b(11)

where rec_a/rec_b carry the step's externally-checkable record (storage
slot + value, calldata offset + word, env value, ALU result).  The host
verifier recomputes bcdigest from the claimed step list
(guest/bytecode_vm.check_steps) checking each absorbed field against its
native source — the contract code bytes, the claimed calldata/envelope,
and the SAME write-log rows the state circuit applies — by pure data
indexing.  Canonical re-limbing in that recompute doubles as the range
check: a non-canonical in-circuit limb witness (e.g. a dropped carry)
produces a different absorbed stream and can never match the digest, so
no range-check bit columns are needed (the TransferAir argument).

The reference's equivalent guarantee comes from executing the guest
inside the zkVM (crates/guest-program/src/common/execution.rs:42-209,
crates/prover/src/backend/sp1.rs:145-163); this is that seat's
tpu-native generalization beyond the transfer/token classes.
"""

from __future__ import annotations

import numpy as np

from ..guest import bytecode_vm as bv
from ..guest.flat_model import int_limbs
from ..ops import babybear as bb
from ..ops import poseidon2 as p2
from ..stark.air import Air
from .poseidon2_air import (PERIOD, ROUNDS, Poseidon2Air,
                            _external_linear_generic, generate_trace)

SEG_PERIODS = 8
SEG_LEN = PERIOD * SEG_PERIODS
NUM_CHUNKS = 7

NUM_FLAGS = 26
(F_STOP, F_ADD, F_SUB, F_LT, F_GT, F_EQ, F_ISZERO, F_CALLER, F_CALLVALUE,
 F_CDLOAD, F_CDSIZE, F_POP, F_MLOAD, F_MSTORE, F_SLOAD, F_SSTORE, F_JUMP,
 F_JUMPI, F_JDEST, F_PUSH, F_DUP, F_SWAP, F_RETURN, F_NOT, F_PC,
 F_ADDRESS) = range(NUM_FLAGS)

_FLAG_OPCODE = {
    F_STOP: bv.OP_STOP, F_ADD: bv.OP_ADD, F_SUB: bv.OP_SUB, F_LT: bv.OP_LT,
    F_GT: bv.OP_GT, F_EQ: bv.OP_EQ, F_ISZERO: bv.OP_ISZERO,
    F_CALLER: bv.OP_CALLER, F_CALLVALUE: bv.OP_CALLVALUE,
    F_CDLOAD: bv.OP_CDLOAD, F_CDSIZE: bv.OP_CDSIZE, F_POP: bv.OP_POP,
    F_MLOAD: bv.OP_MLOAD, F_MSTORE: bv.OP_MSTORE, F_SLOAD: bv.OP_SLOAD,
    F_SSTORE: bv.OP_SSTORE, F_JUMP: bv.OP_JUMP, F_JUMPI: bv.OP_JUMPI,
    F_JDEST: bv.OP_JUMPDEST, F_RETURN: bv.OP_RETURN, F_NOT: bv.OP_NOT,
    F_PC: bv.OP_PC, F_ADDRESS: bv.OP_ADDRESS,
}

SLOTS = bv.MAX_DEPTH          # 14 stack window slots
DSEL_W = SLOTS                # DUP index n-1 / SWAP index n
MEMW = bv.MEM_WORDS           # 4

# column offsets
T = 0
PC = 16
HALT = 17
FLG = 18
DSEL = FLG + NUM_FLAGS                    # 41
PLEN = DSEL + DSEL_W                      # 55
IMM = PLEN + 1                            # 56
RA = IMM + 11                             # 67
RB = RA + 11                              # 78
STK = RB + 11                             # 89
DEP = STK + 11 * SLOTS                    # 243 (one-hot depth 0..SLOTS)
MEM = DEP + SLOTS + 1                     # 258
MSEL = MEM + 11 * MEMW                    # 302
CR = MSEL + MEMW                          # 306
EQE = CR + 11                             # 317
EQW = EQE + 11                            # 328
EQF = EQW + 11                            # 339
Z = EQF + 10                              # 349
ZW = Z + 1                                # 350
WIDTH = ZW + 1                            # 351

TWO24 = 1 << 24


def _flag_of_op(op: int) -> int:
    if bv.OP_PUSH0 <= op <= bv.OP_PUSH0 + 32:
        return F_PUSH
    if 0x80 <= op < 0x80 + bv.MAX_DUP:
        return F_DUP
    if 0x90 <= op < 0x90 + bv.MAX_SWAP:
        return F_SWAP
    for f, o in _FLAG_OPCODE.items():
        if o == op:
            return f
    raise ValueError(f"opcode 0x{op:02x} outside the circuit subset")


def _dsel_index(op: int) -> int | None:
    if 0x80 <= op < 0x80 + bv.MAX_DUP:
        return op - 0x80            # DUP_n duplicates slot n-1
    if 0x90 <= op < 0x90 + bv.MAX_SWAP:
        return op - 0x90 + 1        # SWAP_n exchanges slot 0 <-> n
    return None


def _step_chunks(step) -> list[list[int]]:
    """The NUM_CHUNKS rate-8 absorb chunks of one step."""
    head = [step.pc, step.op, step.pushlen, 0, 0, 0, 0, 0]
    imm = int_limbs(step.imm, 11)
    ra = int_limbs(step.a, 11)
    rb = int_limbs(step.b, 11)
    return [head,
            imm[0:8], imm[8:11] + [0] * 5,
            ra[0:8], ra[8:11] + [0] * 5,
            rb[0:8], rb[8:11] + [0] * 5]


def segment_count(num_steps: int) -> int:
    """>= 1 inert tail segment, with a 16-segment floor so short calls
    share one compiled trace shape (prover and verifier both derive the
    count from the step list, so the floor is part of the statement)."""
    need = num_steps + 1
    return max(16, 1 << (need - 1).bit_length())


def bc_digest_stream(steps: list, segments: int | None = None) -> list[int]:
    """The public statement digest from claimed StepRecs — what a verifier
    computes from the claimed step list alone (after
    guest/bytecode_vm.check_steps pins every field to its source)."""
    if segments is None:
        segments = segment_count(len(steps))
    state = [0] * 16
    for k in range(segments):
        chunks = _step_chunks(steps[k]) if k < len(steps) \
            else [None] * SEG_PERIODS
        for j in range(SEG_PERIODS):
            c = chunks[j] if j < len(chunks) else None
            if c is not None:
                state = [(state[i] + c[i]) % bb.P if i < 8 else state[i]
                         for i in range(16)]
            state = p2.permute_ref(state)
    return state[:8]


class BytecodeAir(Air):
    width = WIDTH
    max_degree = 8
    num_pub_inputs = 8
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

    # -- helpers over column views ----------------------------------------

    @staticmethod
    def _opv(f, plen, idxsum, ops):
        """The opcode byte as a (degree-2) expression of the flags."""
        acc = ops.const(0)
        for fl, opc in _FLAG_OPCODE.items():
            if opc:
                acc = ops.add(acc, ops.mul(f[fl], ops.const(opc)))
        acc = ops.add(acc, ops.mul(f[F_PUSH],
                                   ops.add(ops.const(bv.OP_PUSH0), plen)))
        acc = ops.add(acc, ops.mul(f[F_DUP],
                                   ops.add(ops.const(0x80), idxsum)))
        acc = ops.add(acc, ops.mul(f[F_SWAP],
                                   ops.add(ops.const(0x8F), idxsum)))
        return acc

    def constraints(self, local, nxt, periodic, ops):
        nb = Poseidon2Air.num_periodic
        base_p = periodic[:nb]
        sel_pe = periodic[nb]
        m = periodic[nb + 1:nb + NUM_CHUNKS]
        sel_seg = periodic[nb + NUM_CHUNKS]
        sel_first = periodic[nb + NUM_CHUNKS + 1]
        one = ops.const(1)
        zero = ops.const(0)
        two24 = ops.const(TWO24)

        tl, ntl = local[T:T + 16], nxt[T:T + 16]
        h, hn = local[HALT], nxt[HALT]
        act = ops.sub(one, h)
        n_act = ops.sub(one, hn)
        f = local[FLG:FLG + NUM_FLAGS]
        fn = nxt[FLG:FLG + NUM_FLAGS]
        dsel = local[DSEL:DSEL + DSEL_W]
        plen = local[PLEN]
        imm = local[IMM:IMM + 11]
        ra = local[RA:RA + 11]
        rb = local[RB:RB + 11]
        stk = [local[STK + 11 * i:STK + 11 * (i + 1)]
               for i in range(SLOTS)]
        nstk = [nxt[STK + 11 * i:STK + 11 * (i + 1)] for i in range(SLOTS)]
        d = local[DEP:DEP + SLOTS + 1]
        nd = nxt[DEP:DEP + SLOTS + 1]
        mem = [local[MEM + 11 * i:MEM + 11 * (i + 1)] for i in range(MEMW)]
        nmem = [nxt[MEM + 11 * i:MEM + 11 * (i + 1)] for i in range(MEMW)]
        msel = local[MSEL:MSEL + MEMW]
        cr = local[CR:CR + 11]
        e = local[EQE:EQE + 11]
        w = local[EQW:EQW + 11]
        fch = local[EQF:EQF + 10]
        z, zw = local[Z], local[ZW]

        def fsum(idxs):
            acc = zero
            for i in idxs:
                acc = ops.add(acc, f[i])
            return acc

        idxsum = zero
        for i in range(DSEL_W):
            if i:
                idxsum = ops.add(idxsum, ops.mul(ops.const(i), dsel[i]))

        pushg = fsum([F_PUSH, F_CALLER, F_CALLVALUE, F_CDSIZE, F_DUP,
                      F_PC, F_ADDRESS])
        replg = fsum([F_ISZERO, F_CDLOAD, F_MLOAD, F_SLOAD, F_NOT])
        alug = fsum([F_ADD, F_SUB, F_LT, F_GT, F_EQ])
        pop1g = fsum([F_POP, F_JUMP])
        pop2g = fsum([F_MSTORE, F_SSTORE, F_JUMPI])
        keepg = f[F_JDEST]
        swapg = f[F_SWAP]
        stopg = fsum([F_STOP, F_RETURN])
        memg = fsum([F_MLOAD, F_MSTORE])
        rag = fsum([F_SLOAD, F_SSTORE, F_CDLOAD])
        rbg = fsum([F_SLOAD, F_SSTORE, F_CDLOAD, F_CALLER, F_CALLVALUE,
                    F_CDSIZE, F_ADD, F_SUB, F_LT, F_GT, F_ADDRESS])

        out = []

        # ---- lane T: the bcdigest schedule -------------------------------
        data = ([local[PC],
                 self._opv(f, plen, idxsum, ops), plen, zero, zero, zero,
                 zero, zero],
                imm[0:8], list(imm[8:11]) + [zero] * 5,
                ra[0:8], list(ra[8:11]) + [zero] * 5,
                rb[0:8], list(rb[8:11]) + [zero] * 5)
        n_idxsum = zero
        for i in range(DSEL_W):
            if i:
                n_idxsum = ops.add(n_idxsum,
                                   ops.mul(ops.const(i), nxt[DSEL + i]))
        n_c0 = [nxt[PC], self._opv(fn, nxt[PLEN], n_idxsum, ops),
                nxt[PLEN], zero, zero, zero, zero, zero]
        cons = Poseidon2Air.constraints(self, tl, ntl, base_p, ops)
        me = _external_linear_generic(tl, ops)
        hand = [(m[j], self._absorbed(tl, data[j + 1], ops), act)
                for j in range(NUM_CHUNKS - 1)]
        hand.append((sel_seg, self._absorbed(tl, n_c0, ops), n_act))
        first_mixed = self._absorbed([zero] * 16, data[0], ops)
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
        for col in range(PC, WIDTH):
            out.append(ops.mul(keep, ops.sub(nxt[col], local[col])))

        # ---- flags / one-hots --------------------------------------------
        for flag in list(f) + list(dsel) + list(msel) + list(d) + [z] \
                + list(cr) + list(e):
            out.append(ops.mul(flag, ops.sub(flag, one)))
        out.append(ops.sub(fsum(range(NUM_FLAGS)), act))     # one op iff live
        dsum = zero
        for v in dsel:
            dsum = ops.add(dsum, v)
        out.append(ops.sub(dsum, ops.add(f[F_DUP], f[F_SWAP])))
        msum = zero
        for v in msel:
            msum = ops.add(msum, v)
        out.append(ops.sub(msum, memg))
        depsum = zero
        for v in d:
            depsum = ops.add(depsum, v)
        out.append(ops.sub(depsum, one))
        out.append(ops.mul(h, ops.sub(h, one)))

        # ---- data hygiene -------------------------------------------------
        for l in range(11):
            out.append(ops.mul(ops.sub(one, f[F_PUSH]), imm[l]))
            out.append(ops.mul(ops.sub(one, rag), ra[l]))
            out.append(ops.mul(ops.sub(one, rbg), rb[l]))
        out.append(ops.mul(ops.sub(one, f[F_PUSH]), plen))

        # ---- depth guards -------------------------------------------------
        out.append(ops.mul(pushg, d[SLOTS]))                 # overflow
        out.append(ops.mul(ops.add(replg, pop1g), d[0]))     # 1-ary
        two_ary = ops.add(ops.add(alug, pop2g), f[F_RETURN])
        out.append(ops.mul(two_ary, ops.add(d[0], d[1])))
        # DUP_n needs depth >= n (idx n-1); SWAP_n depth >= n+1 (idx n):
        # both are "guard depths 0..idx"
        guard = zero
        for i in range(DSEL_W):
            cum = zero
            for jd in range(i + 1):
                cum = ops.add(cum, d[jd])
            guard = ops.add(guard, ops.mul(dsel[i], cum))
        out.append(ops.mul(ops.add(f[F_DUP], f[F_SWAP]), guard))

        # ---- memory offset binding ---------------------------------------
        off = zero
        for i in range(MEMW):
            if i:
                off = ops.add(off, ops.mul(msel[i], ops.const(32 * i)))
        out.append(ops.mul(memg, ops.sub(stk[0][10], off)))
        for l in range(10):
            out.append(ops.mul(memg, stk[0][l]))

        # ---- jump target binding -----------------------------------------
        jg = ops.add(f[F_JUMP], f[F_JUMPI])
        for l in range(10):
            out.append(ops.mul(jg, stk[0][l]))

        # ---- record bindings ---------------------------------------------
        for l in range(11):
            out.append(ops.mul(rag, ops.sub(ra[l], stk[0][l])))
            out.append(ops.mul(f[F_SSTORE], ops.sub(rb[l], stk[1][l])))

        # ---- z definitions (ISZERO on stk0 / JUMPI on stk1 / EQ chain) ---
        s0 = zero
        s1 = zero
        for l in range(11):
            s0 = ops.add(s0, stk[0][l])
            s1 = ops.add(s1, stk[1][l])
        for flag, s in ((f[F_ISZERO], s0), (f[F_JUMPI], s1)):
            out.append(ops.mul(flag, ops.mul(z, s)))
            out.append(ops.mul(flag, ops.sub(ops.mul(s, zw),
                                             ops.sub(one, z))))
        for l in range(11):
            delta = ops.sub(stk[0][l], stk[1][l])
            out.append(ops.mul(f[F_EQ], ops.mul(e[l], delta)))
            out.append(ops.mul(f[F_EQ],
                               ops.sub(ops.mul(delta, w[l]),
                                       ops.sub(one, e[l]))))
        out.append(ops.mul(f[F_EQ], ops.sub(fch[0], e[0])))
        for jx in range(1, 10):
            out.append(ops.mul(f[F_EQ],
                               ops.sub(fch[jx],
                                       ops.mul(fch[jx - 1], e[jx]))))
        out.append(ops.mul(f[F_EQ], ops.sub(z, ops.mul(fch[9], e[10]))))

        # ---- ALU chains (result rb; canonical via the absorbed digest) ---
        # the top limb of a canonical u256 holds 16 bits (256 = 10*24+16),
        # so the mod-2^256 wrap discards a 2^16-weight carry there
        two16 = ops.const(1 << 16)
        for i in range(10, -1, -1):
            cin = cr[i + 1] if i < 10 else zero
            radix = two16 if i == 0 else two24
            add_lhs = ops.sub(
                ops.sub(ops.add(ops.add(stk[0][i], stk[1][i]), cin),
                        ops.mul(radix, cr[i])), rb[i])
            out.append(ops.mul(f[F_ADD], add_lhs))
            sub_lhs = ops.sub(
                ops.add(ops.sub(ops.sub(stk[0][i], stk[1][i]), cin),
                        ops.mul(radix, cr[i])), rb[i])
            out.append(ops.mul(ops.add(f[F_SUB], f[F_LT]), sub_lhs))
            gt_lhs = ops.sub(
                ops.add(ops.sub(ops.sub(stk[1][i], stk[0][i]), cin),
                        ops.mul(radix, cr[i])), rb[i])
            out.append(ops.mul(f[F_GT], gt_lhs))

        # ---- value expressions -------------------------------------------
        def dupv(l):
            acc = zero
            for i in range(DSEL_W):
                acc = ops.add(acc, ops.mul(dsel[i], stk[i][l]))
            return acc

        def mlv(l):
            acc = zero
            for i in range(MEMW):
                acc = ops.add(acc, ops.mul(msel[i], mem[i][l]))
            return acc

        envg = fsum([F_CALLER, F_CALLVALUE, F_CDSIZE, F_ADDRESS])

        def pv(l):
            acc = ops.add(ops.mul(f[F_PUSH], imm[l]),
                          ops.mul(envg, rb[l]))
            acc = ops.add(acc, ops.mul(f[F_DUP], dupv(l)))
            if l == 10:
                acc = ops.add(acc, ops.mul(f[F_PC], local[PC]))
            return acc

        ldg = ops.add(f[F_CDLOAD], f[F_SLOAD])

        def rv(l):
            acc = ops.add(ops.mul(ldg, rb[l]), ops.mul(f[F_MLOAD], mlv(l)))
            if l == 10:
                acc = ops.add(acc, ops.mul(f[F_ISZERO], z))
            maxlimb = ops.const(((1 << 16) if l == 0 else (1 << 24)) - 1)
            acc = ops.add(acc, ops.mul(f[F_NOT],
                                       ops.sub(maxlimb, stk[0][l])))
            return acc

        def av(l):
            acc = ops.mul(ops.add(f[F_ADD], f[F_SUB]), rb[l])
            if l == 10:
                acc = ops.add(acc, ops.mul(ops.add(f[F_LT], f[F_GT]),
                                           cr[0]))
                acc = ops.add(acc, ops.mul(f[F_EQ], z))
            return acc

        frozen = ops.add(stopg, h)

        # ---- stack transition --------------------------------------------
        for i in range(SLOTS):
            for l in range(11):
                tgt = ops.mul(ops.add(keepg, frozen), stk[i][l])
                if i == 0:
                    tgt = ops.add(tgt, pv(l))
                    tgt = ops.add(tgt, rv(l))
                    tgt = ops.add(tgt, av(l))
                    tgt = ops.add(tgt, ops.mul(pop1g, stk[1][l]))
                    tgt = ops.add(tgt, ops.mul(pop2g, stk[2][l]))
                    tgt = ops.add(tgt, ops.mul(swapg, dupv(l)))
                else:
                    tgt = ops.add(tgt, ops.mul(pushg, stk[i - 1][l]))
                    tgt = ops.add(tgt, ops.mul(replg, stk[i][l]))
                    up1 = stk[i + 1][l] if i + 1 < SLOTS else zero
                    up2 = stk[i + 2][l] if i + 2 < SLOTS else zero
                    tgt = ops.add(tgt, ops.mul(ops.add(alug, pop1g), up1))
                    tgt = ops.add(tgt, ops.mul(pop2g, up2))
                    sw = ops.add(stk[i][l],
                                 ops.mul(dsel[i],
                                         ops.sub(stk[0][l], stk[i][l])))
                    tgt = ops.add(tgt, ops.mul(swapg, sw))
                out.append(ops.mul(sel_seg, ops.sub(nstk[i][l], tgt)))

        # ---- depth transition --------------------------------------------
        for j in range(SLOTS + 1):
            tgt = ops.mul(ops.add(ops.add(replg, keepg),
                                  ops.add(swapg, frozen)), d[j])
            if j >= 1:
                tgt = ops.add(tgt, ops.mul(pushg, d[j - 1]))
            if j + 1 <= SLOTS:
                tgt = ops.add(tgt, ops.mul(ops.add(alug, pop1g), d[j + 1]))
            if j + 2 <= SLOTS:
                tgt = ops.add(tgt, ops.mul(pop2g, d[j + 2]))
            out.append(ops.mul(sel_seg, ops.sub(nd[j], tgt)))

        # ---- memory transition -------------------------------------------
        for i in range(MEMW):
            for l in range(11):
                delta = ops.mul(ops.mul(f[F_MSTORE], msel[i]),
                                ops.sub(stk[1][l], mem[i][l]))
                out.append(ops.mul(sel_seg,
                                   ops.sub(nmem[i][l],
                                           ops.add(mem[i][l], delta))))

        # ---- pc + halt transition ----------------------------------------
        seqg = ops.sub(ops.sub(ops.sub(act, f[F_JUMP]), f[F_JUMPI]), stopg)
        pcp1 = ops.add(ops.add(local[PC], one), plen)
        t10 = stk[0][10]
        tgt_pc = ops.add(ops.mul(ops.add(h, stopg), local[PC]),
                         ops.mul(seqg, pcp1))
        tgt_pc = ops.add(tgt_pc, ops.mul(f[F_JUMP], t10))
        jmux = ops.add(ops.mul(z, pcp1),
                       ops.mul(ops.sub(one, z), t10))
        tgt_pc = ops.add(tgt_pc, ops.mul(f[F_JUMPI], jmux))
        out.append(ops.mul(sel_seg, ops.sub(nxt[PC], tgt_pc)))
        out.append(ops.mul(sel_seg, ops.sub(hn, ops.add(h, stopg))))
        return out

    def boundaries(self, pub_inputs, n: int):
        digest = [int(v) % bb.P for v in pub_inputs[:8]]
        out = [(n - 1, T + i, digest[i]) for i in range(8)]
        out += [(0, PC, 0), (0, HALT, 0), (n - 1, HALT, 1), (0, DEP, 1)]
        out += [(0, STK + k, 0) for k in range(11 * SLOTS)]
        out += [(0, MEM + k, 0) for k in range(11 * MEMW)]
        return out


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

def _carries_for(op: int, a: int, b: int):
    """(cr, rb_limbs) for the ALU ops, BE limbs, cin from limb i+1.  The
    top limb's radix is 2^16 (canonical u256 limbing), so the discarded
    carry there is exactly the mod-2^256 wrap."""
    al, bl = int_limbs(a, 11), int_limbs(b, 11)
    if op == bv.OP_GT:
        al, bl = bl, al
    cr = [0] * 11
    res = [0] * 11
    if op == bv.OP_ADD:
        cin = 0
        for i in range(10, -1, -1):
            radix = (1 << 16) if i == 0 else TWO24
            s = al[i] + bl[i] + cin
            cr[i] = 1 if s >= radix else 0
            res[i] = s - radix * cr[i]
            cin = cr[i]
    else:  # SUB / LT / GT share the borrow form
        bin_ = 0
        for i in range(10, -1, -1):
            radix = (1 << 16) if i == 0 else TWO24
            dv = al[i] - bl[i] - bin_
            cr[i] = 1 if dv < 0 else 0
            res[i] = dv + radix * cr[i]
            bin_ = cr[i]
    return cr, res


def generate_bytecode_trace(steps: list, snaps: list,
                            segments: int | None = None) -> np.ndarray:
    """Trace for (StepRec, Snapshot) streams from bytecode_vm.run_trace."""
    if segments is None:
        segments = segment_count(len(steps))
    if segments <= len(steps):
        raise ValueError("need at least one inert tail segment")
    n = segments * SEG_LEN
    tr = np.zeros((n, WIDTH), dtype=np.uint32)

    def absorb(state, chunk):
        return [(state[i] + chunk[i]) % bb.P if i < 8 else state[i]
                for i in range(16)]

    halted = False
    state = [0] * 16
    for k in range(segments):
        base = k * SEG_LEN
        chunks = [None] * SEG_PERIODS
        if k < len(steps):
            step, snap = steps[k], snaps[k]
            for j, c in enumerate(_step_chunks(step)):
                chunks[j] = c
            rows = slice(base, base + SEG_LEN)
            tr[rows, PC] = step.pc
            tr[rows, HALT] = 0
            fl = _flag_of_op(step.op)
            tr[rows, FLG + fl] = 1
            di = _dsel_index(step.op)
            if di is not None:
                tr[rows, DSEL + di] = 1
            tr[rows, PLEN] = step.pushlen
            tr[rows, IMM:IMM + 11] = int_limbs(step.imm, 11)
            tr[rows, RA:RA + 11] = int_limbs(step.a, 11)
            tr[rows, RB:RB + 11] = int_limbs(step.b, 11)
            depth = len(snap.stack)
            for i in range(min(depth, SLOTS)):
                tr[rows, STK + 11 * i:STK + 11 * (i + 1)] = \
                    int_limbs(snap.stack[i], 11)
            tr[rows, DEP + depth] = 1
            for i in range(MEMW):
                tr[rows, MEM + 11 * i:MEM + 11 * (i + 1)] = \
                    int_limbs(snap.mem[i], 11)
            if step.op in (bv.OP_MLOAD, bv.OP_MSTORE):
                tr[rows, MSEL + snap.stack[0] // 32] = 1
            if step.op in (bv.OP_ADD, bv.OP_SUB, bv.OP_LT, bv.OP_GT):
                cr, _res = _carries_for(step.op, snap.stack[0],
                                        snap.stack[1])
                tr[rows, CR:CR + 11] = cr
            if step.op == bv.OP_EQ:
                a_l = int_limbs(snap.stack[0], 11)
                b_l = int_limbs(snap.stack[1], 11)
                fprev = 1
                for l in range(11):
                    delta = (a_l[l] - b_l[l]) % bb.P
                    eq = 1 if delta == 0 else 0
                    tr[rows, EQE + l] = eq
                    tr[rows, EQW + l] = 0 if eq else pow(delta, bb.P - 2,
                                                        bb.P)
                    if l < 10:
                        fprev = fprev * eq
                        tr[rows, EQF + l] = fprev
                z = 1 if snap.stack[0] == snap.stack[1] else 0
                tr[rows, Z] = z
            if step.op in (bv.OP_ISZERO, bv.OP_JUMPI):
                val = snap.stack[0] if step.op == bv.OP_ISZERO \
                    else snap.stack[1]
                s = sum(int_limbs(val, 11)) % bb.P
                tr[rows, Z] = 1 if s == 0 else 0
                tr[rows, ZW] = 0 if s == 0 else pow(s, bb.P - 2, bb.P)
            if step.op in (bv.OP_STOP, bv.OP_RETURN):
                halted = True
        else:
            rows = slice(base, base + SEG_LEN)
            tr[rows, HALT] = 1 if halted else 0
            if k < len(steps) or not halted:
                raise ValueError("trace without a halting step")
            # frozen machine state: copy the halt step's columns
            tr[rows, PC] = tr[base - 1, PC]
            for col in range(STK, MEM + 11 * MEMW):
                tr[rows, col] = tr[base - 1, col]
        for j in range(SEG_PERIODS):
            if chunks[j] is not None:
                state = absorb(state, chunks[j])
            prows = generate_trace(state)
            rbase = base + j * PERIOD
            tr[rbase:rbase + PERIOD, T:T + 16] = prows
            state = [int(v) for v in prows[ROUNDS]]
    return tr


def bytecode_public_inputs(steps: list,
                           segments: int | None = None) -> list[int]:
    return bc_digest_stream(steps, segments)
