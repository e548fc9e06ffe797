"""Poseidon2 AIR: the permutation proven in-circuit, one row per round.

A copy of `ethrex_tpu/models/poseidon2_air.py` (AIRs and trace and
public-input generators).

This is the first cryptographically real AIR (hash preimage/compression
binding) and the core building block of the future zkVM AIR's hash/memory
arguments.  It proves y = P(x) for the SAME Poseidon2 the framework uses
for Merkle commitments (ops/poseidon2.py) — constants, matrices, rounds all
identical, verified by tests against permute_ref.

Two AIRs live here:
  * Poseidon2Air — one permutation (n = 32 rows), compression statement.
  * Poseidon2SpongeAir — k chained permutations with absorb transitions
    (duplex sponge), proving ops/poseidon2.hash_leaves in-circuit.
  row 0      = state after the initial external linear layer
  row r+1    = round r applied to row r         (r = 0..20)
  row 21     = P(x) (final state)
  rows 22-31 = padding (forced copies of row 21)

Periodic columns: [sel_ext, sel_int, ext_rc_0..15, int_rc] — selectors pick
the round type per row; the x^7 S-box makes max constraint degree 8
(selector deg 1 + sbox deg 7), so the proof runs at blowup 8.

Public inputs: 16 input limbs + 8 digest limbs, bound via boundary
constraints at rows 0 and 21; digest = P(x)[:8] + x[:8] (the framework's
2-to-1 compression feed-forward, ops/poseidon2.compress).
"""

from __future__ import annotations

import numpy as np

from ..ops import babybear as bb
from ..ops import poseidon2 as p2
from ..stark.air import Air

PERIOD = 32
ROUNDS = p2.ROUNDS_F + p2.ROUNDS_P  # 21
_EXT_ROWS_1 = list(range(0, p2._HALF_F))                      # rounds 0-3
_INT_ROWS = list(range(p2._HALF_F, p2._HALF_F + p2.ROUNDS_P))  # 4-16
_EXT_ROWS_2 = list(range(p2._HALF_F + p2.ROUNDS_P, ROUNDS))    # 17-20


def _m4_generic(x0, x1, x2, x3, ops):
    """The Poseidon2 M4 evaluation chain over abstract field ops
    (mirrors ops/poseidon2._m4)."""
    dbl = lambda v: ops.add(v, v)  # noqa: E731
    t0 = ops.add(x0, x1)
    t1 = ops.add(x2, x3)
    t2 = ops.add(dbl(x1), t1)
    t3 = ops.add(dbl(x3), t0)
    t4 = ops.add(dbl(dbl(t1)), t3)
    t5 = ops.add(dbl(dbl(t0)), t2)
    t6 = ops.add(t3, t5)
    t7 = ops.add(t2, t4)
    return t6, t5, t7, t4


def _external_linear_generic(cols, ops):
    blocks = [_m4_generic(*cols[i:i + 4], ops) for i in range(0, 16, 4)]
    sums = [ops.add(ops.add(blocks[0][j], blocks[1][j]),
                    ops.add(blocks[2][j], blocks[3][j])) for j in range(4)]
    out = []
    for b in blocks:
        out.extend(ops.add(b[j], sums[j]) for j in range(4))
    return out


def _sbox_generic(x, ops):
    x2 = ops.mul(x, x)
    x4 = ops.mul(x2, x2)
    return ops.mul(ops.mul(x4, x2), x)


class Poseidon2Air(Air):
    width = p2.WIDTH            # 16
    max_degree = 8              # selector (1) * sbox (7)
    num_pub_inputs = 24         # 16 input limbs + 8 digest limbs
    num_periodic = 2 + 16 + 1   # sel_ext, sel_int, ext rc x16, int rc

    def periodic_columns(self, n: int):
        if n % PERIOD:
            raise ValueError("trace length must be a multiple of 32")
        sel_ext = np.zeros(PERIOD, dtype=np.uint32)
        sel_int = np.zeros(PERIOD, dtype=np.uint32)
        for r in _EXT_ROWS_1 + _EXT_ROWS_2:
            sel_ext[r] = 1
        for r in _INT_ROWS:
            sel_int[r] = 1
        ext_rc = np.zeros((16, PERIOD), dtype=np.uint32)
        for i, r in enumerate(_EXT_ROWS_1):
            ext_rc[:, r] = p2.EXT_RC[i]
        for i, r in enumerate(_EXT_ROWS_2):
            ext_rc[:, r] = p2.EXT_RC[p2._HALF_F + i]
        int_rc = np.zeros(PERIOD, dtype=np.uint32)
        for i, r in enumerate(_INT_ROWS):
            int_rc[r] = p2.INT_RC[i]
        return [sel_ext, sel_int] + [ext_rc[j] for j in range(16)] + [int_rc]

    def constraints(self, local, nxt, periodic, ops):
        sel_ext, sel_int = periodic[0], periodic[1]
        ext_rc = periodic[2:18]
        int_rc = periodic[18]
        one = ops.const(1)
        sel_none = ops.sub(ops.sub(one, sel_ext), sel_int)
        # external round: M_E(sbox(s + rc))
        sboxed = [_sbox_generic(ops.add(local[j], ext_rc[j]), ops)
                  for j in range(16)]
        ext_out = _external_linear_generic(sboxed, ops)
        # internal round: s0 <- sbox(s0 + rc); out = sum(s) + mu_j * s_j
        s0 = _sbox_generic(ops.add(local[0], int_rc), ops)
        int_state = [s0] + list(local[1:])
        tot = int_state[0]
        for v in int_state[1:]:
            tot = ops.add(tot, v)
        mu = [ops.const(int(m)) for m in p2.DIAG_MU]
        int_out = [ops.add(tot, ops.mul(mu[j], int_state[j]))
                   for j in range(16)]
        out = []
        for j in range(16):
            c = ops.add(
                ops.add(
                    ops.mul(sel_ext, ops.sub(nxt[j], ext_out[j])),
                    ops.mul(sel_int, ops.sub(nxt[j], int_out[j]))),
                ops.mul(sel_none, ops.sub(nxt[j], local[j])))
            out.append(c)
        return out

    def boundaries(self, pub_inputs, n: int):
        limbs = [int(v) % bb.P for v in pub_inputs[:16]]
        digest = [int(v) % bb.P for v in pub_inputs[16:24]]
        row0 = p2._external_linear_ref(limbs)
        out = [(0, j, row0[j]) for j in range(16)]
        # digest = P(x)[:8] + x[:8]  =>  final-state limb = digest - input
        out += [(ROUNDS, j, (digest[j] - limbs[j]) % bb.P)
                for j in range(8)]
        return out


def generate_trace(limbs: list[int]) -> np.ndarray:
    """Round-by-round permutation states for P(limbs), padded to 32 rows."""
    assert len(limbs) == 16
    trace = np.zeros((PERIOD, 16), dtype=np.uint32)
    s = p2._external_linear_ref([int(v) % bb.P for v in limbs])
    trace[0] = s
    row = 0
    for r in range(p2._HALF_F):
        s = [(x + int(c)) % bb.P for x, c in zip(s, p2.EXT_RC[r])]
        s = [p2._sbox_ref(x) for x in s]
        s = p2._external_linear_ref(s)
        row += 1
        trace[row] = s
    for r in range(p2.ROUNDS_P):
        s0 = p2._sbox_ref((s[0] + int(p2.INT_RC[r])) % bb.P)
        s = [s0] + s[1:]
        tot = sum(s) % bb.P
        s = [(tot + int(m) * x) % bb.P for x, m in zip(s, p2.DIAG_MU)]
        row += 1
        trace[row] = s
    for r in range(p2._HALF_F, p2.ROUNDS_F):
        s = [(x + int(c)) % bb.P for x, c in zip(s, p2.EXT_RC[r])]
        s = [p2._sbox_ref(x) for x in s]
        s = p2._external_linear_ref(s)
        row += 1
        trace[row] = s
    for r in range(row + 1, PERIOD):
        trace[r] = trace[row]
    return trace


def public_inputs(limbs: list[int]) -> list[int]:
    """[input limbs, digest] with digest = compress feed-forward."""
    limbs = [int(v) % bb.P for v in limbs]
    final = p2.permute_ref(limbs)
    digest = [(final[j] + limbs[j]) % bb.P for j in range(8)]
    return limbs + digest


# ---------------------------------------------------------------------------
# Sponge mode: chains of permutations absorbing 8-limb chunks — proves
# exactly p2.hash_leaves (the framework's Merkle leaf hash) in-circuit.
# ---------------------------------------------------------------------------

def tile_periodic_columns(n: int, active_periods: int,
                          handoffs: int | None = None):
    """Full-length schedule columns: the single-permutation period-32 base
    columns tiled over the first `active_periods` periods (zeros after),
    plus a sel_absorb column marking the first `handoffs` inter-period
    handoff rows (default: between active periods only; the Merkle AIR
    also hands off INTO its inert tail).  Shared by the sponge and
    Merkle-path AIRs."""
    if n < PERIOD * active_periods:
        raise ValueError("trace too short for the active period count")
    base32 = Poseidon2Air().periodic_columns(PERIOD)
    out = []
    for col in base32:
        full = np.zeros(n, dtype=np.uint32)
        full[:PERIOD * active_periods] = np.tile(col, active_periods)
        out.append(full)
    sel_absorb = np.zeros(n, dtype=np.uint32)
    count = active_periods - 1 if handoffs is None else handoffs
    for j in range(count):
        sel_absorb[PERIOD * (j + 1) - 1] = 1
    return out, sel_absorb


def splice_handoff(perm_cons, state, nxt_state, mixed, sel_absorb, ops):
    """Replace the permutation constraints' sel_none copy with a gated
    handoff at absorb rows: nxt_state = mixed there, copies elsewhere.
    (sel_none = 1 - sel_ext - sel_int also fires at the handoff row, so
    its copy term is subtracted before the gated handoff term is added.)"""
    out = []
    for j in range(16):
        copy_term = ops.mul(sel_absorb, ops.sub(nxt_state[j], state[j]))
        handoff = ops.mul(sel_absorb, ops.sub(nxt_state[j], mixed[j]))
        out.append(ops.add(ops.sub(perm_cons[j], copy_term), handoff))
    return out


class Poseidon2SpongeAir(Air):
    """k chained permutations, n = 32k rows, width 24 (16 state + 8 msg).

    Row layout per period: rows 0..21 the permutation, 22..30 forced
    copies, row 31 (except the trace's last row) the ABSORB transition:
        next_state = M_E(state + [msg_chunk, 0^8])
    which is the duplex-sponge step of ops/poseidon2.hash_leaves (absorb
    into the rate, then permute — whose first op is the external linear).
    The 8 message columns are boundary-bound to the public chunks at each
    absorb row (chunk 0 via the row-0 state boundary).

    Public inputs: 8k message limbs + 8 digest limbs, with
        digest = hash_leaves(message)  (merkle.hash_leaf_ref equivalently).
    """

    width = 24
    max_degree = 8
    num_periodic = Poseidon2Air.num_periodic + 1  # + sel_absorb

    def __init__(self, num_chunks: int):
        assert num_chunks >= 1
        self.num_chunks = num_chunks
        self.num_pub_inputs = 8 * num_chunks + 8

    def periodic_columns(self, n: int):
        # FULL-LENGTH columns (period = n): only the first `num_chunks`
        # periods run permutations/absorbs; the tail periods have all
        # selectors 0, so sel_none forces plain copies — this lets a
        # k-chunk sponge live in a power-of-two trace with k arbitrary
        base, sel_absorb = tile_periodic_columns(n, self.num_chunks)
        return base + [sel_absorb]

    def constraints(self, local, nxt, periodic, ops):
        state = local[:16]
        nxt_state = nxt[:16]
        msg = local[16:24]
        sel_absorb = periodic[-1]
        inner = Poseidon2Air.constraints(self, state, nxt_state,
                                         periodic[:-1], ops)
        # absorb step: nxt = M_E(state + [msg, 0^8])
        absorbed = [ops.add(state[j], msg[j]) if j < 8 else state[j]
                    for j in range(16)]
        mixed = _external_linear_generic(absorbed, ops)
        return splice_handoff(inner, state, nxt_state, mixed, sel_absorb,
                              ops)

    def boundaries(self, pub_inputs, n: int):
        k = self.num_chunks
        assert n >= PERIOD * k and (n & (n - 1)) == 0
        chunks = [[int(v) % bb.P for v in pub_inputs[8 * j:8 * j + 8]]
                  for j in range(k)]
        digest = [int(v) % bb.P for v in pub_inputs[8 * k:8 * k + 8]]
        # row 0 = M_E(first absorbed state)
        state0 = chunks[0] + [0] * 8
        row0 = p2._external_linear_ref(state0)
        out = [(0, j, row0[j]) for j in range(16)]
        # message columns bound at each later absorb row
        for j in range(1, k):
            absorb_row = PERIOD * j - 1
            out += [(absorb_row, 16 + i, chunks[j][i]) for i in range(8)]
        # digest = rate of the final permutation output (last period row 21)
        final_out_row = PERIOD * (k - 1) + ROUNDS
        out += [(final_out_row, i, digest[i]) for i in range(8)]
        return out


def pad_message_limbs(message_limbs) -> list[int]:
    """Canonical limbs zero-padded to a multiple of the rate (8) — the ONE
    place the sponge padding rule lives (trace, public inputs, and the
    prover backend all share it)."""
    limbs = [int(v) % bb.P for v in message_limbs]
    return limbs + [0] * ((-len(limbs)) % 8)


def generate_sponge_trace(message_limbs: list[int]) -> np.ndarray:
    """Sponge rows for hash_leaves(message_limbs); pads limbs to chunks of
    8 and the trace to a power-of-two number of 32-row periods (the tail
    periods are inert copies of the final state)."""
    limbs = pad_message_limbs(message_limbs)
    chunks = [limbs[i:i + 8] for i in range(0, len(limbs), 8)]
    k = len(chunks)
    periods = 1 << (k - 1).bit_length() if k > 1 else 1
    trace = np.zeros((PERIOD * periods, 24), dtype=np.uint32)
    state = [0] * 16
    for j, chunk in enumerate(chunks):
        state = [(state[i] + chunk[i]) % bb.P if i < 8 else state[i]
                 for i in range(16)]
        # the permutation rows (reusing the single-perm generator)
        perm_rows = generate_trace(state)
        base = PERIOD * j
        trace[base:base + PERIOD, :16] = perm_rows
        if j + 1 < len(chunks):
            trace[base + PERIOD - 1, 16:24] = chunks[j + 1]
        state = [int(v) for v in perm_rows[ROUNDS]]
    # inert tail: plain copies of the final state
    trace[PERIOD * k:, :16] = trace[PERIOD * k - 1, :16]
    return trace


def sponge_public_inputs(message_limbs: list[int]) -> list[int]:
    from ..ops.merkle import hash_leaf_ref

    limbs = pad_message_limbs(message_limbs)
    return limbs + hash_leaf_ref(limbs)


# ---------------------------------------------------------------------------
# Round states of many permutations at once (the vectorised trace
# generators of models/fri_verifier_air.py and models/transfer_air.py)
# ---------------------------------------------------------------------------

_P = bb.P
_EXT_RC_INT = [[int(c) for c in row] for row in p2.EXT_RC]
_INT_RC_INT = [int(c) for c in p2.INT_RC]
_MU_INT = [int(m) for m in p2.DIAG_MU]


def perm_rows_py(state) -> list:
    """The 22 round states of Poseidon2 on canonical ints (rows 0..21 of
    poseidon2_air.generate_trace); row 21 is the permutation's output."""
    s = p2._ext_linear_int([int(v) for v in state])
    rows = [s]
    for r in range(p2._HALF_F):
        s = p2._ext_linear_int(p2._full_round_int(s, _EXT_RC_INT[r]))
        rows.append(s)
    for r in range(p2.ROUNDS_P):
        s = p2._partial_round_int(list(s), _INT_RC_INT[r])
        rows.append(s)
    for r in range(p2._HALF_F, p2.ROUNDS_F):
        s = p2._ext_linear_int(p2._full_round_int(s, _EXT_RC_INT[r]))
        rows.append(s)
    return rows


def _m4_np(x0, x1, x2, x3):
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = 2 * x1 + t1
    t3 = 2 * x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    return [t3 + t5, t5, t2 + t4, t4]


def _ext_linear_np(s: np.ndarray) -> np.ndarray:
    blocks = [_m4_np(*(s[:, i + j] for j in range(4))) for i in range(0, 16, 4)]
    sums = [blocks[0][j] + blocks[1][j] + blocks[2][j] + blocks[3][j]
            for j in range(4)]
    return np.stack([(b[j] + sums[j]) % _P for b in blocks for j in range(4)],
                    axis=1)


def _sbox_np(x: np.ndarray) -> np.ndarray:
    x2 = x * x % _P
    x4 = x2 * x2 % _P
    return x4 * x2 % _P * x % _P


_EXT_RC_NP = np.asarray(p2.EXT_RC, dtype=np.uint64)
_MU_NP = np.asarray(p2.DIAG_MU, dtype=np.uint64)


def perm_rows_np(states: np.ndarray) -> np.ndarray:
    """Batched `perm_rows_py`: (B, 16) canonical -> (B, 22, 16) uint64."""
    s = _ext_linear_np(states.astype(np.uint64))
    rows = [s]
    for r in range(p2._HALF_F):
        s = _ext_linear_np(_sbox_np((s + _EXT_RC_NP[r]) % _P))
        rows.append(s)
    for r in range(p2.ROUNDS_P):
        s = s.copy()
        s[:, 0] = _sbox_np((s[:, 0] + np.uint64(_INT_RC_INT[r])) % _P)
        tot = s.sum(axis=1, keepdims=True)
        s = (tot + _MU_NP * s) % _P
        rows.append(s)
    for r in range(p2._HALF_F, p2.ROUNDS_F):
        s = _ext_linear_np(_sbox_np((s + _EXT_RC_NP[r]) % _P))
        rows.append(s)
    return np.stack(rows, axis=1)


def pad_rows(rows: np.ndarray) -> np.ndarray:
    """(..., 22, 16) round states -> (..., 32, 16): rows 22..31 repeat the
    output row, as poseidon2_air.generate_trace pads a period."""
    tail = np.repeat(rows[..., ROUNDS:ROUNDS + 1, :], PERIOD - ROUNDS - 1,
                     axis=-2)
    return np.concatenate([rows, tail], axis=-2)
