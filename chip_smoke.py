"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases:
  1. the card's name and power limit (nvidia-smi); the Groth16 wrap's key
     setup (host bignum work, minutes) starts in a child process and runs
     beside every later phase;
  2. build the CUDA kernels K1-K11 and slice 4's four (ext_inv,
     ext_batch_inv, eval_poly_at, to_mont_cols) from ethrex_tpu_torch/csrc
     and the generated AIR constraint kernels (K6) of the path's six AIRs
     in both modes (the fused alpha combination and the test-only
     constraint block), one nvcc per source, all started together;
  3. hold every kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it (bit-equal; K5 in phase 8), and
     time both with
     CUDA events, beside each kernel's bound: K1 (the coset LDE) and K2
     (the leaf hash and the Merkle tree above it) at every distinct shape
     of the paths (the executed state 115 x 2^21, TransferAir 278 x 2^20,
     outer 90 x 2^22, blowup 8; and the full-size synthesized batch's
     state 115 x 2^19, where the rows are timed and the plain versions fit
     whole; beyond it the plain versions on the first and the last 8
     rows or 2^20 leaves); K3 at every shape of the
     path (each STARK's deep phase at m = 8, its open phase's split-k at
     m = 8, the fused step's two; the plain version on the first and the
     last 2^20 rows of the deep shapes beyond the state's); K4 at the
     2^19 state proof's shape; K6's alpha combination once per AIR at its
     full LDE (the plain version of the four largest on the first and the
     last 2^20 or 2^22 points), and its constraint block at 2^16 points;
     K7 on
     the outer divisor stack, and its divisor entry on the outer proof's
     domain (2^25 points, 11 constants); K8, K9 and K11 at both state
     shapes and the outer proof's (K11 as the open phase calls it: both
     points' tables and the chunks at zeta in one launch; also its
     single-point table at the fused step's 2^20); K10 on the fused
     step's FRI layer trees at log_n 20 and 15 (K8, K10 and K11 timed as
     device time from torch.profiler, the call beside it, with their
     ptxas registers and spills); the ext
     inverses on 2^20 elements, eval_poly_at on 64 x 2^16 and
     to_mont_cols on the TransferAir trace (2^20 x 278);
  4. the main path, with the launch counts zeroed just before and read
     just after (K6's combine kernels once per constraint group of each
     STARK, its block form never): a minimal proof coordinator started
     here on 127.0.0.1 (the port's wire framing, the reference's bytes)
     hands the committed BASELINE-3 ProgramInput (ethrex_tpu_torch/
     fixtures: 1,000 transactions over 4 blocks, 500 ETH transfers and
     500 token calls, with their witness) at groth16 to the port's
     `prover.client.ProverClient(backend, [(host, port)]).poll_once()`
     (its pre-warm done, heartbeats on, ETHREX_PROOF_CKPT_OFF=1), which
     proves it through `GpuBackend(device=dev).prove` and submits it; the
     coordinator checks `verify_submission` and `check_coverage` against
     the committer's `expected_vm_mode` (mode `token`, classified in a
     child) before its ACK, and the round's wall is logged beside the
     prove's.  The prove: stateless execution of the blocks, `build_vm_batch` (token mode:
     2,000 transfer and 500 token segments), the access records (3,504
     writes, depth 6), the state proof, TransferAir, TokenAir, the
     binding proof, the aggregation of the four into one outer
     FriVerifyAir STARK and the Groth16 wrap of its digest (BN254 MSMs,
     K5), with the host walls of each step and the peak device memory;
     the submitted proof's output, write-log and VM-meta digests, the
     tree shape, the mode and the segment counts are held to the
     reference's (`baseline3_expected.json`); in a child process, beside
     the later phases, `GpuBackend(device="cpu").verify_with_input`
     accepts that proof and rejects it with one output byte flipped and
     with its `vm` metadata removed, with its walls.  Then the
     synthesized VM-mode batch,
     the only path with a generic call, its counts zeroed just before
     and read just after: `prover.gpu_backend.prove_vm_stages(...,
     "groth16")` on BASELINE-3's stream cut to 32 rounds a block (512
     transfer and 128 token segments), a state tree of 256 keys and 255
     writes and one generic call of 1,996 steps (BytecodeAir, 2^19 x
     354), with its binding proof, aggregate and wrap;
  5. the second entry point, `parallel.core.build_prove_step` (the fused
     prove step), at log_n 15 and 20 with width 64, its counts zeroed
     just before each run and read just after; at log_n 15 it equals the
     same step run with the plain versions on the CPU (it needs no wrap
     keys, so it runs before phase 4, while the keys' setup finishes);
  6. checks, for each of the two VM-mode paths, in a child process that
     runs beside the later phases (host Python only; the run waits for
     both before its result): the port's verifier accepts every inner
     proof and rejects a tampered public input of each but the binding
     proof; `verify_aggregated` accepts the aggregate and rejects a
     tampered inner FRI value; `wrap_verify` accepts the wrap and rejects
     a wrong digest.  Right after the executed path, every STARK of it is
     proved again from its trace under torch.profiler,
     its cached tables dropped first so that `tables` runs its device
     work again: per phase the wall, the device time by kernel and the
     device's idle share, and per kernel its device time over the path's
     STARKs; K3 and K6 by phase, K7 and PyTorch's own kernels in
     `tables`, and each STARK's peak device memory (the running peak at
     each phase's end shows the phase that sets it);
  7. the earlier slice's path, its counts zeroed just before and read
     just after: a state proof (cut to 126 keys and 127 writes: n = 2^16
     x 115) and a 512-limb binding proof (64 chunks), then
     `prover.gpu_backend.prove_formats(..., "groth16")` over the two, with
     the checks of phase 6 (in a child process too);
  8. the drills: `runtime_errors.memory_gate` fed a free size below a
     STARK's estimate refuses it (`classify` gives "oom") before any
     kernel launches; the committed mixed batch at `stark`, under a
     batch context with a temporary ETHREX_PROOF_CKPT_DIR, killed by the
     `backend.phase` drop fault at each phase boundary in turn and
     resumed by the next prove, ends in a proof equal to the
     uninterrupted one (the resumed phases and the envelope bytes
     logged).  Then the executed path's wrap proved once more (`wrap_prove` of its
     digest)
     with host timers on its parts (witness, `is_satisfied`, `_h_coeffs`,
     point and scalar conversion, MSM calls, host curve arithmetic), CUDA
     events on K5 and torch.profiler's device time per K5 function; K5
     against its plain version on all four of the wrap's MSMs (a_query,
     b1_query, k_query + h_query on G1, b2_query on G2), held equal as
     group elements, each timed beside two bounds (the bucket method's
     and the double-and-add's), with K5's registers and spills from this
     run's ptxas report; a small state proof made on the card equals the
     same proof made by the plain versions on the CPU;
  9. a line with each kernel's time before its current design (from
     PERF.md; not measured here), one JSON line with every kernel's
     launches (per path), error, times, bound and device time on the path,
     then
     {"ok": true, "device": {...}} as the last line.

Any failure raises, so the exit code is not 0 and no result line prints.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# IMAD issue slots per second: 132 SMs x 64 lanes x 1.98 GHz, half the
# card's FP32 FMA lane rate (67 TFLOP/s / 2 / 2)
IMAD_SLOTS_PER_S = 132 * 64 * 1.98e9
# IMAD slots per Montgomery product (bb::mul in csrc/babybear.cuh).  Its
# SASS holds three multiplies, IMAD.WIDE.U32 (a*b), IMAD (lo*NP) and
# IMAD.HI.U32 (umulhi(m, p)), and the wide and high forms issue at half
# the IMAD rate, so two slots each: 1 + 2 + 2.  Both counts come from
# ethrex_tpu_torch/tools/int_mul_rate.py (H100 SXM: 63.4 IMAD, 31.7
# IMAD.HI.U32 and 24.2 IMAD.WIDE.U32 per SM per clock).
SLOTS_PER_MONT = 5
# IMAD slots per raw product summed lazily (bb::mad, with a bb::fold every
# fourth term), as K3 and K6's alpha combination add them: its SASS holds
# 1.125 IMAD.WIDE.U32 and 0.0625 IMAD a product
# (ethrex_tpu_torch/tools/int_mul_rate.py, `sass_multiplies_per_raw`),
# priced as SLOTS_PER_MONT prices them (two slots a wide form)
SLOTS_PER_RAW = 2 * 1.125 + 0.0625
# IMAD slots per reduction of a lazy sum (bb::redc): a Montgomery product
# without its wide multiply, IMAD (lo*NP) and IMAD.HI.U32
SLOTS_PER_REDC = SLOTS_PER_MONT - 2
# IMAD slots per BN254 Montgomery product (csrc/bn254_msm.cu `mul`): 8 x 8
# wide a_i*b_j and 8 x 8 wide m*p_j (IMAD.WIDE.U32, 2 slots each) plus 8
# low products m = t0 * NP (IMAD, 1 slot); an Fp2 product is 3 of them
SLOTS_PER_BN254_MUL = 2 * 128 + 8
# products of a Jacobian doubling, addition and mixed addition
# (csrc/bn254.cuh `pdbl`, `padd`, `madd`)
BN254_DBL_MULS = 7
BN254_ADD_MULS = 16
BN254_MADD_MULS = 11
# device launches of one K5 call (csrc/bn254_msm.cu `run_msm`) and its
# device functions, each a template over Fp (G1) and Fp2 (G2)
K5_FUNCTIONS = ("k_digits", "k_scan", "k_scatter", "k_bucket_acc",
                "k_window_sum", "k_combine")
K5_BASES_FUNCTIONS = ("k_shift", "k_affine")
# each kernel's time at its timed shape before its current design
# (PERF.md's kernel table, in braces; NVIDIA H100 80GB HBM3 at 700 W):
# not measured by this run, so logged on a line of its own.
# K1 the state LDE, K2 the state leaves and one tree level (2^22 -> 2^21),
# K7 the outer divisor stack and K8, K9, K11 the outer shape (K7 and K8
# the call, by an earlier smoke; K11 the earlier design's device time,
# three launches, by tools/k10_k11.py), K10 the fused step's layers at
# log_n 20 (device time, tools/k10_k11.py); K3 the state
# deep phase's two m = 4 calls, and the fused K6 TransferAir's block
# (38.613 ms) plus K3's read of it (31.566 ms), both by the kernels
# before their current design; K5 the double-and-add kernel that the
# bucket MSM replaced, at 6,990 G1 points and 2,897 G2 points
EARLIER_MS = {"ntt": 15.396, "poseidon2_hash_leaves": 32.044,
              "poseidon2_compress_level": 1.065, "mod_matmul": 4.062,
              "fri_fold": 0.073, "air_combine": 70.179,
              "batch_inv": 2.830, "bn254_msm_g1": 12.308,
              "bn254_msm_g2": 40.577, "deep_compose": 5.604,
              "quotient_combine": 1.567, "merkle_batched_level": 1.683,
              "ext_poly_eval": 0.814}
# kernels the groth16 paths need not launch: the reference's test-only
# helpers (no path of the system runs them) and the fused step's own
NOT_ON_GROTH16_PATHS = ("ext_inv", "ext_batch_inv", "eval_poly_at",
                        "merkle_batched_level", "air_constraints")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, products: float,
             slots_per_product: float = SLOTS_PER_MONT) -> tuple[float, str]:
    """Least time for `nbytes` of traffic and `products` Montgomery
    products (or other work at `slots_per_product` IMAD slots each): the
    larger of the two."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = products * slots_per_product / IMAD_SLOTS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Median of `reps` timed calls (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def field(rng, shape, dev):
    from ethrex_tpu_torch.ops import babybear as bb

    return bb.from_numpy(
        rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32),
        dev)


def field_dev(rng, shape, dev):
    """Random field elements made on the card (a torch generator seeded
    from `rng`): the full-size inputs are gigabytes, too slow to draw on
    the host."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    return torch.randint(0, 2013265921, shape, generator=gen,
                         dtype=torch.int32, device=dev)


def compare(name, kern, plain, kernel_reps=5, plain_reps=3):
    """Run the kernel and its plain version once, require bit-equality,
    then time both (median of reps after a warm-up)."""
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version")
    del got, want           # bit-equal: the max |diff| is 0
    return 0, cuda_ms(kern, kernel_reps), cuda_ms(plain, plain_reps)


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

# (tag, trace width, log n) of every STARK of the path whose LDE and tree
# are the largest: the state proof, TransferAir and the outer FriVerifyAir
# (blowup 8: N = 8n)
# "state" is the full-size synthesized batch's state proof, the shape
# every kernel row is timed at (the plain versions fit whole there);
# "executed state" the executed BASELINE-3 batch's (3,504 writes)
PATH_SHAPES = (("state", 115, 19), ("executed state", 115, 21),
               ("transfer", 278, 20), ("outer", 90, 22))
# rows (of the LDE) and leaves the plain versions are held on beyond the
# state shape, where the plain versions would not fit in time
PLAIN_ROWS = 8
PLAIN_LEAVES = 1 << 20


def ntt_bound(w: int, n: int, N: int) -> tuple[float, str]:
    """The coset LDE (w, n) -> (w, N) as the prover runs it: the input
    read once and the output written once; the iNTT's butterflies, the
    pre-scale, and the forward transform's butterflies after its first
    log2(N / n) stages, which only copy (each nonzero input's partner is
    a zero of the pad)."""
    log_n = n.bit_length() - 1
    io_bytes = 4 * (w * n + w * N)
    muls = w * ((n // 2) * log_n + n + (N // 2) * log_n)
    return bound_ms(io_bytes, muls)


def check_ntt_shapes(dev, rng) -> dict:
    """K1: the coset LDE at every distinct shape of the path, timed at the
    full size and held bit-equal to the plain version (on the first and
    the last PLAIN_ROWS rows beyond the state shape: in the TransferAir
    LDE, rows from 256 on start past 2^31 words)."""
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.ops import ntt

    shapes = []
    for tag, w, log_n in PATH_SHAPES:
        n = 1 << log_n
        N = n << 3
        x = field_dev(rng, (w, n), dev)
        pre = ntt.lde_prescale(log_n, bb.GENERATOR, dev)

        def kern():
            return ntt.scaled_ntt(ntt.scaled_ntt(x, inverse=True), n_out=N,
                                  pre=pre)

        r = w if tag == "state" else PLAIN_ROWS

        def plain(rows=slice(0, r)):
            return ntt.scaled_ntt_plain(ntt.scaled_ntt_plain(
                x[rows], inverse=True), n_out=N, pre=pre)

        got = kern()
        held = [slice(0, r)] if r == w else [slice(0, r), slice(w - r, w)]
        for rows in held:
            if not torch.equal(got[rows], plain(rows)):
                raise AssertionError(
                    f"ntt ({tag} LDE {w} x 2^{log_n}, rows {rows.start}-"
                    f"{rows.stop - 1}): kernel differs from its plain "
                    f"version")
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(kern, 5)
        pms = cuda_ms(plain, 1) if tag == "state" else None
        b_ms, b_by = ntt_bound(w, n, N)
        shapes.append(dict(
            tag=tag, shape=f"coset LDE ({w}, 2^{log_n}) -> ({w}, "
            f"2^{log_n + 3})", passes=len(ntt.ntt_plan(log_n))
            + len(ntt.ntt_plan(log_n + 3)), ms=ms, bound_ms=b_ms,
            bound_by=b_by, plain_ms=pms,
            plain_rows=[[h.start, h.stop] for h in held]))
        log(f"[kernels] ntt {tag}: {shapes[-1]}")
        del x
        torch.cuda.empty_cache()
    st = shapes[0]
    return dict(max_abs_err=0, ms=st["ms"], plain_ms=st["plain_ms"],
                bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                shape=st["shape"], at_shapes=shapes)


def tree_bound(m: int) -> tuple[float, str]:
    """Every level above m leaf digests: m - 1 compressions (772
    products each), the leaves read once and every level written once."""
    return bound_ms(4 * 8 * (m + m - 1), (m - 1) * 772)


def check_merkle_shapes(dev, rng) -> dict:
    """K2 at every distinct shape of the path: the leaf hash of the LDE
    rows (read in place from the (w, N) columns) and the tree above the
    N leaf digests, timed at the full size and held bit-equal to the
    plain versions (the leaves on the first and the last PLAIN_LEAVES
    rows beyond the state shape; the tree whole)."""
    from ethrex_tpu_torch.ops import merkle
    from ethrex_tpu_torch.ops import poseidon2 as p2

    leaves_rows, tree_rows = [], []
    for tag, w, log_n in PATH_SHAPES:
        N = 1 << (log_n + 3)
        lde = field_dev(rng, (w, N), dev)
        M = N if tag == "state" else PLAIN_LEAVES
        held = [slice(0, M)] if M == N else [slice(0, M), slice(N - M, N)]
        got = p2.hash_leaves(lde.T)
        for rows in held:
            if not torch.equal(got[rows], p2.hash_leaves_plain(lde.T[rows])):
                raise AssertionError(
                    f"poseidon2_hash_leaves ({tag}, {N} x {w}, leaves "
                    f"{rows.start}-{rows.stop - 1}): kernel differs from "
                    f"its plain version")
        ms = cuda_ms(lambda: p2.hash_leaves(lde.T), 5)
        pms = cuda_ms(lambda: p2.hash_leaves_plain(lde.T), 1) \
            if tag == "state" else None
        perms = N * (-(-w // 8))
        b_ms, b_by = bound_ms(4 * (w * N + 8 * N), perms * 772)
        leaves_rows.append(dict(
            tag=tag, shape=f"leaves ({N}, {w})", ms=ms, bound_ms=b_ms,
            bound_by=b_by, plain_ms=pms,
            plain_rows=[[h.start, h.stop] for h in held]))
        log(f"[kernels] poseidon2_hash_leaves {tag}: {leaves_rows[-1]}")
        del lde
        torch.cuda.empty_cache()
        # the tree above the digests: one (2N - 1, 8) level buffer
        buf = torch.empty((2 * N - 1, 8), dtype=torch.int32, device=dev)
        buf[:N] = got
        del got
        levels = merkle.levels_above(buf, N)
        want = [levels[0]]
        while want[-1].shape[0] > 1:
            want.append(p2.compress_level_plain(want[-1]))
        if len(want) != len(levels) or not all(
                torch.equal(a, b) for a, b in zip(levels, want)):
            raise AssertionError(f"poseidon2_merkle_subtree ({tag}, {N} "
                                 f"leaves): kernel differs from its plain "
                                 f"version")
        del want
        ms = cuda_ms(lambda: merkle.levels_above(buf, N), 5)
        pms = None
        one = None
        if tag == "state":
            def plain_tree():
                lv = levels[0]
                while lv.shape[0] > 1:
                    lv = p2.compress_level_plain(lv)
            pms = cuda_ms(plain_tree, 1)
            # one level alone (a one-level subtree launch), the work the
            # earlier per-level kernel was timed on
            one = cuda_ms(lambda: p2.compress_level(levels[0]), 5)
        b_ms, b_by = tree_bound(N)
        tree_rows.append(dict(
            tag=tag, shape=f"tree over {N} leaves", ms=ms, bound_ms=b_ms,
            bound_by=b_by, plain_ms=pms,
            launches=len(merkle.subtree_plan(N)), one_level_ms=one))
        log(f"[kernels] poseidon2_merkle_subtree {tag}: {tree_rows[-1]}")
        del buf, levels
        torch.cuda.empty_cache()
    out = {}
    for name, rs in (("poseidon2_hash_leaves", leaves_rows),
                     ("poseidon2_merkle_subtree", tree_rows)):
        st = rs[0]
        out[name] = dict(max_abs_err=0, ms=st["ms"], plain_ms=st["plain_ms"],
                         bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                         shape=st["shape"], at_shapes=rs)
    return out


# every STARK of the path whose K3 shapes are large: (tag, trace width,
# log n); blowup 8
K3_SHAPES = (("state", 115, 19), ("executed state", 115, 21),
             ("transfer", 278, 20), ("token", 117, 18),
             ("bytecode", 354, 19), ("outer", 90, 22))


def k3_bound(n: int, k: int, m: int) -> tuple[float, str]:
    """(n, k) @ (k, m): a and b read once, the result written once; n k m
    raw products summed lazily."""
    return bound_ms(4 * (n * k + k * m + n * m), n * k * m, SLOTS_PER_RAW)


def check_k3_shapes(dev, rng) -> dict:
    """K3 at every shape of the path, bit-equal to its plain version and
    timed: the deep phase's LDE rows (N, w), read in place from the (w,
    N) columns, at both openings' gamma powers (m = 8; the plain version
    on the first and the last PLAIN_LEAVES rows beyond the state shape);
    the open phase's trace coefficients (w, n) at both points' power
    tables (m = 8, split-k); the fused step's comb (N, 64) @ (64, 4) and
    its trace at zeta (64, n) @ (n, 4) at log_n 15 and 20.  The row keeps
    the state deep shape; the canonical mode is checked at small shapes."""
    from ethrex_tpu_torch.ops import babybear as bb

    shapes = []

    def held(tag, phase, a, b, rows_held):
        got = bb.mod_matmul(a, b)
        for sl in rows_held:
            if not torch.equal(got[sl], bb.mod_matmul_plain(a[sl], b)):
                raise AssertionError(
                    f"mod_matmul {tag} {phase} {tuple(a.shape)} @ "
                    f"{tuple(b.shape)}, rows {sl.start}-{sl.stop - 1}: "
                    f"kernel differs from its plain version")
        del got
        n, k = a.shape
        m = b.shape[1]
        ms = cuda_ms(lambda: bb.mod_matmul(a, b), 5)
        sl = rows_held[0]
        pms = cuda_ms(lambda: bb.mod_matmul_plain(a[sl], b), 1)
        b_ms, b_by = k3_bound(n, k, m)
        shapes.append(dict(
            tag=tag, phase=phase, shape=f"({n}, {k}) @ ({k}, {m})", ms=ms,
            plain_ms=pms, plain_rows=[[h.start, h.stop] for h in rows_held],
            bound_ms=b_ms, bound_by=b_by,
            kernel="k_rows" if n > bb._SPLITK_MAX_ROWS
            or k <= bb._SPLITK_CHUNK else "k_splitk"))
        log(f"[kernels] mod_matmul {tag} {phase}: {shapes[-1]}")

    for tag, w, log_n in K3_SHAPES:
        n, N = 1 << log_n, 1 << (log_n + 3)
        lde = field_dev(rng, (w, N), dev)
        M = N if tag == "state" else PLAIN_LEAVES
        held(tag, "deep", lde.T, field_dev(rng, (w, 8), dev),
             [slice(0, M)] if M == N else [slice(0, M), slice(N - M, N)])
        del lde
        torch.cuda.empty_cache()
        coeffs = field_dev(rng, (w, n), dev)
        held(tag, "open", coeffs, field_dev(rng, (n, 8), dev),
             [slice(0, w)])
        del coeffs
        torch.cuda.empty_cache()
    for log_n in (15, 20):
        n, N = 1 << log_n, 1 << (log_n + 2)
        lde = field_dev(rng, (64, N), dev)
        held(f"fused{log_n}", "comb", lde.T, field_dev(rng, (64, 4), dev),
             [slice(0, N)])
        del lde
        held(f"fused{log_n}", "trace at zeta", field_dev(rng, (64, n), dev),
             field_dev(rng, (n, 4), dev), [slice(0, 64)])
        torch.cuda.empty_cache()
    for a_shape, k, m in (((4096, 128), 128, 8), ((64, 8192), 8192, 8),
                          ((33, 115), 115, 4), ((7, 70000), 70000, 3)):
        a = field(rng, a_shape, dev)
        b = field(rng, (k, m), dev)
        for mont in (True, False):
            if not torch.equal(bb.mod_matmul(a, b, mont),
                               bb.mod_matmul_plain(a, b, mont)):
                raise AssertionError(f"mod_matmul {a_shape} @ ({k}, {m}) "
                                     f"montgomery={mont}: kernel differs")
        del a, b
    st = shapes[0]
    return dict(max_abs_err=0, ms=st["ms"], plain_ms=st["plain_ms"],
                bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                shape=f"deep, state: {st['shape']}", at_shapes=shapes)


def check_kernels(dev, rng) -> dict:
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.ops import fri
    from ethrex_tpu_torch.ops import ntt
    from ethrex_tpu_torch.ops import poseidon2 as p2

    n, w, lb = 1 << 19, 115, 3
    N = n << lb
    rows = {"ntt": check_ntt_shapes(dev, rng)}
    for shape, kw in (((4, N), dict(inverse=True)),
                      ((8, 4, n), dict(n_out=N)),
                      ((4, 16), dict(inverse=True))):
        y = field(rng, shape, dev)
        post = field(rng, (1,), dev) if kw.get("inverse") else None
        got = ntt.scaled_ntt(y, post=post, **kw)
        want = ntt.scaled_ntt_plain(y, post=post, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"ntt {shape} {kw}: kernel differs")
        del y, got, want
    log(f"[kernels] ntt ok: {rows['ntt']}")
    rows.update(check_merkle_shapes(dev, rng))
    cw = field(rng, (1 << 20, 4), dev)   # an FRI layer, paired in place
    if not torch.equal(p2.hash_leaves(fri.pair_leaves(cw)),
                       p2.hash_leaves_plain(fri.pair_leaves(cw))):
        raise AssertionError("hash_leaves on paired FRI leaves differs")
    del cw

    rows["mod_matmul"] = check_k3_shapes(dev, rng)

    # K4: the first FRI fold (2^22, 4) -> (2^21, 4)
    cw = field(rng, (N, 4), dev)
    beta = field(rng, (4,), dev)
    inv_pts = bb.from_numpy(fri._fold_inv_points_np(22, 31), dev)
    inv2 = bb.from_numpy(bb.to_mont_host(np.array([fri._INV2])), dev)
    err, ms, pms = compare(
        "fri_fold (2^22 -> 2^21)",
        lambda: fri.fold(cw, beta, inv_pts, inv2),
        lambda: fri.fold_plain(cw, beta, inv_pts, inv2))
    b_ms, b_by = bound_ms(4 * (N * 4 + N // 2 + 4 + 1 + N // 2 * 4),
                          (N // 2) * 28)
    rows["fri_fold"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=b_ms, bound_by=b_by,
                            shape="first FRI fold (2^22, 4) -> (2^21, 4)")
    del cw
    log(f"[kernels] fri_fold ok: {rows['fri_fold']}")
    torch.cuda.empty_cache()
    return rows


BINDING_CHUNKS = 10     # the VM-mode binding message: 74 limbs -> 80


def path_airs():
    """The AIRs of the main path at their full size, with the number of
    points the plain K6 version is held on at the head and at the tail of
    the full domain (None: the whole domain): the state proof's
    StateUpdateAir (depth 10, 16-period segments), the VM batch's
    TransferAir (2,048 segments), TokenAir (512) and BytecodeAir (2,048
    steps), the VM-mode binding proof's Poseidon2SpongeAir (10 chunks) and
    the outer FriVerifyAir over all five (the deepest FRI layer-0 path,
    TransferAir's, has depth 22, so 32-period segments).  The plain
    interpreter of TransferAir, BytecodeAir and the outer AIR does not fit
    beside the full LDE, so those are held on 2^20 (2^22) points at each
    end."""
    from ethrex_tpu_torch.models import bytecode_air as bca
    from ethrex_tpu_torch.models import fri_verifier_air as fva
    from ethrex_tpu_torch.models import poseidon2_air as pair
    from ethrex_tpu_torch.models import state_update_air as sua
    from ethrex_tpu_torch.models import token_air as tka
    from ethrex_tpu_torch.models import transfer_air as ta

    return {"StateUpdateAir": (sua.StateUpdateAir(10, seg_periods=16),
                               1 << 19, None),
            "StateUpdateAir executed": (sua.StateUpdateAir(6, seg_periods=16),
                                        1 << 21, 1 << 20),
            "TransferAir": (ta.TransferAir(), 1 << 20, 1 << 20),
            "TokenAir": (tka.TokenAir(), 1 << 18, None),
            "BytecodeAir": (bca.BytecodeAir(), 1 << 19, 1 << 20),
            "Poseidon2SpongeAir": (pair.Poseidon2SpongeAir(BINDING_CHUNKS),
                                   1 << 8, None),
            "FriVerifyAir": (fva.FriVerifyAir(22), 1 << 22, 1 << 22)}


def drill_airs():
    """AIRs of shapes that `path_airs` does not have: the committed mixed
    batch's StateUpdateAir (depth 3, 8-period segments), which the resume
    drill proves, and the binding proof of 13 chunks that both the drill
    and the executed path prove."""
    from ethrex_tpu_torch.models import poseidon2_air as pair
    from ethrex_tpu_torch.models import state_update_air as sua

    return (sua.StateUpdateAir(3, seg_periods=8),
            pair.Poseidon2SpongeAir(13))


def combine_plain_window(air, lde, per, B, apow, lo: int, hi: int):
    """`air_codegen.combine_plain` on the points [lo, hi) of the full
    domain: the local rows there and the next rows at (i + B) mod N."""
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.stark.air import DeviceOps

    N = lde.shape[1]
    nxt = (torch.arange(lo, hi, device=lde.device) + B) % N
    cons = air.constraints(list(lde[:, lo:hi].unbind(0)),
                           list(lde[:, nxt].unbind(0)),
                           list(per[:, lo:hi].unbind(0)),
                           DeviceOps(lde.device))
    block = torch.stack([c.expand(hi - lo) for c in cons])
    del cons
    return bb.mod_matmul_plain(block.T, apow[:air.num_constraints])


def group_muls(graph, max_nodes=None) -> int:
    """Montgomery products a point costs across the AIR's kernels (a node
    needed by two groups is computed in both): the graph's own products
    plus what the split into kernels recomputes."""
    from ethrex_tpu_torch.stark import air_codegen

    parts = air_codegen.groups(graph, max_nodes or
                               air_codegen.MAX_NODES_PER_KERNEL)
    return sum(1 for g in parts for i in graph.reachable(g)
               if graph.nodes[i][0] == air_codegen.MUL)


# points the test-only evaluate form is held and timed on
EVALUATE_POINTS = 1 << 16


def check_air_kernels(dev, rng) -> dict:
    """K6 for each AIR of the path at its LDE size (blowup 8).  Combine
    mode (the path's): timed at the full size and held bit-equal to the
    plain version (the DeviceOps evaluation, then K3's plain version) on
    the whole domain or on its first and last `plain_points` points.
    Evaluate mode (test-only: the constraint block): held bit-equal to
    its plain version and timed on a domain of EVALUATE_POINTS points."""
    from ethrex_tpu_torch.stark import air_codegen

    per_air, per_air_eval = [], []
    for name, (air, n, plain_points) in path_airs().items():
        N = n << 3
        graph = air_codegen.record(air)
        K = graph.num_constraints
        counts = graph.counts()
        nk = len(air_codegen.groups(graph))
        # evaluate mode, reduced
        M = min(N, EVALUATE_POINTS)
        lde = field_dev(rng, (air.width, M), dev)
        per = field_dev(rng, (air.num_periodic, M), dev)
        err, ms, pms = compare(
            f"air_constraints {name} ({air.width} x {M})",
            lambda: air_codegen.evaluate(air, lde, per, 8),
            lambda: air_codegen.evaluate_plain(air, lde, per, 8),
            kernel_reps=3, plain_reps=1)
        b_ms, b_by = bound_ms(4 * (air.width + air.num_periodic + K) * M,
                              counts["mul"] * M)
        per_air_eval.append(dict(
            air=name, shape=f"({air.width}, {M}) -> ({K}, {M})", kernels=nk,
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by))
        log(f"[kernels] air_constraints {name} ok: {per_air_eval[-1]}")
        del lde, per
        # combine mode at the full size
        lde = field_dev(rng, (air.width, N), dev)
        per = field_dev(rng, (air.num_periodic, N), dev)
        apow = field_dev(rng, (K, 4), dev)
        got = air_codegen.combine(air, lde, per, 8, apow)
        M = plain_points or N
        windows = [(0, M)] if M == N else [(0, M), (N - M, N)]
        for lo, hi in windows:
            if not torch.equal(got[lo:hi], combine_plain_window(
                    air, lde, per, 8, apow, lo, hi)):
                raise AssertionError(f"air_combine {name} (N = {N}, points "
                                     f"{lo}-{hi - 1}): kernel differs from "
                                     f"its plain version")
        del got
        torch.cuda.empty_cache()
        pms = cuda_ms(lambda: combine_plain_window(air, lde, per, 8, apow,
                                                   0, M), 1)
        ms = cuda_ms(lambda: air_codegen.combine(air, lde, per, 8, apow), 3)
        # reads each trace and periodic column once, writes (N, 4); the
        # graph's unique products and K x 4 raw products (what the split
        # into kernels recomputes is the kernel's cost, not the function's:
        # reported beside, not bounded)
        b_ms, b_by = bound_ms(4 * ((air.width + air.num_periodic + 4) * N
                                   + 4 * K),
                              N * (counts["mul"] * SLOTS_PER_MONT
                                   + 4 * K * SLOTS_PER_RAW), 1)
        per_air.append(dict(air=name, shape=f"({air.width}, {N}) -> ({N}, "
                            f"4), {K} constraints", kernels=nk,
                            nodes=sum(counts.values()), muls=counts["mul"],
                            recomputed_muls=group_muls(graph) - counts["mul"],
                            max_abs_err=0, ms=ms, plain_ms=pms,
                            plain_points=[list(w) for w in windows],
                            bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] air_combine {name} ok: {per_air[-1]}")
        del lde, per, apow
        torch.cuda.empty_cache()
    out = {}
    for key, rows in (("air_combine", per_air),
                      ("air_constraints", per_air_eval)):
        big = next(r for r in rows if r["air"] == "TransferAir")
        out[key] = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                        ms=big["ms"], plain_ms=big["plain_ms"],
                        bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                        shape=f"TransferAir {big['shape']}", per_air=rows)
    return out


def kernel_ptxas(src: str, functions) -> dict:
    """Registers and spill bytes of each device function named in
    `functions` (a template instance keeps its argument: k_deep<2>, or
    K5's <Fp2>), from the ptxas report (-Xptxas -v) of this run's build
    of csrc/`src`: {"k_bucket_acc<Fp2>": {"registers": r,
    "spill_stores": s, "spill_loads": l, "callee_spill_stores": cs,
    "callee_spill_loads": cl}, ...}, the callee figures summed over the
    functions it calls that are not inlined."""
    import re

    from ethrex_tpu_torch import kernels

    out: dict = {}
    name = mangled = None
    own = False
    for line in kernels.BUILD_LOG.get(src, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = next((f for f in functions if f in mangled), None)
            arg = re.search(r"ILi(\d+)E", mangled)
            name = None if base is None else base + (
                "<Fp2>" if "Fp2" in mangled else
                f"<{arg.group(1)}>" if arg else "")
            if name:
                out[name] = dict(registers=None, spill_stores=0,
                                 spill_loads=0, callee_spill_stores=0,
                                 callee_spill_loads=0)
            continue
        if name is None:
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            own = m.group(1) == mangled
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            pre = "" if own else "callee_"
            out[name][pre + "spill_stores"] += int(m.group(1))
            out[name][pre + "spill_loads"] += int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def check_batch_inv(dev, rng) -> dict:
    """K7 on the outer proof's divisor stack (B + N + nb N elements for N
    = 2^25 and the FriVerifyAir's 10 boundary rows), and its divisor
    entry as the prover calls it there (the B coset-class values, then
    the nb + 1 constants over the 2^25 domain points)."""
    from ethrex_tpu_torch.ops import babybear as bb

    B, N, nb = 8, 1 << 25, 10
    n = B + N + nb * N
    a = field_dev(rng, (n,), dev)
    a[a == 0] = bb.MONT_ONE
    err, ms, pms = compare("batch_inv", lambda: bb.batch_mont_inv(a),
                           lambda: bb.batch_mont_inv_plain(a), plain_reps=1)
    # one read and one write a word; 3 products an element (the running
    # product and the two of the unwinding)
    b_ms, b_by = bound_ms(4 * 2 * n, 3 * n)
    del a
    torch.cuda.empty_cache()
    ptx = kernel_ptxas("batch_inv.cu", ("k_batch_inv", "k_divisor_inv"))
    rows = {"batch_inv": dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        shape=f"outer divisor stack ({n},)", ptxas=ptx)}
    pts = field_dev(rng, (N,), dev)
    head = [int(v) for v in rng.integers(1, bb.P, B)]
    consts = [int(v) for v in rng.integers(1, bb.P, nb + 1)]
    err, ms, pms = compare(
        "divisor_inv", lambda: bb.divisor_stack_inv(pts, head, consts),
        lambda: bb.divisor_stack_inv_plain(pts, head, consts), plain_reps=1)
    # reads the N points once and writes the (nb + 1) N inverses; the
    # unfused bound is K7's over the same stack (read and written)
    b_ms, b_by = bound_ms(4 * (N + n), 3 * n)
    rows["divisor_inv"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        bound_ms_unfused=bound_ms(4 * 2 * n, 3 * n)[0],
        shape=f"outer divisor stack ({n},) from {N} points and {nb + 1} "
              f"constants", ptxas=ptx)
    del pts
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"[kernels] {name} ok: {row}")
    return rows


# the shapes K8, K9 and K11 see on the path: (name, w, n, boundaries) of
# the state proof and of the outer proof (blowup 8)
GLUE_SHAPES = (("state", 115, 1 << 19, 24),
               ("executed state", 115, 1 << 21, 24),
               ("outer", 90, 1 << 22, 10))


def deep_bound(N: int, B: int, openings: int) -> tuple[float, str]:
    """K8's bound at N points, B quotient chunks and one or two openings,
    as the least work of any design: per point it reads x, the openings'
    sums (4 words each) and the 4 B chunk words and writes 4 words; the
    chunk and quotient ext products as raw products summed lazily (16
    each) with one reduction a coordinate, and in Montgomery products a
    conjugate and a norm (11) and 1/(x - z) (4) an opening, and 3 a norm
    for its inverse by Montgomery's trick."""
    raw = 16 * (B + openings)
    mont = (11 + 4 + 3) * openings
    slots = raw * SLOTS_PER_RAW + mont * SLOTS_PER_MONT + 4 * SLOTS_PER_REDC
    return bound_ms(4 * N * (1 + 4 * openings + 4 * B + 4), N * slots, 1)


def check_ext_glue(dev, rng) -> dict:
    """K8, K9 and K11 against their plain versions at the state proof's
    and the outer proof's shapes, timed at both; the row keeps the outer
    proof's times (the larger)."""
    from ethrex_tpu_torch.ops import ext

    rows = {"deep_compose": [], "quotient_combine": [], "ext_poly_eval": []}
    for tag, w, n, nb in GLUE_SHAPES:
        B, N = 8, n << 3

        def point():
            return tuple(int(v) for v in rng.integers(0, 2013265921, 4))

        # K8: two openings and the B quotient chunks
        pts = field_dev(rng, (N,), dev)
        opens = [(point(), field_dev(rng, (N, 4), dev), field_dev(rng, (w, 4), dev),
                  field_dev(rng, (w, 4), dev)) for _ in range(2)]
        q = dict(q_lde=field_dev(rng, (B, 4, N), dev),
                 q_z=field_dev(rng, (B, 4), dev), gq=field_dev(rng, (B, 4), dev))
        err, ms, pms = compare(
            f"deep_compose {tag} (N = {N})",
            lambda: ext.deep_compose(pts, opens, **q),
            lambda: ext.deep_compose_plain(pts, opens, **q), plain_reps=1)
        b_ms, b_by = deep_bound(N, B, 2)
        # the kernel's device time; the CUDA events around the wrapper
        # also hold its host work (the constants: one copy to the host)
        dev_ms = device_ms_by_function(
            lambda: ext.deep_compose(pts, opens, **q), ("k_deep",))
        rows["deep_compose"].append(dict(
            max_abs_err=err, ms=dev_ms["k_deep"], wrapper_ms=ms,
            plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, shape=f"{tag}: N = {N}, two openings, {B} "
                                 f"quotient chunks",
            # the count before this design's: every ext product as 18
            # reduced Montgomery products
            bound_ms_reduced_products=bound_ms(
                4 * N * (1 + 8 + 4 * B + 4),
                N * (22 + 6 + 8 + 18 * (B + 2)))[0]))
        del pts, opens, q
        # K9: the quotient's divisors and nb boundary terms
        acc = field_dev(rng, (N, 4), dev)
        xm = field_dev(rng, (N,), dev)
        inv = field_dev(rng, (B + N + nb * N,), dev)
        lde = field_dev(rng, (w, N), dev)
        cols = [int(c) for c in rng.integers(0, w, nb)]
        bvals, apb = field_dev(rng, (nb,), dev), field_dev(rng, (nb, 4), dev)
        err, ms, pms = compare(
            f"quotient_combine {tag} (N = {N}, {nb} boundaries)",
            lambda: ext.quotient_combine(acc, xm, inv, lde, cols, bvals,
                                         apb, B),
            lambda: ext.quotient_combine_plain(acc, xm, inv, lde, cols,
                                               bvals, apb, B), plain_reps=1)
        # reads acc, x - g^(n-1), the B coset-class inverses of
        # x^n - 1, one LDE word and one inverse per boundary; writes the
        # (N, 4) result
        b_ms, b_by = bound_ms(4 * (4 * N + N + B + 2 * nb * N + 4 * N),
                              N * (5 + 5 * nb))
        rows["quotient_combine"].append(dict(
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, shape=f"{tag}: N = {N}, {nb} boundaries"))
        del acc, xm, inv, lde
        # K11 as the open phase calls it: both points' power tables (K3's
        # (n, 8) operand) and the quotient chunks at zeta (a (B, n, 4)
        # view of the (B, 4, n) coefficients) in one launch
        chunks = field_dev(rng, (B, 4, n), dev).permute(0, 2, 1)
        rows["ext_poly_eval"].append(check_open_powers(
            tag, dev, (point(), point()), n, chunks))
        del chunks
        torch.cuda.empty_cache()
    out = {}
    for name, rs in rows.items():
        out[name] = dict(rs[-1], at_state_shape=rs[0],
                         at_executed_state_shape=rs[1])
    out["deep_compose"]["ptxas"] = kernel_ptxas("deep_compose.cu",
                                                ("k_deep",))
    out["ext_poly_eval"]["ptxas"] = kernel_ptxas("ext_poly_eval.cu",
                                                 ("k_open",))
    out["ext_poly_eval"]["fused_step_table"] = check_powers_table(
        dev, rng, 1 << 20)
    for name in rows:
        log(f"[kernels] {name} ok: {out[name]}")
    return out


def open_bound(n: int, B: int, points: int) -> tuple[float, str]:
    """K11's bound: per row i it reads the B chunk words (16 bytes each)
    and writes each point's power (16 bytes); one ext Montgomery product
    a row and point for the powers (16 products and 3 by W), 3 for W z
    when there are chunks, and 16 raw products a row and chunk summed
    lazily, with one reduction a coordinate and chunk (the least any
    design needs; the kernel reduces once a thread)."""
    mont = points * 19 + (3 if B else 0)
    slots = mont * SLOTS_PER_MONT + 16 * B * SLOTS_PER_RAW
    return bound_ms(16 * n * (B + points) + 16 * B,
                    n * slots + 4 * B * SLOTS_PER_REDC, 1)


def check_open_powers(tag, dev, points, n, chunks) -> dict:
    """K11 (`ext.open_powers`) against its plain version, bit-equal, at
    one of the open phase's shapes; timed as device time (torch.profiler,
    `ms`) and as the call (CUDA events, `wrapper_ms`)."""
    from ethrex_tpu_torch.ops import ext

    B = chunks.shape[0]
    table, sums = ext.open_powers(points, n, chunks)
    p_table, p_sums = ext.open_powers_plain(points, n, chunks)
    if not (torch.equal(table, p_table) and torch.equal(sums, p_sums)):
        raise AssertionError(f"ext_poly_eval {tag} ({B} x {n}, two "
                             f"points): kernel differs from its plain "
                             f"version")
    del table, sums, p_table, p_sums
    # the chunks alone (no table), as eval_ext_poly_at_ext gives them
    if not torch.equal(ext.eval_ext_poly_at_ext(chunks, points[0]),
                       ext.eval_ext_poly_at_ext_plain(chunks, points[0])):
        raise AssertionError(f"ext_poly_eval {tag}: the chunks alone "
                             f"differ from the plain version")

    def kern():
        return ext.open_powers(points, n, chunks)

    call_ms = cuda_ms(kern, 5)
    plain_ms = cuda_ms(lambda: ext.open_powers_plain(points, n, chunks), 1)
    dev_ms = device_ms_by_function(kern, ("k_open",))["k_open"]
    b_ms, b_by = open_bound(n, B, len(points))
    return dict(
        max_abs_err=0, ms=dev_ms, wrapper_ms=call_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{tag}: both points' ({n}, 4) power tables and {B} chunks "
              f"x {n} at zeta, one launch",
        # the count before this design's: one table, every ext product
        # as 18 reduced Montgomery products
        bound_ms_old_count=bound_ms(4 * (B * n * 4 + B * 4 + n * 4),
                                    18 * (B * n + n))[0])


def check_powers_table(dev, rng, n: int) -> dict:
    """K11's single-point table (the fused step's, n = 2^20) against its
    plain version, with its device time and the call's."""
    from ethrex_tpu_torch.ops import ext

    z = tuple(int(v) for v in rng.integers(0, 2013265921, 4))
    if not torch.equal(ext.powers_table(z, n, dev),
                       ext.ext_powers_blocked(z, n, device=dev)):
        raise AssertionError(f"ext_poly_eval: the ({n}, 4) power table "
                             f"differs from its plain version")

    def kern():
        return ext.powers_table(z, n, dev)

    b_ms, b_by = open_bound(n, 0, 1)
    row = dict(ms=device_ms_by_function(kern, ("k_open",))["k_open"],
               wrapper_ms=cuda_ms(kern, 5), bound_ms=b_ms, bound_by=b_by,
               shape=f"({n}, 4) power table of one point")
    log(f"[kernels] ext_poly_eval, the fused step's table: {row}")
    return row


def check_slice4_kernels(dev, rng) -> dict:
    """The four kernels of slice 4 at the sizes of their callers: the ext
    inverses over 2^20 elements and eval_poly_at over 64 rows of 2^16
    (test-only helpers), and to_mont_cols on the TransferAir trace as
    uploaded (2^20 x 278)."""
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.ops import ext
    from ethrex_tpu_torch.ops import ntt

    rows = {}
    n = 1 << 20
    a = field_dev(rng, (n, 4), dev)
    # per element: 12 Frobenius products, two ext products (32), the norm
    # (5), the Fermat power (61), the scaling (4)
    for name, kern, plain, prods in (
            ("ext_inv", ext.ext_inv_device, ext.ext_inv_device_plain,
             n * 114),
            ("ext_batch_inv", ext.batch_inv, ext.batch_inv_plain,
             n * 48 + -(-n // ext._EXT_INV_CHUNK) * 114)):
        err, ms, pms = compare(f"{name} ({n} ext elements)",
                               lambda: kern(a), lambda: plain(a),
                               plain_reps=1)
        b_ms, b_by = bound_ms(4 * 8 * n, prods)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          bound_ms=b_ms, bound_by=b_by,
                          shape=f"({n}, 4) ext elements")
        log(f"[kernels] {name} ok: {rows[name]}")
    del a
    r, m = 64, 1 << 16
    c = field_dev(rng, (r, m), dev)
    pt = int(rng.integers(1, bb.P))
    err, ms, pms = compare(f"eval_poly_at ({r} x {m})",
                           lambda: ntt.eval_poly_at(c, pt),
                           lambda: ntt.eval_poly_at_plain(c, pt),
                           plain_reps=1)
    b_ms, b_by = bound_ms(4 * (r * m + r), 2 * r * m)
    rows["eval_poly_at"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"({r}, {m}) at one point")
    log(f"[kernels] eval_poly_at ok: {rows['eval_poly_at']}")
    del c
    n, w = 1 << 20, 278
    trace = field_dev(rng, (n, w), dev)
    err, ms, pms = compare(f"to_mont_cols ({n} x {w})",
                           lambda: bb.to_mont_cols(trace),
                           lambda: bb.to_mont_cols_plain(trace),
                           plain_reps=1)
    b_ms, b_by = bound_ms(4 * 2 * n * w, n * w)
    rows["to_mont_cols"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"TransferAir trace ({n}, {w}) -> "
                                      f"({w}, {n})")
    log(f"[kernels] to_mont_cols ok: {rows['to_mont_cols']}")
    del trace
    torch.cuda.empty_cache()
    return rows


def fused_bound_ms(log_n: int, w: int = 64, log_blowup: int = 2,
                   log_final: int = 5) -> float:
    """The fused step's bound: the sum of its kernels' bounds at its shape
    (parallel/core.py: the LDE and the trace's iNTT, the leaf hash and
    tree of the LDE rows, the power table and the two matmuls, the DEEP
    codeword, every FRI fold, the layers' leaf hash and roots)."""
    n = 1 << log_n
    N = n << log_blowup
    L = log_n + log_blowup - log_final
    parts = [ntt_bound(w, n, N),
             bound_ms(4 * 2 * w * n, w * ((n // 2) * log_n + n)),
             bound_ms(4 * (w * N + 8 * N), N * (-(-w // 8)) * 772),
             tree_bound(N),
             bound_ms(4 * (w * n + 4 * n + 4 * w), 4 * w * n + 16 * n),
             bound_ms(4 * (w * N + 4 * w + 4 * N), 4 * w * N),
             deep_bound(N, 0, 1)]
    sizes = [N >> (k + 1) for k in range(L)]
    for half in sizes:
        parts.append(bound_ms(4 * (8 * half + half + 4 * half), 28 * half))
    leaves = sum(sizes)
    parts.append(bound_ms(4 * 16 * leaves, 772 * leaves))
    parts.append(bound_ms(4 * 8 * (leaves + L), 772 * (leaves - L)))
    return sum(ms for ms, _ in parts)


def _short_kernel_name(name: str) -> str:
    """A device event's name without namespace, template and arguments:
    the CUDA function (k_ntt_pass, air_k0, ...; K5's G2 template with
    "<Fp2>": k_bucket_acc<Fp2>), or "torch <kernel>" for
    PyTorch's own, or the copy or fill as the profiler names it."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    torch_kernel = "at::" in name
    head = name.split("<")[0].split("(")[0].split("::")[-1].split()
    short = head[-1] if head else name
    if "Fp2>" in name.split("(")[0]:
        short += "<Fp2>"                # K5's G2 instantiation
    return f"torch {short}" if torch_kernel else short


def _kernel_key(fn: str):
    """The KERNELS name of a device function of the profile, or None (a
    copy, a fill, PyTorch's own)."""
    if fn.startswith("air_k"):
        return "air_constraints"
    if fn.startswith("air_c"):
        return "air_combine"
    return DEVICE_FUNCTIONS.get(fn)


def _time_wrappers(fn):
    """Fallback when the profiler reports no device events: CUDA events
    around every `kernels.call` launch (the generated K6 kernels launch
    outside it and are not timed)."""
    from ethrex_tpu_torch import kernels

    orig = kernels.call
    recs = []

    def call(entry, device, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(entry, device, *args)
        b.record()
        recs.append((entry, time.perf_counter(), a, b))

    kernels.call = call
    try:
        out = fn()
    finally:
        kernels.call = orig
    torch.cuda.synchronize()
    return out, [(e, t, a.elapsed_time(b)) for e, t, a, b in recs]


def _device_events(events, t_anchor: float):
    """The profile's device events (kernels, copies, fills) as (host_us,
    dur_us, name, linked).  host_us, on the time.perf_counter() clock, is
    when the host enqueued the event: the start of the runtime call
    (cudaLaunchKernel, cudaMemcpyAsync, ...) with the event's correlation
    id.  The prover synchronizes at every phase's end, so the phase whose
    span holds that call ran the event; the device's own timestamps can
    sit milliseconds off the host clock, enough to move a phase's first
    kernels into the phase before.  An event with no such call (linked
    False) falls back on its device start."""
    from torch.autograd import DeviceType

    anchor = next(e for e in events if e.name == "smoke:anchor")
    off_us = anchor.time_range.start - t_anchor * 1e6
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        at = launch.get(e.id) if e.id > 0 else None
        out.append(((e.time_range.start if at is None else at) - off_us,
                    e.time_range.elapsed_us(), _short_kernel_name(e.name),
                    at is not None))
    return out


def profile_preroll() -> None:
    """Idle device time and a host pause at the start of a profile.  The
    profiler drops device events that it places before its start, and at
    a profile's start the card's clock can sit behind the host's: one
    profile on the card lost its first 1.2 s of device events."""
    for _ in range(8):
        torch.cuda._sleep(1 << 20)
    torch.cuda.synchronize()
    time.sleep(3.0)


def profile_path(dev, result) -> dict:
    """Where each phase's wall goes: every STARK of the main path proved
    again from its trace under torch.profiler (CPU and CUDA activity), in
    one profile that opens with `profile_preroll`.  Per proof and phase:
    the wall, the device time (kernels, copies and fills enqueued inside
    the phase's span), the idle share and the kernels by device time;
    per kernel: its device time summed over the proofs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ethrex_tpu_torch.stark import prover

    params = result["params"]
    lb, shift = params.log_blowup, params.shift
    per_kernel: dict = {}
    report: dict = {}
    source = "torch.profiler"
    runs = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_preroll()
        with record_function("smoke:anchor"):
            t_anchor = time.perf_counter()
        for name, (air, trace, pub) in result["traces"].items():
            # the main path cached this STARK's tables: drop them, so that
            # the profiled proof builds them (K7 and its glue) as the path
            # did
            head = (air.cache_key(), trace.shape[0].bit_length() - 1, lb,
                    shift)
            for key in [k for k in prover._TABLE_CACHE if k[:4] == head]:
                del prover._TABLE_CACHE[key]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _, st = prover.prove_with_stats(air, trace, pub, params,
                                            device=dev)
            torch.cuda.synchronize()
            runs.append((name, air, trace, pub, st,
                         torch.cuda.max_memory_allocated(dev)))
    ev = _device_events(prof.events(), t_anchor)
    all_ev = [(t, dur, nm) for t, dur, nm, _ in ev]
    unlinked_ms = sum(dur for _, dur, _, linked in ev if not linked) / 1e3
    del prof, ev
    for name, air, trace, pub, st, peak in runs:
        dev_ev = all_ev
        if not dev_ev:
            source = "CUDA events around kernels.call (profiler: none)"
            (_, st), recs = _time_wrappers(lambda: prover.prove_with_stats(
                air, trace, pub, params, device=dev))
            dev_ev = [(t * 1e6, ms * 1e3, e) for e, t, ms in recs]
        phases = {}
        for ph, t0, t1 in st["phase_spans"]:
            a, b = t0 * 1e6, t1 * 1e6
            by: dict = {}
            for start, dur, nm in dev_ev:
                if a <= start < b:
                    by[nm] = by.get(nm, 0.0) + dur / 1e3
            busy = sum(by.values())
            wall = (t1 - t0) * 1e3
            by_kernel: dict = {}
            for k, v in by.items():
                key = _kernel_key(k)
                if key:
                    by_kernel[key] = round(by_kernel.get(key, 0.0) + v, 3)
            phases[ph] = dict(wall_ms=wall, device_ms=busy,
                              idle_share=max(0.0, 1 - busy / wall)
                              if wall else 0.0,
                              top=sorted(((k, round(v, 3)) for k, v in
                                          by.items()), key=lambda kv: -kv[1])
                              [:6], by_kernel=by_kernel,
                              mod_matmul_fns={k: round(v, 3) for k, v in
                                              by.items() if _kernel_key(k)
                                              == "mod_matmul"},
                              torch_ms=round(sum(
                                  v for k, v in by.items()
                                  if k.startswith("torch ")), 3),
                              peak_gib=st.get("peak_bytes_by_phase", {})
                              .get(ph, 0) / 2**30)
            for k, v in by.items():
                per_kernel[k] = per_kernel.get(k, 0.0) + v
        busy = sum(p["device_ms"] for p in phases.values())
        report[name] = dict(total_s=st["total_s"], device_ms=busy,
                            idle_share=1 - busy / (st["total_s"] * 1e3),
                            peak_gib=peak / 2**30, phases=phases)
        log(f"[profile] {name} ({source}): proof {st['total_s']:.3f} s, "
            f"device {busy:.1f} ms, idle share "
            f"{report[name]['idle_share']:.3f}, peak device memory "
            f"{peak / 2**30:.2f} GiB; phases {json.dumps(phases)}")
    per_kernel = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1]))
    log(f"[profile] device ms per kernel over the {len(report)} STARKs: "
        f"{json.dumps({k: round(v, 3) for k, v in per_kernel.items()})}")
    # K3 and K6 by phase over the STARKs, and each STARK's peak
    by_phase: dict = {}
    for rep in report.values():
        for ph, row in rep["phases"].items():
            for key in ("mod_matmul", "air_constraints", "air_combine"):
                if key in row["by_kernel"]:
                    d = by_phase.setdefault(key, {})
                    d[ph] = round(d.get(ph, 0.0) + row["by_kernel"][key], 3)
    peaks = {name: round(rep["peak_gib"], 3) for name, rep in report.items()}
    tables = {name: {k: rep["phases"]["tables"]["by_kernel"].get(k, 0.0)
                     for k in ("batch_inv", "divisor_inv", "to_mont_cols",
                               "ntt")}
              | {"torch": rep["phases"]["tables"]["torch_ms"],
                 "device": round(rep["phases"]["tables"]["device_ms"], 3),
                 "wall": round(rep["phases"]["tables"]["wall_ms"], 3)}
              for name, rep in report.items() if "tables" in rep["phases"]}
    log(f"[profile] tables, device ms per STARK (K7, its divisor entry, "
        f"to_mont_cols, K1, PyTorch's own kernels; the phase's device and "
        f"wall ms): {json.dumps(tables)}")
    log(f"[profile] K3 and K6 device ms by phase over the STARKs: "
        f"{json.dumps(by_phase)}; peak GiB per STARK {json.dumps(peaks)}; "
        f"device ms placed by the device clock (no launch call found): "
        f"{unlinked_ms:.3f}")
    return dict(source=source, proofs=report, per_kernel=per_kernel,
                by_phase=by_phase, peak_gib=peaks, unlinked_ms=unlinked_ms,
                tables=tables)


# most K10 launches a call of the fused step's forest, by log_n
# (ceil(log2 of the largest tree / merkle.FOREST_LEVELS))
K10_LAUNCHES = {20: 3, 15: 2}


def check_batched_roots(dev, rng, log_blowup: int = 2,
                        log_final_size: int = 5) -> dict:
    """K10 on the fused step's FRI layer trees at log_n 20 and 15, held
    bit-equal to its plain version, its launches a call counted, timed
    as device time (torch.profiler: the sum of a call's launches, `ms`)
    and as the call (`wrapper_ms`); the row
    keeps log_n 20's."""
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.ops import merkle

    shapes = []
    for log_n in (20, 15):
        log_N = log_n + log_blowup
        sizes = tuple(1 << (log_N - 1 - k)
                      for k in range(log_N - log_final_size))
        d = field(rng, (sum(sizes), 8), dev)

        def kern():
            return torch.stack(merkle.batched_roots(d, sizes))

        kernels.reset_launches()
        got = kern()
        launches = kernels.LAUNCHES["merkle_batched_level"]
        if launches > K10_LAUNCHES[log_n]:
            raise AssertionError(f"merkle_batched_level: {launches} "
                                 f"launches at log_n {log_n}")
        if not torch.equal(got, torch.stack(
                merkle.batched_roots_plain(d, sizes))):
            raise AssertionError(f"merkle_batched_level ({len(sizes)} "
                                 f"trees, log_n {log_n}): kernel differs "
                                 f"from its plain version")
        del got
        call_ms = cuda_ms(kern, 5)
        pms = cuda_ms(lambda: torch.stack(
            merkle.batched_roots_plain(d, sizes)), 1)
        dev_ms = device_ms_per_call(kern, "k_forest", launches)
        # the permutations of every tree's levels, the leaves read once
        # and the roots written once
        b_ms, b_by = bound_ms(4 * 8 * (sum(sizes) + len(sizes)),
                              (sum(sizes) - len(sizes)) * 772)
        shapes.append(dict(
            max_abs_err=0, ms=dev_ms, wrapper_ms=call_ms, plain_ms=pms,
            bound_ms=b_ms, bound_by=b_by, launches_per_call=launches,
            shape=f"{len(sizes)} FRI layer trees, {sum(sizes)} leaves "
                  f"(fused step, log_n {log_n})"))
        log(f"[kernels] merkle_batched_level ok: {shapes[-1]}")
        del d
    return dict(shapes[0], at_log_n_15=shapes[1],
                ptxas=kernel_ptxas("poseidon2.cu", ("k_forest",)))


def msm_products(bit_rows: np.ndarray, live: np.ndarray) -> int:
    """Field products of the double-and-add MSM (the reference's and K5's
    before its bucket design) on these inputs: a doubling per bit of
    every finite point, an addition per set bit after a point's first,
    and the tree's additions."""
    pop = bit_rows.sum(axis=1).astype(np.int64)
    nbits = bit_rows.shape[1]
    n_live = int(live.sum())
    return int(n_live * nbits * BN254_DBL_MULS
               + (np.maximum(pop - 1, 0) * live).sum() * BN254_ADD_MULS
               + max(n_live - 1, 0) * BN254_ADD_MULS)


def signed_digits(s: int, c: int) -> int:
    """Nonzero digits of s in the signed c-bit recoding (digits in
    [-(2^(c-1) - 1), 2^(c-1)], a carry into the next window)."""
    count, carry = 0, 0
    while s or carry:
        raw = (s & ((1 << c) - 1)) + carry
        carry = 1 if raw > 1 << (c - 1) else 0
        count += raw not in (0, 1 << c)
        s >>= c
    return count


def bucket_products(scalars: list[int]) -> int:
    """The least field products of a signed-window bucket MSM over a
    table of bases pre-shifted per window (`msm_with_bases`), for these
    scalars (those of finite points), whatever window c it takes: the
    minimum over c = 4..16 of a mixed addition per nonzero digit (what
    this run's scalars need: a zero digit adds nothing) and two additions
    per bucket for the running sums.  The table's bases differ from
    window to window, so one set of 2^(c-1) buckets can serve every
    window and nothing combines the windows: no doublings, no per-window
    sums."""
    best = None
    for c in range(4, 17):
        digits = sum(signed_digits(int(s), c) for s in scalars)
        total = digits * BN254_MADD_MULS + (1 << c) * BN254_ADD_MULS
        best = total if best is None else min(best, total)
    return best


def bases_products(n_live: int, fp2: bool) -> int:
    """The least field products (Fp) of K5's table of bases for n_live
    finite affine points (Z = 1, as the wrap's): WINDOW_BITS doublings
    between windows, (WINDOWS - 1) WINDOW_BITS a point, then each shifted
    point of windows 1.. made affine by one batched inversion
    (Montgomery's trick: 3 products an element and one inverse, 253
    squarings and 109 products for the set bits of p - 2) and 4 products
    (Z^-2, Z^-3, X Z^-2, Y Z^-3).  G2: 3 Fp products an Fp2 product, and
    the inverse through the norm (4 Fp products around the Fp inverse)."""
    from ethrex_tpu_torch.ops import bn254_msm as msm_ops

    doublings = (msm_ops.WINDOWS - 1) * msm_ops.WINDOW_BITS
    elements = n_live * (msm_ops.WINDOWS - 1)
    mult = 3 if fp2 else 1
    inverse = 362 + (4 if fp2 else 0)
    return (n_live * doublings * BN254_DBL_MULS * mult
            + elements * (3 + 4) * mult + (inverse if n_live else 0))


def _profile_events(fn, functions, runs: int) -> dict:
    """{device function: [its events' device ms]} of the device functions
    named in `functions` (K5's G2 instances named with <Fp2>, other
    template instances without their arguments) in `runs` runs of `fn`,
    the profiler's active step after a warm-up step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            # idle device time first: the profiler drops device events
            # that it places before a step's start
            for _ in range(4):
                torch.cuda._sleep(1 << 20)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out: dict = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        nm = _short_kernel_name(e.name)
        if nm.split("<")[0] in functions:
            out.setdefault(nm, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def device_ms_by_function(fn, functions, runs: int = 5,
                          tries: int = 4) -> dict:
    """Mean device ms of each device function named in `functions` (all
    of which `fn` launches) in a run of `fn`, from torch.profiler: the
    mean over the events recorded in `runs` runs (`_profile_events`).
    The card drops device events of a profiler step, the first launches
    of a function among them, so a step can come back without some of
    its functions; profiles are taken again, up to `tries` in all, until
    each function has events, and the mean over them all does not
    depend on which."""
    total: dict = {}
    count: dict = {}
    for _ in range(tries):
        for nm, ms in _profile_events(fn, functions, runs).items():
            total[nm] = total.get(nm, 0.0) + sum(ms)
            count[nm] = count.get(nm, 0) + len(ms)
        if {nm.split("<")[0] for nm in total} >= set(functions):
            break
    return {nm: round(total[nm] / count[nm], 4) for nm in total}


def device_ms_per_call(fn, function: str, launches: int, runs: int = 5,
                       tries: int = 4) -> float:
    """Device ms of one call of `fn`, which launches `function` `launches`
    times with unlike lengths (K10's rounds), so a mean over launches
    would not do: the sum over a profiler step of `runs` calls, over
    `runs`, from the first of up to `tries` profiles that recorded all
    runs x launches events; if none did, the mean of the events times
    `launches`, logged as such."""
    for _ in range(tries):
        ms = _profile_events(fn, (function,), runs).get(function, [])
        if len(ms) == runs * launches:
            return round(sum(ms) / runs, 4)
    log(f"[kernels] {function}: the profiler recorded {len(ms)} of "
        f"{runs * launches} launches; device ms from their mean")
    return round(sum(ms) / max(1, len(ms)) * launches, 4)


def check_msm(dev, pk, z, n_pub) -> dict:
    """K5 against its plain version on the wrap's own four MSMs, with the
    witness of the main path's wrap: a_query and b1_query (G1, the
    witness), k_query + h_query (G1, the private witness and the
    quotient's coefficients) and b2_query (G2, the witness).  Per MSM:
    the table of bases (`msm_bases`, built once per point table; held
    bit-equal to its plain version at the largest G1 and at the G2
    shape, timed), then the MSM over it (`msm_with_bases`), held equal to
    the plain double-and-add as a group element (`same_point`: the two
    sum in different orders) and run twice for the same Jacobian bits,
    timed (CUDA events, median of 5), profiled by device function and
    bounded twice: by the bucket method's least products and by the
    double-and-add's (the bound of the design it replaced)."""
    from ethrex_tpu_torch.crypto import groth16
    from ethrex_tpu_torch.ops import bn254_msm as msm_ops

    r1cs, zz = z
    h = groth16._h_coeffs(r1cs, zz, groth16._domain_size(r1cs))
    ptxas = kernel_ptxas("bn254_msm.cu", K5_FUNCTIONS + K5_BASES_FUNCTIONS)
    log(f"[kernels] K5 ptxas (registers, spill bytes): {json.dumps(ptxas)}")
    shapes, tables = {}, {}
    for tag, name, pts, scalars, fp2 in (
            ("a_query", "bn254_msm_g1", pk.a_query, list(zz), False),
            ("b1_query", "bn254_msm_g1", pk.b1_query, list(zz), False),
            ("k_query+h_query", "bn254_msm_g1", pk.k_query + pk.h_query,
             list(zz[n_pub:]) + h, False),
            ("b2_query", "bn254_msm_g2", pk.b2_query, list(zz), True)):
        conv = msm_ops.g2_points_to_device if fp2 else \
            msm_ops.points_to_device
        X, Y, Z = conv(pts, dev)
        words_np = msm_ops.scalars_to_words(scalars)
        words = torch.from_numpy(words_np.view(np.int32)).to(dev)
        mult = 3 if fp2 else 1
        finite = np.array([p is not None for p in pts])
        words16 = (2 if fp2 else 1) * 16

        bases = msm_ops.msm_bases(X, Y, Z, fp2)
        b_ms = cuda_ms(lambda: msm_ops.msm_bases(X, Y, Z, fp2), 3)
        table = dict(ms=b_ms, max_abs_err=0, plain_ms=None,
                     shape=f"{len(pts)} points x {msm_ops.WINDOWS} windows")
        if tag in ("k_query+h_query", "b2_query"):
            t0 = time.perf_counter()
            want = msm_ops.msm_bases_plain(X, Y, Z, fp2)
            torch.cuda.synchronize()
            table["plain_ms"] = (time.perf_counter() - t0) * 1e3
            if not torch.equal(bases, want):
                raise AssertionError(f"bn254_msm_bases {tag}: the table "
                                     f"differs from its plain version")
            del want
        table["bound_ms"], table["bound_by"] = bound_ms(
            4 * (3 * len(pts) * words16 + bases.numel()),
            bases_products(int(finite.sum()), fp2), SLOTS_PER_BN254_MUL)
        table["device_ms_by_function"] = device_ms_by_function(
            lambda: msm_ops.msm_bases(X, Y, Z, fp2), K5_BASES_FUNCTIONS)
        tables[tag] = table
        log(f"[kernels] bn254_msm_bases {tag} (built once per point "
            f"table): {json.dumps(table)}")

        def kern():
            return msm_ops.msm_with_bases(bases, words, fp2)

        got = kern()
        again = kern()
        t0 = time.perf_counter()
        want = msm_ops.msm_device_plain(X, Y, Z, words, fp2)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        if not msm_ops.same_point(got, want, fp2):
            raise AssertionError(f"{name} {tag}: kernel and plain version "
                                 f"are different group elements")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} {tag}: two runs gave different "
                                 f"Jacobian bits")
        ms = cuda_ms(kern, 5)
        by_fn = device_ms_by_function(kern, K5_FUNCTIONS)
        fns = {f.split("<")[0] for f in by_fn}
        if fns != set(K5_FUNCTIONS) or any(("<Fp2>" in f) != fp2
                                           for f in by_fn):
            raise AssertionError(f"{name} {tag}: device functions {by_fn}")
        reduced = [int(s) % msm_ops.bn254.R for s in scalars]
        live = finite & np.array([s != 0 for s in reduced])
        nbits = max(1, max(int(s) % msm_ops.bn254.R
                           for s in scalars).bit_length())
        bits_np = msm_ops.scalars_to_bits(scalars, nbits)
        nbytes = 4 * (2 * len(pts) * words16 + words_np.size + 3 * words16)
        m_ms, m_by = bound_ms(nbytes, bucket_products(
            [s for s, ok in zip(reduced, finite) if ok]) * mult,
            SLOTS_PER_BN254_MUL)
        d_ms, _ = bound_ms(nbytes, msm_products(bits_np, live) * mult,
                           SLOTS_PER_BN254_MUL)
        shapes[tag] = dict(
            kernel=name, max_abs_err=0, ms=ms, plain_ms=pms, bound_ms=m_ms,
            bound_by=m_by, bound_ms_double_and_add=d_ms,
            device_ms_by_function=by_fn,
            shape=f"{len(pts)} points ({int(live.sum())} finite with a "
                  f"scalar not 0), {nbits}-bit scalars")
        log(f"[kernels] {name} {tag} ok (same group element as the plain "
            f"version, deterministic): {json.dumps(shapes[tag])}")
        del X, Y, Z, words, bases
    rows = {}
    for name, timed in (("bn254_msm_g1", "k_query+h_query"),
                        ("bn254_msm_g2", "b2_query")):
        row = dict(shapes[timed])
        row["at_shapes"] = {t: {k: v[k] for k in ("ms", "plain_ms",
                                                  "bound_ms",
                                                  "bound_ms_double_and_add",
                                                  "shape")}
                            for t, v in shapes.items()
                            if v["kernel"] == name}
        row["ptxas"] = {f: v for f, v in ptxas.items()
                        if f.split("<")[0] in K5_FUNCTIONS
                        and ("<Fp2>" in f) == (name == "bn254_msm_g2")}
        rows[name] = row
    row = dict(tables["k_query+h_query"])
    row["at_shapes"] = tables
    row["ptxas"] = {f: v for f, v in ptxas.items()
                    if f.split("<")[0] in K5_BASES_FUNCTIONS}
    rows["bn254_msm_bases"] = row
    return rows


def profile_wrap(dev, digest) -> dict:
    """Where the wrap's wall goes: two `groth16_wrap.wrap_prove`s of the
    main path's digest (keys cached).  The first ("first") drops the
    key's kept tables of bases first, so it builds them as the first wrap
    of a process does (the main path's: the points converted, four
    `msm_bases`); the second ("kept") runs over the tables the first
    kept, as every later wrap does.  Each with host timers (exclusive of
    the timed calls inside them) around the witness, `is_satisfied`,
    `_h_coeffs`, `wrap_tables` (the tables' lookup, or their build), the
    point and scalar conversions, the MSM calls (launch, wait and copy
    back), the host curve arithmetic (`g1_mul`, `g2_mul`, `g1_add`,
    `g2_add`), CUDA events around each `msm_bases` and `msm_with_bases`
    (K5's device time), and torch.profiler's device time per function."""
    from ethrex_tpu_torch.prover import groth16_wrap

    # the warm-up steps: the key's kept tables, with zero scalars
    warm = [(bases, torch.zeros((bases.shape[1], 8), dtype=torch.int32,
                                device=dev), bases.dim() == 5)
            for bases in groth16_wrap.wrap_tables(dev).values()]
    runs = {}
    for label in ("first", "kept"):
        for attempt in range(3):
            if label == "first":
                groth16_wrap._TABLES.clear()
            try:
                runs[label] = _profile_one_wrap(dev, digest, label, warm)
                break
            except ProfileEventsLost as e:
                if attempt == 2:
                    raise
                log(f"[wrap] {e}; profiled again")
    return runs


class ProfileEventsLost(AssertionError):
    """A profile came back without device launches that the run made
    (the card drops some of a profile's device events)."""


def _profile_one_wrap(dev, digest, label, warm) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    from ethrex_tpu_torch.crypto import bn254
    from ethrex_tpu_torch.crypto import groth16
    from ethrex_tpu_torch.ops import bn254_msm as msm_ops
    from ethrex_tpu_torch.prover import groth16_wrap

    excl: dict = {}
    stack: list = []
    events: list = []

    def timed(label, fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return fn(*a, **k)
            finally:
                child = stack.pop()
                dt = time.perf_counter() - t0
                excl[label] = excl.get(label, 0.0) + dt - child
                if stack:
                    stack[-1] += dt
        return inner

    def device_timed(fn, kind):
        def inner(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **k)
            e.record()
            events.append((s, e, kind(a[0])))
            return out
        return inner

    patches = [
        (groth16_wrap, "wrap_witness", "witness"),
        (groth16.R1CS, "is_satisfied", "is_satisfied"),
        (groth16, "_h_coeffs", "_h_coeffs"),
        (groth16_wrap, "wrap_tables", "tables of bases (lookup or build)"),
        (msm_ops, "points_to_device", "point conversion"),
        (msm_ops, "g2_points_to_device", "point conversion"),
        (msm_ops, "scalars_to_words", "scalar conversion"),
        (msm_ops, "_run_msm", "MSM launch, wait and copy back"),
        (bn254, "g1_mul", "host g1_mul/g2_mul/g1_add/g2_add"),
        (bn254, "g2_mul", "host g1_mul/g2_mul/g1_add/g2_add"),
        (bn254, "g1_add", "host g1_mul/g2_mul/g1_add/g2_add"),
        (bn254, "g2_add", "host g1_mul/g2_mul/g1_add/g2_add"),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    saved += [(msm_ops, "msm_with_bases", msm_ops.msm_with_bases),
              (msm_ops, "msm_bases", msm_ops.msm_bases)]
    msm_with_bases = msm_ops.msm_with_bases
    try:
        torch.cuda.synchronize()
        # the active step is the timed wrap.  The card drops the first
        # launches of a profiler step, so a warm-up step runs the same
        # device functions first (the MSMs, and for a first wrap the
        # tables' build, those tables dropped again), and the active step
        # opens with `profile_preroll`, before the timers go on
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for bases, words, fp2 in warm:
                msm_with_bases(bases, words, fp2)
            if label == "first":
                groth16_wrap.wrap_tables(dev)
                groth16_wrap._TABLES.clear()
            torch.cuda.synchronize()
            for obj, attr, tag in patches:
                setattr(obj, attr, timed(tag, getattr(obj, attr)))
            msm_ops.msm_with_bases = device_timed(
                msm_ops.msm_with_bases,
                lambda b: "g2" if b.dim() == 5 else "g1")
            msm_ops.msm_bases = device_timed(msm_ops.msm_bases,
                                             lambda _x: "bases")
            prof.step()
            profile_preroll()
            t0 = time.perf_counter()
            wrapped = groth16_wrap.wrap_prove(digest, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    if not groth16_wrap.wrap_verify(wrapped, digest):
        raise AssertionError(f"profiled wrap ({label}): wrap_verify "
                             f"rejected it")
    kinds = ("g1", "g2", "bases")
    k5_ms = {k: sum(s.elapsed_time(e) for s, e, g in events if g == k)
             for k in kinds}
    calls = {k: sum(1 for *_, g in events if g == k) for k in kinds}
    by_fn: dict = {}
    k5_launches = dict.fromkeys(kinds, 0)
    for e in prof.events():
        if e.device_type.name == "CUDA":
            nm = _short_kernel_name(e.name)
            by_fn[nm] = round(by_fn.get(nm, 0.0)
                              + e.time_range.elapsed_us() / 1e3, 4)
            base = nm.split("<")[0]
            if base in K5_BASES_FUNCTIONS:
                k5_launches["bases"] += 1
            elif base in K5_FUNCTIONS:
                k5_launches["g2" if nm.endswith("<Fp2>") else "g1"] += 1
    stray = [f for f in by_fn if f.split("<")[0] in ("k_double_and_add",
                                                     "k_tree_level")]
    per_call = {k: k5_launches[k] / calls[k] if calls[k] else 0
                for k in kinds}
    tables = 4 if label == "first" else 0
    if calls != {"g1": 3, "g2": 1, "bases": tables} or stray:
        raise AssertionError(f"profiled wrap ({label}): K5 calls {calls}, "
                             f"device functions {by_fn}")
    if per_call != {"g1": len(K5_FUNCTIONS), "g2": len(K5_FUNCTIONS),
                    "bases": len(K5_BASES_FUNCTIONS) if tables else 0}:
        raise ProfileEventsLost(
            f"profiled wrap ({label}): K5 calls {calls}, device launches "
            f"per call {per_call}, device functions {by_fn}")
    parts = {k: round(v, 4) for k, v in excl.items()}
    parts["other host"] = round(wall - sum(excl.values()), 4)
    log(f"[wrap] {label}: one wrap_prove {wall:.3f} s, host s by part "
        f"(exclusive): {json.dumps(parts)}; K5 device ms by CUDA events "
        f"{json.dumps(k5_ms)} over {json.dumps(calls)} calls, device "
        f"launches per call {json.dumps(per_call)}; device ms by function "
        f"{json.dumps(by_fn)}")
    return dict(wall_s=wall, parts_s=parts, k5_ms=k5_ms, by_fn=by_fn,
                launches_per_call=per_call)


# ---------------------------------------------------------------------------
# the Groth16 wrap keys: host setup in a child process
# ---------------------------------------------------------------------------

def wrap_keys_job():
    """Runs in the child: the wrap circuit's deterministic key setup."""
    torch.set_num_threads(1)
    from ethrex_tpu_torch.prover import groth16_wrap

    t0 = time.perf_counter()
    keys = groth16_wrap.wrap_keys()
    return keys, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def state_batch(rng, num_keys: int, num_writes: int):
    """A touched-state tree and write log shaped like a transfer batch."""
    from ethrex_tpu_torch.stark import state_tree

    def word():
        return bytes(rng.integers(0, 256, 32, dtype=np.uint8))

    entries = {word(): word() for _ in range(num_keys)}
    depth = state_tree.tree_depth_for(num_keys)
    tree = state_tree.TouchedStateTree(entries, depth)
    r_pre = tree.root
    keys = sorted(entries)
    accesses = [tree.update(keys[int(rng.integers(0, num_keys))], word())
                for _ in range(num_writes)]
    return tree, r_pre, accesses, depth


def state_job(rng, num_keys, num_writes):
    from ethrex_tpu_torch.models import state_update_air as sua
    from ethrex_tpu_torch.prover import gpu_backend

    tree, r_pre, accesses, depth = state_batch(rng, num_keys, num_writes)
    S = gpu_backend._schedule_for(depth)
    air = sua.StateUpdateAir(depth, seg_periods=S)
    trace = sua.generate_state_update_trace(accesses, r_pre, depth, S)
    pub = sua.state_update_public_inputs(accesses, r_pre, tree.root, S)
    return air, trace, pub


def binding_job(rng, limbs: int):
    from ethrex_tpu_torch.models import poseidon2_air as pair
    from ethrex_tpu_torch.ops import babybear as bb

    msg = [int(v) for v in rng.integers(0, bb.P, limbs)]
    air = pair.Poseidon2SpongeAir(num_chunks=len(pair.pad_message_limbs(
        msg)) // 8)
    return air, pair.generate_sponge_trace(msg), pair.sponge_public_inputs(msg)


def balance_slot(holder: bytes) -> int:
    """A token's balance slot of `holder`: keccak(holder . 0) as the
    Solidity mapping at slot 0 lays it out."""
    from ethrex_tpu_torch.crypto.keccak import keccak256

    return int.from_bytes(keccak256(bytes(12) + holder + bytes(32)), "big")


def vm_batch(rng, blocks: int = 4, per_block: int = 125):
    """BASELINE-3's VM stream: per block, `per_block` rounds of an ETH
    transfer (value 100 + i to 0x50 + i % 32) and a token call (value 0,
    amount 10 + i to 0x60 + i % 16), each followed by its coinbase
    segment, from one sender; plus one generic call to a counting loop of
    1,996 steps.  Balances are consistent across the stream; the sender's
    and the token holder's starting balances come from the seed."""
    from ethrex_tpu_torch.guest import bytecode_vm as bv
    from ethrex_tpu_torch.guest.transfer_log import (BcCall, TokSeg,
                                                     VmBatch)
    from ethrex_tpu_torch.models import transfer_air as ta
    from ethrex_tpu_torch.primitives.account import AccountState

    sender = bytes.fromhex("a11ce0" * 6 + "a11c")
    token = bytes([0x70]) * 20
    coinbase = bytes([0xC0]) * 20
    base_fee, gas_token = 7, 51_234
    price = base_fee + 1            # max priority fee 1
    s = AccountState(nonce=0, balance=10**21 + int(rng.integers(0, 10**9)))
    recips: dict = {}
    cb = None
    slots = {h: balance_slot(h) for h in
             [sender] + [bytes([0x60 + i]) * 20 for i in range(16)]}
    tok_bal = {slots[sender]: 10**12 + int(rng.integers(0, 10**9))}
    segs, tok_segs = [], []
    for _ in range(blocks):
        for i in range(per_block):
            for kind in ("eth", "tok"):
                gas = 21_000 if kind == "eth" else gas_token
                fee, tip = gas * price, gas * (price - base_fee)
                value = 100 + i if kind == "eth" else 0
                s_new = AccountState(nonce=s.nonce + 1,
                                     balance=s.balance - value - fee)
                if kind == "eth":
                    to = bytes([0x50 + i % 32]) * 20
                    r_old = recips.get(to)
                    r_new = AccountState(
                        nonce=0 if r_old is None else r_old.nonce,
                        balance=value + (0 if r_old is None
                                         else r_old.balance))
                    recips[to] = r_new
                    segs.append(ta.TxSeg(sender, to, s, s_new, r_old, r_new,
                                         value, fee, tip,
                                         r_created=r_old is None,
                                         r_noop=False))
                else:
                    amount = 10 + i
                    kf = slots[sender]
                    kt = slots[bytes([0x60 + i % 16]) * 20]
                    bf, bt = tok_bal[kf], tok_bal.get(kt, 0)
                    tok_bal[kf], tok_bal[kt] = bf - amount, bt + amount
                    tok_segs.append(TokSeg(amount, kf, bf, bf - amount, kt,
                                           bt, bt + amount))
                    segs.append(ta.TxSeg(sender, token, s, s_new, None, None,
                                         0, fee, tip, False, True))
                s = s_new
                cb_new = AccountState(
                    nonce=0, balance=tip + (0 if cb is None else cb.balance))
                segs.append(ta.CbSeg(coinbase, cb, cb_new, tip,
                                     created=cb is None, noop=False))
                cb = cb_new
    # PUSH0; loop: JUMPDEST PUSH1 1 ADD DUP1 PUSH1 249 GT PUSH1 1 JUMPI;
    # PUSH0 SSTORE STOP: counts to 249 and stores it
    code = bytes([0x5F, 0x5B, 0x60, 0x01, 0x01, 0x80, 0x60, 249, 0x11,
                  0x60, 0x01, 0x57, 0x5F, 0x55, 0x00])
    steps, snaps, _ = bv.run_trace(code, b"", sender, 0, lambda slot: 0,
                                   address=bytes([0xB0]) * 20)
    return VmBatch([], segs, tok_segs, [], [BcCall(steps, snaps)])


def install_wrap_keys(keys_future):
    """The wrap keys come from the child (host setup); the wraps need
    them.  Returns them."""
    from ethrex_tpu_torch.prover import groth16_wrap

    t0 = time.perf_counter()
    keys, keys_s = keys_future.result()
    groth16_wrap.use_keys(keys)
    log(f"[keys] wrap_keys host setup {keys_s:.1f} s in the child "
        f"(waited {time.perf_counter() - t0:.1f} s): "
        f"{len(keys[0].constraints)} constraints, {keys[0].num_vars} "
        f"variables, domain {keys[2].domain_size}")
    return keys


def log_stark_walls(tag, stats, names) -> tuple[float, float]:
    """Each STARK's host walls and phases, the aggregation's and the
    wrap's; returns (inner proofs' seconds, aggregate's seconds)."""
    inner_s = 0.0
    for name in names:
        st = stats[name]
        inner_s += st["pub_s"] + st["trace_s"] + st["total_s"]
        log(f"[{tag}] {name} proof: trace {st['n']} x {st['width']} (N = "
            f"{st['N']}, {st['num_constraints']} constraints), host public "
            f"inputs {st['pub_s']:.1f} s, host trace generation "
            f"{st['trace_s']:.1f} s, proof {st['total_s']:.3f} s, phases "
            f"(s) {json.dumps(st['phase_s'])}")
    agg_stats = stats["aggregate"]
    outer = agg_stats["outer"]
    log(f"[{tag}] outer FriVerifyAir: {agg_stats['items']} items, trace "
        f"{agg_stats['trace_shape']} (N = {outer['N']}, "
        f"{outer['num_constraints']} constraints), host trace generation "
        f"{agg_stats['trace_s']:.1f} s")
    log(f"[{tag}] outer proof phases (s): {json.dumps(outer['phase_s'])} "
        f"total {outer['total_s']:.3f}")
    agg_s = agg_stats["trace_s"] + outer["total_s"]
    log(f"[{tag}] inner proofs with their host public inputs and traces "
        f"{inner_s:.3f} s; aggregate {agg_s:.3f} s; wrap "
        f"{stats['wrap_s']:.3f} s")
    return inner_s, agg_s


def check_path_launches(tag, launches, traces, tables: int) -> None:
    """Every kernel outside NOT_ON_GROTH16_PATHS launched on the path; the
    wrap's K5 calls; K6's combine kernels once per constraint group of
    each STARK and never its block form; one K11 launch per STARK; the
    upload of every STARK's trace through to_mont_cols."""
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in NOT_ON_GROTH16_PATHS
               and not (k == "bn254_msm_bases" and tables == 0)]
    if missing:
        raise AssertionError(f"kernels not launched on the {tag}: "
                             f"{missing}")
    check_wrap_msms(tag, launches, tables=tables)
    from ethrex_tpu_torch.stark import air_codegen

    groups_per_air = {name: len(air_codegen.groups(air_codegen.record(air)))
                      for name, (air, _, _) in traces.items()}
    log(f"[{tag}] air_combine launches per STARK (its constraint groups): "
        f"{json.dumps(groups_per_air)}")
    if launches["air_combine"] != sum(groups_per_air.values()) or \
            launches["air_constraints"]:
        raise AssertionError(
            f"{tag}: air_combine launched {launches['air_combine']} times "
            f"(the STARKs' groups: {sum(groups_per_air.values())}), "
            f"air_constraints {launches['air_constraints']} times (0 "
            f"expected)")
    # each STARK's open phase makes its power tables and its quotient
    # chunks at zeta in one K11 launch, and nothing else launches K11
    if launches["ext_poly_eval"] != len(traces):
        raise AssertionError(f"{tag}: ext_poly_eval launched "
                             f"{launches['ext_poly_eval']} times for "
                             f"{len(traces)} STARKs (one each expected)")
    if launches["to_mont_cols"] < len(traces):
        raise AssertionError(f"{tag}: to_mont_cols launched "
                             f"{launches['to_mont_cols']}"
                             f" times for {len(traces)} STARKs")


class SmokeCoordinator:
    """A minimal proof coordinator on 127.0.0.1, written here with the
    port's wire framing (`prover.protocol`, the reference's bytes): it
    answers one InputRequest with `input_json` at `proof_format`, acks
    heartbeats that carry the lease token, and takes one ProofSubmit,
    which `check(proof)` must accept before the ACK.  One connection at a
    time, on a thread of its own; `stop()` closes it."""

    def __init__(self, input_json: dict, proof_format: str, check):
        import socket
        import threading

        self.input_json = input_json
        self.proof_format = proof_format
        self.check = check
        self.lease_token = "smoke-lease-1"
        self.assigned = False
        self.proof = None
        self.warm = None
        self.heartbeats = []
        self.t_request = self.t_ack = None
        self.error = None
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return          # closed by stop()
            with conn:
                try:
                    self._handle(conn)
                except Exception as e:          # reported by the caller
                    self.error = e

    def _handle(self, conn):
        from ethrex_tpu_torch.prover import protocol

        msg = protocol.recv_msg_file(conn.makefile("rb"))
        kind = msg.get("type") if msg else None
        if kind == protocol.INPUT_REQUEST:
            if msg.get("commit_hash") != protocol.PROTOCOL_VERSION:
                protocol.send_msg(conn, {
                    "type": protocol.VERSION_MISMATCH,
                    "expected": protocol.PROTOCOL_VERSION})
                return
            if self.assigned:
                protocol.send_msg(conn, {"type": protocol.TYPE_NOT_NEEDED})
                return
            self.assigned = True
            self.warm = msg.get("warm")
            self.t_request = time.perf_counter()
            protocol.send_msg(conn, {
                "type": protocol.INPUT_RESPONSE, "batch_id": 1,
                "input": self.input_json, "format": self.proof_format,
                "lease_token": self.lease_token})
        elif kind == protocol.HEARTBEAT:
            ok = msg.get("lease_token") == self.lease_token
            if ok:
                self.heartbeats.append(msg.get("phase"))
            protocol.send_msg(conn, {"type": protocol.HEARTBEAT_ACK,
                                     "batch_id": msg.get("batch_id"),
                                     "ok": ok})
        elif kind == protocol.PROOF_SUBMIT:
            proof = msg.get("proof")
            if msg.get("lease_token") != self.lease_token \
                    or msg.get("batch_id") != 1 or not self.check(proof):
                protocol.send_msg(conn, {"type": protocol.ERROR,
                                         "message": "proof rejected"})
                return
            self.proof = proof
            protocol.send_msg(conn, {"type": protocol.SUBMIT_ACK,
                                     "batch_id": 1})
            self.t_ack = time.perf_counter()

    def stop(self):
        self.sock.close()
        self.thread.join(timeout=10)


def smoke_backend(dev, stats, traces, artifacts):
    """A `GpuBackend` on `dev` whose `prove` (the proof client's call)
    passes the smoke's `stats`, `traces` and `artifacts` dicts through and
    records its own wall under stats["prove_wall_s"]."""
    from ethrex_tpu_torch.prover.gpu_backend import GpuBackend

    class SmokeBackend(GpuBackend):
        def prove(self, program_input, proof_format):
            t0 = time.perf_counter()
            proof = super().prove(program_input, proof_format, stats=stats,
                                  traces=traces, artifacts=artifacts)
            torch.cuda.synchronize()
            stats["prove_wall_s"] = time.perf_counter() - t0
            return proof

    return SmokeBackend(device=dev)


def expected_mode_job(name: str):
    """Runs in a child: the committer's classifier over the fixture (a
    stateless re-execution, host Python)."""
    torch.set_num_threads(1)
    from ethrex_tpu_torch import fixtures
    from ethrex_tpu_torch.prover import gpu_backend

    t0 = time.perf_counter()
    mode = gpu_backend.expected_vm_mode(fixtures.load_program_input(name))
    return mode, time.perf_counter() - t0


def executed_path(dev, mode_future) -> dict:
    """The main path: the committed BASELINE-3 ProgramInput (1,000
    transactions over 4 blocks) pulled from `SmokeCoordinator` by the
    port's `ProverClient(backend, [(host, port)]).poll_once()`, which
    proves it at groth16 through `GpuBackend.prove` (execution, its VM
    batch and access records, the state, TransferAir, TokenAir and
    binding STARKs, their aggregate and the wrap) and submits it over a
    fresh connection.  The coordinator checks `verify_submission` and
    `check_coverage(proof, expected_vm_mode(pi))` against mode `token`
    (`mode_future`: the classifier, run in a child) before its ACK.  The
    round runs with ETHREX_PROOF_CKPT_OFF=1, the reference's own knob:
    checkpointed, one BASELINE-3 batch would write its LDEs and Merkle
    trees (tens of GB) to the temporary directory.  The submitted proof's
    results are held to the reference's (`fixtures.expected`): the
    output, write-log and VM-meta digests, the tree depth, seg_periods,
    the mode and the segment counts."""
    import os

    from ethrex_tpu_torch import fixtures, kernels
    from ethrex_tpu_torch.prover import gpu_backend, protocol
    from ethrex_tpu_torch.prover.client import ProverClient

    t0 = time.perf_counter()
    pi = fixtures.load_program_input("baseline3")
    want = fixtures.expected("baseline3")
    log(f"[executed] BASELINE-3 ProgramInput loaded in "
        f"{time.perf_counter() - t0:.2f} s: {len(pi.blocks)} blocks, "
        f"{sum(len(b.body.transactions) for b in pi.blocks)} transactions, "
        f"{len(pi.witness.nodes)} witness nodes")
    stats: dict = {}
    traces: dict = {}
    artifacts: dict = {}
    backend = smoke_backend(dev, stats, traces, artifacts)
    gate = {}

    def check(proof):
        # the coordinator's gate at ProofSubmit: structural, plus the
        # anti-downgrade check against the committer's classifier
        t_c = time.perf_counter()
        expected_mode, mode_s = mode_future.result()
        gate.update(
            submission=backend.verify_submission(proof),
            coverage=backend.check_coverage(proof, expected_mode),
            expected_mode=expected_mode, mode_s=mode_s,
            check_s=time.perf_counter() - t_c)
        return gate["submission"] and gate["coverage"] \
            and expected_mode == "token"

    coord = SmokeCoordinator(pi.to_json(), protocol.FORMAT_GROTH16, check)
    client = ProverClient(backend, [("127.0.0.1", coord.port)],
                          heartbeat_interval=20.0, rng_seed=SEED)
    if not client._prewarm_done.wait(600):
        raise AssertionError("the client's pre-warm did not finish")
    log(f"[client] pre-warm built {client.hydrated_groups} artifacts; "
        f"InputRequest warm={client.warm}")
    prev_off = os.environ.get("ETHREX_PROOF_CKPT_OFF")
    os.environ["ETHREX_PROOF_CKPT_OFF"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t_path = time.perf_counter()
        proven = client.poll_once()
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t_path
        launches = dict(kernels.LAUNCHES)
    finally:
        client.stop()
        coord.stop()
        if prev_off is None:
            os.environ.pop("ETHREX_PROOF_CKPT_OFF")
        else:
            os.environ["ETHREX_PROOF_CKPT_OFF"] = prev_off
    if coord.error is not None:
        raise coord.error
    if proven != 1 or coord.proof is None or client.submit_rejections:
        raise AssertionError(f"the client round failed: proven {proven}, "
                             f"gate {gate}, rejections "
                             f"{client.submit_rejections}")
    proof = coord.proof
    round_s = coord.t_ack - coord.t_request
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[client] round from InputRequest to ACK {round_s:.3f} s (the "
        f"prove's own wall {stats['prove_wall_s']:.3f} s, the poll "
        f"{path_s:.3f} s); {len(coord.heartbeats)} heartbeats, phases "
        f"{sorted(set(p for p in coord.heartbeats if p))}; the "
        f"coordinator's gate: verify_submission {gate['submission']}, "
        f"check_coverage {gate['coverage']} against mode "
        f"{gate['expected_mode']} (expected_vm_mode {gate['mode_s']:.1f} "
        f"s in a child, gate {gate['check_s']:.3f} s)")
    log(f"[executed] host walls: execute {stats['execute_s']:.3f} s, "
        f"build_vm_batch {stats['build_vm_batch_s']:.3f} s, access "
        f"records {stats['records_s']:.3f} s; mode {stats['mode']}")
    names = [n for n in ("state", "transfer", "token", "binding")
             if n in stats]
    log_stark_walls("executed", stats, names)
    log(f"[executed] whole executed groth16 path {path_s:.3f} s; peak "
        f"device memory {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps(launches)}")
    got = fixtures.proof_summary(proof)
    wrong = {k: (got.get(k), want[k]) for k in got if got[k] != want[k]}
    if wrong or got["mode"] != "token" or set(proof) != {
            "backend", "format", "output", "write_log", "depth",
            "seg_periods", "state_proof", "proof", "vm", "vm_proof",
            "tok_proof", "aggregate", "groth16"}:
        raise AssertionError(f"executed path: results differ from the "
                             f"reference's: {wrong}, keys {sorted(proof)}")
    log(f"[executed] the submitted proof's output, write-log and VM-meta "
        f"digests, depth {got['depth']}, seg_periods {got['seg_periods']}, "
        f"mode {got['mode']} and segments {json.dumps(got['segments'])} "
        f"equal the reference's (baseline3_expected.json)")
    check_path_launches("executed path", launches, traces, tables=4)
    reckoned = reckon_batch(stats, gpu_backend.PARAMS.log_blowup)
    log(f"[ckpt] reckoned checkpoint envelopes of this batch, were it "
        f"checkpointed (commit, quotient and open of each STARK): "
        f"{sum(reckoned.values())} bytes: {json.dumps(reckoned)}")
    return dict(launches=launches, airs=artifacts["airs"], out=proof,
                proofs=artifacts["proofs"], main_s=path_s, peak_bytes=peak,
                params=gpu_backend.PARAMS, stats=stats, traces=traces,
                round_s=round_s)


def reckon_envelope_bytes(n: int, w: int, log_blowup: int) -> int:
    """Bytes of one STARK's commit, quotient and open checkpoint
    envelopes (int32 words; the pickle's framing not counted): the trace
    LDE (w N) and its Merkle tree (2N - 1 digests of 8); the quotient's
    chunks (B n 4), their LDE (4 B N) and its tree; the openings (2 w + B
    values of 4).  The fri envelope and the finished proof, kilobytes to
    megabytes, are left out."""
    B = 1 << log_blowup
    N = n << log_blowup
    tree = (2 * N - 1) * 8
    return 4 * (w * N + tree + B * n * 4 + 4 * B * N + tree
                + (2 * w + B) * 4)


def reckon_batch(stats, log_blowup: int) -> dict:
    """`reckon_envelope_bytes` for every STARK a prove's stats hold (the
    inner ones by name, the aggregate's outer one as "outer")."""
    shapes = {name: (st["n"], st["width"]) for name, st in stats.items()
              if isinstance(st, dict) and "width" in st}
    if "aggregate" in stats:
        outer = stats["aggregate"]["outer"]
        shapes["outer"] = (outer["n"], outer["width"])
    return {name: reckon_envelope_bytes(n, w, log_blowup)
            for name, (n, w) in shapes.items()}


def verify_job(proof, keys) -> dict:
    """Runs in a child, on the card's host: `GpuBackend(device="cpu")
    .verify_with_input` accepts the executed path's submitted groth16
    proof with the BASELINE-3 ProgramInput and rejects it with one output
    byte flipped and with its `vm` metadata removed (the downgrade).
    Returns the walls."""
    torch.set_num_threads(1)
    from ethrex_tpu_torch import fixtures
    from ethrex_tpu_torch.prover import groth16_wrap
    from ethrex_tpu_torch.prover.gpu_backend import GpuBackend

    groth16_wrap.use_keys(keys)
    pi = fixtures.load_program_input("baseline3")
    backend = GpuBackend(device="cpu")
    walls = {}
    flipped = dict(proof)
    out = bytearray.fromhex(proof["output"][2:])
    out[0] ^= 1
    flipped["output"] = "0x" + out.hex()
    downgraded = {k: v for k, v in proof.items() if k != "vm"}
    for name, candidate, want in (("honest", proof, True),
                                  ("output_byte", flipped, False),
                                  ("vm_removed", downgraded, False)):
        t0 = time.perf_counter()
        got = backend.verify_with_input(candidate, pi)
        walls[name] = time.perf_counter() - t0
        if got is not want:
            raise AssertionError(f"verify_with_input gave {got} on the "
                                 f"{name} proof ({want} expected)")
    return walls


def resume_drill(dev) -> dict:
    """The committed mixed batch at `stark` format under
    `checkpoint.batch_context` with a temporary ETHREX_PROOF_CKPT_DIR:
    the `backend.phase` drop fault ends the prove at each phase boundary
    in turn (the execute envelope, then each STARK's commit, quotient,
    open and fri), and the next prove resumes from the finished phases.
    The proof that comes out, and a re-prove that loads every finished
    STARK, must equal the uninterrupted one under json.dumps(...,
    sort_keys=True)."""
    import os
    import tempfile

    from ethrex_tpu_torch import fixtures
    from ethrex_tpu_torch.prover import checkpoint
    from ethrex_tpu_torch.prover import runtime_errors as rt
    from ethrex_tpu_torch.prover.gpu_backend import GpuBackend
    from ethrex_tpu_torch.utils import faults

    pi = fixtures.load_program_input("mixed")
    backend = GpuBackend(device=dev)
    stats: dict = {}
    t0 = time.perf_counter()
    want = json.dumps(backend.prove(pi, "stark", stats=stats),
                      sort_keys=True)
    base_s = time.perf_counter() - t0
    reckoned = sum(reckon_batch(stats, 3).values())
    rt.reset_stats()
    prev = os.environ.get("ETHREX_PROOF_CKPT_DIR")
    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_") as tmp:
        os.environ["ETHREX_PROOF_CKPT_DIR"] = tmp
        try:
            kills, proof = 0, None
            t0 = time.perf_counter()
            with checkpoint.batch_context("smoke-drill", lease_token="t"):
                while proof is None:
                    faults.install(faults.FaultPlan(seed=kills).drop(
                        "backend.phase", times=1))
                    try:
                        proof = backend.prove(pi, "stark")
                    except faults.InjectedFault:
                        kills += 1
                        if kills > 40:
                            raise AssertionError("the drill never ended")
                    finally:
                        faults.clear()
                drill_s = time.perf_counter() - t0
                resumed = rt.STATS["phase_resumes"]
                envelope_bytes = sum(
                    os.path.getsize(os.path.join(root, f))
                    for root, _, files in os.walk(tmp) for f in files)
                again = backend.prove(pi, "stark")
        finally:
            if prev is None:
                os.environ.pop("ETHREX_PROOF_CKPT_DIR")
            else:
                os.environ["ETHREX_PROOF_CKPT_DIR"] = prev
    for name, got in (("resumed", proof), ("re-proved", again)):
        if json.dumps(got, sort_keys=True) != want:
            raise AssertionError(f"the drill's {name} proof differs from "
                                 f"the uninterrupted one")
    if not reckoned <= envelope_bytes <= 1.1 * reckoned:
        raise AssertionError(f"envelopes {envelope_bytes} bytes, reckoned "
                             f"{reckoned} from the shapes")
    log(f"[drill] mixed batch, stark: {kills} kills at phase boundaries, "
        f"{resumed} phases resumed from checkpoints, envelopes "
        f"{envelope_bytes} bytes (reckoned from the shapes: {reckoned} in "
        f"the commit, quotient and open envelopes); the resumed proof and a re-prove that "
        f"loads every finished STARK equal the uninterrupted one "
        f"({base_s:.2f} s uninterrupted, {drill_s:.2f} s for the "
        f"{kills + 1} proves of the drill)")
    return dict(kills=kills, resumed=resumed, envelope_bytes=envelope_bytes)


def oom_drill(dev, rng) -> None:
    """`memory_gate` fed an available size below a STARK's estimate
    (`runtime_errors.stark_bytes`) refuses it with `classify(...) ==
    "oom"` before any kernel of that STARK launches."""
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.prover import gpu_backend
    from ethrex_tpu_torch.prover import runtime_errors as rt
    from ethrex_tpu_torch.stark import prover

    air, trace, pub = state_job(rng, 126, 127)
    params = gpu_backend.PARAMS
    est = rt.stark_bytes(trace.shape[0], trace.shape[1], params.log_blowup,
                         air.num_periodic, len(air.boundaries(
                             pub, trace.shape[0])))
    real = rt._available_bytes
    rt._available_bytes = lambda device: est // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        prover.prove(air, trace, pub, params, device=dev)
    except rt.TransientPhaseError as e:
        kind = rt.classify(e)
    else:
        kind = None
    finally:
        rt._available_bytes = real
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if kind != "oom" or launched:
        raise AssertionError(f"the memory gate gave {kind!r} and launched "
                             f"{launched}")
    log(f"[oom] memory_gate refused a {trace.shape[0]} x {trace.shape[1]} "
        f"STARK (estimate {est} bytes, {est // 2} fed as free): classify "
        f"gave 'oom', no kernel launched")


def main_path(dev, rng) -> dict:
    """The synthesized VM-mode groth16 batch through
    `gpu_backend.prove_vm_stages`, the only path with a generic call (and
    so BytecodeAir): BASELINE-3's stream cut to 32 rounds a block, a
    state tree of 256 keys and 255 writes, and the generic call."""
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.prover import gpu_backend

    params = gpu_backend.PARAMS
    t0 = time.perf_counter()
    tree, r_pre, records, depth = state_batch(rng, num_keys=256,
                                              num_writes=255)
    batch = vm_batch(rng, per_block=32)
    encoded = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    log(f"[vm] batch synthesized in {time.perf_counter() - t0:.1f} s: "
        f"{len(records)} state writes (depth {depth}), {len(batch.segs)} "
        f"transfer segments, {len(batch.tok_segs)} token segments, one "
        f"generic call of {len(batch.bc_calls[0].steps)} steps")
    stats: dict = {}
    traces: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t_main = time.perf_counter()
    out, airs, proofs = gpu_backend.prove_vm_stages(
        records, r_pre, tree.root, depth, encoded, batch, "groth16",
        device=dev, params=params, stats=stats, traces=traces)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    log_stark_walls("vm", stats, ("state", "transfer", "token", "bytecode0",
                                  "binding"))
    log(f"[vm] whole synthesized VM-mode groth16 path {main_s:.3f} s; peak "
        f"device memory {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps(launches)}")
    # the executed path's wrap, the process's first, built the tables
    check_path_launches("synthesized VM path", launches, traces, tables=0)
    return dict(launches=launches, airs=airs, out=out, proofs=proofs,
                main_s=main_s, peak_bytes=peak, params=params, stats=stats)
def check_wrap_msms(tag, launches, tables: int) -> None:
    """A groth16 path's wrap runs three G1 MSMs and one G2 MSM, each one
    K5 call, and builds `tables` tables of bases: the four point tables
    of the wrap's key on the first wrap of the process, none after (they
    are kept)."""
    got = (launches["bn254_msm_g1"], launches["bn254_msm_g2"],
           launches["bn254_msm_bases"])
    if got != (3, 1, tables):
        raise AssertionError(f"{tag}: K5 launched {got} times for G1, G2 "
                             f"and the tables of bases ((3, 1, {tables}) "
                             f"expected)")


def check_inner(names, airs, full, params, tamper) -> None:
    """The port's verifier accepts each inner proof and rejects a
    tampered public input of those named in `tamper`."""
    from ethrex_tpu_torch.stark import verifier

    for name, air, proof in zip(names, airs, full, strict=True):
        verifier.verify(air, proof, params)
        if name not in tamper:
            continue
        bad = dict(proof)
        bad["pub_inputs"] = list(proof["pub_inputs"])
        bad["pub_inputs"][0] = (bad["pub_inputs"][0] + 1) % 2013265921
        try:
            verifier.verify(air, bad, params)
        except verifier.VerificationError:
            pass
        else:
            raise AssertionError(f"a tampered {name} public input verified")


def check_formats(tag, airs, inners, aggregate_out, groth16_json, params,
                  tamper_at: int) -> None:
    """`verify_aggregated` accepts the aggregate of the path-stripped
    `inners` and rejects a tampered FRI value of inner `tamper_at`;
    `wrap_verify` accepts the wrap and rejects a wrong digest."""
    from ethrex_tpu_torch.prover import groth16_wrap
    from ethrex_tpu_torch.stark import aggregate, verifier

    agg = aggregate.AggregateProof(
        inners=inners, outer=aggregate_out["outer"],
        max_depth=aggregate_out["max_depth"],
        seg_periods=aggregate_out["seg_periods"])
    t0 = time.perf_counter()
    aggregate.verify_aggregated(airs, agg, params)
    log(f"[check] {tag}: verify_aggregated accepted the {len(inners)}-proof "
        f"aggregate ({time.perf_counter() - t0:.1f} s)")
    bad_inner = json.loads(json.dumps(inners[tamper_at]))
    val = bad_inner["fri"]["queries"][0][1]["values"][0]
    val[0] = (val[0] + 1) % 2013265921
    bad_agg = aggregate.AggregateProof(
        inners=inners[:tamper_at] + [bad_inner] + inners[tamper_at + 1:],
        outer=agg.outer, max_depth=agg.max_depth,
        seg_periods=agg.seg_periods)
    t0 = time.perf_counter()
    try:
        aggregate.verify_aggregated(airs, bad_agg, params)
    except (verifier.VerificationError, aggregate.AggregationError):
        pass
    else:
        raise AssertionError(f"{tag}: a tampered inner FRI value verified")
    log(f"[check] {tag}: tampered FRI value of inner proof {tamper_at} "
        f"rejected ({time.perf_counter() - t0:.1f} s)")

    digest = [int(v) for v in agg.outer["pub_inputs"]]
    wrapped = groth16_wrap.proof_from_json(groth16_json)
    t0 = time.perf_counter()
    if not groth16_wrap.wrap_verify(wrapped, digest):
        raise AssertionError(f"{tag}: wrap_verify rejected the wrap proof")
    wrong = list(digest)
    wrong[0] = (wrong[0] + 1) % 2013265921
    if groth16_wrap.wrap_verify(wrapped, wrong):
        raise AssertionError(f"{tag}: wrap_verify accepted a wrong digest")
    log(f"[check] {tag}: wrap proof verified, wrong digest rejected "
        f"({time.perf_counter() - t0:.1f} s)")


def check_path_job(tag, airs, proofs, out, params, keys) -> None:
    """Runs in a child: `check_path` on a groth16 path's results (host
    Python only, so it runs beside the card's later phases), with the
    wrap keys the parent proved with."""
    from ethrex_tpu_torch.prover import groth16_wrap

    torch.set_num_threads(1)
    groth16_wrap.use_keys(keys)
    check_path(tag, dict(airs=airs, proofs=proofs, out=out, params=params))


def check_path(tag, result) -> None:
    """The verifiers accept what a groth16 path made and reject tampers:
    every inner proof (a tampered public input of each but the binding
    proof), the aggregate (a tampered FRI value of the first VM proof,
    else of the state proof) and the wrap."""
    params = result["params"]
    out = result["out"]
    inners = [out["state_proof"], out["proof"]]
    names = ["state", "binding"]
    for key, name in (("vm_proof", "transfer"), ("tok_proof", "token")):
        if key in out:
            inners.append(out[key])
            names.append(name)
    inners += out.get("bc_proofs", [])
    names += ["bytecode"] * len(out.get("bc_proofs", []))
    t0 = time.perf_counter()
    tamper = [n for n in names if n != "binding"]
    check_inner(names, result["airs"], result["proofs"], params,
                tamper=tamper)
    log(f"[check] {tag}: the {len(names)} inner proofs verified, tampered "
        f"public inputs of the {', '.join(tamper)} proofs rejected "
        f"({time.perf_counter() - t0:.1f} s)")
    # the aggregate carries them path-stripped, under the reference's keys
    check_formats(tag, result["airs"], inners, out["aggregate"],
                  out["groth16"], params,
                  tamper_at=2 if len(inners) > 2 else 0)


def two_proof_path(dev, rng) -> dict:
    """The earlier slice's path, still driven: a state proof and a
    512-limb (64-chunk) binding proof, then `gpu_backend.prove_formats(...,
    "groth16")` over the two, with the launch counts zeroed just before
    and read just after, then checked by the verifiers.  Its state proof
    is cut from 1,002 keys to 126 (1,023 writes to 127: n = 2^16 x 115,
    so the outer proof is 2^20 x 90) to keep the smoke short; the VM path
    proves the full-size state."""
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.prover import gpu_backend
    from ethrex_tpu_torch.stark import prover

    params = gpu_backend.PARAMS
    t0 = time.perf_counter()
    st_air, st_trace, st_pub = state_job(rng, num_keys=126, num_writes=127)
    bd_air, bd_trace, bd_pub = binding_job(rng, limbs=512)
    encoded = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    log(f"[two-proof] host trace generation {time.perf_counter() - t0:.1f} "
        f"s: state {st_trace.shape}, binding {bd_trace.shape}")
    if bd_trace.shape[0] != 2048:
        raise AssertionError(f"binding trace shape {bd_trace.shape}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t_path = time.perf_counter()
    st_proof = prover.prove(st_air, st_trace, st_pub, params, device=dev)
    bd_proof = prover.prove(bd_air, bd_trace, bd_pub, params, device=dev)
    fmt_stats: dict = {}
    formats = gpu_backend.prove_formats(
        [st_air, bd_air], [st_proof, bd_proof], encoded, "groth16",
        device=dev, params=params, stats=fmt_stats)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    agg_stats = fmt_stats["aggregate"]
    log(f"[two-proof] groth16 path {path_s:.3f} s (outer FriVerifyAir "
        f"{agg_stats['trace_shape']}, {agg_stats['items']} items, host "
        f"trace {agg_stats['trace_s']:.1f} s, proof "
        f"{agg_stats['outer']['total_s']:.3f} s); peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in NOT_ON_GROTH16_PATHS
               and k != "bn254_msm_bases"]
    if missing:
        raise AssertionError(f"kernels not launched on the two-proof path: "
                             f"{missing}")
    check_wrap_msms("two-proof path", launches, tables=0)
    # the batch-proof keys that `check_path` reads
    out = dict(formats, state_proof=formats["inner"][0],
               proof=formats["inner"][1])
    return dict(launches=launches, path_s=path_s, peak_bytes=peak,
                airs=[st_air, bd_air], proofs=[st_proof, bd_proof], out=out,
                params=params)


def small_cross_check(dev, rng) -> None:
    """A small state proof made on the card equals the same proof made by
    the plain versions on the CPU (the CPU tests hold those against the
    JAX package)."""
    from ethrex_tpu_torch.stark import prover

    params = prover.StarkParams(log_blowup=3, num_queries=25,
                                log_final_size=4)
    air, trace, pub = state_job(rng, num_keys=4, num_writes=3)
    t0 = time.perf_counter()
    on_card = prover.prove(air, trace, pub, params, device=dev)
    on_cpu = prover.prove(air, trace, pub, params, device="cpu")
    if json.dumps(on_card, sort_keys=True) != json.dumps(on_cpu,
                                                        sort_keys=True):
        raise AssertionError("small proof: card and CPU proofs differ")
    log(f"[check] small state proof (n={trace.shape[0]}): card == CPU "
        f"({time.perf_counter() - t0:.1f} s)")


def fused_step(dev) -> dict:
    """The second entry point: `parallel.core.build_prove_step` at the
    reference's core-bench shape (log_n 15, width 64), held equal to the
    same step run with the plain versions on the CPU, then at log_n 20;
    each driven with the launch counts zeroed just before and read just
    after, and timed (CUDA events, median of 3 after a warm-up)."""
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.parallel.core import build_prove_step

    rows = {}
    launches = {}
    for log_n in (15, 20):
        step, args = build_prove_step(log_n, 64, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        troot, roots, cw = step(*args)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
        need = ("ntt", "poseidon2_hash_leaves", "poseidon2_merkle_subtree",
                "mod_matmul", "fri_fold", "deep_compose",
                "merkle_batched_level", "ext_poly_eval")
        missing = [k for k in need if got[k] <= 0]
        if missing:
            raise AssertionError(f"fused step (log_n {log_n}) did not "
                                 f"launch {missing}")
        # K10 builds the forest in a few launches, K11 the one table
        if got["merkle_batched_level"] > K10_LAUNCHES[log_n] or \
                got["ext_poly_eval"] != 1:
            raise AssertionError(
                f"fused step (log_n {log_n}): merkle_batched_level "
                f"launched {got['merkle_batched_level']} times (at most "
                f"{K10_LAUNCHES[log_n]}), ext_poly_eval "
                f"{got['ext_poly_eval']} (1 expected)")
        if cw.shape != (32, 4) or len(roots) != log_n + 2 - 5:
            raise AssertionError("fused step: unexpected output shapes")
        if log_n == 15:
            t0 = time.perf_counter()
            step_c, args_c = build_prove_step(log_n, 64, device="cpu")
            want = step_c(*args_c)
            cpu_s = time.perf_counter() - t0
            if not (torch.equal(troot.cpu(), want[0])
                    and all(torch.equal(a.cpu(), b)
                            for a, b in zip(roots, want[1]))
                    and torch.equal(cw.cpu(), want[2])):
                raise AssertionError("fused step: card and CPU differ")
            log(f"[fused] log_n 15 x 64: card == plain versions on the CPU "
                f"(troot, {len(roots)} FRI roots, final codeword; CPU "
                f"{cpu_s:.1f} s)")
        ms = cuda_ms(lambda: step(*args), 3)
        b_ms = fused_bound_ms(log_n)
        rows[log_n] = dict(ms=ms, bound_ms=b_ms, launches=got)
        log(f"[fused] log_n {log_n} x 64 (LDE 2^{log_n + 2}): {ms:.3f} ms "
            f"per step (bound {b_ms:.3f} ms, the sum of its kernels'); "
            f"launches {json.dumps(got)}")
        del step, args
        torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches)


def build_all() -> None:
    """Every kernel source of the path, one nvcc each, all at once."""
    import threading

    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.stark import air_codegen

    t0 = time.perf_counter()
    texts = [air_codegen.cuda_source(air_codegen.record(air), mode=mode)[0]
             for mode in air_codegen.MODES
             for air, _, _ in path_airs().values()]
    # the resume drill's two AIRs of other shapes (its combine kernels)
    texts += [air_codegen.cuda_source(air_codegen.record(air),
                                      mode="combine")[0]
              for air in drill_airs()]
    errors = []

    def static():
        try:
            kernels.build(verbose=True)
        except Exception as e:           # re-raised below, in the caller
            errors.append(e)

    th = threading.Thread(target=static)
    th.start()
    kernels.build_generated(texts)
    th.join()
    if errors:
        raise errors[0]
    kernels.lib()
    names = [f"{name} {mode}" for mode in air_codegen.MODES
             for name in path_airs()]
    gen = {name: round(kernels.GENERATED_BUILD_S.get(
        kernels._generated_key(t), 0.0), 1)
        for name, t in zip(names, texts)}
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s; nvcc s per generated AIR "
        f"source {json.dumps(gen)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import concurrent.futures
    import multiprocessing

    from ethrex_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # children: the wrap keys' host setup, then the host verification of
    # the two VM-mode paths, each beside the card's later phases
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=3,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        keys_future = pool.submit(wrap_keys_job)
        build_all()
        rng = np.random.default_rng(SEED)
        rows = check_kernels(dev, rng)
        rows.update(check_air_kernels(dev, rng))
        rows.update(check_batch_inv(dev, rng))
        rows.update(check_ext_glue(dev, rng))
        rows["merkle_batched_level"] = check_batched_roots(dev, rng)
        rows.update(check_slice4_kernels(dev, rng))
        log(f"[phase] build and kernel checks done at "
            f"{time.perf_counter() - t_start:.1f} s")
        # the fused step needs no wrap keys: it runs while they finish
        fused = fused_step(dev)
        log(f"[phase] fused step done at "
            f"{time.perf_counter() - t_start:.1f} s")
        keys = install_wrap_keys(keys_future)
        mode_future = pool.submit(expected_mode_job, "baseline3")
        executed = executed_path(dev, mode_future)
        log(f"[phase] executed path done at "
            f"{time.perf_counter() - t_start:.1f} s")
        prof = profile_path(dev, executed)
        del executed["traces"]
        log(f"[phase] profile done at {time.perf_counter() - t_start:.1f} s")
        checks = [pool.submit(check_path_job, "executed path",
                              executed["airs"], executed["proofs"],
                              executed["out"], executed["params"], keys)]
        verify_future = pool.submit(verify_job, executed["out"], keys)
        result = main_path(dev, rng)
        log(f"[phase] synthesized VM path done at "
            f"{time.perf_counter() - t_start:.1f} s")
        checks.append(pool.submit(check_path_job, "synthesized VM path",
                                  result["airs"], result["proofs"],
                                  result["out"], result["params"], keys))
        two = two_proof_path(dev, rng)
        checks.append(pool.submit(check_path_job, "two-proof path",
                                  two["airs"], two["proofs"], two["out"],
                                  two["params"], keys))
        log(f"[phase] two-proof path done at "
            f"{time.perf_counter() - t_start:.1f} s")
        oom_drill(dev, np.random.default_rng(SEED + 1))
        resume_drill(dev)
        log(f"[phase] OOM and resume drills done at "
            f"{time.perf_counter() - t_start:.1f} s")
        from ethrex_tpu_torch.prover import groth16_wrap

        r1cs, layout, pk, _vk = groth16_wrap.wrap_keys()
        digest = [int(v) for v in executed["out"]["aggregate"]["outer"][
            "pub_inputs"]]
        wraps = profile_wrap(dev, digest)
        log(f"[phase] wrap profile done at "
            f"{time.perf_counter() - t_start:.1f} s")
        z = groth16_wrap.wrap_witness(digest, r1cs, layout)
        rows.update(check_msm(dev, pk, (r1cs, z), 1 + r1cs.num_pub))
        log(f"[phase] K5 checks done at "
            f"{time.perf_counter() - t_start:.1f} s")
        # the executed path's wrap was its process's first: it built the
        # tables
        wrap = wraps["first"]
        for name, kind in (("bn254_msm_g1", "g1"), ("bn254_msm_g2", "g2"),
                           ("bn254_msm_bases", "bases")):
            rows[name]["launches_per_call"] = wrap["launches_per_call"][kind]
            rows[name]["wrap_device_ms"] = {
                k: w["k5_ms"][kind] for k, w in wraps.items()}
        small_cross_check(dev, rng)
        t0 = time.perf_counter()
        for f in checks:
            f.result()
        walls = verify_future.result()
        log(f"[verify] in a child on the card's host, GpuBackend(device="
            f"'cpu').verify_with_input accepted the executed path's "
            f"submitted groth16 proof in {walls['honest']:.3f} s and "
            f"rejected it with one output byte flipped "
            f"({walls['output_byte']:.3f} s) and with its vm metadata "
            f"removed ({walls['vm_removed']:.3f} s)")
        log(f"[phase] the paths' host checks done at "
            f"{time.perf_counter() - t_start:.1f} s (waited "
            f"{time.perf_counter() - t0:.1f} s)")
    log(f"[end] smoke wall {time.perf_counter() - t_start:.1f} s")

    path_ms: dict = {}
    # the STARKs' profile, and the first wrap's for K5
    for fn, ms in list(prof["per_kernel"].items()) + list(
            wrap["by_fn"].items()):
        key = _kernel_key(fn)
        if key:
            path_ms[key] = path_ms.get(key, 0.0) + ms
    out = []
    for name, src in kernels.KERNELS.items():
        row = rows[name]
        exe_n = executed["launches"][name]
        vm_n = result["launches"][name]
        fused_n = fused["launches"].get(name, 0)
        two_n = two["launches"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"ethrex_tpu_torch/{src}",
            "replaces": REPLACES[name],
            "launches": exe_n + vm_n + fused_n + two_n,
            "launches_by_path": {"executed_groth16": exe_n,
                                 "vm_groth16": vm_n, "fused_step": fused_n,
                                 "two_proof_groth16": two_n},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"],
            "path_device_ms": path_ms.get(name, 0.0),
            **({"at_shapes": row["at_shapes"]} if "at_shapes" in row
               else {}),
            **({"per_air": row["per_air"]} if "per_air" in row else {}),
            **({k: row[k] for k in ("at_state_shape",
                                    "at_executed_state_shape")
                if k in row}),
            **{k: row[k] for k in ("wrapper_ms", "bound_ms_double_and_add",
                                   "bound_ms_reduced_products",
                                   "bound_ms_old_count", "fused_step_table",
                                   "at_log_n_15",
                                   "bound_ms_unfused", "ptxas",
                                   "launches_per_call", "wrap_device_ms",
                                   "device_ms_by_function") if k in row},
        })
    log(f"[earlier] each kernel's time before its current design "
        f"(PERF.md's kernel table, in braces; NVIDIA H100 80GB HBM3, "
        f"700 W), not measured in this run: {json.dumps(EARLIER_MS)}")
    log(json.dumps({"kernels": out, "fused_step": {
        str(k): {"ms": v["ms"], "bound_ms": v["bound_ms"]}
        for k, v in fused["rows"].items()},
        "profile_source": prof["source"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# device function (csrc/*.cu) -> its kernel's KERNELS name, to sum the
# profile's device time per kernel; the generated K6 kernels are air_k*
DEVICE_FUNCTIONS = {
    "k_ntt_pass": "ntt", "k_hash_leaves": "poseidon2_hash_leaves",
    "k_subtree": "poseidon2_merkle_subtree", "k_rows": "mod_matmul",
    "k_splitk": "mod_matmul", "k_splitk_finish": "mod_matmul",
    "k_fold": "fri_fold", "k_batch_inv": "batch_inv",
    "k_divisor_inv": "divisor_inv",
    **{f: "bn254_msm_g1" for f in K5_FUNCTIONS},
    **{f + "<Fp2>": "bn254_msm_g2" for f in K5_FUNCTIONS},
    **{f: "bn254_msm_bases" for f in K5_BASES_FUNCTIONS},
    **{f + "<Fp2>": "bn254_msm_bases" for f in K5_BASES_FUNCTIONS},
    "k_deep": "deep_compose",
    "k_quotient": "quotient_combine",
    "k_forest": "merkle_batched_level",
    "k_open": "ext_poly_eval", "k_ext_inv": "ext_inv",
    "k_ext_batch_inv": "ext_batch_inv", "k_eval_poly_at": "eval_poly_at",
    "k_to_mont_cols": "to_mont_cols"}

REPLACES = {
    "ntt": "ethrex_tpu/ops/ntt.py:51",
    "poseidon2_hash_leaves": "ethrex_tpu/ops/poseidon2.py:232",
    "poseidon2_merkle_subtree": "ethrex_tpu/ops/merkle.py:22",
    "mod_matmul": "ethrex_tpu/ops/babybear.py:191",
    "fri_fold": "ethrex_tpu/ops/fri.py:49",
    "air_constraints": "ethrex_tpu/stark/prover.py:527",
    "air_combine": "ethrex_tpu/stark/prover.py:527",
    "batch_inv": "ethrex_tpu/ops/babybear.py:147",
    "divisor_inv": "ethrex_tpu/stark/prover.py:516",
    "bn254_msm_g1": "ethrex_tpu/ops/bn254_msm.py:308",
    "bn254_msm_g2": "ethrex_tpu/ops/bn254_msm.py:308",
    "bn254_msm_bases": "ethrex_tpu/ops/bn254_msm.py:308",
    "deep_compose": "ethrex_tpu/stark/prover.py:565",
    "quotient_combine": "ethrex_tpu/stark/prover.py:540",
    "merkle_batched_level": "ethrex_tpu/ops/merkle.py:60",
    "ext_poly_eval": "ethrex_tpu/ops/ext.py:175",
    "ext_inv": "ethrex_tpu/ops/ext.py:183",
    "ext_batch_inv": "ethrex_tpu/ops/ext.py:209",
    "eval_poly_at": "ethrex_tpu/ops/ntt.py:166",
    "to_mont_cols": "ethrex_tpu/ops/babybear.py:117",
}


if __name__ == "__main__":
    sys.exit(main())
