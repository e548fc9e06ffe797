"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases:
  1. the card's name and power limit (nvidia-smi); the Groth16 wrap's key
     setup (host bignum work, minutes) starts in a child process and runs
     beside every later phase;
  2. build the CUDA kernels from ethrex_tpu_torch/csrc and the generated
     AIR constraint kernels of the path's three AIRs, one nvcc per source,
     all started together;
  3. hold every kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it (bit-equal), and time both with
     CUDA events: K1-K4 and K7 at the state / outer proof shapes, K6 once
     per AIR (FriVerifyAir at its full 2^24-point LDE);
  4. the main path, with the launch counts zeroed just before and read
     just after: `ethrex_tpu_torch.stark.prover.prove` on the state proof
     of a 1,000-transfer-shaped batch (1,002 touched keys, 1,023 writes:
     n = 2^19 rows x 115 columns, LDE 2^22) and on the binding proof
     (Poseidon2SpongeAir over a 512-limb message), then
     `prover.gpu_backend.prove_formats(..., "groth16")`: the recursive
     aggregation of both into one outer FriVerifyAir STARK and the Groth16
     wrap of its digest (BN254 MSMs, kernel K5);
  5. checks: the port's verifier accepts both inner proofs and rejects a
     tampered public input; `verify_aggregated` accepts the aggregate and
     rejects a tampered inner FRI value; `wrap_verify` accepts the wrap
     and rejects a wrong digest; K5 against its plain version on the
     wrap's own MSM inputs; a small state proof made on the card equals
     the same proof made by the plain versions on the CPU;
  6. one JSON line with every kernel's launches, error and times, then
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
# IMAD slots per BN254 Montgomery product (csrc/bn254_msm.cu `mul`): 8 x 8
# wide a_i*b_j and 8 x 8 wide m*p_j (IMAD.WIDE.U32, 2 slots each) plus 8
# low products m = t0 * NP (IMAD, 1 slot); an Fp2 product is 3 of them
SLOTS_PER_BN254_MUL = 2 * 128 + 8
# products of a Jacobian doubling and addition (csrc/bn254_msm.cu
# `pdbl`, `padd`)
BN254_DBL_MULS = 7
BN254_ADD_MULS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, products: float,
             slots_per_product: int = SLOTS_PER_MONT) -> tuple[float, str]:
    """Least time for `nbytes` of traffic and `products` Montgomery
    products: the larger of the two."""
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

def check_kernels(dev, rng) -> dict:
    from ethrex_tpu_torch.ops import babybear as bb
    from ethrex_tpu_torch.ops import fri
    from ethrex_tpu_torch.ops import ntt
    from ethrex_tpu_torch.ops import poseidon2 as p2

    n, w, lb, K = 1 << 19, 115, 3, 159
    N = n << lb
    rows = {}

    # K1: the trace LDE (115, 2^19) -> (115, 2^22) as the prover runs it
    # (an iNTT, then the forward transform with the coset pre-scale and
    # zero pad); plus the other transform shapes of the path, checked only
    x = field(rng, (w, n), dev)
    pre = ntt.lde_prescale(19, bb.GENERATOR, dev)
    coeffs = ntt.scaled_ntt(x, inverse=True)
    err0, ms0, pms0 = compare(
        "ntt (iNTT 115 x 2^19)",
        lambda: ntt.scaled_ntt(x, inverse=True),
        lambda: ntt.scaled_ntt_plain(x, inverse=True), plain_reps=1)
    err1, ms1, pms1 = compare(
        "ntt (LDE 115 x 2^19 -> 2^22)",
        lambda: ntt.scaled_ntt(coeffs, n_out=N, pre=pre),
        lambda: ntt.scaled_ntt_plain(coeffs, n_out=N, pre=pre), plain_reps=1)
    io_bytes = 4 * (w * n + w * n) + 4 * (w * n + w * N)
    muls = w * ((n // 2) * 19 + (N // 2) * 22 + n)
    b_ms, b_by = bound_ms(io_bytes, muls)
    rows["ntt"] = dict(max_abs_err=max(err0, err1), ms=ms0 + ms1,
                       plain_ms=pms0 + pms1, bound_ms=b_ms, bound_by=b_by,
                       shape="coset LDE (115, 2^19) -> (115, 2^22)")
    del coeffs
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

    # K2: leaf hash of the LDE rows, read in place from (115, 2^22)
    lde = field(rng, (w, N), dev)
    err, ms, pms = compare(
        "poseidon2_hash_leaves (2^22 x 115)",
        lambda: p2.hash_leaves(lde.T), lambda: p2.hash_leaves_plain(lde.T),
        plain_reps=1)
    perms = N * (-(-w // 8))
    b_ms, b_by = bound_ms(4 * (w * N + 8 * N), perms * 772)
    rows["poseidon2_hash_leaves"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        shape="trace leaves (2^22, 115)")
    del lde
    log(f"[kernels] poseidon2_hash_leaves ok: {rows['poseidon2_hash_leaves']}")
    cw = field(rng, (1 << 20, 4), dev)   # an FRI layer, paired in place
    if not torch.equal(p2.hash_leaves(fri.pair_leaves(cw)),
                       p2.hash_leaves_plain(fri.pair_leaves(cw))):
        raise AssertionError("hash_leaves on paired FRI leaves differs")
    del cw

    level = field(rng, (N, 8), dev)
    err, ms, pms = compare(
        "poseidon2_compress_level (2^22 -> 2^21)",
        lambda: p2.compress_level(level),
        lambda: p2.compress_level_plain(level), plain_reps=1)
    b_ms, b_by = bound_ms(4 * (N * 8 + N // 2 * 8), (N // 2) * 772)
    rows["poseidon2_compress_level"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
        shape="first tree level (2^22, 8) -> (2^21, 8)")
    del level
    log(f"[kernels] poseidon2_compress_level ok: "
        f"{rows['poseidon2_compress_level']}")

    # K3: the alpha combination (2^22, 159) @ (159, 4), read in place from
    # the (159, 2^22) constraint stack; also the open phase's (115, 2^19)
    # @ (2^19, 4) (split-k) and the canonical mode, checked only
    cons = field(rng, (K, N), dev)
    apow = field(rng, (K, 4), dev)
    err, ms, pms = compare(
        "mod_matmul ((2^22, 159) @ (159, 4))",
        lambda: bb.mod_matmul(cons.T, apow),
        lambda: bb.mod_matmul_plain(cons.T, apow), plain_reps=1)
    b_ms, b_by = bound_ms(4 * (K * N + K * 4 + N * 4), N * K * 4)
    rows["mod_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                              bound_ms=b_ms, bound_by=b_by,
                              shape="alpha combination (2^22, 159) @ (159, 4)")
    del cons
    for a_shape, k in (((w, n), n), ((4096, 128), 128), ((64, 8192), 8192)):
        a = field(rng, a_shape, dev)
        b = field(rng, (k, 4), dev)
        for mont in (True, False):
            if not torch.equal(bb.mod_matmul(a, b, mont),
                               bb.mod_matmul_plain(a, b, mont)):
                raise AssertionError(f"mod_matmul {a_shape} montgomery="
                                     f"{mont}: kernel differs")
        del a, b
    log(f"[kernels] mod_matmul ok: {rows['mod_matmul']}")

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


def path_airs():
    """The AIRs of the main path at their full size: the state proof's
    StateUpdateAir (depth 10, 16-period segments), the binding proof's
    Poseidon2SpongeAir (64 chunks) and the outer FriVerifyAir over both
    (the deepest FRI layer-0 path has depth 21, so 32-period segments)."""
    from ethrex_tpu_torch.models import fri_verifier_air as fva
    from ethrex_tpu_torch.models import poseidon2_air as pair
    from ethrex_tpu_torch.models import state_update_air as sua

    return {"StateUpdateAir": (sua.StateUpdateAir(10, seg_periods=16),
                               1 << 19),
            "Poseidon2SpongeAir": (pair.Poseidon2SpongeAir(64), 1 << 11),
            "FriVerifyAir": (fva.FriVerifyAir(21), 1 << 21)}


def check_air_kernels(dev, rng) -> dict:
    """K6 for each AIR of the path at its LDE size (blowup 8), against
    the DeviceOps evaluation with its rolled LDE."""
    from ethrex_tpu_torch.stark import air_codegen

    per_air = []
    for name, (air, n) in path_airs().items():
        N = n << 3
        graph = air_codegen.record(air)
        lde = field(rng, (air.width, N), dev)
        per = field(rng, (air.num_periodic, N), dev)
        err, ms, pms = compare(
            f"air_constraints {name} ({air.width} x {N})",
            lambda: air_codegen.evaluate(air, lde, per, 8),
            lambda: air_codegen.evaluate_plain(air, lde, per, 8),
            plain_reps=1)
        K = graph.num_constraints
        counts = graph.counts()
        b_ms, b_by = bound_ms(4 * (air.width + air.num_periodic + K) * N,
                              counts["mul"] * N)
        per_air.append(dict(air=name, shape=f"({air.width}, {N}) -> ({K}, "
                            f"{N})", kernels=len(air_codegen.groups(graph)),
                            nodes=sum(counts.values()), muls=counts["mul"],
                            max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] air_constraints {name} ok: {per_air[-1]}")
        del lde, per
        torch.cuda.empty_cache()
    big = per_air[-1]            # the outer FriVerifyAir, the largest
    return dict(max_abs_err=max(r["max_abs_err"] for r in per_air),
                ms=big["ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                shape=f"FriVerifyAir {big['shape']}", per_air=per_air)


def check_batch_inv(dev, rng) -> dict:
    """K7 on the outer proof's divisor stack: B + N + nb N elements for
    N = 2^24 and the FriVerifyAir's 10 boundary rows."""
    from ethrex_tpu_torch.ops import babybear as bb

    N = 1 << 24
    n = 8 + N + 10 * N
    a = field(rng, (n,), dev)
    a[a == 0] = bb.MONT_ONE
    err, ms, pms = compare("batch_inv", lambda: bb.batch_mont_inv(a),
                           lambda: bb.batch_mont_inv_plain(a), plain_reps=1)
    chunks = -(-n // bb._INV_CHUNK)
    b_ms, b_by = bound_ms(4 * 2 * n, 3 * n + 45 * chunks)
    del a
    torch.cuda.empty_cache()
    row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
               bound_by=b_by, shape=f"outer divisor stack ({n},)")
    log(f"[kernels] batch_inv ok: {row}")
    return row


def msm_products(bit_rows: np.ndarray, live: np.ndarray) -> int:
    """Field products the MSM kernel does on these inputs: a doubling per
    bit of every finite point, an addition per set bit after a point's
    first, and the tree's additions."""
    pop = bit_rows.sum(axis=1).astype(np.int64)
    nbits = bit_rows.shape[1]
    n_live = int(live.sum())
    return int(n_live * nbits * BN254_DBL_MULS
               + (np.maximum(pop - 1, 0) * live).sum() * BN254_ADD_MULS
               + max(n_live - 1, 0) * BN254_ADD_MULS)


def check_msm(dev, pk, z, n_pub) -> dict:
    """K5 against its plain version on the wrap's own MSM inputs: the G1
    MSM over k_query + h_query (the largest) and the G2 MSM over
    b2_query, with the witness of the main path's wrap."""
    from ethrex_tpu_torch.crypto import groth16
    from ethrex_tpu_torch.ops import bn254_msm as msm_ops

    r1cs, zz = z
    h = groth16._h_coeffs(r1cs, zz, groth16._domain_size(r1cs))
    rows = {}
    for name, pts, scalars, fp2 in (
            ("bn254_msm_g1", pk.k_query + pk.h_query,
             list(zz[n_pub:]) + h, False),
            ("bn254_msm_g2", pk.b2_query, list(zz), True)):
        conv = msm_ops.g2_points_to_device if fp2 else \
            msm_ops.points_to_device
        X, Y, Z = conv(pts, dev)
        nbits = max(1, max(int(s) % msm_ops.bn254.R
                           for s in scalars).bit_length())
        bits_np = msm_ops.scalars_to_bits(scalars, nbits)
        bits = torch.from_numpy(bits_np.view(np.int32)).to(dev)

        def kern():
            return torch.stack(msm_ops.msm_device(X, Y, Z, bits, fp2))

        def plain():
            return torch.stack(msm_ops.msm_device_plain(X, Y, Z, bits, fp2))

        got = kern()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version")
        ms = cuda_ms(kern, 3)
        live = np.array([p is not None for p in pts])
        prods = msm_products(bits_np, live) * (3 if fp2 else 1)
        words = (2 if fp2 else 1) * 16
        b_ms, b_by = bound_ms(4 * (3 * len(pts) * words + bits_np.size
                                   + 3 * words), prods, SLOTS_PER_BN254_MUL)
        rows[name] = dict(max_abs_err=0, ms=ms,
                          plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                          shape=f"{len(pts)} points x {nbits} bits")
        log(f"[kernels] {name} ok: {rows[name]}")
    return rows


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


def schedule_for(depth: int) -> int:
    """seg_periods for a tree depth (the backend's `_schedule_for`)."""
    return max(8, 1 << (depth + 4).bit_length())


def state_job(rng, num_keys, num_writes):
    from ethrex_tpu_torch.models import state_update_air as sua

    tree, r_pre, accesses, depth = state_batch(rng, num_keys, num_writes)
    S = schedule_for(depth)
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


def make_jobs(rng):
    """The batch's two inner proof jobs (host trace generation)."""
    t0 = time.perf_counter()
    state = state_job(rng, num_keys=1002, num_writes=1023)
    binding = binding_job(rng, limbs=512)
    log(f"[main] host trace generation {time.perf_counter() - t0:.1f} s: "
        f"state {state[1].shape} (depth {state[0].depth}, seg_periods "
        f"{state[0].seg_periods}), binding {binding[1].shape}")
    if state[1].shape != (1 << 19, 115):
        raise AssertionError(f"state trace shape {state[1].shape}")
    return state, binding


def main_path(dev, rng, keys_future) -> dict:
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.prover import gpu_backend
    from ethrex_tpu_torch.prover import groth16_wrap
    from ethrex_tpu_torch.stark import prover

    params = gpu_backend.PARAMS
    (st_air, st_trace, st_pub), (bd_air, bd_trace, bd_pub) = make_jobs(rng)
    encoded = bytes(rng.integers(0, 256, 64, dtype=np.uint8))

    # the wrap keys come from the child (host setup); the wrap needs them
    t0 = time.perf_counter()
    keys, keys_s = keys_future.result()
    groth16_wrap.use_keys(keys)
    log(f"[main] wrap_keys host setup {keys_s:.1f} s in the child "
        f"(waited {time.perf_counter() - t0:.1f} s): "
        f"{len(keys[0].constraints)} constraints, {keys[0].num_vars} "
        f"variables, domain {keys[2].domain_size}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t_main = time.perf_counter()
    st_proof, st_stats = prover.prove_with_stats(st_air, st_trace, st_pub,
                                                 params, device=dev)
    bd_proof, bd_stats = prover.prove_with_stats(bd_air, bd_trace, bd_pub,
                                                 params, device=dev)
    torch.cuda.synchronize()
    inner_s = time.perf_counter() - t_main
    inner_launches = dict(kernels.LAUNCHES)
    fmt_stats: dict = {}
    t_fmt = time.perf_counter()
    formats = gpu_backend.prove_formats(
        [st_air, bd_air], [st_proof, bd_proof], encoded, "groth16",
        device=dev, params=params, stats=fmt_stats)
    torch.cuda.synchronize()
    formats_s = time.perf_counter() - t_fmt
    main_s = time.perf_counter() - t_main
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    agg_stats = fmt_stats["aggregate"]
    outer = agg_stats["outer"]
    log(f"[main] state proof phases (s): {json.dumps(st_stats['phase_s'])} "
        f"total {st_stats['total_s']:.3f}")
    log(f"[main] binding proof phases (s): {json.dumps(bd_stats['phase_s'])} "
        f"total {bd_stats['total_s']:.3f}")
    log(f"[main] inner proofs {inner_s:.3f} s; launches "
        f"{json.dumps(inner_launches)}")
    log(f"[main] outer FriVerifyAir: {agg_stats['items']} items, trace "
        f"{agg_stats['trace_shape']} (N = {outer['N']}, "
        f"{outer['num_constraints']} constraints), host trace generation "
        f"{agg_stats['trace_s']:.1f} s")
    log(f"[main] outer proof phases (s): {json.dumps(outer['phase_s'])} "
        f"total {outer['total_s']:.3f}")
    log(f"[main] prove_formats(groth16) {formats_s:.3f} s: aggregate "
        f"{agg_stats['trace_s'] + outer['total_s']:.3f} s, wrap "
        f"{formats_s - agg_stats['trace_s'] - outer['total_s']:.3f} s")
    log(f"[main] whole groth16 path {main_s:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return dict(launches=launches, airs=[st_air, bd_air],
                proofs=[st_proof, bd_proof], formats=formats,
                state=st_stats, binding=bd_stats, outer=outer,
                main_s=main_s, peak_bytes=peak, params=params)


def check_main_path(result) -> None:
    """The verifiers accept what the main path made and reject tampers."""
    from ethrex_tpu_torch.prover import groth16_wrap
    from ethrex_tpu_torch.stark import aggregate, verifier

    params = result["params"]
    (st_air, bd_air), (st_proof, bd_proof) = result["airs"], result["proofs"]
    t0 = time.perf_counter()
    verifier.verify(st_air, st_proof, params)
    verifier.verify(bd_air, bd_proof, params)
    bad = dict(st_proof)
    bad["pub_inputs"] = list(st_proof["pub_inputs"])
    bad["pub_inputs"][8] = (bad["pub_inputs"][8] + 1) % 2013265921
    try:
        verifier.verify(st_air, bad, params)
    except verifier.VerificationError:
        pass
    else:
        raise AssertionError("a tampered public input verified")
    log(f"[check] both inner proofs verified, tamper rejected "
        f"({time.perf_counter() - t0:.1f} s)")

    fm = result["formats"]
    agg = aggregate.AggregateProof(
        inners=fm["inner"], outer=fm["aggregate"]["outer"],
        max_depth=fm["aggregate"]["max_depth"],
        seg_periods=fm["aggregate"]["seg_periods"])
    t0 = time.perf_counter()
    aggregate.verify_aggregated(result["airs"], agg, params)
    log(f"[check] verify_aggregated accepted the aggregate "
        f"({time.perf_counter() - t0:.1f} s)")
    bad_inner = json.loads(json.dumps(agg.inners[0]))
    val = bad_inner["fri"]["queries"][0][1]["values"][0]
    val[0] = (val[0] + 1) % 2013265921
    bad_agg = aggregate.AggregateProof(
        inners=[bad_inner] + agg.inners[1:], outer=agg.outer,
        max_depth=agg.max_depth, seg_periods=agg.seg_periods)
    t0 = time.perf_counter()
    try:
        aggregate.verify_aggregated(result["airs"], bad_agg, params)
    except (verifier.VerificationError, aggregate.AggregationError):
        pass
    else:
        raise AssertionError("a tampered inner FRI value verified")
    log(f"[check] tampered inner FRI value rejected "
        f"({time.perf_counter() - t0:.1f} s)")

    digest = [int(v) for v in agg.outer["pub_inputs"]]
    wrapped = groth16_wrap.proof_from_json(fm["groth16"])
    t0 = time.perf_counter()
    if not groth16_wrap.wrap_verify(wrapped, digest):
        raise AssertionError("wrap_verify rejected the wrap proof")
    wrong = list(digest)
    wrong[0] = (wrong[0] + 1) % 2013265921
    if groth16_wrap.wrap_verify(wrapped, wrong):
        raise AssertionError("wrap_verify accepted a wrong digest")
    log(f"[check] wrap proof verified, wrong digest rejected "
        f"({time.perf_counter() - t0:.1f} s)")


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


def build_all() -> None:
    """Every kernel source of the path, one nvcc each, all at once."""
    import threading

    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.stark import air_codegen

    t0 = time.perf_counter()
    texts = [air_codegen.cuda_source(air_codegen.record(air))[0]
             for air, _ in path_airs().values()]
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
    gen = {name: round(kernels.GENERATED_BUILD_S.get(
        kernels._generated_key(t), 0.0), 1)
        for name, t in zip(path_airs(), texts)}
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

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        keys_future = pool.submit(wrap_keys_job)
        build_all()
        rng = np.random.default_rng(SEED)
        rows = check_kernels(dev, rng)
        rows["air_constraints"] = check_air_kernels(dev, rng)
        rows["batch_inv"] = check_batch_inv(dev, rng)
        result = main_path(dev, rng, keys_future)
    check_main_path(result)
    from ethrex_tpu_torch.prover import groth16_wrap

    r1cs, layout, pk, _vk = groth16_wrap.wrap_keys()
    digest = [int(v) for v in result["formats"]["aggregate"]["outer"][
        "pub_inputs"]]
    z = groth16_wrap.wrap_witness(digest, r1cs, layout)
    rows.update(check_msm(dev, pk, (r1cs, z), 1 + r1cs.num_pub))
    small_cross_check(dev, rng)
    log(f"[end] smoke wall {time.perf_counter() - t_start:.1f} s")

    out = []
    for name, src in kernels.KERNELS.items():
        row = rows[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"ethrex_tpu_torch/{src}",
            "replaces": REPLACES[name],
            "launches": result["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"],
            **({"per_air": row["per_air"]} if "per_air" in row else {}),
        })
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


REPLACES = {
    "ntt": "ethrex_tpu/ops/ntt.py:51",
    "poseidon2_hash_leaves": "ethrex_tpu/ops/poseidon2.py:232",
    "poseidon2_compress_level": "ethrex_tpu/ops/poseidon2.py:222",
    "mod_matmul": "ethrex_tpu/ops/babybear.py:191",
    "fri_fold": "ethrex_tpu/ops/fri.py:49",
    "air_constraints": "ethrex_tpu/stark/prover.py:527",
    "batch_inv": "ethrex_tpu/ops/babybear.py:147",
    "bn254_msm_g1": "ethrex_tpu/ops/bn254_msm.py:308",
    "bn254_msm_g2": "ethrex_tpu/ops/bn254_msm.py:308",
}


if __name__ == "__main__":
    sys.exit(main())
