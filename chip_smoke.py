"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ethrex_tpu_torch/csrc with nvcc;
  3. hold every kernel against its plain PyTorch version on the card, at
     the shapes the full-size state proof gives it (bit-equal), and time
     both with CUDA events;
  4. the main path: `ethrex_tpu_torch.stark.prover.prove` on the state
     proof of a 1,000-transfer-shaped batch (1,002 touched keys, 1,023
     writes: n = 2^19 rows x 115 columns, LDE 2^22) and on the binding
     proof (Poseidon2SpongeAir over a 512-limb message), with the launch
     counts zeroed just before and read just after; both proofs are
     checked by the port's verifier, a tampered public input must be
     rejected, and a small state proof made on the card must equal the
     same proof made by the plain versions on the CPU;
  5. one JSON line with every kernel's launches, error and times, then
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


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, products: float) -> tuple[float, str]:
    """Least time for `nbytes` of traffic and `products` Montgomery
    products: the larger of the two."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = products * SLOTS_PER_MONT / IMAD_SLOTS_PER_S
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def field(rng, shape, dev):
    from ethrex_tpu_torch.ops import babybear as bb

    return bb.from_numpy(
        rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32),
        dev)


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

    def compare(name, kern, plain, kernel_reps=5, plain_reps=3):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max |diff| "
                                 f"{max_abs_err(got, want)})")
        err = max_abs_err(got, want)
        del got, want
        return err, cuda_ms(kern, kernel_reps), cuda_ms(plain, plain_reps)

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


def main_path(dev, rng) -> dict:
    from ethrex_tpu_torch import kernels
    from ethrex_tpu_torch.stark import prover, verifier

    params = prover.StarkParams(log_blowup=3, num_queries=40,
                                log_final_size=4)
    t0 = time.perf_counter()
    st_air, st_trace, st_pub = state_job(rng, num_keys=1002, num_writes=1023)
    bd_air, bd_trace, bd_pub = binding_job(rng, limbs=512)
    log(f"[main] host trace generation {time.perf_counter() - t0:.1f} s: "
        f"state {st_trace.shape} (depth {st_air.depth}, seg_periods "
        f"{st_air.seg_periods}), binding {bd_trace.shape}")
    if st_trace.shape != (1 << 19, 115):
        raise AssertionError(f"state trace shape {st_trace.shape}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t_main = time.perf_counter()
    st_proof, st_stats = prover.prove_with_stats(st_air, st_trace, st_pub,
                                                 params, device=dev)
    bd_proof, bd_stats = prover.prove_with_stats(bd_air, bd_trace, bd_pub,
                                                 params, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[main] state proof phases (s): {json.dumps(st_stats['phase_s'])} "
        f"total {st_stats['total_s']:.3f}")
    log(f"[main] binding proof phases (s): {json.dumps(bd_stats['phase_s'])} "
        f"total {bd_stats['total_s']:.3f}")
    log(f"[main] both proofs {main_s:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

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
    log(f"[main] both proofs verified, tamper rejected "
        f"({time.perf_counter() - t0:.1f} s)")
    return dict(launches=launches, state=st_stats, binding=bd_stats,
                main_s=main_s, peak_bytes=peak)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from ethrex_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    rows = check_kernels(dev, rng)
    result = main_path(dev, rng)
    small_cross_check(dev, rng)

    out = []
    for name, src in kernels.KERNELS.items():
        row = rows[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"ethrex_tpu_torch/csrc/{src}",
            "replaces": REPLACES[name],
            "launches": result["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"],
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
}


if __name__ == "__main__":
    sys.exit(main())
