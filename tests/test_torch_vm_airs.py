"""The VM-mode AIRs of the port (TransferAir, TokenAir, BytecodeAir) and
the extension-field kernels' plain versions against the JAX package.

For each AIR, on the reference tests' small inputs (tests/test_transfer_
air.py, tests/test_token_air.py, the REGISTRY program of tests/test_
bytecode_air_rows.py): the trace and public inputs equal the reference's
(np.array_equal), the AIR's structure equals the reference's, the port's
recorded constraint graph (`air_codegen.interpret`) equals the reference
AIR's `constraints` under its eager DeviceOps on a small random LDE, and a
proof made by the port on the CPU is accepted by `ethrex_tpu.stark.
verifier` and by the port's verifier, both of which reject a tampered
public input.  The plain versions of kernels K8, K9 and K11 equal the
reference's `phase_deep` / `phase_quotient` / `phase_open` arithmetic on
the same inputs, and the backend's binding message equals the reference's.
The AIRs' port proofs come from one CPU run of `gpu_backend.
prove_vm_stages` over the three inputs as one VM batch, whose state and
binding proofs the reference's verifier also accepts.

Bar: exact equality everywhere (all arithmetic is exact).  The slow-marked
tests hold the port's CPU proofs JSON-equal to `ethrex_tpu.stark.prover.
prove`'s; the JAX prover's compiles take minutes per AIR, as in the
reference's own slow VM-AIR roundtrips.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethrex_tpu.guest import bytecode_vm as jbv
from ethrex_tpu.guest.transfer_log import TokSeg as JTokSeg
from ethrex_tpu.models import bytecode_air as jbca
from ethrex_tpu.models import token_air as jtka
from ethrex_tpu.models import transfer_air as jta
from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.ops import ext as jext
from ethrex_tpu.primitives.account import AccountState as JAccountState
from ethrex_tpu.stark import verifier as jverifier
from ethrex_tpu.stark.air import DeviceOps as JDeviceOps
from ethrex_tpu.stark.prover import StarkParams as JStarkParams
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.models import bytecode_air as bca
from ethrex_tpu_torch.models import token_air as tka
from ethrex_tpu_torch.models import transfer_air as ta
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import ext
from ethrex_tpu_torch.prover import gpu_backend
from ethrex_tpu_torch.stark import air_codegen
from ethrex_tpu_torch.stark import prover
from ethrex_tpu_torch.stark import verifier

PARAMS = prover.StarkParams(log_blowup=3, num_queries=25, log_final_size=4)
JAX_PARAMS = JStarkParams(log_blowup=3, num_queries=25, log_final_size=4)

SENDER, RECIP, CB = (bytes.fromhex(h * 20) for h in ("11", "22", "33"))
KF = int.from_bytes(b"\x11" * 32, "big")
KT = int.from_bytes(b"\x22" * 32, "big")
REGISTRY = bytes([
    0x60, 0x00, 0x35, 0x60, 0x20, 0x35, 0x80, 0x82, 0x54, 0x10,
    0x61, 0x00, 0x14, 0x57, 0x61, 0x03, 0xE8, 0x55, 0x50, 0x00,
    0x5B, 0x90, 0x55, 0x00,
])
REG_CALLDATA = (5).to_bytes(32, "big") + (42).to_bytes(32, "big")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _transfer_segs(value=1000, fee=21000 * 7, tip=21000 * 2, create=False):
    """The reference's segments (tests/test_transfer_air.py), plus a
    created coinbase and a no-op recipient, so every mux is exercised."""
    s_old = JAccountState(nonce=4, balance=10**18)
    s_new = JAccountState(nonce=5, balance=10**18 - value - fee)
    if create:
        r_old, r_new = None, JAccountState(nonce=0, balance=value)
    else:
        r_old = JAccountState(nonce=1, balance=500)
        r_new = JAccountState(nonce=1, balance=500 + value)
    s2 = JAccountState(nonce=6, balance=s_new.balance - fee)
    return [
        jta.TxSeg(SENDER, RECIP, s_old, s_new, r_old, r_new, value, fee,
                  tip, r_created=create, r_noop=False),
        jta.CbSeg(CB, JAccountState(nonce=0, balance=77),
                  JAccountState(nonce=0, balance=77 + tip), tip,
                  created=False, noop=False),
        jta.TxSeg(SENDER, bytes.fromhex("44" * 20), s_new, s2, None, None,
                  0, fee, tip, False, True),
        jta.CbSeg(bytes.fromhex("55" * 20), None,
                  JAccountState(nonce=0, balance=tip), tip, created=True,
                  noop=False),
    ]


def _token_segs():
    v1, v2 = 12345, (1 << 200) + 7
    return [JTokSeg(v1, KF, 10**6, 10**6 - v1, KT, 500, 500 + v1),
            JTokSeg(v2, KT, 1 << 220, (1 << 220) - v2, KF,
                    (1 << 24) - 1, (1 << 24) - 1 + v2),
            JTokSeg(0, 0, 0, 0, 0, 0, 0, noop=True)]


def _registry_call():
    pre = {5: 10}
    return jbv.run_trace(REGISTRY, REG_CALLDATA, b"\xaa" * 20, 0,
                         lambda s: pre.get(s, 0),
                         address=bytes.fromhex("abcd" * 10))


def _case(name):
    """(port AIR, reference AIR, port trace, reference trace, port pub,
    reference pub) of one AIR on its small input."""
    if name == "TransferAir":
        jsegs = _transfer_segs(create=True)
        segs = [convert.vm_seg(s) for s in jsegs]
        return (ta.TransferAir(), jta.TransferAir(),
                ta.generate_transfer_trace(segs),
                jta.generate_transfer_trace(jsegs),
                ta.transfer_public_inputs(segs),
                jta.transfer_public_inputs(jsegs))
    if name == "TokenAir":
        jsegs = _token_segs()
        segs = [convert.tok_seg(s) for s in jsegs]
        return (tka.TokenAir(), jtka.TokenAir(),
                tka.generate_token_trace(segs),
                jtka.generate_token_trace(jsegs),
                tka.token_public_inputs(segs),
                jtka.token_public_inputs(jsegs))
    jsteps, jsnaps, _ = _registry_call()
    call = convert.bc_call(type("C", (), {"steps": jsteps,
                                          "snaps": jsnaps})())
    return (bca.BytecodeAir(), jbca.BytecodeAir(),
            bca.generate_bytecode_trace(call.steps, call.snaps),
            jbca.generate_bytecode_trace(jsteps, jsnaps),
            bca.bytecode_public_inputs(call.steps),
            jbca.bytecode_public_inputs(jsteps))


AIR_NAMES = ["TransferAir", "TokenAir", "BytecodeAir"]
_CASES: dict = {}
_STAGES: dict = {}
ENCODED = bytes(range(40))


def case(name):
    if name not in _CASES:
        _CASES[name] = _case(name)
    return _CASES[name]


def _state_log():
    """A small touched-state write log (records, r_pre, r_post, depth)."""
    from ethrex_tpu_torch.stark import state_tree

    rng = np.random.default_rng(12)
    entries = {bytes(rng.integers(0, 256, 32, dtype=np.uint8)):
               bytes(rng.integers(0, 256, 32, dtype=np.uint8))
               for _ in range(4)}
    tree = state_tree.TouchedStateTree(entries, 2)
    r_pre = tree.root
    keys = sorted(entries)
    records = [tree.update(keys[i], bytes([i + 1]) * 32) for i in range(3)]
    return records, r_pre, tree.root, 2


def stages():
    """`gpu_backend.prove_vm_stages` on the CPU over the three small
    inputs as one VM batch, "stark" format (made once): its TransferAir,
    TokenAir and BytecodeAir proofs are the port proofs the tests below
    hold against the reference."""
    if not _STAGES:
        from ethrex_tpu_torch.guest.transfer_log import BcCall, VmBatch

        jsteps, jsnaps, _ = _registry_call()
        batch = VmBatch(
            [], [convert.vm_seg(s) for s in _transfer_segs(create=True)],
            [convert.tok_seg(s) for s in _token_segs()], [],
            [convert.bc_call(BcCall(jsteps, jsnaps))])
        records, r_pre, r_post, depth = _state_log()
        out, airs, _ = gpu_backend.prove_vm_stages(
            records, r_pre, r_post, depth, ENCODED, batch, "stark",
            device="cpu", params=PARAMS)
        _STAGES.update(out=out, airs=airs, r_pre=r_pre, r_post=r_post)
    return _STAGES


def port_proof(name):
    """The port's CPU proof of the AIR's small input."""
    out = stages()["out"]
    return {"TransferAir": out["vm_proof"], "TokenAir": out["tok_proof"],
            "BytecodeAir": out["bc_proofs"][0]}[name]


@pytest.mark.parametrize("name", AIR_NAMES)
def test_trace_and_public_inputs_equal_the_reference(name):
    _, _, trace, jtrace, pub, jpub = case(name)
    assert trace.dtype == jtrace.dtype and np.array_equal(trace, jtrace)
    assert [int(v) for v in pub] == [int(v) for v in jpub]
    # the honest trace meets the boundaries those public inputs pin
    air = case(name)[0]
    assert all(int(trace[r, c]) == int(v)
               for r, c, v in air.boundaries(pub, trace.shape[0]))


def test_vectorised_transfer_trace_equals_the_reference_on_a_stream():
    """A longer stream (eight segments, a padded tail of eight): the
    batched lanes and the sequential digest lane stay the reference's."""
    jsegs = _transfer_segs() + _transfer_segs(value=7, create=True)
    segs = [convert.vm_seg(s) for s in jsegs]
    assert np.array_equal(ta.generate_transfer_trace(segs),
                          jta.generate_transfer_trace(jsegs))
    assert ta.vm_digest(segs) == jta.vm_digest(jsegs)


@pytest.mark.parametrize("name", AIR_NAMES)
def test_air_structure_equals_the_reference(name):
    air, jair, trace, _, pub, _ = case(name)
    n = trace.shape[0]
    for attr in ("width", "max_degree", "num_pub_inputs", "num_periodic",
                 "num_constraints"):
        assert getattr(air, attr) == getattr(jair, attr), attr
    for a, b in zip(air.periodic_columns(n), jair.periodic_columns(n),
                    strict=True):
        assert np.array_equal(a, b)
    assert air.boundaries(pub, n) == jair.boundaries(pub, n)
    assert type(convert.air_from_spec({"air": name})) is type(air)


@pytest.mark.parametrize("name", AIR_NAMES)
def test_constraint_graph_equals_the_reference_constraints(name):
    air, jair = case(name)[:2]
    N, B = 64, 8
    rng = np.random.default_rng(len(name))
    lde_np = rng.integers(0, bb.P, size=(air.width, N), dtype=np.uint64)
    lde_np = lde_np.astype(np.uint32)
    lde_np[:, ::5] = 0                  # exercise the zero/one shortcuts
    lde_np[:, 1::7] = int(bb.MONT_ONE)
    per_np = rng.integers(0, bb.P, size=(air.num_periodic, N),
                          dtype=np.uint64).astype(np.uint32)
    got = air_codegen.interpret(air_codegen.record(air),
                                bb.from_numpy(lde_np, "cpu"),
                                bb.from_numpy(per_np, "cpu"), B)
    local = [jnp.asarray(c) for c in lde_np]
    nxt = [jnp.asarray(c) for c in np.roll(lde_np, -B, axis=1)]
    periodic = [jnp.asarray(c) for c in per_np]
    want = np.stack([np.broadcast_to(np.asarray(c), (N,)) for c in
                     jair.constraints(local, nxt, periodic, JDeviceOps())])
    assert np.array_equal(bb.to_numpy(got), want)


@pytest.mark.parametrize("name", AIR_NAMES)
def test_cpu_proof_is_accepted_by_both_verifiers(name):
    air, jair = case(name)[:2]
    proof = port_proof(name)
    assert verifier.verify(air, proof, PARAMS)
    assert jverifier.verify(jair, convert.proof_dict(proof), JAX_PARAMS)


@pytest.mark.parametrize("name", AIR_NAMES)
def test_tampered_public_input_is_rejected_by_both_verifiers(name):
    air, jair = case(name)[:2]
    bad = convert.proof_dict(port_proof(name))
    bad["pub_inputs"][3] = (bad["pub_inputs"][3] + 1) % bb.P
    with pytest.raises(verifier.VerificationError):
        verifier.verify(air, bad, PARAMS)
    with pytest.raises(Exception):
        if not jverifier.verify(jair, bad, JAX_PARAMS):
            raise ValueError("rejected")


def test_vm_stages_bind_the_reference_message_and_verify():
    """The stage proofs' keys, the state proof under the reference's
    verifier, and the binding proof over the reference's VM-mode message
    (its digests from the reference's own public-input functions)."""
    from ethrex_tpu.models import poseidon2_air as jpair
    from ethrex_tpu.models import state_update_air as jsua
    from ethrex_tpu.prover import tpu_backend

    st = stages()
    out = st["out"]
    assert sorted(out) == ["bc_proofs", "depth", "proof", "seg_periods",
                           "state_proof", "tok_proof", "vm_proof"]
    assert out["seg_periods"] == tpu_backend._schedule_for(out["depth"])
    state_pub = out["state_proof"]["pub_inputs"]
    limbs = tpu_backend.binding_limbs(
        ENCODED, st["r_pre"], st["r_post"], state_pub[16:24],
        case("TransferAir")[5], case("TokenAir")[5],
        [case("BytecodeAir")[5]])
    assert out["proof"]["pub_inputs"] == [
        int(v) % bb.P for v in jpair.sponge_public_inputs(limbs)]
    for key, name in (("vm_proof", "TransferAir"), ("tok_proof", "TokenAir")):
        assert out[key]["pub_inputs"] == [int(v) for v in case(name)[5]]
    assert out["bc_proofs"][0]["pub_inputs"] == [
        int(v) for v in case("BytecodeAir")[5]]
    assert [type(a).__name__ for a in st["airs"]] == [
        "StateUpdateAir", "Poseidon2SpongeAir", "TransferAir", "TokenAir",
        "BytecodeAir"]
    assert jverifier.verify(
        jsua.StateUpdateAir(out["depth"], seg_periods=out["seg_periods"]),
        convert.proof_dict(out["state_proof"]), JAX_PARAMS)
    assert jverifier.verify(
        jpair.Poseidon2SpongeAir(len(limbs) // 8),
        convert.proof_dict(out["proof"]), JAX_PARAMS)


# ---------------------------------------------------------------------------
# the plain versions of K8, K9, K11 against the reference's arithmetic
# ---------------------------------------------------------------------------

def _np_field(rng, shape):
    return rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _point(rng):
    return tuple(int(v) for v in rng.integers(0, bb.P, 4))


def test_deep_compose_plain_equals_the_reference_phase_deep():
    """`stark/prover.py:565-585` of the reference, term by term."""
    rng = np.random.default_rng(8)
    N, w, B = 256, 5, 8
    pts, S1, S2 = (_np_field(rng, s) for s in ((N,), (N, 4), (N, 4)))
    tz, tzg, g1, g2 = (_np_field(rng, (w, 4)) for _ in range(4))
    q_lde, q_z, gq = (_np_field(rng, s) for s in ((B, 4, N), (B, 4),
                                                  (B, 4)))
    zeta, zeta_g = _point(rng), _point(rng)
    J = jnp.asarray
    inv_xz = jext.inv_x_minus_zeta(J(pts), jext.to_device(zeta))
    inv_xzg = jext.inv_x_minus_zeta(J(pts), jext.to_device(zeta_g))
    s1 = jext.sub(J(S1), jbb.sum_mod(jext.mul(J(tz), J(g1)), axis=0)[None])
    s2 = jext.sub(J(S2), jbb.sum_mod(jext.mul(J(tzg), J(g2)), axis=0)[None])
    d3 = jext.sub(jnp.moveaxis(J(q_lde), 1, -1), J(q_z)[:, None])
    s3 = jbb.sum_mod(jext.mul(d3, J(gq)[:, None]), axis=0)
    want = jext.add(jext.mul(jext.add(s1, s3), inv_xz),
                    jext.mul(s2, inv_xzg))
    T = lambda a: bb.from_numpy(a, "cpu")  # noqa: E731
    got = ext.deep_compose_plain(
        T(pts), [(zeta, T(S1), T(tz), T(g1)), (zeta_g, T(S2), T(tzg),
                                                 T(g2))],
        q_lde=T(q_lde), q_z=T(q_z), gq=T(gq))
    assert np.array_equal(bb.to_numpy(got), np.asarray(want))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(ext.deep_compose(
        T(pts), [(zeta, T(S1), T(tz), T(g1)), (zeta_g, T(S2), T(tzg),
                                                 T(g2))],
        q_lde=T(q_lde), q_z=T(q_z), gq=T(gq)), got)


def test_deep_compose_plain_single_opening_equals_the_fused_step():
    """The single-opening form: (comb - const) * 1/(x - zeta), as
    `parallel/core.py:103-108` of the reference computes it."""
    rng = np.random.default_rng(9)
    N, w = 128, 6
    pts, comb = _np_field(rng, (N,)), _np_field(rng, (N, 4))
    tz, g = _np_field(rng, (w, 4)), _np_field(rng, (w, 4))
    zeta = _point(rng)
    J = jnp.asarray
    const = jbb.sum_mod(jext.mul(J(tz), J(g)), axis=0)
    want = jext.mul(jext.sub(J(comb), jnp.broadcast_to(const, (N, 4))),
                    jext.inv_x_minus_zeta(J(pts), jext.to_device(zeta)))
    T = lambda a: bb.from_numpy(a, "cpu")  # noqa: E731
    got = ext.deep_compose_plain(T(pts), [(zeta, T(comb), T(tz), T(g))])
    assert np.array_equal(bb.to_numpy(got), np.asarray(want))


def test_quotient_combine_plain_equals_the_reference_phase_quotient():
    """`stark/prover.py:540-548` of the reference."""
    rng = np.random.default_rng(10)
    N, B, w, nb = 256, 8, 4, 3
    acc, xm = _np_field(rng, (N, 4)), _np_field(rng, (N,))
    inv = _np_field(rng, (B + N + nb * N,))
    lde = _np_field(rng, (w, N))
    cols = [2, 0, 3]
    bvals, apb = _np_field(rng, (nb,)), _np_field(rng, (nb, 4))
    J = jnp.asarray
    q = jext.scalar_mul(J(acc), jbb.mont_mul(J(xm),
                                             jnp.tile(J(inv)[:B], N // B)))
    for j, c in enumerate(cols):
        diff = jbb.sub(J(lde)[c], J(bvals)[j])
        inv_x = J(inv)[B + N + j * N: B + N + (j + 1) * N]
        q = jext.add(q, jbb.mont_mul(jbb.mont_mul(diff, inv_x)[:, None],
                                     J(apb)[j][None, :]))
    T = lambda a: bb.from_numpy(a, "cpu")  # noqa: E731
    got = ext.quotient_combine(T(acc), T(xm), T(inv), T(lde), cols,
                               T(bvals), T(apb), B)
    assert np.array_equal(bb.to_numpy(got), np.asarray(q))


@pytest.mark.parametrize("n", [7, 128, 300])
def test_ext_poly_eval_plain_equals_the_reference_phase_open(n):
    """`stark/prover.py:553-556` of the reference: the chunks at zeta and
    a base polynomial at zeta through the power table."""
    rng = np.random.default_rng(n)
    chunks = _np_field(rng, (3, n, 4))
    base = _np_field(rng, (2, n))
    zeta = _point(rng)
    z_dev = jext.to_device(zeta)
    want = np.asarray(jext.eval_ext_poly_at_ext(jnp.asarray(chunks), z_dev))
    T = lambda a: bb.from_numpy(a, "cpu")  # noqa: E731
    assert np.array_equal(
        bb.to_numpy(ext.eval_ext_poly_at_ext(T(chunks), zeta)), want)
    assert np.array_equal(
        bb.to_numpy(ext.powers_table(zeta, n, "cpu")),
        np.asarray(jext.ext_powers_blocked(z_dev, n)))
    assert np.array_equal(
        bb.to_numpy(ext.eval_base_poly_at_ext(T(base), zeta)),
        np.asarray(jext.eval_base_poly_at_ext(jnp.asarray(base), z_dev)))


# ---------------------------------------------------------------------------
# the backend's helpers
# ---------------------------------------------------------------------------

def test_binding_limbs_equal_the_reference_in_vm_mode():
    from ethrex_tpu.prover import tpu_backend

    rng = np.random.default_rng(11)
    out = bytes(rng.integers(0, 256, 77, dtype=np.uint8))
    r_pre, r_post, dig, vm, tok = ([int(v) for v in rng.integers(0, bb.P, 8)]
                                   for _ in range(5))
    bcs = [[int(v) for v in rng.integers(0, bb.P, 8)] for _ in range(2)]
    for args in ((vm, tok, bcs), (vm, None, None), (None, None, None),
                 (vm, None, bcs[:1])):
        assert gpu_backend.binding_limbs(out, r_pre, r_post, dig, *args) \
            == tpu_backend.binding_limbs(out, r_pre, r_post, dig, *args)
    assert gpu_backend.output_to_limbs(out) == \
        tpu_backend.output_to_limbs(out)
    for depth in range(1, 30):
        assert gpu_backend._schedule_for(depth) == \
            tpu_backend._schedule_for(depth)


def test_convert_carries_a_vm_batch_across():
    from ethrex_tpu.guest.transfer_log import BcCall, VmBatch

    jsteps, jsnaps, _ = _registry_call()
    jb = VmBatch([], _transfer_segs(), _token_segs(), [],
                 [BcCall(jsteps, jsnaps)])
    b = convert.vm_batch(jb)
    assert [vars(s) for s in b.segs] == [vars(s) for s in jb.segs]
    assert [dataclasses.asdict(s) for s in b.tok_segs] == \
        [dataclasses.asdict(s) for s in jb.tok_segs]
    assert [dataclasses.asdict(s) for s in b.bc_calls[0].steps] == \
        [dataclasses.asdict(s) for s in jsteps]
    assert gpu_backend._mode_of(b) == "generic"
    b.bc_calls = []
    assert gpu_backend._mode_of(b) == "token"


# ---------------------------------------------------------------------------
# slow: JSON-equality with the reference prover
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", AIR_NAMES)
def test_cpu_proof_json_equals_the_reference_prover(name):
    from ethrex_tpu.stark import prover as jprover

    _, jair, _, jtrace, _, jpub = case(name)
    want = jprover.prove(jair, jtrace, jpub, JAX_PARAMS)
    assert json.dumps(convert.proof_dict(port_proof(name)),
                      sort_keys=True) == json.dumps(
        convert.proof_dict(want), sort_keys=True)
