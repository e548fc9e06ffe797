"""The port's BLS12-381 curve and pairing, KZG commitments and the
EIP-2537 / EIP-4844 precompiles (0x0a-0x0f), against the JAX package's.

The reference's five cases (tests/test_bls_kzg.py) run on the port's
`crypto/bls12_381.py`, `crypto/kzg.py` and `evm/precompiles.py`, each
output held equal to the reference's on the same inputs.  Then one
Prague block whose transactions call 0x0a (a valid point evaluation
under the dev setup) and 0x0b-0x0f (G1 and G2 add and MSM, a two-pair
pairing), plus a malformed call that fails, executes through both
packages' `execution_program`: the encoded `ProgramOutput` and the
receipts must be equal.  Before the port had these modules, the block
raised ImportError in the port.  Host code: no card, and no pairing on
the card's path.
"""

from __future__ import annotations

import pytest

from ethrex_tpu.crypto import bls12_381 as jbls
from ethrex_tpu.crypto import kzg as jkzg
from ethrex_tpu.evm import precompiles as jpc
from ethrex_tpu.guest.execution import execution_program as jexecute
from ethrex_tpu.guest.witness import generate_witness
from ethrex_tpu.guest.execution import ProgramInput as JProgramInput
from ethrex_tpu.node import Node
from ethrex_tpu.primitives.genesis import Genesis
from ethrex_tpu.primitives.transaction import Transaction as JTransaction
from ethrex_tpu_torch.crypto import bls12_381 as bls
from ethrex_tpu_torch.crypto import kzg
from ethrex_tpu_torch.evm import precompiles as pc
from ethrex_tpu_torch.guest.execution import ProgramInput, execution_program
from ethrex_tpu_torch.primitives.genesis import Fork
from tests.test_stateless import GENESIS, SECRET, SENDER


def _both(fn):
    """fn(bls, kzg, precompiles, Fork) in the port and in the reference."""
    from ethrex_tpu.primitives.genesis import Fork as JFork

    return fn(bls, kzg, pc, Fork), fn(jbls, jkzg, jpc, JFork)


def test_pairing_bilinear():
    e = bls.pairing(bls.G1_GEN, bls.G2_GEN)
    assert e != bls.Fp12.one()
    assert e.pow(bls.R) == bls.Fp12.one()
    lhs = bls.pairing(bls.g1_mul(bls.G1_GEN, 6),
                      bls.g2_mul(bls.G2_GEN, 5))
    assert lhs == e.pow(30)
    je = jbls.pairing(jbls.G1_GEN, jbls.G2_GEN)
    assert _fp12_ints(e) == _fp12_ints(je)


def _fp12_ints(x):
    """Fp12 -> its 12 base-field coordinates, whatever its class."""
    out = []

    def walk(v):
        if isinstance(v, int):
            out.append(v)
        else:
            for name in type(v).__slots__:
                walk(getattr(v, name))

    walk(x)
    return out


def test_point_serialization_roundtrip():
    def run(b, _k, _p, _f):
        p = b.g1_mul(b.G1_GEN, 0xDEADBEEF)
        q = b.g2_mul(b.G2_GEN, 0xCAFE)
        assert b.decode_g1(b.encode_g1(p)) == p
        assert b.decode_g2(b.encode_g2(q)) == q
        assert b.g1_decompress(b.g1_compress(p)) == p
        assert b.g2_decompress(b.g2_compress(q)) == q
        with pytest.raises(b.DecodeError):
            b.decode_g1(b"\x01" * 128)
        return (b.encode_g1(p), b.encode_g2(q), b.g1_compress(p),
                b.g2_compress(q), b.g1_compress(b.G1_GEN))

    ours, ref = _both(run)
    assert ours == ref
    # the canonical compressed generator (public constant)
    assert ours[4].hex().startswith("97f1d3a73197d794")


def test_kzg_commit_prove_verify():
    def run(_b, k, _p, _f):
        setup = k.TrustedSetup.dev()
        blob = k.evals_to_blob([7 * i + 3 for i in range(64)])
        c = k.blob_to_kzg_commitment(blob, setup)
        proof, y = k.compute_kzg_proof(blob, 99, setup)
        assert k.verify_kzg_proof(c, 99, y, proof, setup)
        assert not k.verify_kzg_proof(c, 99, (y + 1) % k.BLS_MODULUS,
                                      proof, setup)
        bp = k.compute_blob_kzg_proof(blob, c, setup)
        assert k.verify_blob_kzg_proof(blob, c, bp, setup)
        other = k.evals_to_blob([1])
        assert not k.verify_blob_kzg_proof(other, c, bp, setup)
        return c, proof, y, bp, k.commitment_to_versioned_hash(c)

    ours, ref = _both(run)
    assert ours == ref


def _point_eval_input(k):
    setup = k.TrustedSetup.dev()
    blob = k.evals_to_blob(list(range(1, 33)))
    c = k.blob_to_kzg_commitment(blob, setup)
    z = 0x1234
    proof, y = k.compute_kzg_proof(blob, z, setup)
    return (k.commitment_to_versioned_hash(c) + z.to_bytes(32, "big")
            + y.to_bytes(32, "big") + c + proof)


def test_point_evaluation_precompile():
    def run(_b, k, p, f):
        k.set_setup(k.TrustedSetup.dev())
        try:
            inp = _point_eval_input(k)
            fn = p.get_precompile(p._a(10), f.CANCUN)
            assert fn is not None
            cost, out = fn(inp, 10**6, f.CANCUN)
            assert cost == 50_000 and out == k.POINT_EVAL_OUTPUT
            with pytest.raises(p.PrecompileError):
                bad = bytearray(inp)
                bad[40] ^= 1  # z changes -> proof invalid
                fn(bytes(bad), 10**6, f.CANCUN)
            assert p.get_precompile(p._a(10), f.SHANGHAI) is None
            return inp, cost, out
        finally:
            k.set_setup(None)

    ours, ref = _both(run)
    assert ours == ref


def _bls_inputs(b):
    g1 = b.encode_g1(b.G1_GEN)
    two = b.encode_g1(b.g1_mul(b.G1_GEN, 2))
    g2 = b.encode_g2(b.G2_GEN)
    scalar = (3).to_bytes(32, "big")
    neg_g1 = b.encode_g1((b.G1_GEN[0], b.P - b.G1_GEN[1]))
    return {0x0B: g1 + g1, 0x0C: g1 + scalar + two + scalar,
            0x0D: g2 + b"\x00" * 256, 0x0E: g2 + scalar,
            0x0F: g1 + g2 + neg_g1 + g2}


def test_bls_precompiles_add_msm_pairing():
    def run(b, _k, p, f):
        fork = f.PRAGUE
        ins = _bls_inputs(b)
        outs = {a: p.get_precompile(p._a(a), fork)(data, 10**6, fork)
                for a, data in ins.items()}
        g1 = b.encode_g1(b.G1_GEN)
        assert outs[0x0B] == (375, b.encode_g1(b.g1_mul(b.G1_GEN, 2)))
        assert outs[0x0C] == (2 * 12_000 * 949 // 1000,
                              b.encode_g1(b.g1_mul(b.G1_GEN, 9)))
        assert outs[0x0D] == (600, b.encode_g2(b.G2_GEN))
        assert outs[0x0E] == (22_500, b.encode_g2(b.g2_mul(b.G2_GEN, 3)))
        assert outs[0x0F] == (32_600 * 2 + 37_700,
                              (1).to_bytes(32, "big"))
        add = p.get_precompile(p._a(0x0B), fork)
        msm = p.get_precompile(p._a(0x0C), fork)
        assert add(g1 + b"\x00" * 128, 10**6, fork)[1] == g1
        with pytest.raises(p.PrecompileError):
            add(g1, 10**6, fork)
        with pytest.raises(p.PrecompileError):
            msm(b"", 10**6, fork)
        # a curve point outside G1's subgroup: MSM refuses it, ADD takes
        # it (EIP-2537: no subgroup check on ADD)
        x = 5
        while True:
            y2 = (x * x * x + 4) % b.P
            y = pow(y2, (b.P + 1) // 4, b.P)
            if y * y % b.P == y2 and not b.g1_in_subgroup((x, y)):
                break
            x += 1
        with pytest.raises(p.PrecompileError):
            msm(b.encode_g1((x, y)) + (3).to_bytes(32, "big"), 10**6, fork)
        odd = add(b.encode_g1((x, y)) + g1, 10**6, fork)
        assert p.get_precompile(p._a(0x0B), f.CANCUN) is None
        return outs, odd

    ours, ref = _both(run)
    assert ours == ref


def _precompile_block() -> JProgramInput:
    genesis = dict(GENESIS)
    genesis["config"] = {**GENESIS["config"], "pragueTime": 0}
    genesis["alloc"] = {"0x" + SENDER.hex(): {"balance": hex(10**21)}}
    node = Node(Genesis.from_json(genesis))
    calls = [(0x0A, _point_eval_input(jkzg), 120_000)]
    calls += [(a, data, 250_000) for a, data in _bls_inputs(jbls).items()]
    calls.append((0x0B, b"\x01" * 64, 60_000))      # malformed: fails
    txs = [JTransaction(tx_type=2, chain_id=1337, nonce=i,
                        max_priority_fee_per_gas=1, max_fee_per_gas=10**10,
                        gas_limit=gas, to=a.to_bytes(20, "big"), value=0,
                        data=data).sign(SECRET)
           for i, (a, data, gas) in enumerate(calls)]
    block = node.produce_block(timestamp=12, forced_txs=txs)
    assert len(block.body.transactions) == len(calls)
    return JProgramInput(blocks=[block],
                         witness=generate_witness(node.chain, [block]),
                         config=node.config)


def test_block_calling_the_precompiles_executes_as_the_reference():
    jpi = _precompile_block()
    pi = ProgramInput.from_json(jpi.to_json())
    arts = []
    for execute, prog in ((jexecute, jpi), (execution_program, pi)):
        receipts: list = []
        out = execute(prog, receipts_out=receipts)
        arts.append((out.encode(),
                     [[r.encode() for r in b] for b in receipts]))
    assert arts[1] == arts[0]
    status = [r.succeeded for r in receipts[0]]
    assert status == [True] * 6 + [False]
