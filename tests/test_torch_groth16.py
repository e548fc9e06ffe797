"""The port's Groth16 prover and wrap circuit (`ethrex_tpu_torch.crypto.
groth16`, `ethrex_tpu_torch.prover.groth16_wrap`, MSMs on their plain
versions on the CPU) against the reference's.

Bar: equality.  With the prover's fresh entropy (`os.urandom`, shared by
both modules) fixed by monkeypatch, the port's proof on the small R1CS of
tests/test_groth16.py equals the reference's point for point, and the
reference's verifier accepts it.  The wrap circuit's structure, witness
and hash equal the reference's; its full-size key setup (minutes of host
bignum work) is not run here.
"""

import pytest
import torch

from ethrex_tpu.crypto import bn254 as jbn254
from ethrex_tpu.crypto import groth16 as jgroth16
from ethrex_tpu.prover import groth16_wrap as jwrap
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.crypto import groth16
from ethrex_tpu_torch.prover import groth16_wrap as wrap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fixed_entropy(monkeypatch):
    """Both modules draw their blinding entropy from os.urandom."""
    assert groth16.os is jgroth16.os
    monkeypatch.setattr(groth16.os, "urandom", lambda n: b"\x5a" * n)


def _mult_r1cs(mod):
    """x * y = out, with out public: z = [1, out, x, y]."""
    return mod.R1CS(num_vars=4, num_pub=1,
                    constraints=[({2: 1}, {3: 1}, {1: 1})])


def _vk_fields(vk):
    return (convert.g1_point(vk.alpha1), convert.g2_point(vk.beta2),
            convert.g2_point(vk.gamma2), convert.g2_point(vk.delta2),
            [convert.g1_point(p) for p in vk.ic])


def test_setup_equals_reference():
    pk, vk = groth16.setup(_mult_r1cs(groth16), seed=b"test-setup-1")
    jpk, jvk = jgroth16.setup(_mult_r1cs(jgroth16), seed=b"test-setup-1")
    assert _vk_fields(vk) == _vk_fields(jvk)
    for name in ("a_query", "b1_query", "k_query", "h_query"):
        assert [convert.g1_point(p) for p in getattr(pk, name)] == \
            [convert.g1_point(p) for p in getattr(jpk, name)], name
    assert [convert.g2_point(p) for p in pk.b2_query] == \
        [convert.g2_point(p) for p in jpk.b2_query]
    assert pk.domain_size == jpk.domain_size


def test_proof_equals_reference_and_reference_verifies_it(fixed_entropy):
    r1cs, jr1cs = _mult_r1cs(groth16), _mult_r1cs(jgroth16)
    pk, _vk = groth16.setup(r1cs, seed=b"test-setup-1")
    jpk, jvk = jgroth16.setup(jr1cs, seed=b"test-setup-1")
    z = [1, 35, 5, 7]
    proof = groth16.prove(pk, r1cs, z, rnd=b"t1", device="cpu")
    jproof = jgroth16.prove(jpk, jr1cs, z, rnd=b"t1")
    ours = convert.groth16_proof(proof, jbn254.Fp2)
    assert convert.groth16_proof(ours) == convert.groth16_proof(jproof)
    assert jgroth16.verify(jvk, ours, [35])
    assert not jgroth16.verify(jvk, ours, [36])
    # and the port's own verifier agrees
    assert groth16.verify(_vk, proof, [35])
    bad = dict(proof)
    bad["a"] = groth16.bn254.g1_mul(groth16.G1, 123)
    assert not groth16.verify(_vk, bad, [35])


def test_proof_over_kept_tables_equals_reference(fixed_entropy):
    """The MSMs over the key's tables of bases (`msm_tables`, their plain
    versions on the CPU) give the reference's proof."""
    r1cs, jr1cs = _mult_r1cs(groth16), _mult_r1cs(jgroth16)
    pk, vk = groth16.setup(r1cs, seed=b"test-setup-1")
    jpk, _jvk = jgroth16.setup(jr1cs, seed=b"test-setup-1")
    tables = groth16.msm_tables(pk, "cpu")
    assert set(tables) == {"a", "b1", "kh", "b2"}
    z = [1, 35, 5, 7]
    proof = groth16.prove(pk, r1cs, z, rnd=b"t2", device="cpu",
                          tables=tables)
    jproof = jgroth16.prove(jpk, jr1cs, z, rnd=b"t2")
    ours = convert.groth16_proof(proof, jbn254.Fp2)
    assert convert.groth16_proof(ours) == convert.groth16_proof(jproof)
    assert groth16.verify(vk, proof, [35])


def test_wrap_tables_kept_per_key_and_none_on_cpu(monkeypatch):
    """Installing a seed's keys drops that seed's kept tables only."""
    monkeypatch.setattr(wrap, "_CACHE", {})
    monkeypatch.setattr(wrap, "_TABLES", {(wrap.DEFAULT_SEED, "cuda:0"): {},
                                          (b"other", "cuda:0"): {}})
    assert wrap.wrap_tables("cpu") is None
    wrap.use_keys("keys")
    assert wrap._CACHE == {wrap.DEFAULT_SEED: "keys"}
    assert list(wrap._TABLES) == [(b"other", "cuda:0")]


def test_unsatisfied_witness_refused():
    r1cs = _mult_r1cs(groth16)
    pk, _vk = groth16.setup(r1cs, seed=b"test-setup-1")
    with pytest.raises(ValueError):
        groth16.prove(pk, r1cs, [1, 36, 5, 7], rnd=b"t3", device="cpu")


def test_fr_ntt_equals_reference():
    vals = [3, 1, 4, 1, 5, 9, 2, 6]
    assert groth16._ntt_fr(vals) == jgroth16._ntt_fr(vals)
    assert groth16._ntt_fr(vals, inverse=True) == \
        jgroth16._ntt_fr(vals, inverse=True)


def test_wrap_circuit_equals_reference():
    r1cs, layout = wrap.build_wrap_r1cs()
    jr1cs, jlayout = jwrap.build_wrap_r1cs()
    assert (r1cs.num_vars, r1cs.num_pub) == (jr1cs.num_vars, jr1cs.num_pub)
    assert r1cs.constraints == jr1cs.constraints
    assert layout == jlayout
    assert wrap.CONSTANTS == jwrap.CONSTANTS
    limbs = [(0x5DEECE66D * (i + 1)) % (1 << 31) for i in range(8)]
    assert wrap.wrap_hash(limbs) == jwrap.wrap_hash(limbs)
    z = wrap.wrap_witness(limbs, r1cs, layout)
    assert z == jwrap.wrap_witness(limbs, jr1cs, jlayout)
    assert z[1] == wrap.wrap_hash(limbs)
    with pytest.raises(ValueError):
        wrap.wrap_witness([1 << 31] + limbs[1:], r1cs, layout)


def test_wrap_proof_json_round_trip():
    proof = {"a": (1, 2), "b": (groth16.bn254.Fp2(3, 4),
                                 groth16.bn254.Fp2(5, 6)), "c": (7, 8)}
    wrapped = {"hash": 99, "proof": proof}
    wire = wrap.proof_to_json(wrapped)
    assert wire == jwrap.proof_to_json(
        {"hash": 99, "proof": convert.groth16_proof(proof, jbn254.Fp2)})
    back = wrap.proof_from_json(wire)
    assert back["hash"] == 99
    assert convert.groth16_proof(back["proof"]) == \
        convert.groth16_proof(proof)
