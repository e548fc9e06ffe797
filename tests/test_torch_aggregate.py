"""The port's recursive aggregation (`ethrex_tpu_torch.stark.aggregate`,
`ethrex_tpu_torch.models.fri_verifier_air`, `ethrex_tpu_torch.prover.
gpu_backend.prove_formats`; plain versions on the CPU) against the
reference's (`ethrex_tpu.stark.aggregate`).

Bar: equality; all arithmetic is exact.
  * The FriVerifyAir trace generator (vectorised in the port) and the
    transcript digest equal the reference's on the items of a tiny FRI
    proof (the size of tests/test_aggregate.py) and on seeded synthetic
    items of several depths and segment counts.
  * `aggregate` over two tiny inner proofs is JSON-equal to the
    reference's (outer proof and path-stripped inners), the reference's
    `verify_aggregated` accepts the port's aggregate, and a tampered inner
    FRI value or outer digest is rejected by both verifiers.

The two inner proofs (Poseidon2SpongeAir over 5 and 13 limbs, n = 32 and
64, StarkParams(3, 1, 6)) are made once with the port; slice 1's tests
hold such proofs JSON-equal to the reference's.  The same dicts go to both
`aggregate`s, so the JAX package traces only the outer FriVerifyAir
prover, once for the module: 5 FRI items, 8 segments of 16 periods, an
outer trace of 4,096 rows x 90 columns, proven with StarkParams(3, 1, 12).
"""

import copy
import json

import numpy as np
import pytest
import torch

from ethrex_tpu.models import fri_verifier_air as jfva
from ethrex_tpu.models import poseidon2_air as jpair
from ethrex_tpu.ops import fri as jfri
from ethrex_tpu.ops.challenger import Challenger as JChallenger
from ethrex_tpu.stark import aggregate as jagg
from ethrex_tpu.stark import verifier as jverifier
from ethrex_tpu.stark.prover import StarkParams as JStarkParams
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.models import fri_verifier_air as fva
from ethrex_tpu_torch.models import poseidon2_air as pair
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import fri
from ethrex_tpu_torch.ops import ntt
from ethrex_tpu_torch.ops.challenger import Challenger
from ethrex_tpu_torch.prover import gpu_backend
from ethrex_tpu_torch.prover import groth16_wrap
from ethrex_tpu_torch.prover import protocol
from ethrex_tpu_torch.stark import aggregate
from ethrex_tpu_torch.stark import prover
from ethrex_tpu_torch.stark import verifier

PARAMS = prover.StarkParams(log_blowup=3, num_queries=1, log_final_size=6)
JPARAMS = JStarkParams(log_blowup=3, num_queries=1, log_final_size=6)
# the outer proof stops folding at 2^12 points (3 FRI layers): the JAX
# prover compiles programs per FRI layer shape, which is most of its time
OUTER = prover.StarkParams(log_blowup=3, num_queries=1, log_final_size=12)
JOUTER = JStarkParams(log_blowup=3, num_queries=1, log_final_size=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# ---------------------------------------------------------------------------
# trace generator and digest
# ---------------------------------------------------------------------------

def _small_fri_items(num_queries=3):
    """One tiny FRI proof (N = 32, 1 layer) -> aggregation work items, as
    tests/test_aggregate.py makes them, derived by both packages."""
    rng = np.random.default_rng(11)
    coeffs = bb.from_numpy(rng.integers(0, bb.P, (4, 8), dtype=np.uint64)
                           .astype(np.uint32), "cpu")
    cw = ntt.coset_evals_from_coeffs(bb.to_mont(coeffs), 32).T.contiguous()
    fparams = fri.FriParams(log_blowup=2, num_queries=num_queries,
                            log_final_size=4)
    proof, _ = fri.FriProver(fparams).prove(cw, Challenger())
    ours = aggregate.derive_query_items(proof, 5, Challenger(), fparams,
                                        with_paths=True)
    jproof = jfri.FriProof(roots=proof.roots,
                           final_coeffs=proof.final_coeffs,
                           queries=proof.queries, pow_nonce=proof.pow_nonce)
    jparams = jfri.FriParams(log_blowup=2, num_queries=num_queries,
                             log_final_size=4)
    theirs = jagg.derive_query_items(jproof, 5, JChallenger(), jparams,
                                     with_paths=True)
    return ours, theirs


def test_small_fri_items_trace_and_digest_equal_reference():
    ours, theirs = _small_fri_items()
    assert _dumps(ours) == _dumps(theirs)
    items = ours[2]
    max_depth = max(it["msg"][fva.MF_DEPTH] for it in items)
    air = fva.FriVerifyAir(max_depth)
    assert air.seg_periods == jfva.FriVerifyAir(max_depth).seg_periods
    trace = fva.generate_fri_verify_trace(items, max_depth, air.seg_periods)
    want = jfva.generate_fri_verify_trace(items, max_depth, air.seg_periods)
    assert trace.dtype == want.dtype and np.array_equal(trace, want)
    msgs = [it["msg"] for it in items]
    digest = fva.transcript_digest(msgs, air.seg_periods)
    assert digest == jfva.transcript_digest(msgs, air.seg_periods)
    # the honest trace ends on the digest (the AIR's boundary rows)
    assert [int(v) for v in trace[-1, fva.T_STATE:fva.T_STATE + 8]] == \
        digest
    assert fva.segment_count(len(items)) == jfva.segment_count(len(items))


def _synthetic_items(rng, count, max_depth):
    items = []
    for k in range(count):
        msg = [int(v) for v in rng.integers(0, bb.P, fva.MSG_LIMBS)]
        d = int(rng.integers(1, max_depth + 1))
        msg[fva.MF_DEPTH] = d
        items.append({
            "msg": msg,
            "path": [[int(v) for v in rng.integers(0, bb.P, 8)]
                     for _ in range(d)],
            "bits": [int(b) for b in rng.integers(0, 2, d)]})
    return items


@pytest.mark.parametrize("count,max_depth,seg_periods,segments", [
    (5, 6, 8, None), (9, 3, 8, 16), (3, 14, 16, 4), (7, 5, 8, 8),
    (1, 1, 8, None)])
def test_trace_equals_reference_on_synthetic_items(count, max_depth,
                                                   seg_periods, segments):
    rng = np.random.default_rng(count * 100 + max_depth)
    items = _synthetic_items(rng, count, max_depth)
    got = fva.generate_fri_verify_trace(items, max_depth, seg_periods,
                                        segments)
    want = jfva.generate_fri_verify_trace(items, max_depth, seg_periods,
                                          segments)
    assert np.array_equal(got, want)
    msgs = [it["msg"] for it in items]
    assert fva.transcript_digest(msgs, seg_periods, segments) == \
        jfva.transcript_digest(msgs, seg_periods, segments)


def test_trace_needs_an_inert_tail_segment():
    items = _synthetic_items(np.random.default_rng(1), 4, 3)
    with pytest.raises(ValueError):
        fva.generate_fri_verify_trace(items, 3, 8, segments=4)


# ---------------------------------------------------------------------------
# aggregate: port vs reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inner():
    """Two tiny sponge proofs made by the port, with both packages' AIRs."""
    rng = np.random.default_rng(3)
    airs, jairs, proofs = [], [], []
    for limbs in (5, 13):
        msg = [int(v) for v in rng.integers(0, bb.P, limbs)]
        k = len(pair.pad_message_limbs(msg)) // 8
        air = pair.Poseidon2SpongeAir(k)
        proofs.append(convert.proof_dict(prover.prove(
            air, pair.generate_sponge_trace(msg),
            pair.sponge_public_inputs(msg), PARAMS, device="cpu")))
        airs.append(air)
        jairs.append(jpair.Poseidon2SpongeAir(k))
    return airs, jairs, proofs


@pytest.fixture(scope="module")
def ours(inner, monkeypatch_module):
    """The port's batch-proof entries for the `groth16` format, with the
    wrap (its full-size key setup is minutes of host work) replaced by a
    recorder; chip_smoke.py runs the real wrap."""
    airs, _, proofs = inner
    calls = []

    def fake_wrap(limbs, rnd=b"", device="cuda"):
        calls.append((list(limbs), rnd, device))
        return {"hash": 1, "proof": {"a": (1, 2), "b": None, "c": (3, 4)}}

    monkeypatch_module.setattr(groth16_wrap, "wrap_prove", fake_wrap)
    monkeypatch_module.setattr(groth16_wrap, "proof_to_json",
                               lambda w: {"wrapped": w["hash"]})
    stats = {}
    out = gpu_backend.prove_formats(airs, proofs, b"\x01" * 40,
                                    protocol.FORMAT_GROTH16, device="cpu",
                                    params=PARAMS, outer_params=OUTER,
                                    stats=stats)
    return out, calls, stats


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def theirs(inner):
    _, jairs, proofs = inner
    return jagg.aggregate(jairs, copy.deepcopy(proofs), JPARAMS, JOUTER)


def _port_agg(out) -> aggregate.AggregateProof:
    a = out["aggregate"]
    return aggregate.AggregateProof(
        inners=out["inner"], outer=a["outer"], max_depth=a["max_depth"],
        seg_periods=a["seg_periods"])


def test_prove_formats_shapes(ours, inner):
    out, calls, stats = ours
    assert set(out) == {"inner", "aggregate", "groth16"}
    assert set(out["aggregate"]) == {"outer", "max_depth", "seg_periods"}
    # the wrap saw the outer digest and the batch bytes, on the same device
    assert calls == [([int(v) for v in out["aggregate"]["outer"][
        "pub_inputs"]], b"\x01" * 32, "cpu")]
    assert out["groth16"] == {"wrapped": 1}
    agg = stats["aggregate"]
    assert agg["items"] == 5 and agg["trace_shape"] == (4096, fva.WIDTH)
    assert gpu_backend.prove_formats(
        inner[0], inner[2], b"", protocol.FORMAT_STARK, device="cpu") == {}
    with pytest.raises(ValueError):
        gpu_backend.prove_formats(inner[0], inner[2], b"", "plonk",
                                  device="cpu")


def test_aggregate_equals_reference(ours, theirs):
    agg = _port_agg(ours[0])
    assert _dumps(agg.outer) == _dumps(theirs.outer)
    assert _dumps(agg.inners) == _dumps(theirs.inners)
    assert (agg.max_depth, agg.seg_periods) == (theirs.max_depth,
                                                theirs.seg_periods)
    # path data left the wire
    for proof in agg.inners:
        for per_layer in proof["fri"]["queries"]:
            assert all(set(o) == {"values"} for o in per_layer)


def test_both_verifiers_accept_the_port_aggregate(ours, inner):
    airs, jairs, _ = inner
    agg = _port_agg(ours[0])
    assert aggregate.verify_aggregated(airs, agg, PARAMS, OUTER)
    jagg_proof = convert.aggregate_proof(agg, jagg.AggregateProof)
    assert jagg.verify_aggregated(jairs, jagg_proof, JPARAMS, JOUTER)


def test_tampered_inner_value_and_digest_are_rejected(ours, inner):
    airs, jairs, _ = inner
    agg = _port_agg(ours[0])
    # an FRI value of layer 1 no longer chains to layer 0's fold
    bad = copy.deepcopy(agg)
    val = bad.inners[0]["fri"]["queries"][0][1]["values"][0]
    val[0] = (val[0] + 1) % bb.P
    with pytest.raises((verifier.VerificationError,
                        aggregate.AggregationError)):
        aggregate.verify_aggregated(airs, bad, PARAMS, OUTER)
    with pytest.raises((jverifier.VerificationError, jagg.AggregationError)):
        jagg.verify_aggregated(
            jairs, convert.aggregate_proof(bad, jagg.AggregateProof),
            JPARAMS, JOUTER)
    # an outer digest that the inner proofs do not reproduce
    bad = copy.deepcopy(agg)
    bad.outer["pub_inputs"][0] = (bad.outer["pub_inputs"][0] + 1) % bb.P
    with pytest.raises(aggregate.AggregationError):
        aggregate.verify_aggregated(airs, bad, PARAMS, OUTER)
    with pytest.raises(jagg.AggregationError):
        jagg.verify_aggregated(
            jairs, convert.aggregate_proof(bad, jagg.AggregateProof),
            JPARAMS, JOUTER)


def test_aggregate_groups_slices(inner):
    """aggregate_groups flattens groups in order (checked on the host
    part; the outer proof is the one above)."""
    airs, _, proofs = inner
    items = [aggregate._inner_fri_items(a, p, PARAMS, with_paths=False)[2]
             for a, p in zip(airs, proofs)]
    assert [len(i) for i in items] == [2, 3]
    with pytest.raises(aggregate.AggregationError):
        aggregate.aggregate_groups([(airs, proofs[:1])], PARAMS,
                                   device="cpu")
    with pytest.raises(aggregate.AggregationError):
        aggregate.aggregate([], [], PARAMS, device="cpu")
