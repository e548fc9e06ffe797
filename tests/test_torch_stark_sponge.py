"""The port's binding proof end to end: a Poseidon2SpongeAir proof from
`ethrex_tpu_torch.stark.prover.prove` (plain versions on the CPU) against
`ethrex_tpu.stark.prover.prove` on the same inputs, carried across with
`ethrex_tpu_torch.convert`.

Bar: the proof dicts are equal under json.dumps(..., sort_keys=True) — all
arithmetic is exact, so no tolerance applies.  The shape is that of
tests/test_poseidon2_sponge.py (a 17-limb message padded to 3 chunks),
with StarkParams(3, 25, 4).  The JAX reference proof is made once per
module.  It lives apart from tests/test_torch_stark.py so that the two
JAX references trace in parallel under pytest-xdist.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ethrex_tpu.models import poseidon2_air as jpair
from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.stark import prover as jprover
from ethrex_tpu.stark import verifier as jverifier
from ethrex_tpu.stark.prover import StarkParams as JaxStarkParams
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.stark import prover
from ethrex_tpu_torch.stark import verifier

JAX_PARAMS = JaxStarkParams(log_blowup=3, num_queries=25, log_final_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sponge_case():
    rng = np.random.default_rng(11)
    msg = [int(v) for v in rng.integers(0, jbb.P, 17)]  # pads to 3 chunks
    trace = jpair.generate_sponge_trace(msg)
    pub = jpair.sponge_public_inputs(msg)
    jair = jpair.Poseidon2SpongeAir(num_chunks=3)
    ref = jprover.prove(jair, trace, pub, JAX_PARAMS)
    air = convert.air_from_spec({"air": "Poseidon2SpongeAir",
                                 "num_chunks": 3})
    params = convert.stark_params(dataclasses.asdict(JAX_PARAMS))
    ours = prover.prove(air, trace, pub, params, device="cpu")
    return dict(trace=trace, pub=pub, jair=jair, air=air, params=params,
                ref=ref, ours=ours)


def _dump(proof):
    return json.dumps(proof, sort_keys=True)


@pytest.mark.parametrize("case", ["sponge_case"])
def test_proof_equals_jax_proof(case, request):
    c = request.getfixturevalue(case)
    assert c["ours"]["trace_root"] == c["ref"]["trace_root"]
    assert c["ours"]["quotient_root"] == c["ref"]["quotient_root"]
    assert _dump(c["ours"]) == _dump(c["ref"])


@pytest.mark.parametrize("case", ["sponge_case"])
def test_both_verifiers_accept_and_reject_tampering(case, request):
    c = request.getfixturevalue(case)
    proof = c["ours"]
    assert jverifier.verify(c["jair"], proof, JAX_PARAMS)
    assert verifier.verify(c["air"], proof, c["params"])
    bad = dict(proof)
    bad["pub_inputs"] = list(proof["pub_inputs"])
    bad["pub_inputs"][-1] = (bad["pub_inputs"][-1] + 1) % jbb.P
    with pytest.raises(jverifier.VerificationError):
        jverifier.verify(c["jair"], bad, JAX_PARAMS)
    with pytest.raises(verifier.VerificationError):
        verifier.verify(c["air"], bad, c["params"])
