"""The port's slice end to end: the StateUpdateAir proof from
`ethrex_tpu_torch.stark.prover.prove` (plain versions on the CPU) against
`ethrex_tpu.stark.prover.prove` on the same inputs, carried across with
`ethrex_tpu_torch.convert`; plus the port's trace generators, AIR
structure, conversion helpers and import isolation.

Bar: the proof dicts are equal under json.dumps(..., sort_keys=True) — all
arithmetic is exact, so no tolerance applies.  The shape is that of
tests/test_state_update_air.py (StateUpdateAir depth 2, seg_periods 8, 3
writes: log_n 10), with StarkParams(3, 25, 4).  The JAX reference proof
is made once per module; tracing the JAX prover's programs takes most of
this file's time, so the Poseidon2SpongeAir proof has a file of its own
(tests/test_torch_stark_sponge.py) and the two references trace in
parallel under pytest-xdist.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ethrex_tpu.models import poseidon2_air as jpair
from ethrex_tpu.models import state_update_air as jsua
from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.stark import prover as jprover
from ethrex_tpu.stark import state_tree as jstate_tree
from ethrex_tpu.stark import verifier as jverifier
from ethrex_tpu.stark.prover import StarkParams as JaxStarkParams
from ethrex_tpu_torch import convert
from ethrex_tpu_torch.models import poseidon2_air as pair
from ethrex_tpu_torch.models import state_update_air as sua
from ethrex_tpu_torch.stark import prover
from ethrex_tpu_torch.stark import state_tree
from ethrex_tpu_torch.stark import verifier

ROOT = Path(__file__).resolve().parent.parent
JAX_PARAMS = JaxStarkParams(log_blowup=3, num_queries=25, log_final_size=4)
DEPTH, SEG = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _words(seed, count):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            for _ in range(count)]


def _state_batch(tree_mod, seed=7, num_keys=4, num_writes=3):
    """A touched-state tree and write log built by `tree_mod` (the JAX
    package's state_tree or the port's copy) from the same words."""
    words = _words(seed, 2 * num_keys + num_writes)
    entries = dict(zip(words[:num_keys], words[num_keys:2 * num_keys]))
    tree = tree_mod.TouchedStateTree(entries, DEPTH)
    r_pre = tree.root
    keys = list(entries)
    picks = np.random.default_rng(seed + 1).integers(0, num_keys, num_writes)
    accesses = [tree.update(keys[int(k)], words[2 * num_keys + i])
                for i, k in enumerate(picks)]
    return tree, r_pre, accesses


def _sponge_message():
    rng = np.random.default_rng(11)
    return [int(v) for v in rng.integers(0, jbb.P, 17)]  # pads to 3 chunks


@pytest.fixture(scope="module")
def state_case():
    tree, r_pre, accesses = _state_batch(jstate_tree)
    trace = jsua.generate_state_update_trace(accesses, r_pre, DEPTH, SEG)
    pub = jsua.state_update_public_inputs(accesses, r_pre, tree.root, SEG)
    jair = jsua.StateUpdateAir(DEPTH, seg_periods=SEG)
    ref = jprover.prove(jair, trace, pub, JAX_PARAMS)
    air = convert.air_from_spec({"air": "StateUpdateAir", "depth": DEPTH,
                                 "seg_periods": SEG})
    params = convert.stark_params(dataclasses.asdict(JAX_PARAMS))
    ours = prover.prove(air, trace, pub, params, device="cpu")
    return dict(trace=trace, pub=pub, jair=jair, air=air, params=params,
                ref=ref, ours=ours)


def _dump(proof):
    return json.dumps(proof, sort_keys=True)


@pytest.mark.parametrize("case", ["state_case"])
def test_proof_equals_jax_proof(case, request):
    c = request.getfixturevalue(case)
    assert c["ours"]["trace_root"] == c["ref"]["trace_root"]
    assert c["ours"]["quotient_root"] == c["ref"]["quotient_root"]
    assert _dump(c["ours"]) == _dump(c["ref"])


@pytest.mark.parametrize("case", ["state_case"])
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


def test_port_verifier_accepts_the_jax_proof(state_case):
    assert verifier.verify(state_case["air"], state_case["ref"],
                           state_case["params"])


def test_state_trace_and_public_inputs_equal_jax():
    jtree, jr_pre, jacc = _state_batch(jstate_tree, seed=21, num_writes=4)
    tree, r_pre, acc = _state_batch(state_tree, seed=21, num_writes=4)
    assert r_pre == jr_pre and tree.root == jtree.root
    assert [a.msg_limbs() for a in acc] == [a.msg_limbs() for a in jacc]
    ours = sua.generate_state_update_trace(acc, r_pre, DEPTH, SEG)
    ref = jsua.generate_state_update_trace(jacc, jr_pre, DEPTH, SEG)
    assert np.array_equal(ours, ref)
    assert sua.state_update_public_inputs(acc, r_pre, tree.root, SEG) == \
        jsua.state_update_public_inputs(jacc, jr_pre, jtree.root, SEG)
    assert state_tree.tree_depth_for(1002) == \
        jstate_tree.tree_depth_for(1002) == 10


def test_sponge_trace_and_public_inputs_equal_jax():
    msg = _sponge_message() + [5, 6, 7]
    assert np.array_equal(pair.generate_sponge_trace(msg),
                          jpair.generate_sponge_trace(msg))
    assert pair.sponge_public_inputs(msg) == jpair.sponge_public_inputs(msg)


def test_air_structure_equals_jax():
    for ours, ref in ((sua.StateUpdateAir(DEPTH, seg_periods=SEG),
                       jsua.StateUpdateAir(DEPTH, seg_periods=SEG)),
                      (pair.Poseidon2SpongeAir(3),
                       jpair.Poseidon2SpongeAir(3))):
        assert ours.num_constraints == ref.num_constraints
        assert ours.width == ref.width
        n = 1024
        for a, b in zip(ours.periodic_columns(n), ref.periodic_columns(n)):
            assert np.array_equal(a, b)
        pub = list(range(ref.num_pub_inputs))
        assert ours.boundaries(pub, n) == ref.boundaries(pub, n)


def test_convert_round_trips_field_arrays_and_params():
    a = np.array([0, 1, jbb.P - 1, 12345], dtype=np.uint32)
    t = convert.field_from_numpy(a)
    assert t.dtype == torch.int32
    assert np.array_equal(convert.field_to_numpy(t), a)
    p = convert.stark_params(dataclasses.asdict(JAX_PARAMS))
    assert dataclasses.asdict(p) == dataclasses.asdict(JAX_PARAMS)
    with pytest.raises(ValueError):
        convert.air_from_spec({"air": "TransferAir"})


def test_prove_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    air = pair.Poseidon2SpongeAir(1)
    trace = pair.generate_sponge_trace([1, 2, 3])
    pub = pair.sponge_public_inputs([1, 2, 3])
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            prover.prove(air, trace, pub, prover.StarkParams(3, 4, 4),
                         device=device)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, ethrex_tpu_torch, ethrex_tpu_torch.convert, "
            "ethrex_tpu_torch.stark.prover, ethrex_tpu_torch.stark.verifier, "
            "ethrex_tpu_torch.kernels, ethrex_tpu_torch.stark.aggregate, "
            "ethrex_tpu_torch.stark.air_codegen, "
            "ethrex_tpu_torch.ops.bn254_msm, ethrex_tpu_torch.crypto.groth16, "
            "ethrex_tpu_torch.prover.gpu_backend\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ethrex_tpu' or "
            "m.startswith('ethrex_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|ethrex_tpu)(?![\w])", re.M)
    files = sorted((ROOT / "ethrex_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
