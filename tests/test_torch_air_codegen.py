"""Kernel K6's generator (`ethrex_tpu_torch/stark/air_codegen.py`) on the
CPU: the graph recorded from each AIR of the port's path, run by a plain
PyTorch interpreter, equals `air.constraints` under `DeviceOps` (the
kernel's plain version); `combine` (the quotient's alpha combination,
the prover's path) equals the reference's `acc` (the JAX AIR's
constraints under the JAX `DeviceOps`, then
`ethrex_tpu.ops.babybear.mod_matmul(cons.T, apow[:K])`); and the
generated CUDA source of both modes is deterministic.  The kernels
themselves run only on a card (tests/test_torch_cuda.py).

Bar: bit-equality; all arithmetic is exact.  Inputs are seeded numpy.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethrex_tpu.models import bytecode_air as jbca
from ethrex_tpu.models import fri_verifier_air as jfva
from ethrex_tpu.models import poseidon2_air as jpair
from ethrex_tpu.models import state_update_air as jsua
from ethrex_tpu.models import token_air as jtka
from ethrex_tpu.models import transfer_air as jta
from ethrex_tpu.ops import babybear as jbb
from ethrex_tpu.ops import ext as jext
from ethrex_tpu.stark.air import DeviceOps as JDeviceOps
from ethrex_tpu_torch.models import bytecode_air as bca
from ethrex_tpu_torch.models import fri_verifier_air as fva
from ethrex_tpu_torch.models import poseidon2_air as pair
from ethrex_tpu_torch.models import state_update_air as sua
from ethrex_tpu_torch.models import token_air as tka
from ethrex_tpu_torch.models import transfer_air as ta
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import ext
from ethrex_tpu_torch.stark import air_codegen as cg
from ethrex_tpu_torch.stark.air import DeviceOps

AIRS = {
    "StateUpdateAir": lambda: sua.StateUpdateAir(2, seg_periods=8),
    "Poseidon2SpongeAir": lambda: pair.Poseidon2SpongeAir(3),
    "FriVerifyAir": lambda: fva.FriVerifyAir(7, 16),
    "TransferAir": ta.TransferAir,
    "TokenAir": tka.TokenAir,
    "BytecodeAir": bca.BytecodeAir,
}
# the same AIRs in the JAX package
JAX_AIRS = {
    "StateUpdateAir": lambda: jsua.StateUpdateAir(2, seg_periods=8),
    "Poseidon2SpongeAir": lambda: jpair.Poseidon2SpongeAir(3),
    "FriVerifyAir": lambda: jfva.FriVerifyAir(7, 16),
    "TransferAir": jta.TransferAir,
    "TokenAir": jtka.TokenAir,
    "BytecodeAir": jbca.BytecodeAir,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _field(seed, shape):
    rng = np.random.default_rng(seed)
    return bb.from_numpy(
        rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32),
        "cpu")


@pytest.mark.parametrize("name", sorted(AIRS))
def test_interpreted_graph_equals_device_ops(name):
    air = AIRS[name]()
    N, B = 512, 8
    lde = _field(1, (air.width, N))
    per = _field(2, (air.num_periodic, N))
    lde[:, ::5] = 0                      # exercise the zero/one shortcuts
    lde[:, 1::7] = bb.MONT_ONE
    graph = cg.record(air)
    assert graph.num_constraints == air.num_constraints
    got = cg.interpret(graph, lde, per, B)
    want = cg.evaluate_plain(air, lde, per, B)
    assert got.shape == (air.num_constraints, N)
    assert torch.equal(got, want)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(cg.evaluate(air, lde, per, B), want)


@pytest.mark.parametrize("name", sorted(AIRS))
def test_combine_equals_the_reference_acc(name):
    """A 32-row trace at blowup 8 (N = 256), zeros and ones mixed in."""
    air, jair = AIRS[name](), JAX_AIRS[name]()
    N, B = 256, 8
    K = air.num_constraints
    lde = _field(11, (air.width, N))
    per = _field(12, (air.num_periodic, N))
    lde[:, ::3] = 0
    lde[:, 2::7] = bb.MONT_ONE
    alpha = bb.to_numpy(_field(13, (4,)))
    apow = ext.ext_powers(bb.from_numpy(alpha, "cpu"), K + 3)
    got = cg.combine(air, lde, per, B, apow)
    assert got.shape == (N, 4)
    lde_np, per_np = bb.to_numpy(lde), bb.to_numpy(per)
    rolled = np.roll(lde_np, -B, axis=1)
    cons = jnp.stack([jnp.broadcast_to(c, (N,)) for c in jair.constraints(
        [jnp.asarray(r) for r in lde_np], [jnp.asarray(r) for r in rolled],
        [jnp.asarray(r) for r in per_np], JDeviceOps())])
    want = jbb.mod_matmul(cons.T, jext.ext_powers(jnp.asarray(alpha), K))
    assert np.array_equal(bb.to_numpy(got), np.asarray(want))
    # the plain version is what the CPU runs, and equals the evaluate
    # form's block combined by K3's plain version
    assert torch.equal(got, cg.combine_plain(air, lde, per, B, apow))
    assert torch.equal(got, bb.mod_matmul(cg.evaluate(air, lde, per, B).T,
                                          apow[:K]))


@pytest.mark.parametrize("name", sorted(AIRS))
def test_generated_source_is_deterministic(name):
    air = AIRS[name]()
    text, nk = cg.cuda_source(cg.record(air))
    cg._GRAPHS.clear()
    again, nk2 = cg.cuda_source(cg.record(AIRS[name]()))
    assert text == again and nk == nk2
    # every constraint is written exactly once, by exactly one kernel
    groups = cg.groups(cg.record(air))
    assert sorted(k for g in groups for k in g) == list(
        range(air.num_constraints))
    assert len(groups) == nk
    for k in range(air.num_constraints):
        assert text.count(f"out[{k}LL * N + i]") == 1
    for g in range(nk):
        assert f"int air_launch_{g}(" in text
    # within each kernel every value is declared once, before its use
    for body in text.split("__global__")[1:]:
        declared = set()
        for line in body.splitlines():
            m = re.match(r"\s*const uint32_t v(\d+) = (.*);", line)
            if not m:
                continue
            used = {int(u) for u in re.findall(r"\bv(\d+)\b", m.group(2))}
            assert used <= declared, line
            assert int(m.group(1)) not in declared, line
            declared.add(int(m.group(1)))


def test_groups_respect_the_node_cap():
    graph = cg.record(AIRS["FriVerifyAir"]())
    for cap in (200, 800, 10 ** 6):
        groups = cg.groups(graph, cap)
        for g in groups:
            assert len(g) == 1 or len(graph.reachable(g)) <= cap
    assert len(cg.groups(graph, 10 ** 6)) == 1


def test_recording_rules_equal_device_ops():
    """Each folding / simplification rule gives DeviceOps' residue."""
    ops = cg.RecordingOps()
    dev = DeviceOps("cpu")
    x = _field(3, (64,))
    xs = ops.input(cg.IN_LOCAL, 0)
    cases = [
        (ops.add(xs, ops.const(0)), bb.add(x, dev.const(0))),
        (ops.add(ops.const(0), xs), bb.add(dev.const(0), x)),
        (ops.sub(xs, ops.const(0)), bb.sub(x, dev.const(0))),
        (ops.sub(xs, xs), bb.sub(x, x)),
        (ops.mul(xs, ops.const(1)), bb.mont_mul(x, dev.const(1))),
        (ops.mul(ops.const(1), xs), bb.mont_mul(dev.const(1), x)),
        (ops.mul(xs, ops.const(0)), bb.mont_mul(x, dev.const(0))),
        (ops.add(ops.const(bb.P - 1), ops.const(5)),
         bb.add(dev.const(bb.P - 1), dev.const(5))),
        (ops.sub(ops.const(3), ops.const(9)),
         bb.sub(dev.const(3), dev.const(9))),
        (ops.mul(ops.const(123456789), ops.const(987654321)),
         bb.mont_mul(dev.const(123456789), dev.const(987654321))),
    ]
    graph = cg.Graph("rules", list(ops.nodes), [s.idx for s, _ in cases],
                     1, 0)
    got = cg.interpret(graph, x[None], torch.empty((0, 64), dtype=bb.I32), 1)
    for k, (_, want) in enumerate(cases):
        assert torch.equal(got[k], want.expand(64)), k
    # commutative operands share a node
    ys = ops.input(cg.IN_NEXT, 0)
    assert ops.add(xs, ys) == ops.add(ys, xs)
    assert ops.mul(xs, ys) == ops.mul(ys, xs)
    assert ops.sub(xs, ys) != ops.sub(ys, xs)
