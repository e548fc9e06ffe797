"""The port's fused prove step (`ethrex_tpu_torch.parallel.core`) and its
entry point against the reference's jitted step, and the port's
`merkle.batched_roots` against the reference's.

Bar: exact equality of the trace root, every FRI layer root and the final
codeword (all arithmetic is exact).  The step runs with the plain versions
on the CPU; the reference's jitted step traces and compiles in about a
minute per shape here, which is most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethrex_tpu.ops import merkle as jmerkle
from ethrex_tpu.parallel.core import build_prove_step as jbuild
from ethrex_tpu_torch import entry as entry_mod
from ethrex_tpu_torch.ops import babybear as bb
from ethrex_tpu_torch.ops import merkle
from ethrex_tpu_torch.ops import poseidon2 as p2
from ethrex_tpu_torch.parallel.core import build_prove_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(ours, ref):
    return np.array_equal(bb.to_numpy(ours), np.asarray(ref))


@pytest.mark.parametrize("shape", [(6, 8, 2, 4), (10, 16, 2, 5)],
                         ids=["tiny", "entry"])
def test_fused_step_equals_the_reference(shape):
    jfn, jargs = jbuild(*shape)
    jroot, jroots, jcw = jax.device_get(jfn(*jargs))
    step, args = build_prove_step(*shape, device="cpu")
    for ours, ref in zip(args[:3], jargs[:3]):
        assert _same(ours, ref)
    assert _same(args[3], jargs[3])
    troot, roots, cw = step(*args)
    assert _same(troot, jroot)
    assert len(roots) == len(jroots) == shape[0] + shape[2] - shape[3]
    assert all(_same(a, b) for a, b in zip(roots, jroots))
    assert cw.shape == (1 << shape[3], 4) and _same(cw, jcw)


def test_entry_takes_the_reference_shape_and_the_card_by_default(
        monkeypatch):
    step, args = entry_mod.entry(device="cpu")
    assert args[0].shape == (16, 1 << 10) and args[3].shape == (7, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.entry()


@pytest.mark.parametrize("sizes", [(1,), (1, 1, 1), (8, 1, 4, 1, 2),
                                   (64, 32, 16, 8, 4, 2, 1),
                                   (2, 256, 1, 32)])
def test_batched_roots_equal_the_reference(sizes):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    d = rng.integers(0, bb.P, size=(sum(sizes), 8), dtype=np.uint64)
    d = d.astype(np.uint32)
    want = jmerkle.batched_roots(jnp.asarray(d), sizes)
    got = merkle.batched_roots(bb.from_numpy(d, "cpu"), sizes)
    assert len(got) == len(want) == len(sizes)
    assert all(_same(a, b) for a, b in zip(got, want))
    # each root is that tree's own Merkle root
    off = 0
    for s, r in zip(sizes, got):
        level = bb.from_numpy(d[off:off + s], "cpu")
        while level.shape[0] > 1:
            level = p2.compress_level(level)
        assert torch.equal(level[0], r)
        off += s


def test_batched_roots_reject_a_size_that_is_not_a_power_of_two():
    d = bb.from_numpy(np.zeros((5, 8), dtype=np.uint32), "cpu")
    with pytest.raises(ValueError):
        merkle.batched_roots(d, (3, 2))
