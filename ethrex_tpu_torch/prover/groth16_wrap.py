"""Groth16 wrap circuit: bind a STARK public digest into one BN254 SNARK.

A copy of `ethrex_tpu/prover/groth16_wrap.py` over the port's Groth16
prover.  The wrap circuit proves knowledge of the aggregated STARK digest
(8 BabyBear limbs, range-checked to 31 bits) hashing under MiMC-5/Fr to the
single on-chain public input: the commitment the settlement contract stores
and the off-chain verifier cross-checks against the STARK aggregate
(stark/aggregate.py).  The circuit does NOT yet re-verify the STARK inside
the SNARK; that verifier circuit slots into exactly this R1CS seam (a
documented gap of the reference as well).

MiMC-5: x -> (x + c_i)^5 for 110 rounds (x^5 is a permutation of Fr since
gcd(5, r - 1) = 1); sponge: state' = perm(state + limb) per limb, final
state is the public hash.  Constants are SHAKE-256-derived.
"""

from __future__ import annotations

import hashlib

from .. import require_cuda
from ..crypto import groth16
from ..crypto.groth16 import R, R1CS

ROUNDS = 110
LIMBS = 8
LIMB_BITS = 31
_DOMAIN = b"ethrex-tpu/groth16-wrap/mimc5/v1"


def _constants() -> list[int]:
    out = []
    stream = hashlib.shake_256(_DOMAIN).digest(40 * ROUNDS)
    for i in range(ROUNDS):
        out.append(int.from_bytes(stream[40 * i:40 * (i + 1)], "big") % R)
    return out


CONSTANTS = _constants()


def mimc_perm(x: int) -> int:
    for c in CONSTANTS:
        x = pow((x + c) % R, 5, R)
    return x


def wrap_hash(limbs: list[int]) -> int:
    """Host mirror of the in-circuit sponge (the on-chain recomputation)."""
    if len(limbs) != LIMBS:
        raise ValueError("digest must be 8 limbs")
    state = 0
    for limb in limbs:
        state = mimc_perm((state + int(limb)) % R)
    return state


def build_wrap_r1cs():
    """The fixed wrap R1CS.  z = [1, h, limb_0..7, bits..., round vars...].

    Returns (r1cs, layout) where layout maps names to variable indices for
    witness construction.
    """
    constraints = []
    var = 2 + LIMBS          # after [1, h, limbs]
    bit_vars = []
    # range checks: limb_i = sum bits * 2^j, bits boolean
    for i in range(LIMBS):
        bits = list(range(var, var + LIMB_BITS))
        var += LIMB_BITS
        bit_vars.append(bits)
        for b in bits:
            constraints.append(({b: 1}, {b: 1}, {b: 1}))   # b*b = b
        lin = {b: (1 << j) % R for j, b in enumerate(bits)}
        constraints.append((lin, {0: 1}, {2 + i: 1}))      # sum = limb

    # sponge rounds; u = state + limb (absorb) or previous t; each round:
    #   y2 = u*u ; y4 = y2*y2 ; t = y4*u
    state_lin = {}           # linear combo representing current state
    round_vars = var
    for i in range(LIMBS):
        # absorb: u0 = state + limb_i  (linear, no constraint needed)
        carry = dict(state_lin)
        carry[2 + i] = (carry.get(2 + i, 0) + 1) % R
        for r_i, c in enumerate(CONSTANTS):
            u = dict(carry)
            u[0] = (u.get(0, 0) + c) % R
            y2, y4, t = var, var + 1, var + 2
            var += 3
            constraints.append((u, u, {y2: 1}))
            constraints.append(({y2: 1}, {y2: 1}, {y4: 1}))
            if i == LIMBS - 1 and r_i == ROUNDS - 1:
                # final round output IS the public hash variable
                constraints.append(({y4: 1}, u, {1: 1}))
                var -= 1     # t unused
            else:
                constraints.append(({y4: 1}, u, {t: 1}))
                carry = {t: 1}
        state_lin = carry
    r1cs = R1CS(num_vars=var, num_pub=1, constraints=constraints)
    layout = {"h": 1, "limbs": list(range(2, 2 + LIMBS)),
              "bit_vars": bit_vars, "round_vars": round_vars}
    return r1cs, layout


def wrap_witness(limbs: list[int], r1cs: R1CS, layout) -> list[int]:
    """Assign every variable for a digest."""
    limbs = [int(v) % R for v in limbs]
    if any(v >= (1 << LIMB_BITS) for v in limbs):
        raise ValueError("digest limbs exceed 31 bits")
    z = [0] * r1cs.num_vars
    z[0] = 1
    z[1] = wrap_hash(limbs)
    for i, v in enumerate(limbs):
        z[2 + i] = v
    for i, bits in enumerate(layout["bit_vars"]):
        for j, b in enumerate(bits):
            z[b] = (limbs[i] >> j) & 1
    var = layout["round_vars"]
    state = 0
    for i in range(LIMBS):
        u_val = (state + limbs[i]) % R
        for r_i, c in enumerate(CONSTANTS):
            u = (u_val + c) % R
            y2 = u * u % R
            y4 = y2 * y2 % R
            t = y4 * u % R
            z[var] = y2
            z[var + 1] = y4
            var += 2
            if i == LIMBS - 1 and r_i == ROUNDS - 1:
                pass          # t is the public hash (already assigned)
            else:
                z[var] = t
                var += 1
            u_val = t
        state = u_val
    assert r1cs.is_satisfied(z), "internal witness bug"
    return z


_CACHE: dict = {}
DEFAULT_SEED = b"ethrex-tpu/groth16-wrap/dev-ceremony/v1"


def wrap_keys(seed: bytes = DEFAULT_SEED):
    """Build (and cache) the circuit + keys — setup takes a little while
    (thousands of fixed-base scalar muls), so share per process."""
    got = _CACHE.get(seed)
    if got is None:
        r1cs, layout = build_wrap_r1cs()
        pk, vk = groth16.setup(r1cs, seed=seed)
        got = (r1cs, layout, pk, vk)
        _CACHE[seed] = got
    return got


def use_keys(keys, seed: bytes = DEFAULT_SEED) -> None:
    """Install (r1cs, layout, pk, vk) that `wrap_keys(seed)` built in
    another process (the setup is deterministic in the seed)."""
    _CACHE[seed] = keys
    for slot in [k for k in _TABLES if k[0] == seed]:
        del _TABLES[slot]


_TABLES: dict = {}


def wrap_tables(device, seed: bytes = DEFAULT_SEED) -> dict | None:
    """The wrap key's tables of bases for K5 (`groth16.msm_tables`) on a
    CUDA `device`, built at the key's first proof there and kept beside
    the key; None on the CPU, where the MSMs run their plain version."""
    dev = require_cuda(device)
    if dev.type != "cuda":
        return None
    slot = (seed, str(dev))
    if slot not in _TABLES:
        _TABLES[slot] = groth16.msm_tables(wrap_keys(seed)[2], dev)
    return _TABLES[slot]


def wrap_prove(limbs: list[int], rnd: bytes = b"", device="cuda") -> dict:
    """Digest limbs -> {"hash": h, "proof": groth16 proof}; the MSMs run on
    `device` ("cuda" unless the caller asks for the CPU), over the key's
    kept tables of bases (`wrap_tables`)."""
    r1cs, layout, pk, _vk = wrap_keys()
    z = wrap_witness(limbs, r1cs, layout)
    proof = groth16.prove(pk, r1cs, z, rnd=rnd, device=device,
                          tables=wrap_tables(device))
    return {"hash": z[1], "proof": proof}


def proof_to_json(wrapped: dict) -> dict:
    """Wire form: hex strings (arbitrary-size ints survive any JSON impl)."""
    a, b, c = (wrapped["proof"][k] for k in ("a", "b", "c"))
    return {
        "hash": hex(wrapped["hash"]),
        "a": [hex(a[0]), hex(a[1])],
        "b": [[hex(b[0].c0), hex(b[0].c1)], [hex(b[1].c0), hex(b[1].c1)]],
        "c": [hex(c[0]), hex(c[1])],
    }


def proof_from_json(d: dict) -> dict:
    from ..crypto import bn254

    def h(v):
        return int(v, 16)

    return {
        "hash": h(d["hash"]),
        "proof": {
            "a": (h(d["a"][0]), h(d["a"][1])),
            "b": (bn254.Fp2(h(d["b"][0][0]), h(d["b"][0][1])),
                  bn254.Fp2(h(d["b"][1][0]), h(d["b"][1][1]))),
            "c": (h(d["c"][0]), h(d["c"][1])),
        },
    }


def wrap_verify(wrapped: dict, limbs: list[int]) -> bool:
    """Check the SNARK and that its public hash matches the digest."""
    _r1cs, _layout, _pk, vk = wrap_keys()
    if int(wrapped.get("hash", -1)) != wrap_hash(limbs):
        return False
    return groth16.verify(vk, wrapped["proof"], [wrapped["hash"]])
