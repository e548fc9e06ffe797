"""KZG polynomial commitments (EIP-4844) over BLS12-381: a copy of
`ethrex_tpu/crypto/kzg.py`.

Parity target: upstream ethrex's c-kzg/kzg-rs seat
(crates/common/crypto/kzg.rs) — blob -> commitment,
point-evaluation verification (precompile 0x0a), blob proofs, versioned
hashes — implemented per the deneb polynomial-commitments spec on top of
crypto/bls12_381.py.

Trusted setup: the REAL Ethereum ceremony artifact is not shipped in this
image and cannot be derived (tau is secret).  The module therefore runs in
one of two modes:

  * `TrustedSetup.dev()` (default): a deterministic INSECURE setup whose
    tau is derived from a fixed public seed.  Anyone can forge proofs for
    this setup (tau is known), so it is for self-contained L2/dev use
    only — but it makes every code path (commit, prove, verify, pairing
    checks) real and exercised end to end.  Knowing tau also makes
    commitment = p(tau)*G1 a single scalar multiplication, so no 4096-
    point MSM is needed on the hot path.
  * `TrustedSetup.from_ceremony_json(path)`: loads the standard
    `trusted_setup.json` (g1_lagrange / g2_monomial arrays) when the
    public artifact is provided, enabling mainnet-compatible
    verification.  Configure via `--kzg-setup` (cli.py) or the
    ETHREX_TPU_KZG_SETUP environment variable.

CONSENSUS NOTE: the 0x0a precompile's accept/reject behavior depends on
the active setup, so the setup choice is consensus-critical chain
configuration — every node of a chain MUST be configured with the same
setup (exactly as every mainnet client must embed the same ceremony
artifact).  The process-global setup is resolved once at first use and
pinned for the lifetime of the process.
"""

from __future__ import annotations

import hashlib
import json
import os

from . import bls12_381 as bls

BLS_MODULUS = bls.R
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = 32 * FIELD_ELEMENTS_PER_BLOB
VERSIONED_HASH_VERSION_KZG = 0x01
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"

# primitive 4096th root of unity in the scalar field (7 generates F_r*)
_ROOT = pow(7, (BLS_MODULUS - 1) // FIELD_ELEMENTS_PER_BLOB, BLS_MODULUS)
_WIDTH_BITS = FIELD_ELEMENTS_PER_BLOB.bit_length() - 1


def _brp(i: int) -> int:
    return int(format(i, f"0{_WIDTH_BITS}b")[::-1], 2)


# evaluation domain in the EIP-4844 bit-reversal-permutation order:
# blob[i] is the polynomial's value at _DOMAIN[i]
_DOMAIN = [pow(_ROOT, _brp(i), BLS_MODULUS)
           for i in range(FIELD_ELEMENTS_PER_BLOB)]


class KzgError(Exception):
    pass


def blob_to_evals(blob: bytes) -> list[int]:
    if len(blob) != BYTES_PER_BLOB:
        raise KzgError("blob must be 131072 bytes")
    out = []
    for i in range(0, BYTES_PER_BLOB, 32):
        v = int.from_bytes(blob[i:i + 32], "big")
        if v >= BLS_MODULUS:
            raise KzgError("blob element not canonical")
        out.append(v)
    return out


def evals_to_blob(evals: list[int]) -> bytes:
    padded = list(evals) + [0] * (FIELD_ELEMENTS_PER_BLOB - len(evals))
    return b"".join(v.to_bytes(32, "big") for v in padded)


def _batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion mod BLS_MODULUS (all xs nonzero)."""
    prefix = []
    acc = 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % BLS_MODULUS
    inv = pow(acc, BLS_MODULUS - 2, BLS_MODULUS)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = inv * prefix[i] % BLS_MODULUS
        inv = inv * xs[i] % BLS_MODULUS
    return out


def _eval_poly_at(evals: list[int], z: int) -> int:
    """Barycentric evaluation of the blob polynomial at z (deneb
    evaluate_polynomial_in_evaluation_form), one batched inversion."""
    N = FIELD_ELEMENTS_PER_BLOB
    for i, w in enumerate(_DOMAIN):
        if z == w:
            return evals[i]
    invs = _batch_inv([(z - w) % BLS_MODULUS for w in _DOMAIN])
    total = 0
    for i, w in enumerate(_DOMAIN):
        total += evals[i] * w % BLS_MODULUS * invs[i]
    zn = (pow(z, N, BLS_MODULUS) - 1) % BLS_MODULUS
    return total % BLS_MODULUS * zn % BLS_MODULUS \
        * pow(N, BLS_MODULUS - 2, BLS_MODULUS) % BLS_MODULUS


class TrustedSetup:
    """Either a known-tau dev setup or loaded ceremony points."""

    def __init__(self, tau: int | None = None,
                 g1_lagrange: list | None = None, g2_tau=None):
        self.tau = tau
        self.g1_lagrange = g1_lagrange
        if tau is not None:
            self.g2_tau = bls.g2_mul(bls.G2_GEN, tau)
        else:
            self.g2_tau = g2_tau

    _dev_instance = None

    @classmethod
    def dev(cls) -> "TrustedSetup":
        if cls._dev_instance is None:
            seed = hashlib.sha256(
                b"ethrex-tpu INSECURE dev kzg setup (tau is public)"
            ).digest()
            cls._dev_instance = cls(
                tau=int.from_bytes(seed, "big") % BLS_MODULUS)
        return cls._dev_instance

    @classmethod
    def from_ceremony_json(cls, path: str) -> "TrustedSetup":
        with open(path) as f:
            obj = json.load(f)
        g1 = [bls.g1_decompress(bytes.fromhex(h[2:] if h.startswith("0x")
                                              else h))
              for h in obj["g1_lagrange"]]
        if len(g1) != FIELD_ELEMENTS_PER_BLOB:
            raise KzgError("ceremony file has wrong g1_lagrange length")
        g2 = [bls.g2_decompress(bytes.fromhex(h[2:] if h.startswith("0x")
                                              else h))
              for h in obj["g2_monomial"][:2]]
        return cls(g1_lagrange=g1, g2_tau=g2[1])

    # -- commitment/proof construction (needs lagrange points or tau) ----

    def commit(self, evals: list[int]):
        if self.tau is not None:
            return bls.g1_mul(bls.G1_GEN, _eval_poly_at(evals, self.tau))
        acc = None
        for v, pt in zip(evals, self.g1_lagrange):
            if v:
                acc = bls.g1_add(acc, bls.g1_mul(pt, v))
        return acc

    def prove_at(self, evals: list[int], z: int):
        """(proof, y): q(X) = (p(X) - y)/(X - z) committed."""
        y = _eval_poly_at(evals, z)
        if self.tau is not None:
            if (self.tau - z) % BLS_MODULUS == 0:
                raise KzgError("z equals tau (dev setup)")
            q_tau = (_eval_poly_at(evals, self.tau) - y) \
                * pow((self.tau - z) % BLS_MODULUS, BLS_MODULUS - 2,
                      BLS_MODULUS) % BLS_MODULUS
            return bls.g1_mul(bls.G1_GEN, q_tau), y
        # evaluation-form quotient over the lagrange basis
        N = FIELD_ELEMENTS_PER_BLOB
        q = [0] * N
        in_domain = None
        for i, w in enumerate(_DOMAIN):
            if w == z:
                in_domain = i
        for i, w in enumerate(_DOMAIN):
            if i == in_domain:
                continue
            q[i] = (evals[i] - y) * pow((w - z) % BLS_MODULUS,
                                        BLS_MODULUS - 2, BLS_MODULUS) \
                % BLS_MODULUS
        if in_domain is not None:
            s = 0
            wi = _DOMAIN[in_domain]
            for j, w in enumerate(_DOMAIN):
                if j == in_domain:
                    continue
                s += (evals[j] - y) * w % BLS_MODULUS \
                    * pow(wi * ((wi - w) % BLS_MODULUS) % BLS_MODULUS,
                          BLS_MODULUS - 2, BLS_MODULUS)
            q[in_domain] = s % BLS_MODULUS
        return self.commit(q), y


def _default_setup() -> TrustedSetup:
    path = os.environ.get("ETHREX_TPU_KZG_SETUP")
    if path:
        return TrustedSetup.from_ceremony_json(path)
    return TrustedSetup.dev()


_SETUP: TrustedSetup | None = None


def get_setup() -> TrustedSetup:
    global _SETUP
    if _SETUP is None:
        _SETUP = _default_setup()
    return _SETUP


def set_setup(setup: TrustedSetup | None) -> None:
    global _SETUP
    _SETUP = setup


# ---------------------------------------------------------------------------
# Spec-level API (deneb polynomial-commitments)
# ---------------------------------------------------------------------------

def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup | None = None
                           ) -> bytes:
    setup = setup or get_setup()
    return bls.g1_compress(setup.commit(blob_to_evals(blob)))


def verify_kzg_proof(commitment: bytes, z: int, y: int, proof: bytes,
                     setup: TrustedSetup | None = None) -> bool:
    """e(C - y*G1, G2) == e(pi, tau*G2 - z*G2) via one pairing check."""
    setup = setup or get_setup()
    try:
        c = bls.g1_decompress(commitment)
        pi = bls.g1_decompress(proof)
    except bls.DecodeError:
        return False
    if z >= BLS_MODULUS or y >= BLS_MODULUS:
        return False
    c_minus_y = bls.g1_add(c, bls.g1_mul(bls.G1_GEN,
                                         (-y) % BLS_MODULUS))
    x_minus_z = bls.g2_add(setup.g2_tau,
                           bls.g2_mul(bls.G2_GEN, (-z) % BLS_MODULUS))
    neg_pi = None if pi is None else (pi[0], (-pi[1]) % bls.P)
    return bls.pairing_check([(c_minus_y, bls.G2_GEN),
                              (neg_pi, x_minus_z)])


def compute_kzg_proof(blob: bytes, z: int,
                      setup: TrustedSetup | None = None
                      ) -> tuple[bytes, int]:
    setup = setup or get_setup()
    proof, y = setup.prove_at(blob_to_evals(blob), z)
    return bls.g1_compress(proof), y


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    degree = FIELD_ELEMENTS_PER_BLOB.to_bytes(16, "little")
    data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree + blob + commitment
    return int.from_bytes(hashlib.sha256(data).digest(), "big") \
        % BLS_MODULUS


def compute_blob_kzg_proof(blob: bytes, commitment: bytes,
                           setup: TrustedSetup | None = None) -> bytes:
    z = compute_challenge(blob, commitment)
    proof, _ = compute_kzg_proof(blob, z, setup)
    return proof


def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes,
                          setup: TrustedSetup | None = None) -> bool:
    try:
        evals = blob_to_evals(blob)
    except KzgError:
        return False
    z = compute_challenge(blob, commitment)
    y = _eval_poly_at(evals, z)
    return verify_kzg_proof(commitment, z, y, proof, setup)


def commitment_to_versioned_hash(commitment: bytes) -> bytes:
    return bytes([VERSIONED_HASH_VERSION_KZG]) \
        + hashlib.sha256(commitment).digest()[1:]


# -- precompile 0x0a core (EIP-4844 point evaluation) -----------------------

POINT_EVAL_OUTPUT = (FIELD_ELEMENTS_PER_BLOB.to_bytes(32, "big")
                     + BLS_MODULUS.to_bytes(32, "big"))


def point_evaluation(input_data: bytes,
                     setup: TrustedSetup | None = None) -> bytes:
    """versioned_hash(32) || z(32) || y(32) || commitment(48) || proof(48)
    -> the canonical success output, or raises KzgError on failure."""
    if len(input_data) != 192:
        raise KzgError("point evaluation input must be 192 bytes")
    versioned_hash = input_data[:32]
    z = int.from_bytes(input_data[32:64], "big")
    y = int.from_bytes(input_data[64:96], "big")
    commitment = input_data[96:144]
    proof = input_data[144:192]
    if commitment_to_versioned_hash(commitment) != versioned_hash:
        raise KzgError("versioned hash mismatch")
    if z >= BLS_MODULUS or y >= BLS_MODULUS:
        raise KzgError("z/y not canonical field elements")
    if not verify_kzg_proof(commitment, z, y, proof, setup):
        raise KzgError("kzg proof verification failed")
    return POINT_EVAL_OUTPUT
