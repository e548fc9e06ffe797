"""Groth16 over BN254: setup / prove / verify, with the MSMs on the card.

A copy of `ethrex_tpu/crypto/groth16.py`: R1CS -> QAP over the BN254
scalar field (2-adicity 28 gives radix-2 NTT domains), a deterministic DEV
trusted setup (the setup entropy is derived from a seed and documented as
such; a production deployment substitutes ceremony outputs with identical
shapes), the Groth16 prover with its G1 and G2 multi-scalar
multiplications on the device (`ops/bn254_msm.py`, kernel K5 on a CUDA
device) and the pairing-equation verifier on the host (`crypto/bn254.py`).
Setup, the QAP quotient and the verifier are host Python, as in the
reference.

The wrap circuit that binds a STARK's public digest lives in
prover/groth16_wrap.py; this file knows nothing about STARKs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from . import bn254
from ..ops import bn254_msm as msm_ops

R = bn254.R  # scalar field modulus

# radix-2 NTT over Fr: R - 1 = 2^28 * odd
_TWO_ADICITY = 28
_FR_GEN = 5  # smallest multiplicative generator of Fr*
_ROOT_28 = pow(_FR_GEN, (R - 1) >> _TWO_ADICITY, R)

G1 = (1, 2)
G2 = (
    bn254.Fp2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    bn254.Fp2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def _fr_inv(a: int) -> int:
    return pow(a, R - 2, R)


def _ntt_fr(vals: list[int], inverse: bool = False) -> list[int]:
    """In-place radix-2 NTT over Fr (host bignum; QAP domains are small)."""
    n = len(vals)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n and log_n <= _TWO_ADICITY
    root = pow(_ROOT_28, 1 << (_TWO_ADICITY - log_n), R)
    if inverse:
        root = _fr_inv(root)
    a = list(vals)
    # bit-reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    m = 2
    while m <= n:
        w_m = pow(root, n // m, R)
        for k in range(0, n, m):
            w = 1
            for l in range(m // 2):
                u = a[k + l]
                t = a[k + l + m // 2] * w % R
                a[k + l] = (u + t) % R
                a[k + l + m // 2] = (u - t) % R
                w = w * w_m % R
        m <<= 1
    if inverse:
        n_inv = _fr_inv(n)
        a = [v * n_inv % R for v in a]
    return a


@dataclasses.dataclass
class R1CS:
    """Constraints <A_k, z> * <B_k, z> = <C_k, z> over z = [1, pub, priv].

    Each row is a dict {var_index: coeff mod R}."""

    num_vars: int          # includes the leading constant-1 variable
    num_pub: int           # public variables (right after the constant)
    constraints: list      # list of (dict, dict, dict)

    def eval_row(self, row: dict, z: list[int]) -> int:
        return sum(c * z[i] for i, c in row.items()) % R

    def is_satisfied(self, z: list[int]) -> bool:
        return all(
            self.eval_row(a, z) * self.eval_row(b, z) % R
            == self.eval_row(c, z)
            for a, b, c in self.constraints)


def _domain_size(r1cs: R1CS) -> int:
    return max(2, 1 << (len(r1cs.constraints) - 1).bit_length())


def _lagrange_at(m: int, tau: int) -> list[int]:
    """L_k(tau) for the size-m subgroup: L_k(x) = w^k (x^m - 1) /
    (m (x - w^k)).  Batch-inverts the m denominators."""
    root = pow(_ROOT_28, 1 << (_TWO_ADICITY - (m.bit_length() - 1)), R)
    zh = (pow(tau, m, R) - 1) % R
    ws = []
    w = 1
    for _ in range(m):
        ws.append(w)
        w = w * root % R
    if zh == 0:  # tau in the domain (measure zero for hashed tau)
        return [1 if wk == tau else 0 for wk in ws]
    # batch inverse of m*(tau - w^k)
    dens = [m * (tau - wk) % R for wk in ws]
    prefix = [1]
    for d in dens:
        prefix.append(prefix[-1] * d % R)
    inv_all = _fr_inv(prefix[-1])
    invs = [0] * m
    for k in range(m - 1, -1, -1):
        invs[k] = prefix[k] * inv_all % R
        inv_all = inv_all * dens[k] % R
    return [ws[k] * zh % R * invs[k] % R for k in range(m)]


def _uvw_at_tau(r1cs: R1CS, tau: int, m: int):
    """Sparse per-variable QAP evaluations u_i(tau), v_i(tau), w_i(tau)."""
    lag = _lagrange_at(m, tau)
    u_at = [0] * r1cs.num_vars
    v_at = [0] * r1cs.num_vars
    w_at = [0] * r1cs.num_vars
    for k, (a, b, c) in enumerate(r1cs.constraints):
        lk = lag[k]
        for i, coef in a.items():
            u_at[i] = (u_at[i] + coef * lk) % R
        for i, coef in b.items():
            v_at[i] = (v_at[i] + coef * lk) % R
        for i, coef in c.items():
            w_at[i] = (w_at[i] + coef * lk) % R
    return u_at, v_at, w_at


class _FixedBase:
    """Windowed fixed-base scalar multiplication (setup-time speedup)."""

    def __init__(self, base, add, window: int = 4, bits: int = 256):
        self.add = add
        self.window = window
        self.tables = []
        cur = base
        for _ in range(0, bits, window):
            row = [None]
            acc = None
            for _ in range((1 << window) - 1):
                acc = add(acc, cur)
                row.append(acc)
            self.tables.append(row)
            for _ in range(window):
                cur = add(cur, cur)

    def mul(self, k: int):
        k %= R
        acc = None
        idx = 0
        while k:
            digit = k & ((1 << self.window) - 1)
            if digit:
                acc = self.add(acc, self.tables[idx][digit])
            k >>= self.window
            idx += 1
        return acc


@dataclasses.dataclass
class ProvingKey:
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list        # [u_i(tau)]_1
    b1_query: list       # [v_i(tau)]_1
    b2_query: list       # [v_i(tau)]_2
    k_query: list        # [(beta u_i + alpha v_i + w_i)/delta]_1  (priv)
    h_query: list        # [tau^i t(tau)/delta]_1
    domain_size: int


@dataclasses.dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list             # [(beta u_i + alpha v_i + w_i)/gamma]_1 (1 + pub)


def setup(r1cs: R1CS, seed: bytes = b"ethrex-tpu/groth16/dev-setup/v1"):
    """Deterministic DEV setup (toxic waste derived from `seed`)."""

    def fr(tag: bytes) -> int:
        v = int.from_bytes(hashlib.sha512(seed + b"/" + tag).digest(),
                           "big") % (R - 1)
        return v + 1

    tau, alpha, beta, gamma, delta = (fr(t) for t in
                                      (b"tau", b"alpha", b"beta",
                                       b"gamma", b"delta"))
    m = _domain_size(r1cs)
    t_tau = (pow(tau, m, R) - 1) % R
    gamma_inv = _fr_inv(gamma)
    delta_inv = _fr_inv(delta)
    u_at, v_at, w_at = _uvw_at_tau(r1cs, tau, m)

    g1m = _FixedBase(G1, bn254.g1_add).mul
    g2m = _FixedBase(G2, bn254.g2_add).mul
    n_pub = 1 + r1cs.num_pub
    ic = []
    k_query = []
    for i in range(r1cs.num_vars):
        val = (beta * u_at[i] + alpha * v_at[i] + w_at[i]) % R
        if i < n_pub:
            ic.append(g1m(val * gamma_inv % R))
        else:
            k_query.append(g1m(val * delta_inv % R))
    tp = 1
    h_query = []
    for _ in range(m - 1):
        h_query.append(g1m(tp * t_tau % R * delta_inv % R))
        tp = tp * tau % R
    pk = ProvingKey(
        alpha1=g1m(alpha),
        beta1=g1m(beta),
        beta2=g2m(beta),
        delta1=g1m(delta),
        delta2=g2m(delta),
        a_query=[g1m(u) if u else None for u in u_at],
        b1_query=[g1m(v) if v else None for v in v_at],
        b2_query=[g2m(v) if v else None for v in v_at],
        k_query=k_query,
        h_query=h_query,
        domain_size=m,
    )
    vk = VerifyingKey(
        alpha1=pk.alpha1, beta2=pk.beta2,
        gamma2=g2m(gamma), delta2=pk.delta2, ic=ic)
    return pk, vk


def _h_coeffs(r1cs: R1CS, z: list[int], m: int) -> list[int]:
    """Quotient h(x) = (A(x)B(x) - C(x)) / t(x) via coset evaluation."""
    a_e = [0] * m
    b_e = [0] * m
    c_e = [0] * m
    for k, (a, b, c) in enumerate(r1cs.constraints):
        a_e[k] = r1cs.eval_row(a, z)
        b_e[k] = r1cs.eval_row(b, z)
        c_e[k] = r1cs.eval_row(c, z)
    a_c = _ntt_fr(a_e, inverse=True)
    b_c = _ntt_fr(b_e, inverse=True)
    c_c = _ntt_fr(c_e, inverse=True)
    # evaluate on the coset g*H, divide by t(g x) = g^m - 1 (constant)
    g = _FR_GEN
    gp = [pow(g, i, R) for i in range(m)]
    a_s = _ntt_fr([a_c[i] * gp[i] % R for i in range(m)])
    b_s = _ntt_fr([b_c[i] * gp[i] % R for i in range(m)])
    c_s = _ntt_fr([c_c[i] * gp[i] % R for i in range(m)])
    t_inv = _fr_inv((pow(g, m, R) - 1) % R)
    h_s = [(a_s[k] * b_s[k] - c_s[k]) % R * t_inv % R for k in range(m)]
    h_c = _ntt_fr(h_s, inverse=True)
    g_inv = _fr_inv(g)
    return [h_c[i] * pow(g_inv, i, R) % R for i in range(m)][:m - 1]


def msm_tables(pk: ProvingKey, device) -> dict:
    """K5's tables of bases (`bn254_msm.point_bases`) for the key's four
    MSMs on `device`: a_query, b1_query, k_query + h_query (G1) and
    b2_query (G2).  They depend only on the key, so a prover builds them
    once and passes them to every `prove` with it."""
    return {"a": msm_ops.point_bases(pk.a_query, False, device),
            "b1": msm_ops.point_bases(pk.b1_query, False, device),
            "kh": msm_ops.point_bases(pk.k_query + pk.h_query, False,
                                      device),
            "b2": msm_ops.point_bases(pk.b2_query, True, device)}


def prove(pk: ProvingKey, r1cs: R1CS, z: list[int],
          rnd: bytes = b"", device="cuda", tables: dict | None = None) -> dict:
    """Groth16 proof for a satisfied witness z = [1, pub..., priv...]; the
    MSMs run on `device` ("cuda" unless the caller asks for the CPU), over
    the key's `tables` from `msm_tables` where the caller gives them."""
    tables = tables or {}
    if not r1cs.is_satisfied(z):
        raise ValueError("witness does not satisfy the R1CS")
    m = _domain_size(r1cs)

    # RFC-6979-style blinding: fold the secret witness tail and fresh OS
    # entropy into r/s so proofs are hiding even when callers pass a public
    # rnd seed (and two proofs never share randomizers).
    wit_digest = hashlib.sha512(
        b"groth16-wit/" + b"".join(
            v.to_bytes(32, "big") for v in z[1 + r1cs.num_pub:])).digest()
    entropy = os.urandom(32)

    def fr(tag: bytes) -> int:
        return int.from_bytes(
            hashlib.sha512(
                b"groth16-rnd/" + rnd + wit_digest + entropy + tag
            ).digest(), "big") % R

    r = fr(b"r")
    s = fr(b"s")

    # A = alpha + sum z_i u_i(tau) + r*delta          (G1 MSM)
    a_sum = msm_ops.msm(pk.a_query, list(z), device=device,
                        bases=tables.get("a"))
    A = bn254.g1_add(bn254.g1_add(pk.alpha1, a_sum),
                     bn254.g1_mul(pk.delta1, r))

    # B (G2 MSM on the device too: Fp2 limbs) and its G1 mirror
    b2_sum = msm_ops.g2_msm(pk.b2_query, list(z), device=device,
                            bases=tables.get("b2"))
    B2 = bn254.g2_add(bn254.g2_add(pk.beta2, b2_sum),
                      bn254.g2_mul(pk.delta2, s))
    b1_sum = msm_ops.msm(pk.b1_query, list(z), device=device,
                         bases=tables.get("b1"))
    B1 = bn254.g1_add(bn254.g1_add(pk.beta1, b1_sum),
                      bn254.g1_mul(pk.delta1, s))

    # C = sum_priv z_i K_i + h.t/delta + s*A + r*B1 - r*s*delta  (G1 MSMs)
    n_pub = 1 + r1cs.num_pub
    h = _h_coeffs(r1cs, z, m)
    c_main = msm_ops.msm(pk.k_query + pk.h_query,
                         list(z[n_pub:]) + h, device=device,
                         bases=tables.get("kh"))
    C = bn254.g1_add(c_main, bn254.g1_mul(A, s))
    C = bn254.g1_add(C, bn254.g1_mul(B1, r))
    C = bn254.g1_add(C, bn254.g1_mul(pk.delta1, (R - r * s % R) % R))
    return {"a": A, "b": B2, "c": C}


def verify(vk: VerifyingKey, proof: dict, pub_inputs: list[int]) -> bool:
    """e(A, B) == e(alpha, beta) * e(IC(pub), gamma) * e(C, delta)."""
    if len(pub_inputs) != len(vk.ic) - 1:
        return False
    acc = vk.ic[0]
    for pt, v in zip(vk.ic[1:], pub_inputs):
        acc = bn254.g1_add(acc, bn254.g1_mul(pt, int(v) % R))
    A, B2, C = proof["a"], proof["b"], proof["c"]
    if A is None or B2 is None or C is None:
        return False
    if not (bn254.g1_is_on_curve(A) and bn254.g1_is_on_curve(C)
            and bn254.g2_is_on_curve(B2) and bn254.g2_in_subgroup(B2)):
        return False
    # move everything to one side: e(-A, B) * e(alpha, beta)
    #   * e(acc, gamma) * e(C, delta) == 1
    neg_a = (A[0], (bn254.P - A[1]) % bn254.P)
    return bn254.pairing_check([
        (neg_a, B2),
        (vk.alpha1, vk.beta2),
        (acc, vk.gamma2),
        (C, vk.delta2),
    ])
