"""NIST P-256 (secp256r1) ECDSA verification for the P256VERIFY
precompile (RIP-7212 / EIP-7951 semantics): a copy of
`ethrex_tpu/crypto/p256.py`.

Jacobian arithmetic specialised for a = -3 short-Weierstrass curves;
verification only — the execution layer never signs with P-256.
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

_INF = None  # Jacobian point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def is_on_curve(x: int, y: int) -> bool:
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x - 3 * x + B)) % P == 0


def _jac_double(pt):
    if pt is _INF:
        return _INF
    x, y, z = pt
    if y == 0:
        return _INF
    zz = z * z % P
    # a = -3 trick: M = 3(x - z^2)(x + z^2)
    m = 3 * (x - zz) * (x + zz) % P
    yy = y * y % P
    s = 4 * x * yy % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * yy * yy) % P
    z3 = 2 * y * z % P
    return x3, y3, z3


def _jac_add(p1, p2):
    if p1 is _INF:
        return p2
    if p2 is _INF:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2z2 % P * z2 % P
    s2 = y2 * z1z1 % P * z1 % P
    if u1 == u2:
        if s1 != s2:
            return _INF
        return _jac_double(p1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = hh * h % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = h * z1 % P * z2 % P
    return x3, y3, z3


def _double_mul(k1: int, k2: int, qx: int, qy: int):
    """k1*G + k2*Q by interleaved (Shamir) double-and-add."""
    g = (GX, GY, 1)
    q = (qx, qy, 1)
    gq = _jac_add(g, q)
    acc = _INF
    for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
        acc = _jac_double(acc)
        b1, b2 = (k1 >> i) & 1, (k2 >> i) & 1
        if b1 and b2:
            acc = _jac_add(acc, gq)
        elif b1:
            acc = _jac_add(acc, g)
        elif b2:
            acc = _jac_add(acc, q)
    return acc


def verify(msg_hash: bytes, r: int, s: int, qx: int, qy: int) -> bool:
    """Standard ECDSA verification; malleable s is accepted (both RIP-7212
    and EIP-7951 do not enforce low-s)."""
    if not (1 <= r < N and 1 <= s < N):
        return False
    if not is_on_curve(qx, qy) or (qx == 0 and qy == 0):
        return False
    e = int.from_bytes(msg_hash[:32], "big") % N
    s_inv = _inv(s, N)
    u1 = e * s_inv % N
    u2 = r * s_inv % N
    pt = _double_mul(u1, u2, qx, qy)
    if pt is _INF:
        return False
    x, _, z = pt
    zz = z * z % P
    # r == x-affine mod n without a full affine conversion
    return (x - (r % P) * zz) % P == 0 or (
        r + N < P and (x - ((r + N) % P) * zz) % P == 0)


def sign_for_tests(msg_hash: bytes, secret: int) -> tuple[int, int]:
    """Deterministic-ish signer used only by tests to produce valid
    (r, s) pairs; not constant-time, never used in production paths."""
    import hashlib
    e = int.from_bytes(msg_hash[:32], "big") % N
    k = int.from_bytes(hashlib.sha256(
        secret.to_bytes(32, "big") + msg_hash).digest(), "big") % N or 1
    kg = _double_mul(k, 0, GX, GY)
    x, y, z = kg
    zinv = _inv(z, P)
    r = (x * zinv * zinv) % P % N
    s = _inv(k, N) * (e + r * secret) % N
    return r, s


def pubkey_from_secret(secret: int) -> tuple[int, int]:
    pt = _double_mul(secret, 0, GX, GY)
    x, y, z = pt
    zinv = _inv(z, P)
    return (x * zinv * zinv) % P, (y * zinv * zinv * zinv) % P
