"""secp256k1 ECDSA: recover (the consensus-critical op), sign, verify.

A copy of `ethrex_tpu/crypto/secp256k1.py`: Jacobian arithmetic and a
Shamir double-scalar multiply for recovery (`recover`, the oracle of the
native engine), RFC 6979 deterministic nonces for signing;
`recover_address` dispatches to the native engine
(`crypto/native_secp256k1.py`), as the reference's does.
"""

from __future__ import annotations

import hashlib
import hmac

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7

_INF = None  # point at infinity sentinel


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


# Jacobian coordinates (X, Y, Z); affine = (X/Z^2, Y/Z^3)

def _to_jac(pt):
    if pt is _INF:
        return (0, 1, 0)
    return (pt[0], pt[1], 1)


def _from_jac(j):
    X, Y, Z = j
    if Z == 0:
        return _INF
    zi = _inv(Z, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _jac_double(j):
    X, Y, Z = j
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    S = 4 * X * Y % P * Y % P
    M = 3 * X % P * X % P
    X2 = (M * M - 2 * S) % P
    Y2 = (M * (S - X2) - 8 * pow(Y, 4, P)) % P
    Z2 = 2 * Y * Z % P
    return (X2, Y2, Z2)


def _jac_add(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return (0, 1, 0)
        return _jac_double(j1)
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    HH = H * H % P
    HHH = HH * H % P
    V = U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    Z3 = H * Z1 % P * Z2 % P
    return (X3, Y3, Z3)


def _mul(pt, k: int):
    k %= N
    if k == 0 or pt is _INF:
        return _INF
    acc = (0, 1, 0)
    add = _to_jac(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _from_jac(acc)


def _double_mul(k1: int, pt1, k2: int, pt2):
    """k1*pt1 + k2*pt2 (Shamir's trick)."""
    j1, j2 = _to_jac(pt1), _to_jac(pt2)
    both = _jac_add(j1, j2)
    acc = (0, 1, 0)
    bits = max(k1.bit_length(), k2.bit_length())
    for i in range(bits - 1, -1, -1):
        acc = _jac_double(acc)
        b1 = (k1 >> i) & 1
        b2 = (k2 >> i) & 1
        if b1 and b2:
            acc = _jac_add(acc, both)
        elif b1:
            acc = _jac_add(acc, j1)
        elif b2:
            acc = _jac_add(acc, j2)
    return _from_jac(acc)


G = (GX, GY)


def is_on_curve(pt) -> bool:
    if pt is _INF:
        return False
    x, y = pt
    return (y * y - (x * x * x + A * x + B)) % P == 0


def pubkey_from_secret(secret: int):
    return _mul(G, secret)


def sign(msg_hash: bytes, secret: int) -> tuple[int, int, int]:
    """Returns (r, s, recovery_id) with low-s normalization (EIP-2)."""
    z = int.from_bytes(msg_hash, "big") % N
    k = _rfc6979_k(msg_hash, secret)
    while True:
        R = _mul(G, k)
        r = R[0] % N
        if r == 0:
            k = (k + 1) % N
            continue
        s = _inv(k, N) * (z + r * secret) % N
        if s == 0:
            k = (k + 1) % N
            continue
        rec_id = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:
            s = N - s
            rec_id ^= 1
        return r, s, rec_id


def _rfc6979_k(msg_hash: bytes, secret: int) -> int:
    x = secret.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def recover(msg_hash: bytes, r: int, s: int, rec_id: int):
    """Recover the public key point, or None if the signature is invalid.

    rec_id in [0, 3]; enforces r, s in [1, N) and low-s is NOT enforced here
    (the tx layer enforces EIP-2 where required).
    """
    if not (1 <= r < N and 1 <= s < N and 0 <= rec_id <= 3):
        return None
    x = r + (N if rec_id >= 2 else 0)
    if x >= P:
        return None
    y_sq = (pow(x, 3, P) + B) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if (y & 1) != (rec_id & 1):
        y = P - y
    R = (x, y)
    z = int.from_bytes(msg_hash, "big") % N
    r_inv = _inv(r, N)
    # Q = r^{-1} (s*R - z*G)
    u1 = (-z * r_inv) % N
    u2 = (s * r_inv) % N
    Q = _double_mul(u1, G, u2, R)
    if Q is _INF or not is_on_curve(Q):
        return None
    return Q


def verify(msg_hash: bytes, r: int, s: int, pubkey) -> bool:
    if not (1 <= r < N and 1 <= s < N) or pubkey is _INF:
        return False
    z = int.from_bytes(msg_hash, "big") % N
    s_inv = _inv(s, N)
    u1 = z * s_inv % N
    u2 = r * s_inv % N
    pt = _double_mul(u1, G, u2, pubkey)
    if pt is _INF:
        return False
    return pt[0] % N == r


def pubkey_to_address(pubkey) -> bytes:
    from .keccak import keccak256

    x, y = pubkey
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def recover_address(msg_hash: bytes, r: int, s: int, rec_id: int):
    """Recover the 20-byte sender address, or None.

    Runs in the native engine (same acceptance set, held against
    ``recover``); ``recover`` above stays pure Python and is the
    behavioral oracle.
    """
    from . import native_secp256k1
    from .keccak import keccak256

    raw = native_secp256k1.recover_pubkey_bytes(msg_hash, r, s, rec_id)
    if raw is None:
        return None
    return keccak256(raw)[12:]
