"""EVM precompiled contracts 0x01-0x11 + P256VERIFY: a copy of
`ethrex_tpu/evm/precompiles.py`.

Each entry: fn(data, available_gas, fork) -> (gas_cost, output); raises
PrecompileError for invalid input (the caller treats it as call failure,
consuming all forwarded gas).

KZG point evaluation (0x0a) imports crypto/kzg.py and the BLS12-381 suite
(0x0b..0x0f) crypto/bls12_381.py when first called (pure Python, on the
host; a pairing takes seconds).  The two RFC 9380 map-to-curve
precompiles (0x10/0x11) fail closed pending the published isogeny
constant tables.
"""

from __future__ import annotations

import hashlib

from ..crypto import bn254, p256, secp256k1
from ..primitives.genesis import Fork
from . import gas as G


class PrecompileError(Exception):
    pass


def _words(n: int) -> int:
    return (n + 31) // 32


def _ecrecover(data: bytes, gas: int, fork) -> tuple[int, bytes]:
    cost = 3000
    data = data.ljust(128, b"\x00")[:128]
    h = data[0:32]
    v = int.from_bytes(data[32:64], "big")
    r = int.from_bytes(data[64:96], "big")
    s = int.from_bytes(data[96:128], "big")
    if v not in (27, 28):
        return cost, b""
    addr = secp256k1.recover_address(h, r, s, v - 27)
    if addr is None:
        return cost, b""
    return cost, b"\x00" * 12 + addr


def _sha256(data: bytes, gas: int, fork):
    return 60 + 12 * _words(len(data)), hashlib.sha256(data).digest()


def _ripemd160(data: bytes, gas: int, fork):
    cost = 600 + 120 * _words(len(data))
    h = hashlib.new("ripemd160", data).digest()
    return cost, b"\x00" * 12 + h


def _identity(data: bytes, gas: int, fork):
    return 15 + 3 * _words(len(data)), data


def _modexp(data: bytes, gas: int, fork):
    data = bytes(data)
    bsize = int.from_bytes(data[0:32].ljust(32, b"\x00"), "big")
    esize = int.from_bytes(data[32:64].ljust(32, b"\x00"), "big")
    msize = int.from_bytes(data[64:96].ljust(32, b"\x00"), "big")
    eip2565 = fork >= Fork.BERLIN
    if bsize == 0 and msize == 0 and eip2565:
        return 200, b""
    if max(bsize, esize, msize) > 1_000_000:
        # EIP-7823-style upper bound guard; also protects the host
        raise PrecompileError("modexp size too large")
    body = data[96:]
    # EIP-2565 gas — computed from the header + the 32-byte exponent head
    # ONLY, before any big-int materialization, so oversized operands are
    # rejected by the gas check without doing the pow (DoS guard).
    exp_head = int.from_bytes(body[bsize:bsize + min(esize, 32)]
                              .ljust(min(esize, 32), b"\x00"), "big")
    max_len = max(bsize, msize)
    if esize <= 32:
        iter_count = max(exp_head.bit_length() - 1, 0)
    else:
        iter_count = 8 * (esize - 32) + max(exp_head.bit_length() - 1, 0)
    iter_count = max(iter_count, 1)
    if eip2565:
        mult_complexity = _words(max_len) ** 2
        cost = max(200, mult_complexity * iter_count // 3)
    else:
        # EIP-198 multiplication-complexity schedule (pre-Berlin)
        x = max_len
        if x <= 64:
            mult_complexity = x * x
        elif x <= 1024:
            mult_complexity = x * x // 4 + 96 * x - 3072
        else:
            mult_complexity = x * x // 16 + 480 * x - 199680
        cost = mult_complexity * iter_count // 20
    if gas < cost:
        return cost, b""   # skip the pow when OOG anyway
    base = int.from_bytes(body[:bsize].ljust(bsize, b"\x00"), "big")
    exp = int.from_bytes(body[bsize:bsize + esize].ljust(esize, b"\x00"),
                         "big")
    mod = int.from_bytes(
        body[bsize + esize:bsize + esize + msize].ljust(msize, b"\x00"), "big")
    if mod == 0:
        out = 0
    else:
        out = pow(base, exp, mod)
    return cost, out.to_bytes(msize, "big")


def _bn_point(data: bytes, off: int):
    x = int.from_bytes(data[off:off + 32], "big")
    y = int.from_bytes(data[off + 32:off + 64], "big")
    if x >= bn254.P or y >= bn254.P:
        raise PrecompileError("bn254 coordinate >= p")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not bn254.g1_is_on_curve(pt):
        raise PrecompileError("bn254 point not on curve")
    return pt


def _ecadd(data: bytes, gas: int, fork):
    cost = 150 if fork >= Fork.ISTANBUL else 500   # EIP-1108
    data = bytes(data).ljust(128, b"\x00")
    p1 = _bn_point(data, 0)
    p2 = _bn_point(data, 64)
    out = bn254.g1_add(p1, p2)
    if out is None:
        return cost, b"\x00" * 64
    return cost, out[0].to_bytes(32, "big") + out[1].to_bytes(32, "big")


def _ecmul(data: bytes, gas: int, fork):
    cost = 6000 if fork >= Fork.ISTANBUL else 40000   # EIP-1108
    data = bytes(data).ljust(96, b"\x00")
    p1 = _bn_point(data, 0)
    k = int.from_bytes(data[64:96], "big")
    out = bn254.g1_mul(p1, k) if p1 is not None else None
    if out is None:
        return cost, b"\x00" * 64
    return cost, out[0].to_bytes(32, "big") + out[1].to_bytes(32, "big")


def _ecpairing(data: bytes, gas: int, fork):
    data = bytes(data)
    if len(data) % 192 != 0:
        raise PrecompileError("pairing input not multiple of 192")
    npairs = len(data) // 192
    if fork >= Fork.ISTANBUL:
        cost = 45000 + 34000 * npairs
    else:
        cost = 100000 + 80000 * npairs   # pre-EIP-1108
    if gas < cost:
        return cost, b""   # skip the expensive pairing work when OOG anyway
    pairs = []
    for i in range(npairs):
        off = i * 192
        p1 = _bn_point(data, off)
        # G2 point: coords encoded as (imag, real) per spec
        x_i = int.from_bytes(data[off + 64:off + 96], "big")
        x_r = int.from_bytes(data[off + 96:off + 128], "big")
        y_i = int.from_bytes(data[off + 128:off + 160], "big")
        y_r = int.from_bytes(data[off + 160:off + 192], "big")
        for c in (x_i, x_r, y_i, y_r):
            if c >= bn254.P:
                raise PrecompileError("bn254 g2 coordinate >= p")
        if x_i == x_r == y_i == y_r == 0:
            q = None
        else:
            q = (bn254.Fp2(x_r, x_i), bn254.Fp2(y_r, y_i))
            if not bn254.g2_is_on_curve(q):
                raise PrecompileError("g2 point not on curve")
            if not bn254.g2_in_subgroup(q):
                raise PrecompileError("g2 point not in subgroup")
        if p1 is not None and q is not None:
            pairs.append((p1, q))
    ok = bn254.pairing_check(pairs) if pairs else True
    return cost, (1 if ok else 0).to_bytes(32, "big")


# blake2f (EIP-152) --------------------------------------------------------

_B2_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_B2_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_M64 = (1 << 64) - 1


def _b2_g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M64
    v[d] = _ror64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & _M64
    v[d] = _ror64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 63)


def _ror64(x, n):
    return ((x >> n) | (x << (64 - n))) & _M64


def _blake2f(data: bytes, gas: int, fork):
    if len(data) != 213:
        raise PrecompileError("blake2f input must be 213 bytes")
    rounds = int.from_bytes(data[0:4], "big")
    cost = rounds
    if gas < cost:
        return cost, b""   # skip the rounds when OOG anyway
    h = [int.from_bytes(data[4 + 8 * i:12 + 8 * i], "little")
         for i in range(8)]
    m = [int.from_bytes(data[68 + 8 * i:76 + 8 * i], "little")
         for i in range(16)]
    t0 = int.from_bytes(data[196:204], "little")
    t1 = int.from_bytes(data[204:212], "little")
    final = data[212]
    if final not in (0, 1):
        raise PrecompileError("blake2f bad final flag")
    v = h[:] + _B2_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64
    for r in range(rounds):
        s = _B2_SIGMA[r % 10]
        _b2_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _b2_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _b2_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _b2_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _b2_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _b2_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _b2_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _b2_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    out = b"".join(
        ((h[i] ^ v[i] ^ v[i + 8]) & _M64).to_bytes(8, "little")
        for i in range(8))
    return cost, out


def _kzg_point_eval(data: bytes, gas: int, fork):
    """EIP-4844 point evaluation (0x0a), verified by crypto/kzg.py."""
    from ..crypto import kzg

    cost = 50_000
    if gas < cost:
        return cost, b""
    try:
        return cost, kzg.point_evaluation(bytes(data))
    except kzg.KzgError as e:
        raise PrecompileError(f"point evaluation failed: {e}")


# ---------------------------------------------------------------------------
# EIP-2537: BLS12-381 precompiles (0x0b..0x11), Prague
# Gas constants and MSM discount tables are the EIP's published values.
# ---------------------------------------------------------------------------

_BLS_G1_ADD_COST = 375
_BLS_G2_ADD_COST = 600
_BLS_G1_MUL_COST = 12_000
_BLS_G2_MUL_COST = 22_500
_BLS_MSM_MULTIPLIER = 1000
_BLS_PAIRING_MUL_COST = 32_600
_BLS_PAIRING_FIXED_COST = 37_700
_BLS_G1_DISCOUNT = [
    1000, 949, 848, 797, 764, 750, 738, 728, 719, 712, 705, 698, 692, 687,
    682, 677, 673, 669, 665, 661, 658, 654, 651, 648, 645, 642, 640, 637,
    635, 632, 630, 627, 625, 623, 621, 619, 617, 615, 613, 611, 609, 608,
    606, 604, 603, 601, 599, 598, 596, 595, 593, 592, 591, 589, 588, 586,
    585, 584, 582, 581, 580, 579, 577, 576, 575, 574, 573, 572, 570, 569,
    568, 567, 566, 565, 564, 563, 562, 561, 560, 559, 558, 557, 556, 555,
    554, 553, 552, 551, 550, 549, 548, 547, 547, 546, 545, 544, 543, 542,
    541, 540, 540, 539, 538, 537, 536, 536, 535, 534, 533, 532, 532, 531,
    530, 529, 528, 528, 527, 526, 525, 525, 524, 523, 522, 522, 521, 520,
    520, 519,
]
_BLS_G2_DISCOUNT = [
    1000, 1000, 923, 884, 855, 832, 812, 796, 782, 770, 759, 749, 740,
    732, 724, 717, 711, 704, 699, 693, 688, 683, 679, 674, 670, 666, 663,
    659, 655, 652, 649, 646, 643, 640, 637, 634, 632, 629, 627, 624, 622,
    620, 618, 615, 613, 611, 609, 607, 606, 604, 602, 600, 598, 597, 595,
    593, 592, 590, 589, 587, 586, 584, 583, 582, 580, 579, 578, 576, 575,
    574, 573, 571, 570, 569, 568, 567, 566, 565, 563, 562, 561, 560, 559,
    558, 557, 556, 555, 554, 553, 552, 552, 551, 550, 549, 548, 547, 546,
    545, 545, 544, 543, 542, 541, 541, 540, 539, 538, 537, 537, 536, 535,
    535, 534, 533, 532, 532, 531, 530, 530, 529, 528, 528, 527, 526, 526,
    525, 524, 524,
]


def _bls_msm_cost(k: int, discounts, mul_cost: int) -> int:
    d = discounts[k - 1] if k <= len(discounts) else discounts[-1]
    return k * mul_cost * d // _BLS_MSM_MULTIPLIER


def _bls_g1_add(data: bytes, gas: int, fork):
    from ..crypto import bls12_381 as bls

    cost = _BLS_G1_ADD_COST
    if gas < cost:
        return cost, b""
    if len(data) != 256:
        raise PrecompileError("G1ADD input must be 256 bytes")
    try:
        # EIP-2537: ADD does NOT require subgroup membership
        p1 = bls.decode_g1(bytes(data[:128]), subgroup_check=False)
        p2 = bls.decode_g1(bytes(data[128:]), subgroup_check=False)
    except bls.DecodeError as e:
        raise PrecompileError(str(e))
    return cost, bls.encode_g1(bls.g1_add(p1, p2))


def _bls_g2_add(data: bytes, gas: int, fork):
    from ..crypto import bls12_381 as bls

    cost = _BLS_G2_ADD_COST
    if gas < cost:
        return cost, b""
    if len(data) != 512:
        raise PrecompileError("G2ADD input must be 512 bytes")
    try:
        p1 = bls.decode_g2(bytes(data[:256]), subgroup_check=False)
        p2 = bls.decode_g2(bytes(data[256:]), subgroup_check=False)
    except bls.DecodeError as e:
        raise PrecompileError(str(e))
    return cost, bls.encode_g2(bls.g2_add(p1, p2))


def _bls_g1_msm(data: bytes, gas: int, fork):
    from ..crypto import bls12_381 as bls

    if not data or len(data) % 160:
        raise PrecompileError("G1MSM input must be k*160 bytes, k >= 1")
    k = len(data) // 160
    cost = _bls_msm_cost(k, _BLS_G1_DISCOUNT, _BLS_G1_MUL_COST)
    if gas < cost:
        return cost, b""
    acc = None
    data = bytes(data)
    try:
        for i in range(k):
            chunk = data[i * 160:(i + 1) * 160]
            p = bls.decode_g1(chunk[:128], subgroup_check=True)
            s = int.from_bytes(chunk[128:], "big")
            acc = bls.g1_add(acc, bls.g1_mul(p, s % bls.R))
    except bls.DecodeError as e:
        raise PrecompileError(str(e))
    return cost, bls.encode_g1(acc)


def _bls_g2_msm(data: bytes, gas: int, fork):
    from ..crypto import bls12_381 as bls

    if not data or len(data) % 288:
        raise PrecompileError("G2MSM input must be k*288 bytes, k >= 1")
    k = len(data) // 288
    cost = _bls_msm_cost(k, _BLS_G2_DISCOUNT, _BLS_G2_MUL_COST)
    if gas < cost:
        return cost, b""
    acc = None
    data = bytes(data)
    try:
        for i in range(k):
            chunk = data[i * 288:(i + 1) * 288]
            p = bls.decode_g2(chunk[:256], subgroup_check=True)
            s = int.from_bytes(chunk[256:], "big")
            acc = bls.g2_add(acc, bls.g2_mul(p, s % bls.R))
    except bls.DecodeError as e:
        raise PrecompileError(str(e))
    return cost, bls.encode_g2(acc)


def _bls_pairing(data: bytes, gas: int, fork):
    from ..crypto import bls12_381 as bls

    if not data or len(data) % 384:
        raise PrecompileError("PAIRING input must be k*384 bytes, k >= 1")
    k = len(data) // 384
    cost = _BLS_PAIRING_MUL_COST * k + _BLS_PAIRING_FIXED_COST
    if gas < cost:
        return cost, b""
    pairs = []
    data = bytes(data)
    try:
        for i in range(k):
            chunk = data[i * 384:(i + 1) * 384]
            p = bls.decode_g1(chunk[:128], subgroup_check=True)
            q = bls.decode_g2(chunk[128:], subgroup_check=True)
            pairs.append((p, q))
    except bls.DecodeError as e:
        raise PrecompileError(str(e))
    ok = bls.pairing_check(pairs)
    return cost, (1).to_bytes(32, "big") if ok else b"\x00" * 32


def _bls_map_fp_to_g1(data: bytes, gas: int, fork):
    # RFC 9380 SSWU + 11-isogeny constants are not derivable in-image;
    # fail closed until the published constant tables are vendored.
    raise PrecompileError(
        "MAP_FP_TO_G1 requires the RFC 9380 isogeny constant tables "
        "(not yet embedded)")


def _bls_map_fp2_to_g2(data: bytes, gas: int, fork):
    raise PrecompileError(
        "MAP_FP2_TO_G2 requires the RFC 9380 isogeny constant tables "
        "(not yet embedded)")


def _p256_verify(data: bytes, gas: int, fork) -> tuple[int, bytes]:
    """P256VERIFY (RIP-7212 / EIP-7951, address 0x100): 160-byte input
    hash||r||s||qx||qy; returns 32-byte 1 on valid signature, empty
    otherwise.  Any malformed input is a failed verification (empty
    output), never an exceptional halt."""
    cost = 6900
    if len(data) != 160:
        return cost, b""
    h = data[0:32]
    r = int.from_bytes(data[32:64], "big")
    s = int.from_bytes(data[64:96], "big")
    qx = int.from_bytes(data[96:128], "big")
    qy = int.from_bytes(data[128:160], "big")
    ok = p256.verify(h, r, s, qx, qy)
    return cost, (1).to_bytes(32, "big") if ok else b""


def _a(n: int) -> bytes:
    return n.to_bytes(20, "big")


PRECOMPILES = {
    _a(1): _ecrecover,
    _a(2): _sha256,
    _a(3): _ripemd160,
    _a(4): _identity,
    _a(5): _modexp,
    _a(6): _ecadd,
    _a(7): _ecmul,
    _a(8): _ecpairing,
    _a(9): _blake2f,
    _a(10): _kzg_point_eval,
    _a(0x0B): _bls_g1_add,
    _a(0x0C): _bls_g1_msm,
    _a(0x0D): _bls_g2_add,
    _a(0x0E): _bls_g2_msm,
    _a(0x0F): _bls_pairing,
    _a(0x10): _bls_map_fp_to_g1,
    _a(0x11): _bls_map_fp2_to_g2,
    _a(0x100): _p256_verify,
}

# precompiles that only exist from a given fork onward; absent entries are
# active on every supported fork (all pre-date our earliest target chains)
PRECOMPILE_FORKS = {
    _a(5): Fork.BYZANTIUM,   # modexp, EIP-198
    _a(6): Fork.BYZANTIUM,   # bn254 add, EIP-196
    _a(7): Fork.BYZANTIUM,   # bn254 mul
    _a(8): Fork.BYZANTIUM,   # bn254 pairing, EIP-197
    _a(9): Fork.ISTANBUL,    # blake2f, EIP-152
    _a(10): Fork.CANCUN,     # point evaluation, EIP-4844
    _a(0x0B): Fork.PRAGUE,   # EIP-2537 BLS12-381 suite
    _a(0x0C): Fork.PRAGUE,
    _a(0x0D): Fork.PRAGUE,
    _a(0x0E): Fork.PRAGUE,
    _a(0x0F): Fork.PRAGUE,
    _a(0x10): Fork.PRAGUE,
    _a(0x11): Fork.PRAGUE,
    _a(0x100): Fork.OSAKA,   # P256VERIFY, EIP-7951
}


def active_precompiles(fork):
    """Addresses that behave as precompiles at `fork`; anything else at
    those addresses is an ordinary (empty) account."""
    return {a for a in PRECOMPILES
            if fork >= PRECOMPILE_FORKS.get(a, Fork.FRONTIER)}


def get_precompile(addr: bytes, fork):
    if fork < PRECOMPILE_FORKS.get(addr, Fork.FRONTIER):
        return None
    return PRECOMPILES.get(addr)
