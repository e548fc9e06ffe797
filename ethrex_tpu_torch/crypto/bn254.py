"""alt_bn128 (BN254) field, curve and optimal ate pairing on the host.

A copy of `ethrex_tpu/crypto/bn254.py` (implemented from the curve
equations and the standard Fp2/Fp6/Fp12 tower construction), kept so that
the port's Groth16 prover and verifier (`crypto/groth16.py`) need nothing
of the JAX package.  Python integers throughout; the device MSM lives in
`ops/bn254_msm.py`.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# curve: y^2 = x^3 + 3 over Fp; twist: y^2 = x^3 + 3/(9+u) over Fp2
B = 3
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE = ATE_LOOP_COUNT.bit_length() - 1


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1), elements (a, b) = a + b*u
# ---------------------------------------------------------------------------

class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0 % P
        self.c1 = c1 % P

    ZERO = None
    ONE = None

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        ac = a * c
        bd = b * d
        return Fp2(ac - bd, (a + b) * (c + d) - ac - bd)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def inv(self):
        norm = _inv((self.c0 * self.c0 + self.c1 * self.c1) % P)
        return Fp2(self.c0 * norm, -self.c1 * norm)

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def mul_by_nonresidue(self):
        # xi = 9 + u
        a, b = self.c0, self.c1
        return Fp2(9 * a - b, a + 9 * b)


Fp2.ZERO = Fp2(0, 0)
Fp2.ONE = Fp2(1, 0)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi), elements (c0, c1, c2)
# ---------------------------------------------------------------------------

class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0, c1, c2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fp6(Fp2.ZERO, Fp2.ZERO, Fp2.ZERO)

    @staticmethod
    def one():
        return Fp6(Fp2.ONE, Fp2.ZERO, Fp2.ZERO)

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def mul_by_nonresidue(self):
        return Fp6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * a0 - (a1 * a2).mul_by_nonresidue()
        t1 = (a2 * a2).mul_by_nonresidue() - a0 * a1
        t2 = a1 * a1 - a0 * a2
        denom = a0 * t0 + (a2 * t1).mul_by_nonresidue() \
            + (a1 * t2).mul_by_nonresidue()
        dinv = denom.inv()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fp12(Fp6.one(), Fp6.zero())

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(t0 + t1.mul_by_nonresidue(),
                    (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        return self * self

    def inv(self):
        t = (self.c0 * self.c0
             - (self.c1 * self.c1).mul_by_nonresidue()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def conj(self):
        return Fp12(self.c0, -self.c1)

    def __eq__(self, o):
        c = self.c0
        d = o.c0
        return (c.c0 == d.c0 and c.c1 == d.c1 and c.c2 == d.c2
                and self.c1.c0 == o.c1.c0 and self.c1.c1 == o.c1.c1
                and self.c1.c2 == o.c1.c2)

    def pow(self, e: int):
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self):
        """x -> x^p."""
        c0 = _fp6_frob(self.c0)
        c1 = _fp6_frob(self.c1)
        # multiply c1 coefficients by gamma = xi^((p-1)/6) powers
        c1 = Fp6(c1.c0 * _FROB_GAMMA[0], c1.c1 * _FROB_GAMMA[2],
                 c1.c2 * _FROB_GAMMA[4])
        c0 = Fp6(c0.c0, c0.c1 * _FROB_GAMMA[1], c0.c2 * _FROB_GAMMA[3])
        return Fp12(c0, c1)


def _fp6_frob(x: Fp6) -> Fp6:
    return Fp6(x.c0.conj(), x.c1.conj(), x.c2.conj())


# gamma_i = xi^(i*(p-1)/6) in Fp2, xi = 9+u
_XI = Fp2(9, 1)


def _fp2_pow(x: Fp2, e: int) -> Fp2:
    r = Fp2.ONE
    b = x
    while e:
        if e & 1:
            r = r * b
        b = b * b
        e >>= 1
    return r


_FROB_GAMMA = [_fp2_pow(_XI, i * (P - 1) // 6) for i in range(1, 6)]


# ---------------------------------------------------------------------------
# G1 (affine over Fp) and G2 (affine over Fp2), None = infinity
# ---------------------------------------------------------------------------

G1 = (1, 2)
G2 = (
    Fp2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    Fp2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    b2 = Fp2(3, 0) * Fp2(9, 1).inv()
    lhs = y * y
    rhs = x * x * x + b2
    return lhs == rhs


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1 * x1 * 3) * (y1 * 2).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_in_subgroup(pt) -> bool:
    return pt is None or g2_mul(pt, R) is None


# ---------------------------------------------------------------------------
# optimal ate pairing
# ---------------------------------------------------------------------------

def _line(q1, q2, p):
    """Line through q1,q2 (G2 pts) evaluated at G1 point p -> sparse Fp12.

    Returns Fp12 element representing the line value using the standard
    D-type twist embedding: l = a + b*w + c*w^3 kind of sparse form; here we
    construct the full Fp12 for simplicity (correctness over speed).
    """
    px, py = p
    x1, y1 = q1
    x2, y2 = q2
    if not (x1 == x2):
        lam = (y2 - y1) * (x2 - x1).inv()
    elif (y1 + y2).is_zero():
        # vertical line: x - x1 evaluated at embedded p
        return _embed_vertical(x1, px)
    else:
        lam = (x1 * x1 * 3) * (y1 * 2).inv()
    # l(P) = lam * (x_P - x_Q) - (y_P - y_Q) with proper embedding:
    # embed G2 coords into Fp12 via twist: x' = x * w^2, y' = y * w^3
    # line: (y_P - y1') - lam' * (x_P - x1')
    # Using tower: w^2 = v => x' lives in c0.c1? We construct explicitly.
    # Fp12 element layout: c0 = (a0, a1, a2), c1 = (b0, b1, b2)
    # 1: c0.c0 ; w: c1.c0 ; w^2 = v: c0.c1 ; w^3 = v*w: c1.c1
    yp = _fp12_scalar(py)
    xq_w2 = _fp12_from(c0c1=x1)
    yq_w3 = _fp12_from(c1c1=y1)
    # untwisted slope is lam * w  (w: c1.c0 position)
    lam12 = Fp12(Fp6.zero(), Fp6(lam, Fp2.ZERO, Fp2.ZERO))
    xp = _fp12_scalar(px)
    return _sub12(_sub12(yp, yq_w3), lam12 * _sub12(xp, xq_w2))


def _embed_vertical(xq: Fp2, px: int):
    return _sub12(_fp12_scalar(px), _fp12_from(c0c1=xq))


def _fp12_scalar(a: int) -> Fp12:
    return Fp12(Fp6(Fp2(a, 0), Fp2.ZERO, Fp2.ZERO), Fp6.zero())


def _fp12_from(c0c0=None, c0c1=None, c1c1=None, fp2=None) -> Fp12:
    z = Fp2.ZERO
    if fp2 is not None:
        return Fp12(Fp6(fp2, z, z), Fp6.zero())
    c0 = Fp6(z if c0c0 is None else c0c0, z if c0c1 is None else c0c1, z)
    c1 = Fp6(z, z if c1c1 is None else c1c1, z)
    return Fp12(c0, c1)


def _sub12(a: Fp12, b: Fp12) -> Fp12:
    return Fp12(a.c0 - b.c0, a.c1 - b.c1)


def miller_loop(q, p) -> Fp12:
    """Miller loop for the optimal ate pairing e(P in G1, Q in G2)."""
    if p is None or q is None:
        return Fp12.one()
    f = Fp12.one()
    t = q
    for i in range(LOG_ATE - 1, -1, -1):
        f = f.square() * _line(t, t, p)
        t = g2_add(t, t)
        if (ATE_LOOP_COUNT >> i) & 1:
            f = f * _line(t, q, p)
            t = g2_add(t, q)
    # frobenius adjustment lines (optimal ate for BN curves)
    q1 = _g2_frob(q)
    q2 = g2_neg(_g2_frob(q1))
    f = f * _line(t, q1, p)
    t = g2_add(t, q1)
    f = f * _line(t, q2, p)
    return f


_FROB_X = _fp2_pow(_XI, (P - 1) // 3)
_FROB_Y = _fp2_pow(_XI, (P - 1) // 2)


def _g2_frob(pt):
    if pt is None:
        return None
    x, y = pt
    return (x.conj() * _FROB_X, y.conj() * _FROB_Y)


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r) — done the straightforward (slow) way with bignum
    exponent; fine for a correctness-first host precompile."""
    exp = (P ** 12 - 1) // R
    return f.pow(exp)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 ?  pairs: [(g1_pt, g2_pt)]."""
    acc = Fp12.one()
    for p1, q2 in pairs:
        acc = acc * miller_loop(q2, p1)
    return final_exponentiation(acc) == Fp12.one()


def pairing(p1, q2) -> Fp12:
    return final_exponentiation(miller_loop(q2, p1))
