"""BLS12-381 G1 and G2 in plain Python integers: the reference's own curve
arithmetic, written from the curve's public definition (the IETF
pairing-friendly-curves draft, section 4.2.1), imports nothing.

G1: y^2 = x^3 + 4 over Fp.  G2: y^2 = x^3 + 4(u + 1) over Fp2 = Fp[u] /
(u^2 + 1).  Points are affine tuples, None at infinity; an Fp2 element is
(c0, c1) = c0 + c1 u.  Scalar multiplication is double-and-add in
Jacobian coordinates, one inversion at the end.
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2 = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


class Fp:
    """Field operations on plain ints mod P (the G1 coordinates)."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def is_zero(a):
        return a % P == 0


class Fp2:
    """Field operations on (c0, c1) = c0 + c1 u, u^2 = -1."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P,
                ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * n % P, -a[1] * n % P)

    @staticmethod
    def is_zero(a):
        return a[0] % P == 0 and a[1] % P == 0


def _double(F, pt):
    """2·(X, Y, Z) in Jacobian coordinates, a = 0."""
    X, Y, Z = pt
    if F.is_zero(Z) or F.is_zero(Y):
        return (F.one, F.one, F.zero)
    A = F.mul(X, X)
    B = F.mul(Y, Y)
    C = F.mul(B, B)
    XB = F.add(X, B)
    D = F.sub(F.sub(F.mul(XB, XB), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.mul(E, E), F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y, Z)
    return (X3, Y3, F.add(YZ, YZ))


def _add_affine(F, pt, q):
    """(X, Y, Z) + affine q, Jacobian."""
    X1, Y1, Z1 = pt
    if F.is_zero(Z1):
        return (q[0], q[1], F.one)
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(q[0], Z1Z1)
    S2 = F.mul(F.mul(q[1], Z1), Z1Z1)
    H = F.sub(U2, X1)
    rr = F.sub(S2, Y1)
    if F.is_zero(H):
        if F.is_zero(rr):
            return _double(F, pt)
        return (F.one, F.one, F.zero)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.mul(rr, rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul(Y1, HHH))
    return (X3, Y3, F.mul(Z1, H))


def _to_affine(F, pt):
    X, Y, Z = pt
    if F.is_zero(Z):
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi)))


def _mul(F, base, k: int):
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:] if k else "":
        acc = _double(F, acc)
        if bit == "1":
            acc = _add_affine(F, acc, base)
    return _to_affine(F, acc)


def g1_mul(k: int, base=G1):
    """k·base on G1, affine (x, y) or None."""
    return _mul(Fp, base, k)


def g2_mul(k: int, base=G2):
    """k·base on G2, affine ((x0, x1), (y0, y1)) or None."""
    return _mul(Fp2, base, k)


def g1_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 4) % P == 0


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    rhs = Fp2.add(Fp2.mul(Fp2.mul(x, x), x), (4, 4))
    return Fp2.sub(Fp2.mul(y, y), rhs) == (0, 0)
