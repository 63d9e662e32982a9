"""Circuit gadget library over the R1CS substrate
(reference: src/zk/groth16/gadgets/).

Semantics mirror the reference's bellman gadgets — lazy linear
combinations (`Num`), booleans, muxes, bit-decomposition range proofs,
in-circuit Poseidon, 4-ary Merkle proofs, JubJub EdDSA verification and
state-model reveal — with our own constraint ordering (keys are
self-generated; SURVEY.md §7 hard-part #3 fallback).

A copy of `bazuka_tpu/groth16/gadgets.py`."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..crypto import jubjub as jj
from ..fields.host import FR, FR_MODULUS
from ..zk.poseidon_host import params_for_width
from .r1cs import ONE, ConstraintSystem, SynthesisError, lc_add, lc_scale, lc_sub

P = FR_MODULUS


class Num:
    """Lazy linear combination + optional value
    (reference: gadgets/common/number.rs)."""

    __slots__ = ("lc", "value")

    def __init__(self, lc=None, value: Optional[int] = None):
        self.lc = lc or {}
        self.value = value % P if value is not None else None

    # -- constructors

    @staticmethod
    def zero() -> "Num":
        return Num({}, 0)

    @staticmethod
    def one() -> "Num":
        return Num({ONE: 1}, 1)

    @staticmethod
    def constant(k: int) -> "Num":
        k %= P
        return Num({ONE: k} if k else {}, k)

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[int]) -> "Num":
        var = cs.alloc(value if cs.proving else None)
        return Num({var: 1}, value if cs.proving else None)

    @staticmethod
    def alloc_input(cs: ConstraintSystem, value: Optional[int]) -> "Num":
        var = cs.alloc_input(value if cs.proving else None)
        return Num({var: 1}, value if cs.proving else None)

    # -- linear ops (free)

    def __add__(self, other: "Num") -> "Num":
        v = None
        if self.value is not None and other.value is not None:
            v = (self.value + other.value) % P
        return Num(lc_add(self.lc, other.lc), v)

    def __sub__(self, other: "Num") -> "Num":
        v = None
        if self.value is not None and other.value is not None:
            v = (self.value - other.value) % P
        return Num(lc_sub(self.lc, other.lc), v)

    def scale(self, k: int) -> "Num":
        v = self.value * k % P if self.value is not None else None
        return Num(lc_scale(self.lc, k), v)

    def add_const(self, k: int) -> "Num":
        return self + Num.constant(k)

    # -- constraints

    def mul(self, cs: ConstraintSystem, other: "Num") -> "Num":
        """One constraint: self * other = out."""
        v = None
        if self.value is not None and other.value is not None:
            v = self.value * other.value % P
        out = Num.alloc(cs, v)
        cs.enforce(self.lc, other.lc, out.lc)
        return out

    def compress(self, cs: ConstraintSystem) -> "Num":
        """Collapse a multi-term LC into one allocated variable."""
        if len(self.lc) <= 1:
            return self
        out = Num.alloc(cs, self.value)
        cs.enforce(self.lc, {ONE: 1}, out.lc)
        return out

    def is_zero(self, cs: ConstraintSystem) -> "Bool":
        """2 constraints (reference: number.rs is_zero)."""
        if cs.proving:
            v = self.value
            out_v = 1 if v == 0 else 0
            inv_v = 0 if v == 0 else FR.inv(v)
        else:
            out_v = inv_v = None
        out = Num.alloc(cs, out_v)
        inv = Num.alloc(cs, inv_v)
        # num * inv == 1 - out ;  num * out == 0
        cs.enforce(self.lc, inv.lc, (Num.one() - out).lc)
        cs.enforce(self.lc, out.lc, {})
        return Bool(out)

    def is_equal(self, cs: ConstraintSystem, other: "Num") -> "Bool":
        return (self - other).is_zero(cs)

    def assert_equal(self, cs: ConstraintSystem, other: "Num"):
        cs.enforce(self.lc, {ONE: 1}, other.lc)

    def assert_equal_if_enabled(self, cs: ConstraintSystem, enabled: "Bool",
                                other: "Num"):
        """enabled * (self - other) == 0."""
        cs.enforce(enabled.num.lc, (self - other).lc, {})


class Bool:
    """A Num constrained to {0, 1}."""

    __slots__ = ("num",)

    def __init__(self, num: Num):
        self.num = num

    @property
    def value(self) -> Optional[bool]:
        return None if self.num.value is None else bool(self.num.value)

    @staticmethod
    def constant(v: bool) -> "Bool":
        return Bool(Num.constant(1 if v else 0))

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[bool]) -> "Bool":
        b = Num.alloc(cs, None if value is None else int(bool(value)))
        # b * (1 - b) == 0
        cs.enforce(b.lc, (Num.one() - b).lc, {})
        return Bool(b)

    def not_(self) -> "Bool":
        return Bool(Num.one() - self.num)

    def and_(self, cs: ConstraintSystem, other: "Bool") -> "Bool":
        return Bool(self.num.mul(cs, other.num))

    def or_(self, cs: ConstraintSystem, other: "Bool") -> "Bool":
        """¬(¬a ∧ ¬b) (reference: boolean.rs boolean_or)."""
        return self.not_().and_(cs, other.not_()).not_()

    def assert_true(self, cs: ConstraintSystem):
        self.num.assert_equal(cs, Num.one())

    def assert_true_if_enabled(self, cs: ConstraintSystem, enabled: "Bool"):
        self.num.assert_equal_if_enabled(cs, enabled, Num.one())


def mux(cs: ConstraintSystem, select: Bool, a: Num, b: Num) -> Num:
    """select ? b : a — one constraint (a-b)*s == a-out
    (reference: mux.rs)."""
    if select.num.value is not None and a.value is not None and b.value is not None:
        v = b.value if select.num.value else a.value
    else:
        v = None
    out = Num.alloc(cs, v)
    cs.enforce((a - b).lc, select.num.lc, (a - out).lc)
    return out


# ---------------------------------------------------------------- uint


class UnsignedInteger:
    """Bit-decomposed nonnegative integer (reference: common/uint.rs)."""

    def __init__(self, num: Num, bits: List[Bool]):
        self.num = num
        self.bits = bits

    @property
    def num_bits(self) -> int:
        return len(self.bits)

    @staticmethod
    def constrain(cs: ConstraintSystem, num: Num, num_bits: int) -> "UnsignedInteger":
        vals = None
        if cs.proving:
            if num.value is None:
                raise SynthesisError("missing value")
            vals = [(num.value >> i) & 1 for i in range(num_bits)]
        bits = [
            Bool.alloc(cs, None if vals is None else bool(vals[i]))
            for i in range(num_bits)
        ]
        acc = {}
        for i, b in enumerate(bits):
            acc = lc_add(acc, lc_scale(b.num.lc, 1 << i))
        cs.enforce(acc, {ONE: 1}, num.lc)
        return UnsignedInteger(num, bits)

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[int], num_bits: int):
        return UnsignedInteger.constrain(cs, Num.alloc(cs, value), num_bits)

    @staticmethod
    def alloc_32(cs: ConstraintSystem, value: Optional[int]):
        return UnsignedInteger.alloc(cs, value, 32)

    @staticmethod
    def alloc_64(cs: ConstraintSystem, value: Optional[int]):
        return UnsignedInteger.alloc(cs, value, 64)

    @staticmethod
    def constrain_strict(cs: ConstraintSystem, num: Num) -> "UnsignedInteger":
        """Canonical 255-bit decomposition: bits encode a value < p
        (reference: uint.rs constrain_strict / bellman to_bits_le_strict)."""
        u = UnsignedInteger.constrain(cs, num, 255)
        # lexicographic strictly-less-than-p over the bits, MSB down
        eq = Bool.constant(True)
        lt = Bool.constant(False)
        for i in range(254, -1, -1):
            b = u.bits[i]
            p_bit = (P >> i) & 1
            if p_bit == 1:
                # lt |= eq & !b ;  eq &= b
                lt = lt.or_(cs, eq.and_(cs, b.not_()))
                eq = eq.and_(cs, b)
            else:
                # a 1 where p has 0 while still equal → impossible
                # eq & b must be false; fold into eq chain
                eq_and_b = eq.and_(cs, b)
                eq_and_b.num.assert_equal(cs, Num.zero())
        lt.assert_true(cs)
        return u

    def lt(self, cs: ConstraintSystem, other: "UnsignedInteger") -> Bool:
        """(a - b + 2^(n+1)) decomposition; result = bit n
        (reference: uint.rs:96-113, ~198 constraints at n=64)."""
        assert self.num_bits == other.num_bits
        n = self.num_bits
        sub = (self.num - other.num).add_const(1 << (n + 1))
        sub_bits = UnsignedInteger.constrain(cs, sub, n + 2)
        return sub_bits.bits[n]

    def gt(self, cs, other):
        return other.lt(cs, self)

    def lte(self, cs, other) -> Bool:
        return self.gt(cs, other).not_()

    def gte(self, cs, other) -> Bool:
        return self.lt(cs, other).not_()


# ---------------------------------------------------------------- poseidon


def poseidon(cs: ConstraintSystem, vals: List[Num]) -> Num:
    """In-circuit Poseidon mirroring the native permutation
    (reference: gadgets/poseidon/mod.rs).  S-box costs 3 constraints;
    MDS/constants fold into LCs for free; partial rounds compress the
    non-S-boxed lanes."""
    elems = [Num.zero()] + list(vals)
    params = params_for_width(len(elems))

    def sbox(a: Num) -> Num:
        a2 = a.mul(cs, a)
        a4 = a2.mul(cs, a2)
        return a.mul(cs, a4)

    def add_constants(elems, offset):
        return [e.add_const(params.round_constants[offset + i])
                for i, e in enumerate(elems)]

    def product_mds(elems):
        out = []
        for j in range(len(elems)):
            acc = Num.zero()
            for k in range(len(elems)):
                acc = acc + elems[k].scale(params.mds[j][k])
            out.append(acc)
        return out

    offset = 0
    for _ in range(params.full_rounds // 2):
        elems = add_constants(elems, offset)
        elems = [sbox(e) for e in elems]
        elems = product_mds(elems)
        offset += len(elems)
    for _ in range(params.partial_rounds):
        elems = add_constants(elems, offset)
        elems = [sbox(elems[0])] + [e.compress(cs) for e in elems[1:]]
        elems = product_mds(elems)
        offset += len(elems)
    for _ in range(params.full_rounds // 2):
        elems = add_constants(elems, offset)
        elems = [sbox(e) for e in elems]
        elems = product_mds(elems)
        offset += len(elems)
    return elems[1]


# ---------------------------------------------------------------- merkle


def merge_hash_poseidon4(cs: ConstraintSystem, select: Tuple[Bool, Bool],
                         v: Num, p: List[Num]) -> Num:
    """Place v among 3 siblings by 2 select bits, then Poseidon4
    (reference: merkle/mod.rs:21-52)."""
    s0, s1 = select
    and_ = s0.and_(cs, s1)
    or_ = s0.or_(cs, s1)
    v0 = mux(cs, or_, v, p[0])
    v1p = mux(cs, s0, p[0], v)
    v1 = mux(cs, s1, Num(v1p.lc, v1p.value), p[1])
    v2p = mux(cs, s0, v, p[2])
    v2 = mux(cs, s1, p[1], v2p)
    v3 = mux(cs, and_, p[2], v)
    return poseidon(cs, [v0, v1, v2, v3])


def calc_root_poseidon4(cs: ConstraintSystem, index: UnsignedInteger,
                        val: Num, proof: List[List[Num]]) -> Num:
    assert len(index.bits) == len(proof) * 2
    curr = val
    for level, p in enumerate(proof):
        bits = (index.bits[2 * level], index.bits[2 * level + 1])
        curr = merge_hash_poseidon4(cs, bits, curr, p)
    return curr


def check_proof_poseidon4(cs: ConstraintSystem, enabled: Bool,
                          index: UnsignedInteger, val: Num,
                          proof: List[List[Num]], root: Num):
    new_root = calc_root_poseidon4(cs, index, val, proof)
    root.assert_equal_if_enabled(cs, enabled, new_root)


# ---------------------------------------------------------------- eddsa


class AllocatedPoint:
    """In-circuit JubJub point (reference: eddsa/mod.rs AllocatedPoint)."""

    def __init__(self, x: Num, y: Num):
        self.x = x
        self.y = y

    @staticmethod
    def alloc(cs: ConstraintSystem, point: Optional[Tuple[int, int]]):
        x = Num.alloc(cs, point[0] if point else None)
        y = Num.alloc(cs, point[1] if point else None)
        return AllocatedPoint(x, y)

    def value(self) -> Optional[Tuple[int, int]]:
        if self.x.value is None or self.y.value is None:
            return None
        return (self.x.value, self.y.value)

    def is_null(self, cs) -> Bool:
        return self.x.is_zero(cs).and_(cs, self.y.is_zero(cs))

    def is_equal(self, cs, other) -> Bool:
        return self.x.is_equal(cs, other.x).and_(cs, self.y.is_equal(cs, other.y))

    def assert_on_curve(self, cs, enabled: Bool):
        x2 = self.x.mul(cs, self.x)
        y2 = self.y.mul(cs, self.y)
        x2y2 = x2.mul(cs, y2)
        lhs = y2 - x2
        rhs = x2y2.scale(jj.D) + Num.one()
        lhs.assert_equal_if_enabled(cs, enabled, rhs)

    def _sum_value(self, other_val):
        mine = self.value()
        if mine is None or other_val is None:
            return None
        if not jj.is_on_curve(mine) or not jj.is_on_curve(other_val):
            return (0, 0)  # invalid inputs: any value satisfies nothing
        return jj.point_add(mine, other_val)

    def add(self, cs, other: "AllocatedPoint") -> "AllocatedPoint":
        """Unified twisted-Edwards addition: 2 division constraints
        (reference: eddsa/mod.rs add)."""
        sum_pt = AllocatedPoint.alloc(cs, self._sum_value(other.value()))
        common = self.x.mul(cs, other.x).mul(cs, self.y).mul(cs, other.y)
        x1 = self.x.mul(cs, other.y)
        x2 = self.y.mul(cs, other.x)
        # (1 + d*common) * sum.x == x1 + x2
        cs.enforce(
            (Num.one() + common.scale(jj.D)).lc, sum_pt.x.lc, (x1 + x2).lc
        )
        y1 = self.y.mul(cs, other.y)
        y2 = self.x.mul(cs, other.x)
        # (1 - d*common) * sum.y == y1 - a*y2
        cs.enforce(
            (Num.one() - common.scale(jj.D)).lc,
            sum_pt.y.lc,
            (y1 - y2.scale(jj.A)).lc,
        )
        return sum_pt

    def add_const(self, cs, b: Tuple[int, int]) -> "AllocatedPoint":
        """Add a constant point: 1 mul + 2 constraints
        (reference: eddsa/mod.rs add_const)."""
        sum_pt = AllocatedPoint.alloc(cs, self._sum_value(b))
        bx, by = b
        d_bx_by = jj.D * bx % P * by % P
        common = self.x.mul(cs, self.y)
        cs.enforce(
            (Num.one() + common.scale(d_bx_by)).lc,
            sum_pt.x.lc,
            (self.x.scale(by) + self.y.scale(bx)).lc,
        )
        cs.enforce(
            (Num.one() - common.scale(d_bx_by)).lc,
            sum_pt.y.lc,
            (self.y.scale(by) - self.x.scale(jj.A * bx % P)).lc,
        )
        return sum_pt

    def mul(self, cs, scalar: Num) -> "AllocatedPoint":
        """Double-and-add over the strict 255-bit decomposition
        (reference: eddsa/mod.rs mul)."""
        bits = list(
            reversed(UnsignedInteger.constrain_strict(cs, scalar).bits)
        )
        result = AllocatedPoint(
            mux(cs, bits[0], Num.zero(), self.x),
            mux(cs, bits[0], Num.one(), self.y),
        )
        for bit in bits[1:]:
            result = result.add(cs, result)
            plus = result.add(cs, self)
            result = AllocatedPoint(
                mux(cs, bit, result.x, plus.x), mux(cs, bit, result.y, plus.y)
            )
        return result


def base_mul(cs: ConstraintSystem, base: Tuple[int, int], scalar: Num) -> AllocatedPoint:
    """Fixed-base double-and-add (reference: eddsa/mod.rs base_mul)."""
    bits = list(reversed(UnsignedInteger.constrain_strict(cs, scalar).bits))
    result = AllocatedPoint(
        mux(cs, bits[0], Num.zero(), Num.constant(base[0])),
        mux(cs, bits[0], Num.one(), Num.constant(base[1])),
    )
    for bit in bits[1:]:
        result = result.add(cs, result)
        plus = result.add_const(cs, base)
        result = AllocatedPoint(
            mux(cs, bit, result.x, plus.x), mux(cs, bit, result.y, plus.y)
        )
    return result


def mul_cofactor(cs: ConstraintSystem, point: AllocatedPoint) -> AllocatedPoint:
    pnt = point.add(cs, point)
    pnt = pnt.add(cs, pnt)
    return pnt.add(cs, pnt)


def verify_eddsa(cs: ConstraintSystem, enabled: Bool, pk: AllocatedPoint,
                 msg: Num, sig_r: AllocatedPoint, sig_s: Num):
    """h = Poseidon5(R, A, M); check 8(hA + R) == s·(8B)
    (reference: eddsa/mod.rs:249-280)."""
    h = poseidon(cs, [sig_r.x, sig_r.y, pk.x, pk.y, msg]).compress(cs)
    sb = base_mul(cs, jj.BASE_COFACTOR, sig_s)
    r_plus_ha = pk.mul(cs, h).add(cs, sig_r)
    r_plus_ha = mul_cofactor(cs, r_plus_ha)
    r_plus_ha.x.assert_equal_if_enabled(cs, enabled, sb.x)
    r_plus_ha.y.assert_equal_if_enabled(cs, enabled, sb.y)


# ---------------------------------------------------------------- reveal


def reveal(cs: ConstraintSystem, state_model, state) -> Num:
    """Recompute a ZkStateModel-shaped compressed root from allocated
    leaves (reference: reveal/mod.rs).  `state` is a Num for Scalar
    models, or a list of sub-states for Struct/List."""
    from ..zk.state import ListModel, Scalar, Struct

    if isinstance(state_model, Scalar):
        assert isinstance(state, Num)
        return state
    if isinstance(state_model, Struct):
        vals = [
            reveal(cs, ft, sub)
            for ft, sub in zip(state_model.field_types, state)
        ]
        return poseidon(cs, vals)
    if isinstance(state_model, ListModel):
        leaves = [
            reveal(cs, state_model.item_type, sub)
            for sub in state
        ]
        assert len(leaves) == 1 << (2 * state_model.log4_size)
        while len(leaves) != 1:
            leaves = [
                poseidon(cs, leaves[i : i + 4]) for i in range(0, len(leaves), 4)
            ]
        return leaves[0]
    raise SynthesisError(f"bad state model {state_model}")
