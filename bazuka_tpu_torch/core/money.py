"""Amount / Decimal fixed-point and Ratio (reference: src/core/money.rs,
src/core/transaction.rs Ratio).
A copy of `bazuka_tpu/core/money.py`."""

from __future__ import annotations

from dataclasses import dataclass

MAX_U64 = (1 << 64) - 1


def _sat_mul10(v: int) -> int:
    return min(v * 10, MAX_U64)


@dataclass(frozen=True)
class Decimal:
    value: int
    num_decimals: int

    def to_amount(self, decimals: int) -> int:
        v = self.value
        if self.num_decimals < decimals:
            for _ in range(decimals - self.num_decimals):
                v = _sat_mul10(v)
        else:
            for _ in range(self.num_decimals - decimals):
                v //= 10
        return v

    @staticmethod
    def parse(s: str) -> "Decimal":
        s = s.strip()
        if "." in s:
            if s == ".":
                raise ValueError("amount invalid")
            while s and s[-1] == "0":
                s = s[:-1]
            dot = s.find(".")
            num_decimals = len(s) - dot - 1
            s = s[:dot] + s[dot + 1 :]
            if not s.isdigit():
                raise ValueError("amount invalid")
            return Decimal(int(s), num_decimals)
        if not s.isdigit():
            raise ValueError("amount invalid")
        return Decimal(int(s), 0)


def display_amount(amount: int, decimals: int) -> str:
    """u64 amount -> decimal string (reference: Amount::display_by_decimals)."""
    s = str(amount)
    if decimals == 0:
        return s
    while len(s) <= decimals:
        s = "0" + s
    s = s[:-decimals] + "." + s[-decimals:]
    while s and s[-1] == "0":
        s = s[:-1]
    if s and s[-1] == ".":
        s += "0"
    return s


@dataclass(frozen=True)
class Ratio:
    """u8 fraction of 255 (reference: src/core/transaction.rs Ratio)."""

    value: int  # 0..255

    def as_float(self) -> float:
        return self.value / 255.0

    @staticmethod
    def from_float(v: float) -> "Ratio":
        if not 0.0 <= v <= 1.0:
            raise ValueError("floating point not in correct range")
        return Ratio(int(255.0 * v))
