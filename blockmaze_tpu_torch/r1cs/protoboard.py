"""Constraint-system builder mirroring libsnark's protoboard semantics.

Variable index 0 is the constant ONE (protoboard.tcc:19-28: next_free_var
starts at 1); allocation order and constraint order follow the reference
gadget constructors exactly, because the witness vector must line up
element-for-element with the variable numbering baked into the reference
proving keys (SURVEY.md §7 "exact interop").

Linear combinations are lists of (var_index, coeff) with coeff mod r.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple, Union

from ..fields.constants import R_MOD

Term = Tuple[int, int]

ONE = 0  # variable index of the constant one


class LC:
    """Linear combination Σ coeff_i * var_i (append-ordered like libsnark)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Iterable[Term] = ()):  # noqa: D401
        self.terms: List[Term] = list(terms)

    @staticmethod
    def of(x) -> "LC":
        if isinstance(x, LC):
            return x
        if isinstance(x, int):  # constant c -> c * ONE
            return LC([(ONE, x % R_MOD)]) if x else LC()
        raise TypeError(x)

    @staticmethod
    def var(idx: int, coeff: int = 1) -> "LC":
        return LC([(idx, coeff % R_MOD)])

    def __add__(self, other):
        o = LC.of(other)
        return LC(self.terms + o.terms)

    def __radd__(self, other):
        return LC.of(other) + self

    def __sub__(self, other):
        o = LC.of(other)
        return LC(self.terms + [(i, (-c) % R_MOD) for i, c in o.terms])

    def __rsub__(self, other):
        return LC.of(other) - self

    def __mul__(self, k: int):
        k %= R_MOD
        return LC([(i, c * k % R_MOD) for i, c in self.terms])

    __rmul__ = __mul__

    def __neg__(self):
        return self * (R_MOD - 1)

    def evaluate(self, values: List[int]) -> int:
        acc = 0
        for i, c in self.terms:
            acc += c * values[i]
        return acc % R_MOD

    def as_dict(self) -> dict:
        d = {}
        for i, c in self.terms:
            d[i] = (d.get(i, 0) + c) % R_MOD
        return {i: c for i, c in d.items() if c}


def vlc(v: Union[int, LC]) -> LC:
    """A variable index or LC -> LC."""
    return v if isinstance(v, LC) else LC.var(v)


class Protoboard:
    def __init__(self):
        self.next_free_var = 1
        self.values: List[int] = [1]  # index 0 = ONE
        self.constraints: List[Tuple[LC, LC, LC]] = []
        self.primary_input_size = 0

    # --- allocation -----------------------------------------------------
    def allocate(self) -> int:
        idx = self.next_free_var
        self.next_free_var += 1
        self.values.append(0)
        return idx

    def allocate_array(self, n: int) -> List[int]:
        return [self.allocate() for _ in range(n)]

    def set_input_sizes(self, n: int):
        self.primary_input_size = n

    # --- values ---------------------------------------------------------
    def val(self, idx: int) -> int:
        return self.values[idx]

    def setval(self, idx: int, v: int):
        assert idx != ONE
        self.values[idx] = v % R_MOD

    def lc_val(self, lc: Union[int, LC]) -> int:
        if isinstance(lc, int):
            return self.values[lc]
        return lc.evaluate(self.values)

    # --- constraints ----------------------------------------------------
    def add_constraint(self, a, b, c):
        self.constraints.append((_as_lc(a), _as_lc(b), _as_lc(c)))

    @property
    def num_variables(self) -> int:
        return self.next_free_var - 1

    @property
    def auxiliary_input_size(self) -> int:
        return self.num_variables - self.primary_input_size

    def primary_input(self) -> List[int]:
        return self.values[1:1 + self.primary_input_size]

    def auxiliary_input(self) -> List[int]:
        return self.values[1 + self.primary_input_size:]

    def is_satisfied(self) -> bool:
        for (a, b, c) in self.constraints:
            if a.evaluate(self.values) * b.evaluate(self.values) % R_MOD \
                    != c.evaluate(self.values):
                return False
        return True


def _as_lc(x) -> LC:
    """ints that are SMALL constants are field constants; to reference a
    variable use LC.var(idx) explicitly. This mirrors libsnark, where
    r1cs_constraint(1, ...) means the constant 1, not variable 1."""
    if isinstance(x, LC):
        return x
    if isinstance(x, int):
        return LC.of(x)
    raise TypeError(x)


# --- helpers mirroring basic_gadgets.tcc -------------------------------

def generate_boolean_constraint(pb: Protoboard, lc):
    """lc * (1 - lc) = 0 (basic_gadgets.tcc:17-22)."""
    l = vlc(lc)
    pb.add_constraint(l, 1 - l, LC())


def generate_equals_const_constraint(pb: Protoboard, lc, const: int):
    """1 * lc = const (basic_gadgets.tcc:25-29)."""
    pb.add_constraint(LC.of(1), vlc(lc), LC.of(const))


def packing_sum(bits: List) -> LC:
    """Σ bits[i] * 2^i as an LC (pb_variable.tcc:353-365)."""
    out = LC()
    two_i = 1
    for b in bits:
        for (idx, c) in vlc(b).terms:
            out.terms.append((idx, c * two_i % R_MOD))
        two_i = (two_i * 2) % R_MOD
    return out
