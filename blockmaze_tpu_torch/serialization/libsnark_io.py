"""Byte-compatible reader/writer for libsnark's decimal-text serialization.

The reference serializes pk/vk/proof as a whitespace-separated decimal token
stream (non-binary build: OUTPUT_NEWLINE="\\n", OUTPUT_SEPARATOR=" ",
libff/common/serialization.hpp:64-68), with:

  Fp       : one decimal token, non-Montgomery (fp.tcc:779-801)
  Fp2      : c0 SP c1                       (fp2.tcc:208)
  Fp6      : c0 SP c1 SP c2                 (fp6_3over2.tcc:167)
  Fp12     : c0 SP c1                       (fp12_2over3over2.tcc:363)
  G1       : is_zero SP X SP lsb(Y)         (alt_bn128_g1.cpp:404-416, compressed)
  G2       : is_zero SP X SP lsb(Y.c0)      (alt_bn128_g2.cpp analogous)
  vector<T>: size NL, then each elem + NL   (alt_bn128_g1.cpp:469-476)
  sparse_vector<T>: domain_size NL nidx NL idx* NL nval NL val*  (sparse_vector.tcc:272)
  accumulation_vector<T>: first NL rest(sparse) NL (accumulation_vector.tcc:63)
  knowledge_commitment<T1,T2>: g SP h       (knowledge_commitment.tcc)
  linear_combination: nterms NL {index NL coeff NL}* (variable.tcc:411-421)
  r1cs_constraint: a b c                    (r1cs.tcc:66-73)
  r1cs_constraint_system: primary NL aux NL ncons NL constraints (r1cs.tcc:242)
  proving_key: alpha_g1 beta_g1 beta_g2 delta_g1 delta_g2
               A_query(vec<G1>) B_query(kc_vec<G2,G1>) H_query L_query cs
               (r1cs_gg_ppzksnark.tcc:52-66)
  verification_key: alpha_g1_beta_g2(Fq12) gamma_g2 delta_g2
               gamma_ABC(acc_vec<G1>)      (r1cs_gg_ppzksnark.tcc:101-110)
  proof    : g_A(G1) g_B(G2) g_C(G1)       (r1cs_gg_ppzksnark.tcc:169-177)

Every token is separated by whitespace, so reading is a token scan; writing
reproduces the exact byte layout (verified against reference-generated files).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Tuple

import numpy as np

from ..fields import host as F
from ..fields.constants import Q_MOD, R_MOD, G1_B
from ..curves.host_curve import g2_b_coeff


# ---------------------------------------------------------------------------
# Token stream
# ---------------------------------------------------------------------------

class TokenStream:
    def __init__(self, path: str, chunk: int = 1 << 22):
        self._f = open(path, "rb")
        self._chunk = chunk
        self._iter = self._tokens()

    def _tokens(self) -> Iterator[bytes]:
        tail = b""
        while True:
            buf = self._f.read(self._chunk)
            if not buf:
                if tail:
                    yield tail
                return
            buf = tail + buf
            parts = buf.split()
            # if the buffer doesn't end in whitespace the last token may be cut
            if buf[-1:] not in b" \t\r\n":
                tail = parts.pop() if parts else b""
            else:
                tail = b""
            yield from parts

    def next(self) -> bytes:
        return next(self._iter)

    def next_int(self) -> int:
        return int(next(self._iter))

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# Element parsers (host ints)
# ---------------------------------------------------------------------------

def read_fq(ts: TokenStream) -> int:
    return ts.next_int()


def read_fr(ts: TokenStream) -> int:
    return ts.next_int()


def g1_from_compressed(is_zero: int, x: int, lsb: int):
    """Affine (x, y, is_zero) of a compressed G1 point: y from x and the
    parity bit (mirrors alt_bn128_g1.cpp:425-476 istream semantics)."""
    if is_zero:
        return (0, 0, 1)
    y2 = (x * x % Q_MOD * x + G1_B) % Q_MOD
    y = F.fq_sqrt(y2)
    if y is None:
        raise ValueError("G1 x-coordinate not on curve")
    if (y & 1) != lsb:
        y = Q_MOD - y
    return (x, y, 0)


def g2_from_compressed(is_zero: int, x, lsb: int):
    """Affine ((x0,x1),(y0,y1),is_zero) of a compressed G2 point: y from x
    (Fq2) and the parity bit of y.c0."""
    if is_zero:
        return (F.FQ2_ZERO, F.FQ2_ZERO, 1)
    y2 = F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), g2_b_coeff())
    y = F.fq2_sqrt(y2)
    if y is None:
        raise ValueError("G2 x-coordinate not on twist curve")
    if (y[0] & 1) != lsb:
        y = F.fq2_neg(y)
    return (x, y, 0)


def read_g1(ts: TokenStream) -> Tuple[int, int, int]:
    """Returns affine (x, y, is_zero), decompressed (g1_from_compressed)."""
    is_zero = ts.next_int()
    x = ts.next_int()
    return g1_from_compressed(is_zero, x, ts.next_int())


def read_g2(ts: TokenStream):
    """Returns affine ((x0,x1),(y0,y1),is_zero)."""
    is_zero = ts.next_int()
    x = (ts.next_int(), ts.next_int())
    return g2_from_compressed(is_zero, x, ts.next_int())


def read_fq12(ts: TokenStream):
    def fq2():
        return (ts.next_int(), ts.next_int())

    def fq6():
        return (fq2(), fq2(), fq2())

    return (fq6(), fq6())


def read_g1_vector(ts: TokenStream) -> List[Tuple[int, int, int]]:
    n = ts.next_int()
    return [read_g1(ts) for _ in range(n)]


def read_sparse_vector(ts: TokenStream, read_elem):
    domain_size = ts.next_int()
    n_idx = ts.next_int()
    indices = [ts.next_int() for _ in range(n_idx)]
    n_val = ts.next_int()
    assert n_val == n_idx
    values = [read_elem(ts) for _ in range(n_val)]
    return domain_size, indices, values


def read_accumulation_vector_g1(ts: TokenStream):
    first = read_g1(ts)
    domain_size, indices, values = read_sparse_vector(ts, read_g1)
    return first, domain_size, indices, values


def read_linear_combination(ts: TokenStream) -> List[Tuple[int, int]]:
    n = ts.next_int()
    return [(ts.next_int(), ts.next_int()) for _ in range(n)]


# ---------------------------------------------------------------------------
# Data classes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConstraintSystem:
    primary_input_size: int
    auxiliary_input_size: int
    # per-matrix CSR over constraints: indptr (ncons+1,), var indices, coeffs
    constraints: list  # list of (a_terms, b_terms, c_terms); terms = [(idx, coeff)]

    @property
    def num_constraints(self):
        return len(self.constraints)

    @property
    def num_variables(self):
        return self.primary_input_size + self.auxiliary_input_size

    def is_satisfied(self, full_assignment: List[int]) -> bool:
        """full_assignment[0] is the constant ONE; mirrors r1cs is_satisfied."""
        for (a, b, c) in self.constraints:
            av = sum(coeff * full_assignment[idx] for idx, coeff in a) % R_MOD
            bv = sum(coeff * full_assignment[idx] for idx, coeff in b) % R_MOD
            cv = sum(coeff * full_assignment[idx] for idx, coeff in c) % R_MOD
            if av * bv % R_MOD != cv:
                return False
        return True


@dataclasses.dataclass
class VerificationKey:
    alpha_g1_beta_g2: tuple      # Fq12
    gamma_g2: tuple              # G2 affine
    delta_g2: tuple              # G2 affine
    gamma_ABC_first: tuple       # G1 affine
    gamma_ABC_rest: list         # list of (index, G1 affine) sparse
    gamma_ABC_domain: int


@dataclasses.dataclass
class ProvingKey:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    A_query: list                 # dense list of G1 affine (len = num_vars+1)
    B_domain: int
    B_indices: list               # sparse indices of nonzero B-query entries
    B_g2: list                    # G2 affine values (kc.g)
    B_g1: list                    # G1 affine values (kc.h)
    H_query: list                 # dense G1
    L_query: list                 # dense G1
    cs: ConstraintSystem


@dataclasses.dataclass
class Proof:
    a: tuple  # G1 affine (x, y, is_zero)
    b: tuple  # G2 affine ((x0,x1),(y0,y1),is_zero)
    c: tuple  # G1 affine


# ---------------------------------------------------------------------------
# Proof wire ABI: the tx format's hex encoding
# ---------------------------------------------------------------------------
# Mirrors string_proof_as_hex (mintcgo.cpp:176-187): 8 big-endian 64-hex-char
# coordinates A.x‖A.y‖B.x.c1‖B.x.c0‖B.y.c1‖B.y.c0‖C.x‖C.y — 512 chars — and
# the verify-side decode (mintcgo.cpp:344-404). Values are standard-form
# (non-Montgomery) Fq integers; infinity never occurs in a valid proof.

def _hex64(x: int) -> str:
    return format(x, "064x")


def proof_to_hex(p: Proof) -> str:
    (ax, ay, _), ((bx0, bx1), (by0, by1), _), (cx, cy, _) = p.a, p.b, p.c
    return "".join(map(_hex64, (ax, ay, bx1, bx0, by1, by0, cx, cy)))


def proof_from_hex(s: str) -> Proof:
    if len(s) != 512:
        raise ValueError(f"proof hex must be 512 chars, got {len(s)}")
    v = [int(s[i * 64:(i + 1) * 64], 16) for i in range(8)]
    ax, ay, bx1, bx0, by1, by0, cx, cy = v
    return Proof(a=(ax, ay, False),
                 b=((bx0, bx1), (by0, by1), False),
                 c=(cx, cy, False))


# ---------------------------------------------------------------------------
# Top-level readers
# ---------------------------------------------------------------------------

def read_constraint_system(ts: TokenStream) -> ConstraintSystem:
    primary = ts.next_int()
    aux = ts.next_int()
    ncons = ts.next_int()
    constraints = []
    for _ in range(ncons):
        a = read_linear_combination(ts)
        b = read_linear_combination(ts)
        c = read_linear_combination(ts)
        constraints.append((a, b, c))
    return ConstraintSystem(primary, aux, constraints)


def load_verification_key(path: str) -> VerificationKey:
    ts = TokenStream(path)
    alpha_beta = read_fq12(ts)
    gamma_g2 = read_g2(ts)
    delta_g2 = read_g2(ts)
    first, domain, indices, values = read_accumulation_vector_g1(ts)
    ts.close()
    return VerificationKey(alpha_beta, gamma_g2, delta_g2, first,
                           list(zip(indices, values)), domain)


def load_proving_key(path: str) -> ProvingKey:
    ts = TokenStream(path)
    alpha_g1 = read_g1(ts)
    beta_g1 = read_g1(ts)
    beta_g2 = read_g2(ts)
    delta_g1 = read_g1(ts)
    delta_g2 = read_g2(ts)
    A_query = read_g1_vector(ts)
    b_domain, b_indices, b_values = read_sparse_vector(
        ts, lambda t: (read_g2(t), read_g1(t)))
    H_query = read_g1_vector(ts)
    L_query = read_g1_vector(ts)
    cs = read_constraint_system(ts)
    ts.close()
    return ProvingKey(
        alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2,
        A_query,
        b_domain, b_indices,
        [g2 for (g2, g1) in b_values],
        [g1 for (g2, g1) in b_values],
        H_query, L_query, cs)


def load_proof(path: str) -> Proof:
    ts = TokenStream(path)
    a = read_g1(ts)
    b = read_g2(ts)
    c = read_g1(ts)
    ts.close()
    return Proof(a, b, c)


# ---------------------------------------------------------------------------
# Writers (must match the reference byte-for-byte)
# ---------------------------------------------------------------------------

def fmt_g1(p) -> str:
    x, y, is_zero = p
    if is_zero:
        # reference serializes the zero point's stored coords (affine of
        # (0,1,0) -> X=0, parity of Y=1)
        return "1 0 1"
    return f"0 {x} {y & 1}"


def fmt_g2(p) -> str:
    x, y, is_zero = p
    if is_zero:
        return "1 0 0 1"
    return f"0 {x[0]} {x[1]} {y[0] & 1}"


def write_proof(path: str, proof: Proof):
    with open(path, "w") as f:
        f.write(fmt_g1(proof.a) + "\n")
        f.write(fmt_g2(proof.b) + "\n")
        f.write(fmt_g1(proof.c) + "\n")


def write_primary_input(path: str, values: List[int]):
    """Plain count + one decimal Fr per line (consumed by our C++ oracle)."""
    with open(path, "w") as f:
        f.write(f"{len(values)}\n")
        for v in values:
            f.write(f"{v % R_MOD}\n")


def fmt_fq12(el) -> str:
    (a0, a1, a2), (b0, b1, b2) = el
    parts = [a0[0], a0[1], a1[0], a1[1], a2[0], a2[1],
             b0[0], b0[1], b1[0], b1[1], b2[0], b2[1]]
    return " ".join(str(x) for x in parts)


def write_verification_key(path: str, vk: VerificationKey):
    """Byte-compatible with r1cs_gg_ppzksnark_verification_key operator<<
    (r1cs_gg_ppzksnark.tcc:101-110)."""
    with open(path, "w") as f:
        f.write(fmt_fq12(vk.alpha_g1_beta_g2) + "\n")
        f.write(fmt_g2(vk.gamma_g2) + "\n")
        f.write(fmt_g2(vk.delta_g2) + "\n")
        # accumulation_vector: first NL sparse_vector NL
        f.write(fmt_g1(vk.gamma_ABC_first) + "\n")
        f.write(f"{vk.gamma_ABC_domain}\n")
        f.write(f"{len(vk.gamma_ABC_rest)}\n")
        for idx, _ in vk.gamma_ABC_rest:
            f.write(f"{idx}\n")
        f.write(f"{len(vk.gamma_ABC_rest)}\n")
        for _, p in vk.gamma_ABC_rest:
            f.write(fmt_g1(p) + "\n")
        f.write("\n")


def write_proving_key(path: str, pk: ProvingKey):
    """Byte-compatible with r1cs_gg_ppzksnark_proving_key operator<<
    (r1cs_gg_ppzksnark.tcc:52-66)."""
    with open(path, "w") as f:
        for p in (pk.alpha_g1, pk.beta_g1):
            f.write(fmt_g1(p) + "\n")
        f.write(fmt_g2(pk.beta_g2) + "\n")
        f.write(fmt_g1(pk.delta_g1) + "\n")
        f.write(fmt_g2(pk.delta_g2) + "\n")
        # A_query: vector<G1>
        f.write(f"{len(pk.A_query)}\n")
        for p in pk.A_query:
            f.write(fmt_g1(p) + "\n")
        # B_query: sparse_vector<kc<G2,G1>>
        f.write(f"{pk.B_domain}\n")
        f.write(f"{len(pk.B_indices)}\n")
        for i in pk.B_indices:
            f.write(f"{i}\n")
        f.write(f"{len(pk.B_indices)}\n")
        for g2p, g1p in zip(pk.B_g2, pk.B_g1):
            f.write(fmt_g2(g2p) + " " + fmt_g1(g1p) + "\n")
        for q in (pk.H_query, pk.L_query):
            f.write(f"{len(q)}\n")
            for p in q:
                f.write(fmt_g1(p) + "\n")
        # constraint system
        cs = pk.cs
        f.write(f"{cs.primary_input_size}\n{cs.auxiliary_input_size}\n")
        f.write(f"{cs.num_constraints}\n")
        for (a, b, c) in cs.constraints:
            for lc in (a, b, c):
                f.write(f"{len(lc)}\n")
                for idx, coeff in lc:
                    f.write(f"{idx}\n{coeff % R_MOD}\n")
