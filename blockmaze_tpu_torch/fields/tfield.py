"""Montgomery field arithmetic on torch tensors: host helpers and the plain
versions of the field ops.

Layout (kept from the JAX package, blockmaze_tpu/fields/jfield.py): a field
element is a (..., 16) tensor of 16-bit little-endian limbs, Montgomery
radix R = 2^256. Torch has no uint32 shifts on the CPU, so the limbs live in
int32 tensors at the public boundary and every computation here runs in
int64. The CUDA kernels (csrc/field.cuh) repack the same limbs into 8 x 32
bits in registers; since every op returns the canonical residue, the two
agree bit for bit.

These plain versions are what the kernel wrappers run for CPU tensors, and
what chip_smoke.py holds the kernels against on the card. They are exact
integer arithmetic, vectorised over the leading batch axes:
  * products are limb convolutions (outer product + one index_add_);
  * Montgomery reduction is the whole-word form m = (T mod R)·(-p^-1) mod R,
    (T + m·p) / R, with one conditional subtraction;
  * carries propagate in whole-tensor passes until none is left.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from . import constants as C

N = C.N_LIMBS          # 16
W = C.LIMB_BITS        # 16
MASK = C.LIMB_MASK


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy)
# ---------------------------------------------------------------------------

def ints_to_limbs(xs) -> np.ndarray:
    """Python ints (< 2^256) -> (len, 16) uint32 limb array."""
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), N)
    return u16.astype(np.uint32)


def limbs_to_ints(a) -> list:
    """(..., 16) limb array (any integer dtype) -> flat list of Python ints."""
    u16 = np.ascontiguousarray(np.asarray(a).reshape(-1, N), dtype="<u2")
    raw = u16.tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(u16.shape[0])]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants."""
    name: str
    modulus: int
    inv: int              # -p^-1 mod 2^16 (the JAX package's CIOS constant)
    r_mod: int            # R mod p (Montgomery one)
    r2_mod: int           # R^2 mod p

    @cached_property
    def p_limbs(self) -> np.ndarray:
        return np.array(C.to_limbs(self.modulus), dtype=np.uint32)

    @cached_property
    def one_mont(self) -> np.ndarray:
        return np.array(C.to_limbs(self.r_mod), dtype=np.uint32)

    @cached_property
    def r2_limbs(self) -> np.ndarray:
        return np.array(C.to_limbs(self.r2_mod), dtype=np.uint32)

    @cached_property
    def nprime_limbs(self) -> np.ndarray:
        """-p^-1 mod 2^256 as 16 limbs (whole-word Montgomery constant)."""
        return np.array(C.to_limbs((-pow(self.modulus, -1, C.R_MONT))
                                   % C.R_MONT), dtype=np.uint32)


FR = FieldSpec("Fr", C.R_MOD, C.FR_INV, C.FR_R, C.FR_R2)
FQ = FieldSpec("Fq", C.Q_MOD, C.FQ_INV, C.FQ_R, C.FQ_R2)


def to_mont_host(spec: FieldSpec, xs) -> np.ndarray:
    """Python ints -> Montgomery-form (n, 16) uint32 limbs."""
    p = spec.modulus
    return ints_to_limbs([(x % p) * C.R_MONT % p for x in xs])


def from_mont_host(spec: FieldSpec, a) -> list:
    """Montgomery-form limbs -> Python ints."""
    p = spec.modulus
    rinv = pow(C.R_MONT, -1, p)
    return [x * rinv % p for x in limbs_to_ints(a)]


def to_tensor(a, device) -> torch.Tensor:
    """numpy limbs (uint32 / int32 / bool / int) -> torch tensor on `device`.
    16-bit limbs fit int32, so uint32 arrays cross by a dtype view."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


_CONSTS = {}


def const(limbs, like: torch.Tensor) -> torch.Tensor:
    """A (16,) int64 constant row on `like`'s device (cached; read only)."""
    key = (np.asarray(limbs, dtype=np.int64).tobytes(), like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(np.asarray(limbs, dtype=np.int64),
                         device=like.device)
        _CONSTS[key] = t
    return t


# ---------------------------------------------------------------------------
# Plain field ops (int64 internally, canonical in and out)
# ---------------------------------------------------------------------------

_CONV_IDX = {}


def _conv_index(device) -> torch.Tensor:
    """Cached index vector i + j over a 16 x 16 outer product."""
    idx = _CONV_IDX.get(device)
    if idx is None:
        i = torch.arange(N, device=device)
        idx = (i[:, None] + i[None, :]).reshape(-1)
        _CONV_IDX[device] = idx
    return idx


def _conv(a, b):
    """Limb convolution: (..., 16) x (..., 16) -> (..., 32) unnormalised."""
    prod = a[..., :, None] * b[..., None, :]
    batch = prod.shape[:-2]
    out = torch.zeros(batch + (2 * N,), dtype=torch.int64, device=a.device)
    return out.index_add_(-1, _conv_index(a.device),
                          prod.reshape(batch + (N * N,)))


def _carry(x):
    """Propagate carries (or borrows) until every limb is in [0, 2^16).
    Returns the limbs and the signed carry out of the top limb. Each pass
    moves every limb's excess one limb up; a random operand needs two or
    three passes."""
    top = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    while True:
        c = x >> W                       # floor shift: signed carries
        if not bool(c.any()):
            return x, top
        x = x & MASK
        top = top + c[..., -1]
        x[..., 1:] += c[..., :-1]


def _i64(a):
    return a.to(torch.int64)


def _cond_sub_p(spec, x, extra):
    """x - p if (extra, x) >= p, else x (x normalised, extra its top carry)."""
    d, borrow = _carry(x - const(spec.p_limbs, x))
    need = (extra > 0) | (borrow == 0)
    return torch.where(need[..., None], d, x)


def mont_mul(spec: FieldSpec, a, b):
    """a·b·R^-1 mod p. As in the JAX package, one operand must be canonical
    and the other < 2^256; the result is canonical."""
    a, b = _i64(a), _i64(b)
    a, b = torch.broadcast_tensors(a, b)
    t = _conv(a, b)
    m = _conv(t[..., :N], const(spec.nprime_limbs, t))[..., :N]
    m, _ = _carry(m)                              # exact mod R
    u, _ = _carry(t + _conv(m, const(spec.p_limbs, t)))
    return _cond_sub_p(spec, u[..., N:].contiguous(),
                       torch.zeros(u.shape[:-1], dtype=torch.int64,
                                   device=u.device))


def add(spec: FieldSpec, a, b):
    s, c = _carry(_i64(a) + _i64(b))
    return _cond_sub_p(spec, s, c)


def sub(spec: FieldSpec, a, b):
    d, borrow = _carry(_i64(a) - _i64(b))
    dp, _ = _carry(d + const(spec.p_limbs, d))
    return torch.where((borrow < 0)[..., None], dp, d)


def is_zero(a):
    return (a == 0).all(dim=-1)


def neg(spec: FieldSpec, a):
    a = _i64(a)
    r = sub(spec, torch.zeros_like(a), a)
    return torch.where(is_zero(a)[..., None], torch.zeros_like(a), r)


def select(mask, a, b):
    """mask ? a : b, mask over the batch shape."""
    return torch.where(mask[..., None], a, b)


def canon_wide(spec: FieldSpec, wide):
    """Canonical residue of an int64 limb tensor holding sums of canonical
    16-bit limbs (e.g. an index_add_ over Montgomery residues), each limb
    < 2^48. Split each limb into three 16-bit parts and fold each through a
    Montgomery product with a canonical constant:
        part_k · (2^{16k}·R mod p) · R^-1 = part_k · 2^{16k} mod p."""
    wide = _i64(wide)
    acc = None
    for k in range(3):
        part = (wide >> (W * k)) & MASK
        cst = const(C.to_limbs((1 << (W * k)) * spec.r_mod % spec.modulus),
                    wide)
        term = mont_mul(spec, part, cst)
        acc = term if acc is None else add(spec, acc, term)
    return acc


def inv(spec: FieldSpec, a):
    """a^(p-2) (Fermat) by left-to-right square-and-multiply from the top
    bit of p - 2, the chain of csrc/field.cuh inv_e: the inverse, in
    Montgomery form for a Montgomery-form a; 0 maps to 0."""
    a = _i64(a)
    r = a
    for bit in bin(spec.modulus - 2)[3:]:
        r = mont_mul(spec, r, r)
        if bit == "1":
            r = mont_mul(spec, r, a)
    return r


def from_mont(spec: FieldSpec, a):
    one = torch.zeros(N, dtype=torch.int64, device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)
