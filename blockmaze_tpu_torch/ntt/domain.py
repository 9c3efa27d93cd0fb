"""Evaluation domains over Fr for the QAP reduction (host-side metadata).

Mirrors libfqfft's domain selection (get_evaluation_domain.tcc:41-50): for the
BlockMaze circuits only two shapes occur —

  basic_radix2_domain(m = 2^k)          send (2^18), deposit (2^19)
  step_radix2_domain(m = 2^k + 2^r)     mint/redeem (2^17 + 2^16)

This module computes domain parameters (omegas, coset constants, vanishing
polynomial values) with Python ints; the FFT kernels live in ntt/jntt.py.
"""

from __future__ import annotations

import dataclasses

from ..fields.constants import FR_MULT_GEN, FR_ROOT_OF_UNITY, FR_S, R_MOD


def _log2_ceil(n: int) -> int:
    return (n - 1).bit_length()


def get_root_of_unity(m: int) -> int:
    """Primitive m-th root of unity in Fr (libff get_root_of_unity)."""
    assert m == 1 << _log2_ceil(m), "m must be a power of two"
    logm = _log2_ceil(m)
    assert logm <= FR_S
    omega = FR_ROOT_OF_UNITY
    for _ in range(FR_S - logm):
        omega = omega * omega % R_MOD
    return omega


@dataclasses.dataclass(frozen=True)
class BasicDomain:
    m: int
    omega: int

    kind = "basic"

    def get_domain_element(self, idx: int) -> int:
        return pow(self.omega, idx, R_MOD)

    def compute_vanishing_polynomial(self, t: int) -> int:
        return (pow(t, self.m, R_MOD) - 1) % R_MOD


@dataclasses.dataclass(frozen=True)
class StepDomain:
    m: int
    big_m: int
    small_m: int
    omega: int        # root of unity of order 2^ceil(log2(m))
    big_omega: int    # omega^2 (order big_m)
    small_omega: int  # root of order small_m

    kind = "step"

    def get_domain_element(self, idx: int) -> int:
        if idx < self.big_m:
            return pow(self.big_omega, idx, R_MOD)
        return self.omega * pow(self.small_omega, idx - self.big_m, R_MOD) % R_MOD

    def compute_vanishing_polynomial(self, t: int) -> int:
        return (pow(t, self.big_m, R_MOD) - 1) * (
            pow(t, self.small_m, R_MOD) - pow(self.omega, self.small_m, R_MOD)
        ) % R_MOD


def get_evaluation_domain(min_size: int):
    """Try-chain of libfqfft get_evaluation_domain restricted to the radix-2
    domains (the geometric/arithmetic fallbacks never trigger for Fr's
    2-adicity of 28 and BlockMaze circuit sizes)."""
    assert min_size > 1

    def try_basic(m):
        if m == 1 << _log2_ceil(m) and _log2_ceil(m) <= FR_S:
            return BasicDomain(m, get_root_of_unity(m))
        return None

    def try_step(m):
        big = 1 << (_log2_ceil(m) - 1)
        small = m - big
        if small != 1 << _log2_ceil(max(small, 1)):
            return None
        omega = get_root_of_unity(1 << _log2_ceil(m))
        return StepDomain(m, big, small, omega,
                          omega * omega % R_MOD, get_root_of_unity(small))

    big = 1 << (_log2_ceil(min_size) - 1)
    small = min_size - big
    rounded_small = 1 << _log2_ceil(max(small, 1))

    for m in (min_size, big + rounded_small):
        d = try_basic(m)
        if d:
            return d
        # extended_radix2 only fires for m = 2^(s+1) (beyond 2-adicity);
        # impossible here because circuit sizes are far below 2^28.
        d = try_step(m)
        if d:
            return d
    raise ValueError(f"no matching domain for size {min_size}")


MULT_GEN = FR_MULT_GEN  # coset generator used by cosetFFT
