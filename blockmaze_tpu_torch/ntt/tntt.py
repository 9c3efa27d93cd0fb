"""Radix-2 NTT over Fr on torch tensors, for both libfqfft domain kinds.

Port of blockmaze_tpu/ntt/jntt.py's table-driven pipeline: host tables
(twiddles per stage, bit reversal, coset powers, 1/Z on the coset) built
once per domain, and the fft/ifft/coset/divide-by-Z operations over
(m, 16) Montgomery limb tensors. Every power-of-two FFT runs through
pntt.fft (bit-reversal gather and all stages) and every Montgomery product
through pntt.mul_elementwise (the CUDA kernels on the card, their plain
versions on the CPU); the step domain's adds and subs stay plain torch, as
they were XLA in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import tfield as tf
from ..fields.constants import R_MOD
from . import pntt
from .domain import MULT_GEN, BasicDomain, StepDomain

FR = tf.FR


# ---------------------------------------------------------------------------
# Host tables (jntt.py:37-113, :217-253)
# ---------------------------------------------------------------------------

def _powers(base: int, n: int) -> list:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % R_MOD
    return out


def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _fft_tables(m: int, omega: int):
    """Bit-reversal permutation and per-stage twiddle tables (Montgomery)."""
    logm = m.bit_length() - 1
    assert m == 1 << logm
    stages = []
    span = 1
    for _ in range(logm):
        w_m = pow(omega, m // (2 * span), R_MOD)
        stages.append(tf.to_mont_host(FR, _powers(w_m, span)))
        span *= 2
    return _bitrev_perm(m), stages


@lru_cache(maxsize=None)
def _coset_table(m: int, g: int):
    return tf.to_mont_host(FR, _powers(g, m))


def batch_modinv(vals: list) -> list:
    """Inverses mod r of nonzero values, with one modular inversion."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R_MOD
    inv_total = pow(prefix[-1], -1, R_MOD)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_total % R_MOD
        inv_total = inv_total * vals[i] % R_MOD
    return out


@lru_cache(maxsize=None)
def _divide_by_z_table(domain):
    """1/Z on the coset, (m, 16) Montgomery (step_radix2_domain.tcc:218-247
    for the step domain)."""
    g = MULT_GEN
    if isinstance(domain, BasicDomain):
        zinv = pow((pow(g, domain.m, R_MOD) - 1) % R_MOD, -1, R_MOD)
        return tf.to_mont_host(FR, [zinv] * domain.m)
    big_m, small_m, omega = domain.big_m, domain.small_m, domain.omega
    Z0 = (pow(g, big_m, R_MOD) - 1) % R_MOD
    c_sm_Z0 = pow(g, small_m, R_MOD) * Z0 % R_MOD
    w_sm_Z0 = pow(omega, small_m, R_MOD) * Z0 % R_MOD
    w_2sm = pow(omega, 2 * small_m, R_MOD)
    elt = 1
    vals = []
    for _ in range(big_m):
        vals.append((c_sm_Z0 * elt - w_sm_Z0) % R_MOD)
        elt = elt * w_2sm % R_MOD
    Z1 = (pow(g * omega % R_MOD, big_m, R_MOD) - 1) * (
        (pow(g * omega % R_MOD, small_m, R_MOD)
         - pow(omega, small_m, R_MOD)) % R_MOD) % R_MOD
    vals.append(Z1)
    inv = batch_modinv(vals)
    return tf.to_mont_host(FR, inv[:big_m] + [inv[big_m]] * small_m)


@lru_cache(maxsize=None)
def qap_tables(domain) -> dict:
    """Every table the QAP pipeline needs for `domain`, as numpy arrays
    (same keys as jntt.qap_tables). Move them with tables_to(T, device)."""
    g = MULT_GEN
    if isinstance(domain, BasicDomain):
        m, omega = domain.m, domain.omega
        perm, fwd = _fft_tables(m, omega)
        _, inv = _fft_tables(m, pow(omega, -1, R_MOD))
        return {
            "perm": perm, "fwd": tuple(fwd), "inv": tuple(inv),
            "minv": tf.to_mont_host(FR, [pow(m, -1, R_MOD)]),
            "coset": _coset_table(m, g),
            "coset_inv": _coset_table(m, pow(g, -1, R_MOD)),
            "zinv": _divide_by_z_table(domain),
        }
    d = domain
    big_o = d.omega * d.omega % R_MOD
    big_perm, big_fwd = _fft_tables(d.big_m, big_o)
    _, big_inv = _fft_tables(d.big_m, pow(big_o, -1, R_MOD))
    small_perm, small_fwd = _fft_tables(d.small_m, d.small_omega)
    _, small_inv = _fft_tables(d.small_m, pow(d.small_omega, -1, R_MOD))
    return {
        "big_perm": big_perm, "big_fwd": tuple(big_fwd),
        "big_inv": tuple(big_inv),
        "small_perm": small_perm, "small_fwd": tuple(small_fwd),
        "small_inv": tuple(small_inv),
        "omega_pows": _coset_table(d.big_m, d.omega),
        "omega_inv_pows": _coset_table(d.small_m, pow(d.omega, -1, R_MOD)),
        "big_minv": tf.to_mont_host(FR, [pow(d.big_m, -1, R_MOD)]),
        "small_minv": tf.to_mont_host(FR, [pow(d.small_m, -1, R_MOD)]),
        "half": tf.to_mont_host(FR, [pow(2, -1, R_MOD)]),
        "coset": _coset_table(d.m, g),
        "coset_inv": _coset_table(d.m, pow(g, -1, R_MOD)),
        "zinv": _divide_by_z_table(domain),
    }


def tables_to(T: dict, device) -> dict:
    """qap_tables on `device`: limbs as int32, permutations as int32, and
    each direction's per-stage twiddle tables as one (m - 1, 16) tensor,
    stage s at row 2^s - 1 (what pntt.fft takes)."""
    out = {}
    for k, v in T.items():
        if isinstance(v, tuple):
            out[k] = tf.to_tensor(np.concatenate(v) if v else
                                  np.zeros((0, tf.N), np.uint32), device)
        elif k.endswith("perm"):
            out[k] = torch.from_numpy(np.asarray(v, np.int32)).to(device)
        else:
            out[k] = tf.to_tensor(v, device)
    return out


# ---------------------------------------------------------------------------
# Pipeline (jntt.py:120-152, :256-329)
# ---------------------------------------------------------------------------

def _add(a, b):
    return tf.add(FR, a, b).to(torch.int32)


def _sub(a, b):
    return tf.sub(FR, a, b).to(torch.int32)


def fft_with(a, perm, tw):
    """In-order Cooley-Tukey DIT FFT (_basic_serial_radix2_FFT) with the
    concatenated twiddles of tables_to: one pntt.fft."""
    return pntt.fft(a.contiguous(), perm, tw)


def fft_t(domain, a, T):
    if isinstance(domain, BasicDomain):
        return fft_with(a, T["perm"], T["fwd"])
    return _step_fft_t(domain, a, T)


def ifft_t(domain, a, T):
    if isinstance(domain, BasicDomain):
        out = fft_with(a, T["perm"], T["inv"])
        return pntt.mul_elementwise(out, T["minv"])
    return _step_ifft_t(domain, a, T)


def coset_fft_t(domain, a, T):
    return fft_t(domain, pntt.mul_elementwise(a, T["coset"]), T)


def icoset_fft_t(domain, a, T):
    return pntt.mul_elementwise(ifft_t(domain, a, T), T["coset_inv"])


def divide_by_z_t(a, T):
    return pntt.mul_elementwise(a, T["zinv"])


def _step_fft_t(d: StepDomain, a, T):
    big_m, small_m = d.big_m, d.small_m
    compr = big_m // small_m
    a_lo, a_hi = a[:big_m], a[big_m:]
    pad_hi = torch.cat([a_hi, torch.zeros((big_m - small_m, tf.N),
                                          dtype=a.dtype, device=a.device)])
    c = _add(a_lo, pad_hi)
    dvec = pntt.mul_elementwise(T["omega_pows"], _sub(a_lo, pad_hi))
    e = dvec.reshape(compr, small_m, tf.N)
    acc = e[0]
    for j in range(1, compr):
        acc = _add(acc, e[j])
    c = fft_with(c, T["big_perm"], T["big_fwd"])
    eo = fft_with(acc, T["small_perm"], T["small_fwd"])
    return torch.cat([c, eo])


def _step_ifft_t(d: StepDomain, a, T):
    big_m, small_m = d.big_m, d.small_m
    compr = big_m // small_m
    U0 = fft_with(a[:big_m], T["big_perm"], T["big_inv"])
    U1 = fft_with(a[big_m:], T["small_perm"], T["small_inv"])
    U0 = pntt.mul_elementwise(U0, T["big_minv"])
    U1 = pntt.mul_elementwise(U1, T["small_minv"])
    tmp = pntt.mul_elementwise(U0, T["omega_pows"])
    tmp_r = tmp.reshape(compr, small_m, tf.N)
    sub_acc = tmp_r[1]
    for j in range(2, compr):
        sub_acc = _add(sub_acc, tmp_r[j])
    U1 = _sub(U1, sub_acc)
    U1 = pntt.mul_elementwise(U1, T["omega_inv_pows"])
    a_prefix = pntt.mul_elementwise(_add(U0[:small_m], U1), T["half"])
    b2 = pntt.mul_elementwise(_sub(U0[:small_m], U1), T["half"])
    return torch.cat([a_prefix, U0[small_m:], b2])
