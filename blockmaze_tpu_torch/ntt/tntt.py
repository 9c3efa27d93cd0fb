"""Radix-2 NTT over Fr on torch tensors, for both libfqfft domain kinds.

Port of blockmaze_tpu/ntt/jntt.py's table-driven pipeline: host tables
(twiddles per stage, bit reversal, coset powers, 1/Z on the coset) built
once per domain, and the fft/ifft/coset/divide-by-Z operations over
(m, 16) Montgomery limb tensors. Every power-of-two FFT runs through
pntt.fft (bit-reversal gather and all stages); the pointwise work around
the FFTs is fused into kernels too (the CUDA kernels on the card, their
plain versions on the CPU): on a basic domain the coset, 1/m and coset^-1
products ride in fft's first and last pass, and the step domain's
elementwise stages are one pntt.step_pre before its two forward FFTs and
one pntt.step_post after its two inverse ones. Same functions and
outputs as jntt's; only divide_by_z_t is a mul_elementwise (the QAP fuses
it into pntt.qap_combine).
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


@lru_cache(maxsize=None)
def std_tables(domain) -> dict:
    """Tables in standard form (not Montgomery): "coset_inv_std", the
    coset^-1 powers that icoset_fft_t(std=True) takes. A Montgomery product
    by a factor in standard form, x*R * c * R^-1 = x*c, gives the
    standard-form product, so the inverse coset FFT's last step also leaves
    the Montgomery form. Move with tables_to."""
    g_inv = pow(MULT_GEN, -1, R_MOD)
    return {"coset_inv_std": tf.ints_to_limbs(_powers(g_inv, domain.m))}


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
        return pntt.fft(a.contiguous(), T["perm"], T["inv"], scale=T["minv"])
    return _step_ifft_t(domain, a, T)


def coset_fft_t(domain, a, T):
    if isinstance(domain, BasicDomain):
        return pntt.fft(a.contiguous(), T["perm"], T["fwd"], pre=T["coset"])
    return _step_fft_t(domain, a, T, T["coset"])


def icoset_fft_t(domain, a, T, std: bool = False):
    """Inverse coset FFT; std=True returns the standard form (T must then
    hold std_tables' "coset_inv_std")."""
    post = T["coset_inv_std" if std else "coset_inv"]
    if isinstance(domain, BasicDomain):
        return pntt.fft(a.contiguous(), T["perm"], T["inv"], scale=T["minv"],
                        post=post)
    return _step_ifft_t(domain, a, T, post)


def divide_by_z_t(a, T):
    return pntt.mul_elementwise(a, T["zinv"])


def _step_fft_t(d: StepDomain, a, T, coset=None):
    """One step_pre (times coset, if given), then the big and the small FFT
    into the two row ranges of one output."""
    big_m = d.big_m
    x = pntt.step_pre(a.contiguous(), T["omega_pows"], d.small_m, coset)
    out = torch.empty_like(x)
    pntt.fft(x[:big_m], T["big_perm"], T["big_fwd"], out=out[:big_m])
    pntt.fft(x[big_m:], T["small_perm"], T["small_fwd"], out=out[big_m:])
    return out


def _step_ifft_t(d: StepDomain, a, T, post=None):
    """The big and the small inverse FFT, then one step_post (times post,
    if given)."""
    big_m = d.big_m
    a = a.contiguous()
    U0 = fft_with(a[:big_m], T["big_perm"], T["big_inv"])
    U1 = fft_with(a[big_m:], T["small_perm"], T["small_inv"])
    return pntt.step_post(U0, U1, T["omega_pows"], T["omega_inv_pows"],
                          T["big_minv"], T["small_minv"], T["half"], post)
