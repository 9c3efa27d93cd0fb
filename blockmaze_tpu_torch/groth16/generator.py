"""Groth16 key generator (trusted setup) with the fixed-base
exponentiations on a torch device.

Port of blockmaze_tpu/groth16/generator.py (r1cs_gg_ppzksnark.tcc:223-388).
The host parts are the JAX package's, copied because that module imports
jax: toxic-waste sampling, QAP instance evaluation at t (Lagrange
coefficients and the sparse contraction), window tables. The device part,
fixed_base_exp, computes scalar_i * base for a whole query vector in one
kernel launch (csrc/fixed_base.cu) that ends in the affine Montgomery limbs
the proving key stores; generate_cached builds the cached DevicePK from
those arrays directly.
"""

from __future__ import annotations

import os
import random
import secrets
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..curves import host_curve as HC
from ..curves import pairing as PR
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..msm import pippenger as pp
from ..ntt import domain as D
from ..ntt import pntt
from ..ntt.tntt import batch_modinv
from ..r1cs.protoboard import Protoboard
from ..serialization import libsnark_io as io
from ..utils import kernels as kn
from . import keys as K

WINDOW_C = 8
N_WINDOWS = -(-256 // WINDOW_C)


# ---------------------------------------------------------------------------
# Host QAP instance evaluation (generator.py:48-129)
# ---------------------------------------------------------------------------

def _lagrange_coeffs_basic(m: int, omega: int, t: int) -> List[int]:
    """u_i(t) = Z(t)/m * omega^i / (t - omega^i)."""
    zt = (pow(t, m, R_MOD) - 1) % R_MOD
    if zt == 0:
        raise ValueError("t in domain")
    minv = pow(m, -1, R_MOD)
    omi = 1
    denoms = []
    for _ in range(m):
        denoms.append((t - omi) % R_MOD)
        omi = omi * omega % R_MOD
    dinv = batch_modinv(denoms)
    out = []
    omi = 1
    base = zt * minv % R_MOD
    for i in range(m):
        out.append(base * omi % R_MOD * dinv[i] % R_MOD)
        omi = omi * omega % R_MOD
    return out


def lagrange_coeffs(domain, t: int) -> List[int]:
    """evaluate_all_lagrange_polynomials for basic and step domains."""
    if isinstance(domain, D.BasicDomain):
        return _lagrange_coeffs_basic(domain.m, domain.omega, t)
    d = domain
    inner_big = _lagrange_coeffs_basic(d.big_m, d.big_omega, t)
    omega_inv = pow(d.omega, -1, R_MOD)
    inner_small = _lagrange_coeffs_basic(
        d.small_m, d.small_omega, t * omega_inv % R_MOD)
    L0 = (pow(t, d.small_m, R_MOD) - pow(d.omega, d.small_m, R_MOD)) % R_MOD
    omega_to_small_m = pow(d.omega, d.small_m, R_MOD)
    big_omega_to_small_m = pow(d.big_omega, d.small_m, R_MOD)
    elt = 1
    denoms = []
    for _ in range(d.big_m):
        denoms.append((elt - omega_to_small_m) % R_MOD)
        elt = elt * big_omega_to_small_m % R_MOD
    dinv = batch_modinv(denoms)
    result = [inner_big[i] * L0 % R_MOD * dinv[i] % R_MOD
              for i in range(d.big_m)]
    L1 = (pow(t, d.big_m, R_MOD) - 1) * pow(
        (pow(d.omega, d.big_m, R_MOD) - 1) % R_MOD, -1, R_MOD) % R_MOD
    result += [L1 * inner_small[i] % R_MOD for i in range(d.small_m)]
    return result


def qap_instance_evaluation(cs_coo: Dict, num_vars: int, ncons: int,
                            num_inputs: int, domain, t: int):
    """At/Bt/Ct (len num_vars + 1), the powers of t, and Z(t)
    (r1cs_to_qap_instance_map_with_evaluation)."""
    u = lagrange_coeffs(domain, t)
    At = [0] * (num_vars + 1)
    Bt = [0] * (num_vars + 1)
    Ct = [0] * (num_vars + 1)
    for i in range(num_inputs + 1):
        At[i] = u[ncons + i]
    for (rows, vars_, coeffs), target in (
            (cs_coo["a"], At), (cs_coo["b"], Bt), (cs_coo["c"], Ct)):
        for rr, vv, cc in zip(rows, vars_, coeffs):
            target[vv] = (target[vv] + cc * u[rr]) % R_MOD
    m = domain.m
    Ht = [1] * m
    for i in range(1, m):
        Ht[i] = Ht[i - 1] * t % R_MOD
    return At, Bt, Ct, Ht, domain.compute_vanishing_polynomial(t)


# ---------------------------------------------------------------------------
# Device fixed-base exponentiation
# ---------------------------------------------------------------------------

def _host_window_table(base, add, zero):
    """(W, 2^c) table: T[w][d] = d * 2^(c*w) * base (host affine)."""
    table = []
    b = base
    for _ in range(N_WINDOWS):
        row = [zero]
        for _ in range(1, 1 << WINDOW_C):
            row.append(add(row[-1], b))
        table.append(row)
        for _ in range(WINDOW_C):
            b = add(b, b)
    return table


class WindowTable(NamedTuple):
    """A base's window table on a device: T[w][d] = d * 2^(c*w) * base as
    affine Montgomery (x, y, inf) of shape (W, 2^c, ...), and the same
    entries in fixed_base_exp's kernel layout (pack_table; inf as uint8)."""
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor
    packed: torch.Tensor
    flags: torch.Tensor


def window_table(curve: str, base, device) -> WindowTable:
    """The window table of `base` on `device`."""
    if curve == "g1":
        table = _host_window_table(base, HC.g1_add, HC.G1_ZERO)
        conv = tc.g1_affine_to_device
    else:
        table = _host_window_table(base, HC.g2_add, HC.G2_ZERO)
        conv = tc.g2_affine_to_device
    x, y, inf = conv([p for row in table for p in row])
    shape = (N_WINDOWS, 1 << WINDOW_C)
    tx = tf.to_tensor(x, device).reshape(shape + x.shape[1:])
    ty = tf.to_tensor(y, device).reshape(shape + y.shape[1:])
    tinf = torch.from_numpy(inf).to(device).reshape(shape)
    return WindowTable(tx, ty, tinf, pack_table(tx, ty),
                       tinf.to(torch.uint8).contiguous())


def pack_table(tx, ty) -> torch.Tensor:
    """fixed_base_exp's kernel table: entry w * 2^c + d is T[w][d]'s x then
    y as 32-bit words, (W * 2^c, 16) int32 for G1, (W * 2^c, 32) for G2."""
    def words(t):
        t = t.to(torch.int64).reshape(t.shape[0] * t.shape[1], -1)
        w = t[:, 0::2] | (t[:, 1::2] << 16)
        return w - ((w >> 31) << 32)        # as int32, two's complement

    return torch.cat([words(tx), words(ty)], 1).to(torch.int32).contiguous()


def fixed_base_exp_plain(curve: str, table, scalars_std, blind):
    """The kernel's ladder in plain torch ops: window 0 and the blind B
    through the complete mixed add, windows 1..W-1 through the exception-
    free one, a complete add of -B, then tc.jacobian_to_affine."""
    tx, ty, tinf = table.x, table.y, table.inf
    F = tc.ops(curve)
    n = scalars_std.shape[0]
    digits = pp.digits(scalars_std, WINDOW_C)           # (W, n)
    bx, by = blind
    z = torch.zeros((n,) + tc.coord_tail(curve), dtype=torch.int64,
                    device=scalars_std.device)
    one = F.one_like(z)

    def entry(w):
        d = digits[w]
        return tx[w][d], ty[w][d], tinf[w][d]

    acc = tc.point_mixed_add(F, (z, one, z), *entry(0))
    acc = tc.point_mixed_add(F, acc, bx.expand(z.shape), by.expand(z.shape),
                             torch.zeros(n, dtype=torch.bool,
                                         device=z.device))
    for w in range(1, N_WINDOWS):
        acc = tc.point_mixed_add_noexc(F, acc, *entry(w))
    neg_b = (bx.expand(z.shape), tf.neg(tf.FQ, by).expand(z.shape), one)
    return tc.jacobian_to_affine(curve, tc.point_add(F, acc, neg_b))


def fixed_base_exp(curve: str, table, scalars_std, blind):
    """scalars_i * base for (n, 16) standard-form scalars as the proving key
    stores points: affine (x, y) Montgomery int32 tensors ((n, 16) G1, (n,
    2, 16) G2) and a bool infinity mask (x = y = 0 there). table from
    window_table; blind = (Bx, By), the Montgomery tensors of
    pp.make_blind, B a secret random group element that keeps the
    accumulator off the exceptional cases: it can be infinity only before B
    is in, and from then on acc = B + partial sum is infinity or +-(next
    table point) only if B is, with probability about n*W/r. The kernel
    (csrc/fixed_base.cu) runs the whole ladder and the normalisation in one
    launch; the plain version for CPU tensors."""
    bx, by = blind
    if kn.on_cpu(table.packed, scalars_std, bx, by):
        return fixed_base_exp_plain(curve, table, scalars_std, blind)
    n = scalars_std.shape[0]
    if scalars_std.shape != (n, tf.N) or table.x.shape[:2] != (
            N_WINDOWS, 1 << WINDOW_C):
        raise ValueError(f"fixed_base_exp: bad shapes scalars "
                         f"{tuple(scalars_std.shape)}, table "
                         f"{tuple(table.x.shape)}")
    sc = scalars_std.to(torch.int32).contiguous()
    bx, by = bx.to(torch.int32).contiguous(), by.to(torch.int32).contiguous()
    kn.check_cuda("fixed_base_exp", table.packed, table.flags, sc, bx, by)
    kn.check_aligned("fixed_base_exp", table.packed, sc)
    shape = (n,) + tc.coord_tail(curve)
    x = torch.empty(shape, dtype=torch.int32, device=sc.device)
    y = torch.empty_like(x)
    inf = torch.empty(n, dtype=torch.uint8, device=sc.device)
    kn.K["fixed_base_exp"](kn.CURVE_ID[curve], x, y, inf, table.packed,
                           table.flags, sc, bx, by, n)
    return x, y, inf.view(torch.bool)


def _host_points(curve: str, pts) -> list:
    """Affine Montgomery arrays -> the host affine ints of io's keys."""
    x, y, inf = (np.asarray(a) for a in pts)
    flags = [int(f) for f in inf]
    if curve == "g1":
        return list(zip(tf.from_mont_host(tf.FQ, x),
                        tf.from_mont_host(tf.FQ, y), flags))
    x0, x1 = (tf.from_mont_host(tf.FQ, x[:, k]) for k in range(2))
    y0, y1 = (tf.from_mont_host(tf.FQ, y[:, k]) for k in range(2))
    return list(zip(zip(x0, x1), zip(y0, y1), flags))


# ---------------------------------------------------------------------------
# Generator (generator.py:211-321)
# ---------------------------------------------------------------------------

def _timed(timings, key, t0):
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return time.perf_counter()


def _keygen(pb, device, rnd, timings=None) -> dict:
    """The trusted setup's parts: sizes, the COO constraint lists (after
    the A/B swap), the group constants as host affine ints, and every query
    as affine Montgomery numpy arrays (uint32 limbs, bool mask). timings,
    if given, gains seconds by phase: qap (COO lists, QAP instance at t,
    scalar vectors), tables (window tables, blinds, group constants,
    pairing), exp (scalar limbs, their upload, the fixed-base
    exponentiations and the copy back)."""
    device = torch.device(device)
    t0 = time.perf_counter()
    ncons = len(pb.constraints)
    num_inputs = pb.primary_input_size
    num_vars = pb.num_variables
    domain = D.get_evaluation_domain(ncons + num_inputs + 1)

    # swap A/B if beneficial (r1cs.tcc:182-231): column-touch count
    touched_a, touched_b = set(), set()
    coo = {"a": ([], [], []), "b": ([], [], []), "c": ([], [], [])}
    for i, (a, b, c) in enumerate(pb.constraints):
        for key, lc, touched in (("a", a, touched_a), ("b", b, touched_b),
                                 ("c", c, None)):
            for idx, cf in lc.as_dict().items():
                coo[key][0].append(i)
                coo[key][1].append(idx)
                coo[key][2].append(cf)
                if touched is not None:
                    touched.add(idx)
    if len(touched_b) > len(touched_a):
        coo["a"], coo["b"] = coo["b"], coo["a"]

    t = rnd()
    At, Bt, Ct, Ht, Zt = qap_instance_evaluation(
        coo, num_vars, ncons, num_inputs, domain, t)

    alpha, beta, gamma, delta = rnd(), rnd(), rnd(), rnd()
    gamma_inv = pow(gamma, -1, R_MOD)
    delta_inv = pow(delta, -1, R_MOD)

    gamma_ABC_s = [(beta * At[i] + alpha * Bt[i] + Ct[i])
                   * gamma_inv % R_MOD for i in range(num_inputs + 1)]
    L_s = [(beta * At[i] + alpha * Bt[i] + Ct[i]) * delta_inv % R_MOD
           for i in range(num_inputs + 1, num_vars + 1)]
    H_s = [Ht[i] * Zt % R_MOD * delta_inv % R_MOD
           for i in range(domain.m - 1)]
    # B query is sparse over the nonzero Bt entries
    b_nonzero = [i for i, v in enumerate(Bt) if v]
    b_scalars = [Bt[i] for i in b_nonzero]
    t0 = _timed(timings, "qap", t0)

    g1 = HC.g1_generator()
    g2 = HC.g2_generator()
    tables = {"g1": window_table("g1", g1, device),
              "g2": window_table("g2", g2, device)}
    blinds = {"g1": pp.make_blind("g1", device)[1],
              "g2": pp.make_blind("g2", device)[1]}
    alpha_g1 = HC.g1_mul(g1, alpha)
    beta_g2 = HC.g2_mul(g2, beta)
    out = dict(
        num_inputs=num_inputs, num_vars=num_vars, ncons=ncons,
        domain=domain, coo=coo, b_nonzero=b_nonzero,
        alpha_g1=alpha_g1, beta_g1=HC.g1_mul(g1, beta), beta_g2=beta_g2,
        delta_g1=HC.g1_mul(g1, delta), delta_g2=HC.g2_mul(g2, delta),
        gamma_g2=HC.g2_mul(g2, gamma),
        alpha_beta=PR.pairing(alpha_g1, beta_g2),
        gamma_ABC_first=HC.g1_mul(g1, gamma_ABC_s[0]))
    t0 = _timed(timings, "tables", t0)

    def exp(curve, scalars: List[int]):
        sc = tf.to_tensor(tf.ints_to_limbs(scalars), device)
        x, y, inf = (t.cpu().numpy() for t in fixed_base_exp(
            curve, tables[curve], sc, blinds[curve]))
        return x.view(np.uint32), y.view(np.uint32), inf

    out.update(A=exp("g1", At), H=exp("g1", H_s), L=exp("g1", L_s),
               gamma_ABC_rest=exp("g1", gamma_ABC_s[1:]),
               B2=exp("g2", b_scalars), B1=exp("g1", b_scalars))
    _timed(timings, "exp", t0)
    return out


def _verification_key(kg) -> io.VerificationKey:
    return io.VerificationKey(
        alpha_g1_beta_g2=kg["alpha_beta"], gamma_g2=kg["gamma_g2"],
        delta_g2=kg["delta_g2"], gamma_ABC_first=kg["gamma_ABC_first"],
        gamma_ABC_rest=list(enumerate(_host_points("g1",
                                                   kg["gamma_ABC_rest"]))),
        gamma_ABC_domain=kg["num_inputs"])


def generate(pb: Protoboard, device="cuda", rng=None):
    """Trusted setup over a synthesised circuit (this package's Protoboard
    or any object with its constraints, primary_input_size and
    num_variables), exponentiations on `device`, one launch a query. Returns
    (io.ProvingKey, io.VerificationKey) with host affine points. rng() draws
    the toxic waste (default: `secrets`); the exponentiation blinds always
    come from `secrets` and do not change the keys."""
    rnd = rng or (lambda: secrets.randbelow(R_MOD - 1) + 1)
    kg = _keygen(pb, device, rnd)
    cs = io.ConstraintSystem(
        kg["num_inputs"], kg["num_vars"] - kg["num_inputs"],
        _rebuild_constraints(kg["coo"], kg["ncons"]))
    pk = io.ProvingKey(
        alpha_g1=kg["alpha_g1"], beta_g1=kg["beta_g1"],
        beta_g2=kg["beta_g2"], delta_g1=kg["delta_g1"],
        delta_g2=kg["delta_g2"],
        A_query=_host_points("g1", kg["A"]),
        B_domain=kg["num_vars"] + 1, B_indices=kg["b_nonzero"],
        B_g2=_host_points("g2", kg["B2"]), B_g1=_host_points("g1", kg["B1"]),
        H_query=_host_points("g1", kg["H"]),
        L_query=_host_points("g1", kg["L"]), cs=cs)
    return pk, _verification_key(kg)


def _coo_arrays(coo, device) -> dict:
    """The DevicePK's COO fields (keys._cs_to_coo's arrays) from keygen's
    constraint lists, which already run constraint by constraint, terms in
    as_dict order: rows and variables int32, the coefficients reduced mod r
    and put in Montgomery form by one mul_elementwise by the R^2 row on
    `device`."""
    coeffs = [c % R_MOD for k in "abc" for c in coo[k][2]]
    std = tf.to_tensor(tf.ints_to_limbs(coeffs), device)
    mont = pntt.mul_elementwise(std, tf.to_tensor(tf.FR.r2_limbs[None],
                                                  device))
    mont = mont.cpu().numpy().view(np.uint32)
    out, off = {}, 0
    for k in "abc":
        rows, vars_, cs = coo[k]
        out[f"{k}_row"] = np.asarray(rows, np.int32)
        out[f"{k}_var"] = np.asarray(vars_, np.int32)
        out[f"{k}_coeff"] = mont[off:off + len(cs)]
        off += len(cs)
    return out


def cache_paths(name: str, seed: int, cache_dir: str) -> tuple[str, str]:
    """(npz DevicePK, vk) paths of generate_cached's keys for circuit
    `name` and `seed` in cache_dir."""
    base = os.path.join(cache_dir, f"{name}_s{seed}")
    return f"{base}.v{K.CACHE_VERSION}.npz", f"{base}_vk.txt"


def generate_cached(pb, name: str, seed: int, cache_dir: str,
                    device="cuda", timings=None):
    """Keys for circuit `name` with toxic waste from random.Random(seed),
    cached in cache_dir as the v1 npz DevicePK plus the libsnark-format vk
    (cache_paths). Generates and writes them on a miss: the DevicePK
    straight from the kernel's affine limbs and keygen's COO lists, no
    point or coefficient through a Python-int conversion. pb is the
    circuit's Protoboard, or a function that makes it, called only on a
    miss. Returns (DevicePK, VerificationKey, generated). timings, if
    given, gains seconds by phase (_keygen's, then build: coefficients and
    DevicePK; write: npz and vk written and read back)."""
    npz, vk_path = cache_paths(name, seed, cache_dir)
    generated = not (os.path.exists(npz) and os.path.exists(vk_path))
    if generated:
        if callable(pb):
            pb = pb()
        toxic = random.Random(seed)
        kg = _keygen(pb, device, lambda: toxic.randrange(1, R_MOD), timings)
        t0 = time.perf_counter()
        dpk = K.DevicePK(
            primary_input_size=kg["num_inputs"],
            aux_input_size=kg["num_vars"] - kg["num_inputs"],
            num_constraints=kg["ncons"], domain_size=kg["domain"].m,
            alpha_g1=kg["alpha_g1"], beta_g1=kg["beta_g1"],
            beta_g2=kg["beta_g2"], delta_g1=kg["delta_g1"],
            delta_g2=kg["delta_g2"],
            A=kg["A"], B_idx=np.asarray(kg["b_nonzero"], np.int32),
            B2=kg["B2"], B1=kg["B1"], H=kg["H"], L=kg["L"],
            **_coo_arrays(kg["coo"], device))
        vk = _verification_key(kg)
        t0 = _timed(timings, "build", t0)
        os.makedirs(cache_dir, exist_ok=True)
        K.save_device_pk(dpk, npz)
        K.replace_atomically(vk_path,
                             lambda tmp: io.write_verification_key(tmp, vk))
    out = K.load_device_pk(npz), io.load_verification_key(vk_path), generated
    if generated:
        _timed(timings, "write", t0)
    return out


def _rebuild_constraints(coo, ncons):
    rows = [([], [], []) for _ in range(ncons)]
    for k, sel in (("a", 0), ("b", 1), ("c", 2)):
        rr, vv, cc = coo[k]
        for r, v, c in zip(rr, vv, cc):
            rows[r][sel].append((v, c))
    return [tuple(r) for r in rows]
