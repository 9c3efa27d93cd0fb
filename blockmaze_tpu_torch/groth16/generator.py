"""Groth16 key generator (trusted setup) with the fixed-base
exponentiations on a torch device.

Port of blockmaze_tpu/groth16/generator.py (r1cs_gg_ppzksnark.tcc:223-388).
The host parts are the JAX package's, copied because that module imports
jax: toxic-waste sampling, QAP instance evaluation at t (Lagrange
coefficients and the sparse contraction), window tables. The device part,
fixed_base_exp, computes scalar_i * base for a whole query vector with one
table gather and one batched mixed add per window.
"""

from __future__ import annotations

import os
import random
import secrets
from typing import Dict, List

import torch

from ..curves import host_curve as HC
from ..curves import pairing as PR
from ..curves import pcurve as pc
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..msm import pippenger as pp
from ..ntt import domain as D
from ..ntt.tntt import batch_modinv
from ..r1cs.protoboard import Protoboard
from ..serialization import libsnark_io as io
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


def window_table(curve: str, base, device):
    """The window table of `base` as (x, y, inf) tensors of shape
    (W, 2^c, ...) on `device`."""
    if curve == "g1":
        table = _host_window_table(base, HC.g1_add, HC.G1_ZERO)
        conv = tc.g1_affine_to_device
    else:
        table = _host_window_table(base, HC.g2_add, HC.G2_ZERO)
        conv = tc.g2_affine_to_device
    x, y, inf = conv([p for row in table for p in row])
    shape = (N_WINDOWS, 1 << WINDOW_C)
    return (tf.to_tensor(x, device).reshape(shape + x.shape[1:]),
            tf.to_tensor(y, device).reshape(shape + y.shape[1:]),
            torch.from_numpy(inf).to(device).reshape(shape))


def fixed_base_exp(curve: str, table, scalars_std, blind):
    """scalars_i * base for (n, 16) standard-form scalars, as a Jacobian
    batch; table from window_table, blind = (B host affine point,
    (Bx, By) Montgomery tensors) with B a secret random group element.

    The accumulator can be infinity only before the blind is in: window 0
    and the blind B join through the complete mixed add (kernel mixed_add).
    From then on acc = B + partial sum, which is infinity or +-(next table
    point) only if B is, with probability about n*W/r, so windows 1..W-1
    run the exception-free mixed add (kernel mixed_add_noexc), as the MSM
    stream does. A complete add of -B (kernel add) removes the blind."""
    tx, ty, tinf = table
    n = scalars_std.shape[0]
    dev = scalars_std.device
    digits = pp.digits(scalars_std, WINDOW_C)           # (W, n)
    B_host, (bx, by) = blind
    tail = tc.coord_tail(curve)
    z = torch.zeros((n,) + tail, dtype=torch.int32, device=dev)
    one = tc.ops(curve).one_like(z).to(torch.int32)

    def entry(w):
        d = digits[w]
        return tx[w][d], ty[w][d], tinf[w][d]

    acc = pc.mixed_add(curve, (z, one, z), *entry(0))
    finite = torch.zeros(n, dtype=torch.bool, device=dev)
    acc = pc.mixed_add(curve, acc, bx.expand(z.shape).contiguous(),
                       by.expand(z.shape).contiguous(), finite)
    for w in range(1, N_WINDOWS):
        acc = pc.mixed_add_noexc(curve, acc, *entry(w))
    neg = HC.g1_neg(B_host) if curve == "g1" else HC.g2_neg(B_host)
    conv = tc.g1_affine_to_device if curve == "g1" else tc.g2_affine_to_device
    nx, ny, _ = conv([neg])
    negB = (tf.to_tensor(nx, dev).expand(z.shape).contiguous(),
            tf.to_tensor(ny, dev).expand(z.shape).contiguous(), one)
    return pc.add(curve, acc, negB)


def jacobian_to_affine_host(curve: str, P) -> list:
    if curve == "g1":
        return tc.g1_jacobian_to_host(P)
    return tc.g2_jacobian_to_host(P)


# ---------------------------------------------------------------------------
# Generator (generator.py:211-321)
# ---------------------------------------------------------------------------

def generate(pb: Protoboard, device="cuda", rng=None,
             chunk: int = 1 << 18):
    """Trusted setup over a synthesised circuit (this package's Protoboard
    or any object with its constraints, primary_input_size and
    num_variables), exponentiations on `device`. Returns (io.ProvingKey, io.VerificationKey) with host affine
    points. rng() draws the toxic waste (default: `secrets`); the
    exponentiation blinds always come from `secrets` and do not change the
    keys."""
    rnd = rng or (lambda: secrets.randbelow(R_MOD - 1) + 1)
    device = torch.device(device)
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

    g1 = HC.g1_generator()
    g2 = HC.g2_generator()
    tables = {"g1": window_table("g1", g1, device),
              "g2": window_table("g2", g2, device)}
    blinds = {"g1": pp.make_blind("g1", device),
              "g2": pp.make_blind("g2", device)}

    def exp(curve, scalars: List[int]) -> list:
        out = []
        for off in range(0, len(scalars), chunk):
            part = tf.to_tensor(tf.ints_to_limbs(scalars[off:off + chunk]),
                                device)
            out.extend(jacobian_to_affine_host(
                curve, fixed_base_exp(curve, tables[curve], part,
                                      blinds[curve])))
        return out

    A_query = exp("g1", At)
    H_query = exp("g1", H_s)
    L_query = exp("g1", L_s)
    gamma_ABC_rest_pts = exp("g1", gamma_ABC_s[1:])
    gamma_ABC_first = HC.g1_mul(g1, gamma_ABC_s[0])

    # B query is sparse over the nonzero Bt entries
    b_nonzero = [i for i, v in enumerate(Bt) if v]
    b_scalars = [Bt[i] for i in b_nonzero]
    B_g2 = exp("g2", b_scalars)
    B_g1 = exp("g1", b_scalars)

    alpha_g1 = HC.g1_mul(g1, alpha)
    beta_g1 = HC.g1_mul(g1, beta)
    beta_g2 = HC.g2_mul(g2, beta)
    delta_g1 = HC.g1_mul(g1, delta)
    delta_g2 = HC.g2_mul(g2, delta)
    gamma_g2 = HC.g2_mul(g2, gamma)
    alpha_beta = PR.pairing(alpha_g1, beta_g2)

    cs = io.ConstraintSystem(
        num_inputs, num_vars - num_inputs, _rebuild_constraints(coo, ncons))
    pk = io.ProvingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        delta_g1=delta_g1, delta_g2=delta_g2,
        A_query=A_query,
        B_domain=num_vars + 1, B_indices=b_nonzero,
        B_g2=B_g2, B_g1=B_g1,
        H_query=H_query, L_query=L_query, cs=cs)
    vk = io.VerificationKey(
        alpha_g1_beta_g2=alpha_beta, gamma_g2=gamma_g2, delta_g2=delta_g2,
        gamma_ABC_first=gamma_ABC_first,
        gamma_ABC_rest=list(enumerate(gamma_ABC_rest_pts)),
        gamma_ABC_domain=num_inputs)
    return pk, vk


def generate_cached(pb: Protoboard, name: str, seed: int, cache_dir: str,
                    device="cuda"):
    """Keys for circuit `name` with toxic waste from random.Random(seed),
    cached in cache_dir as the v1 npz DevicePK plus the libsnark-format vk
    (<name>_s<seed>.v1.npz, <name>_s<seed>_vk.txt). Generates and writes
    them on a miss. Returns (DevicePK, VerificationKey, generated)."""
    base = os.path.join(cache_dir, f"{name}_s{seed}")
    npz = f"{base}.v{K.CACHE_VERSION}.npz"
    vk_path = f"{base}_vk.txt"
    generated = not (os.path.exists(npz) and os.path.exists(vk_path))
    if generated:
        toxic = random.Random(seed)
        pk, vk = generate(pb, device, rng=lambda: toxic.randrange(1, R_MOD))
        os.makedirs(cache_dir, exist_ok=True)
        K.save_device_pk(K.build_device_pk(pk), npz)
        io.write_verification_key(vk_path, vk)
    return K.load_device_pk(npz), io.load_verification_key(vk_path), generated


def _rebuild_constraints(coo, ncons):
    rows = [([], [], []) for _ in range(ncons)]
    for k, sel in (("a", 0), ("b", 1), ("c", 2)):
        rr, vv, cc = coo[k]
        for r, v, c in zip(rr, vv, cc):
            rows[r][sel].append((v, c))
    return [tuple(r) for r in rows]
