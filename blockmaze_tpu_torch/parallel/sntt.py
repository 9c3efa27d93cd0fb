"""Sharded NTT: the 4-step (Bailey) decomposition over a mesh of devices.

Port of blockmaze_tpu/parallel/sntt.py. View the m = m1 * m2 coefficients
as an (m1, m2) matrix, x[i1 * m2 + i2]:

  step 1  column FFTs (length m1)    columns i2 in one block per shard
  step 2  twiddle by w^(i2 * k1)     elementwise, on each shard
  step 3  all-to-all                 each shard takes its block of k1
  step 4  row FFTs (length m2)       rows k1 in one block per shard

and X[k1 + m1 * k2] = C[k1, k2], the transposed flatten.

Every sub-FFT batch is one launch of pntt.fft over the shard's block,
stored transform after transform: step 1 runs on the (m2 / n, m1) block
of the transposed input (row i2 a column of x), step 4 on the (m1 / n, m2)
block of rows k1. Step 2's twiddles ride in step 1's last pass as its
post factor (a K2 product fused into the pass, as a basic domain's coset
products ride in the single-card FFT), laid out as step 1's output; a
coset FFT's powers ride as step 1's pre factor, an inverse FFT's 1/m as
step 4's scale and an inverse coset FFT's coset^-1 as step 4's post, each
cut to the shard's block in that step's layout (tables_to). Step 3 is
the mesh's all_to_all of equal blocks, and the output is gathered to the
lead device (mesh.gather), as the JAX version all-gathers it; each shard
cuts its block of columns from the input on the lead device. On a
ProcessMesh every process holds the input, and the output, itself.
At every sharded size of the circuits (m1, m2 <= 2^10 = pntt.FFT_TILE_LOG)
each step is one pass.

The step domain (m = big_m + small_m, mint and redeem) runs its big and
its small FFT each through the 4-step decomposition; its elementwise
stages stay on the lead device (every process's own, on a ProcessMesh),
one pntt.step_pre before the forward FFTs and one pntt.step_post after
the inverse ones, as on a single card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..ntt import pntt, tntt
from ..ntt.domain import MULT_GEN, BasicDomain, StepDomain

FR = tf.FR


# ---------------------------------------------------------------------------
# Host tables (cached)
# ---------------------------------------------------------------------------

def _split(m: int, n_dev: int):
    """m = m1 * m2, m1 = 2^floor(log m / 2), both multiples of n_dev."""
    logm = m.bit_length() - 1
    l1 = logm // 2
    m1, m2 = 1 << l1, 1 << (logm - l1)
    if m1 % n_dev or m2 % n_dev:
        raise ValueError(f"m={m} too small to 4-step over {n_dev} devices")
    return m1, m2


def can_shard(m: int, n_dev: int) -> bool:
    """True when the 4-step split of m feeds n_dev devices evenly."""
    logm = m.bit_length() - 1
    if m != 1 << logm:
        return False
    l1 = logm // 2
    return ((1 << l1) % n_dev == 0) and ((1 << (logm - l1)) % n_dev == 0)


@lru_cache(maxsize=None)
def _twiddle_table(m1: int, m2: int, omega: int) -> np.ndarray:
    """(m2, m1, 16) Montgomery table of w^(i2 * k1), row i2: step 2's
    twiddles in the layout of step 1's output (the JAX table's transpose).
    m products and one Montgomery conversion of m values on the host."""
    col = tntt._powers(omega, m2)       # w^i2
    flat = [v for i2 in range(m2) for v in tntt._powers(col[i2], m1)]
    return tf.to_mont_host(FR, flat).reshape(m2, m1, tf.N)


@lru_cache(maxsize=None)
def fft_tabs(m: int, omega: int, n_dev: int) -> dict:
    """Host tables of one sharded FFT of size m with root omega: the split
    (m1, m2), each sub-FFT's bit reversal and concatenated twiddles (p1,
    t1 for length m1, root w^m2; p2, t2 for length m2, root w^m1; as
    tntt.tables_to concatenates them) and step 2's twiddles (tw)."""
    m1, m2 = _split(m, n_dev)
    out = {"m1": m1, "m2": m2, "tw": _twiddle_table(m1, m2, omega)}
    for k, (mk, w) in (("1", (m1, pow(omega, m2, R_MOD))),
                       ("2", (m2, pow(omega, m1, R_MOD)))):
        perm, stages = tntt._fft_tables(mk, w)
        out["p" + k] = perm.astype(np.int32)
        out["t" + k] = (np.concatenate(stages) if stages else
                        np.zeros((0, tf.N), np.uint32))
    return out


@lru_cache(maxsize=None)
def sqap_tables(domain, n_dev: int) -> dict:
    """Host tables of the sharded QAP pipeline: each sharded FFT's
    fft_tabs, and the pointwise tables of the single-card pipeline
    (tntt.qap_tables' and std_tables' entries other than its FFTs')."""
    g = MULT_GEN
    m = domain.m
    out = {"coset": tntt._coset_table(m, g),
           "coset_inv": tntt._coset_table(m, pow(g, -1, R_MOD)),
           "coset_inv_std": tntt.std_tables(domain)["coset_inv_std"],
           "zinv": tntt._divide_by_z_table(domain)}
    if isinstance(domain, BasicDomain):
        omega = domain.omega
        return {**out, "fwd": fft_tabs(m, omega, n_dev),
                "inv": fft_tabs(m, pow(omega, -1, R_MOD), n_dev),
                "minv": tf.to_mont_host(FR, [pow(m, -1, R_MOD)])}
    d = domain
    big_o = d.omega * d.omega % R_MOD
    return {**out,
            "big_fwd": fft_tabs(d.big_m, big_o, n_dev),
            "big_inv": fft_tabs(d.big_m, pow(big_o, -1, R_MOD), n_dev),
            "small_fwd": fft_tabs(d.small_m, d.small_omega, n_dev),
            "small_inv": fft_tabs(d.small_m, pow(d.small_omega, -1, R_MOD),
                                  n_dev),
            "omega_pows": tntt._coset_table(d.big_m, d.omega),
            "omega_inv_pows": tntt._coset_table(d.small_m,
                                                pow(d.omega, -1, R_MOD)),
            "big_minv": tf.to_mont_host(FR, [pow(d.big_m, -1, R_MOD)]),
            "small_minv": tf.to_mont_host(FR, [pow(d.small_m, -1, R_MOD)]),
            "half": tf.to_mont_host(FR, [pow(2, -1, R_MOD)])}


# ---------------------------------------------------------------------------
# Tables on the mesh
# ---------------------------------------------------------------------------

def _step1_layout(t, m1: int, m2: int):
    """An (m, 16) table at step 1's positions: (m2, m1), row i2."""
    return np.ascontiguousarray(
        np.asarray(t).reshape(m1, m2, tf.N).transpose(1, 0, 2))


def _step4_layout(t, m1: int, m2: int):
    """An (m, 16) table at step 4's positions: (m1, m2), row k1, entry
    (k1, k2) the output index k1 + m1 * k2."""
    return np.ascontiguousarray(
        np.asarray(t).reshape(m2, m1, tf.N).transpose(1, 0, 2))


def _cut(mesh, t):
    """A host table's rows in blocks, as (rows, 16): the block of each
    shard this process computes, on its device."""
    rows = np.asarray(t).reshape(-1, tf.N)
    return [tf.to_tensor(rows[a:b], dev) for (a, b), dev in
            mesh.local_blocks(rows.shape[0])]


def plan_to(T: dict, mesh) -> dict:
    """fft_tabs on the mesh: for each shard this process computes, the
    sub-FFT tables on its device and step 2's twiddles cut to its block
    of columns."""
    shards = []
    for dev, tw in zip(mesh.local_devices, _cut(mesh, T["tw"])):
        S = {k: tf.to_tensor(T[k], dev) for k in ("p1", "t1", "p2", "t2")}
        S["tw"] = tw
        shards.append(S)
    return {"m1": T["m1"], "m2": T["m2"], "shards": shards}


def tables_to(T: dict, mesh) -> dict:
    """sqap_tables on the mesh, this process's share: each sharded FFT by
    plan_to; on a basic domain the coset powers cut in step 1's layout,
    coset^-1 (both forms) in step 4's and 1/m on each shard's device (the
    factors ride in the sharded FFT's steps), 1/Z on the lead device; on a
    step domain every pointwise table on the lead device (its stages run
    there). The lead device's tables are out["lead"]."""
    out = {k: plan_to(v, mesh) for k, v in T.items() if isinstance(v, dict)}
    if "fwd" in T:
        m1, m2 = T["fwd"]["m1"], T["fwd"]["m2"]
        out["coset"] = _cut(mesh, _step1_layout(T["coset"], m1, m2))
        for k in ("coset_inv", "coset_inv_std"):
            out[k] = _cut(mesh, _step4_layout(T[k], m1, m2))
        out["minv"] = [tf.to_tensor(T["minv"], dev)
                       for dev in mesh.local_devices]
        lead = {"zinv": T["zinv"]}
    else:
        lead = {k: v for k, v in T.items() if not isinstance(v, dict)}
    out["lead"] = tntt.tables_to(lead, mesh.lead)
    return out


# ---------------------------------------------------------------------------
# The sharded 4-step FFT
# ---------------------------------------------------------------------------

def sharded_fft_t(mesh, m: int, a, plan, pre=None, scale=None, post=None,
                  out=None):
    """FFT of an (m, 16) Montgomery tensor on the lead device over the
    mesh, with plan = plan_to(fft_tabs(m, omega, mesh.size), mesh): the
    (m, 16) result on the lead device (into `out` if given), equal to the
    single-card pntt.fft with the same factors. pre (step 1's layout),
    scale (one row) and post (step 4's layout) are lists from tables_to
    (one entry per shard this process computes), or None."""
    n = mesh.size
    m1, m2 = plan["m1"], plan["m2"]
    shards = plan["shards"]
    none = [None] * len(shards)
    pre, scale, post = (f if f is not None else none
                        for f in (pre, scale, post))
    # step 1 (with step 2 as its post factor): column FFTs, a shard's block
    # of columns i2 of x transposed, row i2 a column
    x = a.reshape(m1, m2, tf.N)
    cols = [x[:, c0:c1].transpose(0, 1).contiguous().reshape(-1, tf.N)
            .to(dev) for (c0, c1), dev in mesh.local_blocks(m2)]
    y = [pntt.fft(col, S["p1"], S["t1"], pre=f, post=S["tw"])
         for col, S, f in zip(cols, shards, pre)]
    # step 3: shard e takes every shard's columns of its k1 block, as
    # (m1 / n, m2) rows k1
    b1, b2 = m1 // n, m2 // n
    got = mesh.all_to_all([yd.view(b2, n, b1, tf.N).transpose(0, 1)
                           for yd in y])
    rows = [t.reshape(m2, b1, tf.N).transpose(0, 1).contiguous()
            .reshape(b1 * m2, tf.N) for t in got]
    # step 4: row FFTs
    z = [pntt.fft(r, S["p2"], S["t2"], scale=s, post=f)
         for r, S, s, f in zip(rows, shards, scale, post)]
    # X[k1 + m1 * k2] = C[k1, k2]
    C = mesh.gather(z).reshape(m1, m2, tf.N)
    if out is None:
        return C.transpose(0, 1).contiguous().reshape(m, tf.N)
    out.view(m2, m1, tf.N).copy_(C.transpose(0, 1))
    return out


def _step_fft_t(mesh, d: StepDomain, a, T, coset=None):
    """One step_pre on the lead device (times coset, if given), then the
    big and the small sharded FFT into the two row ranges of one output."""
    L = T["lead"]
    big = d.big_m
    x = pntt.step_pre(a.contiguous(), L["omega_pows"], d.small_m, coset)
    out = torch.empty_like(x)
    sharded_fft_t(mesh, big, x[:big], T["big_fwd"], out=out[:big])
    sharded_fft_t(mesh, d.small_m, x[big:], T["small_fwd"], out=out[big:])
    return out


def _step_ifft_t(mesh, d: StepDomain, a, T, post=None):
    """The big and the small sharded inverse FFT, then one step_post on the
    lead device (times post, if given)."""
    L = T["lead"]
    big = d.big_m
    a = a.contiguous()
    U0 = sharded_fft_t(mesh, big, a[:big], T["big_inv"])
    U1 = sharded_fft_t(mesh, d.small_m, a[big:], T["small_inv"])
    return pntt.step_post(U0, U1, L["omega_pows"], L["omega_inv_pows"],
                          L["big_minv"], L["small_minv"], L["half"], post)


# ---------------------------------------------------------------------------
# Domain-dispatching wrappers over tables_to(sqap_tables(...)): the mesh
# counterparts of tntt's fft_t / ifft_t / coset_fft_t / icoset_fft_t
# ---------------------------------------------------------------------------

def s_fft_t(mesh, domain, a, T):
    if isinstance(domain, BasicDomain):
        return sharded_fft_t(mesh, domain.m, a, T["fwd"])
    return _step_fft_t(mesh, domain, a, T)


def s_ifft_t(mesh, domain, a, T):
    if isinstance(domain, BasicDomain):
        return sharded_fft_t(mesh, domain.m, a, T["inv"], scale=T["minv"])
    return _step_ifft_t(mesh, domain, a, T)


def s_coset_fft_t(mesh, domain, a, T):
    if isinstance(domain, BasicDomain):
        return sharded_fft_t(mesh, domain.m, a, T["fwd"], pre=T["coset"])
    return _step_fft_t(mesh, domain, a, T, T["lead"]["coset"])


def s_icoset_fft_t(mesh, domain, a, T, std: bool = False):
    """Inverse coset FFT; std=True returns the standard form."""
    key = "coset_inv_std" if std else "coset_inv"
    if isinstance(domain, BasicDomain):
        return sharded_fft_t(mesh, domain.m, a, T["inv"], scale=T["minv"],
                             post=T[key])
    return _step_ifft_t(mesh, domain, a, T, T["lead"][key])


# ---------------------------------------------------------------------------
# Convenience wrappers (tests, callers without a Prover): host tables from
# the caches above, moved to the mesh at each call
# ---------------------------------------------------------------------------

def sharded_fft(mesh, domain: BasicDomain, a, inverse: bool = False):
    """The FFT (or inverse FFT, with 1/m) of a basic domain over the
    mesh."""
    omega = pow(domain.omega, -1, R_MOD) if inverse else domain.omega
    plan = plan_to(fft_tabs(domain.m, omega, mesh.size), mesh)
    scale = None
    if inverse:
        minv = tf.to_mont_host(FR, [pow(domain.m, -1, R_MOD)])
        scale = [tf.to_tensor(minv, dev) for dev in mesh.local_devices]
    return sharded_fft_t(mesh, domain.m, a, plan, scale=scale)


def s_fft(mesh, domain, a):
    if isinstance(domain, BasicDomain):
        return sharded_fft(mesh, domain, a)
    return _step_fft_t(mesh, domain, a,
                       tables_to(sqap_tables(domain, mesh.size), mesh))


def s_ifft(mesh, domain, a):
    if isinstance(domain, BasicDomain):
        return sharded_fft(mesh, domain, a, inverse=True)
    return _step_ifft_t(mesh, domain, a,
                        tables_to(sqap_tables(domain, mesh.size), mesh))


def sharded_coset_fft(mesh, domain, a, g: int):
    """The FFT of a * (g^i) over the mesh."""
    coset = tntt._coset_table(domain.m, g)
    if isinstance(domain, BasicDomain):
        plan = plan_to(fft_tabs(domain.m, domain.omega, mesh.size), mesh)
        m1, m2 = plan["m1"], plan["m2"]
        return sharded_fft_t(mesh, domain.m, a, plan,
                             pre=_cut(mesh, _step1_layout(coset, m1, m2)))
    return _step_fft_t(mesh, domain, a,
                       tables_to(sqap_tables(domain, mesh.size), mesh),
                       tf.to_tensor(coset, mesh.lead))


def sharded_icoset_fft(mesh, domain, a, g: int):
    """The inverse FFT of a over the mesh, times (g^-i)."""
    coset_inv = tntt._coset_table(domain.m, pow(g, -1, R_MOD))
    if isinstance(domain, BasicDomain):
        m = domain.m
        plan = plan_to(fft_tabs(m, pow(domain.omega, -1, R_MOD), mesh.size),
                       mesh)
        minv = tf.to_mont_host(FR, [pow(m, -1, R_MOD)])
        return sharded_fft_t(
            mesh, m, a, plan,
            scale=[tf.to_tensor(minv, dev) for dev in mesh.local_devices],
            post=_cut(mesh, _step4_layout(coset_inv, plan["m1"],
                                          plan["m2"])))
    return _step_ifft_t(mesh, domain, a,
                        tables_to(sqap_tables(domain, mesh.size), mesh),
                        tf.to_tensor(coset_inv, mesh.lead))
