"""Proving key in the tensor form the prover consumes, its v1 npz cache,
and the move onto a torch device.

Port of blockmaze_tpu/groth16/keys.py. The npz format is the JAX
package's (CACHE_VERSION 1), so a key written by either package loads in
the other. Arrays are numpy on the host (uint32 16-bit limbs, Montgomery
form); to_device carries any object with DevicePK's fields - this
package's or the JAX package's - onto a device as int32 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..ntt import domain as D
from ..serialization import libsnark_io as io

CACHE_VERSION = 1


@dataclasses.dataclass
class DevicePK:
    primary_input_size: int
    aux_input_size: int
    num_constraints: int
    domain_size: int
    # group constants (host affine ints)
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    # queries: affine (x, y, inf) Montgomery limb arrays
    A: tuple
    B_idx: np.ndarray
    B2: tuple
    B1: tuple
    H: tuple
    L: tuple
    # constraint matrices, COO with Montgomery coefficients
    a_row: np.ndarray
    a_var: np.ndarray
    a_coeff: np.ndarray
    b_row: np.ndarray
    b_var: np.ndarray
    b_coeff: np.ndarray
    c_row: np.ndarray
    c_var: np.ndarray
    c_coeff: np.ndarray

    @property
    def num_variables(self):
        return self.primary_input_size + self.aux_input_size

    @property
    def domain(self):
        return D.get_evaluation_domain(
            self.num_constraints + self.primary_input_size + 1)


def _cs_to_coo(cs: io.ConstraintSystem):
    out = []
    for sel in range(3):
        rows, vars_, coeffs = [], [], []
        for i, cons in enumerate(cs.constraints):
            for idx, coeff in cons[sel]:
                rows.append(i)
                vars_.append(idx)
                coeffs.append(coeff)
        out.append((np.asarray(rows, np.int32), np.asarray(vars_, np.int32),
                    tf.to_mont_host(tf.FR, coeffs)))
    return out


def build_device_pk(pk: io.ProvingKey) -> DevicePK:
    (a_row, a_var, a_coeff), (b_row, b_var, b_coeff), \
        (c_row, c_var, c_coeff) = _cs_to_coo(pk.cs)
    cs = pk.cs
    return DevicePK(
        primary_input_size=cs.primary_input_size,
        aux_input_size=cs.auxiliary_input_size,
        num_constraints=cs.num_constraints,
        domain_size=D.get_evaluation_domain(
            cs.num_constraints + cs.primary_input_size + 1).m,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        A=tc.g1_affine_to_device(pk.A_query),
        B_idx=np.asarray(pk.B_indices, np.int32),
        B2=tc.g2_affine_to_device(pk.B_g2),
        B1=tc.g1_affine_to_device(pk.B_g1),
        H=tc.g1_affine_to_device(pk.H_query),
        L=tc.g1_affine_to_device(pk.L_query),
        a_row=a_row, a_var=a_var, a_coeff=a_coeff,
        b_row=b_row, b_var=b_var, b_coeff=b_coeff,
        c_row=c_row, c_var=c_var, c_coeff=c_coeff,
    )


_POINT_FIELDS = ["A", "B2", "B1", "H", "L"]
_INT_FIELDS = ["primary_input_size", "aux_input_size", "num_constraints",
               "domain_size"]
_G1_CONSTS = ["alpha_g1", "beta_g1", "delta_g1"]
_G2_CONSTS = ["beta_g2", "delta_g2"]
_COO_FIELDS = ["a_row", "a_var", "a_coeff", "b_row", "b_var", "b_coeff",
               "c_row", "c_var", "c_coeff"]


def save_device_pk(dpk, path: str):
    data = {"version": np.int64(CACHE_VERSION)}
    for f in _INT_FIELDS:
        data[f] = np.int64(getattr(dpk, f))
    for f in _G1_CONSTS:
        x, y, z = getattr(dpk, f)
        data[f] = np.array([str(x), str(y), str(z)])
    for f in _G2_CONSTS:
        (x0, x1), (y0, y1), z = getattr(dpk, f)
        data[f] = np.array([str(x0), str(x1), str(y0), str(y1), str(z)])
    for f in _POINT_FIELDS:
        x, y, inf = getattr(dpk, f)
        data[f + "_x"], data[f + "_y"], data[f + "_inf"] = x, y, inf
    data["B_idx"] = dpk.B_idx
    for f in _COO_FIELDS:
        data[f] = getattr(dpk, f)
    np.savez_compressed(path, **data)


def load_device_pk(path: str) -> DevicePK:
    with np.load(path) as z:
        if int(z["version"]) != CACHE_VERSION:
            raise ValueError(f"{path}: key cache version {int(z['version'])}"
                             f" != {CACHE_VERSION}")
        kw = {f: int(z[f]) for f in _INT_FIELDS}
        for f in _G1_CONSTS:
            x, y, i = z[f]
            kw[f] = (int(x), int(y), int(i))
        for f in _G2_CONSTS:
            x0, x1, y0, y1, i = z[f]
            kw[f] = ((int(x0), int(x1)), (int(y0), int(y1)), int(i))
        for f in _POINT_FIELDS:
            kw[f] = (z[f + "_x"], z[f + "_y"], z[f + "_inf"])
        kw["B_idx"] = z["B_idx"]
        for f in _COO_FIELDS:
            kw[f] = z[f]
    return DevicePK(**kw)


@dataclasses.dataclass
class DeviceKey:
    """A DevicePK's arrays as torch tensors on one device: point queries as
    (x int32, y int32, inf bool), COO rows/vars int64, coefficients int32."""
    A: tuple
    B_idx: torch.Tensor
    B2: tuple
    B1: tuple
    H: tuple
    L: tuple
    coos: tuple


def to_device(dpk, device) -> DeviceKey:
    """Carry a DevicePK (this package's or the JAX package's) to `device`."""
    def pts(t):
        x, y, inf = t
        return (tf.to_tensor(x, device), tf.to_tensor(y, device),
                torch.from_numpy(np.asarray(inf, bool)).to(device))

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    coos = tuple(
        (idx(getattr(dpk, f"{k}_row")), idx(getattr(dpk, f"{k}_var")),
         tf.to_tensor(getattr(dpk, f"{k}_coeff"), device))
        for k in "abc")
    return DeviceKey(A=pts(dpk.A), B_idx=idx(dpk.B_idx), B2=pts(dpk.B2),
                     B1=pts(dpk.B1), H=pts(dpk.H), L=pts(dpk.L), coos=coos)
