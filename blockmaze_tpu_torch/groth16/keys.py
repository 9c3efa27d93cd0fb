"""Proving key in the tensor form the prover consumes, its v1 npz cache,
its load from the reference's text file, and the move onto a torch
device.

Port of blockmaze_tpu/groth16/keys.py. The npz format is the JAX
package's (CACHE_VERSION 1), so a key written by either package loads in
the other. Arrays are numpy on the host (uint32 16-bit limbs, Montgomery
form); to_device carries any object with DevicePK's fields - this
package's or the JAX package's - onto a device as int32 tensors, with the
three COO constraint matrices turned into the one CSR matrix the QAP's
matvec kernel takes (build_csr). load_text_pk reads a libsnark-format
text key through the host tokenizer (serialization/native_io.py) and
decompresses its points on the device (curves/decompress.py); the Python
reader (build_device_pk(io.load_proving_key(path))) stays as the
reference the tests hold it against.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..curves import decompress as dc
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..ntt import domain as D
from ..ntt import pntt
from ..serialization import libsnark_io as io
from ..serialization import native_io

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


def replace_atomically(path: str, write):
    """write(tmp) into a temporary file beside path, then rename it onto
    path: a reader (another process) sees no file or the whole file,
    never a part of one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_device_pk(dpk, path: str):
    """Write dpk as the v1 npz at path (replace_atomically)."""
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
    # uncompressed: compressing the limb arrays was most of keygen's host
    # time; np.load reads either kind, so both packages load the file.
    # Written through a file object, so numpy adds no ".npz" to its name
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **data)

    replace_atomically(path, write)


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


def load_text_pk(pk_txt_path: str, device="cuda", timings=None) -> DevicePK:
    """The DevicePK of a libsnark-format text proving key, the one
    build_device_pk(io.load_proving_key(path)) gives, array for array: the
    host tokenizer turns the text into limbs, one decompress_g1 launch
    finds every G1 point's y (A, B, H, L together) and one decompress_g2
    every G2 point's, and one mul_elementwise by the R^2 row puts the
    coefficients in Montgomery form (as generator._coo_arrays does), on
    `device` ("cpu": the kernels' plain versions). Raises ValueError on a
    malformed or truncated file or a point off its curve. timings, if
    given, gains seconds by phase: tokenize, upload (the limbs to the
    device), decompress and coeffs (each up to its arrays back on the
    host), build."""
    def lap(key, t0):
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    device = torch.device(device)
    t0 = time.perf_counter()
    tk = native_io.parse_pk_text(pk_txt_path)
    t0 = lap("tokenize", t0)
    g1 = [tf.to_tensor(a, device) for a in (tk.g1.x, tk.g1.lsb, tk.g1.zero)]
    g2 = [tf.to_tensor(a, device) for a in (tk.g2.x, tk.g2.lsb, tk.g2.zero)]
    coeffs = tf.to_tensor(tk.coeffs, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = lap("upload", t0)
    names = list(tk.g1_counts.items())
    g1_pts = [t.cpu().numpy() for t in dc.decompress("g1", *g1, names)]
    g2_pts = [t.cpu().numpy() for t in dc.decompress("g2", *g2,
                                                      [("B", len(tk.g2.lsb))])]
    t0 = lap("decompress", t0)
    mont = pntt.mul_elementwise(coeffs, tf.to_tensor(tf.FR.r2_limbs[None],
                                                     device))
    mont = mont.cpu().numpy().view(np.uint32)
    t0 = lap("coeffs", t0)
    queries, off = {}, 0
    for name, count in names:
        x, y, inf = (a[off:off + count] for a in g1_pts)
        queries[name] = (x.view(np.uint32), y.view(np.uint32), inf)
        off += count
    x, y, inf = g2_pts
    queries["B2"] = (x.view(np.uint32), y.view(np.uint32), inf)
    coo, off = {}, 0
    for k in "abc":
        n = tk.nnz[k]
        coo.update({f"{k}_row": tk.rows[off:off + n],
                    f"{k}_var": tk.vars[off:off + n],
                    f"{k}_coeff": mont[off:off + n]})
        off += n
    dpk = DevicePK(
        primary_input_size=tk.primary_input_size,
        aux_input_size=tk.aux_input_size,
        num_constraints=tk.num_constraints,
        domain_size=D.get_evaluation_domain(
            tk.num_constraints + tk.primary_input_size + 1).m,
        alpha_g1=tk.alpha_g1, beta_g1=tk.beta_g1, beta_g2=tk.beta_g2,
        delta_g1=tk.delta_g1, delta_g2=tk.delta_g2,
        B_idx=tk.B_idx, **queries, **coo)
    lap("build", t0)
    return dpk


def load_or_build(pk_txt_path: str, cache_dir: str | None = None,
                  device="cuda", timings=None) -> DevicePK:
    """The DevicePK of a libsnark-format proving key: its npz cache next to
    the text file (<base>.v1.npz, also found when the text file is absent)
    unless the text file is newer; on a miss load_text_pk reads the text
    on `device` (timings as there, and "write" for the cache) and the
    cache is written (the npz the Python reader's DevicePK would give)."""
    cache_dir = cache_dir or os.path.dirname(pk_txt_path)
    base = os.path.splitext(os.path.basename(pk_txt_path))[0]
    cache = os.path.join(cache_dir, base + f".v{CACHE_VERSION}.npz")
    if os.path.exists(cache) and (
            not os.path.exists(pk_txt_path)
            or os.path.getmtime(cache) >= os.path.getmtime(pk_txt_path)):
        return load_device_pk(cache)
    dpk = load_text_pk(pk_txt_path, device, timings)
    t0 = time.perf_counter()
    save_device_pk(dpk, cache)
    if timings is not None:
        timings["write"] = time.perf_counter() - t0
    return dpk


# Rows of more terms than this are summed by a warp in the matvec kernel
# (csrc/qap.cu), the others by a thread.
LONG_ROW = 32


@dataclasses.dataclass
class MatrixCSR:
    """A, B and C stacked as one compressed-row matrix of 3m rows (m the
    domain size): row r of A, B, C is row r, m + r, 2m + r. A also holds
    the input-consistency rows ncons + i = wire i (i <= num_inputs), each
    one term with coefficient Montgomery one (x * (R mod r) * R^-1 = x).
    Rows past a matrix's constraints have no terms. ptr (3m + 1,) int32
    row offsets into var (nnz,) int32 and coeff (nnz, 16) Montgomery
    limbs; long_rows (int32) lists the rows of more than LONG_ROW terms.
    numpy arrays from build_csr, int32 tensors in a DeviceKey."""
    ptr: object
    var: object
    coeff: object
    long_rows: object


def build_csr(dpk) -> MatrixCSR:
    """The CSR of a DevicePK's (this package's or the JAX package's) COO
    matrices, A (with its input-consistency rows), B and C stacked."""
    m, ncons = dpk.domain_size, dpk.num_constraints
    n_inp = dpk.primary_input_size
    rows, vars_, coeffs = [], [], []
    for k, name in enumerate("abc"):
        r = np.asarray(getattr(dpk, f"{name}_row"), np.int64)
        v = np.asarray(getattr(dpk, f"{name}_var"), np.int64)
        c = np.asarray(getattr(dpk, f"{name}_coeff"), np.uint32)
        if name == "a":
            extra = np.arange(n_inp + 1)
            r = np.concatenate([r, ncons + extra])
            v = np.concatenate([v, extra])
            c = np.concatenate([c, np.broadcast_to(tf.FR.one_mont,
                                                   (n_inp + 1, tf.N))])
        rows.append(r + k * m)
        vars_.append(v)
        coeffs.append(c)
    return coo_to_csr(np.concatenate(rows), np.concatenate(vars_),
                      np.concatenate(coeffs), 3 * m)


def coo_to_csr(row, var, coeff, nrows: int) -> MatrixCSR:
    """The CSR (numpy) of a COO matrix of nrows rows: a stable sort by row,
    so each row keeps its terms' order."""
    row = np.asarray(row, np.int64)
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=nrows)
    ptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return MatrixCSR(ptr=ptr.astype(np.int32),
                     var=np.asarray(var)[order].astype(np.int32),
                     coeff=np.asarray(coeff, np.uint32)[order],
                     long_rows=np.flatnonzero(counts > LONG_ROW)
                     .astype(np.int32))


def csr_to(csr: MatrixCSR, device) -> MatrixCSR:
    """A numpy MatrixCSR as int32 tensors on `device`."""
    return MatrixCSR(*(tf.to_tensor(getattr(csr, f.name), device)
                       for f in dataclasses.fields(csr)))


@dataclasses.dataclass
class DeviceKey:
    """A DevicePK's arrays as torch tensors on one device: point queries as
    (x int32, y int32, inf bool), B_idx int64, and the constraint matrices
    as one MatrixCSR of int32 tensors."""
    A: tuple
    B_idx: torch.Tensor
    B2: tuple
    B1: tuple
    H: tuple
    L: tuple
    csr: MatrixCSR


def to_device(dpk, device) -> DeviceKey:
    """Carry a DevicePK (this package's or the JAX package's) to `device`."""
    def pts(t):
        x, y, inf = t
        return (tf.to_tensor(x, device), tf.to_tensor(y, device),
                torch.from_numpy(np.asarray(inf, bool)).to(device))

    csr = csr_to(build_csr(dpk), device)
    B_idx = torch.from_numpy(np.asarray(dpk.B_idx, np.int64)).to(device)
    return DeviceKey(A=pts(dpk.A), B_idx=B_idx, B2=pts(dpk.B2),
                     B1=pts(dpk.B1), H=pts(dpk.H), L=pts(dpk.L), csr=csr)
