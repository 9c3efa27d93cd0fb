"""R1CS -> QAP witness map on torch tensors.

Port of blockmaze_tpu/groth16/qap.py (r1cs_to_qap_witness_map with
d1 = d2 = d3 = 0), as a short chain of kernels with no field arithmetic
in plain torch between them and nothing that waits for the device: one
qap_matvec for A, B and C (with A's input-consistency rows) over the key's
CSR (keys.MatrixCSR), iFFT -> coset FFT on each, one pntt.qap_combine for
(A*B - C)/Z on the coset, and the inverse coset FFT, whose last step can
also leave the Montgomery form (std=True, what the prover's H MSM takes).
"""

from __future__ import annotations

import torch

from ..fields import tfield as tf
from ..ntt import pntt, tntt
from ..utils import kernels as kn
from .keys import LONG_ROW

FR = tf.FR


def qap_matvec_plain(csr, witness_mont):
    """jax sparse_matvec over the stacked CSR: each term's product, an
    int64 sum per row over 16-bit limbs (exact below 2^32 terms a row),
    folded to the canonical residue by tfield.canon_wide."""
    nrows = csr.ptr.shape[0] - 1
    counts = (csr.ptr[1:] - csr.ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(nrows, device=counts.device), counts)
    terms = pntt.mul_elementwise_plain(
        witness_mont.index_select(0, csr.var.to(torch.int64)), csr.coeff)
    wide = torch.zeros((nrows, tf.N), dtype=torch.int64, device=terms.device)
    wide.index_add_(0, rows, terms.to(torch.int64))
    return tf.canon_wide(FR, wide).to(torch.int32)


def qap_matvec(csr, witness_mont):
    """y[r] = sum of coeff_t * witness[var_t] over row r's terms, (3m, 16)
    Montgomery: A, B and C in one launch (rows r, m + r, 2m + r), zero for
    a row with no terms."""
    tensors = (csr.ptr, csr.var, csr.coeff, csr.long_rows, witness_mont)
    if kn.on_cpu(*tensors):
        return qap_matvec_plain(csr, witness_mont)
    nrows = csr.ptr.shape[0] - 1
    if witness_mont.dim() != 2 or witness_mont.shape[1] != tf.N \
            or csr.coeff.shape != (csr.var.shape[0], tf.N):
        raise ValueError(f"qap_matvec: bad shapes {tuple(csr.coeff.shape)}, "
                         f"{tuple(witness_mont.shape)}")
    kn.check_cuda("qap_matvec", *tensors)
    kn.check_aligned("qap_matvec", csr.coeff, witness_mont)
    y = torch.empty((nrows, tf.N), dtype=torch.int32,
                    device=witness_mont.device)
    kn.K["qap_matvec"](y, csr.ptr, csr.var, csr.coeff, witness_mont,
                       csr.long_rows, nrows, csr.long_rows.shape[0], LONG_ROW)
    return y


def qap_h_arrays(domain, csr, witness_mont, T, std: bool = False):
    """H coefficients (m, 16) for the full witness (index 0 is the constant
    one), in Montgomery form (the JAX package's qap_h_arrays), or in
    standard form if std (T must then hold tntt.std_tables). csr is the
    key's keys.MatrixCSR and T the tables of tntt.tables_to, all on the
    witness's device."""
    m = domain.m
    aA, aB, aC = qap_matvec(csr, witness_mont).reshape(3, m, tf.N)
    aA, aB, aC = (tntt.coset_fft_t(domain, tntt.ifft_t(domain, x, T), T)
                  for x in (aA, aB, aC))
    H = pntt.qap_combine(aA, aB, aC, T["zinv"])
    return tntt.icoset_fft_t(domain, H, T, std=std)
