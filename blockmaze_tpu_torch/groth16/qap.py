"""R1CS -> QAP witness map on torch tensors.

Port of blockmaze_tpu/groth16/qap.py (r1cs_to_qap_witness_map with
d1 = d2 = d3 = 0): three sparse COO matvecs (gather, Fr product through
pntt.mul_elementwise, integer index_add_, canonical fold), the input
consistency rows, then iFFT -> coset FFT on A, B, C, the pointwise
A*B - C, divide by Z on the coset, and the inverse coset FFT.
"""

from __future__ import annotations

import torch

from ..fields import tfield as tf
from ..ntt import pntt, tntt

FR = tf.FR


def sparse_matvec(row, var, coeff, witness_mont, m: int):
    """y[r] = sum of coeff_t * witness[var_t] over the terms with
    row_t == r, as (m, 16) Montgomery limbs (rows >= ncons are zero).

    The per-row sum runs over 16-bit limbs in int64 (exact for any fan-in
    below 2^32 terms), then tfield.canon_wide folds it to the canonical
    residue with three Montgomery products by constants."""
    terms = pntt.mul_elementwise(witness_mont.index_select(0, var), coeff)
    wide = torch.zeros((m, tf.N), dtype=torch.int64, device=terms.device)
    wide.index_add_(0, row, terms.to(torch.int64))
    return tf.canon_wide(FR, wide, mul=lambda a, b: pntt.mul_elementwise(
        a.to(torch.int32), b.to(torch.int32))).to(torch.int32)


def qap_h_arrays(domain, meta, coos, witness_mont, T):
    """H coefficients (m, 16) Montgomery for the full witness (index 0 is
    the constant one). meta = (num_constraints, primary_input_size); coos
    are the three (row int64, var int64, coeff int32) triples on the
    witness's device and T the tables of tntt.tables_to."""
    m = domain.m
    ncons, n_inp = meta
    (a_row, a_var, a_coeff), (b_row, b_var, b_coeff), \
        (c_row, c_var, c_coeff) = coos

    aA = sparse_matvec(a_row, a_var, a_coeff, witness_mont, m)
    aB = sparse_matvec(b_row, b_var, b_coeff, witness_mont, m)
    aA[ncons:ncons + n_inp + 1] = witness_mont[:n_inp + 1]

    aA = tntt.coset_fft_t(domain, tntt.ifft_t(domain, aA, T), T)
    aB = tntt.coset_fft_t(domain, tntt.ifft_t(domain, aB, T), T)
    H = pntt.mul_elementwise(aA, aB)

    aC = sparse_matvec(c_row, c_var, c_coeff, witness_mont, m)
    aC = tntt.coset_fft_t(domain, tntt.ifft_t(domain, aC, T), T)

    H = tf.sub(FR, H, aC).to(torch.int32)
    H = tntt.divide_by_z_t(H, T)
    return tntt.icoset_fft_t(domain, H, T)
