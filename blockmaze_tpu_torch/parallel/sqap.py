"""Sharded R1CS -> QAP witness map (the mesh version of groth16/qap.py).

Port of blockmaze_tpu/parallel/sqap.py, with the two hot structures
distributed over the mesh:

  sparse matvec   the key's CSR (keys.MatrixCSR, A, B and C stacked) cut
                  by rows into one block per shard, of about equal terms;
                  each shard runs qap_matvec on its rows against its copy
                  of the witness and the blocks are gathered on the lead
                  device (mesh.gather_rows). Every row's sum is canonical,
                  so any cut gives the same bits and no field reduction
                  crosses devices (the JAX package psums lazy limb sums
                  instead).
  FFT pipeline    every iFFT / coset FFT / inverse coset FFT through the
                  4-step mesh decomposition (parallel/sntt.py), on both
                  domain kinds.

(A*B - C)/Z stays one qap_combine on the lead device (on every process of
a ProcessMesh), as do the step domain's elementwise stages: they are one
pass over m rows each.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fields import tfield as tf
from ..groth16 import qap
from ..groth16.keys import MatrixCSR
from ..ntt import pntt
from ..ntt.domain import BasicDomain
from . import sntt


@dataclasses.dataclass
class CSRShard:
    """Rows [start, stop) of a MatrixCSR as a MatrixCSR of their own on one
    device (ptr from 0, long_rows from start); cuts: every shard's first
    row, then the row count (shard d has rows cuts[d] to cuts[d + 1])."""
    start: int
    stop: int
    csr: MatrixCSR
    cuts: tuple


def shard_csr(mesh, csr: MatrixCSR):
    """csr (tensors) cut by rows into mesh.size blocks of about equal
    terms: the block of each shard this process computes, on its device
    (every process computes the same cuts from the same ptr). The term
    arrays are slices, so a block on csr's own device shares its
    storage."""
    ptr = csr.ptr.cpu().numpy().astype(np.int64)
    nrows, nnz, n = ptr.shape[0] - 1, int(ptr[-1]), mesh.size
    cuts = tuple([0] + [min(nrows, int(np.searchsorted(ptr,
                                                        -(-nnz * d // n))))
                        for d in range(1, n)] + [nrows])
    lr = csr.long_rows
    out = []
    for d, dev in zip(mesh.shards, mesh.local_devices):
        r0, r1 = cuts[d], cuts[d + 1]
        t0, t1 = int(ptr[r0]), int(ptr[r1])
        out.append(CSRShard(r0, r1, MatrixCSR(
            ptr=(csr.ptr[r0:r1 + 1] - t0).to(dev),
            var=csr.var[t0:t1].to(dev), coeff=csr.coeff[t0:t1].to(dev),
            long_rows=(lr[(lr >= r0) & (lr < r1)] - r0).to(dev)), cuts))
    return out


def sharded_matvec(mesh, shards, witness_mont):
    """y[r] = sum of coeff_t * witness[var_t] over row r's terms for every
    row of the sharded CSR (shard_csr), (rows, 16) Montgomery on the lead
    device: one qap_matvec per shard with rows, each against its own copy
    of the witness, and the blocks (of unequal rows) gathered."""
    parts = [qap.qap_matvec(s.csr, witness_mont.to(dev))
             if s.stop > s.start else
             witness_mont.new_empty((0, tf.N)).to(dev)
             for s, dev in zip(shards, mesh.local_devices)]
    cuts = shards[0].cuts
    return mesh.gather_rows(parts, [b - a for a, b in zip(cuts, cuts[1:])])


def can_shard_domain(domain, n_dev: int) -> bool:
    if isinstance(domain, BasicDomain):
        return sntt.can_shard(domain.m, n_dev)
    return (sntt.can_shard(domain.big_m, n_dev)
            and sntt.can_shard(domain.small_m, n_dev))


def sharded_qap_h(mesh, domain, shards, witness_mont, T, std: bool = False):
    """qap.qap_h_arrays over the mesh: the same (m, 16) H on the lead
    device, in Montgomery form, or in standard form if std. shards is
    shard_csr of the key's CSR, T sntt.tables_to(sntt.sqap_tables(domain,
    mesh.size), mesh), witness_mont on the lead device. On a ProcessMesh
    every process calls it with the same witness and gets the same H."""
    m = domain.m
    aA, aB, aC = sharded_matvec(mesh, shards, witness_mont).reshape(3, m,
                                                                    tf.N)
    aA, aB, aC = (sntt.s_coset_fft_t(mesh, domain,
                                     sntt.s_ifft_t(mesh, domain, x, T), T)
                  for x in (aA, aB, aC))
    H = pntt.qap_combine(aA, aB, aC, T["lead"]["zinv"])
    return sntt.s_icoset_fft_t(mesh, domain, H, T, std=std)
