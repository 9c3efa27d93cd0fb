"""Groth16 prover on one torch device: QAP witness map and five MSMs on the
device, unblinding and the final combine on the host.

Port of blockmaze_tpu/groth16/prover.py (`Prover.__init__`, `prove` and
`prove_batch`; r1cs_gg_ppzksnark.tcc:391-506). The witness goes to the
device as one 64-bit word a wire from a pinned host buffer (its few wires
of 2^64 and above apart, as limb rows), is widened there to standard form
(wire_widen: the MSM scalars) and takes its Montgomery form there (one
mul_elementwise by R^2); the QAP returns H in standard form:

  H       = qap_witness_map(cs, primary, aux)                 [NTT pipeline]
  At      = <A_query, (1, wires)>                             [MSM G1]
  Bt, Bt1 = <B_query sparse, (1, wires)>                      [MSM G2, G1]
  Ht      = <H_query, H[0..m-2]>                              [MSM G1]
  Lt      = <L_query, wires[num_inputs+1..]>                  [MSM G1]
  A = alpha + At + r*delta,  B = beta + Bt + s*delta,
  C = Ht + Lt + s*A + r*B1 - r*s*delta

r and s are drawn per proof from `secrets` unless given; each proof (each
batch, in prove_batch) also draws fresh MSM blinds (msm/pippenger.py), so
the proof for a given (r, s) is the same whatever the blinds.

With a mesh (parallel/mesh.py), as the JAX package's Prover(mesh=...):
every MSM's points lie in one block per shard from init on (each block
uploaded from the host to its shard's device) and the MSMs run through
parallel.mesh.sharded_msm; the QAP runs through parallel.sqap.sharded_qap_h
(the key's CSR cut by rows, every FFT in four steps over the mesh) when
the domain splits evenly over the mesh (sqap.can_shard_domain), else on
the lead device as on one card. The witness, the blinds, the QAP's
elementwise passes and the results live on the lead device. On a
ProcessMesh (parallel.distributed.global_mesh) every process builds the
Prover and calls prove with the same witness; each holds only its own
block of every query and of the CSR, and the draws (r, s when not given,
the blinds' scalars) are rank 0's, broadcast, so every process returns
the same proof. A proof equals the single-card proof at the same (r, s).
"""

from __future__ import annotations

import contextlib
import secrets
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..curves import native
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..msm import pippenger as pp
from ..ntt import pntt, tntt
from ..parallel import mesh as pm
from ..parallel import sntt, sqap
from ..serialization.libsnark_io import Proof
from ..utils import kernels as kn
from ..utils import spans
from . import keys as K
from . import qap

FR = tf.FR


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _pad_points(t, n: int):
    """Pad affine points with infinity rows to n (one MSM shape per size)."""
    x, y, inf = t
    k = n - x.shape[0]
    if k <= 0:
        return t
    return (torch.cat([x, x.new_zeros((k,) + x.shape[1:])]),
            torch.cat([y, y.new_zeros((k,) + y.shape[1:])]),
            torch.cat([inf, inf.new_ones(k)]))


def _pad_scalars(s, n: int):
    k = n - s.shape[0]
    if k <= 0:
        return s
    return torch.cat([s, s.new_zeros((k, s.shape[1]))])


class Prover:
    """Device-resident proving key of one circuit.

    dpk is a DevicePK of this package (a JAX package key comes over through
    the shared npz cache, keys.load_device_pk); device is where every
    tensor lives: the card by default, where the kernels run; "cpu" runs
    their plain versions. lanes is the most MSM accumulation lanes
    (pippenger.lane_cut cuts fewer for a sparse stream), window the
    Pippenger window c. mesh (parallel.mesh.Mesh or ProcessMesh) shards
    the proof over its devices, its lead device in place of device.

    timings holds the seconds of the last call's laps, each the span
    prover.<lap> of utils/spans.py, timed whether or not the span recorder
    is on and ended by a synchronise of the device: after prove, wires
    (the draws, prover.limbs: the witness to a word a wire, _wire_words'
    native pass; prover.upload: the words' copy to the device, their
    widening and Montgomery form;
    prover.blinds: two make_blind on the host), qap, msm (the MSMs, each
    waiting for its live count) and combine (prover.fetch: the MSMs'
    results to the host; prover.unblind; prover.group: A, B and C); after
    prove_batch, see there. prover.blinds, prover.unblind and
    prover.group run the native group law (curves/native.py) and carry
    {"muls": n}, its scalar products: 2, 5 and 6 a proof.

    prove_batch starts one combine thread, which close() stops (a later
    prove_batch starts it again)."""

    def __init__(self, dpk, device="cuda", lanes: Optional[int] = None,
                 window: Optional[int] = None, mesh=None):
        self.mesh = mesh
        self.device = mesh.lead if mesh is not None else torch.device(device)
        self.dpk = dpk
        self.domain = dpk.domain
        cuda = self.device.type == "cuda"
        self.lanes = lanes or (pp.MAX_LANES if cuda else 64)
        self.window = window or pp.default_window(dpk.num_variables)
        n_dev = mesh.size if mesh is not None else 1

        def pad(n):
            # a mesh cuts every MSM into equal blocks (powers of two)
            return max(_next_pow2(n), n_dev)

        # on a mesh each query goes to the shards' devices block by block,
        # from the host, so no device holds a whole query
        dk = K.to_device(dpk, self.device if mesh is None else "cpu")
        m = self.domain.m
        self.nA = pad(dpk.num_variables + 1)
        self.A = self._place(_pad_points(dk.A, self.nA))
        self.nB = pad(len(dpk.B_idx))
        self.B2 = self._place(_pad_points(dk.B2, self.nB))
        self.B1 = self._place(_pad_points(dk.B1, self.nB))
        self.nH = pad(m - 1)
        self.H = self._place(_pad_points(tuple(v[:m - 1] for v in dk.H),
                                         self.nH))
        self.nL = pad(len(dpk.L[2]))
        self.L = self._place(_pad_points(dk.L, self.nL))
        self.B_idx = dk.B_idx.to(self.device)
        self.sharded_qap = mesh is not None and sqap.can_shard_domain(
            self.domain, n_dev)
        if self.sharded_qap:
            self.csr_shards = sqap.shard_csr(mesh, dk.csr)
            self.tables = sntt.tables_to(sntt.sqap_tables(self.domain,
                                                          n_dev), mesh)
        else:
            self.csr = K.MatrixCSR(*(getattr(dk.csr, f).to(self.device)
                                     for f in ("ptr", "var", "coeff",
                                               "long_rows")))
            self.tables = tntt.tables_to({**tntt.qap_tables(self.domain),
                                          **tntt.std_tables(self.domain)},
                                         self.device)
        # x * R^2 * R^-1 = x*R mod r for any x < 2^256 (R^2 mod r is
        # canonical, the operand the product needs)
        self._r2 = tf.to_tensor(FR.r2_limbs[None], self.device)
        self._consts = (dpk.alpha_g1, dpk.beta_g1, dpk.beta_g2, dpk.delta_g1,
                        dpk.delta_g2)
        # the witness's words, rewritten by every proof (_limbs) through
        # the numpy view: pinned on a card, so the upload copies them at
        # the bus's rate. The copy is blocking and the widening writes a
        # new tensor (on the CPU too), so nothing a proof keeps shares the
        # buffer and no proof reads another's words. A non-blocking copy
        # would make this reuse unsafe.
        self._words = torch.empty(dpk.num_variables + 1, dtype=torch.int64,
                                  pin_memory=cuda)
        self._word_buf = self._words.numpy()
        # the host libraries built now, not inside the first proof
        kn.host_lib("wirelimbs.cpp")
        native.lib()
        self._pool = None
        self.timings = {}
        self.msm_inputs = {}

    def _place(self, pts):
        """An MSM's points: as they are, or one block per shard."""
        return pts if self.mesh is None else self.mesh.shard_points(pts)

    def _sync(self):
        devs = (self.mesh.local_devices if self.mesh is not None
                else (self.device,))
        with spans.span("device.wait"):
            for d in dict.fromkeys(devs):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def _lap(self, label):
        """The lap prover.<label>, the device synchronised at its end, its
        seconds into timings[label]."""
        with spans.Timed("prover." + label, sync=self._sync) as lap:
            yield lap
        self.timings[label] = lap.seconds

    def _msm(self, name, curve, pts, scalars, n, blind):
        """One MSM of the proof; its points and padded scalars stay in
        msm_inputs[name] until the next proof."""
        scalars = _pad_scalars(scalars, n)
        self.msm_inputs[name] = (pts, scalars)
        if self.mesh is not None:
            return pm.sharded_msm(self.mesh, curve, pts, scalars,
                                  self.window, self.lanes, blind=blind)
        return pp.msm(curve, pts, scalars, self.window, self.lanes,
                      blind=blind)

    def _qap(self, wires_mont):
        """H[0..m-2] in standard form (the H MSM's scalars)."""
        if self.sharded_qap:
            H = sqap.sharded_qap_h(self.mesh, self.domain, self.csr_shards,
                                   wires_mont, self.tables, std=True)
        else:
            H = qap.qap_h_arrays(self.domain, self.csr, wires_mont,
                                 self.tables, std=True)
        return H[:self.domain.m - 1]

    def _check_sizes(self, primary, aux):
        dpk = self.dpk
        if len(primary) != dpk.primary_input_size:
            raise ValueError(f"primary input has {len(primary)} values, the "
                             f"key wants {dpk.primary_input_size}")
        if len(aux) != dpk.aux_input_size:
            raise ValueError(f"auxiliary input has {len(aux)} values, the "
                             f"key wants {dpk.aux_input_size}")

    def _msms(self, wires_std, H_std, b1, b2):
        """The five blinded MSMs of one proof: (A, B g2, B g1, H, L), each
        (X, Y, Z, window counts of the blind) on the device."""
        At = self._msm("A", "g1", self.A, wires_std, self.nA, b1)
        b_scalars = wires_std.index_select(0, self.B_idx)
        Bt2 = self._msm("B g2", "g2", self.B2, b_scalars, self.nB, b2)
        Bt1 = self._msm("B g1", "g1", self.B1, b_scalars, self.nB, b1)
        Ht = self._msm("H", "g1", self.H, H_std, self.nH, b1)
        Lt = self._msm("L", "g1", self.L,
                       wires_std[self.dpk.primary_input_size + 1:], self.nL,
                       b1)
        return At, Bt2, Bt1, Ht, Lt

    def _shared(self, draws):
        """draws as every shard of the mesh sees them: on a ProcessMesh rank
        0's (a random value drawn on each process would differ)."""
        return draws if self.mesh is None else self.mesh.broadcast(draws)

    def _blinds(self, k1: int, k2: int):
        """The G1 and G2 blinds of scalars k1, k2: ((R1, b1), (R2, b2))."""
        return (pp.make_blind("g1", self.device, k1),
                pp.make_blind("g2", self.device, k2))

    @spans.traced("prover.prove")
    def prove(self, primary: List[int], aux: List[int],
              r: Optional[int] = None, s: Optional[int] = None) -> Proof:
        self._check_sizes(primary, aux)
        self.timings = {}
        self.msm_inputs = {}
        with self._lap("wires"):
            r, s, k1, k2 = self._shared((
                secrets.randbelow(R_MOD) if r is None else r,
                secrets.randbelow(R_MOD) if s is None else s,
                pp.blind_scalar(), pp.blind_scalar()))
            wide, _ = self._limbs(primary, aux)
            wires_std, wires_mont = self._upload(wide)
            with _muls(spans.span("prover.blinds")):
                (R1, b1), (R2, b2) = self._blinds(k1, k2)

        with self._lap("qap"):
            H_std = self._qap(wires_mont)

        with self._lap("msm"):
            msms = self._msms(wires_std, H_std, b1, b2)

        with self._lap("combine"):
            proof = _combine(self._consts, self.window, _to_numpy(msms), R1,
                             R2, r, s)
        return proof

    def _limbs(self, primary, aux):
        """The wires (1, primary, aux) as words in the reused buffer; their
        wide rows (_wire_words) and the seconds of the span prover.limbs
        that makes them (its info: {"wires": rows, "wide": rows that took
        Python's branch})."""
        with spans.Timed("prover.limbs") as lap:
            words, wide = _wire_words(primary, aux, self._word_buf)
            lap.info = {"wires": len(words), "wide": len(wide)}
        return wide, lap.seconds

    def _upload(self, wide):
        """The wires on the device, in standard and in Montgomery form:
        the buffer's words (one blocking copy) and the wide rows copied,
        widened by wire_widen. The span prover.upload's info: {"bytes":
        copied, "pinned": 1 if the words crossed from pinned memory,
        "wide": rows}. No tensor shares memory with the buffer."""
        with spans.span("prover.upload") as sp:
            words = self._words.to(self.device)
            rows = torch.from_numpy(wide).to(self.device)
            sp.info = {"bytes": self._words.nbytes + wide.nbytes,
                       "pinned": int(self._words.is_pinned()),
                       "wide": len(wide)}
            wires_std = wire_widen(words, rows)
            return wires_std, pntt.mul_elementwise(wires_std, self._r2)

    @spans.traced("prover.prove_batch")
    def prove_batch(self, instances, rs: Optional[List[int]] = None,
                    ss: Optional[List[int]] = None) -> List[Proof]:
        """Proofs of B (primary, aux) witnesses of this circuit, proofs[i]
        equal to prove(*instances[i], rs[i], ss[i]); r and s are drawn per
        proof from `secrets` unless given. One blind pair serves the batch,
        and each proof is unblinded with its own window counts, as the JAX
        package's prove_batch does.

        There is no batch axis through the kernels: this thread turns each
        witness into words, uploads and widens it and runs its QAP and MSMs
        (waiting for the device at each MSM's live count and for its
        results), with no sync between phases; the host combine of each
        proof (_combine: the native group law's unblinding and A, B, C,
        which releases the interpreter lock) runs meanwhile on the Prover's
        combine thread.
        The overlap rests on this thread releasing the lock too, as it
        does at every torch call and every wait for the device.

        timings holds the batch's laps, each the span prover.<lap>
        (utils/spans.py), timed whether or not the recorder is on and ended
        by a synchronise of the device: blinds (the draws and the batch's
        blind pair; {"muls": 2}), dispatch (this thread's loop: per witness
        prover.limbs, prover.upload, the QAP and MSMs, prover.fetch and
        prover.submit to the combine thread) and drain (the combines left
        after it); and limbs, the prover.limbs spans' seconds summed. Each
        combine's spans, prover.unblind and prover.group, are recorded on
        the combine thread as children of this call's prover.prove_batch
        (spans.carry)."""
        for primary, aux in instances:
            self._check_sizes(primary, aux)
        B = len(instances)
        rs = [secrets.randbelow(R_MOD) for _ in range(B)] if rs is None \
            else list(rs)
        ss = [secrets.randbelow(R_MOD) for _ in range(B)] if ss is None \
            else list(ss)
        if len(rs) != B or len(ss) != B:
            raise ValueError(f"{B} instances, {len(rs)} r and {len(ss)} s")
        if B == 0:
            return []
        self.timings = {"limbs": 0.0}
        self.msm_inputs = {}
        combine = spans.carry(_combine)
        with _muls(self._lap("blinds")):
            rs, ss, k1, k2 = self._shared((rs, ss, pp.blind_scalar(),
                                           pp.blind_scalar()))
            (R1, b1), (R2, b2) = self._blinds(k1, k2)
        with self._lap("dispatch"):
            pool = self._host_pool()
            proofs = []
            for (primary, aux), r, s in zip(instances, rs, ss):
                wide, seconds = self._limbs(primary, aux)
                self.timings["limbs"] += seconds
                wires_std, wires_mont = self._upload(wide)
                H_std = self._qap(wires_mont)
                msms = _to_numpy(self._msms(wires_std, H_std, b1, b2))
                with spans.span("prover.submit"):
                    proofs.append(pool.submit(combine, self._consts,
                                              self.window, msms, R1, R2, r,
                                              s))
        with self._lap("drain"):
            proofs = [p.result() for p in proofs]
        return proofs

    def _host_pool(self) -> ThreadPoolExecutor:
        """prove_batch's combine thread: one, since a combine is a few ms
        of native work beside tens of ms of dispatch a proof; started at
        the first prove_batch after construction or close()."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="prover-combine")
        return self._pool

    def close(self):
        """Stop prove_batch's combine thread, if one was started."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _wire_words(primary, aux, out: np.ndarray):
    """The wires (1, primary, aux) as one little-endian 64-bit word a wire,
    written into out ((n,) int64, returned), and the wide rows: a (k, 17)
    int32 array, each a wire's row and its 16 standard-form limbs, for the
    k wires a word cannot hold (2^64 and above, negative, not an exact
    int), whose words are 0. wire_widen of the two equals
    tf.ints_to_limbs([1] + list(primary) + list(aux)), and this raises what
    that raises. One native pass (csrc/wirelimbs.cpp) writes every word;
    each wide wire's limbs come from int(x).to_bytes(32, "little") here."""
    primary = primary if type(primary) is list else list(primary)
    aux = aux if type(aux) is list else list(aux)
    n = 1 + len(primary) + len(aux)
    if out.shape != (n,) or out.dtype != np.int64 or \
            not out.flags.c_contiguous:
        raise ValueError(f"the words of {n} wires need a C-contiguous ({n},) "
                         f"int64 array, got {out.shape} {out.dtype}")
    rows = np.empty(n, np.int64)
    k = kn.host_lib("wirelimbs.cpp").bm_wire_words(
        primary, aux, out.ctypes.data, n, rows.ctypes.data)
    wide = np.empty((k, 1 + tf.N), np.int32)
    for i, row in enumerate(rows[:k].tolist()):
        x = primary[row - 1] if row <= len(primary) else \
            aux[row - 1 - len(primary)]
        wide[i, 0] = row
        wide[i, 1:] = np.frombuffer(int(x).to_bytes(32, "little"), "<u2")
    return out, wide


def wire_widen_plain(words, wide):
    """wire_widen's plain version (any device)."""
    shifts = torch.arange(0, 64, 16, device=words.device)
    out = torch.zeros((words.shape[0], tf.N), dtype=torch.int32,
                      device=words.device)
    out[:, :4] = (words[:, None] >> shifts & 0xFFFF).to(torch.int32)
    out[wide[:, 0].long()] = wide[:, 1:]
    return out


def wire_widen(words, wide):
    """The (n, 16) int32 standard-form limbs of n wires from their (n,)
    int64 words (_wire_words: each the wire's value below 2^64, its bits
    as an int64), then each wide row (wide: (k, 17) int32, a row in [0, n)
    and its 16 limbs) written over its slot. The kernel wire_widen
    (csrc/widen.cu) on a card, wire_widen_plain on the CPU."""
    if kn.on_cpu(words, wide):
        return wire_widen_plain(words, wide)
    n, k = words.shape[0], wide.shape[0]
    if words.shape != (n,) or words.dtype != torch.int64 or \
            wide.shape != (k, 1 + tf.N):
        raise ValueError(f"wire_widen: bad inputs {tuple(words.shape)} "
                         f"{words.dtype}, {tuple(wide.shape)}")
    kn.check_cuda("wire_widen", words.view(torch.int32), wide)
    out = torch.empty((n, tf.N), dtype=torch.int32, device=words.device)
    kn.K["wire_widen"](out, words, n, wide, k)
    return out


def _to_numpy(msms):
    """The MSM results as host numpy arrays (waits for the device): the
    span prover.fetch."""
    with spans.span("prover.fetch"):
        return tuple(tuple(t.cpu().numpy() for t in res) for res in msms)


def _combine(consts, c: int, msms, R1, R2, r: int, s: int) -> Proof:
    """The host half of a proof in the native group law (curves/native.py):
    each MSM (X, Y, Z, blind window counts as numpy arrays, in _msms'
    order) from the card's Jacobian limbs to affine, less its blind's
    surplus against R1 or R2 (the span prover.unblind, five scalar
    products), then A, B and C with r and s (prover.group, six). consts:
    the key's (alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2). prove
    runs it inline, prove_batch on the combine thread."""
    At, Bt2, Bt1, Ht, Lt = msms
    with _muls(spans.span("prover.unblind")):
        At_h, Bt1_h, Ht_h, Lt_h = (pp.unblind_result("g1", res, R1, c)
                                   for res in (At, Bt1, Ht, Lt))
        Bt2_h = pp.unblind_result("g2", Bt2, R2, c)

    with _muls(spans.span("prover.group")):
        A, B, C = native.combine(consts, (At_h, Bt2_h, Bt1_h, Ht_h, Lt_h),
                                 r, s)
    return Proof(a=A, b=B, c=C)


@contextlib.contextmanager
def _muls(span):
    """span entered; its info {"muls": the native scalar products this
    thread made inside it}."""
    with span as sp:
        n = native.muls()
        yield
        sp.info = {"muls": native.muls() - n}
