"""blockmaze_tpu_torch's mesh across processes (parallel.mesh.ProcessMesh,
parallel.distributed) on the CPU: two processes join one gloo group on
127.0.0.1 through distributed.initialize and run, on
distributed.global_mesh(), sharded_msm (G1 and G2, with and without a
blind), the sharded FFT, inverse, coset and inverse coset FFT (basic m =
32, step m = 48), sharded_matvec on an uneven cut, the sharded field sum,
and Prover(mesh=global_mesh()) on chain_circuit(30) (basic) and
chain_circuit(46) (step, through prove_batch) at (r, s) = (7, 9) and on
chain_circuit(30) with r, s and the blinds drawn by the Prover. Every
process's result is held, exactly, against the JAX package (its
parallel/ on 2 of the conftest's virtual devices, its single-chip
Prover), the single-device port and the host oracle, and against the
other process's. The two processes run every check in one spawn each (a
module fixture), as the plain MSM folds make each one cost seconds.

Also: a launch through torchrun (its agent serves the group's store),
the backend choice from a placement, the atomic key writes, and the
kernel build lock (one process compiles, the others wait)."""

import os
import pickle
import random
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.groth16 import generator as jgen
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.groth16.prover import Prover as JaxProver
from blockmaze_tpu.msm import pippenger as jpp
from blockmaze_tpu.ntt import domain as JD
from blockmaze_tpu.parallel import mesh as jmesh
from blockmaze_tpu.parallel import sntt as jsntt
from blockmaze_tpu.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import keys, qap, verifier
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.ntt import domain as D
from blockmaze_tpu_torch.ntt import tntt
from blockmaze_tpu_torch.ntt.domain import MULT_GEN
from blockmaze_tpu_torch.parallel import distributed
from blockmaze_tpu_torch.serialization.libsnark_io import Proof
from blockmaze_tpu_torch.utils import kernels as kn

from test_torch_parallel_msm import _curve, _host_msm
from test_torch_sharded_prover import (LANES, WINDOW, R, S, _coo,
                                       check_proof, fields)

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

FR = tf.FR
RANKS = 2
C, MSM_LANES, PER_RANK = 8, 4, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
MSM_CASES = [("g1", False), ("g1", True), ("g2", False), ("g2", True)]
FFT_OPS = ["fft", "ifft", "coset_fft", "icoset_fft"]
FFT_SIZES = {"basic32": 32, "step48": 48}
CIRCUITS = {"basic": 30, "step": 46}
RANK_TIMEOUT = 900


# ---------------------------------------------------------------------------
# One process of the group
# ---------------------------------------------------------------------------

def _fft_ops(mesh, dom, a):
    from blockmaze_tpu_torch.parallel import sntt
    return {"fft": lambda: sntt.s_fft(mesh, dom, a),
            "ifft": lambda: sntt.s_ifft(mesh, dom, a),
            "coset_fft": lambda: sntt.sharded_coset_fft(mesh, dom, a,
                                                        MULT_GEN),
            "icoset_fft": lambda: sntt.sharded_icoset_fft(mesh, dom, a,
                                                          MULT_GEN)}


def _rank_main(workdir):
    """Every check on global_mesh() of this process's group (joined from
    the launcher's variables); results to <workdir>/rank<i>.pkl."""
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.parallel import mesh as pm
    from blockmaze_tpu_torch.parallel import sqap
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    assert distributed.initialize(device="cpu")
    mesh = distributed.global_mesh()
    out = {"rank": mesh.rank, "size": mesh.size, "lead": str(mesh.lead),
           "devices": [str(d) for d in mesh.devices],
           "backend": torch.distributed.get_backend()}
    for curve, blinded in MSM_CASES:
        pts, sc, k = inp["msm"][curve]
        P = tuple(torch.from_numpy(t) for t in pts)
        bl = pp.make_blind(curve, "cpu", k)[1] if blinded else None
        res = pm.sharded_msm(mesh, curve, P, torch.from_numpy(sc), c=C,
                             lanes=MSM_LANES, blind=bl)
        out["msm", curve, blinded] = tuple(t.numpy() for t in res)
    for name, n in FFT_SIZES.items():
        dom = D.get_evaluation_domain(n)
        for op, fn in _fft_ops(mesh, dom,
                               torch.from_numpy(inp["fft"][name])).items():
            out["fft", name, op] = fn().numpy()
    csr, wit = inp["matvec"]
    shards = sqap.shard_csr(mesh, keys.csr_to(csr, "cpu"))
    out["cuts"] = shards[0].cuts
    out["matvec"] = sqap.sharded_matvec(mesh, shards,
                                        tf.to_tensor(wit, "cpu")).numpy()
    out["field_sum"] = pm.sharded_field_inner_sum(
        mesh, tf.to_tensor(inp["field_sum"], "cpu")).numpy()
    for kind, (path, primary, aux) in inp["provers"].items():
        prover = Prover(keys.load_device_pk(path), lanes=LANES,
                        window=WINDOW, mesh=distributed.global_mesh())
        out["sharded_qap", kind] = prover.sharded_qap
        out["nA_local", kind] = [p[0].shape[0] for p in prover.A]
        if kind == "step":
            try:
                (proof,) = prover.prove_batch([(primary, aux)], rs=[R],
                                              ss=[S])
            finally:
                prover.close()
        else:
            proof = prover.prove(primary, aux, r=R, s=S)
            out["drawn"] = fields(prover.prove(primary, aux))
        out["proof", kind] = fields(proof)
    with open(os.path.join(workdir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _torchrun_main(workdir):
    """Joined as torchrun starts it: the mesh and a field sum over it, to
    <workdir>/torchrun<rank>.pkl."""
    from blockmaze_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    assert distributed.initialize(device="cpu")
    mesh = distributed.global_mesh()
    vals = tf.to_mont_host(FR, list(range(1, 9)))
    out = {"rank": mesh.rank, "backend": torch.distributed.get_backend(),
           "devices": [str(d) for d in mesh.devices],
           "agent_store": os.environ.get("TORCHELASTIC_USE_AGENT_STORE"),
           "field_sum": pm.sharded_field_inner_sum(
               mesh, tf.to_tensor(vals, "cpu")).numpy()}
    with open(os.path.join(workdir, f"torchrun{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(workdir):
    """RANKS processes of _rank_main, logs to <workdir>/rank<i>.log."""
    port = _free_port()
    code = ("import sys; sys.path[:0] = sys.argv[2:]; "
            "import test_torch_process_mesh as t; t._rank_main(sys.argv[1])")
    procs = []
    for r in range(RANKS):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(workdir), TESTS, ROOT],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                env={**os.environ, "PYTHONPATH": ROOT,
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                     "WORLD_SIZE": str(RANKS), "RANK": str(r),
                     "LOCAL_RANK": str(r)}))
    return procs


def _wait_ranks(procs, workdir, deadline):
    """Wait for every rank until `deadline` (time.monotonic()), then stop
    any left; every one must have exited 0. Returns their results in rank
    order."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    outs = []
    for r in range(RANKS):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# The parent: inputs, the ranks, the references
# ---------------------------------------------------------------------------

def _msm_input(curve, seed):
    """RANKS * PER_RANK random points (an infinity point among them in G1)
    and scalars (the first two 0 and 1); a blind's scalar."""
    g, mul, _, _, zero, to_dev = _curve(curve)[:6]
    r = random.Random(seed)
    n = RANKS * PER_RANK
    pts = [mul(g, r.randrange(1, R_MOD)) for _ in range(n)]
    if curve == "g1":
        pts[2] = zero
    sc = [r.randrange(R_MOD) for _ in range(n)]
    sc[0], sc[1] = 0, 1
    X, Y, inf = to_dev(pts)
    return pts, sc, ((X.view(np.int32), Y.view(np.int32), inf),
                     tf.ints_to_limbs(sc).view(np.int32), pp.blind_scalar())


def _matvec_input():
    """A CSR of 2 x 48 rows with every term in the last 40 rows but for a
    long row (so the cut by terms is uneven), and a witness."""
    rng = np.random.RandomState(11)
    m, nvars = 96, 20
    row, var, coeff = _coo(rng, 40, nvars, 150, long_row=7)
    row = np.where(row == 7, row, row + m - 40).astype(np.int32)
    wit = tf.to_mont_host(FR, [int(rng.randint(1, 1 << 30))
                               for _ in range(nvars)])
    return keys.coo_to_csr(row, var, tf.to_mont_host(FR, coeff), m), wit


def _circuit(ncons, workdir, kind):
    """chain_circuit(ncons): the JAX keygen's keys, the port's DevicePK
    written to workdir, the witness."""
    pb = chain_circuit(ncons)
    toxic = iter([11, 13, 17, 19, 23])
    pk, vk = jgen.generate(pb, rng=lambda: next(toxic))
    path = os.path.join(workdir, f"{kind}.v1.npz")
    keys.save_device_pk(keys.build_device_pk(pk), path)
    return pb, pk, vk, path


def _jax_fft(dom, host):
    """The JAX package's sharded FFTs of host over 2 devices, by op."""
    jdom, ja, jm = (JD.get_evaluation_domain(dom.m),
                    jnp.asarray(host.view(np.uint32)),
                    jmesh.make_mesh(RANKS))
    return {"fft": np.asarray(jsntt.s_fft(jm, jdom, ja)),
            "ifft": np.asarray(jsntt.s_ifft(jm, jdom, ja)),
            "coset_fft": np.asarray(jsntt.sharded_coset_fft(jm, jdom, ja,
                                                            MULT_GEN)),
            "icoset_fft": np.asarray(jsntt.sharded_icoset_fft(jm, jdom, ja,
                                                              MULT_GEN))}


def _jax_msm(curve, pts, sc):
    """The JAX package's unblinded sharded_msm over 2 devices, host
    affine."""
    jax_to_dev, jax_to_host = _curve(curve)[7:]
    jres = jmesh.sharded_msm(
        jmesh.make_mesh(RANKS), curve,
        tuple(jnp.asarray(t) for t in jax_to_dev(pts)),
        jnp.asarray(jpp.scalars_to_device(sc)), c=C, lanes=MSM_LANES)
    return jax_to_host(tuple(np.asarray(r)[None] for r in jres))[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the RANKS processes' results, the JAX references, made
    while the ranks run)."""
    workdir = tmp_path_factory.mktemp("process_mesh")
    msm = {curve: _msm_input(curve, 30 + i)
           for i, curve in enumerate(("g1", "g2"))}
    rnd = random.Random(5)
    fft = {name: tf.to_mont_host(FR, [rnd.randrange(R_MOD) for _ in range(
        D.get_evaluation_domain(n).m)]).view(np.int32)
        for name, n in FFT_SIZES.items()}
    matvec = _matvec_input()
    field_sum = tf.to_mont_host(FR, [rnd.randrange(R_MOD)
                                     for _ in range(64)])
    circuits = {kind: _circuit(n, workdir, kind)
                for kind, n in CIRCUITS.items()}
    inputs = {
        "msm": {c: v[2] for c, v in msm.items()}, "fft": fft,
        "matvec": matvec, "field_sum": field_sum,
        "provers": {kind: (path, pb.primary_input(), pb.auxiliary_input())
                    for kind, (pb, _, _, path) in circuits.items()}}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    deadline = time.monotonic() + RANK_TIMEOUT
    procs = _start_ranks(workdir)
    # the JAX references in threads (most of their time is outside the
    # interpreter lock), while the ranks run
    try:
        with ThreadPoolExecutor(3) as pool:
            proofs = {kind: pool.submit(
                lambda pb, pk: JaxProver(jkeys.build_device_pk(pk), lanes=8,
                                         window=8).prove(
                    pb.primary_input(), pb.auxiliary_input(), r=R, s=S),
                pb, pk) for kind, (pb, pk, _, _) in circuits.items()}
            rest = pool.submit(lambda: (
                {name: _jax_fft(D.get_evaluation_domain(n), fft[name])
                 for name, n in FFT_SIZES.items()},
                {curve: _jax_msm(curve, *msm[curve][:2])
                 for curve in ("g1", "g2")}))
            jax_proofs = {kind: f.result() for kind, f in proofs.items()}
            jax_fft, jax_msm = rest.result()
    finally:
        outs = _wait_ranks(procs, workdir, deadline)
    return {"inputs": inputs, "msm": msm, "outs": outs,
            "circuits": circuits, "jax_proofs": jax_proofs,
            "jax_fft": jax_fft, "jax_msm": jax_msm}


def test_ranks_join_gloo_and_list_devices(run):
    """initialize() chose gloo on the CPU; global_mesh() is the process
    mesh of both ranks, rank i shard i, every rank's device listed in
    rank order, results on the rank's own device."""
    for r, out in enumerate(run["outs"]):
        assert out["rank"] == r and out["size"] == RANKS
        assert out["backend"] == "gloo"
        assert out["devices"] == ["cpu"] * RANKS and out["lead"] == "cpu"


@pytest.mark.parametrize("curve,blinded", MSM_CASES,
                         ids=[f"{c}-{'blind' if b else 'plain'}"
                              for c, b in MSM_CASES])
def test_sharded_msm_over_ranks(run, curve, blinded):
    """sharded_msm over the 2 ranks equals the host sum on both ranks;
    blinded, its (2, W) window counts unblind to it; unblinded, it equals
    the JAX package's sharded_msm over 2 devices."""
    pts, sc, (_, _, k) = run["msm"][curve]
    want = _host_msm(curve, pts, sc)
    to_host = _curve(curve)[6]
    results = [out["msm", curve, blinded] for out in run["outs"]]
    for res in results[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(res, results[0]))
    res = results[0]
    got = to_host(tuple(torch.from_numpy(t[None]) for t in res[:3]))[0]
    if blinded:
        assert res[3].shape == (RANKS, pp.n_windows(C))
        got = pp.unblind_msm(curve, got, res[3],
                             pp.make_blind(curve, "cpu", k)[0], C)
    else:
        assert run["jax_msm"][curve] == got
    assert got == want


@pytest.mark.parametrize("op", FFT_OPS)
@pytest.mark.parametrize("name", list(FFT_SIZES))
def test_sharded_fft_over_ranks(run, name, op):
    """The sharded FFTs over the 2 ranks, on both ranks, equal tntt's on
    one device and the JAX package's sharded ones over 2 devices."""
    dom = D.get_evaluation_domain(FFT_SIZES[name])
    assert dom.kind == name[:-2]
    host = run["inputs"]["fft"][name]
    a = torch.from_numpy(host)
    T = tntt.tables_to({**tntt.qap_tables(dom), **tntt.std_tables(dom)},
                       "cpu")
    want = {"fft": lambda: tntt.fft_t(dom, a, T),
            "ifft": lambda: tntt.ifft_t(dom, a, T),
            "coset_fft": lambda: tntt.coset_fft_t(dom, a, T),
            "icoset_fft": lambda: tntt.icoset_fft_t(dom, a, T)}[op]()
    for out in run["outs"]:
        got = out["fft", name, op]
        assert np.array_equal(got, want.numpy())
        assert np.array_equal(got.view(np.uint32), run["jax_fft"][name][op])


def test_sharded_matvec_uneven_over_ranks(run):
    """The CSR's terms cut the rows unevenly (rank 0 takes the long row and
    most empty rows); the gathered rows equal qap_matvec's on one device
    and the integer sums, on both ranks."""
    csr, wit = run["inputs"]["matvec"]
    cuts = run["outs"][0]["cuts"]
    sizes = [b - a for a, b in zip(cuts, cuts[1:])]
    assert len(set(sizes)) > 1 and cuts[-1] == csr.ptr.shape[0] - 1
    want = qap.qap_matvec(keys.csr_to(csr, "cpu"),
                          tf.to_tensor(wit, "cpu")).numpy()
    w = tf.from_mont_host(FR, wit)
    ints = [sum(tf.from_mont_host(FR, csr.coeff[t:t + 1])[0]
                * w[csr.var[t]] for t in range(a, b)) % R_MOD
            for a, b in zip(csr.ptr, csr.ptr[1:])]
    assert tf.from_mont_host(FR, want) == ints
    for out in run["outs"]:
        assert out["cuts"] == cuts
        assert np.array_equal(out["matvec"], want)


def test_sharded_field_sum_over_ranks(run):
    vals = tf.from_mont_host(FR, run["inputs"]["field_sum"])
    for out in run["outs"]:
        got = out["field_sum"].view(np.uint32)
        assert tf.from_mont_host(FR, got[None])[0] == sum(vals) % R_MOD


@pytest.mark.parametrize("kind", list(CIRCUITS))
def test_process_mesh_prover_equals_jax_single_chip(run, kind):
    """Prover(mesh=global_mesh()) over 2 ranks, each holding half of every
    query: the proof at (7, 9) on every rank (the step circuit's through
    prove_batch) equals the JAX package's single-chip proof, and both
    verifiers accept it and reject a wrong input."""
    pb, _, vk, _ = run["circuits"][kind]
    for out in run["outs"]:
        assert out["sharded_qap", kind]
        assert len(out["nA_local", kind]) == 1
        check_proof(vk, pb, Proof(*out["proof", kind]),
                    run["jax_proofs"][kind])


def test_drawn_r_s_and_blinds_equal_on_every_rank(run):
    """r, s and the blinds' scalars drawn by the Prover are rank 0's, so
    both ranks return the same proof, and it verifies."""
    pb, _, vk, _ = run["circuits"]["basic"]
    a, b = (out["drawn"] for out in run["outs"])
    assert a == b
    assert verifier.verify(vk, pb.primary_input(), Proof(*a))
    assert a != run["outs"][0]["proof", "basic"]


def test_torchrun_launch(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2` (torchrun)
    starts two processes whose initialize() joins the store its agent
    already serves at MASTER_PORT: both join one gloo group, list both
    ranks' devices in order, and sum over it."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import sys; sys.path[:0] = [sys.argv[2], sys.argv[3]]\n"
        "import test_torch_process_mesh as t; t._torchrun_main(sys.argv[1])\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    with open(tmp_path / "torchrun.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(RANKS), "--max-restarts", "0",
             "--master-addr", "127.0.0.1", "--master-port",
             str(_free_port()), str(script), str(tmp_path), TESTS, ROOT],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env={**env, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
        try:
            proc.communicate(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, (tmp_path / "torchrun.log").read_text()
    for r in range(RANKS):
        with open(tmp_path / f"torchrun{r}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out["rank"] == r and out["backend"] == "gloo"
        assert out["devices"] == ["cpu"] * RANKS
        assert out["agent_store"] == "True"
        got = out["field_sum"].view(np.uint32)
        assert tf.from_mont_host(FR, got[None])[0] == 36


# ---------------------------------------------------------------------------
# No ranks needed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement,backend", [
    (["h cuda:0", "h cuda:1", "h cuda:2", "h cuda:3"], "nccl"),
    (["h cuda:0", "h cuda:0"], "gloo"),
    (["h cpu", "h cpu"], "gloo"),
    (["a cuda:0", "b cuda:0"], "nccl"),
    (["h cuda:0", "h cpu"], "gloo")],
    ids=["4-cards", "shared-card", "cpu", "2-hosts", "mixed"])
def test_choose_backend(placement, backend):
    assert distributed.choose_backend(placement) == backend


@pytest.mark.parametrize("hosts,local", [
    (["a", "a", "b", "b"], [0, 1, 0, 1]),
    (["a", "b", "a", "b"], [0, 0, 1, 1]),
    (["a"], [0])], ids=["blocks", "interleaved", "one"])
def test_local_indices(hosts, local):
    """Without LOCAL_RANK a process's card is the number of lower ranks on
    its own host, not its global rank (a second one-card host takes
    cuda:0)."""
    assert distributed.local_indices(hosts) == local


def test_exchange_through_store():
    """The hostname exchange initialize runs without LOCAL_RANK: every
    process's value in rank order, through the rendezvous store."""
    store = torch.distributed.TCPStore("127.0.0.1", _free_port(), 1,
                                       is_master=True)
    assert distributed._exchange(store, "host", "h0", 1, 0) == ["h0"]


def test_initialize_without_a_card_raises(monkeypatch):
    """Two processes and no visible card: initialize raises unless the
    caller asks for the CPU, before it opens any store."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            distributed.initialize("127.0.0.1:1", 2, 1, device=dev)
    assert not torch.distributed.is_initialized()


def test_save_device_pk_is_atomic(tmp_path, monkeypatch):
    """While the npz is written the target does not exist (a reader sees
    no key or the whole key); after, it loads equal; a failed write
    leaves neither the target nor a temporary file."""
    pb = chain_circuit(30)
    toxic = iter([11, 13, 17, 19, 23])
    dpk = keys.build_device_pk(jgen.generate(pb, rng=lambda: next(toxic))[0])
    path = str(tmp_path / "k.v1.npz")
    seen = []
    savez = np.savez

    def watched(f, **data):
        seen.append(os.path.exists(path))
        savez(f, **data)

    monkeypatch.setattr(np, "savez", watched)
    keys.save_device_pk(dpk, path)
    assert seen == [False]
    back = keys.load_device_pk(path)
    assert all(np.array_equal(a, b) for a, b in zip(back.A, dpk.A))
    assert os.listdir(tmp_path) == ["k.v1.npz"]

    def broken(f, **data):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError):
        keys.save_device_pk(dpk, str(tmp_path / "b.v1.npz"))
    assert os.listdir(tmp_path) == ["k.v1.npz"]


def test_build_lock_one_compile(tmp_path, monkeypatch):
    """Four threads call build() on a fresh build directory at once: one
    compiles under the lock, the others wait and return its library."""
    monkeypatch.setattr(kn, "BUILD", str(tmp_path))
    calls = []

    def compile_(srcs, lib, verbose):
        calls.append(lib)
        time.sleep(0.5)
        with open(lib, "w") as f:
            f.write("lib")

    monkeypatch.setattr(kn, "_compile", compile_)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(kn.build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(set(libs)) == 1 and len(libs) == 4
    assert os.path.exists(libs[0])
