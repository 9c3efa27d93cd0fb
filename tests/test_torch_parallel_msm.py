"""blockmaze_tpu_torch's mesh layer (parallel/mesh.py, parallel/distributed.py)
on CPU shards: sharded_msm over 8 shards against the host oracle and the
JAX package's sharded_msm on the conftest's 8 virtual devices, blinded and
unblinded, in G1 and G2; unblind_msm on stacked (k, W) window counts
against the JAX package's; the sharded field sum; the mesh's placement and
its device checks; the process group of two CPU processes. Inputs are
made from seeded random.Random; every comparison is exact."""

import os
import random
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.curves import jcurve as JC
from blockmaze_tpu.msm import pippenger as jpp
from blockmaze_tpu.parallel import mesh as jmesh
from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.parallel import distributed
from blockmaze_tpu_torch.parallel import mesh as pm
from blockmaze_tpu_torch.utils import kernels as kn

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

C, LANES, SHARDS = 8, 4, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _curve(curve):
    """The curve's host ops and conversions: (G, mul, add, neg, zero,
    to device, to host, the JAX package's to device and to host)."""
    if curve == "g1":
        return (HC.g1_generator(), HC.g1_mul, HC.g1_add, HC.g1_neg,
                HC.G1_ZERO, tc.g1_affine_to_device, tc.g1_jacobian_to_host,
                JC.g1_affine_to_device, JC.g1_jacobian_to_host)
    return (HC.g2_generator(), HC.g2_mul, HC.g2_add, HC.g2_neg, HC.G2_ZERO,
            tc.g2_affine_to_device, tc.g2_jacobian_to_host,
            JC.g2_affine_to_device, JC.g2_jacobian_to_host)


def _instance(curve, seed, per_shard, live_shards):
    """SHARDS * per_shard random points, an infinity point among them in
    G1, with random scalars on the first live_shards shards (the first
    two 0 and 1) and zero scalars on the others (shards with no live
    item). Returns (host points, scalars, port points, port scalars)."""
    g, mul, _, _, zero, to_dev = _curve(curve)[:6]
    r = random.Random(seed)
    n = SHARDS * per_shard
    pts = [mul(g, r.randrange(1, R_MOD)) for _ in range(n)]
    if curve == "g1":
        pts[2] = zero
    sc = [r.randrange(R_MOD) if i < live_shards * per_shard else 0
          for i in range(n)]
    sc[0], sc[1] = 0, 1
    X, Y, inf = to_dev(pts)
    P = (tf.to_tensor(X, "cpu"), tf.to_tensor(Y, "cpu"),
         torch.from_numpy(inf))
    return pts, sc, P, tf.to_tensor(tf.ints_to_limbs(sc), "cpu")


def _host_msm(curve, pts, sc):
    _, mul, add, _, zero = _curve(curve)[:5]
    acc = zero
    for p, k in zip(pts, sc):
        acc = add(acc, mul(p, k))
    return acc


@pytest.fixture(scope="module")
def jax_mesh8():
    return jmesh.make_mesh(8)


@pytest.mark.parametrize("curve,live_shards,blind", [
    ("g1", SHARDS, False), ("g1", 4, True), ("g2", 2, False),
    ("g2", 2, True)])
def test_sharded_msm_8_shards(jax_mesh8, curve, live_shards, blind):
    """The port's sharded_msm over 8 CPU shards, some shards with no live
    item where live_shards < 8, equals the host oracle; blinded, its
    (8, W) window counts unblind to that point; unblinded, it equals the
    JAX package's sharded_msm too (whose blinded branch on the CPU is the
    same compact kernel, pinned by its own tests)."""
    per_shard = 4 if curve == "g1" else 2
    pts, sc, P, S = _instance(curve, 17 + live_shards, per_shard,
                              live_shards)
    mesh = pm.Mesh(["cpu"] * SHARDS)
    to_host, jax_to_dev, jax_to_host = _curve(curve)[6:]
    if blind:
        R, bl = pp.make_blind(curve, "cpu")
        res = pm.sharded_msm(mesh, curve, P, S, c=C, lanes=LANES, blind=bl)
        assert res[3].shape == (SHARDS, pp.n_windows(C))
        got = pp.unblind_msm(curve, to_host(tuple(r[None] for r in res[:3]))
                             [0], res[3].numpy(), R, C)
    else:
        res = pm.sharded_msm(mesh, curve, P, S, c=C, lanes=LANES)
        got = to_host(tuple(r[None] for r in res))[0]
        jres = jmesh.sharded_msm(
            jax_mesh8, curve, tuple(jnp.asarray(t) for t in jax_to_dev(pts)),
            jnp.asarray(jpp.scalars_to_device(sc)), c=C, lanes=LANES)
        assert jax_to_host(tuple(np.asarray(r)[None] for r in jres))[0] == \
            got
    assert got == _host_msm(curve, pts, sc)


def test_sharded_msm_takes_placed_shards():
    """Points already placed (mesh.shard_points, as the Prover holds them)
    give the same result as points cut by sharded_msm; a shard count other
    than the mesh's raises."""
    pts, sc, P, S = _instance("g1", 5, 1, 2)
    mesh = pm.Mesh(["cpu"] * 2)
    placed = mesh.shard_points(tuple(t[:2] for t in P))
    res = pm.sharded_msm(mesh, "g1", placed, S[:2], c=C, lanes=LANES)
    assert tc.g1_jacobian_to_host(tuple(r[None] for r in res))[0] == \
        _host_msm("g1", pts[:2], sc[:2])
    with pytest.raises(ValueError):
        pm.sharded_msm(mesh, "g1", placed[:1], S[:2], c=C, lanes=LANES)


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("rows", [1, 8], ids=["W", "stacked"])
def test_unblind_msm_matches_jax(curve, rows):
    """unblind_msm on (W,) and on (8, W) window counts (a sharded MSM's,
    stacked) equals the JAX package's, which sums each window's column."""
    g, mul, add, neg = _curve(curve)[:4]
    r = np.random.default_rng(rows)
    W = pp.n_windows(C)
    wts = r.integers(0, 1 << 20, (rows, W), dtype=np.int64)
    wts = wts[0] if rows == 1 else wts
    P, R = mul(g, 5), mul(g, 7)
    got = pp.unblind_msm(curve, P, wts, R, C)
    assert got == jpp.unblind_msm(curve, P, wts, R, C)
    total = sum(int(x) << (C * i) for i, x in
                enumerate(np.asarray(wts).reshape(-1, W).sum(0))) % R_MOD
    assert got == add(P, neg(mul(R, total)))


def test_sharded_field_inner_sum(jax_mesh8):
    r = random.Random(9)
    vals = [r.randrange(R_MOD) for _ in range(64)]
    host = tf.to_mont_host(tf.FR, vals)
    mesh = pm.Mesh(["cpu"] * SHARDS)
    tot = pm.sharded_field_inner_sum(mesh, tf.to_tensor(host, "cpu"))
    assert tf.from_mont_host(tf.FR, tot.numpy()[None])[0] == \
        sum(vals) % R_MOD
    want = jmesh.sharded_field_inner_sum(jax_mesh8, jnp.asarray(host))
    assert np.array_equal(tot.numpy().astype(np.uint32), np.asarray(want))
    # one shard of more than LONG_ROW terms (a warp row on the card)
    one = pm.sharded_field_inner_sum(pm.Mesh(["cpu"]),
                                     tf.to_tensor(host, "cpu"))
    assert torch.equal(one, tot)


def test_mesh_placement():
    mesh = pm.Mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.lead == torch.device("cpu")
    assert mesh.axis_names == ("pts",)
    assert mesh.blocks(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    t = torch.arange(8)
    assert [p.tolist() for p in mesh.scatter(t)] == [[0, 1], [2, 3], [4, 5],
                                                     [6, 7]]
    with pytest.raises(ValueError):
        mesh.blocks(6)
    with pytest.raises(ValueError):
        pm.Mesh([])
    with pytest.raises(ValueError):
        pm.Mesh(["cpu", "meta"])
    # make_mesh takes cards only, and never more than are visible
    with pytest.raises(ValueError):
        pm.make_mesh(torch.cuda.device_count() + 1)


def test_kernel_checks_reject_two_cards():
    """A kernel's tensors must lie on one card: on_cpu and check_cuda raise
    on two (stand-ins with a .device are enough: both look at it first)."""
    a, b = (SimpleNamespace(device=torch.device("cuda", i)) for i in (0, 1))
    assert kn.on_cpu(torch.zeros(1), torch.zeros(1))
    assert not kn.on_cpu(a, a)
    for fn in (kn.on_cpu, lambda *t: kn.check_cuda("k", *t)):
        with pytest.raises(ValueError):
            fn(a, b)
    with pytest.raises(ValueError):
        kn.on_cpu(a, torch.zeros(1))


def test_initialize_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize("127.0.0.1:1", 1, 0) is False


def test_initialize_two_processes():
    """Two processes join one gloo group on this host through initialize
    (arguments from the launcher's variables) and sum a tensor."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from blockmaze_tpu_torch.parallel import distributed
        assert distributed.initialize(device="cpu")
        assert distributed.initialize(device="cpu")
        t = torch.tensor([dist.get_rank() + 1])
        dist.all_reduce(t)
        print(int(t))
        dist.destroy_process_group()
    """)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT,
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "WORLD_SIZE": "2", "RANK": str(r)})
        for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert [o.strip() for o in outs] == ["3", "3"]
