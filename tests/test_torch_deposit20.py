"""The deposit20 deployment of the port's benchmark (portbench/configs/
deposit20.*) on the CPU: the port's depth-20 public input against the
plain reference's statement, and the Pippenger window c = 13 it proves
at against c = 12 on a toy circuit, judged by the reference verifier."""

import json
import os
import subprocess
import sys
import textwrap

import torch

from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.groth16 import generator
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.r1cs.examples import chain_circuit
from portbench import loops, spec
from portbench.reference import bn254 as B
from portbench.reference import groth16 as G

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "portbench", "configs")


def config():
    return spec.read_json(os.path.join(CONFIGS, "deposit20.json"))


def test_public_input_is_the_references_statement_at_depth_20():
    """Two transactions of the cell's stream: the port's witness at depth
    20 states what the reference works out, root included; another tree,
    or the depth-8 root, states something else."""
    cfg = config()
    assert cfg["merkle_depth"] == 20
    ref = spec.load_module(os.path.join(CONFIGS, "deposit20_ref.py"))
    prog = spec.load_module(os.path.join(CONFIGS, "deposit20.py"))
    rng = loops.stream(2**31 + 5, "pool")
    for tx in (ref.transaction(rng), ref.transaction(rng)):
        primary, aux = prog.witness(tx, cfg)
        assert len(primary) == cfg["public_inputs"]
        assert len(primary) + len(aux) == cfg["variables"]
        assert primary == ref.statement(tx, cfg)
        other = dict(tx, leaves=[bytes(32)] + tx["leaves"][1:])
        assert primary != ref.statement(other, cfg)
        assert primary != ref.statement(tx, {"merkle_depth": 8})


def test_deposit20_reference_imports_nothing_of_jax_or_the_port():
    code = textwrap.dedent(f"""
        import json, random, sys
        sys.path.insert(0, {ROOT!r})
        from portbench import spec
        ref = spec.load_module({CONFIGS!r} + "/deposit20_ref.py")
        ref.statement(ref.transaction(random.Random(1)),
                      {{"merkle_depth": 20}})
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    modules = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not modules & {"jax", "jaxlib", "flax", "blockmaze_tpu",
                          "blockmaze_tpu_torch", "torch"}


def host_triangle(curve, bkt, W: int, nb: int):
    """pippenger.triangle's window sums win_w = sum_{d>=1} d * S_{w,d},
    summed on the host over the buckets that hold a point and returned as
    Jacobian tensors (Z = 1; infinity as pippenger's (0, 1, 0)). The plain
    triangle walks all W * 2^c slots, minutes at c = 13 on one CPU thread;
    chip_smoke.py holds the kernel to it at deposit20's c = 13 shape."""
    g1 = curve == "g1"
    to_host = tc.g1_jacobian_to_host if g1 else tc.g2_jacobian_to_host
    add, mul = (HC.g1_add, HC.g1_mul) if g1 else (HC.g2_add, HC.g2_mul)
    zeros = pp._zeros_pts(curve, W, bkt[0].device)
    win = to_host(tuple(t[:1] for t in zeros)) * W
    used = torch.nonzero((bkt[2].reshape(W * nb, -1) != 0).any(1))
    used = used.squeeze(1).tolist()
    for i, p in zip(used, to_host(tuple(t[used] for t in bkt))):
        w, d = divmod(i, nb)
        if d:
            win[w] = add(win[w], mul(p, d))
    xs, ys, inf = (tc.g1_affine_to_device if g1 else
                   tc.g2_affine_to_device)(win)
    F = tc.ops(curve)
    inf = torch.as_tensor(inf)
    affine = (tf.to_tensor(xs, "cpu"), tf.to_tensor(ys, "cpu"), zeros[1])
    return tuple(F.select(inf, z, a).to(torch.int32)
                 for z, a in zip(zeros, affine))


def test_window_13_proves_as_window_12(tmp_path, monkeypatch):
    """Prover(window=13), deposit20's window (pippenger.default_window of
    its 763,859 variables), and Prover(window=12) give one proof at one
    (r, s): digits, W, buckets, blind counts, fold and unblinding at each
    window (the window sums on the host, host_triangle); the reference
    verifier accepts it for its statement and rejects it for another."""
    assert pp.default_window(config()["variables"]) == 13
    monkeypatch.setattr(pp, "triangle", host_triangle)
    seed = 7
    dpk, vk, _ = generator.generate_cached(chain_circuit(12, 3), "chain",
                                           seed, str(tmp_path), "cpu")
    ic = [vk.gamma_ABC_first] + [p for _, p in sorted(vk.gamma_ABC_rest)]
    key = G.deployment_key(seed, [[p[0], p[1]] for p in ic])
    pb = chain_circuit(12, 5)
    inst = (pb.primary_input(), pb.auxiliary_input())
    proofs = []
    for c in (13, 12):
        prover = Prover(dpk, "cpu", window=c)
        assert prover.window == c
        p = prover.prove(*inst, r=3, s=4)
        proofs.append((p.a, p.b, p.c))
    assert proofs[0] == proofs[1]
    assert G.verify(key, inst[0], proofs[0]) is True
    bad = [(inst[0][0] + 1) % B.R_MOD]
    assert G.verify(key, bad, proofs[0]) is False
