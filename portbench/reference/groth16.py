"""The benchmark's judge of Groth16 proofs over BN254, in plain Python.

The deployment's key is worked out here from what the deployment states:
the set-up seed, from which the trusted setup draws its toxic waste (t,
alpha, beta, gamma, delta, in that order, each random.Random(seed)
.randrange(1, r)), and the input commitments gamma_ABC of its verification
key, which the configuration file carries. Every other part of the key
follows from the toxic waste alone, so it is recomputed here. A proof is
accepted when e(A, B) = e(alpha, beta) e(acc, gamma) e(C, delta), acc the
statement's commitment, as libsnark's strong-IC verifier checks it.

Imports nothing of the program: the program's outputs come in as plain
integers and tuples.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from . import bn254 as B


def toxic_waste(setup_seed: int):
    """(t, alpha, beta, gamma, delta) of the trusted setup of this seed."""
    rnd = random.Random(setup_seed)
    return tuple(rnd.randrange(1, B.R_MOD) for _ in range(5))


@dataclass
class Key:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    gamma_g2: tuple
    alpha_beta: tuple
    ic: list
    gamma_pre: list
    delta_pre: list


def deployment_key(setup_seed: int, ic_xy) -> Key:
    """The deployment's key: its group constants from the set-up seed's
    toxic waste, its input commitments ic_xy ([x, y] pairs, gamma_ABC's
    first point, then one per public input) as stated."""
    _, alpha, beta, gamma, delta = toxic_waste(setup_seed)
    g1, g2 = B.g1_generator(), B.g2_generator()
    alpha_g1, beta_g2 = B.g1_mul(g1, alpha), B.g2_mul(g2, beta)
    gamma_g2, delta_g2 = B.g2_mul(g2, gamma), B.g2_mul(g2, delta)
    ic = [(int(x), int(y), 0) for x, y in ic_xy]
    return Key(alpha_g1, B.g1_mul(g1, beta), beta_g2, B.g1_mul(g1, delta),
               delta_g2, gamma_g2, B.pairing(alpha_g1, beta_g2), ic,
               B.precompute_g2(gamma_g2), B.precompute_g2(delta_g2))


def key_differences(key: Key, program: dict) -> list:
    """The parts of the program's key that differ from the deployment's.
    program: {"alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"} of
    its proving key, {"gamma_g2", "delta_g2_vk", "alpha_beta", "ic"} of its
    verification key, as plain tuples."""
    want = {"alpha_g1": key.alpha_g1, "beta_g1": key.beta_g1,
            "beta_g2": key.beta_g2, "delta_g1": key.delta_g1,
            "delta_g2": key.delta_g2, "gamma_g2": key.gamma_g2,
            "delta_g2_vk": key.delta_g2, "alpha_beta": key.alpha_beta,
            "ic": key.ic}
    return [k for k, v in want.items() if _plain(program.get(k)) != _plain(v)]


def _plain(v):
    """Nested lists and tuples as tuples of ints, to compare."""
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v if v is None else int(v)


def accumulate(key: Key, statement) -> tuple:
    """ic[0] + sum_i statement[i] * ic[i + 1]."""
    acc = key.ic[0]
    for x, p in zip(statement, key.ic[1:]):
        acc = B.g1_add(acc, B.g1_mul(p, x))
    return acc


def verify(key: Key, statement, proof) -> bool:
    """Whether proof = (A, B, C) proves `statement` (a list of field
    elements) under the key."""
    a, b, c = proof
    if len(statement) != len(key.ic) - 1:
        return False
    if not (B.g1_is_on_curve(a) and B.g2_is_on_curve(b)
            and B.g1_is_on_curve(c)):
        return False
    f1 = B.miller_loop(a, B.precompute_g2(b))
    f2 = B.double_miller_loop(accumulate(key, statement), key.gamma_pre, c,
                              key.delta_pre)
    return B.final_exponentiation(
        B.fq12_mul(f1, B.fq12_conj(f2))) == key.alpha_beta


def blinded_as_drawn(key: Key, first, r0: int, s0: int, proof, r: int,
                     s: int) -> bool:
    """Whether two proofs of one witness differ by their draws as Groth16's
    zero-knowledge blinding makes them: A - A0 = (r - r0) delta in G1 and
    B - B0 = (s - s0) delta in G2."""
    a0, b0, _ = first
    a, b, _ = proof
    da = B.g1_mul(key.delta_g1, (r - r0) % B.R_MOD)
    db = B.g2_mul(key.delta_g2, (s - s0) % B.R_MOD)
    return (_plain(B.g1_add(a0, da)) == _plain(a)
            and _plain(B.g2_add(b0, db)) == _plain(b))


def proof_from_wire(hex_str: str):
    """A proof from the transaction's wire encoding (mintcgo.cpp:176-187):
    A.x, A.y, B.x.c1, B.x.c0, B.y.c1, B.y.c0, C.x, C.y as 64 hex digits
    each, big-endian."""
    if len(hex_str) != 512:
        raise ValueError(f"a proof is 512 hex digits, not {len(hex_str)}")
    ax, ay, bx1, bx0, by1, by0, cx, cy = (
        int(hex_str[i:i + 64], 16) for i in range(0, 512, 64))
    return (ax, ay, 0), ((bx0, bx1), (by0, by1), 0), (cx, cy, 0)
