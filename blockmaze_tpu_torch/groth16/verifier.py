"""Groth16 verifier (host-side exact arithmetic).

Mirrors r1cs_gg_ppzksnark_online_verifier_strong_IC
(r1cs_gg_ppzksnark.tcc:509-621): accumulate the public input against
gamma_ABC, then check

    e(A, B) == alpha_g1_beta_g2 * e(acc, gamma_g2) * e(C, delta_g2)

computed the same way as the reference: one Miller loop for (A,B), one
double Miller loop for (acc,gamma),(C,delta), conjugated, one final
exponentiation, compared against the vk's precomputed GT element.
"""

from __future__ import annotations

from typing import List

from ..curves import host_curve as HC
from ..curves import pairing as P
from ..fields import host as F
from ..serialization.libsnark_io import Proof, VerificationKey


def accumulate_input(vk: VerificationKey, primary: List[int]):
    """acc = first + sum_i primary[i] * rest[i] (accumulation_vector
    accumulate_chunk with offset 0).

    The input may be SHORTER than the vk's accumulation domain (weak IC:
    r1cs_gg_ppzksnark.tcc:533 accumulates only primary_input.size() terms)
    but never longer — the reference asserts domain >= input size."""
    if len(primary) > vk.gamma_ABC_domain:
        raise ValueError(
            f"primary input length {len(primary)} exceeds the vk's "
            f"accumulation domain {vk.gamma_ABC_domain}")
    acc = (vk.gamma_ABC_first[0], vk.gamma_ABC_first[1], vk.gamma_ABC_first[2])
    for idx, point in vk.gamma_ABC_rest:
        if idx < len(primary):
            acc = HC.g1_add(acc, HC.g1_mul(point, primary[idx]))
    return acc


def verify(vk: VerificationKey, primary: List[int], proof: Proof,
           strong: bool = True) -> bool:
    if strong and vk.gamma_ABC_domain != len(primary):
        return False

    # well-formedness
    if not (HC.g1_is_on_curve(proof.a) and HC.g2_is_on_curve(proof.b)
            and HC.g1_is_on_curve(proof.c)):
        return False

    acc = accumulate_input(vk, primary)

    qap1 = P.miller_loop(proof.a, P.precompute_g2(proof.b))
    qap2 = P.double_miller_loop(
        acc, P.precompute_g2(vk.gamma_g2),
        proof.c, P.precompute_g2(vk.delta_g2))
    qap = P.final_exponentiation(F.fq12_mul(qap1, F.fq12_conj(qap2)))
    return qap == vk.alpha_g1_beta_g2
