"""Synthetic example circuits (tests, dryruns, scaling probes).

The reference's analogue is the hardcoded-instance standalone binaries
(src/*/main.cpp); these are parameter-sized so harnesses can dial the
constraint count to hit a target evaluation-domain shape.
"""

from ..fields.constants import R_MOD
from .protoboard import LC, Protoboard


def chain_circuit(ncons: int, w0: int = 3) -> Protoboard:
    """Public x, witness chain w_{i+1} = w_i^2; last constraint w_k*1 = x.
    ncons constraints, ncons+1 variables; domain size = ncons + 2."""
    pb = Protoboard()
    vx = pb.allocate()
    pb.set_input_sizes(1)
    vals = [w0]
    vprev = pb.allocate()
    pb.setval(vprev, w0)
    for _ in range(ncons - 1):
        vnext = pb.allocate()
        nxt = vals[-1] * vals[-1] % R_MOD
        pb.add_constraint(LC.var(vprev), LC.var(vprev), LC.var(vnext))
        pb.setval(vnext, nxt)
        vals.append(nxt)
        vprev = vnext
    pb.add_constraint(LC.var(vprev), LC.of(1), LC.var(vx))
    pb.setval(vx, vals[-1])
    assert pb.is_satisfied()
    return pb
