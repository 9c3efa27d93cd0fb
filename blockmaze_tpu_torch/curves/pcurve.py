"""Batched point kernels over G1 and G2 (csrc/pcurve.cu), each beside its
plain torch version (curves/tcurve.py).

Port of blockmaze_tpu/curves/pcurve.py: `add`, `double`, `mixed_add` and
`mixed_add_noexc`, same semantics as the jcurve functions they wrap. curve
is "g1" (coordinates (..., 16)) or "g2" ((..., 2, 16)); points are
(X, Y, Z) Jacobian tuples, Qx/Qy affine with a bool infinity mask. A
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; outputs are int32 with the input's batch shape.
"""

from __future__ import annotations

import torch

from ..utils import kernels as kn
from . import tcurve as tc


def _i32(P):
    return tuple(t.to(torch.int32) for t in P)


def _prep(curve, name, coords, masks=()):
    """Validate shapes, flatten the batch; return (batch_shape, n, flat
    coordinate tensors, flat uint8 masks)."""
    tail = tc.coord_tail(curve)
    batch = coords[0].shape[:coords[0].dim() - len(tail)]
    for t in coords:
        if t.shape != batch + tail:
            raise ValueError(f"{name}: coordinate shape {tuple(t.shape)} != "
                             f"{tuple(batch + tail)}")
    n = 1
    for d in batch:
        n *= d
    flat = [t.reshape((n,) + tail).contiguous() for t in coords]
    ms = [m.reshape(n).to(torch.uint8).contiguous() for m in masks]
    kn.check_cuda(name, *flat, *ms)
    return batch, n, flat, ms


def _outs(curve, batch, like, n):
    tail = tc.coord_tail(curve)
    return tuple(torch.empty((n,) + tail, dtype=torch.int32,
                             device=like.device) for _ in range(3)), batch + tail


def add(curve: str, P, Q):
    """jcurve.point_add."""
    if kn.on_cpu(*P, *Q):
        return _i32(tc.point_add(tc.ops(curve), P, Q))
    batch, n, flat, _ = _prep(curve, "add", list(P) + list(Q))
    out, shape = _outs(curve, batch, flat[0], n)
    kn.K["add"](kn.CURVE_ID[curve], *out, *flat, n)
    return tuple(o.reshape(shape) for o in out)


def double(curve: str, P):
    """jcurve.point_double."""
    if kn.on_cpu(*P):
        return _i32(tc.point_double(tc.ops(curve), P))
    batch, n, flat, _ = _prep(curve, "double", list(P))
    out, shape = _outs(curve, batch, flat[0], n)
    kn.K["double"](kn.CURVE_ID[curve], *out, *flat, n)
    return tuple(o.reshape(shape) for o in out)


def _mixed(name, exc, curve, P, Qx, Qy, q_inf):
    batch, n, flat, ms = _prep(curve, name, list(P) + [Qx, Qy], [q_inf])
    out, shape = _outs(curve, batch, flat[0], n)
    kn.K[name](kn.CURVE_ID[curve], exc, *out, *flat, ms[0], n)
    return tuple(o.reshape(shape) for o in out)


def mixed_add(curve: str, P, Qx, Qy, q_inf):
    """jcurve.point_mixed_add (Jacobian + affine, every exceptional case)."""
    if kn.on_cpu(*P, Qx, Qy, q_inf):
        return _i32(tc.point_mixed_add(tc.ops(curve), P, Qx, Qy, q_inf))
    return _mixed("mixed_add", 1, curve, P, Qx, Qy, q_inf)


def mixed_add_noexc(curve: str, P, Qx, Qy, q_inf):
    """jcurve.point_mixed_add_noexc (exact when P is neither infinity nor
    +-Q)."""
    if kn.on_cpu(*P, Qx, Qy, q_inf):
        return _i32(tc.point_mixed_add_noexc(tc.ops(curve), P, Qx, Qy,
                                             q_inf))
    return _mixed("mixed_add_noexc", 0, curve, P, Qx, Qy, q_inf)
