"""Several torch devices as one mesh, and the MSM sharded over it.

Port of blockmaze_tpu/parallel/mesh.py. The JAX package is one process
over a jax Mesh, its collectives shard_map's (all_gather, psum). The
port's counterpart is a Mesh of torch devices in one process, its
collectives explicit copies: Tensor.to(device) (peer to peer between
cards; PyTorch orders a copy between two cards after the work queued on
both cards' current streams) with torch.cat and slicing. A shard's
kernels launch on its own card (utils/kernels.py), so the cards of a mesh
work at once while this thread queues their launches.

A mesh may name one device more than once: the tests run 8 shards on the
CPU, as the JAX tests run 8 virtual devices, and a one-card machine can
run 4 shards on that card. make_mesh never repeats a card; a repeated one
comes only from an explicit device list. Data never moves in place: a
copy onto its own device is the same tensor (Tensor.to returns it), so a
shard that writes into its input would write into its neighbour's too.

  axis "pts": MSM (point, scalar) pairs in equal contiguous blocks, one
              per shard; each shard runs the whole single-card MSM on its
              block, and the partials (one Jacobian point each) are
              gathered to the lead device and folded with the point add
              kernel (csrc/pcurve.cu, K3).
"""

from __future__ import annotations

import torch

from ..curves import pcurve as pc
from ..fields import tfield as tf
from ..groth16 import qap
from ..groth16.keys import LONG_ROW, MatrixCSR
from ..msm import pippenger as pp

FR = tf.FR


class Mesh:
    """An ordered list of torch devices, the first the lead device, where
    a sharded result is gathered. axis_names mirrors the jax Mesh's."""

    def __init__(self, devices, axis: str = "pts"):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"mesh mixes device kinds: {devs}")
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    def blocks(self, n: int):
        """(start, stop) of each shard's block of n rows, n / size each."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over "
                             f"{self.size} shards")
        b = n // self.size
        return [(d * b, (d + 1) * b) for d in range(self.size)]

    def scatter(self, t):
        """t's rows in equal contiguous blocks, block d on device d."""
        return [t[a:b].to(dev) for (a, b), dev in
                zip(self.blocks(t.shape[0]), self.devices)]

    def shard_points(self, points):
        """Affine points (X, Y, inf) as one (X, Y, inf) block per shard."""
        return [tuple(parts) for parts in
                zip(*(self.scatter(t) for t in points))]


def make_mesh(n_devices: int | None = None, axis: str = "pts") -> Mesh:
    """A mesh of the first n_devices cards (all visible cards by default);
    raises if fewer are visible."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}): {count} cards visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def sharded_msm(mesh: Mesh, curve: str, points, scalars, c: int = 13,
                lanes: int = 1024, blind=None):
    """MSM with (point, scalar) pairs sharded over the mesh, as
    pippenger.msm returns it: (X, Y, Z) on the lead device; with a
    blind, (X, Y, Z, wts) with wts the (size, W) int64 window counts of
    the shards, stacked for unblind_msm to sum.

    points: (X, Y, inf) of n rows, cut here, or mesh.shard_points of them
    (already on their devices); scalars (n, 16), cut here. Every shard
    starts from the same blind. The live counts, the one value each MSM
    reads to the host, are read once for all shards after every shard's
    window keys are queued, so no shard's read holds back another card's
    launches; the accumulation, reduction and fold are then queued shard
    after shard, and the n partials folded on the lead device by n - 1
    point add launches."""
    shards = (mesh.shard_points(points) if torch.is_tensor(points[0])
              else list(points))
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} point shards on a mesh of "
                         f"{mesh.size}")
    scal = mesh.scatter(scalars)
    blinds = ([tuple(b.to(d) for b in blind) for d in mesh.devices]
              if blind is not None else [None] * mesh.size)
    staged = [pp.window_keys(p, s, c) for p, s in zip(shards, scal)]
    counts = torch.stack([live.sum().to(mesh.lead)
                          for _, live, _ in staged]).tolist()
    parts = [pp.msm_stream(curve, p, pp.sort_live(keys, live, n) + (drop,),
                           c, lanes, b)
             for p, (keys, live, drop), n, b in zip(shards, staged, counts,
                                                    blinds)]
    res = tuple(t.to(mesh.lead) for t in parts[0][:3])
    for part in parts[1:]:
        res = pc.add(curve, res, tuple(t.to(mesh.lead) for t in part[:3]))
    if blind is None:
        return res
    return res + (torch.stack([part[3].to(mesh.lead) for part in parts]),)


def field_sum(terms_mont):
    """sum_i terms_i of an (n, 16) Montgomery tensor, (1, 16): a CSR of one
    row of n terms of coefficient Montgomery one through qap_matvec (x *
    (R mod r) * R^-1 = x), on the terms' device."""
    n, dev = terms_mont.shape[0], terms_mont.device
    coeff = tf.to_tensor(FR.one_mont, dev).expand(n, tf.N).contiguous()
    csr = MatrixCSR(
        ptr=torch.tensor([0, n], dtype=torch.int32, device=dev),
        var=torch.arange(n, dtype=torch.int32, device=dev), coeff=coeff,
        long_rows=torch.tensor([0] if n > LONG_ROW else [],
                               dtype=torch.int32, device=dev))
    return qap.qap_matvec(csr, terms_mont.contiguous())


def sharded_field_inner_sum(mesh: Mesh, terms_mont):
    """sum_i terms_i over a sharded axis, (16,) Montgomery on the lead
    device: each shard sums its block (field_sum), the partials are
    gathered and summed once more. The JAX package sums 16-bit limbs
    lazily and psums them; the card's 8 x 32-bit limbs have no headroom
    for that, so every sum is a field sum."""
    local = [field_sum(t) for t in mesh.scatter(terms_mont)]
    return field_sum(torch.cat([t.to(mesh.lead) for t in local]))[0]
