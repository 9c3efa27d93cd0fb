"""Several torch devices as one mesh, and the MSM sharded over it.

Port of blockmaze_tpu/parallel/mesh.py. The JAX package runs one program
over a jax Mesh whose collectives are shard_map's (all_gather, psum), in
one process or, after jax.distributed, in one process per host. The port
has two meshes with one surface:

  Mesh         torch devices in one process. A collective is explicit
               copies: Tensor.to(device) (peer to peer between cards;
               PyTorch orders a copy between two cards after the work
               queued on both cards' current streams) with torch.cat and
               slicing. This thread queues every shard's work, each
               shard's kernels on its own card (utils/kernels.py).
  ProcessMesh  one shard per process of a torch.distributed group
               (distributed.initialize), each process driving its own
               device. Every process calls the same function with the
               same host inputs, computes its own shard and ends up with
               the same replicated result; a collective is a
               torch.distributed call (all_gather, all_to_all_single,
               broadcast_object_list). nccl orders a collective after the
               work queued on the tensors' current stream, and the
               kernels after it; gloo moves host tensors, so a card's
               tensors go through the host around it.

The code over a mesh (sharded_msm, sntt, sqap, the Prover) is one path for
both: it computes the shards in mesh.shards (every shard in a Mesh, this
process's in a ProcessMesh) on mesh.local_devices, and moves data only
through the mesh's collective methods (gather, gather_rows, all_to_all,
broadcast). Results land on mesh.lead: a Mesh's first device, a
ProcessMesh's own device.

A mesh may name one device more than once: the tests run 8 shards on the
CPU, as the JAX tests run 8 virtual devices, and a one-card machine can
run 4 shards (or 2 processes) on that card. make_mesh never repeats a
card; a repeated one comes only from an explicit device list or
placement. Data never moves in place: a copy onto its own device is the
same tensor (Tensor.to returns it), so a shard that writes into its input
would write into its neighbour's too.

  axis "pts": MSM (point, scalar) pairs in equal contiguous blocks, one
              per shard; each shard runs the whole single-card MSM on its
              block, and the partials (one Jacobian point each) are
              gathered and folded in shard order with the point add
              kernel (csrc/pcurve.cu, K3).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..curves import pcurve as pc
from ..fields import tfield as tf
from ..groth16 import qap
from ..groth16.keys import LONG_ROW, MatrixCSR
from ..msm import pippenger as pp

FR = tf.FR


class Mesh:
    """An ordered list of torch devices in one process, the first the lead
    device, where a sharded result is gathered. axis_names mirrors the jax
    Mesh's."""

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

    @property
    def shards(self):
        """The shards this process computes, in order."""
        return range(self.size)

    @property
    def local_devices(self):
        """The devices of the shards this process computes."""
        return self.devices

    def __repr__(self):
        return f"{type(self).__name__}({[str(d) for d in self.devices]})"

    def blocks(self, n: int):
        """(start, stop) of each shard's block of n rows, n / size each."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over "
                             f"{self.size} shards")
        b = n // self.size
        return [(d * b, (d + 1) * b) for d in range(self.size)]

    def local_blocks(self, n: int):
        """((start, stop), device) of each shard this process computes."""
        blocks = self.blocks(n)
        return [(blocks[d], dev) for d, dev in zip(self.shards,
                                                    self.local_devices)]

    def scatter(self, t):
        """t's rows in equal contiguous blocks: the block of each shard this
        process computes, on its device."""
        return [t[a:b].to(dev) for (a, b), dev in
                self.local_blocks(t.shape[0])]

    def shard_points(self, points):
        """Affine points (X, Y, inf) as one (X, Y, inf) block per shard this
        process computes."""
        return [tuple(parts) for parts in
                zip(*(self.scatter(t) for t in points))]

    # -- collectives: `parts` holds one tensor per shard this process
    # -- computes (mesh.shards), each on its shard's device

    def gather(self, parts):
        """Every shard's part (equal shapes) concatenated along dim 0 in
        shard order, on the lead device."""
        return torch.cat([p.to(self.lead) for p in parts])

    def gather_rows(self, parts, sizes):
        """gather for parts of sizes[d] rows (shard d's), unequal."""
        return self.gather(parts)

    def all_to_all(self, chunks):
        """chunks[i] (size, ...): chunk e is for shard e. Returns one
        (size, ...) tensor per shard this process computes, on its device,
        whose row d is shard d's chunk for it."""
        return [torch.stack([c[e].to(dev) for c in chunks])
                for e, dev in enumerate(self.devices)]

    def broadcast(self, obj):
        """obj as the first shard's process holds it (here: obj)."""
        return obj


class ProcessMesh(Mesh):
    """One shard per process of the torch.distributed group, shard i the
    process of rank i on its own device `local` (distributed.global_mesh
    builds it after distributed.initialize). devices lists every rank's
    device in rank order; lead is this process's device, where every
    result lands, the same on every rank."""

    def __init__(self, local, axis: str = "pts"):
        local = torch.device(local)
        if local.type == "cuda" and local.index is None:
            local = torch.device("cuda", torch.cuda.current_device())
        self.rank = dist.get_rank()
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, str(local))
        super().__init__(names, axis)
        self.local = local
        self.backend = dist.get_backend()
        # gloo's collectives take host tensors: a card's go through the host
        self._via_host = local.type == "cuda" and self.backend == "gloo"

    @property
    def lead(self) -> torch.device:
        return self.local

    @property
    def shards(self):
        return (self.rank,)

    @property
    def local_devices(self):
        return (self.local,)

    def _out(self, t):
        """t as a collective takes it: contiguous, on the host for gloo."""
        t = t.contiguous()
        return t.cpu() if self._via_host else t

    def gather(self, parts):
        (part,) = parts
        t = self._out(part)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return torch.cat(out).to(self.local)

    def gather_rows(self, parts, sizes):
        """all_gather takes equal sizes: each block padded to the longest,
        then trimmed by the known sizes."""
        (part,) = parts
        most = max(sizes)
        pad = part.new_zeros((most - part.shape[0],) + part.shape[1:])
        full = self.gather([torch.cat([part, pad])])
        return torch.cat([full[d * most:d * most + k]
                          for d, k in enumerate(sizes)])

    def all_to_all(self, chunks):
        (chunk,) = chunks
        t = self._out(chunk)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return [out.to(self.local)]

    def broadcast(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(n_devices: int | None = None, axis: str = "pts") -> Mesh:
    """A mesh of the first n_devices cards (all visible cards by default);
    raises if fewer are visible."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}): {count} cards visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def _pack(part):
    """An MSM result (X, Y, Z[, wts int64]) as one int32 vector, the
    coordinates first (each stays 16-byte aligned in the gathered rows)."""
    return torch.cat([t.reshape(-1) for t in part[:3]]
                     + [t.contiguous().view(torch.int32) for t in part[3:]])


def _unpack(row, like):
    """_pack's inverse on one gathered row, shaped as the tuple `like`."""
    out, off = [], 0
    for t in like:
        k = t.numel() * t.element_size() // 4
        out.append(row[off:off + k].view(t.dtype).reshape(t.shape))
        off += k
    return tuple(out)


def sharded_msm(mesh: Mesh, curve: str, points, scalars, c: int = 13,
                lanes: int = 1024, blind=None):
    """MSM with (point, scalar) pairs sharded over the mesh, as
    pippenger.msm returns it: (X, Y, Z) on the lead device; with a
    blind, (X, Y, Z, wts) with wts the (size, W) int64 window counts of
    the shards, stacked for unblind_msm to sum.

    points: (X, Y, inf) of n rows, cut here, or mesh.shard_points of them
    (already on their devices); scalars (n, 16), cut here. Every shard
    starts from the same blind. The live counts, the one value each MSM
    reads to the host, are read once for this process's shards after
    their window keys are queued, so no shard's read holds back another
    card's launches (and no process waits for another's device); the
    accumulation, reduction and fold are then queued shard after shard.
    Every shard's partial and window counts are gathered, and the size
    partials folded in shard order on the lead device by size - 1 point
    add launches."""
    shards = (mesh.shard_points(points) if torch.is_tensor(points[0])
              else list(points))
    devs = mesh.local_devices
    if len(shards) != len(devs):
        raise ValueError(f"{len(shards)} point shards for the {len(devs)} "
                         f"shards of {mesh} this process computes")
    scal = mesh.scatter(scalars)
    blinds = ([tuple(b.to(d) for b in blind) for d in devs]
              if blind is not None else [None] * len(devs))
    staged = [pp.window_keys(p, s, c) for p, s in zip(shards, scal)]
    counts = torch.stack([live.sum().to(devs[0])
                          for _, live, _ in staged]).tolist()
    parts = [pp.msm_stream(curve, p, pp.sort_live(keys, live, n) + (drop,),
                           c, lanes, b)
             for p, (keys, live, drop), n, b in zip(shards, staged, counts,
                                                    blinds)]
    rows = mesh.gather([_pack(p) for p in parts]).reshape(mesh.size, -1)
    every = [_unpack(row, parts[0]) for row in rows]
    res = every[0][:3]
    for part in every[1:]:
        res = pc.add(curve, res, part[:3])
    if blind is None:
        return res
    return res + (torch.stack([part[3] for part in every]),)


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
    return field_sum(mesh.gather(local))[0]
