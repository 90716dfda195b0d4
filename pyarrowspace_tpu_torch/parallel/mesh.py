"""The device mesh and the collectives of the sharded build and serving
(port of pyarrowspace_tpu/parallel/mesh.py on ``torch.distributed``).

``torch.distributed`` is SPMD: one process per device, every process
calling the same functions with the same arguments.  The corpus shards
row-wise over the 1-D "data" dimension of a ``DeviceMesh``; ``make_mesh``
builds it over the default process group (initialised from the
environment, as ``torchrun`` sets it, when the caller has not done so).
On the card the group is NCCL and each rank takes ``cuda:{LOCAL_RANK}``;
``make_mesh(device="cpu")`` is gloo on the CPU; gloo with CUDA tensors
(``backend="gloo"``, e.g. several ranks sharing one card) only when the
caller asks for it.  There is no fallback from one backend to the other.

``Comm`` holds the collectives of one mesh dimension.  Every float that
crosses ranks is gathered and reduced in rank order on every rank
(``sum_ordered``), never by an all-reduce, so two runs, and two ranks,
hold the same bits.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def make_mesh(n_devices: Optional[int] = None, *, device=None,
              backend: Optional[str] = None) -> DeviceMesh:
    """1-D data-parallel mesh over every rank of the default group.

    ``device``: None (the card: ``cuda:{LOCAL_RANK}``, LOCAL_RANK
    defaulting to the rank modulo the cards present), ``"cpu"``, or an
    explicit CUDA device.  ``backend``: None (NCCL on the card, gloo on
    the CPU) or an explicit name.  A default group that is already up
    must have that backend.  ``n_devices``, when given, must equal the
    world size (a mesh over a subset of the ranks is not supported)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "mesh on the CPU")
    want = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cpu" and want != "gloo":
        raise ValueError(f"a CPU mesh needs gloo, not {want!r}")
    if not dist.is_initialized():
        dist.init_process_group(want)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"the default process group is {have!r}; this "
                           f"mesh asks for {want!r}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} must equal the world size "
                         f"{world}")
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=(DATA_AXIS,))


def pad_rows_to_multiple(x: torch.Tensor, multiple: int):
    """Pad the leading axis with zero rows to a multiple; returns
    (padded tensor, original row count)."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, n


class Comm:
    """The collectives of one dimension of a mesh, on this rank's device.

    A gloo group takes CUDA tensors in all_gather, all_to_all_single and
    all_reduce, but not in its point-to-point sends (measured on an H100
    with torch 2.11: gloo's TCP transport reads the CUDA pointer on the
    host and fails with "Bad address").  So for a gloo group on CUDA
    tensors, and only there, the ring shift copies the block through host
    memory; ``host_copied`` names the ops that did.  Compute stays on the
    device."""

    def __init__(self, mesh: DeviceMesh, dim: str = DATA_AXIS):
        self.mesh = mesh
        self.group = mesh.get_group(dim)
        self.size = mesh.size(mesh.mesh_dim_names.index(dim))
        self.rank = mesh.get_local_rank(dim)
        self.device = mesh_device(mesh)
        self._ranks = dist.get_process_group_ranks(self.group)
        self._gloo_cuda = (dist.get_backend(self.group) == "gloo"
                           and self.device.type == "cuda")
        self.host_copied: set[str] = set()

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's tensor (same shape and dtype on every rank), in
        rank order."""
        t = t.contiguous()
        if self.size == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self.all_gather(t))

    def all_gather_ragged(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's tensor when the leading sizes differ."""
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=self.device)
        sizes = [int(s) for s in self.all_gather_cat(n).tolist()]
        m = max(sizes)
        pad = t.new_zeros((m,) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        return [p[:s] for p, s in zip(self.all_gather(pad), sizes)]

    def sum_ordered(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's tensor, added in rank order on every
        rank (the same bits everywhere, run after run)."""
        parts = self.all_gather(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc

    def sum_int(self, value: int) -> int:
        """An exact integer sum across ranks."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return int(t)

    def max_int(self, value: int) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t)

    def sum_exact(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce of an integer (or boolean-valued) tensor: exact in
        any order."""
        if t.dtype.is_floating_point:
            raise TypeError("sum_exact takes integer tensors; gather floats "
                            "with sum_ordered")
        t = t.clone()
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all along dim 0: chunk r of every rank's tensor
        goes to rank r, and the result holds the chunks received, in rank
        order."""
        t = t.contiguous()
        if self.size == 1:
            return t.clone()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def ring_shift(self, t: torch.Tensor, out: torch.Tensor):
        """Send ``t`` to rank - 1 and receive rank + 1's into ``out``
        (``lax.ppermute`` with perm (i, i - 1)); returns the works to
        wait on (none once a host copy has completed)."""
        if self.size == 1:
            out.copy_(t)
            return []
        dst = self._ranks[(self.rank - 1) % self.size]
        src = self._ranks[(self.rank + 1) % self.size]
        if self._gloo_cuda:
            self.host_copied.add("ring_shift")
            send = t.cpu()
            recv = torch.empty(out.shape, dtype=out.dtype)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, self.group),
                dist.P2POp(dist.irecv, recv, src, self.group)])
            for w in works:
                w.wait()
            out.copy_(recv)
            return []
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), dst, self.group),
            dist.P2POp(dist.irecv, out, src, self.group)])


def local_real(n_real: int, lo: int, n_loc: int) -> int:
    """How many of the rows [lo, lo + n_loc) are real (below n_real)."""
    return int(np.clip(n_real - lo, 0, n_loc))
