"""The rank mesh of the sharded pipelines, and their two collectives.

The reference crate's parallelism is a thread pool over reads
(src/main.rs:57,79).  The reference package lifts it to a ``data`` mesh
axis over chips, plus a ``seq`` axis that cuts long reads along their
length.  Here the mesh is a ``torch.distributed`` DeviceMesh over the
ranks of the initialised default group, one process a rank: rank r sits
at (r // n_seq, r % n_seq), as the reference reshapes its device list.
Each rank holds only its own block of ``codes[B, L]``: ``batch_sharding``
and ``row_sharding`` say which.

The mesh's device type follows the group's backend (cuda for nccl, cpu
for gloo); the device the kernels run on is the pipelines' own argument.
On a gloo group, ``all_gather`` and ``all_reduce`` take a CUDA tensor
through the host: the collectives carry only small counts and tails, so
several gloo ranks can share one GPU, which NCCL refuses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1) -> DeviceMesh:
    """A (data, seq) mesh over ranks [0, n_data * n_seq) of the default
    group; n_data defaults to the world size // n_seq.  Every rank of the
    world calls it; a rank outside the mesh gets no coordinate."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_seq
    n = n_data * n_seq
    if n > world or n < 1:
        raise ValueError(f"mesh {n_data}x{n_seq} needs {n} ranks, have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_seq),
                      mesh_dim_names=("data", "seq"))


def _block(n: int, parts: int, i: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} is not a multiple of {parts}")
    return slice(i * (n // parts), (i + 1) * (n // parts))


def batch_sharding(mesh: DeviceMesh, B: int, L: int, seq_sharded: bool = False):
    """This rank's (rows, columns) block of codes[B, L]: rows split over
    'data', columns over 'seq' when ``seq_sharded`` (else all of them)."""
    d, s = mesh.get_coordinate()
    n_data, n_seq = mesh.shape
    cols = _block(L, n_seq, s, "padded length") if seq_sharded else slice(0, L)
    return _block(B, n_data, d, "batch size"), cols


def row_sharding(mesh: DeviceMesh, B: int) -> slice:
    """This rank's block of a per-read vector such as lengths[B]."""
    return _block(B, mesh.shape[0], mesh.get_coordinate()[0], "batch size")


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[group size, *t.shape]: every rank's t, in group rank order, on
    t's device."""
    src = (t.cpu() if _via_host(t, group) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's t, on t's device."""
    out = (t.cpu() if _via_host(t, group) else t).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)
