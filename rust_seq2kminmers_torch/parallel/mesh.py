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

Over NCCL the compiled steps hold the collectives inside CUDA graphs
(``nccl_compiled_step``); NCCL does not let a communicator go while such
a graph lives, so ``release_graphs`` comes before
``destroy_process_group`` (``launch.run_world`` and the file runner's
command line call it).
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.cuda.graph import CompiledStep

# The compiled steps whose graphs hold this process's NCCL collectives.
_holding_nccl: "weakref.WeakSet[CompiledStep]" = weakref.WeakSet()


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


# The single-tensor all-gather: ``all_gather_single`` where torch has it,
# ``all_gather_into_tensor`` (the same call, deprecated since) before.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[group size, *t.shape]: every rank's t, in group rank order, on
    t's device, gathered into one tensor of fixed shape (so that a CUDA
    graph can hold the NCCL all-gather)."""
    src = (t.cpu() if _via_host(t, group) else t).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.numel(),))
    _all_gather_single(out, src.view(-1), group=group)
    return out.view(-1, *src.shape).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's t, on t's device."""
    out = (t.cpu() if _via_host(t, group) else t).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def nccl_compiled_step(fn: Callable) -> CompiledStep:
    """A ``CompiledStep`` of ``fn``, whose graphs will hold NCCL
    collectives: ``release_graphs`` drops them."""
    step = CompiledStep(fn)
    _holding_nccl.add(step)
    return step


def release_graphs() -> None:
    """Drop every captured graph that holds NCCL collectives (the compiled
    DP and sharded steps' graphs; each captures again on its next call).
    NCCL reclaims a communicator's resources only once the graphs that
    captured its collectives are gone, so over two ranks or more
    ``destroy_process_group`` waits for them: call this first."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for step in list(_holding_nccl):
        step.graphs.clear()
