"""Runs a function on every rank of a fresh ``torch.distributed`` world.

The reference package drives every device from one process; here a rank
is a process.  ``run_world`` spawns one per rank (start method spawn, so
a parent that has already initialised CUDA is safe), and the ranks meet
through a file store in a temporary directory: no TCP port, so several
worlds can start at once on one machine.  The kernel library is built
(or loaded) in the parent first, so the ranks only load it.

Spawning starts multiprocessing's resource tracker, a process of its own.
Python 3.12 releases before the fix of CPython issue 88887 leave it to end
after the parent has exited; ``run_world`` stops it and waits for it when
the world is done, so that no process of the world outlives the call.
"""

from __future__ import annotations

import gc
import queue
import tempfile
import time
import traceback
from multiprocessing import resource_tracker
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import release_graphs

_POLL_S = 0.2
_TIMEOUT_S = 900.0  # a world that runs longer is ended


def _rank_main(rank, world_size, backend, device, init_method, results, fn, args):
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        device = torch.device(device)
        if backend == "nccl":  # one GPU a rank
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        result = fn(device, *args)
        release_graphs()
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, backend: str, device, *args):
    """-> [fn(device, *args) of rank 0, 1, ...], each run in its own process
    after ``init_process_group(backend)`` over ``world_size`` ranks.  fn
    and args must pickle, and fn's result should be plain data (numpy, not
    tensors).  On nccl rank r uses GPU r modulo the GPUs there are; on
    gloo every rank uses ``device``.  If a rank raises, its traceback is
    raised here and the other ranks are ended; so is a world that runs
    past 900 seconds."""
    if torch.device(device).type == "cuda":
        from ..ops.cuda import build

        build.library()
    own_tracker = resource_tracker._resource_tracker._fd is None
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    try:
        out, failure = _run_ranks(ctx, results, fn, world_size, backend, device, args)
    finally:
        results.close()
        results.join_thread()
        del results
        gc.collect()  # the queue's semaphores leave the tracker's list now
        if own_tracker:  # end the tracker process the spawn started, and wait for it
            resource_tracker._resource_tracker._stop()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]


def _run_ranks(ctx, results, fn, world_size, backend, device, args):
    """Start the ranks, collect their results, join them -> (results by
    rank, the first failure or None)."""
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "store").as_uri()
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, world_size, backend, str(device), init, results, fn, args))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + _TIMEOUT_S
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=_POLL_S)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                    elif time.monotonic() > deadline:
                        failure = f"the world did not finish in {_TIMEOUT_S} s"
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join()
    return out, failure
