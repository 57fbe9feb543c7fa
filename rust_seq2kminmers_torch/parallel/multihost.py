"""Distributed k-min-mers of a FASTA/FASTQ file, one rank a process.

Scales the reference crate's thread pool (src/main.rs:65-79: the file
split across threads, one closure a record) to many processes and GPUs,
as the reference package's ``parallel/multihost.py`` does over hosts:

  * ``torch.distributed``, one process a rank; a 1-D ``data`` mesh over
    every rank.
  * Batch g covers records [g * B, g * B + B), B = ranks x rows a rank;
    each rank packs only its own contiguous rows with the native reader,
    padded to its longest row (rounded up to 1024), and no rank ever
    holds another's reads.
  * Each batch is the data-parallel step (``driver.make_dp_pipeline``):
    the only traffic is the all-gather of per-read counts that gives each
    read its offset in the ordered stream, and the overflow flag, which is
    the same on every rank, so a rescue (``api.rescue_spec``) reruns the
    batch on every rank together.
  * Each rank stitches its own rows into an ordered chunk; the chunks in
    (batch, rank) order are the global stream.  With ``out_dir`` each rank
    writes its chunks and rank 0 a manifest; nothing big crosses ranks.

One process a rank, e.g. two ranks:

    python -m rust_seq2kminmers_torch.parallel.multihost \\
        --coordinator host0:29500 --num-processes 2 --process-id $RANK \\
        --out-dir /shared/out reads.fa

``--backend`` is nccl for one GPU a rank (the default on a GPU), gloo for
several ranks on one GPU or on the CPU (``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

_ROW_QUANTUM = 1024  # batches pad to a multiple of this


def _default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Initialise the default process group: ``coordinator_address`` is
    host:port (tcp) or an ``init_method`` URL such as file:///shared/f;
    ``backend`` defaults to nccl for a CUDA device and gloo for the CPU.
    -> True if a group of several processes was started; one process
    starts none (``global_data_mesh`` then makes a world of one)."""
    if num_processes in (None, 1):
        return False
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend or _default_backend(device), init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def global_data_mesh(device="cuda"):
    """1-D 'data' mesh over every rank of the default group, rank order.
    In a process that started no group, a world of one on an in-process
    store."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group(_default_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=("data",))


@dataclasses.dataclass
class HostChunk:
    """This rank's piece of the globally ordered stream for one batch."""

    batch_index: int
    first_record: int  # global index of this chunk's first read row
    stream_start: int  # global stream offset of this chunk's first element
    records: dict  # stitch_records struct-of-arrays (local chunk)
    batch_total: int  # k-min-mers in the WHOLE batch (all ranks)


def run_file_distributed(
    path,
    spec,
    mesh=None,
    rows_per_rank: int = 8,
    threads: int = 0,
    out_dir: Optional[str] = None,
    progress: bool = False,
    device="cuda",
) -> List[HostChunk]:
    """Enumerate the k-min-mers of a FASTA/FASTQ file across all ranks.

    Every rank calls this with the same arguments (the file visible to
    each).  Returns this rank's ordered chunks; with ``out_dir``, also
    writes one .npz per (batch, rank) and rank 0's manifest of the global
    order and stream offsets."""
    from ..api import _device, rescue_spec
    from ..constants import XCODE_PAD, family_of_mode
    from ..io.fasta import FastaFile
    from .driver import make_dp_pipeline, stitch_records, valid_corner

    device = _device(device)
    if mesh is None:
        mesh = global_data_mesh(device)
    group = mesh.get_group("data")
    nproc, proc = dist.get_world_size(group), dist.get_rank(group)
    B = nproc * rows_per_rank
    fam = family_of_mode(spec.mode)
    # Rows shorter than the window still need a padded length above l.
    min_pad = -(-(spec.l + 1) // _ROW_QUANTUM) * _ROW_QUANTUM

    chunks: List[HostChunk] = []
    stream_base = 0  # global stream offset of the current batch's start
    with FastaFile(path) as f:
        n = len(f)
        lens = f.seq_lens()
        for g, first in enumerate(range(0, n, B)):
            lfirst = first + proc * rows_per_rank
            cnt = max(0, min(rows_per_rank, n - lfirst))
            longest = int(lens[lfirst : lfirst + cnt].max(initial=0))
            pad = max(min_pad, -(-longest // _ROW_QUANTUM) * _ROW_QUANTUM)
            codes = np.full((rows_per_rank, pad), XCODE_PAD, dtype=np.uint8)
            lengths = np.zeros(rows_per_rank, dtype=np.int32)
            if cnt:
                c, ln = f.pack(lfirst, cnt, pad, threads, fam)
                codes[:cnt], lengths[:cnt] = c, ln
            codes_d = torch.from_numpy(codes).to(device)
            lengths_d = torch.from_numpy(lengths).to(device)
            # `lost` is all-reduced, so every rank retries together; each
            # reruns on the lossless tile capacity with M sized for its own
            # largest raw count, as api.kminmers_batch does.  The reference
            # crate never drops a minimizer (src/nthash_avx512_32.rs:139-141).
            rspec = spec
            for _ in range(8):
                res = make_dp_pipeline(rspec, mesh, device)(codes_d, lengths_d)
                if int(res.lost) == 0:
                    break
                rspec = rescue_spec(rspec, int(res.batch.n_minimizers_raw.max()))
            else:
                raise RuntimeError("minimizer overflow not resolved after 8 distributed retries")

            counts, bases, batch_total, *columns = valid_corner(res)
            local_total = int(counts.sum())
            chunk_start = int(bases[0])
            rec = stitch_records(counts, bases - chunk_start, local_total, *columns,
                                 read_base=lfirst)
            chunk = HostChunk(
                batch_index=g,
                first_record=lfirst,
                stream_start=stream_base + chunk_start,
                records=rec,
                batch_total=batch_total,
            )
            chunks.append(chunk)
            stream_base += chunk.batch_total
            if out_dir is not None:
                p = Path(out_dir)
                p.mkdir(parents=True, exist_ok=True)
                np.savez_compressed(p / f"part-b{g:05d}-h{proc:03d}.npz",
                                    stream_start=chunk.stream_start,
                                    first_record=chunk.first_record, **rec)
            if progress:
                print(f"[rank {proc}] batch {g}: reads [{lfirst}, {lfirst + cnt}) -> "
                      f"{local_total} k-min-mers (batch total {chunk.batch_total})",
                      flush=True)

    if out_dir is not None and proc == 0:
        manifest = {
            "file": str(path),
            "num_processes": nproc,
            "rows_per_batch": B,
            "num_records": n,
            "total_kminmers": stream_base,
            "spec": {
                "l": spec.l, "k": spec.k, "density": spec.density,
                "mode": spec.mode, "hash_width": spec.hash_width,
                "variant": spec.variant,
            },
            "part_pattern": "part-b{batch:05d}-h{host:03d}.npz",
            "order": "ascending (batch, host); concatenation is the "
            "globally ordered stream",
        }
        (Path(out_dir) / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return chunks


def main(argv=None):
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("fasta")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0, or an init_method URL (file://...)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mode", default="regular")
    ap.add_argument("--l", type=int, default=31)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--rows-per-rank", type=int, default=8)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on a GPU, gloo on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..ops.pipeline import PipelineSpec
    from .mesh import release_graphs

    device = args.device
    backend = args.backend or _default_backend(device)
    if backend == "nccl":  # one GPU a rank
        device = f"cuda:{(args.process_id or 0) % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    init_distributed(args.coordinator, args.num_processes, args.process_id, backend, device)
    spec = PipelineSpec(l=args.l, k=args.k, density=args.density, mode=args.mode)
    t0 = time.perf_counter()
    chunks = run_file_distributed(
        args.fasta, spec, rows_per_rank=args.rows_per_rank, threads=args.threads,
        out_dir=args.out_dir, progress=True, device=device,
    )
    dt = time.perf_counter() - t0
    local = sum(len(c.records["hash"]) for c in chunks)
    total = sum(c.batch_total for c in chunks)
    print(f"[rank {dist.get_rank()}] done in {dt:.3f}s: {local} local / {total} total "
          f"k-min-mers over {len(chunks)} batches")
    release_graphs()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
