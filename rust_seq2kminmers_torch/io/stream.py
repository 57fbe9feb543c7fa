"""Streaming FASTA/FASTQ -> k-min-mers: length-bucketed batches, packed on a
producer thread while the device computes.

The reference crate streams records through a thread pool, one closure a
record (src/main.rs:65-79).  Here reads are batched, and two things keep
the batches cheap:

  * **Length buckets.**  Records are binned by padded length into
    power-of-two pads (multiples of 1024), so a 2 kb read never pays for a
    100 kb neighbour.  Rows per batch scale inversely with the pad, so
    every batch holds about ``target_cells`` bases.
  * **Overlap.**  A producer thread packs each batch with the native
    reader (``FastaFile.pack_indices``) straight into a pinned host buffer
    from a small pool.  The main thread copies it to the device on a side
    stream, makes the compute stream wait for the copy, and replays the
    spec's compiled pipeline (``api._cached_pipeline``: one captured CUDA
    graph per bucket shape, every shape captured before the producer
    starts); two batches are in flight before the older one is read back.
    The producer touches no CUDA API, and a buffer goes back to it only
    after the copy out of it has completed.

Reading a batch back fetches its three count vectors first, reruns it
through ``api.kminmers_batch`` if a read lost minimizers to a capacity,
then fetches only the valid ``[reads, max n_kminmers]`` corner of the
record columns.  Bucketing permutes batches, not the output: ``collect()``
orders the stream by record id, then offset, as the reference's
sequential iterator does (src/lib.rs:258-259).  ``device="cpu"`` runs the
same loop on the plain versions, without pinned memory or streams.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import _cached_pipeline, _device, kminmers_batch
from ..constants import family_of_mode
from ..parallel.driver import stitch_records
from . import queues
from .fasta import FastaFile

PAD_QUANTUM = 1024
ROW_QUANTUM = 8
IN_FLIGHT = 2  # batches dispatched before the oldest is read back


def plan_buckets(
    lens: np.ndarray,
    target_cells: int = 1 << 25,
    max_rows: int = 1024,
) -> List[Tuple[int, int, np.ndarray]]:
    """Bin record lengths into power-of-two pads (multiples of 1024).

    Returns [(pad, rows_per_batch, record_indices)] with indices ascending
    inside each bucket; rows_per_batch ~ target_cells / pad, so batches
    cost about the same whatever the read length.  rows_per_batch is also
    clamped to the bucket's occupancy (rounded up to the row quantum), so
    a small file never runs a mostly empty batch (a single 100 kb read
    gets an [8, 131072] batch, not [256, 131072]).
    """
    lens = np.asarray(lens, dtype=np.int64)
    pads = np.maximum(PAD_QUANTUM, 1 << np.ceil(
        np.log2(np.maximum(lens, 1))).astype(np.int64))
    out = []
    for pad in np.unique(pads):
        idx = np.nonzero(pads == pad)[0]
        rows = int(min(max_rows, max(ROW_QUANTUM, target_cells // pad)))
        occupancy = -(-len(idx) // ROW_QUANTUM) * ROW_QUANTUM
        rows = min((rows // ROW_QUANTUM) * ROW_QUANTUM, occupancy)
        out.append((int(pad), rows, idx))
    return out


@dataclasses.dataclass
class StreamStats:
    total_kminmers: int
    total_bases: int
    num_records: int
    wall_s: float
    pack_s: float  # the producer thread's packing time (overlapped)
    batches: int
    buckets: int
    # Time the run spent building or loading the kernel library and
    # capturing each bucket's graph, before the producer starts (0.0 when
    # both were done by an earlier run in this process, and on the CPU).
    warm_s: float = 0.0
    # From the start of the run to the first batch read back.
    first_result_s: float = 0.0
    # The main thread's time waiting for the producer's next batch, reading
    # batches back (count and record fetches, each waiting for its batch's
    # kernels, and any rescue), and stitching their records.
    wait_s: float = 0.0
    fetch_s: float = 0.0
    stitch_s: float = 0.0


class _Slot:
    """One pinned host buffer pair, big enough for any batch of the plan;
    each batch views its [rows, pad] corner."""

    def __init__(self, cells: int, rows: int):
        self.codes = torch.empty(cells, dtype=torch.uint8, pin_memory=True)
        self.lengths = torch.empty(rows, dtype=torch.int64, pin_memory=True)
        self._codes, self._lengths = self.codes.numpy(), self.lengths.numpy()

    def arrays(self, rows: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._codes[: rows * pad].reshape(rows, pad), self._lengths[:rows]

    def tensors(self, rows: int, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.codes[: rows * pad].view(rows, pad), self.lengths[:rows]


class StreamingRunner:
    """Length-bucketed, overlapped FASTA -> k-min-mer stream on ``device``.

    Usage:
        with StreamingRunner(path, spec) as r:
            stats = r.run()
            records = r.collect()   # optional: the ordered stream
    """

    def __init__(
        self,
        path,
        spec,
        threads: int = 0,
        target_cells: int = 1 << 25,
        queue_depth: int = 3,
        keep_records: bool = True,
        device="cuda",
    ):
        self.device = _device(device)
        self.path = path
        self.spec = spec
        self.threads = threads
        self.target_cells = target_cells
        self.queue_depth = queue_depth
        self.keep_records = keep_records
        self.file = FastaFile(path)
        self.family = family_of_mode(spec.mode)
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._counts: Optional[np.ndarray] = None
        self.stats: Optional[StreamStats] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.file.close()
        return False

    # ---- producer: pack batches ahead of the device ----
    def _produce(self, plan, free, q, stop):
        """Pack every batch, padding rows included (id -1: length 0,
        XCODE_PAD), into a free slot (GPU) or new arrays (CPU); put
        (chunk, codes, lengths, slot), then the packing seconds."""
        t_pack = 0.0
        try:
            for pad, rows, idx in plan:
                for first in range(0, len(idx), rows):
                    chunk = idx[first : first + rows]
                    ids = np.full(rows, -1, dtype=np.int64)
                    ids[: len(chunk)] = chunk
                    slot = None if free is None else queues.get(free, stop)
                    if free is not None and slot is None:
                        return  # stopped
                    t0 = time.perf_counter()
                    codes, lengths = self.file.pack_indices(
                        ids, pad, self.threads, self.family,
                        out=None if slot is None else slot.arrays(rows, pad),
                    )
                    t_pack += time.perf_counter() - t0
                    if not queues.put(q, (chunk, codes, lengths, slot), stop):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            queues.put(q, e, stop)
            return
        queues.put(q, t_pack, stop)

    def _settle(self, batch, counts, timing, progress):
        """Read one batch back: its counts, a rerun if it overflowed, then
        the valid corner of its record columns, stitched."""
        chunk, dcodes, dlens, out = batch
        n = len(chunk)
        t0 = time.perf_counter()
        c = torch.stack([out.n_kminmers, out.n_minimizers, out.n_minimizers_raw]).cpu()
        if bool((c[1] < c[2]).any()):
            out = kminmers_batch(dcodes, dlens, self.spec)
            c = out.n_kminmers[None].cpu()
        nk = c[0, :n].numpy().astype(np.int64)
        counts[chunk] = nk
        total = int(nk.sum())
        if self.keep_records:
            mk = int(nk.max(initial=0))
            cols = torch.stack([
                t[:n, :mk].to(torch.int32)
                for t in (out.hash_hi, out.hash_lo, out.start, out.end, out.rev)
            ]).cpu().numpy()
        t1 = time.perf_counter()
        timing["fetch"] += t1 - t0
        if self.keep_records:
            hashes = (cols[0].view(np.uint32).astype(np.uint64) << np.uint64(32)) | (
                cols[1].view(np.uint32))
            self._chunks.append(stitch_records(
                nk, np.cumsum(nk) - nk, total, hashes, cols[2], cols[3],
                cols[4].astype(bool), read_ids=chunk,
            ))
            timing["stitch"] += time.perf_counter() - t1
        if progress:
            print(f"  batch of {n} reads -> {total} k-min-mers", flush=True)
        return total

    def _warm(self, pipe, plan) -> float:
        """Build or load the kernel library and capture the pipeline's graph
        for every bucket shape of the plan, now -> the seconds it took.  A
        capture rejects CUDA calls from other threads, so this runs before
        the producer starts (the counterpart of the reference's warm
        thread)."""
        t0 = time.perf_counter()
        for pad, rows, _ in plan:
            pipe.capture(
                torch.zeros((rows, pad), dtype=torch.uint8, device=self.device),
                torch.zeros((rows,), dtype=torch.int32, device=self.device),
            )
        return time.perf_counter() - t0

    def run(self, progress: bool = False) -> StreamStats:
        lens = self.file.seq_lens()
        n = len(lens)
        plan = plan_buckets(lens, self.target_cells)
        cuda = self.device.type == "cuda"
        pipe = _cached_pipeline(self.spec)
        t0 = time.perf_counter()
        free = None
        warm_s = 0.0
        if cuda:
            # The pinned pool: enough slots for the queue, the batch being
            # packed and the one being copied.
            free = queue.Queue()
            cells = max((pad * rows for pad, rows, _ in plan), default=0)
            max_rows = max((rows for _, rows, _ in plan), default=0)
            for _ in range(self.queue_depth + 2):
                free.put(_Slot(cells, max_rows))
            copy_stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            warm_s = self._warm(pipe, plan)
        q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._produce, args=(plan, free, q, stop), daemon=True
        )
        producer.start()
        counts = np.zeros(n, dtype=np.int64)
        total = batches = 0
        pack_s = first_result_s = 0.0
        self._chunks = []
        inflight: collections.deque = collections.deque()
        copies = []  # (copy event, slot) not yet back in the pool
        timing = collections.Counter()
        try:
            while True:
                t_wait = time.perf_counter()
                item = q.get()
                timing["wait"] += time.perf_counter() - t_wait
                if isinstance(item, Exception):
                    raise item
                if isinstance(item, float):  # the producer is done
                    pack_s = item
                    break
                chunk, codes, lengths, slot = item
                if cuda:
                    hcodes, hlens = slot.tensors(*codes.shape)
                    with torch.cuda.stream(copy_stream):
                        dcodes = hcodes.to(self.device, non_blocking=True)
                        dlens = hlens.to(self.device, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                    compute.wait_event(copied)
                    dcodes.record_stream(compute)
                    dlens.record_stream(compute)
                    copies.append((copied, slot))
                else:
                    dcodes, dlens = torch.from_numpy(codes), torch.from_numpy(lengths)
                out = pipe(dcodes, dlens)
                inflight.append((chunk, dcodes, dlens, out))
                batches += 1
                if len(inflight) >= IN_FLIGHT:
                    total += self._settle(inflight.popleft(), counts, timing, progress)
                    first_result_s = first_result_s or time.perf_counter() - t0
                    for copied, s in copies:  # done, or nearly: hand back
                        copied.synchronize()
                        free.put(s)
                    copies.clear()
            while inflight:
                total += self._settle(inflight.popleft(), counts, timing, progress)
                first_result_s = first_result_s or time.perf_counter() - t0
        finally:
            stop.set()
            producer.join()
        self._counts = counts
        self.stats = StreamStats(
            total_kminmers=total,
            total_bases=int(lens.sum()),
            num_records=n,
            wall_s=time.perf_counter() - t0,
            pack_s=pack_s,
            batches=batches,
            buckets=len(plan),
            warm_s=warm_s,
            first_result_s=first_result_s,
            wait_s=timing["wait"],
            fetch_s=timing["fetch"],
            stitch_s=timing["stitch"],
        )
        return self.stats

    def collect(self) -> Dict[str, np.ndarray]:
        """The stitched batches as ONE ordered struct-of-arrays (ascending
        record id, then offset in the read): the reference's sequential
        iteration order."""
        if self._counts is None:
            raise RuntimeError("run() first")
        if not self.keep_records:
            raise RuntimeError("constructed with keep_records=False")
        base = np.cumsum(self._counts) - self._counts  # each read's first slot
        total = int(self._counts.sum())
        out = {
            "hash": np.zeros(total, dtype=np.uint64),
            "start": np.zeros(total, dtype=np.int64),
            "end": np.zeros(total, dtype=np.int64),
            "offset": np.zeros(total, dtype=np.int64),
            "rev": np.zeros(total, dtype=bool),
            "read": np.zeros(total, dtype=np.int64),
        }
        for rec in self._chunks:
            dest = base[rec["read"]] + rec["offset"]
            for kcol in out:
                out[kcol][dest] = rec[kcol]
        return out


def stream_file(
    path,
    spec,
    threads: int = 0,
    out: Optional[str] = None,
    progress: bool = False,
    target_cells: int = 1 << 25,
    device="cuda",
) -> StreamStats:
    """One streaming run; with ``out``, writes the ordered stream to a
    compressed .npz (columns hash/start/end/offset/rev/read)."""
    with StreamingRunner(
        path, spec, threads=threads, target_cells=target_cells,
        keep_records=out is not None, device=device,
    ) as runner:
        stats = runner.run(progress=progress)
        if out is not None:
            np.savez_compressed(out, **runner.collect())
    return stats
