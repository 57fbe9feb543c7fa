"""The block scan of K1's pass 3 (``csrc/fused_scan.cu``, ``then``), on the CPU.

A thread's run of kept bases is summarised as (n, f, r): its count and the
XORs of its terms rotated by their rank inside the run,
f = XOR_i rol(seed[c_i], -i) and r = XOR_i rol(seed'[c_i], i).  Two runs
combine as (n1 + n2, f1 ^ rol(f2, -n1), r1 ^ rol(r2, n1)).  These tests hold
that operator, with the port's plain rotations at each width, to being
associative and to giving, scanned the way the kernel scans it, the direct
prefix XOR of terms rotated by their global rank, from ranks near 2^31 too.
"""

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops.nthash import _rol16, _rol31
from rust_seq2kminmers_torch.ops.u64 import rol32, rol64

WIDTHS = {16: _rol16, 31: _rol31, 32: rol32, 64: rol64}
RUN, THREADS, WARP = 16, 96, 32  # the kernel's run, block and warp


def _values(rng, w, shape):
    """Random values of width w as the plain versions hold them in int64
    (width 64 as bit patterns)."""
    if w == 64:
        return torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64))
    return torch.from_numpy(rng.integers(0, 1 << w, shape, dtype=np.int64))


def _then(rol, a, b):
    """a, then b: b's ranks move up by a's count."""
    (n1, f1, r1), (n2, f2, r2) = a, b
    return n1 + n2, f1 ^ rol(f2, -n1), r1 ^ rol(r2, n1)


def _xor_prefix(x):
    """Inclusive XOR prefix along the last axis."""
    o = 1
    while o < x.shape[-1]:
        x = torch.cat([x[..., :o], x[..., o:] ^ x[..., :-o]], dim=-1)
        o <<= 1
    return x


@pytest.mark.parametrize("w", sorted(WIDTHS))
def test_scan_operator_is_associative(w):
    rol = WIDTHS[w]
    rng = np.random.default_rng(w)
    trials = 4000
    # Counts of a run, of a step and of a whole prefix of the stream, up to
    # 2^31, where the kernel's ranks end.
    counts = [rng.integers(0, RUN + 1, trials), rng.integers(0, 1 << 12, trials),
              rng.integers((1 << 31) - (1 << 16), 1 << 31, trials)]
    segs = []
    for k in range(3):
        rng.shuffle(counts[k])
        segs.append((torch.from_numpy(counts[k]), _values(rng, w, trials),
                     _values(rng, w, trials)))
    a, b, c = segs
    left = _then(rol, _then(rol, a, b), c)
    right = _then(rol, a, _then(rol, b, c))
    for x, y in zip(left, right):
        assert torch.equal(x, y)
    zero = torch.zeros(trials, dtype=torch.int64)
    for x, y in zip(_then(rol, (zero, zero, zero), a), a):
        assert torch.equal(x, y)


@pytest.mark.parametrize("w", sorted(WIDTHS))
@pytest.mark.parametrize("base", [0, 1000, (1 << 31) - 6 * RUN * THREADS])
def test_scan_operator_gives_rank_rotated_prefixes(w, base):
    """Six steps of 96 runs of 16 with random keep masks, scanned as the
    kernel does: each run's own (n, f, r), a shuffle scan inside each warp
    of 32, the exclusive value recovered from the inclusive one, the warps'
    totals in order, then each kept element's PF(e) = PF(first - 1) ^
    rol(its run prefix, -first).  Every PF(e) and PR(e) equals the direct
    XOR of seed[c_k] rotated by -k and seed'[c_k] rotated by k over the
    global ranks k <= e, from PF(base - 1) = PR(base - 1) = 0."""
    rol = WIDTHS[w]
    rng = np.random.default_rng(base + w)
    trials, steps = 4, 6
    kept = torch.from_numpy(rng.random((trials, steps, THREADS, RUN)) < 0.75)
    kept[:, 1] = False  # a step that keeps nothing
    kept[:, 2] = True  # and one that keeps everything
    kept[:, 3, :, 5:] = False  # runs cut short, as at a read's end
    tf = _values(rng, w, (trials, steps, THREADS, RUN))
    tr = _values(rng, w, (trials, steps, THREADS, RUN))

    # Direct: each kept term at its global rank, in stream order.
    flat = kept.reshape(trials, -1).to(torch.int64)
    rank = (base + torch.cumsum(flat, 1) - flat).view_as(tf)
    want_f = _xor_prefix(torch.where(kept, rol(tf, -rank), 0).reshape(trials, -1)).view_as(tf)
    want_r = _xor_prefix(torch.where(kept, rol(tr, rank), 0).reshape(trials, -1)).view_as(tf)

    # The kernel's way, step by step, PF(base - 1) carried in registers.
    zero = torch.zeros(trials, dtype=torch.int64)
    pb_f, pb_r, b = zero, zero, torch.full((trials,), base, dtype=torch.int64)
    lane = torch.arange(THREADS) % WARP
    for s in range(steps):
        k = kept[:, s]
        local = torch.cumsum(k.to(torch.int64), -1) - k.to(torch.int64)  # rank in the run
        lf = _xor_prefix(torch.where(k, rol(tf[:, s], -local), 0))
        lr = _xor_prefix(torch.where(k, rol(tr[:, s], local), 0))
        own = (k.sum(-1), lf[..., -1], lr[..., -1])  # trials x threads
        inc = own
        o = 1
        while o < WARP:  # lane t takes lane t - o's value where lane >= o
            new = _then(rol, tuple(torch.roll(x, o, dims=1) for x in inc), inc)
            inc = tuple(torch.where(lane >= o, y, x) for x, y in zip(inc, new))
            o <<= 1
        en = inc[0] - own[0]
        exc = (en, inc[1] ^ rol(own[1], -en), inc[2] ^ rol(own[2], en))
        total, before = (zero, zero, zero), []
        for wp in range(THREADS // WARP):
            before.append(total)
            total = _then(rol, total, tuple(x[:, wp * WARP + WARP - 1] for x in inc))
        warp_of = torch.arange(THREADS) // WARP
        before = tuple(torch.stack([bw[j] for bw in before], 1)[:, warp_of] for j in range(3))
        bt = _then(rol, before, exc)
        first = b[:, None] + bt[0]
        bf = pb_f[:, None] ^ rol(bt[1], -b[:, None])
        br = pb_r[:, None] ^ rol(bt[2], b[:, None])
        pf = bf[..., None] ^ rol(lf, -first[..., None])
        pr = br[..., None] ^ rol(lr, first[..., None])
        assert torch.equal(torch.where(k, pf, 0), torch.where(k, want_f[:, s], 0))
        assert torch.equal(torch.where(k, pr, 0), torch.where(k, want_r[:, s], 0))
        has = k.any(-1)  # first is the rank of the run's first kept element
        first_kept = torch.where(k, rank[:, s], 1 << 40).amin(-1)
        assert torch.equal(torch.where(has, first, 0), torch.where(has, first_kept, 0))
        pb_f = pb_f ^ rol(total[1], -b)
        pb_r = pb_r ^ rol(total[2], b)
        b = b + total[0]
    assert torch.equal(b - base, kept.sum(dim=(1, 2, 3)))
