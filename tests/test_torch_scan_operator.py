"""The block scan of K1's pass 3 (``csrc/fused_scan.cu``, ``then``), on the CPU.

A thread's run of kept bases is summarised as (n, f, r): its count and the
XORs of its terms rotated by their rank inside the run,
f = XOR_i rol(seed[c_i], -i) and r = XOR_i rol(seed'[c_i], i).  Two runs
combine as (n1 + n2, f1 ^ rol(f2, -n1), r1 ^ rol(r2, n1)).  These tests hold
that operator, with the port's plain rotations at each width, to being
associative and to giving, scanned the way the kernel scans it at each
width's run and block (``ScanShape<H>``, read from the source), the direct
prefix XOR of terms rotated by their global rank, from ranks near 2^31 too;
and the width-64 rotates on 32-bit halves to equal ``rol64``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch.ops.nthash import _rol16, _rol31
from rust_seq2kminmers_torch.ops.u64 import MASK32, rol32, rol64

WIDTHS = {16: _rol16, 31: _rol31, 32: rol32, 64: rol64}
WARP = 32
SOURCE = Path(__file__).resolve().parents[1] / "rust_seq2kminmers_torch" / "csrc" / "fused_scan.cu"


def _constant(src, name):
    """``name``'s value in ``ScanShape<H>`` as (width 64, the others): a
    number, or ``sizeof(typename H::T) == 8 ? a : b``."""
    m = re.search(r"constexpr int " + name
                  + r" = (?:sizeof\(typename H::T\) == 8 \? (\d+) : )?(\d+);", src)
    return int(m.group(1) or m.group(2)), int(m.group(2))


def _kernel_shapes():
    """{width: (run, threads, min_blocks)} and LMAX as ``fused_scan.cu`` sets them."""
    src = SOURCE.read_text()
    values = [_constant(src, name) for name in ("run", "threads", "min_blocks")]
    lmax = _constant(src, "LMAX")[1]
    return {w: tuple(v[0] if w == 64 else v[1] for v in values) for w in WIDTHS}, lmax


SHAPES, LMAX = _kernel_shapes()
THREADS = SHAPES[32][1]
TOP_BASE = (1 << 31) - 6 * 16 * THREADS  # six steps of the widest run below 2^31


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
    counts = [rng.integers(0, SHAPES[w][0] + 1, trials), rng.integers(0, 1 << 12, trials),
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
@pytest.mark.parametrize("base", [0, 1000, TOP_BASE])
def test_scan_operator_gives_rank_rotated_prefixes(w, base):
    """Six steps of 96 runs (of 16 bases, 8 at width 64) with random keep
    masks, scanned as the kernel does: each run's own (n, f, r), a shuffle scan inside each warp
    of 32, the exclusive value recovered from the inclusive one, the warps'
    totals in order, then each kept element's PF(e) = PF(first - 1) ^
    rol(its run prefix, -first).  Every PF(e) and PR(e) equals the direct
    XOR of seed[c_k] rotated by -k and seed'[c_k] rotated by k over the
    global ranks k <= e, from PF(base - 1) = PR(base - 1) = 0."""
    rol = WIDTHS[w]
    RUN, THREADS, _ = SHAPES[w]
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
        if w == 64:  # the counts first, then XOR scans of own moved to its rank
            while o < WARP:
                inc = (torch.where(lane >= o, inc[0] + torch.roll(inc[0], o, dims=1), inc[0]),)
                o <<= 1
            en = inc[0] - own[0]
            moved = (rol(own[1], -en), rol(own[2], en))
            for x in moved:
                y, o = x, 1
                while o < WARP:
                    y = torch.where(lane >= o, y ^ torch.roll(y, o, dims=1), y)
                    o <<= 1
                inc = inc + (y,)
            exc = (en, inc[1] ^ moved[0], inc[2] ^ moved[1])
        while o < WARP:  # lane t takes lane t - o's value where lane >= o
            new = _then(rol, tuple(torch.roll(x, o, dims=1) for x in inc), inc)
            inc = tuple(torch.where(lane >= o, y, x) for x, y in zip(inc, new))
            o <<= 1
        if w != 64:
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


@pytest.mark.parametrize("w", sorted(WIDTHS))
def test_ring_holds_a_step_and_the_window_before_it(w):
    """At each width's shape the ring (a power of two) holds a step's ranks
    and the l + 1 before it at the largest l, and its padded slots (two
    values and a position each) fit a block's 48 KB of shared memory and
    the shape's blocks in a SM's 228 KB."""
    run, threads, min_blocks = SHAPES[w]
    need = threads * run + LMAX + 1
    ring = 1 << (need - 1).bit_length()
    assert need <= ring < 2 * need
    slots = ring + ring // 16
    nbytes = slots * (2 * (8 if w == 64 else 4) + 4)
    assert nbytes <= 48 * 1024
    assert min_blocks * (nbytes + 1024) <= 228 * 1024
    # Threads' first ranks a run apart fall on distinct banks: a half warp
    # of 8-byte accesses (a pair, or at width 64 one value) covers all 32.
    r = np.arange(16) * run
    s = r % ring + (r % ring) // 16
    assert len(set((s * 2) % 32)) == 16


def _rol64_halves(x, r):
    """The kernel's width-64 rotate on numpy uint64: the 32-bit halves
    swapped where bit 5 of the u32 amount is set, then one funnel shift
    each by the amount's low 5 bits."""
    r = np.asarray(r, dtype=np.uint64)
    lo, hi = x & np.uint64(MASK32), x >> np.uint64(32)
    swap = (r & np.uint64(32)) != 0
    lo, hi = np.where(swap, hi, lo), np.where(swap, lo, hi)
    s = r & np.uint64(31)
    m = np.uint64(MASK32)
    new_hi = ((hi << s) | (lo >> (np.uint64(32) - s))) & m  # __funnelshift_l(lo, hi, s)
    new_lo = ((lo << s) | (hi >> (np.uint64(32) - s))) & m  # __funnelshift_l(hi, lo, s)
    return (new_hi << np.uint64(32)) | new_lo


def _rol64_below32(x, n):
    """By n < 32, without a swap: __funnelshift_l on each half."""
    n = np.asarray(n, dtype=np.uint64)
    lo, hi = x & np.uint64(MASK32), x >> np.uint64(32)
    m = np.uint64(MASK32)
    new_hi = ((hi << n) | (lo >> (np.uint64(32) - n))) & m
    new_lo = ((lo << n) | (hi >> (np.uint64(32) - n))) & m
    return (new_hi << np.uint64(32)) | new_lo


def _ror64_below32(x, n):
    """By -n, n < 32, without a swap: __funnelshift_r on each half."""
    n = np.asarray(n, dtype=np.uint64)
    lo, hi = x & np.uint64(MASK32), x >> np.uint64(32)
    m = np.uint64(MASK32)
    new_hi = ((hi >> n) | (lo << (np.uint64(32) - n))) & m  # __funnelshift_r(hi, lo, n)
    new_lo = ((lo >> n) | (hi << (np.uint64(32) - n))) & m  # __funnelshift_r(lo, hi, n)
    return (new_hi << np.uint64(32)) | new_lo


def _as_torch(x):
    return torch.from_numpy(x.view(np.int64))


@pytest.mark.parametrize("amounts", ["0-63", "64-and-up", "negated"])
def test_rotate_on_halves_equals_rol64(amounts):
    """Every amount 0..63, amounts of 64 and more up to 2^32 - 1, and the
    negated amounts the kernel passes (0u - r, as a u32), on random
    values and on ones with a single bit set."""
    rng = np.random.default_rng(64)
    x = np.concatenate([rng.integers(0, 1 << 64, 512, dtype=np.uint64, endpoint=False),
                        np.uint64(1) << np.arange(64, dtype=np.uint64)])
    if amounts == "0-63":
        rs = np.arange(64)
    elif amounts == "64-and-up":
        rs = np.concatenate([np.arange(64, 256), rng.integers(256, 1 << 32, 64),
                             [(1 << 32) - 1, (1 << 31) + 37]])
    else:
        rs = (-np.concatenate([np.arange(64), rng.integers(64, 1 << 31, 64)])) % (1 << 32)
    for r in rs.tolist():
        want = rol64(_as_torch(x), r)
        assert torch.equal(_as_torch(_rol64_halves(x, r)), want), r
        if r < 32:  # step a's amounts: n and -n for a rank inside a run
            assert torch.equal(_as_torch(_rol64_below32(x, r)), want)
            assert torch.equal(_as_torch(_ror64_below32(x, r)), rol64(_as_torch(x), -r))


@pytest.mark.parametrize("l", [2, 31, 255])
@pytest.mark.parametrize("base", [0, TOP_BASE])
def test_width64_frames_give_the_window_hashes(l, base):
    """Width 64 as the kernel runs it: each run's (n, f, r) from the
    recurrences of G and Q from 0, turned back; the block scan with the
    counts first; then G(r) = rol(PF(r), r) and Q(r) = rol(PR(r), l - 1 - r)
    by their recurrences from G(first - 1) and Q(first - 1).  Every kept
    rank's G and Q equal the direct ones, and every window's hash from them
    (G(w) ^ rol(G(f - 1), l), Q(w) ^ rol(Q(f - 1), -l)) equals NtHash's
    sums over the window's l terms."""
    run, threads, _ = SHAPES[64]
    rng = np.random.default_rng(l + base)
    steps = 3
    seed_f, seed_r = _values(rng, 64, 8), _values(rng, 64, 8)
    term_r = rol64(seed_r, l - 1)  # the kernel's table: (seed[c], rol(seed'[c], l - 1))
    codes = torch.from_numpy(rng.integers(0, 8, (steps, threads, run)))
    kept = torch.from_numpy(rng.random((steps, threads, run)) < 0.75)
    kept[1, :40] = False  # threads that keep nothing

    def rot1(x, k, sign):  # rotate by k in {0, 1}
        return torch.where(k, rol64(x, sign), x)

    lane = torch.arange(threads) % WARP
    pb_f = pb_r = torch.tensor(0)
    b = base
    g_of, q_of = {base - 1: 0}, {base - 1: 0}
    for s in range(steps):
        k, c = kept[s], codes[s]
        hf = hr = torch.zeros(threads, dtype=torch.int64)
        for i in range(run):  # step a
            hf = rot1(hf, k[:, i], 1) ^ torch.where(k[:, i], seed_f[c[:, i]], 0)
            hr = rot1(hr, k[:, i], -1) ^ torch.where(k[:, i], term_r[c[:, i]], 0)
        n = k.sum(-1)
        own = (n, rol64(hf, 1 - n), rol64(hr, n - l))
        cnt, o = n.clone(), 1  # step b: counts first, then XOR scans
        while o < WARP:
            cnt = torch.where(lane >= o, cnt + torch.roll(cnt, o), cnt)
            o <<= 1
        en = cnt - n
        moved = (rol64(own[1], -en), rol64(own[2], en))
        inc = []
        for x in moved:
            o = 1
            while o < WARP:
                x = torch.where(lane >= o, x ^ torch.roll(x, o), x)
                o <<= 1
            inc.append(x)
        exc = (en, inc[0] ^ moved[0], inc[1] ^ moved[1])
        total, before = (torch.tensor(0), torch.tensor(0), torch.tensor(0)), []
        for wp in range(threads // WARP):
            before.append(total)
            last = wp * WARP + WARP - 1
            total = _then(rol64, total, (cnt[last], inc[0][last], inc[1][last]))
        warp_of = torch.arange(threads) // WARP
        bw = tuple(torch.stack([x[j] for x in before])[warp_of] for j in range(3))
        bt = _then(rol64, bw, exc)
        first = b + bt[0]
        bf = pb_f ^ rol64(bt[1], -b)
        br = pb_r ^ rol64(bt[2], b)
        g, q = rol64(bf, first - 1), rol64(br, l - first)  # step c
        r = first.clone()
        for i in range(run):
            g = rot1(g, k[:, i], 1) ^ torch.where(k[:, i], seed_f[c[:, i]], 0)
            q = rot1(q, k[:, i], -1) ^ torch.where(k[:, i], term_r[c[:, i]], 0)
            for t in torch.nonzero(k[:, i]).flatten().tolist():
                g_of[int(r[t])], q_of[int(r[t])] = int(g[t]), int(q[t])
            r = r + k[:, i]
        pb_f = pb_f ^ rol64(total[1], -b)
        pb_r = pb_r ^ rol64(total[2], b)
        b = b + int(total[0])
    ranks = torch.arange(base, b)
    flat = codes.reshape(-1)[kept.reshape(-1)]
    pf = _xor_prefix(rol64(seed_f[flat], -ranks))
    pr = _xor_prefix(rol64(seed_r[flat], ranks))
    assert torch.equal(torch.tensor([g_of[x] for x in ranks.tolist()]), rol64(pf, ranks))
    assert torch.equal(torch.tensor([q_of[x] for x in ranks.tolist()]), rol64(pr, l - 1 - ranks))
    for f in range(base, b - l + 1):
        w = f + l - 1
        fh = g_of[w] ^ int(rol64(torch.tensor(g_of[f - 1]), l))
        rh = q_of[w] ^ int(rol64(torch.tensor(q_of[f - 1]), -l))
        j = torch.arange(l)
        want_f = _xor_prefix(rol64(seed_f[flat[f - base:f - base + l]], l - 1 - j))[-1]
        want_r = _xor_prefix(rol64(seed_r[flat[f - base:f - base + l]], j))[-1]
        assert (fh, rh) == (int(want_f), int(want_r)), f
