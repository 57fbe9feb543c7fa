"""The port's encoders of sequence text against the reference package's:
the device encoder's plain version (``ops/xcode.py``), the host library
(``io/native_ext.py`` over ``io/native/rle.cpp``) behind
``constants.encode_xcodes`` and ``hpc_strings``, the byte view of a str,
and the entry points that take text (``kminmers_long_batch``,
``kminmers_list``), which encode it on their device and never on the
host.  Every output is an integer or a str: equality is exact."""

import ctypes
import gc

import jax  # noqa: F401  (the reference package's own import, made explicit)
import numpy as np
import pytest
import torch

from rust_seq2kminmers_torch import constants, hpc_strings, kminmers_list
from rust_seq2kminmers_torch import kminmers_long, kminmers_long_batch
from rust_seq2kminmers_torch.constants import XCODE_PAD, byte_view, code_table
from rust_seq2kminmers_torch.io import gxx, native_ext
from rust_seq2kminmers_torch.ops.cuda.xcode import encode_xcodes_cuda
from rust_seq2kminmers_torch.ops.long_read import (
    minimizer_stream_long,
    minimizer_stream_long_batch,
)
from rust_seq2kminmers_torch.ops.pipeline import PipelineSpec
from rust_seq2kminmers_torch.ops.xcode import READ_START, XCODE_ROW, encode_xcodes_plain
from rust_seq2kminmers_tpu import constants as jc
from rust_seq2kminmers_tpu import hpc_strings as jh
from rust_seq2kminmers_tpu.io.native_ext import load_ext
from rust_seq2kminmers_tpu.ops import long_read as jax_long

FAMILIES = ["scalar", "simd"]
ALPHABET = np.frombuffer(b"ACGTNacgtnRY*-\x00\xff", dtype=np.uint8)


def _texts(rng):
    """Byte strings: every byte value, runs of bases in both cases and of
    N, and lengths around 4096 (the host library's threshold)."""
    every = np.arange(256, dtype=np.uint8)
    runs = np.repeat(rng.choice(ALPHABET, 3000), rng.integers(1, 7, 3000))
    out = [b"", b"A", b"AA", b"aAaA", b"NNnnACGTTTT", every.tobytes(),
           np.repeat(every, 3).tobytes(), runs.tobytes()]
    out += [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (4095, 4096, 4097)]
    out += [rng.choice(ALPHABET, n).tobytes() for n in (1, 127, 128, 129, 20000)]
    return out


def _rows(rng, lengths):
    """uint8 rows with runs, lowercase, N and every byte value."""
    rows = []
    for n in lengths:
        pick = rng.choice(np.concatenate([ALPHABET, np.arange(256, dtype=np.uint8)]), n)
        rows.append(np.repeat(pick, rng.integers(1, 5, n))[:n].astype(np.uint8))
    return rows


# ---- the device encoder's plain version ----------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_equals_reference_row_by_row(family):
    """Ragged rows (lengths 0, 1, 17, 4095, 4096, 4097) of one [B, C]
    batch: each row's first length_local bytes encode as the reference's
    encode_xcodes of that row, and the rest is XCODE_PAD."""
    rng = np.random.default_rng(1)
    lengths = [0, 1, 17, 4095, 4096, 4097]
    rows = _rows(rng, lengths)
    C = 4112
    raw = rng.integers(0, 256, (len(rows), C), dtype=np.uint8)  # junk past each length
    for b, r in enumerate(rows):
        raw[b, : len(r)] = r
    start = torch.full((len(rows),), READ_START, dtype=torch.int32)
    got = encode_xcodes_plain(torch.from_numpy(raw), start,
                              torch.tensor(lengths, dtype=torch.int32), family).numpy()
    for b, r in enumerate(rows):
        np.testing.assert_array_equal(got[b, : len(r)], jc.encode_xcodes(r, family))
        assert (got[b, len(r):] == XCODE_PAD).all()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("chunk", [16, 1000, 4096])
def test_plain_chunks_continue_the_row(family, chunk):
    """A read cut into chunks, each encoded with ``prev`` the byte before
    it (READ_START at the read's start), gives the reference's encoding of
    the whole read; a run that a cut splits stays collapsed.  A row marked
    XCODE_ROW holds xcodes and is copied."""
    rng = np.random.default_rng(2)
    rows = _rows(rng, [9001, 5000])
    rows[1][990:1010] = ord("A")  # a run across the cut at 1000
    want = [jc.encode_xcodes(r, family) for r in rows]
    rows.append(want[0])  # a row of xcodes, passed through
    n_max = max(len(r) for r in rows)
    got = [[] for _ in rows]
    for lo in range(0, n_max, chunk):
        raw = np.zeros((len(rows), chunk), dtype=np.uint8)
        local = np.clip([len(r) - lo for r in rows], 0, chunk).astype(np.int32)
        prev = np.array([r[lo - 1] if 0 < lo <= len(r) else READ_START for r in rows[:2]]
                        + [XCODE_ROW], dtype=np.int32)
        for b, r in enumerate(rows):
            raw[b, : local[b]] = r[lo : lo + local[b]]
        out = encode_xcodes_plain(torch.from_numpy(raw), torch.from_numpy(prev),
                                  torch.from_numpy(local), family).numpy()
        for b in range(len(rows)):
            got[b].append(out[b, : local[b]])
            assert (out[b, local[b]:] == XCODE_PAD).all()
    for b, w in enumerate(want + [want[0]]):
        np.testing.assert_array_equal(np.concatenate(got[b]), w)


def test_wrapper_on_the_cpu_and_its_checks():
    """On CPU tensors the wrapper is the plain version; a wrong dtype or
    shape, or an unknown family, raises."""
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, (3, 64), dtype=np.uint8))
    prev = torch.tensor([READ_START, 65, XCODE_ROW], dtype=torch.int32)
    length = torch.tensor([64, 10, 0], dtype=torch.int32)
    assert torch.equal(encode_xcodes_cuda(raw, prev, length, "simd"),
                       encode_xcodes_plain(raw, prev, length, "simd"))
    with pytest.raises(TypeError):
        encode_xcodes_cuda(raw.to(torch.int32), prev, length, "simd")
    with pytest.raises(ValueError):
        encode_xcodes_cuda(raw, prev[:2], length, "simd")
    with pytest.raises(ValueError, match="family"):
        encode_xcodes_cuda(raw, prev, length, "nibble")


# ---- the byte view ----------------------------------------------------------------


def test_byte_view_reads_an_ascii_str_in_place():
    """An ASCII str is viewed where CPython keeps it, read-only, and the
    view keeps the str alive after the caller drops it."""
    s = "ACGT" * 1000 + "".join(chr(65 + i % 26) for i in range(999))
    v = byte_view(s)
    size = ctypes.c_ssize_t()
    addr = constants._utf8_and_size(s, ctypes.byref(size))
    assert v.ctypes.data == addr and len(v) == len(s) and not v.flags.writeable
    want = s.encode()
    del s
    gc.collect()
    assert v.tobytes() == want


@pytest.mark.parametrize("obj", [
    "ÀÉacgtÿ", b"ACGT\x00\xff", bytearray(b"acgtN"), memoryview(b"NNNA"),
    np.frombuffer(b"TTTT", dtype=np.uint8), "",
])
def test_byte_view_of_other_inputs(obj):
    """A latin-1 str as latin-1; bytes-like objects and uint8 arrays as
    their bytes."""
    want = obj.encode("latin-1") if isinstance(obj, str) else bytes(obj)
    got = byte_view(obj)
    assert got.dtype == np.uint8 and got.tobytes() == want


def test_byte_view_outside_latin1():
    """A str outside latin-1 raises as the reference's encode_xcodes does,
    or with utf8 is read as its UTF-8 bytes (the string API's rule)."""
    s = "ACGT→α" * 1000
    with pytest.raises(UnicodeEncodeError):
        byte_view(s)
    assert byte_view(s, utf8=True).tobytes() == s.encode()
    for fn in (constants.encode_xcodes, jc.encode_xcodes):
        for t in (s, s[:10]):
            with pytest.raises(UnicodeEncodeError):
                fn(t)


# ---- the host library ---------------------------------------------------------------


def _as(kind, b: bytes):
    return {"bytes": b, "bytearray": bytearray(b), "memoryview": memoryview(b),
            "ndarray": np.frombuffer(b, dtype=np.uint8)}[kind]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "ndarray", "str"])
def test_encode_xcodes_equals_reference(family, kind):
    """``constants.encode_xcodes`` (the library from 4096 bytes on) equals
    the reference's, and the library's AVX-512 and scalar kernels both
    equal the numpy body, on every input kind."""
    rng = np.random.default_rng(4)
    for b in _texts(rng):
        if kind == "str":
            b = bytes(c & 0x7F for c in b)  # ASCII: read in place
        x = b.decode("latin-1") if kind == "str" else _as(kind, b)
        got = constants.encode_xcodes(x, family)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jc.encode_xcodes(x, family))
        arr = np.frombuffer(b, dtype=np.uint8)
        want = constants._encode_xcodes_numpy(arr, code_table(family))
        for scalar in (False, True):
            np.testing.assert_array_equal(native_ext.xcode(arr, code_table(family), scalar), want)


def test_encode_xcodes_latin1_str():
    """A str of latin-1 characters past ASCII is encoded from its latin-1
    bytes, as the reference does."""
    rng = np.random.default_rng(5)
    s = bytes(rng.integers(0, 256, 6000, dtype=np.uint8)).decode("latin-1")
    for family in FAMILIES:
        np.testing.assert_array_equal(constants.encode_xcodes(s, family),
                                      jc.encode_xcodes(s, family))


def _plain_rle(b: bytes, collapse_any: bool, wide: bool):
    chars, pos = hpc_strings._rle(b, collapse_any)
    return chars, pos.astype(np.int64 if wide else np.int32)


@pytest.mark.parametrize("collapse_any", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_library_rle_equals_plain_and_reference(collapse_any, wide):
    """The collapse at 32- and 64-bit positions, AVX-512 and scalar, with
    and without positions, equals the numpy plain version and the
    reference's extension, on every text (and one of 5 MB, past the
    threshold of the threaded store)."""
    ext = load_ext()
    rng = np.random.default_rng(6)
    big = np.repeat(rng.choice(ALPHABET, 3 << 20), rng.integers(1, 3, 3 << 20))[: 5 << 20]
    for b in _texts(rng) + [big.tobytes()]:
        want = _plain_rle(b, collapse_any, wide)
        if ext is not None:
            ref = ext.rle(b, int(collapse_any), int(wide), 1)
            assert ref[0] == want[0]
            np.testing.assert_array_equal(ref[1], want[1])
        arr = np.frombuffer(b, dtype=np.uint8)
        for scalar in (False, True):
            chars, pos = native_ext.rle(arr, collapse_any, wide, True, scalar)
            assert chars == want[0] and pos.dtype == want[1].dtype
            np.testing.assert_array_equal(pos, want[1])
            assert native_ext.rle(arr, collapse_any, wide, False, scalar) == (want[0], None)


def test_library_runs_avx512_where_the_cpu_has_it():
    """The library's default path is AVX-512 exactly where the CPU has the
    instructions (so the tests above, which ask for both paths, ran both
    where it does)."""
    flags = set(gxx.cpu_flags().decode().split())
    assert native_ext.avx512() == {
        "rle": {"avx512vbmi", "avx512_vbmi2"} <= flags,
        "xcode": "avx512vbmi" in flags,
    }


@pytest.mark.parametrize("name", ["hpc", "encode_rle", "encode_rle_simd"])
@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "ndarray"])
def test_string_api_on_bytes_like_inputs(name, kind):
    """The string API through the library equals the reference's on every
    bytes-like kind."""
    rng = np.random.default_rng(7)
    for b in _texts(rng):
        x = _as(kind, b)
        mine, ref = getattr(hpc_strings, name)(x), getattr(jh, name)(x)
        if name == "hpc":
            assert mine == ref
        else:
            assert mine[0] == ref[0] and mine[1].dtype == ref[1].dtype
            np.testing.assert_array_equal(mine[1], ref[1])


@pytest.mark.parametrize("name", ["hpc", "encode_rle", "encode_rle_simd"])
def test_string_api_on_strs(name):
    """ASCII (read in place), latin-1 past ASCII, and outside latin-1 (read
    as UTF-8 by both packages)."""
    rng = np.random.default_rng(8)
    strs = [bytes(c & 0x7F for c in b).decode() for b in _texts(rng)]
    strs += [bytes(rng.integers(0, 256, 5000, dtype=np.uint8)).decode("latin-1"),
             "ACGT→→TTA" * 600, "ααβAAC"]
    for s in strs:
        mine, ref = getattr(hpc_strings, name)(s), getattr(jh, name)(s)
        if name == "hpc":
            assert mine == ref
        else:
            assert mine[0] == ref[0] and mine[1].dtype == ref[1].dtype
            np.testing.assert_array_equal(mine[1], ref[1])


def test_rle_loop_and_its_32_bit_guard():
    """The in-library loop times passes; 32-bit positions refuse an input
    of 2^31 bytes before reading it (the entry is given one byte and told
    2^31), in the loop and in the store."""
    arr = np.frombuffer(b"ACGTTTAC" * 1000, dtype=np.uint8)
    iters, ns = native_ext.rle_loop(arr, True, False, True, 1)
    assert iters >= 1 and ns >= 1_000_000
    lib, one = native_ext.library(), np.zeros(1, dtype=np.uint8)
    iters_c, ns_c = ctypes.c_int64(), ctypes.c_int64()
    err = lib.s2k_rle_loop(native_ext._addr(one), 1 << 31, 1, 4, 1, 1, 0,
                           ctypes.byref(iters_c), ctypes.byref(ns_c))
    assert err == 2 and iters_c.value == 0
    plan = np.zeros(lib.s2k_rle_plan_words(), dtype=np.int64)
    out = np.zeros(1, dtype=np.uint8)
    assert lib.s2k_rle_store(native_ext._addr(plan), native_ext._addr(one), 1 << 31, 1,
                             native_ext._addr(out), native_ext._addr(np.zeros(1, np.int32)),
                             4) == 2
    with pytest.raises(OverflowError):
        native_ext._check(2, "s2k_rle_loop")


def test_failed_library_build_raises(monkeypatch, tmp_path):
    """A library that does not build raises with g++'s message, from the
    string API and from encode_xcodes: nothing falls back to numpy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_ext, "SOURCE", bad)
    monkeypatch.setattr(native_ext, "BUILD_DIR", tmp_path / "build")
    native_ext.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            hpc_strings.hpc("ACGT")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            constants.encode_xcodes("ACGT" * 2000)
        assert constants.encode_xcodes("ACGT").shape == (4,)  # below 4096: numpy
    finally:
        monkeypatch.undo()
        native_ext.library.cache_clear()


# ---- text through the entry points, encoded on their device -----------------------------


@pytest.fixture
def no_host_encoding(monkeypatch):
    """Every host xcode encoder raises: the paths under test must not call
    them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host xcode encoder was called")

    monkeypatch.setattr(constants, "encode_xcodes", refuse)
    monkeypatch.setattr(constants, "_encode_xcodes_numpy", refuse)
    monkeypatch.setattr(native_ext, "xcode", refuse)


def _runs_text(seed, n):
    """ACGTN text with lowercase and homopolymer runs of up to 700."""
    rng = np.random.default_rng(seed)
    parts, m = [], 0
    while m < n:
        p = (str(rng.choice(list("ACGTa"))) * int(rng.integers(2, 700))
             if rng.random() < 0.2 else "".join(rng.choice(list("ACGTNacgt"), 60)))
        parts.append(p)
        m += len(p)
    return "".join(parts)[:n]


KEYS = ("hash", "start", "end", "offset", "rev")


def _same(got, want):
    for key in KEYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_long_read_from_text_equals_xcodes_and_reference(mode, no_host_encoding):
    """kminmers_long_batch on the CPU from text (a str and bytes) equals the
    same reads as xcodes and the reference's run, in a batch that mixes
    text and an xcode row, at chunks of 1024 that split homopolymer runs;
    so do kminmers_long and the minimizer streams; no host encoder of the
    port runs."""
    seqs = [_runs_text(9, 7000), _runs_text(10, 3000)]
    for s in seqs:  # some chunk boundary falls inside a run
        assert any(s[c - 1] == s[c] for c in range(1024, len(s), 1024))
    family = "simd" if mode == "hpcsimd" else "scalar"
    xcodes = [jc.encode_xcodes(s, family) for s in seqs]
    kw = dict(l=13, k=3, density=0.1, mode=mode, chunk=1024)
    want = jax_long.kminmers_long_batch(seqs, interpret=True, **kw)
    from_x = kminmers_long_batch(xcodes, device="cpu", **kw)
    from_text = kminmers_long_batch(seqs, device="cpu", **kw)
    mixed = kminmers_long_batch([seqs[0].encode(), xcodes[1]], device="cpu", **kw)
    one = kminmers_long(seqs[1], device="cpu", **kw)
    for b in range(2):
        assert len(want[b]["hash"]) > 20
        for got in (from_x[b], from_text[b], mixed[b]):
            _same(got, want[b])
    _same(one, want[1])
    spec = PipelineSpec(l=13, k=3, density=0.1, mode=mode)
    streams = [minimizer_stream_long_batch(rows, spec, chunk=1024, device="cpu")
               for rows in (xcodes, seqs, [seqs[0].encode(), bytearray(seqs[1].encode())])]
    for b in range(2):
        assert len(streams[0][b][0]) > 20
        for got in streams[1:]:
            for g, w in zip(got[b], streams[0][b]):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(minimizer_stream_long(seqs[1], spec, chunk=1024, device="cpu"),
                    streams[0][1]):
        assert np.array_equal(g, w)


def test_kminmers_list_from_text_equals_oracle(no_host_encoding):
    """kminmers_list on the CPU from a str and from bytes (encoded by the
    device path's plain version) equals backend="oracle"."""
    seq = _runs_text(11, 5000)
    for mode in ("regular", "simd", "hpc", "hpcsimd"):
        want = kminmers_list(seq, 11, 3, 0.1, mode, backend="oracle")
        assert len(want) > 20
        for x in (seq, seq.encode()):
            assert kminmers_list(x, 11, 3, 0.1, mode, device="cpu") == want
