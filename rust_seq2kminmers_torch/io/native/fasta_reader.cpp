// Native multithreaded FASTA/FASTQ reader and base packer.
//
// The port's own copy of the reference package's reader
// (rust_seq2kminmers_tpu/io/native/fasta_reader.cpp), in place of the
// reference crate's rust-parallelfastx (src/main.rs:5,79): mmap the file,
// index record boundaries, and pack bases into caller-allocated padded
// [batch, max_len] uint8 arrays with one worker thread per CPU, ready for
// the copy to the device.  The xcode packers write (keep << 3) | code,
// keep being the raw-byte != previous-raw-byte flag.
//
// A plain C API, loaded from Python with ctypes (rust_seq2kminmers_torch/
// io/fasta.py), which builds it with g++ on first use.

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint8_t CODE_OTHER = 5;
constexpr uint8_t CODE_PAD = 6;

struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    for (int i = 0; i < 256; i++) t[i] = CODE_OTHER;
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['G'] = t['g'] = 2;
    t['T'] = t['t'] = 3;
    t['N'] = t['n'] = 4;
  }
};
const CodeTable kCodes;

struct Record {
  uint64_t name_off, name_len;
  uint64_t seq_off;    // offset of first sequence byte
  uint64_t seq_end;    // one past last sequence line byte (may span lines)
  uint64_t seq_len;    // total bases (newlines excluded)
  bool multiline;
};

struct File {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  bool fastq = false;
  std::vector<Record> records;
};

// Scan one record starting at a '>' (FASTA) or '@' (FASTQ) header.
const char* find_eol(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  return nl ? nl : end;
}

void index_fasta(File* f) {
  const char* p = f->data;
  const char* end = f->data + f->size;
  while (p < end && *p != '>') p = find_eol(p, end) + 1;
  while (p < end) {
    Record r{};
    const char* hdr_end = find_eol(p, end);
    r.name_off = (p + 1) - f->data;
    r.name_len = hdr_end - (p + 1);
    const char* sp = hdr_end < end ? hdr_end + 1 : end;
    r.seq_off = sp - f->data;
    uint64_t len = 0;
    int lines = 0;
    const char* q = sp;
    while (q < end && *q != '>') {
      const char* eol = find_eol(q, end);
      len += eol - q;
      lines++;
      q = eol + 1;
    }
    r.seq_end = std::min<uint64_t>(q - f->data, f->size);
    r.seq_len = len;
    r.multiline = lines > 1;
    f->records.push_back(r);
    p = q;
  }
}

void index_fastq(File* f) {
  const char* p = f->data;
  const char* end = f->data + f->size;
  while (p < end) {
    if (*p != '@') {  // tolerate stray blank lines
      p = find_eol(p, end) + 1;
      continue;
    }
    Record r{};
    const char* hdr_end = find_eol(p, end);
    r.name_off = (p + 1) - f->data;
    r.name_len = hdr_end - (p + 1);
    const char* sp = hdr_end + 1;
    const char* seq_end = find_eol(sp, end);
    r.seq_off = sp - f->data;
    r.seq_end = seq_end - f->data;
    r.seq_len = seq_end - sp;
    r.multiline = false;
    f->records.push_back(r);
    const char* plus = seq_end + 1;              // '+' line
    const char* plus_end = find_eol(plus, end);
    const char* qual_end = find_eol(plus_end + 1, end);
    p = qual_end + 1;
  }
}

template <typename T>
void pack_one(const File& f, const Record& r, const T* table, T pad, T* out,
              int64_t max_len, int64_t* out_len) {
  const char* s = f.data + r.seq_off;
  int64_t n = 0;
  if (!r.multiline) {
    int64_t take = std::min<int64_t>(r.seq_len, max_len);
    for (int64_t i = 0; i < take; i++)
      out[i] = table[static_cast<uint8_t>(s[i])];
    n = take;
  } else {
    const char* end = f.data + r.seq_end;
    const char* q = s;
    while (q < end && n < max_len) {
      const char* eol = find_eol(q, end);
      int64_t take = std::min<int64_t>(eol - q, max_len - n);
      for (int64_t i = 0; i < take; i++)
        out[n + i] = table[static_cast<uint8_t>(q[i])];
      n += take;
      q = eol + 1;
    }
  }
  for (int64_t i = n; i < max_len; i++) out[i] = pad;
  *out_len = n;
}

// xcode pack: one uint8 per base, (keep << 3) | hash_code3, where keep is
// the raw-byte != previous-raw-byte flag (keep = 1 at base 0) — the HPC
// run boundary precomputed against raw bytes exactly as the reference
// compares them (reference src/nthash_hpc.rs:253-263, src/hpc.rs:88).
// See constants.py for the format contract.
void pack_one_x(const File& f, const Record& r, const uint8_t* table,
                uint8_t pad, uint8_t* out, int64_t max_len,
                int64_t* out_len) {
  const char* s = f.data + r.seq_off;
  int64_t n = 0;
  int prev = -1;  // no previous byte: first base always keeps
  if (!r.multiline) {
    int64_t take = std::min<int64_t>(r.seq_len, max_len);
    for (int64_t i = 0; i < take; i++) {
      uint8_t c = static_cast<uint8_t>(s[i]);
      out[i] = table[c] | ((c != prev) << 3);
      prev = c;
    }
    n = take;
  } else {
    const char* end = f.data + r.seq_end;
    const char* q = s;
    while (q < end && n < max_len) {
      const char* eol = find_eol(q, end);
      int64_t take = std::min<int64_t>(eol - q, max_len - n);
      for (int64_t i = 0; i < take; i++) {
        uint8_t c = static_cast<uint8_t>(q[i]);
        out[n + i] = table[c] | ((c != prev) << 3);
        prev = c;
      }
      n += take;
      q = eol + 1;
    }
  }
  for (int64_t i = n; i < max_len; i++) out[i] = pad;
  *out_len = n;
}

template <typename T>
int64_t pack_range(File* f, int64_t first, int64_t count, int64_t max_len,
                   const T* table, T pad, T* codes, int64_t* lengths,
                   int64_t threads) {
  int64_t n_rec = f->records.size();
  if (first >= n_rec) return 0;
  count = std::min(count, n_rec - first);
  if (threads <= 0)
    threads = std::max(1u, std::thread::hardware_concurrency());
  threads = std::min<int64_t>(threads, count);

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= count) return;
      pack_one<T>(*f, f->records[first + i], table, pad, codes + i * max_len,
                  max_len, &lengths[i]);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return count;
}

}  // namespace

extern "C" {

// Open + index. Returns an opaque handle, or nullptr on failure.
void* s2k_open(const char* path) {
  File* f = new File();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) {
    delete f;
    return nullptr;
  }
  struct stat st;
  fstat(f->fd, &st);
  f->size = st.st_size;
  if (f->size == 0) {
    close(f->fd);
    delete f;
    return nullptr;
  }
  f->data = static_cast<const char*>(
      mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0));
  if (f->data == MAP_FAILED) {
    close(f->fd);
    delete f;
    return nullptr;
  }
  madvise(const_cast<char*>(f->data), f->size, MADV_SEQUENTIAL);
  f->fastq = f->data[0] == '@';
  if (f->fastq)
    index_fastq(f);
  else
    index_fasta(f);
  return f;
}

int64_t s2k_num_records(void* h) {
  return static_cast<File*>(h)->records.size();
}

int64_t s2k_max_seq_len(void* h) {
  File* f = static_cast<File*>(h);
  uint64_t m = 0;
  for (const auto& r : f->records) m = std::max(m, r.seq_len);
  return m;
}

int64_t s2k_seq_len(void* h, int64_t i) {
  return static_cast<File*>(h)->records[i].seq_len;
}

// Bulk record lengths into a caller-allocated int64[num_records] buffer.
void s2k_seq_lens(void* h, int64_t* out) {
  File* f = static_cast<File*>(h);
  for (size_t i = 0; i < f->records.size(); i++) out[i] = f->records[i].seq_len;
}

int64_t s2k_name(void* h, int64_t i, char* buf, int64_t cap) {
  File* f = static_cast<File*>(h);
  const Record& r = f->records[i];
  int64_t n = std::min<int64_t>(r.name_len, cap);
  memcpy(buf, f->data + r.name_off, n);
  return n;
}

// Pack records [first, first+count) into codes[count, max_len] (uint8,
// caller-allocated, row-major) and lengths[count] (int64), using up to
// `threads` worker threads.  Returns count actually packed.  Legacy
// quantized-code format (case-folded, all non-ACGTN -> OTHER).
int64_t s2k_pack(void* h, int64_t first, int64_t count, int64_t max_len,
                 uint8_t* codes, int64_t* lengths, int64_t threads) {
  return pack_range<uint8_t>(static_cast<File*>(h), first, count, max_len,
                             kCodes.t, CODE_PAD, codes, lengths, threads);
}

// Same, but in the exact-fidelity uint8 xcode format ((raw-byte-diff keep
// << 3) | hash_code3) through a caller-provided 256-entry byte->code3
// table (per mode family, see constants.py) and an explicit pad value.
int64_t s2k_packx(void* h, int64_t first, int64_t count, int64_t max_len,
                  const uint8_t* table, uint8_t pad, uint8_t* codes,
                  int64_t* lengths, int64_t threads) {
  File* f = static_cast<File*>(h);
  int64_t n_rec = f->records.size();
  if (first >= n_rec) return 0;
  count = std::min(count, n_rec - first);
  if (threads <= 0)
    threads = std::max(1u, std::thread::hardware_concurrency());
  threads = std::min<int64_t>(threads, count);

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= count) return;
      pack_one_x(*f, f->records[first + i], table, pad, codes + i * max_len,
                 max_len, &lengths[i]);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return count;
}

// Gather-pack: arbitrary record indices (for length-bucketed batching in
// the streaming CLI) instead of a contiguous [first, first+count) range.
int64_t s2k_packx_idx(void* h, const int64_t* indices, int64_t count,
                      int64_t max_len, const uint8_t* table, uint8_t pad,
                      uint8_t* codes, int64_t* lengths, int64_t threads) {
  File* f = static_cast<File*>(h);
  int64_t n_rec = f->records.size();
  if (threads <= 0)
    threads = std::max(1u, std::thread::hardware_concurrency());
  threads = std::min<int64_t>(threads, count);
  if (count <= 0) return 0;

  std::atomic<int64_t> next(0);
  std::atomic<int64_t> ok(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= count) return;
      int64_t r = indices[i];
      if (r < 0 || r >= n_rec) {
        memset(codes + i * max_len, pad, max_len);
        lengths[i] = 0;
        continue;
      }
      pack_one_x(*f, f->records[r], table, pad, codes + i * max_len,
                 max_len, &lengths[i]);
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return ok.load();
}

}  // extern "C"

extern "C" {

void s2k_close(void* h) {
  File* f = static_cast<File*>(h);
  if (f->data && f->data != MAP_FAILED)
    munmap(const_cast<char*>(f->data), f->size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
