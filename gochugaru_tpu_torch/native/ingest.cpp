// Native ingest layer: batch string interning + parallel lexicographic
// sort for columnar snapshot builds.
//
// Role in the framework: the reference (authzed/gochugaru) is a pure-Go
// client whose server does all heavy lifting; in this TPU-native redesign
// the host-side ingest — interning (type, object-id) strings to dense
// int32 node ids and sorting edge columns into the device's binary-search
// layout — is the bottleneck at 100M-1B edges (SURVEY.md §7 "interning
// throughput at 1B edges is the real bottleneck").  This is the runtime
// piece that earns native code: a C ABI (consumed via ctypes, no pybind11
// in the image) wrapping
//   * an open-addressing string interner with an append-only arena, and
//   * an OpenMP-parallel sort over packed 93-bit (rel,res,subj,srel1) keys.
//
// Thread-safety: the interner is single-writer (callers serialize mutating
// calls — the Python side holds its store lock); reads of immutable
// prefixes are safe.  Sorting is stateless.
//
// Build: g++ -O3 -shared -fPIC -fopenmp ingest.cpp -o libgochugaru_ingest.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

inline uint64_t hash_bytes(const char* data, uint64_t len, uint64_t seed) {
  // FNV-1a, then a final mix (good enough for open addressing; inputs are
  // short object ids)
  uint64_t h = 1469598103934665603ull ^ (seed * 0x9e3779b97f4a7c15ull);
  for (uint64_t i = 0; i < len; i++) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ull;
  }
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  return h;
}

struct Entry {
  uint64_t hash;
  uint64_t off;
  uint32_t len;
  int32_t type;
};

struct Interner {
  std::vector<char> arena;
  std::vector<Entry> entries;   // index == node id
  std::vector<int64_t> table;   // open addressing; -1 empty, else node id
  uint64_t mask = 0;

  Interner() {
    table.assign(1 << 16, -1);
    mask = table.size() - 1;
    arena.reserve(1 << 20);
  }

  void grow() {
    std::vector<int64_t> bigger(table.size() * 2, -1);
    uint64_t m = bigger.size() - 1;
    for (int64_t node = 0; node < static_cast<int64_t>(entries.size()); node++) {
      uint64_t slot = entries[node].hash & m;
      while (bigger[slot] != -1) slot = (slot + 1) & m;
      bigger[slot] = node;
    }
    table.swap(bigger);
    mask = m;
  }

  inline bool equals(int64_t node, int32_t type, const char* s, uint32_t len,
                     uint64_t h) const {
    const Entry& e = entries[node];
    return e.hash == h && e.type == type && e.len == len &&
           std::memcmp(arena.data() + e.off, s, len) == 0;
  }

  int64_t find(int32_t type, const char* s, uint32_t len) const {
    uint64_t h = hash_bytes(s, len, static_cast<uint64_t>(type) + 1);
    uint64_t slot = h & mask;
    while (true) {
      int64_t node = table[slot];
      if (node == -1) return -1;
      if (equals(node, type, s, len, h)) return node;
      slot = (slot + 1) & mask;
    }
  }

  int64_t intern(int32_t type, const char* s, uint32_t len) {
    uint64_t h = hash_bytes(s, len, static_cast<uint64_t>(type) + 1);
    uint64_t slot = h & mask;
    while (true) {
      int64_t node = table[slot];
      if (node == -1) break;
      if (equals(node, type, s, len, h)) return node;
      slot = (slot + 1) & mask;
    }
    if ((entries.size() + 1) * 10 >= table.size() * 7) {  // 0.7 load factor
      grow();
      slot = h & mask;
      while (table[slot] != -1) slot = (slot + 1) & mask;
    }
    int64_t node = static_cast<int64_t>(entries.size());
    Entry e;
    e.hash = h;
    e.off = arena.size();
    e.len = len;
    e.type = type;
    arena.insert(arena.end(), s, s + len);
    entries.push_back(e);
    table[slot] = node;
    return node;
  }
};

}  // namespace

extern "C" {

void* gi_new() { return new Interner(); }

void gi_free(void* h) { delete static_cast<Interner*>(h); }

int64_t gi_size(void* h) {
  return static_cast<int64_t>(static_cast<Interner*>(h)->entries.size());
}

// Intern n strings: buf holds concatenated bytes, offsets has n+1 entries,
// type_ids has n entries.  Writes node ids to out.
void gi_intern_batch(void* h, const char* buf, const int64_t* offsets,
                     int64_t n, const int32_t* type_ids, int32_t* out) {
  Interner* in = static_cast<Interner*>(h);
  for (int64_t i = 0; i < n; i++) {
    out[i] = static_cast<int32_t>(in->intern(
        type_ids[i], buf + offsets[i],
        static_cast<uint32_t>(offsets[i + 1] - offsets[i])));
  }
}

// Lookup without interning; -1 when absent.
void gi_lookup_batch(void* h, const char* buf, const int64_t* offsets,
                     int64_t n, const int32_t* type_ids, int32_t* out) {
  Interner* in = static_cast<Interner*>(h);
  for (int64_t i = 0; i < n; i++) {
    out[i] = static_cast<int32_t>(in->find(
        type_ids[i], buf + offsets[i],
        static_cast<uint32_t>(offsets[i + 1] - offsets[i])));
  }
}

// Per-node type ids for nodes [0, n).
void gi_node_types(void* h, int32_t* out, int64_t n) {
  Interner* in = static_cast<Interner*>(h);
  for (int64_t i = 0; i < n && i < static_cast<int64_t>(in->entries.size()); i++)
    out[i] = in->entries[i].type;
}

// Key of one node: returns length, copies up to cap bytes into out_str and
// the type id into out_type.  Returns -1 for an invalid node.
int64_t gi_key(void* h, int64_t node, char* out_str, int64_t cap,
               int32_t* out_type) {
  Interner* in = static_cast<Interner*>(h);
  if (node < 0 || node >= static_cast<int64_t>(in->entries.size())) return -1;
  const Entry& e = in->entries[node];
  *out_type = e.type;
  int64_t n = e.len < cap ? e.len : cap;
  std::memcpy(out_str, in->arena.data() + e.off, n);
  return e.len;
}

// Batched keys: concatenated id bytes of n nodes into out_buf (cap bytes),
// with out_offsets (n+1 entries, offsets[0] = 0) and out_types (n).
// Returns the total byte length needed — when it exceeds cap, nothing is
// written beyond what fits and the caller must retry with a bigger buffer.
// Invalid nodes get length 0 and type -1.
int64_t gi_keys_batch(void* h, const int64_t* nodes, int64_t n,
                      char* out_buf, int64_t cap, int64_t* out_offsets,
                      int32_t* out_types) {
  Interner* in = static_cast<Interner*>(h);
  const int64_t sz = static_cast<int64_t>(in->entries.size());
  int64_t total = 0;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t node = nodes[i];
    if (node < 0 || node >= sz) {
      out_types[i] = -1;
      out_offsets[i + 1] = total;
      continue;
    }
    const Entry& e = in->entries[node];
    out_types[i] = e.type;
    if (total + e.len <= cap) {
      std::memcpy(out_buf + total, in->arena.data() + e.off, e.len);
    }
    total += e.len;
    out_offsets[i + 1] = total;
  }
  return total;
}

// Parallel lexsort by (a, b, c, d) — the snapshot's primary order
// (rel, res, subj, srel1).  Writes the permutation into out (int64[n]).
// Keys are packed into (hi, lo) uint64 pairs: hi = a<<32 | b-as-unsigned,
// lo = c<<32 | d-as-unsigned; int32 values are biased by 2^31 so signed
// order (e.g. srel1 = 0 for direct subjects, payload -1 never occurs in
// sort keys) is preserved under unsigned comparison.
// LSD radix passes over 16-bit digits: stable by construction and
// data-independent O(n) — a comparison sort of random 10M packed keys
// costs ~7s on this one-core host, the radix ~1.5s.  Passes whose digit
// is uniform across all keys are skipped (common for high digits).
//
// Each pass is OpenMP-parallel when threads are available: per-thread
// chunk histograms, a serial (digit-major, thread-minor) exclusive
// prefix over 65536·T counters, then a per-thread ordered scatter.
// Within a digit, elements land ordered by (chunk, in-chunk position) =
// their order in ``cur`` — exactly the serial stable permutation, so the
// output is bit-identical to np.argsort(kind="stable") regardless of T.
static bool radix_pass(const uint64_t* key, int shift, const int64_t* cur,
                       int64_t* nxt, int64_t n) {
  int T = 1;
#if defined(_OPENMP)
  T = omp_get_max_threads();
  if (T > 16) T = 16;
  if (T < 1) T = 1;
  if (n < (1 << 18)) T = 1;
#endif
  const int64_t chunk = (n + T - 1) / T;
  std::vector<int64_t> hist((size_t)T * 65536, 0);
  const uint16_t first = (uint16_t)(key[cur[0]] >> shift);
  std::vector<char> uni((size_t)T, 1);
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    int64_t* h = hist.data() + (size_t)t * 65536;
    char u = 1;
    for (int64_t i = lo; i < hi; i++) {
      const uint16_t d = (uint16_t)(key[cur[i]] >> shift);
      h[d]++;
      u &= (d == first);
    }
    uni[t] = u;
  }
  bool uniform = true;
  for (int t = 0; t < T; t++) uniform = uniform && uni[t];
  if (uniform) return false;
  int64_t run = 0;
  for (int64_t d = 0; d < 65536; d++) {
    for (int t = 0; t < T; t++) {
      const int64_t c = hist[(size_t)t * 65536 + d];
      hist[(size_t)t * 65536 + d] = run;
      run += c;
    }
  }
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    int64_t* off = hist.data() + (size_t)t * 65536;
    for (int64_t i = lo; i < hi; i++) {
      const uint16_t d = (uint16_t)(key[cur[i]] >> shift);
      nxt[off[d]++] = cur[i];
    }
  }
  return true;
}

static void radix_u64(const uint64_t* key, int64_t* perm, int64_t n,
                      std::vector<int64_t>& tmp) {
  if (n <= 1) return;
  if ((int64_t)tmp.size() < n) tmp.resize(n);
  int64_t* cur = perm;
  int64_t* nxt = tmp.data();
  for (int shift = 0; shift < 64; shift += 16) {
    if (radix_pass(key, shift, cur, nxt, n)) std::swap(cur, nxt);
  }
  if (cur != perm) std::copy(cur, cur + n, perm);
}

// Stable lexicographic permutation over up to three 64-bit words (w0
// major; w1/w2 may be null).  The generic front-end behind lexsorts
// whose key columns don't fit the packed-int32 entry points (e.g. the
// permission fold's (res, raw-k2, cav·ctx) dedup order).
static void radix_words(const uint64_t* const* words, int nwords,
                        int64_t* perm, int64_t n) {
  if (n <= 1) return;
  std::vector<int64_t> tmp;
  if ((int64_t)tmp.size() < n) tmp.resize(n);
  int64_t* cur = perm;
  int64_t* nxt = tmp.data();
  for (int w = nwords - 1; w >= 0; w--) {
    const uint64_t* key = words[w];
    for (int shift = 0; shift < 64; shift += 16) {
      if (radix_pass(key, shift, cur, nxt, n)) std::swap(cur, nxt);
    }
  }
  if (cur != perm) std::copy(cur, cur + n, perm);
}

void gi_lexsort4(const int32_t* a, const int32_t* b, const int32_t* c,
                 const int32_t* d, int64_t n, int64_t* out) {
  std::vector<uint64_t> hi(n), lo(n);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    // flip the sign bit so signed int32 order == unsigned order
    uint64_t au = static_cast<uint32_t>(a[i]) ^ 0x80000000u;
    uint64_t bu = static_cast<uint32_t>(b[i]) ^ 0x80000000u;
    uint64_t cu = static_cast<uint32_t>(c[i]) ^ 0x80000000u;
    uint64_t du = static_cast<uint32_t>(d[i]) ^ 0x80000000u;
    hi[i] = (au << 32) | bu;
    lo[i] = (cu << 32) | du;
    out[i] = i;
  }
  std::vector<int64_t> tmp;
  radix_u64(lo.data(), out, n, tmp);  // minor word first: LSD over 128b
  radix_u64(hi.data(), out, n, tmp);
}

// Stable argsort of a single int32 column (radix).
void gi_argsort1(const int32_t* a, int64_t n, int64_t* out) {
  std::vector<uint64_t> key(n);
  for (int64_t i = 0; i < n; i++) {
    key[i] = static_cast<uint32_t>(a[i]) ^ 0x80000000u;
    out[i] = i;
  }
  std::vector<int64_t> tmp;
  radix_u64(key.data(), out, n, tmp);
}

// Exact join of two (h, l)-lexsorted int64 pair sets: out[j] = FIRST
// table position matching query j, or -1.  One linear merge — no
// per-run bisection, no Python.  Both sides must be sorted ascending.
void gi_join_sorted2(const int64_t* th, const int64_t* tl, int64_t nt,
                     const int64_t* qh, const int64_t* ql, int64_t nq,
                     int64_t* out) {
  int64_t i = 0;
  for (int64_t j = 0; j < nq; j++) {
    while (i < nt && (th[i] < qh[j] || (th[i] == qh[j] && tl[i] < ql[j]))) {
      i++;
    }
    out[j] = (i < nt && th[i] == qh[j] && tl[i] == ql[j]) ? i : -1;
  }
}

// Parallel stable lexsort by (a, b) — used for the membership-propagation
// view order (subj, srel).
void gi_lexsort2(const int32_t* a, const int32_t* b, int64_t n, int64_t* out) {
  std::vector<uint64_t> key(n);
  for (int64_t i = 0; i < n; i++) {
    uint64_t au = static_cast<uint32_t>(a[i]) ^ 0x80000000u;
    uint64_t bu = static_cast<uint32_t>(b[i]) ^ 0x80000000u;
    key[i] = (au << 32) | bu;
    out[i] = i;
  }
  std::vector<int64_t> tmp;
  radix_u64(key.data(), out, n, tmp);
}

// Stable permutation by up to three caller-packed uint64 words, w0 major
// (w1/w2 nullable).  The caller is responsible for order-preserving
// packing (non-negative int64 values reinterpret directly; pairs of
// int32 pack as hi<<32|lo with any needed bias applied before the call).
void gi_sortperm3(const uint64_t* w0, const uint64_t* w1, const uint64_t* w2,
                  int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = i;
  const uint64_t* words[3];
  int nwords = 0;
  if (w0) words[nwords++] = w0;
  if (w1) words[nwords++] = w1;
  if (w2) words[nwords++] = w2;
  if (nwords == 0) return;
  radix_words(words, nwords, out, n);
}

// Fused hash-bucket index build: given full 32-bit hashes and a pow2
// ``size``, computes bucket = h & (size-1) per row and emits the stable
// bucket-grouped row permutation (== np.argsort(bucket, kind="stable"))
// plus the bucket offset array (== cumsum of the bucket histogram).
// Replaces the mask/astype/bincount/argsort/cumsum chain of
// engine/hash.py build_hash with three linear passes.  Returns the max
// bucket occupancy (the device probe cap).
int64_t gi_hash_index32(const uint32_t* h, int64_t n, int64_t size,
                        int32_t* rows, int32_t* off) {
  const uint32_t mask = (uint32_t)(size - 1);
  std::vector<int32_t> cur(size, 0);
  int T = 1;
#if defined(_OPENMP)
  T = omp_get_max_threads();
  if (T > 8) T = 8;
  if (T < 1) T = 1;
  if (n < (1 << 20)) T = 1;
#endif
  // bucket-range ownership: thread t scans the whole hash column
  // (sequential, shared) but touches only its own bucket range — the
  // random counter/scatter traffic is what binds this loop, and it
  // splits cleanly.  Rows append in ascending i per bucket on every
  // thread, so the permutation is the stable one regardless of T.
  const int64_t brange = (size + T - 1) / T;
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const uint32_t blo = (uint32_t)((int64_t)t * brange);
    const uint32_t bhi =
        (uint32_t)std::min<int64_t>(size, (int64_t)(t + 1) * brange);
    for (int64_t i = 0; i < n; i++) {
      const uint32_t b = h[i] & mask;
      if (b >= blo && b < bhi) cur[b]++;
    }
  }
  int64_t cap = 0, run = 0;
  off[0] = 0;
  for (int64_t b = 0; b < size; b++) {
    const int64_t c = cur[b];
    if (c > cap) cap = c;
    cur[b] = (int32_t)run;
    run += c;
    off[b + 1] = (int32_t)run;
  }
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const uint32_t blo = (uint32_t)((int64_t)t * brange);
    const uint32_t bhi =
        (uint32_t)std::min<int64_t>(size, (int64_t)(t + 1) * brange);
    for (int64_t i = 0; i < n; i++) {
      const uint32_t b = h[i] & mask;
      if (b >= blo && b < bhi) rows[cur[b]++] = (int32_t)i;
    }
  }
  return cap;
}

// Fused dense subject-relation remap (engine/flat.py _m_srel1):
// out[i] = 0 when srel1[i] == 0, else k2map[srel1[i] - 1] + 1 — one pass
// instead of the clip/gather/where numpy chain.  k2map values may be -1
// ("never matches"), which maps to 0 - ... callers rely on exact numpy
// semantics: np.where(srel1 == 0, 0, k2[clip(srel1-1, 0, None)] + 1).
void gi_msrel1(const int32_t* srel1, const int32_t* k2map, int64_t mapn,
               int64_t n, int32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    const int32_t s = srel1[i];
    if (s == 0) {
      out[i] = 0;
    } else {
      int64_t j = (int64_t)s - 1;
      if (j < 0) j = 0;  // np.clip(srel1 - 1, 0, None)
      if (j >= mapn) j = mapn - 1;
      out[i] = k2map[j] + 1;
    }
  }
}

// FNV-1a over int32 words + murmur3 finalizer — bit-identical to
// engine/hash.py mix32 (the device recomputes the same mix, so host and
// device hashes must agree exactly).  cols is an array of ncols pointers
// to int32 columns, passed as int64 addresses.
void gi_mix32(const int64_t* cols, int64_t ncols, int64_t n, uint32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    uint32_t h = 2166136261u;
    for (int64_t j = 0; j < ncols; j++) {
      const int32_t* c = reinterpret_cast<const int32_t*>(cols[j]);
      h = (h ^ (uint32_t)c[i]) * 16777619u;
    }
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    out[i] = h;
  }
}

// Parallel gathers: out[i] = src[idx[i]] (callers guarantee bounds).
void gi_take32(const int32_t* src, const int64_t* idx, int64_t n,
               int32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) out[i] = src[idx[i]];
}

void gi_take64(const int64_t* src, const int64_t* idx, int64_t n,
               int64_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) out[i] = src[idx[i]];
}

// Fused gather + interleave: out[i*stride + j] = cols[j][idx ? idx[i] : i]
// for j < w — one row-major pass instead of w column-major numpy gathers
// (the interleaved row write is a single cache line; the gathers are the
// only random traffic).  cols are int32 column addresses as in gi_mix32;
// idx (int32 row permutation) may be null for identity.
void gi_interleave32(const int64_t* cols, int64_t w, const int32_t* idx,
                     int64_t n, int32_t* out, int64_t stride) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    const int64_t r = idx ? (int64_t)idx[i] : i;
    int32_t* o = out + i * stride;
    for (int64_t j = 0; j < w; j++)
      o[j] = reinterpret_cast<const int32_t*>(cols[j])[r];
  }
}

// Run boundaries of a sorted key column: writes the start index of every
// equal-key run into starts (capacity n) and returns the run count — the
// sorted-runs half of build_range_hash without the boolean-mask /
// nonzero materialization.  Two-phase parallel: per-chunk boundary
// counts, then an offset-aware fill.
static int64_t run_bounds_impl(const int64_t* k64, const int32_t* k32,
                               int64_t n, int64_t* starts) {
  if (n == 0) return 0;
  int T = 1;
#if defined(_OPENMP)
  T = omp_get_max_threads();
  if (T > 16) T = 16;
  if (T < 1) T = 1;
  if (n < (1 << 18)) T = 1;
#endif
  const int64_t chunk = (n + T - 1) / T;
  std::vector<int64_t> cnt((size_t)T, 0);
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    int64_t c = 0;
    for (int64_t i = lo; i < hi; i++) {
      if (i == 0) { c++; continue; }
      const bool b = k64 ? (k64[i] != k64[i - 1]) : (k32[i] != k32[i - 1]);
      c += b ? 1 : 0;
    }
    cnt[t] = c;
  }
  std::vector<int64_t> base((size_t)T + 1, 0);
  for (int t = 0; t < T; t++) base[t + 1] = base[t] + cnt[t];
#if defined(_OPENMP)
#pragma omp parallel for num_threads(T) schedule(static, 1)
#endif
  for (int t = 0; t < T; t++) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    int64_t at = base[t];
    for (int64_t i = lo; i < hi; i++) {
      const bool b =
          i == 0 || (k64 ? (k64[i] != k64[i - 1]) : (k32[i] != k32[i - 1]));
      if (b) starts[at++] = i;
    }
  }
  return base[T];
}

int64_t gi_run_bounds64(const int64_t* k, int64_t n, int64_t* starts) {
  return run_bounds_impl(k, nullptr, n, starts);
}

int64_t gi_run_bounds32(const int32_t* k, int64_t n, int64_t* starts) {
  return run_bounds_impl(nullptr, k, n, starts);
}

// Fused dense-radix key packing: out[i] = (int32)(a[i] * radix + b[i]) —
// the engine/flat.py _pack inner op without the int64 temporary pair.
void gi_pack32(const int32_t* a, const int32_t* b, int64_t radix, int64_t n,
               int32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++)
    out[i] = (int32_t)((int64_t)a[i] * radix + (int64_t)b[i]);
}

}  // extern "C"
