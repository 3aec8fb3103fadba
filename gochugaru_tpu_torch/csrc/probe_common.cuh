// Device helpers shared by the fused probe kernels (fused_probe.cu and
// fused_probe_aligned.cu): the key hash, the packed-row decode, and the
// slot tile with its warp-reduced path -- every check mode of both
// kernels (block, gate, and the reduced modes any and until2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GOCHUGARU_MAXW 16
#define GOCHUGARU_DICT 256
#define GOCHUGARU_MAXL 8  // aligned levels; also the tile's segments a lane

enum { MODE_BLOCK = 0, MODE_ANY = 1, MODE_UNTIL2 = 2, MODE_GATE = 3, MODE_RUNS = 4 };

// mix32 (engine/hash.py): FNV-1a over the key words + murmur3 finalizer
__device__ __forceinline__ uint32_t gochugaru_mix32(int32_t q0, int32_t q1,
                                                    int nq) {
  uint32_t h = 2166136261u;
  h = (h ^ (uint32_t)q0) * 16777619u;
  if (nq > 1) h = (h ^ (uint32_t)q1) * 16777619u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// A packed field's lanes as one 32-bit window: lane off_bit >> 4, and the
// next lane when the field crosses into it (a constant field reads none).
// f is the field's spec row (bits, base, delta_of, dict_id, off_bit).
__device__ __forceinline__ uint32_t gochugaru_field_window(const uint16_t* r,
                                                           const int32_t* f) {
  const int bits = f[0], off_bit = f[4];
  if (bits == 0) return 0u;
  const int lane = off_bit >> 4;
  uint32_t w = (uint32_t)r[lane];
  if ((off_bit & 15) + bits > 16) w |= (uint32_t)r[lane + 1] << 16;
  return w;
}

// A field's own value from its window, before any delta is added: the
// constant, the dictionary entry (the index clamped into the padded
// dictionary), or the bit range plus its base.
__device__ __forceinline__ uint32_t gochugaru_field_own(uint32_t w,
                                                        const int32_t* f,
                                                        const int32_t* dicts) {
  const int bits = f[0], base = f[1], dict_id = f[3];
  if (bits == 0) return (uint32_t)base;
  uint32_t v = w >> (f[4] & 15);
  if (bits < 32) v &= (1u << bits) - 1u;
  if (dict_id >= 0)
    return (uint32_t)dicts[dict_id * GOCHUGARU_DICT +
                           min(v, (uint32_t)(GOCHUGARU_DICT - 1))];
  return v + (uint32_t)base;
}

// One packed row (uint16 lanes) -> W logical int32 columns through the
// runtime spec: fields int32[W, 5] = (bits, base, delta_of, dict_id,
// off_bit), dictionaries int32[ndict, 256] padded with their last value.
__device__ __forceinline__ void gochugaru_decode_row(
    const uint16_t* r, int W, const int32_t* fields, const int32_t* dicts,
    int32_t* cols) {
  for (int c = 0; c < W; ++c) {
    const int32_t* f = fields + 5 * c;
    uint32_t col = gochugaru_field_own(gochugaru_field_window(r, f), f, dicts);
    if (f[2] >= 0) col += (uint32_t)cols[f[2]];
    cols[c] = (int32_t)col;
  }
}

// Column c of one packed row alone: the own values along its delta chain
// (c, delta_of(c), ...; each delta_of names an earlier column, as
// kernels.spec_tensors checks), summed mod 2^32 -- what
// gochugaru_decode_row stores in cols[c], without a cols array.
__device__ __forceinline__ int32_t gochugaru_decode_col(const uint16_t* r,
                                                       int c,
                                                       const int32_t* fields,
                                                       const int32_t* dicts) {
  uint32_t col = 0u;
  for (int k = c, m = 0; k >= 0 && m <= c; ++m) {
    const int32_t* f = fields + 5 * k;
    col += gochugaru_field_own(gochugaru_field_window(r, f), f, dicts);
    k = f[2];
  }
  return (int32_t)col;
}

// The gate's optional int32 planes (pallas.py:355-359): PLANES 0 writes
// hit and live only; 1 adds the caveat-id plane (the row's cav column on
// a hit, 0 on a miss); 2 adds the stored-context plane too (its ctx
// column on a hit, -1 on a miss).  A template parameter of the slot tile,
// so a gate without caveats compiles to the code it had before the planes
// existed.
struct GochugaruGatePlanes {
  int32_t* cav;  // [B, cap] or null (PLANES 0)
  int32_t* ctx;  // [B, cap] or null (PLANES < 2)
  int lay_cav;   // logical column of the caveat id
  int lay_ctx;   // logical column of the context index
};

// ---------------------------------------------------------------------------
// The slot tile: every check mode of both kernels (block, gate, and the
// reduced modes any and until2, whose short lanes take the warp path)
// ---------------------------------------------------------------------------
//
// A lane's candidate block is a short list of SEGMENTS, each a run of
// contiguous slots in one table: fused_probe has one (cap rows at the
// clamped bucket start), fused_probe_aligned one per level (cap_l slots of
// bucket h_l's row).  Segment s of every lane shares its table, slot count
// and slot stride; only its start differs per lane, and the kernel's
// ``Lanes`` functor computes those starts (Lanes::segment(q, s) the start
// of segment s of the lane whose keys are q; Lanes::segments(lane, off)
// all nseg of them).
//
// A CTA owns one TILE: ``tile_slots`` consecutive slots of the flattened
// [B * capT] slot space, so its output is one contiguous span.
//   A. one thread per lane the tile touches: hash, offset read, clamp (or
//      the per-level hashes) -> segment starts in shared memory (gate and
//      the reduced modes: the lane's two keys beside them, and the reduced
//      modes' flag word, zeroed); the dependent offset read happens once
//      per lane, not once per slot;
//   B. one thread per slot, neighbouring threads on neighbouring slots of
//      one lane's contiguous segment, so the row reads coalesce (the slot
//      cursor and gochugaru_slot_at below: the one copy of the segment
//      walk);
//   C. block: the shared tile to the output; the reduced modes: the flag
//      words to the per-lane outputs.
//
// Mode block (pallas.py:246 and :444, block tail) is bound by bytes and
// dominated by its OUTPUT, a lane's decoded [capT, W] int32 block.  Phase
// B copies each slot's row into the shared tile [tile_slots, W] with
// asynchronous 4-byte copies (cp.async: no registers, every slot of the
// thread in flight at once, one wait for all), or decodes it through the
// runtime pack spec straight into the tile; phase C stores the tile's span
// with 16-byte streaming stores, the ragged end element by element.  The
// host picks tile_slots (engine/kernels/__init__.py::block_tile) so that
// tile_slots * W is a multiple of 4 (every span starts 16-byte aligned)
// and the shared bytes fit; a lane whose block passes the budget is
// walked in chunks of slots, since a tile is any run of slots.
//
// Mode gate (pallas.py:246 and :444, gate tail) writes two uint8 flags a
// slot, hit and live: 2 * capT bytes a lane, the most of its bytes, and
// the rest is the rows read.  On caveated tables it also writes one or two
// int32 planes a slot (pallas.py:355-359, :551-555): the caveat id and the
// stored-context index on a hit, 0 and -1 on a miss, each at the slot's
// flat index beside the flags, decoded only on a hit.  One thread a lane
// (the first kernels) walked its slots one after another, decoded every
// column of every row into a cols[] array, and stored the flags at a
// capT-byte stride and the planes at a 4 * capT-byte one, so a warp's
// store spanned 32 sectors to write one or four.  Here one thread takes a
// slot: it reads the lanes its slot needs (the two key fields and the
// expiry field, their spec rows read once a thread), compares with the
// lane's UNSALTED keys from shared memory, applies the expiry only on a
// hit, and stores the two flags (and planes) at the slot's flat index:
// neighbouring threads, neighbouring bytes and words.  There is no output
// tile and no phase C.  What bounds it is not bytes (the flags and rows
// are ~5 MB at the main-path call, ~1.5 us at the HBM rate): a launch of
// the tiles with phase A and the stores alone takes ~3.4 us there, the
// slot walk ~1 us more, the row reads and compares the rest.  Fewer memory
// instructions a slot did not pay: reading a packed row as the aligned
// 32-bit words that hold its lanes measured slower than one 16-bit load a
// field lane (PERF.md; gochugaru_tpu_torch/tools/probe_variants.py).
// Slots a CTA come from kernels.gate_tile; the shared bytes are only the
// touched lanes' segment starts and keys, so a lane longer than a tile is
// walked in chunks.
//
// The reduced modes (any and until2, pallas.py:343-347) fold a lane's
// slots into one or two flags a LANE: any hit, and for until2 any hit
// with column 2 / column 3 past ``now``.  The per-lane kernels they
// replace walked a lane's slots one after another in one thread and
// decoded every column of every row.  Here one thread takes a slot and
// reads only the key fields and, for until2, columns 2 and 3 (each decoded
// alone along its delta chain, reusing the key columns already decoded;
// gochugaru_slot_bits, the one copy of the slot body), on one of two
// paths, both with whole lanes a CTA, so no lane is combined across CTAs
// and nothing needs a global atomic:
//   - the WARP PATH, lanes of capT <= GOCHUGARU_WARP_CAP (32) slots
//     (gochugaru_warp_reduce_kernel): a warp owns 32 / capT whole lanes,
//     thread t slot t % capT of lane t / capT (the threads past them
//     idle).  Each thread computes its own slot's segment start (the hash,
//     and for fused_probe the offset read and the clamp; the lane's capT
//     threads read the same key and offset addresses, one request a warp),
//     so there is no phase A, no shared memory and no barrier; the warp
//     folds its flags with one __ballot_sync a flag, and each lane's first
//     thread stores its byte.  The main-path calls (32,768 lanes of 3-4
//     slots) run ~400-512 CTAs, against the 128 of one thread a lane: warps
//     enough to hide the dependent chain key -> offset -> row -> store.
//     The slot tile's floor (phase A, two barriers, phase C) was above the
//     whole per-lane any (PERF.md).
//   - the SHARED-FLAG TILE, longer lanes: a CTA owns
//     max(1, REDUCE_SLOTS / capT) whole lanes (kernels.reduce_tile; a lane
//     past REDUCE_SLOTS has a CTA of its own whose threads loop over its
//     slots); phase A as above with each lane's flag word zeroed, phase B
//     the gate's slot walk, a slot that hits ORs its bits into its lane's
//     shared flag word (a shared atomicOr, only when it has a bit to set),
//     and phase C stores the flag words as the lanes' uint8 outputs.  Its
//     tiles are smaller than the gate's: 2,048 slots a CTA left half the
//     SMs idle on a reduced call (PERF.md).
// The host picks the path (kernels.reduce_path, by capT) and passes it
// as ``warp``; the launch refuses a warp path past GOCHUGARU_WARP_CAP or
// with another geometry than gochugaru_warp_slots.
//
// Table and output addresses are int64; shared indices are 32-bit.

#define GOCHUGARU_TILE_THREADS 256
#define GOCHUGARU_SMEM_MAX 232448  // per-block shared memory on sm_90
#define GOCHUGARU_WARP_CAP 32      // longest lane of the warp path

struct GochugaruTile {
  const void* seg_tbl[GOCHUGARU_MAXL];    // segment s's table (int32 or uint16)
  int seg_first[GOCHUGARU_MAXL + 1];      // segment s's first slot in a lane
  int nseg;                               // segments a lane (1..MAXL)
  int capT;                               // slots a lane (seg_first[nseg])
  int W;                                  // logical int32 columns a slot
  int stride;                             // elements between a segment's slots
  int packed;                             // tables hold uint16 lanes (decode)
  int tile_slots;                         // slots a CTA
  int warp;                               // reduced: the warp path
  int warp_div;                           // warp path: ceil(2^16 / capT)
  const int32_t* fields;                  // pack spec [W, 5], or null
  const int32_t* dicts;                   // dictionaries [ndict, 256], or null
  int32_t* out;                           // block: [B, capT, W]
  uint8_t* hit;                           // gate: [B, capT] hit flags
  uint8_t* live;                          // gate: [B, capT] live flags
  GochugaruGatePlanes planes;             // gate: the optional int32 planes
  uint8_t* red0;                          // reduced: [B] first lane flag
  uint8_t* red1;                          // until2: [B] second lane flag
  const int32_t* q0;                      // gate, reduced: [B] first key column
  const int32_t* q1;                      // gate, reduced: [B] second key or null
  int nq;                                 // gate, reduced: key columns (1 or 2)
  int now;                                // gate: expiry; until2: threshold
  const int32_t* now_ptr;                 // the clock on the device, or null
  int lay_exp;                            // gate: expiry column, -1 = none
  long long B;
};

// The clock the gate and until2 compare with: the device scalar at
// ``now_ptr`` when there is one (a replayed CUDA graph reads the clock
// its caller filled in before the replay), else the by-value ``now``.
__device__ __forceinline__ int gochugaru_now(const GochugaruTile& t) {
  return t.now_ptr != nullptr ? __ldg(t.now_ptr) : t.now;
}

// The most lanes one tile touches: tiles start at multiples of S, so a
// tile of whole lanes touches S / capT of them, any other at most
// ceil((S - 1) / capT) + 1.  Mirrored by kernels._tile_lanes.
__host__ __device__ __forceinline__ int gochugaru_tile_lanes(int S, int capT) {
  return S % capT == 0 ? S / capT : (S + capT - 2) / capT + 1;
}

// Shared bytes of one CTA: block's tile [S, W] int32, then per touched
// lane its nseg segment starts (int64) and, for gate and the reduced
// modes, its two keys, and for the reduced modes its flag word.  Mirrored
// by kernels.block_tile / gate_tile / reduce_tile.
template <int MODE>
__host__ __device__ __forceinline__ size_t gochugaru_tile_smem(int S, int capT,
                                                              int W, int nseg) {
  const size_t lanes = (size_t)gochugaru_tile_lanes(S, capT);
  if (MODE == MODE_BLOCK) return (size_t)S * W * 4 + lanes * nseg * 8;
  if (MODE == MODE_GATE) return lanes * (nseg * 8 + 8);
  return lanes * (nseg * 8 + 12);
}

// Whole lanes a warp of the warp path (capT <= GOCHUGARU_WARP_CAP): thread
// t takes slot t % capT of lane t / capT, the threads past them idle.
// Mirrored by kernels.warp_tile.
__host__ __device__ __forceinline__ int gochugaru_warp_lanes(int capT) {
  return 32 / capT;
}

// Slots a CTA of the warp path: its warps' whole lanes.  Mirrored by
// kernels.warp_tile.
__host__ __device__ __forceinline__ int gochugaru_warp_slots(int capT) {
  return GOCHUGARU_TILE_THREADS / 32 * gochugaru_warp_lanes(capT) * capT;
}

// One int32 row of W columns into the shared tile, as W asynchronous
// 4-byte copies (global -> shared, no registers); complete after
// gochugaru_copy_wait.
__device__ __forceinline__ void gochugaru_copy_row(const int32_t* r, int W,
                                                   int32_t* dst) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  for (int c = 0; c < W; ++c)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * c),
                 "l"(r + c)
                 : "memory");
}

__device__ __forceinline__ void gochugaru_copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase B's cursor: slot p of the tile is slot j of the tile's k-th lane;
// a thread's slots lie ``step`` apart, so (k, j) advance without division.
struct GochugaruSlotCursor {
  int k, j, dk, dj, capT;
  __device__ __forceinline__ GochugaruSlotCursor(int first, int step, int capT_)
      : k(first / capT_), j(first - (first / capT_) * capT_),
        dk(step / capT_), dj(step - (step / capT_) * capT_), capT(capT_) {}
  __device__ __forceinline__ void next() {
    k += dk;
    j += dj;
    if (j >= capT) {
      j -= capT;
      ++k;
    }
  }
};

// The segment s that holds slot j of a lane (returned, with its first
// slot and its table): constant indices (no indexed parameter reads),
// stopping at the slot's segment.
__device__ __forceinline__ int gochugaru_seg_of(const GochugaruTile& t, int j,
                                                int& first,
                                                const void*& tbl) {
  // segment s holds slots [seg_first[s], seg_first[s + 1])
  int s = 0;
  first = 0;
  tbl = t.seg_tbl[0];
#pragma unroll
  for (int m = 1; m < GOCHUGARU_MAXL; ++m) {
    if (m >= t.nseg || j < t.seg_first[m]) break;
    s = m;
    first = t.seg_first[m];
    tbl = t.seg_tbl[m];
  }
  return s;
}

// The element offset of slot j of the tile's k-th lane in its segment's
// table (returned in tbl).
__device__ __forceinline__ long long gochugaru_slot_at(
    const GochugaruTile& t, const long long* seg_off, int k, int j,
    const void*& tbl) {
  int first;
  const int s = gochugaru_seg_of(t, j, first, tbl);
  return seg_off[k * t.nseg + s] + (long long)(j - first) * t.stride;
}

// Phase B+C of mode block: rows into the shared tile, the tile to out.
__device__ __forceinline__ void gochugaru_block_slots(const GochugaruTile& t,
                                                      const long long* seg_off,
                                                      int32_t* tile,
                                                      long long g0, int n,
                                                      int j0) {
  GochugaruSlotCursor c(j0 + (int)threadIdx.x, blockDim.x, t.capT);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const void* tbl;
    const long long at = gochugaru_slot_at(t, seg_off, c.k, c.j, tbl);
    int32_t* dst = tile + p * t.W;
    if (t.packed) {
      gochugaru_decode_row((const uint16_t*)tbl + at, t.W, t.fields, t.dicts,
                           dst);
    } else {
      gochugaru_copy_row((const int32_t*)tbl + at, t.W, dst);
    }
    c.next();
  }
  gochugaru_copy_wait();
  __syncthreads();

  // C: the tile's contiguous span of out, 16 bytes a thread
  int32_t* out = t.out + g0 * t.W;
  const int ne = n * t.W;
  const int nv = ne >> 2;
  for (int v = threadIdx.x; v < nv; v += blockDim.x)
    __stcs((int4*)out + v, ((const int4*)tile)[v]);
  for (int e = (nv << 2) + threadIdx.x; e < ne; e += blockDim.x)
    __stcs(out + e, tile[e]);
}

// A packed column's value from its own value ``own`` (its field alone) and
// its delta chain ``d`` (the column it is a delta of, -1 = none): column 0
// and, with two keys, column 1 are already decoded (c0, c1); any other
// chain is decoded from the row.
__device__ __forceinline__ uint32_t gochugaru_chain(const GochugaruTile& t,
                                                    const uint16_t* r,
                                                    uint32_t own, int d,
                                                    uint32_t c0, uint32_t c1) {
  if (d == 0) return own + c0;
  if (d == 1 && t.nq > 1) return own + c1;
  if (d >= 0) return own + (uint32_t)gochugaru_decode_col(r, d, t.fields, t.dicts);
  return own;
}

// The spec row of column c (f[5]) read once into registers, or a constant
// 0 field (no lanes, base 0, no delta, no dictionary) when there is no
// spec or no such column (c < 0).
__device__ __forceinline__ void gochugaru_spec_row(const GochugaruTile& t,
                                                   int c, int32_t* f) {
#pragma unroll
  for (int e = 0; e < 5; ++e)
    f[e] = (t.packed && c >= 0) ? t.fields[5 * c + e]
                                : ((e == 2 || e == 3) ? -1 : 0);
}

// Phase B of mode gate: one thread a slot, its hit and live flags, and on
// a hit its PLANES caveat / context columns (each decoded alone along its
// delta chain: no cols[] array).
template <int PLANES>
__device__ __forceinline__ void gochugaru_gate_slots(const GochugaruTile& t,
                                                     const long long* seg_off,
                                                     const int32_t* keys,
                                                     long long g0, int n,
                                                     int j0) {
  // the spec rows of the key fields and the expiry field
  int32_t f0[5], f1[5], fe[5];
  gochugaru_spec_row(t, 0, f0);
  gochugaru_spec_row(t, t.nq > 1 ? 1 : -1, f1);
  gochugaru_spec_row(t, t.lay_exp, fe);
  const bool gate = t.lay_exp >= 0;
  const int now = gate ? gochugaru_now(t) : 0;
  GochugaruSlotCursor c(j0 + (int)threadIdx.x, blockDim.x, t.capT);
  for (int p = threadIdx.x; p < n; p += blockDim.x, c.next()) {
    const int2 q = ((const int2*)keys)[c.k];
    bool hit = false, live = false;
    int32_t cav = 0, ctx = -1;
    if (q.x >= 0 && (t.nq < 2 || q.y >= 0)) {
      const void* tbl;
      const long long at = gochugaru_slot_at(t, seg_off, c.k, c.j, tbl);
      uint32_t c0, c1 = 0u, e = 0u;
      if (t.packed) {
        const uint16_t* r = (const uint16_t*)tbl + at;
        const uint32_t w0 = gochugaru_field_window(r, f0);
        const uint32_t w1 = gochugaru_field_window(r, f1);
        const uint32_t we = gochugaru_field_window(r, fe);
        c0 = gochugaru_field_own(w0, f0, t.dicts);
        if (t.nq > 1)
          c1 = gochugaru_field_own(w1, f1, t.dicts) + (f1[2] == 0 ? c0 : 0u);
        if (gate)
          e = gochugaru_chain(t, r, gochugaru_field_own(we, fe, t.dicts), fe[2],
                              c0, c1);
      } else {
        const int32_t* r = (const int32_t*)tbl + at;
        c0 = (uint32_t)r[0];
        if (t.nq > 1) c1 = (uint32_t)r[1];
        if (gate) e = (uint32_t)r[t.lay_exp];
      }
      // compare with the unsalted keys; the expiry gate on a hit
      hit = (int32_t)c0 == q.x && (t.nq < 2 || (int32_t)c1 == q.y);
      live = hit && (!gate || (int32_t)e == 0 || (int32_t)e > now);
      if (PLANES > 0 && hit) {
        const GochugaruGatePlanes& gp = t.planes;
        if (t.packed) {
          const uint16_t* r = (const uint16_t*)tbl + at;
          cav = gochugaru_decode_col(r, gp.lay_cav, t.fields, t.dicts);
          if (PLANES > 1)
            ctx = gochugaru_decode_col(r, gp.lay_ctx, t.fields, t.dicts);
        } else {
          const int32_t* r = (const int32_t*)tbl + at;
          cav = r[gp.lay_cav];
          if (PLANES > 1) ctx = r[gp.lay_ctx];
        }
      }
    }
    if (PLANES > 0) t.planes.cav[g0 + p] = cav;
    if (PLANES > 1) t.planes.ctx[g0 + p] = ctx;
    t.hit[g0 + p] = hit;
    t.live[g0 + p] = live;
  }
}

// The spec rows a reduced mode reads: the key fields and, for until2,
// columns 2 and 3 (read once a thread).
struct GochugaruReduceSpec {
  int32_t f0[5], f1[5], f2[5], f3[5];
};

template <int MODE>
__device__ __forceinline__ GochugaruReduceSpec
gochugaru_reduce_spec(const GochugaruTile& t) {
  GochugaruReduceSpec sp;
  gochugaru_spec_row(t, 0, sp.f0);
  gochugaru_spec_row(t, t.nq > 1 ? 1 : -1, sp.f1);
  gochugaru_spec_row(t, MODE == MODE_UNTIL2 ? 2 : -1, sp.f2);
  gochugaru_spec_row(t, MODE == MODE_UNTIL2 ? 3 : -1, sp.f3);
  return sp;
}

// One slot of a reduced mode, the row at element ``at`` of ``tbl``
// against the lane's unsalted keys q (both >= 0): its bits (any: bit 0 on
// a hit; until2: bit 0 when column 2 > now, bit 1 when column 3 > now), 0
// on a miss.  The one slot body of both reduced paths.
template <int MODE>
__device__ __forceinline__ int gochugaru_slot_bits(const GochugaruTile& t,
                                                   const GochugaruReduceSpec& sp,
                                                   const void* tbl,
                                                   long long at, int2 q) {
  uint32_t c0, c1 = 0u, v2 = 0u, v3 = 0u;
  if (t.packed) {
    const uint16_t* r = (const uint16_t*)tbl + at;
    const uint32_t w0 = gochugaru_field_window(r, sp.f0);
    const uint32_t w1 = gochugaru_field_window(r, sp.f1);
    const uint32_t w2 = gochugaru_field_window(r, sp.f2);
    const uint32_t w3 = gochugaru_field_window(r, sp.f3);
    c0 = gochugaru_field_own(w0, sp.f0, t.dicts);
    if (t.nq > 1)
      c1 = gochugaru_field_own(w1, sp.f1, t.dicts) + (sp.f1[2] == 0 ? c0 : 0u);
    if (MODE == MODE_UNTIL2) {
      v2 = gochugaru_chain(t, r, gochugaru_field_own(w2, sp.f2, t.dicts),
                           sp.f2[2], c0, c1);
      const uint32_t own3 = gochugaru_field_own(w3, sp.f3, t.dicts);
      v3 = sp.f3[2] == 2 ? own3 + v2
                         : gochugaru_chain(t, r, own3, sp.f3[2], c0, c1);
    }
  } else {
    const int32_t* r = (const int32_t*)tbl + at;
    c0 = (uint32_t)r[0];
    if (t.nq > 1) c1 = (uint32_t)r[1];
    if (MODE == MODE_UNTIL2) {
      v2 = (uint32_t)r[2];
      v3 = (uint32_t)r[3];
    }
  }
  if ((int32_t)c0 != q.x || (t.nq > 1 && (int32_t)c1 != q.y)) return 0;
  if (MODE == MODE_ANY) return 1;
  const int now = gochugaru_now(t);
  return ((int32_t)v2 > now) | (((int32_t)v3 > now) << 1);
}

// Phase B of the shared-flag tile: one thread a slot; a slot that hits ORs
// its bits into its lane's shared flag word.
template <int MODE>
__device__ __forceinline__ void gochugaru_reduce_slots(const GochugaruTile& t,
                                                       const long long* seg_off,
                                                       const int32_t* keys,
                                                       int* flags, int n) {
  const GochugaruReduceSpec sp = gochugaru_reduce_spec<MODE>(t);
  GochugaruSlotCursor c((int)threadIdx.x, blockDim.x, t.capT);
  for (int p = threadIdx.x; p < n; p += blockDim.x, c.next()) {
    const int2 q = ((const int2*)keys)[c.k];
    if (q.x < 0 || (t.nq > 1 && q.y < 0)) continue;
    const void* tbl;
    const long long at = gochugaru_slot_at(t, seg_off, c.k, c.j, tbl);
    const int bits = gochugaru_slot_bits<MODE>(t, sp, tbl, at, q);
    if (bits) atomicOr(flags + c.k, bits);
  }
}

// The warp path of a reduced mode (lanes of capT <= GOCHUGARU_WARP_CAP
// slots): warp w owns lanes [w * L, w * L + L), L = gochugaru_warp_lanes;
// thread t takes slot j = t % capT of lane k = t / capT, computes its own
// segment start, and the warp folds each lane's bits with one ballot a
// flag.  No shared memory and no barrier.
template <int MODE, class Lanes>
__global__ void __launch_bounds__(GOCHUGARU_TILE_THREADS)
gochugaru_warp_reduce_kernel(const GochugaruTile t, const Lanes lanes) {
  // n / capT for n <= 32 as (n * ceil(2^16 / capT)) >> 16: exact, since
  // the multiplier's excess adds under 33 / 2^16 < 1 / capT to the
  // quotient (no division a thread)
  const int tid = threadIdx.x & 31;
  const int per = (32 * t.warp_div) >> 16;  // gochugaru_warp_lanes(capT)
  const int k = (tid * t.warp_div) >> 16;
  const int j = tid - k * t.capT;
  const long long lane0 =
      ((long long)blockIdx.x * (GOCHUGARU_TILE_THREADS / 32) +
       (threadIdx.x >> 5)) * per;
  if (lane0 >= t.B) return;  // the whole warp: no ballot follows
  const long long i = lane0 + k;
  const bool mine = k < per && i < t.B;  // a slot of one of the warp's lanes
  int bits = 0;
  if (mine) {
    const int2 q = make_int2(t.q0[i], t.nq > 1 ? t.q1[i] : 0);
    if (q.x >= 0 && (t.nq < 2 || q.y >= 0)) {
      int first;
      const void* tbl;
      const int s = gochugaru_seg_of(t, j, first, tbl);
      const long long at =
          lanes.segment(q, s) + (long long)(j - first) * t.stride;
      // an int32 row reads no spec: load the spec rows only when packed
      bits = t.packed ? gochugaru_slot_bits<MODE>(
                            t, gochugaru_reduce_spec<MODE>(t), tbl, at, q)
                      : gochugaru_slot_bits<MODE>(t, GochugaruReduceSpec{}, tbl,
                                                  at, q);
    }
  }
  const unsigned b0 = __ballot_sync(0xffffffffu, bits & 1);
  const unsigned b1 =
      MODE == MODE_UNTIL2 ? __ballot_sync(0xffffffffu, bits & 2) : 0u;
  if (mine && j == 0) {
    // the lane's capT bits (all 32 when capT is 32: no shift by 32)
    const unsigned m =
        (t.capT == 32 ? 0xffffffffu : (1u << t.capT) - 1u) << (k * t.capT);
    t.red0[i] = (b0 & m) != 0u;
    if (MODE == MODE_UNTIL2) t.red1[i] = (b1 & m) != 0u;
  }
}

template <int MODE, class Lanes, int PLANES>
__global__ void __launch_bounds__(GOCHUGARU_TILE_THREADS)
gochugaru_slot_tile_kernel(const GochugaruTile t, const Lanes lanes) {
  extern __shared__ int4 gochugaru_smem[];
  int32_t* tile = (int32_t*)gochugaru_smem;
  long long* seg_off =
      (long long*)(tile + (MODE == MODE_BLOCK ? t.tile_slots * t.W : 0));

  const long long g0 = (long long)blockIdx.x * t.tile_slots;
  const long long left = t.B * t.capT - g0;
  const int n = left < t.tile_slots ? (int)left : t.tile_slots;
  const long long lane0 = g0 / t.capT;
  const int j0 = (int)(g0 - lane0 * t.capT);
  const int nl = (j0 + n - 1) / t.capT + 1;
  const int tl = gochugaru_tile_lanes(t.tile_slots, t.capT);
  int32_t* keys = (int32_t*)(seg_off + tl * t.nseg);
  int* flags = keys + 2 * tl;  // reduced modes

  // A: segment starts (and the keys, and the zeroed flag words), one
  // thread per lane
  for (int k = threadIdx.x; k < nl; k += blockDim.x) {
    lanes.segments(lane0 + k, seg_off + k * t.nseg);
    if (MODE != MODE_BLOCK) {
      keys[2 * k] = t.q0[lane0 + k];
      keys[2 * k + 1] = t.nq > 1 ? t.q1[lane0 + k] : 0;
    }
    if (MODE == MODE_ANY || MODE == MODE_UNTIL2) flags[k] = 0;
  }
  __syncthreads();

  if (MODE == MODE_BLOCK) {
    gochugaru_block_slots(t, seg_off, tile, g0, n, j0);
  } else if (MODE == MODE_GATE) {
    gochugaru_gate_slots<PLANES>(t, seg_off, keys, g0, n, j0);
  } else {
    // the tile is whole lanes (j0 == 0): B, then C one thread a lane
    gochugaru_reduce_slots<MODE>(t, seg_off, keys, flags, n);
    __syncthreads();
    for (int k = threadIdx.x; k < nl; k += blockDim.x) {
      const int f = flags[k];
      t.red0[lane0 + k] = f & 1;
      if (MODE == MODE_UNTIL2) t.red1[lane0 + k] = (f >> 1) & 1;
    }
  }
}

// Launch the slot tile of MODE (block, gate with PLANES int32 planes, or a
// reduced mode on its shared-flag tile or, with t.warp, its warp path)
// over every lane; returns a cudaError_t as int.  Refuses a geometry that
// does not fit or align, a reduced tile that splits a lane, a warp path
// past GOCHUGARU_WARP_CAP or off gochugaru_warp_slots, and outputs or
// columns the mode cannot write or read.
template <int MODE, class Lanes, int PLANES = 0>
int gochugaru_launch_slot_tile(const GochugaruTile& t, const Lanes& lanes,
                               cudaStream_t st) {
  const int S = t.tile_slots;
  const bool reduced = MODE == MODE_ANY || MODE == MODE_UNTIL2;
  if (t.nseg < 1 || t.nseg > GOCHUGARU_MAXL || t.capT < 1 || S < 1 ||
      S > GOCHUGARU_SMEM_MAX || t.seg_first[t.nseg] != t.capT)
    return (int)cudaErrorInvalidValue;
  if (MODE == MODE_BLOCK &&
      ((S * t.W) % 4 != 0 || ((uintptr_t)t.out & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (MODE != MODE_BLOCK && (t.nq < 1 || t.nq > 2 || t.W < t.nq))
    return (int)cudaErrorInvalidValue;
  if (MODE == MODE_GATE && t.lay_exp >= t.W) return (int)cudaErrorInvalidValue;
  if (reduced && (S % t.capT != 0 || t.red0 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (MODE == MODE_UNTIL2 && (t.W < 4 || t.red1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (PLANES > 0 && (MODE != MODE_GATE || t.planes.cav == nullptr ||
                     t.planes.lay_cav < 0 || t.planes.lay_cav >= t.W))
    return (int)cudaErrorInvalidValue;
  if (PLANES > 1 && (t.planes.ctx == nullptr || t.planes.lay_ctx < 0 ||
                     t.planes.lay_ctx >= t.W))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (t.B * t.capT + S - 1) / S;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (MODE == MODE_ANY || MODE == MODE_UNTIL2) {
    if (t.warp) {
      // whole warps of whole lanes: the tiles are the warp path's CTAs
      if (t.capT > GOCHUGARU_WARP_CAP || S != gochugaru_warp_slots(t.capT))
        return (int)cudaErrorInvalidValue;
      GochugaruTile w = t;
      w.warp_div = (65536 + t.capT - 1) / t.capT;
      gochugaru_warp_reduce_kernel<MODE, Lanes>
          <<<(unsigned)tiles, GOCHUGARU_TILE_THREADS, 0, st>>>(w, lanes);
      return (int)cudaGetLastError();
    }
  } else if (t.warp) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gochugaru_tile_smem<MODE>(S, t.capT, t.W, t.nseg);
  if (smem > GOCHUGARU_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gochugaru_slot_tile_kernel<MODE, Lanes, PLANES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gochugaru_slot_tile_kernel<MODE, Lanes, PLANES>
      <<<(unsigned)tiles, GOCHUGARU_TILE_THREADS, smem, st>>>(t, lanes);
  return (int)cudaGetLastError();
}
