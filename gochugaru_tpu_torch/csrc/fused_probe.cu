// Fused bucket probe for Hopper (sm_90a).
//
// Replaces gochugaru_tpu/engine/pallas.py::fused_probe (modes block, any,
// until2, gate, and runs below).  One probe per query lane:
//
//   mix32(q) -> bucket -> bucket start (int32 offsets, or int32 anchor +
//   uint16 residual) -> clamp to [0, rows - cap] -> cap rows -> decode
//   (runtime pack spec) -> key compare with q >= 0 guard -> mode tail
//
// What bounds it: bytes.  A probe reads cap rows of 4-16 bytes at a
// data-dependent address and does a few dozen integer operations on them,
// far below the card's operations-per-byte balance, so the kernel is a
// random-gather kernel limited by memory transactions.  The TPU design
// double-buffered bucket DMAs into VMEM; on Hopper many resident warps
// hide the gather latency instead.  The decode spec (fields and <= 256-entry
// dictionaries) is a small device array uploaded once per table at
// prepare: no per-spec recompilation, the spec is data.
//
// Bool outputs are uint8.  Row addressing is int64 (rows * lanes passes
// 2^31 on large tables).
//
// Modes block, gate, until2 and any run the slot tile of probe_common.cuh:
// per lane one segment of cap rows at the clamped start
// (OffInterleaveLanes below: the hash, the offset read and the clamp), the
// rows read slot by slot by neighbouring threads.
//   - block (pallas.py:246, the block tail) is bound by its OUTPUT, a
//     lane's decoded [cap, W] int32 block (cap 8, W 3: 96 bytes out per
//     lane); the rows go into a shared-memory tile, stored to out0 as one
//     contiguous span with 16-byte stores.
//   - gate (the gate tail, :348-359) writes hit and live a slot, and on a
//     caveated table (pallas.py:286, :355-359) the row's caveat id (0 on a
//     miss) in out2 and its stored-context index (-1 on a miss) in out3:
//     one thread a slot decodes only the key and expiry fields, the
//     caveat and context columns only on a hit, and stores at the slot's
//     flat index.
//   - until2 (:345-347) and any (:343-344) fold a lane's slots into flags
//     a lane ((column 2 > now) and (column 3 > now) of a hit; any hit).
//     Lanes of cap <= 32 take the warp path: a warp owns 32 / cap whole
//     lanes, each thread hashes, reads the offset and clamps for its own
//     slot, and one ballot a flag folds the lanes, with no shared memory
//     and no barrier; longer lanes take the shared-flag tile (whole lanes
//     a CTA, a shared flag word a lane).
// One thread per lane walking its cap rows (the kernels these replace)
// read scattered rows a warp, decoded every column of every row, and
// stored a gate's flags and planes at a cap-byte and a 4 * cap-byte
// stride.

// Mode runs replaces pallas.py::fused_probe mode "runs" (pallas.py:364-400,
// the point-run probe of engine/spmv.py::_make_runs behind the lookups).
// One thread per key: mix32 -> bucket h -> [start, end) from off(h) and
// off(h + 1) (anchor + residual when packed) -> two bisects over column 0
// inside the bucket, the lower bound and then the upper -> (lo, ln) as
// int32; keys < 0 give (0, 0).  The TPU kernel DMA'd a cap-row block into
// VMEM first; reverse-index caps are max bucket occupancies (thousands of
// rows for a popular subject), so here each bisect step reads its one
// column-0 row straight from global memory.
//
// What bounds it: round trips to L2, one per 128-byte line a key's reads
// first touch, in the dependent chain key -> offsets -> rows, and the L2
// requests of reads that miss together.  On the main path (the arrow
// index: buckets of ~20 rows of 6-12 bytes, a folder's documents) a
// bucket is one or two lines, so the lower bisect's first reads bring
// them into L1 and the upper bisect's reads hit.  Reads issued together
// miss together: counting a small bucket's rows in one round of
// independent reads, interleaving the two bisects, issuing both bisects'
// reads at once on the guess that the bucket is the key's whole run, or
// prefetching the bucket's lines first all measured slower than the two
// bisects one after the other on packed tables, on main-path-shaped
// tables and on tables of 2-row buckets alike (PERF.md;
// gochugaru_tpu_torch/tools/probe_variants.py).  So the kernel stays the
// reference's own bisect, exact on every input by construction.
//
// The loop runs `steps = max(bit_length(cap), 1)` iterations and stops
// once the range is empty.  That equals the reference's fixed count with
// its `alive` freeze exactly: a step with n == 0 changes nothing (lo
// stays, n stays 0), so every iteration after the first empty one is a
// no-op, and the break only skips no-ops.  (With a true bucket of at most
// cap rows the range is empty after bit_length(cap) steps anyway: each
// live step leaves n <= floor(n / 2).)

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

extern "C" {
struct ProbeArgs {
  const int32_t* q0;     // [B] first key column
  const int32_t* q1;     // [B] second key column (nq == 2) or null
  long long B;           // query lanes
  const void* off;       // int32[size + 1], or uint16 residuals when off_a
  const int32_t* off_a;  // int32 anchors (packed offsets) or null
  long long size;        // bucket count (pow2)
  const void* tbl;       // int32[rows, w_raw], or uint16 lanes when packed
  long long rows;
  const int32_t* fields; // [W, 5] (bits, base, delta_of, dict_id, off_bit)
  const int32_t* dicts;  // [ndict, 256] dictionary values, last one repeated
  void* out0;
  void* out1;
  int32_t* out2;         // gate: [B, cap] caveat ids, or null (no cav lane)
  int32_t* out3;         // gate: [B, cap] context indices, or null
  const int32_t* now_ptr; // int32 clock on the device (read when non-null), or null
  int nq;
  int ashift;
  int packed;            // tbl holds uint16 lanes decoded through fields
  int w_raw;             // row stride in elements
  int cap;              // probe rows; runs: bisect bound (max bucket rows)
  int W;                 // logical columns
  int now;
  int lay_exp;           // gate: expiry column, -1 = no expiry gate
  int lay_cav;           // gate: caveat-id column (out2), -1 = none
  int lay_ctx;           // gate: context-index column (out3), -1 = none
  int tile_slots;        // slot-tile modes: slots a CTA (kernels.block_tile,
                         // gate_tile, reduce_tile, warp_tile)
  int warp;              // any/until2: 1 = the warp path (kernels.reduce_path)
};
}

__device__ __forceinline__ long long off_read(const ProbeArgs& a, long long b) {
  if (a.off_a != nullptr) {
    return (long long)a.off_a[b >> a.ashift] +
           (long long)((const uint16_t*)a.off)[b];
  }
  return (long long)((const int32_t*)a.off)[b];
}

// The slot tile's one segment a lane: cap rows from the bucket start,
// clamped as slice_blocks clamps (0 <= s <= rows - cap), as an element
// offset into tbl.
struct OffInterleaveLanes {
  ProbeArgs a;
  __device__ __forceinline__ long long segment(int2 q, int) const {
    const uint32_t h = gochugaru_mix32(q.x, q.y, a.nq);
    const long long start = off_read(a, (long long)(h & (uint32_t)(a.size - 1)));
    const long long hi = a.rows - a.cap;
    return (start < 0 ? 0 : (start > hi ? hi : start)) * a.w_raw;
  }
  __device__ __forceinline__ void segments(long long i, long long* off) const {
    off[0] = segment(make_int2(a.q0[i], a.nq > 1 ? a.q1[i] : 0), 0);
  }
};

// Modes block, gate (with PLANES int32 planes), until2 and any: the slot
// tile (or the reduced modes' warp path) over one segment a lane.
template <int MODE, int PLANES = 0>
static int launch_tile(const ProbeArgs& a, cudaStream_t st) {
  if (a.cap < 1 || a.rows < a.cap) return (int)cudaErrorInvalidValue;
  GochugaruTile t = {};
  t.seg_tbl[0] = a.tbl;
  t.seg_first[1] = a.cap;
  t.nseg = 1;
  t.capT = a.cap;
  t.W = a.W;
  t.stride = a.w_raw;
  t.packed = a.packed;
  t.tile_slots = a.tile_slots;
  t.warp = a.warp;
  t.fields = a.fields;
  t.dicts = a.dicts;
  t.out = (int32_t*)a.out0;
  t.hit = (uint8_t*)a.out0;
  t.live = (uint8_t*)a.out1;
  t.planes = GochugaruGatePlanes{a.out2, a.out3, a.lay_cav, a.lay_ctx};
  t.red0 = (uint8_t*)a.out0;
  t.red1 = (uint8_t*)a.out1;
  t.q0 = a.q0;
  t.q1 = a.q1;
  t.nq = a.nq;
  t.now = a.now;
  t.now_ptr = a.now_ptr;
  t.lay_exp = a.lay_exp;
  t.B = a.B;
  return gochugaru_launch_slot_tile<MODE, OffInterleaveLanes, PLANES>(
      t, OffInterleaveLanes{a}, st);
}

// column 0 of one row: int32 tables read it whole; packed tables decode
// field 0 (a plain range at bit 0: lane 0, and lane 1 when bits > 16)
__device__ __forceinline__ int32_t col0_read(const ProbeArgs& a, long long row) {
  if (!a.packed) return ((const int32_t*)a.tbl)[row * a.w_raw];
  const uint16_t* r = (const uint16_t*)a.tbl + row * a.w_raw;
  const int bits = a.fields[0], base = a.fields[1];
  uint32_t v = (uint32_t)r[0];
  if (bits > 16) v |= (uint32_t)r[1] << 16;
  if (bits < 32) v &= (1u << bits) - 1u;
  return (int32_t)(v + (uint32_t)base);
}

__device__ __forceinline__ long long bisect(const ProbeArgs& a, long long start,
                                            long long end, int32_t key,
                                            int steps, bool left) {
  const long long last = a.rows - 1;
  long long lo = start, n = end - start;
  for (int s = 0; s < steps && n > 0; ++s) {
    const long long half = n >> 1;
    const long long mid = lo + half;
    const int32_t v = col0_read(a, mid < 0 ? 0 : (mid > last ? last : mid));
    if (left ? (v < key) : (v <= key)) {
      lo = mid + 1;
      n = n - half - 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void fused_runs_kernel(const ProbeArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  const int32_t key = a.q0[i];
  int32_t lo_out = 0, ln_out = 0;
  if (key >= 0) {
    const uint32_t h = gochugaru_mix32(key, 0, 1);
    const long long b = (long long)(h & (uint32_t)(a.size - 1));
    const long long start = off_read(a, b), end = off_read(a, b + 1);
    const int steps = a.cap > 0 ? 32 - __clz(a.cap) : 1;
    const long long lo = bisect(a, start, end, key, steps, true);
    const long long hi = bisect(a, start, end, key, steps, false);
    lo_out = (int32_t)lo;
    ln_out = (int32_t)(hi - lo);
  }
  ((int32_t*)a.out0)[i] = lo_out;
  ((int32_t*)a.out1)[i] = ln_out;
}

extern "C" int gochugaru_fused_probe(int mode, const ProbeArgs* args,
                                     void* stream) {
  const ProbeArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.W > GOCHUGARU_MAXW || a.W < a.nq) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned grid = (unsigned)((a.B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_BLOCK:
      return launch_tile<MODE_BLOCK>(a, st);
    case MODE_ANY:
      return launch_tile<MODE_ANY>(a, st);
    case MODE_UNTIL2:
      return launch_tile<MODE_UNTIL2>(a, st);
    case MODE_GATE:
      if (a.out3 != nullptr && a.out2 == nullptr) return (int)cudaErrorInvalidValue;
      if (a.out2 != nullptr && (a.lay_cav < 0 || a.lay_cav >= a.W))
        return (int)cudaErrorInvalidValue;
      if (a.out3 != nullptr && (a.lay_ctx < 0 || a.lay_ctx >= a.W))
        return (int)cudaErrorInvalidValue;
      if (a.out3 != nullptr) return launch_tile<MODE_GATE, 2>(a, st);
      if (a.out2 != nullptr) return launch_tile<MODE_GATE, 1>(a, st);
      return launch_tile<MODE_GATE>(a, st);
    case MODE_RUNS:
      if (a.nq != 1) return (int)cudaErrorInvalidValue;
      fused_runs_kernel<<<grid, threads, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
