// Fused probe over the bucket-ALIGNED layout for Hopper (sm_90a).
//
// Replaces gochugaru_tpu/engine/pallas.py::fused_probe_aligned (modes
// block, any, until2, gate; pallas.py:444).  The layout (engine/hash.py build_aligned)
// stores bucket b's entries IN row b of a level table, cap_l slots of
// sw elements each, padded with -1; entries past a bucket's cap spill to
// the next, smaller level under a salted hash.  One probe per query lane:
//
//   for each level l: h_l = mix32(q0 ^ salt_l, q1) & (size_l - 1)
//                     -> ONE row of cap_l slots
//   slots in level order (output slot = sum_{m<l} cap_m + j) -> decode
//   (runtime pack spec) -> key compare with the UNSALTED q, q >= 0 guard
//   -> mode tail
//
// What bounds it: bytes.  A probe reads one contiguous row per level
// (tens of bytes) at a hashed address, with no dependent offset read —
// that is the layout's point against off+interleave's offset -> block
// chain — and does a few dozen integer operations per slot, far below
// the card's operations-per-byte balance.  Every mode runs the slot tile
// of probe_common.cuh, the same device code as fused_probe.cu's modes,
// with AlignedLanes below for the segment starts (one segment a level);
// resident warps hide the gather latency the TPU kernel hid with
// double-buffered row DMAs.  Levels arrive as data (pointer, rows, row
// stride, cap, host-computed salt; at most MAXL), and the decode spec is
// the same device array fused_probe.cu reads: no recompile per ladder or
// per spec.
//
// The salt XORs q0 inside the hash only; stored keys are unsalted.  The
// masked hash is always inside the level (size_l is a pow2 row count),
// so nothing clamps.  Row addressing is int64 (a level near the 3 GiB
// budget holds ~800M int32).  Padded slots hold -1 keys and never match a
// q >= 0; block mode still writes them decoded.  Bool outputs are uint8.
//
// Mode block (pallas.py:444, the same kernel's block tail) is bound by
// bytes and dominated by its OUTPUT: capT slots of W int32 a lane (capT
// 13, W 3: 156 bytes out per lane, against one row read per level).  One
// thread per lane writing its own block made each warp store touch 32
// sectors at a capT*W*4-byte stride.  It runs the slot tile of
// probe_common.cuh, the same device code as fused_probe.cu's block: per
// lane one segment per level (AlignedLanes below does the salted hashes
// once per lane), each level's row read slot by slot into a shared-memory
// tile by neighbouring threads, levels in order, and the tile stored to
// out0 as one contiguous span with 16-byte stores.
//
// Mode gate (pallas.py:444, the same kernel's gate tail) writes two uint8
// flags a slot (capT 10: 20 bytes out per lane against one packed row
// read a level), which the per-lane kernel wrote at a capT-byte stride, so
// each warp byte store spanned 32 * capT bytes to write 32.  It runs the
// same slot tile with the same AlignedLanes: the salted hashes and the
// lane's keys once per lane into shared memory, then one thread a slot --
// the key and expiry lanes read, the compare against the unsalted keys,
// the expiry applied only on a hit -- storing its two flags at the slot's
// flat index, neighbouring threads on neighbouring bytes.  Its time goes
// to the tile's launch, phase A and the slot walk more than to bytes
// (probe_common.cuh, PERF.md).  On caveated tables (pallas.py:479,
// :551-555) each slot also stores the row's caveat id and stored-context
// index (0 and -1 on a miss) as int32 planes out2 / out3, beside its
// flags.
//
// Modes any and until2 (pallas.py:444, the any and until tails,
// :539-543) fold a lane's slots into one or two flags a lane.  One thread
// a lane (the kernel they replace) decoded every column of every slot of
// every level, one after another.  Lanes of capT <= 32 take the warp path
// of the reduced modes: a warp owns 32 / capT whole lanes, each thread
// hashes its own slot's level (AlignedLanes::segment: the salted hash of
// that level only) and reads only the key fields and, for until2, columns
// 2 and 3, and one ballot a flag folds the lanes; longer lanes take the
// shared-flag tile (whole lanes a CTA, a shared flag word a lane).

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

extern "C" {
struct AlignedLevel {
  const void* tbl;    // int32[size, cap * sw], or uint16 lanes when packed
  long long size;     // rows (pow2)
  long long stride;   // row stride in elements (cap * sw)
  int cap;            // slots per row
  int salt;           // XORed into q0 for this level's hash only
};

struct AlignedArgs {
  const int32_t* q0;      // [B] first key column
  const int32_t* q1;      // [B] second key column (nq == 2) or null
  long long B;            // query lanes
  const int32_t* fields;  // [W, 5] pack spec fields, or null
  const int32_t* dicts;   // [ndict, 256] dictionary values, or null
  void* out0;
  void* out1;
  int32_t* out2;          // gate: [B, capT] caveat ids, or null (no cav lane)
  int32_t* out3;          // gate: [B, capT] context indices, or null
  const int32_t* now_ptr; // int32 clock on the device (read when non-null), or null
  int nq;
  int L;                  // levels
  int packed;             // levels hold uint16 lanes decoded through fields
  int sw;                 // slot width in elements (w, or lanes when packed)
  int capT;               // sum of the levels' caps
  int W;                  // logical columns
  int now;
  int lay_exp;            // gate: expiry column, -1 = no expiry gate
  int lay_cav;            // gate: caveat-id column (out2), -1 = none
  int lay_ctx;            // gate: context-index column (out3), -1 = none
  int tile_slots;         // slots a CTA (kernels.block_tile, gate_tile,
                          // reduce_tile, warp_tile)
  AlignedLevel lv[GOCHUGARU_MAXL];
  int warp;               // any/until2: 1 = the warp path (kernels.reduce_path)
};
}

// The slot tile's segments: level l's bucket row h_l (salted hash), as an
// element offset into that level's table.
struct AlignedLanes {
  AlignedArgs a;
  // level s's row alone: its fields picked by constant indices (no
  // indexed parameter reads, no local array), stopping at level s
  __device__ __forceinline__ long long segment(int2 q, int s) const {
    int salt = 0;
    long long size = 1, stride = 0;
#pragma unroll
    for (int l = 0; l < GOCHUGARU_MAXL; ++l) {
      if (l == s) {
        salt = a.lv[l].salt;
        size = a.lv[l].size;
        stride = a.lv[l].stride;
        break;
      }
    }
    const uint32_t h =
        gochugaru_mix32(q.x ^ salt, q.y, a.nq) & (uint32_t)(size - 1);
    return (long long)h * stride;
  }
  __device__ __forceinline__ void segments(long long i, long long* off) const {
    const int2 q = make_int2(a.q0[i], a.nq > 1 ? a.q1[i] : 0);
#pragma unroll
    for (int l = 0; l < GOCHUGARU_MAXL; ++l)
      if (l < a.L) off[l] = segment(q, l);
  }
};

// Every mode (the gate with PLANES int32 planes; any and until2 on the
// shared-flag tile or the warp path): the slot tile over one segment a
// level.
template <int MODE, int PLANES = 0>
static int launch_tile(const AlignedArgs& a, cudaStream_t st) {
  GochugaruTile t = {};
  int first = 0;
  for (int l = 0; l < a.L; ++l) {
    t.seg_tbl[l] = a.lv[l].tbl;
    t.seg_first[l] = first;
    first += a.lv[l].cap;
  }
  t.seg_first[a.L] = first;
  if (first != a.capT) return (int)cudaErrorInvalidValue;
  t.nseg = a.L;
  t.capT = a.capT;
  t.W = a.W;
  t.stride = a.sw;
  t.packed = a.packed;
  t.tile_slots = a.tile_slots;
  t.warp = a.warp;
  t.fields = a.fields;
  t.dicts = a.dicts;
  t.out = (int32_t*)a.out0;
  t.hit = (uint8_t*)a.out0;
  t.live = (uint8_t*)a.out1;
  t.q0 = a.q0;
  t.q1 = a.q1;
  t.nq = a.nq;
  t.now = a.now;
  t.now_ptr = a.now_ptr;
  t.lay_exp = a.lay_exp;
  t.planes = GochugaruGatePlanes{a.out2, a.out3, a.lay_cav, a.lay_ctx};
  t.red0 = (uint8_t*)a.out0;
  t.red1 = (uint8_t*)a.out1;
  t.B = a.B;
  return gochugaru_launch_slot_tile<MODE, AlignedLanes, PLANES>(
      t, AlignedLanes{a}, st);
}

extern "C" int gochugaru_fused_probe_aligned(int mode, const AlignedArgs* args,
                                             void* stream) {
  const AlignedArgs a = *args;
  if (a.B <= 0) return 0;
  if (a.W > GOCHUGARU_MAXW || a.W < a.nq || a.L < 1 || a.L > GOCHUGARU_MAXL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_BLOCK:
      return launch_tile<MODE_BLOCK>(a, st);
    case MODE_GATE:
      if (a.out3 != nullptr && a.out2 == nullptr) return (int)cudaErrorInvalidValue;
      if (a.out3 != nullptr) return launch_tile<MODE_GATE, 2>(a, st);
      if (a.out2 != nullptr) return launch_tile<MODE_GATE, 1>(a, st);
      return launch_tile<MODE_GATE>(a, st);
    case MODE_ANY:
      return launch_tile<MODE_ANY>(a, st);
    case MODE_UNTIL2:
      return launch_tile<MODE_UNTIL2>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
