// Device helpers shared by the fused probe kernels (fused_probe.cu and
// fused_probe_aligned.cu): the key hash, the packed-row decode, the
// per-mode tails of the reduced modes, and the block mode's cooperative
// tile, which both kernels launch.
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

// One packed row (uint16 lanes) -> W logical int32 columns through the
// runtime spec: fields int32[W, 5] = (bits, base, delta_of, dict_id,
// off_bit), dictionaries int32[ndict, 256] padded with their last value.
__device__ __forceinline__ void gochugaru_decode_row(
    const uint16_t* r, int W, const int32_t* fields, const int32_t* dicts,
    int32_t* cols) {
  for (int c = 0; c < W; ++c) {
    const int32_t* f = fields + 5 * c;
    const int bits = f[0], base = f[1], delta_of = f[2], dict_id = f[3];
    const int off_bit = f[4];
    uint32_t col;
    if (bits == 0) {
      col = (uint32_t)base;
    } else {
      const int lane = off_bit >> 4, sh = off_bit & 15;
      uint32_t v = (uint32_t)r[lane] >> sh;
      if (sh + bits > 16) v |= (uint32_t)r[lane + 1] << (16 - sh);
      if (bits < 32) v &= (1u << bits) - 1u;
      if (dict_id >= 0) {
        col = (uint32_t)dicts[dict_id * GOCHUGARU_DICT +
                              min(v, (uint32_t)(GOCHUGARU_DICT - 1))];
      } else {
        col = v + (uint32_t)base;
      }
    }
    if (delta_of >= 0) col += (uint32_t)cols[delta_of];
    cols[c] = (int32_t)col;
  }
}

// One decoded candidate slot through a reduced mode's tail.  ``slot`` is
// the lane's flat output slot (lane * cap + j); gate writes its hit and
// live flags (live: no expiry column, or expiry 0 or past ``now``), any /
// until2 fold into the lane's accumulators.  (Block mode is the tile
// below.)
template <int MODE>
__device__ __forceinline__ void gochugaru_slot_tail(
    const int32_t* cols, bool hit, int W, int now, int lay_exp,
    long long slot, void* out0, void* out1, bool& acc0, bool& acc1) {
  if (MODE == MODE_ANY) {
    acc0 |= hit;
  } else if (MODE == MODE_UNTIL2) {
    acc0 |= hit && cols[2] > now;
    acc1 |= hit && cols[3] > now;
  } else {  // MODE_GATE
    bool live = hit;
    if (lay_exp >= 0) {
      const int32_t e = hit ? cols[lay_exp] : 0;
      live = hit && (e == 0 || e > now);
    }
    ((uint8_t*)out0)[slot] = hit;
    ((uint8_t*)out1)[slot] = live;
  }
}

// The lane's folded outputs (bool as uint8) once every slot is seen.
template <int MODE>
__device__ __forceinline__ void gochugaru_lane_tail(long long i, void* out0,
                                                    void* out1, bool acc0,
                                                    bool acc1) {
  if (MODE == MODE_ANY) {
    ((uint8_t*)out0)[i] = acc0;
  } else if (MODE == MODE_UNTIL2) {
    ((uint8_t*)out0)[i] = acc0;
    ((uint8_t*)out1)[i] = acc1;
  }
}

// ---------------------------------------------------------------------------
// Block mode: the cooperative tile
// ---------------------------------------------------------------------------
//
// Block mode writes every lane's decoded [capT, W] int32 candidate block
// to out0 = int32[B, capT, W]; its bytes are mostly that output.  A lane's
// block is a short list of SEGMENTS, each a run of contiguous slots in
// one table: fused_probe has one (cap rows at the clamped bucket start),
// fused_probe_aligned one per level (cap_l slots of bucket h_l's row).
// Segment s of every lane shares its table, slot count and slot stride;
// only its start differs per lane, and the kernel's ``Lanes`` functor
// computes those starts (Lanes::segments(lane, off) writes nseg element
// offsets).
//
// A CTA owns one TILE: ``tile_slots`` consecutive slots of the flattened
// [B * capT] output, so its output is one contiguous span of out0.
//   A. one thread per lane the tile touches: hash, offset read, clamp (or
//      the per-level hashes) -> segment starts in shared memory; the
//      dependent offset read happens once per lane, not once per slot;
//   B. one thread per slot: its row copied into the shared tile
//      [tile_slots, W] with asynchronous 4-byte copies (cp.async: no
//      registers, and every slot of the thread in flight at once, one
//      wait for all), or decoded through the runtime pack spec straight
//      into the tile.  Neighbouring threads take neighbouring slots of
//      one lane's contiguous segment, so the row reads coalesce;
//   C. the tile copied to out0 with 16-byte streaming stores, neighbouring
//      threads on neighbouring addresses; the ragged end of the last tile
//      element by element.
// The host picks tile_slots (engine/kernels/__init__.py::block_tile) so
// that tile_slots * W is a multiple of 4 (every tile's span starts 16-byte
// aligned), and the shared bytes fit; a lane whose block passes the
// budget is walked in chunks of slots, since a tile is any run of slots.
// Table and output addresses are int64; shared indices are 32-bit.

#define GOCHUGARU_TILE_THREADS 256
#define GOCHUGARU_SMEM_MAX 232448  // per-block shared memory on sm_90

struct GochugaruTile {
  const void* seg_tbl[GOCHUGARU_MAXL];    // segment s's table (int32 or uint16)
  int seg_first[GOCHUGARU_MAXL + 1];      // segment s's first slot in a lane
  int nseg;                               // segments a lane (1..MAXL)
  int capT;                               // slots a lane (seg_first[nseg])
  int W;                                  // logical int32 columns a slot
  int stride;                             // elements between a segment's slots
  int packed;                             // tables hold uint16 lanes (decode)
  int tile_slots;                         // slots a CTA
  const int32_t* fields;                  // pack spec [W, 5], or null
  const int32_t* dicts;                   // dictionaries [ndict, 256], or null
  int32_t* out;                           // [B, capT, W]
  long long B;
};

// The most lanes one tile touches: tiles start at multiples of S, so a
// tile of whole lanes touches S / capT of them, any other at most
// ceil((S - 1) / capT) + 1.  Mirrored by kernels.block_tile.
__host__ __device__ __forceinline__ int gochugaru_tile_lanes(int S, int capT) {
  return S % capT == 0 ? S / capT : (S + capT - 2) / capT + 1;
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

template <class Lanes>
__global__ void __launch_bounds__(GOCHUGARU_TILE_THREADS)
gochugaru_block_tile_kernel(const GochugaruTile t, const Lanes lanes) {
  extern __shared__ int4 gochugaru_smem[];
  int32_t* tile = (int32_t*)gochugaru_smem;
  long long* seg_off = (long long*)(tile + t.tile_slots * t.W);

  const long long g0 = (long long)blockIdx.x * t.tile_slots;
  const long long left = t.B * t.capT - g0;
  const int n = left < t.tile_slots ? (int)left : t.tile_slots;
  const long long lane0 = g0 / t.capT;
  const int j0 = (int)(g0 - lane0 * t.capT);
  const int nl = (j0 + n - 1) / t.capT + 1;

  // A: segment starts, one thread per lane
  for (int k = threadIdx.x; k < nl; k += blockDim.x)
    lanes.segments(lane0 + k, seg_off + k * t.nseg);
  __syncthreads();

  // B: one slot a thread, into the shared tile; (k, j) = the slot's lane
  // in the tile and slot in the lane, advanced by blockDim slots a step
  const int dk = blockDim.x / t.capT, dj = blockDim.x - dk * t.capT;
  int k = (j0 + (int)threadIdx.x) / t.capT;
  int j = j0 + (int)threadIdx.x - k * t.capT;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const void* tbl = t.seg_tbl[0];
    int s = 0, first = 0;
#pragma unroll
    for (int m = 1; m < GOCHUGARU_MAXL; ++m) {
      if (m < t.nseg && j >= t.seg_first[m]) {
        s = m;
        first = t.seg_first[m];
        tbl = t.seg_tbl[m];
      }
    }
    const long long at =
        seg_off[k * t.nseg + s] + (long long)(j - first) * t.stride;
    int32_t* dst = tile + p * t.W;
    if (t.packed) {
      gochugaru_decode_row((const uint16_t*)tbl + at, t.W, t.fields, t.dicts,
                           dst);
    } else {
      gochugaru_copy_row((const int32_t*)tbl + at, t.W, dst);
    }
    k += dk;
    j += dj;
    if (j >= t.capT) {
      j -= t.capT;
      ++k;
    }
  }
  gochugaru_copy_wait();
  __syncthreads();

  // C: the tile's contiguous span of out0, 16 bytes a thread
  int32_t* out = t.out + g0 * t.W;
  const int ne = n * t.W;
  const int nv = ne >> 2;
  for (int v = threadIdx.x; v < nv; v += blockDim.x)
    __stcs((int4*)out + v, ((const int4*)tile)[v]);
  for (int e = (nv << 2) + threadIdx.x; e < ne; e += blockDim.x)
    __stcs(out + e, tile[e]);
}

// Launch the tile kernel over every lane; returns a cudaError_t as int.
template <class Lanes>
int gochugaru_launch_block_tile(const GochugaruTile& t, const Lanes& lanes,
                                cudaStream_t st) {
  const int S = t.tile_slots;
  if (t.nseg < 1 || t.nseg > GOCHUGARU_MAXL || t.capT < 1 || S < 1 ||
      S > GOCHUGARU_SMEM_MAX || (S * t.W) % 4 != 0 ||
      ((uintptr_t)t.out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * t.W * 4 +
                      (size_t)gochugaru_tile_lanes(S, t.capT) * t.nseg * 8;
  if (smem > GOCHUGARU_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long tiles = (t.B * t.capT + S - 1) / S;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gochugaru_block_tile_kernel<Lanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gochugaru_block_tile_kernel<Lanes>
      <<<(unsigned)tiles, GOCHUGARU_TILE_THREADS, smem, st>>>(t, lanes);
  return (int)cudaGetLastError();
}
