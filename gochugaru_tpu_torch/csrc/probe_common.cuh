// Device helpers shared by the fused probe kernels (fused_probe.cu and
// fused_probe_aligned.cu): the key hash, the packed-row decode and the
// per-mode tails.
#pragma once

#include <stdint.h>

#define GOCHUGARU_MAXW 16
#define GOCHUGARU_DICT 256

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

// One decoded candidate slot through a mode's tail.  ``slot`` is the
// lane's flat output slot (lane * cap + j); block writes the row, gate
// its hit and live flags (live: no expiry column, or expiry 0 or past
// ``now``), any / until2 fold into the lane's accumulators.
template <int MODE>
__device__ __forceinline__ void gochugaru_slot_tail(
    const int32_t* cols, bool hit, int W, int now, int lay_exp,
    long long slot, void* out0, void* out1, bool& acc0, bool& acc1) {
  if (MODE == MODE_BLOCK) {
    int32_t* o = (int32_t*)out0 + slot * W;
    for (int c = 0; c < W; ++c) o[c] = cols[c];
  } else if (MODE == MODE_ANY) {
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
