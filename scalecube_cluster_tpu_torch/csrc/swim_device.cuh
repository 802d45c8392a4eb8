// Device helpers shared by the port's SWIM kernels: the record-key layout
// of scalecube_cluster_tpu_torch/ops/merge.py, the sender-window
// addressing, the delivered maxima, the merge lattice (merge_views) and
// the per-cell suspicion countdown, DEAD transition and aging; for the
// kernels that move four lanes a thread, the packing of int8 and int16
// lanes into one word and the L2 evict-last loads of the sender band (by
// the read-only path, or through L2 alone for planes the same launch
// wrote).
// Every kernel source that includes this header is rebuilt when it
// changes (ops/cuda_build.py hashes the headers with each source).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace swim {

constexpr int kDeadBit = 1 << 21;
constexpr int kEpochShift = 22;

// A known ALIVE record (ops/merge.py::is_alive_key).
__device__ __forceinline__ bool alive_key(int k) {
  return k >= 0 && (k & kDeadBit) == 0 && (k & 1) == 0;
}

// A known DEAD record.
__device__ __forceinline__ bool dead_key(int k) {
  return k >= 0 && (k & kDeadBit) != 0;
}

// A known SUSPECT record.
__device__ __forceinline__ bool suspect_key(int k) {
  return k >= 0 && (k & kDeadBit) == 0 && (k & 1) != 0;
}

// The sender row that feeds receiver row ``r`` of its ``group``-row block
// on one channel: row (r + rot) mod group of sender block ``ginv`` (the
// TPU kernels' roll of the sender window by group - rot).
__device__ __forceinline__ int64_t window_row(int group, int ginv, int rot, int r) {
  return (int64_t)group * ginv + ((r + rot) % group + group) % group;
}

// One delivered record ``w`` into the receiver cell's running maxima: the
// best record and the best ALIVE record (-1 = nothing yet).
__device__ __forceinline__ void offer(int w, int& best_any, int& best_alive) {
  best_any = max(best_any, w);
  if (alive_key(w)) best_alive = max(best_alive, w);
}

// ops/merge.py::merge_views on one cell: the receiver's record ``local``
// against the best delivered record and the best delivered ALIVE record
// (-1 = nothing delivered).
__device__ __forceinline__ int merge_key(int local, int best_any, int best_alive) {
  const bool known = local >= 0;
  const int e_local = local >> kEpochShift;
  const int e_any = best_any >> kEpochShift;
  const int e_alive = best_alive >> kEpochShift;
  const bool same = known && best_any >= 0 && e_any == e_local;
  const bool upd_same = same && (local & kDeadBit) == 0 && best_any > local;
  const bool intro = best_alive >= 0 && (!known || e_alive > e_local);
  int merged = upd_same ? best_any : (intro ? best_alive : local);
  if (intro && e_alive > e_any) merged = best_alive;
  return merged;
}

// One cell after its merge.
struct Cell {
  int key;   // the record
  int age;   // its age (saturating at age_stale)
  int susp;  // its suspicion countdown
};

// The suspicion countdown, the DEAD transition and aging of one cell:
// ``local`` is the receiver's record (with its point update applied, and
// ``point`` set, when it had one), ``merged`` the merge's result, ``a0``
// and ``s_loc`` the cell's age and countdown. An armed SUSPECT record that
// nothing re-armed turns DEAD when its countdown runs out; a changed cell
// ages to 0, others by one; a dead receiver row keeps its countdown; an
// inactive lane (``active`` false, sparse only) never resets or arms.
__device__ __forceinline__ Cell countdown(int local, int merged, int a0, int s_loc,
                                         bool point, bool alive_row, bool active,
                                         int susp_ticks, int age_stale) {
  const bool armed = s_loc > 0;
  const bool rearm = merged != local || point;
  const int left0 = max(s_loc - 1, 0);
  const bool expired = alive_row && armed && !rearm && left0 == 0 && suspect_key(merged);
  Cell cell;
  cell.key = expired ? ((merged | kDeadBit) & ~1) : merged;
  const bool changed = (cell.key != local || point) && alive_row && active;
  cell.age = changed ? 0 : min(a0, age_stale - 1) + 1;
  cell.susp = (suspect_key(cell.key) && active) ? ((rearm || !armed) ? susp_ticks : left0) : 0;
  if (!alive_row) cell.susp = s_loc;
  return cell;
}

// Four consecutive lanes a thread owns (the redesigned kernels): int32
// planes move as one 16-byte access, int8 planes as one 32-bit word and
// int16 planes as one 64-bit word.
constexpr int kQuad = 4;

// The four int8 lanes of a 32-bit word, sign-extended.
__device__ __forceinline__ void unpack_i8x4(uint32_t w, int (&v)[kQuad]) {
#pragma unroll
  for (int q = 0; q < kQuad; ++q) v[q] = (int)(int8_t)(w >> (8 * q));
}

// Four lanes' low bytes as one 32-bit word (int8 truncation).
__device__ __forceinline__ uint32_t pack_i8x4(const int (&v)[kQuad]) {
  const uint32_t lo = __byte_perm(v[0], v[1], 0x0040);
  const uint32_t hi = __byte_perm(v[2], v[3], 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// The four int16 lanes of a 64-bit word, sign-extended.
__device__ __forceinline__ void unpack_i16x4(uint2 w, int (&v)[kQuad]) {
  v[0] = (int)(int16_t)(w.x & 0xffffu);
  v[1] = (int)w.x >> 16;
  v[2] = (int)(int16_t)(w.y & 0xffffu);
  v[3] = (int)w.y >> 16;
}

// Four lanes' low halves as one 64-bit word (int16 truncation).
__device__ __forceinline__ uint2 pack_i16x4(const int (&v)[kQuad]) {
  return make_uint2(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
}

// An L2 policy that keeps lines past the streams (evict-last): for the
// sender band, which f receiver blocks read at unrelated times.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// 16 bytes of a read-only plane under ``policy``.
__device__ __forceinline__ int4 load_kept_x4(const int32_t* p, uint64_t policy) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// 4 bytes of a read-only plane under ``policy``.
__device__ __forceinline__ uint32_t load_kept_u32(const void* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// The same through L2 alone (ld.global.cg), for planes that other CTAs of
// the same launch wrote (the persistent core's ping-pong buffers, read
// after a grid barrier): the read-only path (.nc) and L1 may hold a line
// from before the write, L2 is coherent. 16 bytes under ``policy``.
__device__ __forceinline__ int4 load_kept_cg_x4(const int32_t* p, uint64_t policy) {
  int4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// 8 bytes through L2 alone under ``policy`` (see load_kept_cg_x4).
__device__ __forceinline__ uint2 load_kept_cg_u64(const void* p, uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.cg.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(policy));
  return v;
}

// Offer one channel's four delivered records to the lanes' maxima.
__device__ __forceinline__ void offer_x4(const int (&w)[kQuad], int (&best_any)[kQuad],
                                         int (&best_alive)[kQuad]) {
#pragma unroll
  for (int q = 0; q < kQuad; ++q) offer(w[q], best_any[q], best_alive[q]);
}

// The sparse aggregate bits of one cell of a live row: bit 0 the lane
// still holds it (young, counting down, or an unswept DEAD record of
// another member), bit 1 a SUSPECT record, bit 2 a DEAD record.
__device__ __forceinline__ int aggregate_bits(const Cell& cell, bool own, int spread,
                                              int sweep) {
  const bool dead = dead_key(cell.key);
  const bool holding =
      cell.age < spread || cell.susp > 0 || (dead && !(cell.age > sweep) && !own);
  return (holding ? 1 : 0) | (suspect_key(cell.key) ? 2 : 0) | (dead ? 4 : 0);
}

}  // namespace swim
