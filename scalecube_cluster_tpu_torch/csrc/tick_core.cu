// Fused dense tick core of the SWIM engine, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel scalecube_cluster_tpu/ops/pallas_tick.py::
// tick_core_pallas (body _tick_kernel_factory, merge helper _merge_rows).
// Its plain PyTorch twin is scalecube_cluster_tpu_torch/ops/tick_core.py::
// tick_core_reference; the two agree bit for bit.
//
// What it computes, per receiver row i and column j (one tick, no SYNC):
//   - f sender rows: receiver i's sender on channel c is
//     8*ginv[c, i/8] + (i + rots[c, i/8]) % 8 (the TPU kernel's roll of the
//     8-row window by 8 - rot). A sender s sends rows[s, j], except at its
//     fired FD target column fd_tgt[s], where it sends fd_key[s];
//   - best_any / best_alive maxima over the edges that deliver;
//   - the raw best_any on the diagonal is the self-rumor, then the diagonal
//     is excluded from the merge;
//   - the receiver's own record with its FD verdict applied (view1), the
//     merge lattice, the dead-receiver freeze;
//   - the suspicion countdown (int16), the DEAD transition, aging (int8 ages
//     saturate as min(age, AGE_STALE-1)+1), tombstone demotion, the young
//     payload rows_next and the per-row count known_cnt of known non-DEAD
//     non-self records.
//
// What bounds it on the card: bytes. The function must read rows, view0
// (int32), age (int8) and susp (int16) once and write view2, rows_next
// (int32), age2 and susp2: 22 B per cell, 2.31e9 B at n=10240, 0.69 ms at
// 3.35 TB/s. It needs about 67 integer operations per cell at f=3 with 85%
// of edges up (counted in chip_smoke.py::dense_core_work): 7.0e9 at
// n=10240, 0.42 ms at the INT32 rate (16.75e12/s), below the bytes but not
// far: the instructions a cell costs matter too. Two things kept an
// earlier kernel (one CTA per 8-row group across all N columns) at 2.3x
// this bound. Each sender row is read by f receiver groups at unrelated
// times, and the 400 MiB of rows does not fit the 50 MB L2, so rows came
// from device memory f times (about 30 B per cell). And every cell
// reloaded its f senders' offsets, FD columns and keys from shared memory
// and tested the FD cells and the diagonal. Staging a sender group in
// shared memory cannot help: the f readers of a group are different CTAs,
// each of which also reads f - 1 other groups, so the reuse has to come
// from L2.
//
// Design:
//   - The grid is (receiver group, column tile) with the group fastest
//     (blockIdx.x), so the card runs every group of one tile, and part of
//     the next, at once. A sender cell's f reads then fall within the time
//     L2 holds rows[:, tile] (N x 256 x 4 B = 10.5 MB at n=10240): by
//     design rows comes from device memory once and the L2 serves the
//     f - 1 re-reads (no DRAM byte count exists on the card's machine; a
//     layout whose f readers are neighbouring CTAs is 1.4% faster).
//   - Sender rows are read under an L2 evict-last policy; view0, age, susp
//     and the four outputs are single-use and stream evict-first (ld/st
//     .cs), so their ~18 B per cell do not push the band out.
//   - Each thread owns 4 consecutive columns: int32 planes move as 16-byte
//     accesses, age as one 32-bit word and susp as one 64-bit word.
//   - Row and sender work is out of the cell loop: a sender's row offset,
//     FD column and key and the edge bit are read from shared memory once
//     per (row, channel) and thread; the sender's FD column, the
//     receiver's FD cell and the diagonal are tested once per (row,
//     channel) or row against the thread's 4-column span. The rare spans
//     that hold one, and dead receiver rows, take the general path; the
//     others skip those tests.
//   - Offsets are 32-bit inside a universe: the wrapper refuses
//     n*n >= 2^31. An ensemble's B universes (sim/ensemble.py) are the
//     grid's third axis: each CTA moves every pointer to its universe
//     with a 64-bit offset, and the rest is the one-universe kernel.
//   - known_cnt: each warp sums a row's count (__reduce_add_sync), the CTA
//     adds its warps in shared memory, then one atomicAdd per (CTA, row)
//     into the [N] vector the launcher zeroes on the stream: integer
//     addition, exact in any order. self_rumor is written by the one thread
//     whose span holds the row's diagonal.
//   - Operands whose planes are not 16-byte aligned take a path that moves
//     one column at a time; the arithmetic is the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 128;
constexpr int kQ = swim::kQuad;
// Columns of one CTA's tile: the fastest of 128, 256 and 512 on the H100
// (PERF.md).
constexpr int kTile = 256;
constexpr int kCols = kTile / kQ;        // threads along a row
constexpr int kRowStep = kThreads / kCols;  // rows in flight in the CTA
static_assert(kCols % 32 == 0 && kThreads % kCols == 0, "a warp holds one row");

struct Consts {
  int spread;
  int sweep;
  int susp_ticks;
  int age_stale;
};

// The thread's four columns of one sender row, kept in L2.
template <bool kVec>
__device__ __forceinline__ void load_sender(const int32_t* p, uint64_t keep, int (&w)[kQ]) {
  if (kVec) {
    const int4 v = swim::load_kept_x4(p, keep);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) w[q] = p[q];
  }
}

// One channel's sender quad with the sender's FD column applied, offered
// to the lanes' maxima.
__device__ __forceinline__ void deliver(int (&w)[kQ], int4 snd, int j0, int (&best_any)[kQ],
                                        int (&best_alive)[kQ]) {
  const unsigned d = (unsigned)(snd.y - j0);
  if (d < kQ) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (q == (int)d) w[q] = snd.z;
  }
  swim::offer_x4(w, best_any, best_alive);
}

// The receiver's four cells: view0, age, susp (single-use, evict-first).
template <bool kVec>
__device__ __forceinline__ void load_cells(const int32_t* view0, const int8_t* age,
                                           const int16_t* susp, int off, int (&v)[kQ],
                                           int (&a)[kQ], int (&s)[kQ]) {
  if (kVec) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(view0 + off));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    swim::unpack_i8x4(__ldcs(reinterpret_cast<const unsigned int*>(age + off)), a);
    swim::unpack_i16x4(__ldcs(reinterpret_cast<const uint2*>(susp + off)), s);
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      v[q] = view0[off + q];
      a[q] = age[off + q];
      s[q] = susp[off + q];
    }
  }
}

// The four outputs of the thread's cells (evict-first).
template <bool kVec>
__device__ __forceinline__ void store_cells(int32_t* view2, int8_t* age2, int16_t* susp2,
                                            int32_t* rows_next, int off, const int (&out)[kQ],
                                            const int (&a)[kQ], const int (&s)[kQ],
                                            const int (&next)[kQ]) {
  if (kVec) {
    __stcs(reinterpret_cast<int4*>(view2 + off), make_int4(out[0], out[1], out[2], out[3]));
    __stcs(reinterpret_cast<int4*>(rows_next + off), make_int4(next[0], next[1], next[2], next[3]));
    __stcs(reinterpret_cast<unsigned int*>(age2 + off), swim::pack_i8x4(a));
    __stcs(reinterpret_cast<uint2*>(susp2 + off), swim::pack_i16x4(s));
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      view2[off + q] = out[q];
      rows_next[off + q] = next[q];
      age2[off + q] = static_cast<int8_t>(a[q]);
      susp2[off + q] = static_cast<int16_t>(s[q]);
    }
  }
}

// One cell after delivery: the merge lattice, the dead-receiver freeze,
// the countdown, DEAD transition and aging, tombstone demotion, the young
// payload and the known_cnt term.
__device__ __forceinline__ void cell_update(int view1, int a0, int s0, int best_any,
                                            int best_alive, bool cellm, bool on_diag,
                                            bool alive_row, const Consts& k, int& out, int& age,
                                            int& susp, int& next, int& known) {
  int merged = swim::merge_key(view1, best_any, best_alive);
  if (!alive_row) merged = view1;
  const swim::Cell cell = swim::countdown(view1, merged, a0, s0, cellm, alive_row, true,
                                          k.susp_ticks, k.age_stale);
  int key = cell.key;
  if (!on_diag && swim::dead_key(key) && cell.age > k.sweep && alive_row) key = -1;
  out = key;
  age = cell.age;
  susp = cell.susp;
  next = cell.age < k.spread ? key : -1;
  known += (key >= 0 && !swim::dead_key(key) && !on_diag) ? 1 : 0;
}

// kF > 0: exactly kF channels, their sender loads issued together; kF == 0:
// f channels, one at a time. kVec: 16-byte aligned planes.
template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads) tick_core_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ view0,
    const int8_t* __restrict__ age, const int16_t* __restrict__ susp,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ fd_tgt, const int32_t* __restrict__ fd_key,
    int32_t* __restrict__ view2, int8_t* __restrict__ age2, int16_t* __restrict__ susp2,
    int32_t* __restrict__ rows_next, int32_t* __restrict__ self_rumor,
    int32_t* __restrict__ known_cnt, int n, int f, Consts k) {
  const int fan = kF > 0 ? kF : f;
  const int grp = blockIdx.x;
  const int ng = gridDim.x;
  {
    // This CTA's universe.
    const size_t u = blockIdx.z;
    const size_t cells = u * (size_t)n * (size_t)n;
    rows += cells;
    view0 += cells;
    age += cells;
    susp += cells;
    view2 += cells;
    age2 += cells;
    susp2 += cells;
    rows_next += cells;
    ginv += u * f * ng;
    rots += u * f * ng;
    edge_ok += u * f * n;
    alive += u * n;
    fd_tgt += u * n;
    fd_key += u * n;
    self_rumor += u * n;
    known_cnt += u * n;
  }
  const int j0 = blockIdx.y * kTile + kQ * (threadIdx.x % kCols);
  const bool in_range = j0 < n;  // n % 8 == 0: a span is all in or all out

  // Per (receiver row, channel): the sender row's offset, its FD column
  // and key, the edge bit.
  __shared__ int4 s_send[kGroup][kMaxFanout];
  // Per receiver row: its own FD column and key, its liveness.
  __shared__ int4 s_recv[kGroup];
  __shared__ int s_known[kGroup];

  for (int i = threadIdx.x; i < fan * kGroup; i += kThreads) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    const int src = (int)swim::window_row(kGroup, ginv[c * ng + grp], rots[c * ng + grp], r);
    s_send[r][c] = make_int4(src * n, fd_tgt[src], fd_key[src], edge_ok[c * n + grp * kGroup + r]);
  }
  if (threadIdx.x < kGroup) {
    const int row = grp * kGroup + threadIdx.x;
    s_recv[threadIdx.x] = make_int4(fd_tgt[row], fd_key[row], alive[row], 0);
    s_known[threadIdx.x] = 0;
  }
  __syncthreads();

  const uint64_t keep = swim::evict_last_policy();
  for (int r = threadIdx.x / kCols; r < kGroup; r += kRowStep) {
    const int row = grp * kGroup + r;
    int known = 0;
    if (in_range) {
      int best_any[kQ], best_alive[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) best_any[q] = best_alive[q] = -1;
      if (kF > 0) {
        int w[kF > 0 ? kF : 1][kQ];
#pragma unroll
        for (int c = 0; c < kF; ++c) {
          const int4 snd = s_send[r][c];
          if (snd.w) load_sender<kVec>(rows + snd.x + j0, keep, w[c]);
        }
#pragma unroll
        for (int c = 0; c < kF; ++c) {
          const int4 snd = s_send[r][c];
          if (snd.w) deliver(w[c], snd, j0, best_any, best_alive);
        }
      } else {
        for (int c = 0; c < fan; ++c) {
          const int4 snd = s_send[r][c];
          if (!snd.w) continue;
          int w[kQ];
          load_sender<kVec>(rows + snd.x + j0, keep, w);
          deliver(w, snd, j0, best_any, best_alive);
        }
      }

      const int off = row * n + j0;
      int v[kQ], a[kQ], s[kQ];
      load_cells<kVec>(view0, age, susp, off, v, a, s);
      const int4 rcv = s_recv[r];
      const bool alive_row = rcv.z != 0;
      const unsigned d_fd = (unsigned)(rcv.x - j0);
      const unsigned d_diag = (unsigned)(row - j0);
      int out[kQ], a2[kQ], s2[kQ], next[kQ];
      if (d_fd >= kQ && d_diag >= kQ && alive_row) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          cell_update(v[q], a[q], s[q], best_any[q], best_alive[q], false, false, true, k,
                      out[q], a2[q], s2[q], next[q], known);
      } else {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const bool cellm = d_fd == (unsigned)q;
          const bool on_diag = d_diag == (unsigned)q;
          int ba = best_any[q];
          int bal = best_alive[q];
          if (on_diag) {
            self_rumor[row] = ba;
            ba = -1;
            bal = -1;
          }
          cell_update(cellm ? rcv.y : v[q], cellm ? 0 : a[q], s[q], ba, bal, cellm, on_diag,
                      alive_row, k, out[q], a2[q], s2[q], next[q], known);
        }
      }
      store_cells<kVec>(view2, age2, susp2, rows_next, off, out, a2, s2, next);
    }
    // A warp holds one row.
    known = __reduce_add_sync(0xffffffffu, known);
    if (threadIdx.x % 32 == 0 && known) atomicAdd(&s_known[r], known);
  }
  __syncthreads();
  if (threadIdx.x < kGroup && s_known[threadIdx.x])
    atomicAdd(&known_cnt[grp * kGroup + threadIdx.x], s_known[threadIdx.x]);
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <int kF, bool kVec>
void launch(dim3 grid, cudaStream_t stream, const void* rows, const void* view0,
            const void* age, const void* susp, const void* ginv, const void* rots,
            const void* edge_ok, const void* alive, const void* fd_tgt, const void* fd_key,
            void* view2, void* age2, void* susp2, void* rows_next, void* self_rumor,
            void* known_cnt, int n, int f, Consts k) {
  tick_core_kernel<kF, kVec><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)rows, (const int32_t*)view0, (const int8_t*)age, (const int16_t*)susp,
      (const int32_t*)ginv, (const int32_t*)rots, (const uint8_t*)edge_ok,
      (const uint8_t*)alive, (const int32_t*)fd_tgt, (const int32_t*)fd_key,
      (int32_t*)view2, (int8_t*)age2, (int16_t*)susp2, (int32_t*)rows_next,
      (int32_t*)self_rumor, (int32_t*)known_cnt, n, f, k);
}

}  // namespace

// Zeroes known_cnt and launches the kernel on ``stream``; every output is
// written in full. The grid is (n/8 receiver groups, column tiles, b
// universes); every operand holds b universes back to back.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tick_core_launch(
    const void* rows, const void* view0, const void* age, const void* susp,
    const void* ginv, const void* rots, const void* edge_ok, const void* alive,
    const void* fd_tgt, const void* fd_key, void* view2, void* age2,
    void* susp2, void* rows_next, void* self_rumor, void* known_cnt, int n,
    int f, int b, int spread, int sweep, int susp_ticks, int age_stale,
    void* stream) {
  if (n <= 0 || n % kGroup != 0 || f > kMaxFanout || f < 1 ||
      (long long)n * n >= (1LL << 31) || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(known_cnt, 0, sizeof(int32_t) * n * (size_t)b, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned(rows, 16) && aligned(view0, 16) && aligned(view2, 16) &&
                   aligned(rows_next, 16) && aligned(age, 4) && aligned(age2, 4) &&
                   aligned(susp, 8) && aligned(susp2, 8);
  const dim3 grid(n / kGroup, (n + kTile - 1) / kTile, b);
  const Consts k{spread, sweep, susp_ticks, age_stale};
#define TICK_CORE_ARGS                                                                    \
  grid, s, rows, view0, age, susp, ginv, rots, edge_ok, alive, fd_tgt, fd_key, view2, age2, \
      susp2, rows_next, self_rumor, known_cnt, n, f, k
  if (f == 3 && vec)
    launch<3, true>(TICK_CORE_ARGS);
  else if (vec)
    launch<0, true>(TICK_CORE_ARGS);
  else
    launch<0, false>(TICK_CORE_ARGS);
#undef TICK_CORE_ARGS
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* tick_core_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
