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
// Hopper differences from the TPU design: the TPU grid carried self_rumor
// and known_cnt across its sequential lane-block axis. Here one CTA owns one
// 8-row receiver group across all N columns, so known_cnt is a reduction
// inside the CTA (warp shuffles, then shared memory) written once per row,
// and self_rumor is written by the one thread whose column is the row's
// diagonal. No atomics; the result does not depend on block order. Each
// CTA loads its sender rows, FD lanes and edge bits into shared memory; there
// is no scalar prefetch.
//
// What bounds it on the card: bytes. The function must read rows, view0
// (int32), age (int8) and susp (int16) once and write view2, rows_next
// (int32), age2 and susp2: 22 B per cell, 2.31e9 B at n=10240, 0.69 ms at
// 3.35 TB/s. It needs about 67 integer operations per cell at f=3 with 85%
// of edges up (chip_smoke.py's seeded operands; counted in
// chip_smoke.py::dense_core_work): 57 per cell, 5 per sender cell, 2 per
// delivered record, the diagonal, FD-cell and edge tests once per row.
// That is 7.0e9 at n=10240, 0.42 ms at the INT32 rate (16.75e12/s), below
// the bytes. This simple kernel does more (it repeats the per-row and
// per-sender work in every cell) and moves about 30 B per cell: it reads
// the f=3 sender rows of every cell from device memory (a sender group is
// read by f receiver groups at different times, and the 400 MiB rows does
// not fit the 50 MB L2).
//
// Design: the simple one. One CTA of 256 threads per 8-row receiver group
// (N/8 CTAs), threads along the columns so every warp reads each row segment
// coalesced, each thread walking its columns and the group's 8 rows. No
// shared-memory staging of the sender windows, no vector loads yet: later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) tick_core_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ view0,
    const int8_t* __restrict__ age, const int16_t* __restrict__ susp,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ fd_tgt, const int32_t* __restrict__ fd_key,
    int32_t* __restrict__ view2, int8_t* __restrict__ age2,
    int16_t* __restrict__ susp2, int32_t* __restrict__ rows_next,
    int32_t* __restrict__ self_rumor, int32_t* __restrict__ known_cnt, int n,
    int f, int spread, int sweep, int susp_ticks, int age_stale) {
  const int grp = blockIdx.x;
  const int ng = n / kGroup;

  // Sender rows with their FD lanes, per channel and receiver row.
  __shared__ int64_t s_row[kMaxFanout][kGroup];
  __shared__ int s_tgt[kMaxFanout][kGroup];
  __shared__ int s_key[kMaxFanout][kGroup];
  __shared__ uint8_t s_ok[kMaxFanout][kGroup];
  // The receiver rows' own FD lanes and liveness.
  __shared__ int r_tgt[kGroup];
  __shared__ int r_key[kGroup];
  __shared__ uint8_t r_alive[kGroup];
  __shared__ int warp_cnt[kWarps][kGroup];

  for (int i = threadIdx.x; i < f * kGroup; i += blockDim.x) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    const int64_t src = swim::window_row(kGroup, ginv[c * ng + grp], rots[c * ng + grp], r);
    s_row[c][r] = src;
    s_tgt[c][r] = fd_tgt[src];
    s_key[c][r] = fd_key[src];
    s_ok[c][r] = edge_ok[(int64_t)c * n + (int64_t)grp * kGroup + r];
  }
  for (int r = threadIdx.x; r < kGroup; r += blockDim.x) {
    const int row = grp * kGroup + r;
    r_tgt[r] = fd_tgt[row];
    r_key[r] = fd_key[row];
    r_alive[r] = alive[row];
  }
  __syncthreads();

  int cnt[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) cnt[r] = 0;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int row = grp * kGroup + r;
      int best_any = -1;
      int best_alive = -1;
      for (int c = 0; c < f; ++c) {
        if (!s_ok[c][r]) continue;
        int w = rows[s_row[c][r] * n + j];
        if (j == s_tgt[c][r]) w = s_key[c][r];
        swim::offer(w, best_any, best_alive);
      }
      const bool on_diag = j == row;
      if (on_diag) {
        self_rumor[row] = best_any;
        best_any = -1;
        best_alive = -1;
      }

      const int64_t off = (int64_t)row * n + j;
      const bool cellm = j == r_tgt[r];
      const int view1 = cellm ? r_key[r] : view0[off];
      const int a0 = cellm ? 0 : age[off];

      // Merge lattice (ops/merge.py::merge_views).
      int merged = swim::merge_key(view1, best_any, best_alive);
      const bool alive_row = r_alive[r] != 0;
      if (!alive_row) merged = view1;

      // Suspicion countdown, DEAD transition, aging, tombstone demotion.
      const swim::Cell cell = swim::countdown(view1, merged, a0, susp[off], cellm, alive_row,
                                              true, susp_ticks, age_stale);
      int out = cell.key;
      if (!on_diag && swim::dead_key(out) && cell.age > sweep && alive_row) out = -1;

      view2[off] = out;
      age2[off] = static_cast<int8_t>(cell.age);
      susp2[off] = static_cast<int16_t>(cell.susp);
      rows_next[off] = cell.age < spread ? out : -1;
      cnt[r] += (out >= 0 && !swim::dead_key(out) && !on_diag) ? 1 : 0;
    }
  }

  // known_cnt: reduce each row's count over the CTA, write it once.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    int v = cnt[r];
    for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_cnt[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < kGroup) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_cnt[w][threadIdx.x];
    known_cnt[grp * kGroup + threadIdx.x] = total;
  }
}

}  // namespace

// Launches the kernel on ``stream``. Every output is written in full.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tick_core_launch(
    const void* rows, const void* view0, const void* age, const void* susp,
    const void* ginv, const void* rots, const void* edge_ok, const void* alive,
    const void* fd_tgt, const void* fd_key, void* view2, void* age2,
    void* susp2, void* rows_next, void* self_rumor, void* known_cnt, int n,
    int f, int spread, int sweep, int susp_ticks, int age_stale,
    void* stream) {
  if (n <= 0 || n % kGroup != 0 || f > kMaxFanout || f < 1)
    return (int)cudaErrorInvalidValue;
  tick_core_kernel<<<n / kGroup, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)view0, (const int8_t*)age,
      (const int16_t*)susp, (const int32_t*)ginv, (const int32_t*)rots,
      (const uint8_t*)edge_ok, (const uint8_t*)alive, (const int32_t*)fd_tgt,
      (const int32_t*)fd_key, (int32_t*)view2, (int8_t*)age2,
      (int16_t*)susp2, (int32_t*)rows_next, (int32_t*)self_rumor,
      (int32_t*)known_cnt, n, f, spread, sweep, susp_ticks, age_stale);
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* tick_core_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
