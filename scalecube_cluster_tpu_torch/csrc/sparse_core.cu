// Fused sparse tick core of the compact-rumor SWIM engine, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel scalecube_cluster_tpu/ops/pallas_sparse.py::
// sparse_core_pallas (body _kernel_factory, helpers pack_flags / pack_slots
// and ops/pallas_tick.py::_merge_rows) with the full residual fold
// {countdown, points, wb_mask, view_rows} and no shard mode. Its plain
// PyTorch twin is scalecube_cluster_tpu_torch/ops/sparse_core.py::
// sparse_core_reference; the two agree bit for bit.
//
// What it computes, per receiver row r and slab lane j (one tick):
//   - f sender windows: receiver r of 32-row block b reads sender row
//     32*ginv[c,b] + (r + rots[c,b]) % 32 on channel c (the TPU kernel's
//     roll by 32 - rot); the SENDER's FD/SYNC point update overrides its
//     cell first (SYNC wins a same-cell collision) and makes it young;
//   - the young mask, and best_any / best_alive maxima under the edge bits;
//   - the self-rumor (the lane whose subject is the receiver itself) is
//     extracted, then excluded from the merge;
//   - the merge lattice on the receiver's point-updated record, the
//     inactive-lane and dead-row freezes;
//   - the suspicion countdown, the DEAD transition and aging (int8 ages
//     saturate as min(age, AGE_STALE-1)+1, countdowns are int16);
//   - the per-lane aggregate: bit 0 = a live viewer still holds the slot
//     (the write-back pin rule), bit 1 = a live viewer holds SUSPECT,
//     bit 2 = a live viewer holds DEAD.
//
// Hopper differences from the TPU design: blocks run in parallel in no
// order, so the aggregate that the TPU grid OR-accumulated in one revisited
// block is an atomicOr into a zero-filled [S] vector (OR is order-free, so
// the result is exact), and the self-rumor is an atomicMax into a [N]
// vector the wrapper fills with -1. Each CTA loads its own fan-out indices,
// edge bits and point lanes into shared memory; there is no scalar prefetch.
//
// What bounds it on the card: bytes, narrowly. The function must read 7
// bytes per cell (slab i32, age i8, susp i16) and write 7: about 235 MB a
// tick at 32768 x 512, 0.070 ms at 3.35 TB/s. It needs about 62 integer
// operations per cell of an active lane, 30 per cell of an idle lane, 12
// per sender cell and 2 per delivered record, the point, own-lane and
// edge tests once per row (counted in chip_smoke.py::core_work): 1.1e9 on
// the smoke test's operands, 0.067 ms at the card's INT32 rate. This
// kernel does more (it repeats the per-row and per-sender work in every
// cell) and reads each sender window again (f x (4 + 1) B/cell more, 29
// B/cell in all at f = 3), which the L2 may catch.
//
// Design: the simple one. One CTA per 32-row receiver block covering all S
// lanes (N/32 CTAs), threads along S so every warp reads a row segment
// coalesced; sender windows are read straight from global memory (the L2
// holds them). No shared-memory staging of windows, no TMA, no vectorised
// int8 loads yet: that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 32;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) sparse_core_kernel(
    const int32_t* __restrict__ slab, const int8_t* __restrict__ age,
    const int16_t* __restrict__ susp, const int32_t* __restrict__ slot_subj,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ fd_slot, const int32_t* __restrict__ sy_slot,
    const int32_t* __restrict__ fd_key, const int32_t* __restrict__ sy_key,
    int32_t* __restrict__ slab2, int8_t* __restrict__ age2,
    int16_t* __restrict__ susp2, int32_t* __restrict__ self_rumor,
    int32_t* __restrict__ aggr, int n, int s, int f, int spread,
    int susp_ticks, int age_stale, int sweep) {
  const int blk = blockIdx.x;
  const int nb = n / kGroup;

  // Sender rows and their point lanes, per channel and receiver row.
  __shared__ int64_t w_row[kMaxFanout][kGroup];
  __shared__ int w_fd[kMaxFanout][kGroup];
  __shared__ int w_sy[kMaxFanout][kGroup];
  __shared__ int w_fdk[kMaxFanout][kGroup];
  __shared__ int w_syk[kMaxFanout][kGroup];
  __shared__ uint8_t w_ok[kMaxFanout][kGroup];
  // The receiver rows' own point lanes and liveness.
  __shared__ int r_fd[kGroup];
  __shared__ int r_sy[kGroup];
  __shared__ int r_fdk[kGroup];
  __shared__ int r_syk[kGroup];
  __shared__ uint8_t r_alive[kGroup];

  for (int i = threadIdx.x; i < f * kGroup; i += blockDim.x) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    const int64_t src = swim::window_row(kGroup, ginv[c * nb + blk], rots[c * nb + blk], r);
    w_row[c][r] = src;
    w_fd[c][r] = fd_slot[src];
    w_sy[c][r] = sy_slot[src];
    w_fdk[c][r] = fd_key[src];
    w_syk[c][r] = sy_key[src];
    w_ok[c][r] = edge_ok[(int64_t)c * n + (int64_t)blk * kGroup + r];
  }
  for (int r = threadIdx.x; r < kGroup; r += blockDim.x) {
    const int row = blk * kGroup + r;
    r_fd[r] = fd_slot[row];
    r_sy[r] = sy_slot[row];
    r_fdk[r] = fd_key[row];
    r_syk[r] = sy_key[row];
    r_alive[r] = alive[row];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    const int subj = slot_subj[j];
    const bool active = subj >= 0;
    int bits = 0;
    for (int r = 0; r < kGroup; ++r) {
      const int row = blk * kGroup + r;
      int best_any = -1;
      int best_alive = -1;
      if (active) {
        for (int c = 0; c < f; ++c) {
          if (!w_ok[c][r]) continue;
          const int64_t off = w_row[c][r] * s + j;
          int w = slab[off];
          int a = age[off];
          if (j == w_sy[c][r]) {
            w = w_syk[c][r];
            a = 0;
          } else if (j == w_fd[c][r]) {
            w = w_fdk[c][r];
            a = 0;
          }
          if (a < spread) swim::offer(w, best_any, best_alive);
        }
      }

      const int64_t loff = (int64_t)row * s + j;
      int local = slab[loff];
      int a0 = age[loff];
      bool point = false;
      if (j == r_sy[r]) {
        local = r_syk[r];
        a0 = 0;
        point = true;
      } else if (j == r_fd[r]) {
        local = r_fdk[r];
        a0 = 0;
        point = true;
      }

      const bool own = subj == row;
      if (own) {
        if (best_any >= 0) atomicMax(&self_rumor[row], best_any);
        best_any = -1;
        best_alive = -1;
      }

      // Merge lattice (ops/merge.py::merge_views).
      int merged = swim::merge_key(local, best_any, best_alive);
      const bool alive_row = r_alive[r] != 0;
      if (!active || !alive_row) merged = local;

      // Suspicion countdown, DEAD transition, aging.
      const swim::Cell cell = swim::countdown(local, merged, a0, susp[loff], point,
                                              alive_row, active, susp_ticks, age_stale);
      slab2[loff] = cell.key;
      age2[loff] = static_cast<int8_t>(cell.age);
      susp2[loff] = static_cast<int16_t>(cell.susp);
      if (alive_row) bits |= swim::aggregate_bits(cell, own, spread, sweep);
    }
    if (bits) atomicOr(&aggr[j], bits);
  }
}

}  // namespace

// Launches the kernel on ``stream``; ``self_rumor`` must hold -1 and ``aggr``
// 0 on entry. Returns the cudaError_t of the launch (0 = success).
extern "C" int sparse_core_launch(
    const void* slab, const void* age, const void* susp, const void* slot_subj,
    const void* ginv, const void* rots, const void* edge_ok, const void* alive,
    const void* fd_slot, const void* sy_slot, const void* fd_key,
    const void* sy_key, void* slab2, void* age2, void* susp2, void* self_rumor,
    void* aggr, int n, int s, int f, int spread, int susp_ticks, int age_stale,
    int sweep, void* stream) {
  if (n % kGroup != 0 || f > kMaxFanout || f < 1) return (int)cudaErrorInvalidValue;
  sparse_core_kernel<<<n / kGroup, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)slab, (const int8_t*)age, (const int16_t*)susp,
      (const int32_t*)slot_subj, (const int32_t*)ginv, (const int32_t*)rots,
      (const uint8_t*)edge_ok, (const uint8_t*)alive, (const int32_t*)fd_slot,
      (const int32_t*)sy_slot, (const int32_t*)fd_key, (const int32_t*)sy_key,
      (int32_t*)slab2, (int8_t*)age2, (int16_t*)susp2, (int32_t*)self_rumor,
      (int32_t*)aggr, n, s, f, spread, susp_ticks, age_stale, sweep);
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* sparse_core_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
