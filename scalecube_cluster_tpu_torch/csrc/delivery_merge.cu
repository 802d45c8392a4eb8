// Fused gossip delivery + membership merge over the dense [N, N] tables,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel scalecube_cluster_tpu/ops/pallas_tick.py::
// delivery_merge_pallas (body _kernel_factory, merge helper _merge_rows).
// Its plain PyTorch twin is scalecube_cluster_tpu_torch/ops/
// delivery_merge.py::delivery_merge_reference (the reference's XLA
// formula); the two agree bit for bit.
//
// What it computes, per receiver row i and column j:
//   - f sender rows: receiver i's sender on channel c is
//     8*ginv[c, i/8] + (i + rots[c, i/8]) % 8 (the TPU kernel's roll of the
//     8-row window by 8 - rot), as in csrc/tick_core.cu;
//   - best_any / best_alive maxima of rows[sender, j] over the edges that
//     deliver;
//   - the raw best_any on the diagonal is the self-rumor, taken before the
//     diagonal is excluded from the merge;
//   - the merge lattice against local[i, j], and the dead-receiver freeze.
//
// The TPU kernel double-buffered 2 x 8-row sender windows per grid step in
// VMEM and needed m % 128 == 0 (a lane rule; other widths fell back to XLA
// ops). Here any n % 8 == 0 runs the kernel.
//
// What bounds it on the card: bytes. The function must read rows and
// local (int32) and write merged once: 12 B per cell, 1,258,291,200 B at
// n=10240 (0.376 ms at 3.35 TB/s); its integer operations (counted in
// chip_smoke.py::delivery_merge_work) take less. An earlier kernel (one
// CTA per 8-row receiver group across all N columns, one column a thread)
// took 3.1x this bound: each sender row is read by f receiver groups at
// unrelated times and the 400 MiB of rows does not fit the 50 MB L2, so
// the f - 1 re-reads came partly from device memory; and every cell
// reloaded its f senders' offsets and edge bits from shared memory.
//
// Design, as csrc/tick_core.cu:
//   - The grid is (8-row receiver group, 256-column tile) with the groups
//     fastest (blockIdx.x), so the card runs every group of one tile at
//     once, and a sender cell's f reads fall within the time L2 holds
//     rows[:, tile] (N x 256 x 4 B = 10.5 MB at n=10240): rows comes from
//     device memory about once and the L2 serves the re-reads.
//   - Sender rows are read under an L2 evict-last policy; local and merged
//     are single-use and stream evict-first (ld/st .cs), so their 8 B per
//     cell do not push the band out.
//   - Each thread owns 4 consecutive columns, moved as 16-byte accesses.
//     Planes off 16-byte alignment take a path that moves one column at a
//     time; the arithmetic is the same. A partial last tile is masked: with
//     n % 8 == 0 a thread's 4 columns are all in or all out.
//   - Row and sender work is out of the cell loop: a sender row's offset
//     and edge bit come from shared memory once per (row, channel) and
//     thread, the row's liveness once per row; the diagonal is tested
//     once per row against the thread's span, and the self-rumor is
//     written, without atomics, by the one thread whose span holds it.
//   - Offsets are 32-bit: the wrapper refuses n*n >= 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 128;
constexpr int kQ = swim::kQuad;
// Columns of one CTA's tile: tick_core.cu's width.
constexpr int kTile = 256;
constexpr int kCols = kTile / kQ;           // threads along a row
constexpr int kRowStep = kThreads / kCols;  // rows in flight in the CTA
static_assert(kThreads % kCols == 0 && kThreads >= kGroup, "whole rows in flight");

// The thread's four columns of one plane at ``p``: kept in L2 (the
// sender band) or streamed (the receiver's own row).
template <bool kVec, bool kKeep>
__device__ __forceinline__ void load4(const int32_t* p, uint64_t keep, int (&w)[kQ]) {
  if (kVec) {
    const int4 v = kKeep ? swim::load_kept_x4(p, keep) : __ldcs(reinterpret_cast<const int4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) w[q] = p[q];
  }
}

// kF > 0: exactly kF channels, their sender loads issued together; kF == 0:
// f channels, one at a time. kVec: 16-byte aligned planes.
template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads) delivery_merge_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ local,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    int32_t* __restrict__ merged, int32_t* __restrict__ self_rumor, int n, int f) {
  const int fan = kF > 0 ? kF : f;
  const int grp = blockIdx.x;
  const int ng = gridDim.x;
  const int j0 = blockIdx.y * kTile + kQ * (threadIdx.x % kCols);

  // Per (receiver row, channel): the sender row's offset, -1 where the
  // edge is down. Per receiver row: its liveness.
  __shared__ int s_send[kGroup][kMaxFanout];
  __shared__ int s_alive[kGroup];

  for (int i = threadIdx.x; i < fan * kGroup; i += kThreads) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    const int src = (int)swim::window_row(kGroup, ginv[c * ng + grp], rots[c * ng + grp], r);
    s_send[r][c] = edge_ok[c * n + grp * kGroup + r] ? src * n : -1;
  }
  if (threadIdx.x < kGroup) s_alive[threadIdx.x] = alive[grp * kGroup + threadIdx.x];
  __syncthreads();
  if (j0 >= n) return;

  const uint64_t keep = swim::evict_last_policy();
  for (int r = threadIdx.x / kCols; r < kGroup; r += kRowStep) {
    const int row = grp * kGroup + r;
    int best_any[kQ], best_alive[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) best_any[q] = best_alive[q] = -1;
    if (kF > 0) {
      int w[kF > 0 ? kF : 1][kQ];
      int snd[kF > 0 ? kF : 1];
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        snd[c] = s_send[r][c];
        if (snd[c] >= 0) load4<kVec, true>(rows + snd[c] + j0, keep, w[c]);
      }
#pragma unroll
      for (int c = 0; c < kF; ++c)
        if (snd[c] >= 0) swim::offer_x4(w[c], best_any, best_alive);
    } else {
      for (int c = 0; c < fan; ++c) {
        const int snd = s_send[r][c];
        if (snd < 0) continue;
        int w[kQ];
        load4<kVec, true>(rows + snd + j0, keep, w);
        swim::offer_x4(w, best_any, best_alive);
      }
    }

    const int off = row * n + j0;
    int v[kQ];
    load4<kVec, false>(local + off, keep, v);
    const unsigned d_diag = (unsigned)(row - j0);
    if (d_diag < kQ) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (q == (int)d_diag) {
          self_rumor[row] = best_any[q];
          best_any[q] = -1;
          best_alive[q] = -1;
        }
      }
    }
    int out[kQ];
    if (s_alive[r]) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) out[q] = swim::merge_key(v[q], best_any[q], best_alive[q]);
    } else {
#pragma unroll
      for (int q = 0; q < kQ; ++q) out[q] = v[q];
    }
    if (kVec) {
      __stcs(reinterpret_cast<int4*>(merged + off), make_int4(out[0], out[1], out[2], out[3]));
    } else {
#pragma unroll
      for (int q = 0; q < kQ; ++q) merged[off + q] = out[q];
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <int kF, bool kVec>
void launch(dim3 grid, cudaStream_t stream, const void* rows, const void* local,
            const void* ginv, const void* rots, const void* edge_ok, const void* alive,
            void* merged, void* self_rumor, int n, int f) {
  delivery_merge_kernel<kF, kVec><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)rows, (const int32_t*)local, (const int32_t*)ginv, (const int32_t*)rots,
      (const uint8_t*)edge_ok, (const uint8_t*)alive, (int32_t*)merged, (int32_t*)self_rumor,
      n, f);
}

}  // namespace

// Launches the kernel on ``stream`` on an (n/8 receiver groups, column
// tiles) grid. Every output is written in full. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int delivery_merge_launch(
    const void* rows, const void* local, const void* ginv, const void* rots,
    const void* edge_ok, const void* alive, void* merged, void* self_rumor,
    int n, int f, void* stream) {
  if (n <= 0 || n % kGroup != 0 || f < 1 || f > kMaxFanout || (long long)n * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned(rows, 16) && aligned(local, 16) && aligned(merged, 16);
  const dim3 grid(n / kGroup, (n + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)stream;
#define DELIVERY_MERGE_ARGS grid, st, rows, local, ginv, rots, edge_ok, alive, merged, self_rumor, n, f
  if (f == 3 && vec)
    launch<3, true>(DELIVERY_MERGE_ARGS);
  else if (vec)
    launch<0, true>(DELIVERY_MERGE_ARGS);
  else
    launch<0, false>(DELIVERY_MERGE_ARGS);
#undef DELIVERY_MERGE_ARGS
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* delivery_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
