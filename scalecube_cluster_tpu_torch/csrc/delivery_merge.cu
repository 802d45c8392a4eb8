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
// Hopper differences from the TPU design: the TPU kernel double-buffered
// 2 x 8-row sender windows per grid step in VMEM and needed m % 128 == 0
// (a lane rule; other widths fell back to XLA ops). Here one CTA owns one
// 8-row receiver group across all N columns, threads along the columns,
// and reads the sender rows straight from global memory, so any n % 8 == 0
// runs the kernel. The self-rumor is written by the one thread whose column
// is the row's diagonal: no atomics.
//
// What bounds it on the card: bytes. The function must read rows and
// local (int32) and write merged once: 12 B per cell, 1,258,291,200 B at
// n=10240 (0.376 ms at 3.35 TB/s); its integer operations (counted in
// chip_smoke.py::delivery_merge_work) take less. This simple kernel
// reads the f sender rows of every cell from device memory (f x 4 B more
// per cell), which the 50 MB L2 catches only in part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) delivery_merge_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ local,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    int32_t* __restrict__ merged, int32_t* __restrict__ self_rumor, int n,
    int f) {
  const int grp = blockIdx.x;
  const int ng = n / kGroup;

  __shared__ int64_t s_row[kMaxFanout][kGroup];
  __shared__ uint8_t s_ok[kMaxFanout][kGroup];
  __shared__ uint8_t r_alive[kGroup];

  for (int i = threadIdx.x; i < f * kGroup; i += blockDim.x) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    s_row[c][r] = swim::window_row(kGroup, ginv[c * ng + grp], rots[c * ng + grp], r);
    s_ok[c][r] = edge_ok[(int64_t)c * n + (int64_t)grp * kGroup + r];
  }
  for (int r = threadIdx.x; r < kGroup; r += blockDim.x)
    r_alive[r] = alive[grp * kGroup + r];
  __syncthreads();

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int row = grp * kGroup + r;
      int best_any = -1;
      int best_alive = -1;
      for (int c = 0; c < f; ++c)
        if (s_ok[c][r]) swim::offer(rows[s_row[c][r] * n + j], best_any, best_alive);
      if (j == row) {
        self_rumor[row] = best_any;
        best_any = -1;
        best_alive = -1;
      }
      const int64_t off = (int64_t)row * n + j;
      const int mine = local[off];
      merged[off] = r_alive[r] ? swim::merge_key(mine, best_any, best_alive) : mine;
    }
  }
}

}  // namespace

// Launches the kernel on ``stream``. Every output is written in full.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int delivery_merge_launch(
    const void* rows, const void* local, const void* ginv, const void* rots,
    const void* edge_ok, const void* alive, void* merged, void* self_rumor,
    int n, int f, void* stream) {
  if (n <= 0 || n % kGroup != 0 || f < 1 || f > kMaxFanout)
    return (int)cudaErrorInvalidValue;
  delivery_merge_kernel<<<n / kGroup, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)local, (const int32_t*)ginv,
      (const int32_t*)rots, (const uint8_t*)edge_ok, (const uint8_t*)alive,
      (int32_t*)merged, (int32_t*)self_rumor, n, f);
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* delivery_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
