// Persistent k-tick sparse core of the compact-rumor SWIM engine, CUDA C++
// for sm_90a: k <= k_max plain sparse ticks in ONE cooperative launch.
//
// Replaces the TPU kernel scalecube_cluster_tpu/ops/pallas_sparse.py::
// sparse_core_pallas_persistent (body _persistent_factory). Its plain
// PyTorch twin is scalecube_cluster_tpu_torch/ops/sparse_persistent.py::
// sparse_core_persistent_reference (k chained plain sparse cores with no
// FD/SYNC points); the two agree bit for bit.
//
// What it computes: tick t (0 <= t < k) is the sparse core of
// csrc/sparse_core.cu without point updates, over the slab (int32) and
// the cold lane (int16, age | susp << 8, ops/sparse_persistent.py::
// pack_cold), with tick t's fan-out (ginv/rots [k_max, f, N/32]) and
// packed flags (edge bit c, alive bit 7; [k_max, N] int32). Tick 0 reads
// the caller's inputs, which are never written; tick t writes buffer A
// when t is even and B when t is odd, and tick t >= 1 reads what tick t-1
// wrote. The wrapper hands back A when k is odd and B when k is even. The
// last tick also yields the self-rumor (atomicMax into a -1-filled [N])
// and the per-lane aggregate, masked to the bits the fold asks for
// (atomicOr into a zero-filled [S]).
//
// Hopper differences from the TPU design. The TPU ran the (tick, block)
// grid in order on one core, so a tick's writes were done before the next
// tick's reads by construction. Here a receiver block reads arbitrary
// sender blocks of the previous tick, written by other CTAs, so ticks are
// separated by a grid-wide barrier (cooperative_groups::this_grid().sync())
// and the kernel is launched cooperatively with a grid the card can hold
// at once (occupancy x SM count; each CTA loops over the 32-row blocks).
// The ping-pong buffers are written and read inside the launch, so they
// are read with ld.global.cg (L2, never a stale L1 line) and never through
// the read-only path. The TPU kernel staged 32-row windows in VMEM; three
// windows at S=512 exceed a CTA's shared memory, so sender rows are read
// from global memory with threads along S, as in csrc/sparse_core.cu.
// k is a kernel argument and every table is sized by k_max: one build
// serves every k (the JAX zero-recompile contract).
//
// What bounds it on the card: bytes. Each tick must read the slab and the
// cold lane once and write them once: 12 B per cell, 201,326,592 B a tick
// at 32768 x 512 (0.060 ms at 3.35 TB/s); the integer operations it needs
// are the sparse core's without the point terms (counted in
// chip_smoke.py::persistent_work). This simple kernel also reads each
// sender window again per channel (f x 6 B per cell), which the L2 may
// catch, and repeats the per-row and per-sender work in every cell.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 32;
constexpr int kAliveBit = 7;
constexpr int kMaxFanout = kAliveBit;
constexpr int kThreads = 256;

// The slab and cold pointers of the launch are plain (no __restrict__):
// the A/B buffers are written by some CTAs and read by others.
__global__ void __launch_bounds__(kThreads) sparse_persistent_kernel(
    const int32_t* slab_in, const int16_t* cold_in,
    const int32_t* __restrict__ slot_subj, const int32_t* __restrict__ ginv,
    const int32_t* __restrict__ rots, const int32_t* __restrict__ flags,
    int32_t* slab_a, int16_t* cold_a, int32_t* slab_b, int16_t* cold_b,
    int32_t* self_rumor, int32_t* aggr, int n, int s, int f, int k,
    int spread, int susp_ticks, int age_stale, int sweep, int aggr_mask) {
  cg::grid_group grid = cg::this_grid();
  const int nb = n / kGroup;

  // Sender rows and edge bits per channel and receiver row; liveness.
  __shared__ int64_t w_row[kMaxFanout][kGroup];
  __shared__ uint8_t w_ok[kMaxFanout][kGroup];
  __shared__ uint8_t r_alive[kGroup];

  for (int t = 0; t < k; ++t) {
    const int32_t* src_slab = t == 0 ? slab_in : (t % 2 == 1 ? slab_a : slab_b);
    const int16_t* src_cold = t == 0 ? cold_in : (t % 2 == 1 ? cold_a : cold_b);
    int32_t* dst_slab = t % 2 == 0 ? slab_a : slab_b;
    int16_t* dst_cold = t % 2 == 0 ? cold_a : cold_b;
    const bool last = t == k - 1;
    const int32_t* t_ginv = ginv + (int64_t)t * f * nb;
    const int32_t* t_rots = rots + (int64_t)t * f * nb;
    const int32_t* t_flags = flags + (int64_t)t * n;

    for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
      for (int i = threadIdx.x; i < f * kGroup; i += blockDim.x) {
        const int c = i / kGroup;
        const int r = i % kGroup;
        w_row[c][r] = swim::window_row(kGroup, t_ginv[c * nb + blk], t_rots[c * nb + blk], r);
        w_ok[c][r] = (t_flags[blk * kGroup + r] >> c) & 1;
      }
      for (int r = threadIdx.x; r < kGroup; r += blockDim.x)
        r_alive[r] = (t_flags[blk * kGroup + r] >> kAliveBit) & 1;
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
              const int a = __ldcg(src_cold + off) & 0xFF;
              if (a < spread) swim::offer(__ldcg(src_slab + off), best_any, best_alive);
            }
          }

          const int64_t loff = (int64_t)row * s + j;
          const int local = __ldcg(src_slab + loff);
          const int cold = __ldcg(src_cold + loff);
          const int a0 = cold & 0xFF;
          const int s_loc = cold >> 8;

          const bool own = subj == row;
          if (own) {
            if (last && best_any >= 0) atomicMax(&self_rumor[row], best_any);
            best_any = -1;
            best_alive = -1;
          }

          int merged = swim::merge_key(local, best_any, best_alive);
          const bool alive_row = r_alive[r] != 0;
          if (!active || !alive_row) merged = local;

          // Suspicion countdown, DEAD transition, aging (no point updates).
          const swim::Cell cell = swim::countdown(local, merged, a0, s_loc, false, alive_row,
                                                  active, susp_ticks, age_stale);
          dst_slab[loff] = cell.key;
          dst_cold[loff] = static_cast<int16_t>((cell.age & 0xFF) | (cell.susp << 8));
          if (last && alive_row) bits |= swim::aggregate_bits(cell, own, spread, sweep);
        }
        bits &= aggr_mask;
        if (bits) atomicOr(&aggr[j], bits);
      }
      // The shared tables are rewritten for the next block.
      __syncthreads();
    }
    // Tick t is complete in its buffer before any CTA reads it.
    if (t + 1 < k) grid.sync();
  }
}

}  // namespace

// Launches ``k`` ticks as one cooperative kernel on ``stream``;
// ``self_rumor`` must hold -1 and ``aggr`` 0 on entry. ``grid_out``
// receives the number of CTAs launched. Returns a cudaError_t (0 =
// success); a card without cooperative launch gives cudaErrorNotSupported.
extern "C" int sparse_persistent_launch(
    const void* slab_in, const void* cold_in, const void* slot_subj,
    const void* ginv, const void* rots, const void* flags, void* slab_a,
    void* cold_a, void* slab_b, void* cold_b, void* self_rumor, void* aggr,
    int n, int s, int f, int k, int spread, int susp_ticks, int age_stale,
    int sweep, int aggr_mask, void* stream, int* grid_out) {
  if (n % kGroup != 0 || f < 1 || f > kMaxFanout || k < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sparse_persistent_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int nb = n / kGroup;
  const int grid = per_sm * sms < nb ? per_sm * sms : nb;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

  const int32_t* a_slab_in = (const int32_t*)slab_in;
  const int16_t* a_cold_in = (const int16_t*)cold_in;
  const int32_t* a_slot_subj = (const int32_t*)slot_subj;
  const int32_t* a_ginv = (const int32_t*)ginv;
  const int32_t* a_rots = (const int32_t*)rots;
  const int32_t* a_flags = (const int32_t*)flags;
  int32_t* a_slab_a = (int32_t*)slab_a;
  int16_t* a_cold_a = (int16_t*)cold_a;
  int32_t* a_slab_b = (int32_t*)slab_b;
  int16_t* a_cold_b = (int16_t*)cold_b;
  int32_t* a_self = (int32_t*)self_rumor;
  int32_t* a_aggr = (int32_t*)aggr;
  void* args[] = {&a_slab_in, &a_cold_in, &a_slot_subj, &a_ginv, &a_rots,
                  &a_flags, &a_slab_a, &a_cold_a, &a_slab_b, &a_cold_b,
                  &a_self, &a_aggr, &n, &s, &f, &k, &spread, &susp_ticks,
                  &age_stale, &sweep, &aggr_mask};
  err = cudaLaunchCooperativeKernel((const void*)sparse_persistent_kernel,
                                    dim3(grid), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  *grid_out = grid;
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* sparse_persistent_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
