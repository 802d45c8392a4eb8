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
// edge bits (edge_ok [k_max, f, N]) and the rows' liveness. Tick 0 reads
// the caller's slab, age (int8) and susp (int16) planes, which are never
// written, and packs the cold lane in registers; tick t < k-1 writes
// buffer pair A when t is even and B when t is odd, and tick t >= 1 reads
// what tick t-1 wrote; the last tick writes its slab to that pair and the
// age and susp output planes unpacked (unpack_cold). The wrapper hands
// back A's slab when k is odd and B's when k is even. The last tick also
// yields the self-rumor (atomicMax into [N], which the launcher fills with
// -1) and the per-lane aggregate, masked to the bits the fold asks for
// (atomicOr into [S], which it zeroes).
//
// Hopper differences from the TPU design. The TPU ran the (tick, block)
// grid in order on one core, so a tick's writes were done before the next
// tick's reads by construction. Here a receiver block reads arbitrary
// sender blocks of the previous tick, written by other CTAs, so ticks are
// separated by a grid-wide barrier (cooperative_groups::this_grid().sync())
// and the kernel is launched cooperatively with a grid the card can hold
// at once (occupancy x SM count). The ping-pong buffers are written and
// read inside the launch, so they are read through L2 alone
// (swim::load_kept_cg_*: ld.global.cg) and never by the read-only path,
// which may hold a line from before the write; only the caller's planes
// take .nc. k is a kernel argument and every table is sized by k_max: one
// build serves every k (the JAX zero-recompile contract).
//
// What bounds it on the card. Each tick must stream its state: 12 B a cell
// (slab and cold read once, written once), 201,326,592 B a tick at
// 32768 x 512, 0.060 ms at 3.35 TB/s, since registers, shared memory and
// the 50 MB L2 together cannot hold the 96 MB state between ticks; the
// integer operations of a plain tick take less (chip_smoke.py::
// persistent_work counts both). An earlier kernel (CTAs walking 32-row
// blocks across all S lanes, one lane a thread) took 0.213 ms a tick:
// a tick's sender band was the whole state, so the f - 1 re-reads of a
// sender cell came partly from device memory; every cell reloaded the
// senders' rows, edge bits and liveness from shared memory; and its
// wrapper spent ~0.23 ms a call packing and unpacking the cold lane in
// six elementwise kernels, and packed the edge bits and liveness into one
// word a row in seven more.
//
// Design, as csrc/sparse_core.cu:
//   - A tick's work items are (32-row receiver block, 128-lane tile) pairs
//     with the blocks fastest; the CTAs stride over them in that order, so
//     the items in flight cover about one tile, and a sender cell's f
//     reads fall within the time L2 holds the band (slab, cold)[:, tile]
//     (N x 128 x 6 B = 25 MB at n=32768). The band and the receiver's own
//     cells are read under an L2 evict-last policy, and every store
//     streams evict-first (st.cs; 0.9% faster for the ping-pong than
//     write-back stores on the H100). Odd ticks walk the tiles in
//     reverse, so a tick starts on the tile the previous one wrote last
//     (1.1-1.3% faster).
//   - Each thread owns 4 consecutive lanes: the slab moves as 16-byte
//     accesses, the cold lane as one 64-bit word, the caller's age as one
//     32-bit word and its susp as one 64-bit word. The wrapper refuses
//     caller planes off 16-byte alignment and allocates every other
//     plane. S % 128 == 0.
//   - Row and sender work is out of the cell loop: a sender row's offset
//     and edge bit come from shared memory once per (row, channel) and
//     thread, the row's liveness once per row; the own lane is tested
//     once per row, where a subject of the thread's span is a row of the
//     block. Those spans and dead rows take the general path.
//   - Offsets are 32-bit: the wrapper refuses n*S >= 2^31.
//   - The last tick ORs the aggregate over the item's 32 rows in shared
//     memory, then one atomicOr per lane word and item.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 32;
// The reference's limit (its packed flags word holds liveness in bit 7).
constexpr int kMaxFanout = 7;
constexpr int kThreads = 128;
// CTAs an SM must hold: caps the kernel at 64 registers. The f=3 kernel
// spills a little there, and still runs 11% faster than at 7 CTAs an SM
// (72 registers, no spill) on the H100 (PERF.md).
constexpr int kMinBlocks = 8;
constexpr int kQ = swim::kQuad;
// Lanes of one work item's tile (the grid walks items, blocks fastest).
constexpr int kTile = 128;
constexpr int kCols = kTile / kQ;           // threads along a row
constexpr int kRowStep = kThreads / kCols;  // rows in flight in the CTA
static_assert(kThreads % kCols == 0, "whole rows in flight");
static_assert(kThreads >= kTile && kThreads >= kGroup, "one shared entry a thread");

// Where a tick reads its state: the caller's planes (tick 0) or the
// ping-pong pair the previous tick wrote.
enum Source { kCaller, kPingPong };

struct Consts {
  int spread;
  int susp_ticks;
  int age_stale;
  int sweep;
  int aggr_mask;
};

struct Planes {
  const int32_t* slab_in;  // the caller's state, read by tick 0
  const int8_t* age_in;
  const int16_t* susp_in;
  int32_t* slab[2];  // the ping-pong pairs A and B
  int16_t* cold[2];
  int8_t* age_out;  // the last tick's unpacked cold lane
  int16_t* susp_out;
};

// The four lanes' low bytes of a cold word (the ages, unsigned).
__device__ __forceinline__ uint32_t cold_lo(uint2 c) { return __byte_perm(c.x, c.y, 0x6420); }
// The four lanes' high bytes of a cold word (the countdowns).
__device__ __forceinline__ uint32_t cold_hi(uint2 c) { return __byte_perm(c.x, c.y, 0x7531); }

// The thread's 4 lanes of a sender row at ``off``: records and ages (one
// unsigned byte a lane), kept in L2.
template <int kIn>
__device__ __forceinline__ void load_band(const Planes& p, const int32_t* slab,
                                          const int16_t* cold, int off, uint64_t keep,
                                          int (&w)[kQ], uint32_t& ages) {
  if (kIn == kPingPong) {
    const int4 x = swim::load_kept_cg_x4(slab + off, keep);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    ages = cold_lo(swim::load_kept_cg_u64(cold + off, keep));
  } else {
    const int4 x = swim::load_kept_x4(p.slab_in + off, keep);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    ages = swim::load_kept_u32(p.age_in + off, keep);
  }
}

// The receiver's 4 cells: records, ages (unsigned bytes) and countdowns
// (the cold lane's high bytes; at tick 0 the low byte of the caller's
// susp, as packing keeps it).
template <int kIn>
__device__ __forceinline__ void load_own(const Planes& p, const int32_t* slab,
                                         const int16_t* cold, int off, uint64_t keep,
                                         int (&v)[kQ], uint32_t& lo, uint32_t& hi) {
  if (kIn == kPingPong) {
    const int4 x = swim::load_kept_cg_x4(slab + off, keep);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    const uint2 c = swim::load_kept_cg_u64(cold + off, keep);
    lo = cold_lo(c);
    hi = cold_hi(c);
    return;
  }
  load_band<kIn>(p, slab, cold, off, keep, v, lo);
  const uint2 sp = __ldcs(reinterpret_cast<const uint2*>(p.susp_in + off));
  hi = __byte_perm(sp.x, sp.y, 0x6420);
}

// One channel's sender quad into the lanes' maxima: young records (age <
// spread) are offered, stale ones as -1, which changes neither.
__device__ __forceinline__ void deliver(const int (&w)[kQ], uint32_t ages, int spread,
                                        int (&best_any)[kQ], int (&best_alive)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    swim::offer((int)((ages >> (8 * q)) & 0xFF) < spread ? w[q] : -1, best_any[q],
                best_alive[q]);
}

// One cell after delivery: the merge lattice, the inactive-lane and
// dead-row freezes, the countdown, DEAD transition and aging. Returns the
// cell's aggregate bits (0 for a dead row).
__device__ __forceinline__ int cell_update(int local, int a0, int s0, int best_any,
                                           int best_alive, bool own, bool active,
                                           bool alive_row, const Consts& k, int& key, int& age,
                                           int& susp) {
  int merged = swim::merge_key(local, best_any, best_alive);
  if (!active || !alive_row) merged = local;
  const swim::Cell cell = swim::countdown(local, merged, a0, s0, false, alive_row, active,
                                          k.susp_ticks, k.age_stale);
  key = cell.key;
  age = cell.age;
  susp = cell.susp;
  return alive_row ? swim::aggregate_bits(cell, own, k.spread, k.sweep) : 0;
}

// The thread's 4 cells out: the slab, and the cold lane packed (a tick
// that feeds another) or unpacked into the age and susp planes (the last:
// age & 0xFF as int8, the countdown's low byte sign-extended to int16).
template <bool kLast>
__device__ __forceinline__ void store_cells(const Planes& p, int32_t* slab, int16_t* cold,
                                            int off, const int (&key)[kQ], const int (&a)[kQ],
                                            const int (&s)[kQ]) {
  const uint32_t ages = swim::pack_i8x4(a);
  __stcs(reinterpret_cast<int4*>(slab + off), make_int4(key[0], key[1], key[2], key[3]));
  if (kLast) {
    int s8[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) s8[q] = (int)(int8_t)s[q];
    __stcs(reinterpret_cast<unsigned int*>(p.age_out + off), ages);
    __stcs(reinterpret_cast<uint2*>(p.susp_out + off), swim::pack_i16x4(s8));
  } else {
    const uint32_t hi = swim::pack_i8x4(s);
    __stcs(reinterpret_cast<uint2*>(cold + off),
           make_uint2(__byte_perm(ages, hi, 0x5140), __byte_perm(ages, hi, 0x7362)));
  }
}

struct Shared {
  int send[kGroup][kMaxFanout];  // a sender row's offset, -1 where the edge is down
  int alive[kGroup];             // the receiver row's liveness
  int aggr[kTile];               // the item's aggregate bits (last tick)
};

// One tick over its work items. kF > 0: exactly kF channels, their band
// loads issued together; kF == 0: f channels, one at a time.
template <int kF, int kIn, bool kLast>
__device__ __forceinline__ void run_tick(
    const Planes& p, const int32_t* src_slab, const int16_t* src_cold, int32_t* dst_slab,
    int16_t* dst_cold, const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ slot_subj,
    int32_t* self_rumor, int32_t* aggr, int n, int s, int f, bool reverse, const Consts& k,
    Shared& sh) {
  const int fan = kF > 0 ? kF : f;
  const int nb = n / kGroup;
  const int tiles = s / kTile;
  const int tx = threadIdx.x % kCols;
  const uint64_t keep = swim::evict_last_policy();

  for (int item = blockIdx.x; item < nb * tiles; item += gridDim.x) {
    const int blk = item % nb;
    const int tile = reverse ? tiles - 1 - item / nb : item / nb;
    const int row0 = blk * kGroup;
    for (int i = threadIdx.x; i < fan * kGroup; i += kThreads) {
      const int c = i / kGroup;
      const int r = i % kGroup;
      const int src = (int)swim::window_row(kGroup, ginv[c * nb + blk], rots[c * nb + blk], r);
      sh.send[r][c] = edge_ok[c * n + row0 + r] ? src * s : -1;
    }
    if (threadIdx.x < kGroup) sh.alive[threadIdx.x] = alive[row0 + threadIdx.x];
    if (kLast && threadIdx.x < kTile) sh.aggr[threadIdx.x] = 0;
    __syncthreads();

    // Lane facts, fixed across rows.
    const int j0 = tile * kTile + kQ * tx;
    int subj[kQ];
    bool active[kQ];
    bool any_active = false;
    bool own_rows = false;  // some subject of the span is a row of this block
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      subj[q] = slot_subj[j0 + q];
      active[q] = subj[q] >= 0;
      any_active |= active[q];
      own_rows |= active[q] && (unsigned)(subj[q] - row0) < (unsigned)kGroup;
    }
    int bits[kQ] = {0, 0, 0, 0};

    for (int r = threadIdx.x / kCols; r < kGroup; r += kRowStep) {
      const int row = row0 + r;
      int best_any[kQ], best_alive[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) best_any[q] = best_alive[q] = -1;
      // An inactive lane delivers nothing: skip the windows of an idle span.
      if (any_active) {
        if (kF > 0) {
          int w[kF > 0 ? kF : 1][kQ];
          uint32_t wa[kF > 0 ? kF : 1];
          int snd[kF > 0 ? kF : 1];
#pragma unroll
          for (int c = 0; c < kF; ++c) {
            snd[c] = sh.send[r][c];
            if (snd[c] >= 0) load_band<kIn>(p, src_slab, src_cold, snd[c] + j0, keep, w[c], wa[c]);
          }
#pragma unroll
          for (int c = 0; c < kF; ++c)
            if (snd[c] >= 0) deliver(w[c], wa[c], k.spread, best_any, best_alive);
        } else {
          for (int c = 0; c < fan; ++c) {
            const int snd = sh.send[r][c];
            if (snd < 0) continue;
            int w[kQ];
            uint32_t wa;
            load_band<kIn>(p, src_slab, src_cold, snd + j0, keep, w, wa);
            deliver(w, wa, k.spread, best_any, best_alive);
          }
        }
      }

      const int off = row * s + j0;
      int v[kQ];
      uint32_t lo, hi;
      load_own<kIn>(p, src_slab, src_cold, off, keep, v, lo, hi);
      const bool alive_row = sh.alive[r] != 0;
      bool own_here = false;
      if (own_rows) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) own_here |= subj[q] == row;
      }
      int key[kQ], a2[kQ], s2[kQ];
      if (!own_here && alive_row) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int b = cell_update(v[q], (lo >> (8 * q)) & 0xFF, (int)(int8_t)(hi >> (8 * q)),
                                    best_any[q], best_alive[q], false, active[q], true, k,
                                    key[q], a2[q], s2[q]);
          if (kLast) bits[q] |= b;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const bool own = subj[q] == row;
          int ba = best_any[q];
          int bal = best_alive[q];
          if (own) {
            if (kLast && ba >= 0) atomicMax(&self_rumor[row], ba);
            ba = -1;
            bal = -1;
          }
          const int b = cell_update(v[q], (lo >> (8 * q)) & 0xFF, (int)(int8_t)(hi >> (8 * q)),
                                    ba, bal, own, active[q], alive_row, k, key[q], a2[q], s2[q]);
          if (kLast) bits[q] |= b;
        }
      }
      store_cells<kLast>(p, dst_slab, dst_cold, off, key, a2, s2);
    }

    if (kLast) {
      // The aggregate: OR over the item's rows, then one atomic per lane word.
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (bits[q] & k.aggr_mask) atomicOr(&sh.aggr[kQ * tx + q], bits[q] & k.aggr_mask);
      __syncthreads();
      if (threadIdx.x < kTile && sh.aggr[threadIdx.x])
        atomicOr(&aggr[tile * kTile + threadIdx.x], sh.aggr[threadIdx.x]);
    }
    // The shared tables are rewritten for the next item.
    __syncthreads();
  }
}

template <int kF>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sparse_persistent_kernel(
    Planes p, const int32_t* __restrict__ slot_subj, const int32_t* __restrict__ ginv,
    const int32_t* __restrict__ rots, const uint8_t* __restrict__ edge_ok,
    const uint8_t* __restrict__ alive, int32_t* self_rumor, int32_t* aggr, int n, int s, int f,
    int k, Consts consts) {
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int nb = n / kGroup;
  for (int t = 0; t < k; ++t) {
    const bool odd = t % 2 == 1;
    const int32_t* src_slab = odd ? p.slab[0] : p.slab[1];  // what tick t - 1 wrote
    const int16_t* src_cold = odd ? p.cold[0] : p.cold[1];
    int32_t* dst_slab = odd ? p.slab[1] : p.slab[0];
    int16_t* dst_cold = odd ? p.cold[1] : p.cold[0];
    const int32_t* t_ginv = ginv + (int64_t)t * f * nb;
    const int32_t* t_rots = rots + (int64_t)t * f * nb;
    const uint8_t* t_edge = edge_ok + (int64_t)t * f * n;
#define PERSISTENT_TICK_ARGS                                                                   \
  p, src_slab, src_cold, dst_slab, dst_cold, t_ginv, t_rots, t_edge, alive, slot_subj,      \
      self_rumor, aggr, n, s, f, odd, consts, sh
    if (t == 0 && t == k - 1)
      run_tick<kF, kCaller, true>(PERSISTENT_TICK_ARGS);
    else if (t == 0)
      run_tick<kF, kCaller, false>(PERSISTENT_TICK_ARGS);
    else if (t == k - 1)
      run_tick<kF, kPingPong, true>(PERSISTENT_TICK_ARGS);
    else
      run_tick<kF, kPingPong, false>(PERSISTENT_TICK_ARGS);
#undef PERSISTENT_TICK_ARGS
    // Tick t is complete in its buffers before any CTA reads them.
    if (t + 1 < k) grid.sync();
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Fills ``self_rumor`` with -1 and zeroes ``aggr`` on ``stream``, then
// launches ``k`` ticks there as one cooperative kernel on a grid of the
// CTAs the card holds at once (at most one per work item). Tick t < k - 1
// writes ``slab_a`` / ``cold_a`` (t even) or ``slab_b`` / ``cold_b`` (t
// odd), the last tick the slab of that pair and ``age_out`` / ``susp_out``.
// ``grid_out`` receives the number of CTAs launched. Returns a cudaError_t
// (0 = success): a caller plane off 16-byte alignment gives
// cudaErrorInvalidValue, a card without cooperative launch
// cudaErrorNotSupported.
extern "C" int sparse_persistent_launch(
    const void* slab_in, const void* age_in, const void* susp_in, const void* slot_subj,
    const void* ginv, const void* rots, const void* edge_ok, const void* alive, void* slab_a,
    void* cold_a,
    void* slab_b, void* cold_b, void* age_out, void* susp_out, void* self_rumor, void* aggr,
    int n, int s, int f, int k, int spread, int susp_ticks, int age_stale, int sweep,
    int aggr_mask, void* stream, int* grid_out) {
  if (n <= 0 || n % kGroup != 0 || s <= 0 || s % kTile != 0 || f < 1 || f > kMaxFanout ||
      k < 1 || (long long)n * s >= (1LL << 31) || !aligned(slab_in) || !aligned(age_in) ||
      !aligned(susp_in))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  int sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  const void* kernel = f == 3 ? (const void*)sparse_persistent_kernel<3>
                              : (const void*)sparse_persistent_kernel<0>;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int items = n / kGroup * (s / kTile);
  const int grid = per_sm * sms < items ? per_sm * sms : items;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(self_rumor, 0xff, sizeof(int32_t) * n, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(aggr, 0, sizeof(int32_t) * s, st);
  if (err != cudaSuccess) return (int)err;

  Planes p{(const int32_t*)slab_in,
           (const int8_t*)age_in,
           (const int16_t*)susp_in,
           {(int32_t*)slab_a, (int32_t*)slab_b},
           {(int16_t*)cold_a, (int16_t*)cold_b},
           (int8_t*)age_out,
           (int16_t*)susp_out};
  const int32_t* a_slot_subj = (const int32_t*)slot_subj;
  const int32_t* a_ginv = (const int32_t*)ginv;
  const int32_t* a_rots = (const int32_t*)rots;
  const uint8_t* a_edge_ok = (const uint8_t*)edge_ok;
  const uint8_t* a_alive = (const uint8_t*)alive;
  int32_t* a_self = (int32_t*)self_rumor;
  int32_t* a_aggr = (int32_t*)aggr;
  Consts consts{spread, susp_ticks, age_stale, sweep, aggr_mask};
  void* args[] = {&p,      &a_slot_subj, &a_ginv, &a_rots, &a_edge_ok, &a_alive,
                  &a_self, &a_aggr,      &n,      &s,      &f,         &k,
                  &consts};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  *grid_out = grid;
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* sparse_persistent_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
