// Fused sparse tick core of the compact-rumor SWIM engine, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel scalecube_cluster_tpu/ops/pallas_sparse.py::
// sparse_core_pallas (body _kernel_factory, helpers pack_flags / pack_slots
// and ops/pallas_tick.py::_merge_rows) with the full residual fold
// {countdown, points, wb_mask, view_rows} and its shard mode (the
// explicit-SPMD engine's per-shard launch, pallas_sparse.py:114-139,
// :323-325, :365-379; see "Shard mode" below). Its plain
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
// What bounds it on the card: bytes and instructions, both near. The
// function must read 7 bytes per cell (slab i32, age i8, susp i16) and
// write 7: about 235 MB a tick at 32768 x 512, 0.070 ms at 3.35 TB/s. It
// needs about 62 integer operations per cell of an active lane, 30 per cell
// of an idle lane, 12 per sender cell and 2 per delivered record, the
// point, own-lane and edge tests once per row (counted in
// chip_smoke.py::core_work): 1.1e9 on the smoke test's operands, 0.067 ms
// at the card's INT32 rate. An earlier kernel (one CTA per 32-row block
// across all S lanes) took 3.5x the bound: the f sender windows, slab and
// age, were read again for each receiver block and the 80 MB of slab and
// age does not fit the 50 MB L2 (about 29 B per cell moved); every cell
// reloaded six shared arrays and tested the point lanes; and each of its
// 1,024 CTAs did an atomicOr on every aggregate word. Staging the windows
// in shared memory cannot help: the f readers of a sender block are
// different CTAs, each of which also reads f - 1 other blocks.
//
// Design:
//   - The grid is (32-row receiver block, lane tile) with the blocks
//     fastest (blockIdx.x), so the card runs every block of one tile at once,
//     and a sender cell's f reads fall within the time L2 holds the band
//     (slab, age)[:, tile] (N x 128 x 5 B = 21 MB at n=32768): by design
//     slab and age come from device memory once (not counted on the card;
//     a neighbouring-CTA layout is 3.4% faster). They are the band and the
//     receiver's own cells, so both reads go under an L2 evict-last
//     policy; susp and the three outputs stream evict-first (ld/st .cs).
//   - Each thread owns 4 consecutive lanes: slab moves as 16-byte
//     accesses, age as one 32-bit word and susp as one 64-bit word. When S
//     is not a multiple of 4, or a plane is not aligned, a path that moves
//     one lane at a time takes the operands; the ragged tail is masked.
//   - Row and sender work is out of the cell loop: a sender's row, FD and
//     SYNC lanes and the edge bit come from shared memory once per (row,
//     channel) and thread; its point lanes, the receiver's point lanes and
//     the own lane are tested once per (row, channel) or row against the
//     thread's 4-lane span (the own lane only where one of the span's
//     subjects is a row of the CTA). The rare spans that hold one, and dead
//     receiver rows, take the general path.
//   - Offsets are 32-bit inside a universe: the wrapper refuses
//     n*S >= 2^31. An ensemble's B universes (sim/ensemble.py, the vmap of
//     the reference's pallas_call) are the grid's third axis: each CTA
//     moves every pointer to its universe with a 64-bit offset (at
//     n=32768, S=512 a universe is 2^24 cells, so B >= 128 passes 2^31),
//     and the rest of the kernel is the one-universe kernel.
//   - The aggregate is OR-ed over the CTA's 32 rows in shared memory, then
//     one atomicOr per lane word and CTA goes into the [S] vector the
//     launcher zeroes on the stream; the self-rumor is an atomicMax into
//     the [N] vector it fills with -1. Both are exact in any order. CTAs
//     of 2 or 4 row blocks, with a half or a quarter of the atomics, were
//     no faster at the main path's shape: the atomics are not what costs.
//
// Shard mode (parallel/spmd.py, all shards and universes in one launch,
// grid.z = B * shards): each z is one shard's [nl, S] block, with its own
// row_base[z] (the global member id of its row 0: own lanes are found on
// global ids) and its own caller-built sender windows, [W, S] int32 and
// int8 at 64-bit offsets, read where the single-device kernel reads the
// sender rows of the block (ginv indexes their 32-row blocks). Window rows
// are not rows of the block, so no point lane reaches them: with windows
// the point fold is off, and the receiver's FD / SYNC lanes only mark its
// point cells for the countdown (the caller applied the updates). The
// bound adds the window reads, at most W x S x 5 bytes a shard.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swim_device.cuh"

namespace {

constexpr int kGroup = 32;
constexpr int kMaxFanout = 8;
constexpr int kThreads = 128;
// CTAs an SM must hold: caps the kernel at 64 registers. Left to itself,
// nvcc gives the f=3 instantiation 80, six CTAs an SM, 10% slower on the
// H100 (PERF.md).
constexpr int kMinBlocks = 8;
constexpr int kQ = swim::kQuad;
// Lanes of one CTA's tile: the fastest of 16 to 512 on the H100 (PERF.md).
constexpr int kTile = 128;
constexpr int kCols = kTile / kQ;        // threads along a row
constexpr int kRowStep = kThreads / kCols;  // rows in flight in the CTA
static_assert(kThreads % kCols == 0, "whole rows in flight");

struct Consts {
  int spread;
  int susp_ticks;
  int age_stale;
  int sweep;
};

// The thread's ``nv`` lanes of a slab row and its ages, packed in one
// word (the band: kept in L2). Lanes past ``nv`` read as UNKNOWN at age 0.
template <bool kVec>
__device__ __forceinline__ void load_band(const int32_t* slab, const int8_t* age, int off,
                                          int nv, uint64_t keep, int (&w)[kQ], uint32_t& ages) {
  if (kVec) {
    const int4 x = swim::load_kept_x4(slab + off, keep);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    ages = swim::load_kept_u32(age + off, keep);
  } else {
    ages = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      w[q] = q < nv ? slab[off + q] : -1;
      ages |= q < nv ? (uint32_t)(uint8_t)age[off + q] << (8 * q) : 0u;
    }
  }
}

// One channel's sender quad: the sender's SYNC and FD point updates (SYNC
// wins a collision) make a cell young with the point key; young records
// are offered to the lanes' maxima (a stale one as -1, which changes
// neither).
__device__ __forceinline__ void deliver(int (&w)[kQ], uint32_t ages, int4 snd, int j0,
                                        const int32_t* fd_key, const int32_t* sy_key,
                                        int spread, int (&best_any)[kQ],
                                        int (&best_alive)[kQ]) {
  int a[kQ];
  swim::unpack_i8x4(ages, a);
  const unsigned d_fd = (unsigned)(snd.y - j0);
  const unsigned d_sy = (unsigned)(snd.z - j0);
  if (d_fd < kQ || d_sy < kQ) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (d_sy == (unsigned)q) {
        w[q] = sy_key[snd.x];
        a[q] = 0;
      } else if (d_fd == (unsigned)q) {
        w[q] = fd_key[snd.x];
        a[q] = 0;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) swim::offer(a[q] < spread ? w[q] : -1, best_any[q], best_alive[q]);
}

// The receiver's countdowns (single-use, evict-first).
template <bool kVec>
__device__ __forceinline__ void load_susp(const int16_t* susp, int off, int nv, int (&s)[kQ]) {
  if (kVec) {
    swim::unpack_i16x4(__ldcs(reinterpret_cast<const uint2*>(susp + off)), s);
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) s[q] = q < nv ? susp[off + q] : 0;
  }
}

// The three outputs of the thread's lanes (evict-first).
template <bool kVec>
__device__ __forceinline__ void store_cells(int32_t* slab2, int8_t* age2, int16_t* susp2, int off,
                                            int nv, const int (&key)[kQ], const int (&a)[kQ],
                                            const int (&s)[kQ]) {
  if (kVec) {
    __stcs(reinterpret_cast<int4*>(slab2 + off), make_int4(key[0], key[1], key[2], key[3]));
    __stcs(reinterpret_cast<unsigned int*>(age2 + off), swim::pack_i8x4(a));
    __stcs(reinterpret_cast<uint2*>(susp2 + off), swim::pack_i16x4(s));
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (q < nv) {
        slab2[off + q] = key[q];
        age2[off + q] = static_cast<int8_t>(a[q]);
        susp2[off + q] = static_cast<int16_t>(s[q]);
      }
    }
  }
}

// One cell after delivery: the merge lattice, the inactive-lane and
// dead-row freezes, the countdown, DEAD transition and aging. Returns the
// cell's aggregate bits (0 for a dead row).
__device__ __forceinline__ int cell_update(int local, int a0, int s0, int best_any,
                                           int best_alive, bool point, bool own, bool active,
                                           bool alive_row, const Consts& k, int& key, int& age,
                                           int& susp) {
  int merged = swim::merge_key(local, best_any, best_alive);
  if (!active || !alive_row) merged = local;
  const swim::Cell cell = swim::countdown(local, merged, a0, s0, point, alive_row, active,
                                          k.susp_ticks, k.age_stale);
  key = cell.key;
  age = cell.age;
  susp = cell.susp;
  return alive_row ? swim::aggregate_bits(cell, own, k.spread, k.sweep) : 0;
}

// kF > 0: exactly kF channels, their window loads issued together; kF == 0:
// f channels, one at a time. kVec: S % 4 == 0 and aligned planes.
template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sparse_core_kernel(
    const int32_t* __restrict__ slab, const int8_t* __restrict__ age,
    const int16_t* __restrict__ susp, const int32_t* __restrict__ slot_subj,
    const int32_t* __restrict__ ginv, const int32_t* __restrict__ rots,
    const uint8_t* __restrict__ edge_ok, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ fd_slot, const int32_t* __restrict__ sy_slot,
    const int32_t* __restrict__ fd_key, const int32_t* __restrict__ sy_key,
    const int32_t* __restrict__ win_slab, const int8_t* __restrict__ win_age,
    const int32_t* __restrict__ row_base, int32_t* __restrict__ slab2,
    int8_t* __restrict__ age2, int16_t* __restrict__ susp2, int32_t* __restrict__ self_rumor,
    int32_t* __restrict__ aggr, int n, int s, int f, int win_rows, Consts k) {
  const int fan = kF > 0 ? kF : f;
  const int blk = blockIdx.x;
  const int nb = gridDim.x;
  // The point lanes fold in only where the senders are the block's rows.
  const bool points = win_slab == slab;
  int rb = 0;  // global member id of the block's row 0
  {
    // This CTA's universe (or shard).
    const size_t u = blockIdx.z;
    const size_t cells = u * (size_t)n * (size_t)s;
    win_slab += u * (size_t)win_rows * (size_t)s;
    win_age += u * (size_t)win_rows * (size_t)s;
    if (row_base != nullptr) rb = row_base[u];
    slab += cells;
    age += cells;
    susp += cells;
    slab2 += cells;
    age2 += cells;
    susp2 += cells;
    slot_subj += u * s;
    aggr += u * s;
    ginv += u * f * nb;
    rots += u * f * nb;
    edge_ok += u * f * n;
    alive += u * n;
    fd_slot += u * n;
    sy_slot += u * n;
    fd_key += u * n;
    sy_key += u * n;
    self_rumor += u * n;
  }
  const int row0 = blk * kGroup;
  const int tx = threadIdx.x % kCols;
  const int j0 = blockIdx.y * kTile + kQ * tx;
  const int nv = min(max(s - j0, 0), kQ);  // the span's lanes inside the slab

  // Per (receiver row, channel): the sender row, its FD and SYNC lanes, the
  // edge bit.
  __shared__ int4 s_send[kGroup][kMaxFanout];
  // Per receiver row: its own FD and SYNC lanes, its liveness.
  __shared__ int4 s_recv[kGroup];
  __shared__ int s_aggr[kTile];

  for (int i = threadIdx.x; i < fan * kGroup; i += kThreads) {
    const int c = i / kGroup;
    const int r = i % kGroup;
    const int src = (int)swim::window_row(kGroup, ginv[c * nb + blk], rots[c * nb + blk], r);
    s_send[r][c] = make_int4(src, points ? fd_slot[src] : -1, points ? sy_slot[src] : -1,
                             edge_ok[c * n + row0 + r]);
  }
  if (threadIdx.x < kGroup) {
    const int row = row0 + threadIdx.x;
    s_recv[threadIdx.x] = make_int4(fd_slot[row], sy_slot[row], alive[row], 0);
  }
  for (int t = threadIdx.x; t < kTile; t += kThreads) s_aggr[t] = 0;
  __syncthreads();

  // Lane facts, fixed across rows.
  int subj[kQ];
  bool active[kQ];
  bool any_active = false;
  bool own_rows = false;  // some subject of the span is a row of this CTA
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    subj[q] = q < nv ? slot_subj[j0 + q] : -1;
    active[q] = subj[q] >= 0;
    any_active |= active[q];
    own_rows |= active[q] && (unsigned)(subj[q] - (rb + row0)) < (unsigned)kGroup;
  }
  int bits[kQ] = {0, 0, 0, 0};

  const uint64_t keep = swim::evict_last_policy();
  if (nv > 0) {
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
#pragma unroll
          for (int c = 0; c < kF; ++c) {
            const int4 snd = s_send[r][c];
            if (snd.w) load_band<kVec>(win_slab, win_age, snd.x * s + j0, nv, keep, w[c], wa[c]);
          }
#pragma unroll
          for (int c = 0; c < kF; ++c) {
            const int4 snd = s_send[r][c];
            if (snd.w)
              deliver(w[c], wa[c], snd, j0, fd_key, sy_key, k.spread, best_any, best_alive);
          }
        } else {
          for (int c = 0; c < fan; ++c) {
            const int4 snd = s_send[r][c];
            if (!snd.w) continue;
            int w[kQ];
            uint32_t wa;
            load_band<kVec>(win_slab, win_age, snd.x * s + j0, nv, keep, w, wa);
            deliver(w, wa, snd, j0, fd_key, sy_key, k.spread, best_any, best_alive);
          }
        }
      }

      const int off = row * s + j0;
      int v[kQ], a[kQ], sl[kQ];
      uint32_t ages;
      load_band<kVec>(slab, age, off, nv, keep, v, ages);
      swim::unpack_i8x4(ages, a);
      load_susp<kVec>(susp, off, nv, sl);
      const int4 rcv = s_recv[r];
      const bool alive_row = rcv.z != 0;
      const unsigned d_fd = (unsigned)(rcv.x - j0);
      const unsigned d_sy = (unsigned)(rcv.y - j0);
      bool own_here = false;
      if (own_rows) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) own_here |= subj[q] == rb + row;
      }
      int key[kQ], a2[kQ], s2[kQ];
      if (d_fd >= kQ && d_sy >= kQ && !own_here && alive_row) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          bits[q] |= cell_update(v[q], a[q], sl[q], best_any[q], best_alive[q], false, false,
                                 active[q], true, k, key[q], a2[q], s2[q]);
      } else {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          int local = v[q];
          int a0 = a[q];
          bool point = false;
          if (d_sy == (unsigned)q || d_fd == (unsigned)q) {
            point = true;
            if (points) {
              local = d_sy == (unsigned)q ? sy_key[row] : fd_key[row];
              a0 = 0;
            }
          }
          const bool own = subj[q] == rb + row;
          int ba = best_any[q];
          int bal = best_alive[q];
          if (own) {
            if (ba >= 0) atomicMax(&self_rumor[row], ba);
            ba = -1;
            bal = -1;
          }
          bits[q] |= cell_update(local, a0, sl[q], ba, bal, point, own, active[q], alive_row, k,
                                 key[q], a2[q], s2[q]);
        }
      }
      store_cells<kVec>(slab2, age2, susp2, off, nv, key, a2, s2);
    }
  }

  // The aggregate: OR over the CTA's rows, then one atomic per lane word.
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (q < nv && bits[q]) atomicOr(&s_aggr[kQ * tx + q], bits[q]);
  __syncthreads();
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int lane = blockIdx.y * kTile + t;
    if (lane < s && s_aggr[t]) atomicOr(&aggr[lane], s_aggr[t]);
  }
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <int kF, bool kVec>
void launch(dim3 grid, cudaStream_t stream, const void* slab, const void* age,
            const void* susp, const void* slot_subj, const void* ginv, const void* rots,
            const void* edge_ok, const void* alive, const void* fd_slot, const void* sy_slot,
            const void* fd_key, const void* sy_key, const void* win_slab, const void* win_age,
            const void* row_base, void* slab2, void* age2, void* susp2, void* self_rumor,
            void* aggr, int n, int s, int f, int win_rows, Consts k) {
  sparse_core_kernel<kF, kVec><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)slab, (const int8_t*)age, (const int16_t*)susp,
      (const int32_t*)slot_subj, (const int32_t*)ginv, (const int32_t*)rots,
      (const uint8_t*)edge_ok, (const uint8_t*)alive, (const int32_t*)fd_slot,
      (const int32_t*)sy_slot, (const int32_t*)fd_key, (const int32_t*)sy_key,
      (const int32_t*)win_slab, (const int8_t*)win_age, (const int32_t*)row_base,
      (int32_t*)slab2, (int8_t*)age2, (int16_t*)susp2, (int32_t*)self_rumor,
      (int32_t*)aggr, n, s, f, win_rows, k);
}

}  // namespace

// Fills ``self_rumor`` with -1 and zeroes ``aggr`` on ``stream``, then
// launches the kernel there on an (n/32 row blocks, lane tiles, b
// universes) grid; every operand holds b universes back to back. The
// sender rows come from ``win_slab`` / ``win_age`` (``win_rows`` rows a
// universe; the slab and age themselves outside shard mode); ``row_base``
// is null or ``[b]`` int32. Windows other than the slab leave the point
// lanes unapplied.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sparse_core_launch(
    const void* slab, const void* age, const void* susp, const void* slot_subj,
    const void* ginv, const void* rots, const void* edge_ok, const void* alive,
    const void* fd_slot, const void* sy_slot, const void* fd_key,
    const void* sy_key, const void* win_slab, const void* win_age, const void* row_base,
    void* slab2, void* age2, void* susp2, void* self_rumor, void* aggr, int n, int s,
    int f, int b, int win_rows, int spread, int susp_ticks, int age_stale,
    int sweep, void* stream) {
  if (n <= 0 || n % kGroup != 0 || s <= 0 || f > kMaxFanout || f < 1 ||
      (long long)n * s >= (1LL << 31) || b < 1 || b > 65535 || win_rows < kGroup ||
      win_rows % kGroup != 0 || (long long)win_rows * s >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(self_rumor, 0xff, sizeof(int32_t) * n * (size_t)b, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(aggr, 0, sizeof(int32_t) * s * (size_t)b, st);
  if (err != cudaSuccess) return (int)err;
  const bool vec = s % kQ == 0 && aligned(slab, 16) && aligned(slab2, 16) && aligned(age, 4) &&
                   aligned(age2, 4) && aligned(susp, 8) && aligned(susp2, 8) &&
                   aligned(win_slab, 16) && aligned(win_age, 4);
  const dim3 grid(n / kGroup, (s + kTile - 1) / kTile, b);
  const Consts k{spread, susp_ticks, age_stale, sweep};
#define SPARSE_CORE_ARGS                                                                      \
  grid, st, slab, age, susp, slot_subj, ginv, rots, edge_ok, alive, fd_slot, sy_slot, fd_key, \
      sy_key, win_slab, win_age, row_base, slab2, age2, susp2, self_rumor, aggr, n, s, f,      \
      win_rows, k
  if (f == 3 && vec)
    launch<3, true>(SPARSE_CORE_ARGS);
  else if (vec)
    launch<0, true>(SPARSE_CORE_ARGS);
  else
    launch<0, false>(SPARSE_CORE_ARGS);
#undef SPARSE_CORE_ARGS
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* sparse_core_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
