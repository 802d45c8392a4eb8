// Feature probes of the card, CUDA C++ for sm_90a: five small kernels, one
// per probe of scalecube_cluster_tpu/tools/probe_mosaic.py (the line of
// each probe's pl.pallas_call below), each checking a feature the port's
// kernels rely on. Their plain PyTorch twins (from each probe's ``expect``
// expression) live in scalecube_cluster_tpu_torch/tools/probe_kernels.py,
// which runs them and prints PASS or FAIL.
//
//   probe_smallint  (p_smallint, :64)  int8 / int16 loads and stores with
//                   converts: the age and countdown pass of the cores;
//   probe_window2d  (p_window2d, :116) an 8-row window per column tile,
//                   picked by an index, repeated down the output rows;
//   probe_accum     (p_accum, :152)    the row sums of an int32 [n, m]: the
//                   per-row count (tick_core.cu's known_cnt pattern);
//   probe_fdmask    (p_fdmask, :180)   out = (col == tgt[row]) ? key[row]
//                   : v: the FD cell mask (tick_core.cu's fd_tgt/fd_key);
//   probe_roll      (p_roll, :203)     a row roll by ``shift`` of an
//                   8-row window: the fan-out's rotated sender rows.
//
// At the probes' sizes (tens of KB) each is bound by launch latency. At the
// dense main path's width ([10240, 10240] cells) each is bound by
// device-memory bytes: each input read once, each output written once.
// probe_smallint, probe_window2d, probe_accum and probe_fdmask are designed
// for that width; probe_roll (one int a thread, two runtime % a cell) is
// the simple first port.
//
// probe_smallint replaces a TPU kernel that walked 32-row blocks of the
// three planes. Here every thread owns 4 consecutive cells: one 4-byte
// evict-first load of a8 and one 8-byte load of a16, one store of each to
// o8 and o16, and one 16-byte vector of ov, so that every warp request
// covers 128, 256 or 512 contiguous bytes. v is read only where the
// function needs it: the thread's 16-byte vector of v is loaded only
// when one of its 4 cells is young (a8 < 7; about 21% of vectors at ages
// in [0, 120)), else ov stores -1 without a read; and every load of a
// thread is issued before its first store. Cells index in 64 bits.
// Measured at the width (H100 80GB HBM3, 700 W): 16 and 8 cells a thread
// (fewer threads, strided 16-byte accesses) took 0.493 and 0.458 ms, 4
// cells 0.441; loading v always, 0.488.
// Bound at [10240, 10240] with ages in [0, 120): 1,048,576,000 B plus 4 B
// per young cell (about 24.5 MB) = 0.3203 ms at 3.35 TB/s.
//
// probe_window2d replaces a TPU kernel that copied each tile's window into
// VMEM by DMA and stored it four times. On the card nothing is reused
// across CTAs that the L2 does not already hold, so there is no shared
// memory and no cp.async: each thread owns one 16-byte column vector, reads
// its 8 window vectors once through the read-only path (320 KB over all 40
// tiles at the width, kept in L2) and issues coalesced 16-byte
// evict-first stores down a block of kWindowRows output rows, row p taking
// window row p % 8 from registers. The grid, (column vectors) x (row
// blocks), covers the SMs many times over at the width. Measured there
// (H100 80GB HBM3, 700 W): row blocks of 16, 32 and 64 rows took 0.1308,
// 0.1325 and 0.1334 ms (2.0, 2.5 and 2.5 us at the probe's shape).
// Bound at [10240, 10240], 40 tiles, 10240 output rows: 419,758,240 B =
// 0.1253 ms at 3.35 TB/s (the write stream).
//
// probe_accum replaces a TPU kernel that revisits one output block across
// a sequential grid axis (zero it at column tile 0, add each tile's sums).
// Here a loop inside a warp takes the place of that axis, so nothing is
// carried between CTAs: one warp a row, 8 rows a 256-thread CTA. Each lane
// reads 16-byte vectors along the row, neighbouring lanes on neighbouring
// addresses (512 contiguous bytes a warp request, four requests in flight
// a lane), as evict-first streams (__ldcs: nothing is read twice); the
// warp reduces with __reduce_add_sync and lane 0 stores the row's sum once.
// No zero fill, no atomics, one launch. The sums are unsigned, so they
// wrap mod 2**32 exactly as torch.sum(dtype=torch.int32) does.
// Bound at [10240, 10240]: 419,471,360 B = 0.1252 ms at 3.35 TB/s.
//
// probe_fdmask replaces a TPU kernel that brought tgt and key in by scalar
// prefetch and walked 32-row blocks. Here every thread owns 4 consecutive
// columns of one row: one 16-byte evict-first load of v, four compares
// against the row's target (-1 matches no column), one 16-byte
// evict-first store; tgt[row] and key[row] are two scalar loads a thread
// that L1 serves to the row's threads. One thread per 4 cells, so every
// cell is in flight at once and no CTA walks rows in series.
// Bound at [10240, 10240]: 838,942,720 B = 0.2504 ms at 3.35 TB/s.
//
// Each of the four takes a scalar path for the whole launch when a plane
// is off 16-byte alignment (or, for probe_accum and probe_fdmask, the row
// width is off a multiple of 4): probe_smallint then takes one cell a
// thread, probe_window2d 4-byte accesses, probe_accum one int a lane (128
// contiguous bytes a warp request), probe_fdmask one cell a thread.
// probe_smallint's vector path takes the cells % 4 past the last whole
// group in one thread. probe_fdmask and probe_roll index cells in 32 bits;
// their wrappers refuse 2**31 cells.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

// p_smallint's function of one cell: the next age (0 when young, else
// min(a, 119) + 1) and the next countdown (150 when young, else c - 1
// floored at 0), with young = a < 7.
__device__ __forceinline__ int age_next(int a) { return a < 7 ? 0 : min(a, 119) + 1; }
__device__ __forceinline__ int countdown_next(int a, int c) { return a < 7 ? 150 : max(c - 1, 0); }

// Load v's 16-byte vector only when one of its 4 cells is young (else ov
// stores -1 without a read); false loads every vector.
constexpr bool kSkipOldPayload = true;

__device__ __forceinline__ void smallint_cell(const int8_t* __restrict__ a8,
                                              const int16_t* __restrict__ a16,
                                              const int32_t* __restrict__ v,
                                              int8_t* __restrict__ o8,
                                              int16_t* __restrict__ o16,
                                              int32_t* __restrict__ ov, int64_t i) {
  const int a = __ldcs(a8 + i);
  o8[i] = static_cast<int8_t>(age_next(a));
  o16[i] = static_cast<int16_t>(countdown_next(a, __ldcs(a16 + i)));
  ov[i] = a < 7 ? __ldcs(v + i) : -1;
}

// kVec: one thread per 4 consecutive cells (see the header), the thread
// past the last whole group taking the cells % 4 left one by one; else one
// cell a thread. Every load of a thread is issued before its first store
// (the stores would otherwise order the loads behind them).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) smallint_kernel(const int8_t* __restrict__ a8,
                                                            const int16_t* __restrict__ a16,
                                                            const int32_t* __restrict__ v,
                                                            int8_t* __restrict__ o8,
                                                            int16_t* __restrict__ o16,
                                                            int32_t* __restrict__ ov,
                                                            int64_t cells) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (!kVec) {
    if (t < cells) smallint_cell(a8, a16, v, o8, o16, ov, t);
    return;
  }
  const int64_t groups = cells / 4;
  if (t >= groups) {
    if (t == groups)
      for (int64_t i = groups * 4; i < cells; ++i) smallint_cell(a8, a16, v, o8, o16, ov, i);
    return;
  }
  const int4* vin = reinterpret_cast<const int4*>(v) + t;
  int4 old;
  if constexpr (!kSkipOldPayload) old = __ldcs(vin);
  const unsigned aw = __ldcs(reinterpret_cast<const unsigned*>(a8) + t);
  const int2 cw = __ldcs(reinterpret_cast<const int2*>(a16) + t);
  unsigned ow8 = 0, ow16[2] = {0, 0};
  unsigned young = 0;  // bit i: cell i is young
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = static_cast<int8_t>(aw >> (8 * i));
    const int c = static_cast<int16_t>((unsigned)(i < 2 ? cw.x : cw.y) >> (16 * (i % 2)));
    young |= (unsigned)(a < 7) << i;
    ow8 |= ((unsigned)age_next(a) & 0xffu) << (8 * i);
    ow16[i / 2] |= ((unsigned)countdown_next(a, c) & 0xffffu) << (16 * (i % 2));
  }
  if constexpr (kSkipOldPayload) {
    if (young) old = __ldcs(vin);
  }
  __stcs(reinterpret_cast<unsigned*>(o8) + t, ow8);
  __stcs(reinterpret_cast<int2*>(o16) + t, make_int2(ow16[0], ow16[1]));
  __stcs(reinterpret_cast<int4*>(ov) + t,
         make_int4((young & 1u) ? old.x : -1, (young & 2u) ? old.y : -1,
                   (young & 4u) ? old.z : -1, (young & 8u) ? old.w : -1));
}

// p_window2d's column vectors a CTA covers (one a thread) and output rows
// a thread writes, a multiple of 8 so that row p takes window row p % 8
// from the same register at every step.
constexpr int kWindowThreads = 128;
constexpr int kWindowRows = 16;

// out[p, x] = rows[8 * idx[x / mc] + p % 8, x]: each thread owns one
// 16-byte column vector (kVec; else 4 columns by 4-byte accesses, for
// planes off 16-byte alignment), reads its 8 window vectors once through
// the read-only path and stores them down kWindowRows rows of each of its
// row blocks. mc % 4 == 0, so no vector straddles two tiles.
template <bool kVec>
__global__ void __launch_bounds__(kWindowThreads) window2d_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int m, int mc, int out_rows) {
  const int c = blockIdx.x * kWindowThreads + threadIdx.x;
  if (4 * c >= m) return;
  const int g = __ldg(idx + 4 * c / mc);
  const int32_t* src = rows + (int64_t)8 * g * m + 4 * c;
  using Vec = typename std::conditional<kVec, int4, int>::type;
  constexpr int kParts = kVec ? 1 : 4;
  Vec win[8][kParts];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int u = 0; u < kParts; ++u)
      win[k][u] = __ldg(reinterpret_cast<const Vec*>(src + (int64_t)k * m) + u);
  for (int row0 = blockIdx.y * kWindowRows; row0 < out_rows;
       row0 += gridDim.y * kWindowRows) {
    Vec* dst = reinterpret_cast<Vec*>(out + (int64_t)row0 * m + 4 * c);
    const int64_t step = m / (4 / kParts);
    const int end = min(kWindowRows, out_rows - row0);
    for (int r = 0; r < end; r += 8)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int u = 0; u < kParts; ++u) __stcs(dst + u, win[k][u]);
        dst += step;
      }
  }
}

constexpr int kWarp = 32;
constexpr int kRowsPerCta = kThreads / kWarp;
// 16-byte loads a lane issues before it adds (probe_accum).
constexpr int kInFlight = 4;

// One warp a row (see the header). kVec: 16-byte vectors (m % 4 == 0 and
// x 16-byte aligned), else one int a lane.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) accum_kernel(const int32_t* __restrict__ x,
                                                         int32_t* __restrict__ acc, int n,
                                                         int m) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
  if (row >= n) return;  // the whole warp: row is the same for its lanes
  const int32_t* p = x + (int64_t)row * m;
  unsigned sum = 0;
  if constexpr (kVec) {
    const int4* q = reinterpret_cast<const int4*>(p);
    const int vecs = m / 4;
    int j = lane;
    for (; j + (kInFlight - 1) * kWarp < vecs; j += kInFlight * kWarp) {
      int4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) v[u] = __ldcs(q + j + u * kWarp);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        sum += (unsigned)v[u].x + (unsigned)v[u].y + (unsigned)v[u].z + (unsigned)v[u].w;
    }
    for (; j < vecs; j += kWarp) {
      const int4 v = __ldcs(q + j);
      sum += (unsigned)v.x + (unsigned)v.y + (unsigned)v.z + (unsigned)v.w;
    }
  } else {
    for (int j = lane; j < m; j += kWarp) sum += (unsigned)__ldcs(p + j);
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if (lane == 0) acc[row] = (int32_t)sum;
}

// One thread per 4 columns of a row (kVec), else per cell (see the header).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) fdmask_kernel(const int32_t* __restrict__ tgt,
                                                          const int32_t* __restrict__ key,
                                                          const int32_t* __restrict__ v,
                                                          int32_t* __restrict__ out,
                                                          unsigned items, unsigned per_row) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const unsigned row = i / per_row;
  const int t = tgt[row];
  const int k = key[row];
  if constexpr (kVec) {
    const int c = (int)(i - row * per_row) * 4;
    int4 w = __ldcs(reinterpret_cast<const int4*>(v) + i);
    w.x = c == t ? k : w.x;
    w.y = c + 1 == t ? k : w.y;
    w.z = c + 2 == t ? k : w.z;
    w.w = c + 3 == t ? k : w.w;
    __stcs(reinterpret_cast<int4*>(out) + i, w);
  } else {
    const int c = (int)(i - row * per_row);
    __stcs(out + i, c == t ? k : __ldcs(v + i));
  }
}

// An empty kernel: its device time is the launch floor the probes are
// read against. No path of the port launches it.
__global__ void noop_kernel() {}

// out[p, j] = x[(p - shift) mod rows, j].
__global__ void roll_kernel(const int32_t* __restrict__ x,
                            int32_t* __restrict__ out, int rows, int m,
                            int shift) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows * m;
       i += gridDim.x * blockDim.x) {
    const int p = i / m;
    const int j = i % m;
    const int src = ((p - shift) % rows + rows) % rows;
    out[i] = x[(int64_t)src * m + j];
  }
}

int blocks_for(int cells) { return (cells + kThreads - 1) / kThreads; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Each launcher runs its kernel on ``stream`` and returns the cudaError_t
// of the launch (0 = success).
extern "C" int probe_smallint(const void* a8, const void* a16, const void* v,
                              void* o8, void* o16, void* ov, int64_t cells,
                              void* stream) {
  if (cells <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(a8) && aligned16(a16) && aligned16(v) && aligned16(o8) &&
                   aligned16(o16) && aligned16(ov);
  const int64_t items = vec ? cells / 4 + 1 : cells;
  const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
  if (vec)
    smallint_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)a8, (const int16_t*)a16, (const int32_t*)v, (int8_t*)o8,
        (int16_t*)o16, (int32_t*)ov, cells);
  else
    smallint_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)a8, (const int16_t*)a16, (const int32_t*)v, (int8_t*)o8,
        (int16_t*)o16, (int32_t*)ov, cells);
  return (int)cudaGetLastError();
}

extern "C" int probe_window2d(const void* rows, const void* idx, void* out,
                              int tiles, int m, int mc, int out_rows,
                              void* stream) {
  if (tiles <= 0 || mc <= 0 || mc % 4 != 0 || (int64_t)tiles * mc != m || out_rows <= 0 ||
      out_rows % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m / 4 + kWindowThreads - 1) / kWindowThreads,
                  std::min((out_rows + kWindowRows - 1) / kWindowRows, 65535));
  if (aligned16(rows) && aligned16(out))
    window2d_kernel<true><<<grid, kWindowThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int32_t*)idx, (int32_t*)out, m, mc, out_rows);
  else
    window2d_kernel<false><<<grid, kWindowThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int32_t*)idx, (int32_t*)out, m, mc, out_rows);
  return (int)cudaGetLastError();
}

extern "C" int probe_accum(const void* x, void* acc, int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRowsPerCta - 1) / kRowsPerCta;
  if (m % 4 == 0 && aligned16(x))
    accum_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)acc, n, m);
  else
    accum_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)acc, n, m);
  return (int)cudaGetLastError();
}

extern "C" int probe_fdmask(const void* tgt, const void* key, const void* v,
                            void* out, int n, int m, void* stream) {
  const int64_t cells = (int64_t)n * m;
  if (n <= 0 || m <= 0 || cells >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && aligned16(v) && aligned16(out);
  const unsigned per_row = vec ? m / 4 : m;
  const unsigned items = (unsigned)n * per_row;
  const unsigned blocks = (items + kThreads - 1) / kThreads;
  if (vec)
    fdmask_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tgt, (const int32_t*)key, (const int32_t*)v, (int32_t*)out, items,
        per_row);
  else
    fdmask_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tgt, (const int32_t*)key, (const int32_t*)v, (int32_t*)out, items,
        per_row);
  return (int)cudaGetLastError();
}

extern "C" int probe_noop(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int probe_roll(const void* x, void* out, int rows, int m, int shift,
                          void* stream) {
  if (rows <= 0 || m <= 0 || (int64_t)rows * m >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  roll_kernel<<<blocks_for(rows * m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, rows, m, shift);
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* probes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
