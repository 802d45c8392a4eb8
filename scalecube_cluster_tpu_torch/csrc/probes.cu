// Feature probes of the card, CUDA C++ for sm_90a: five small kernels, one
// per probe of scalecube_cluster_tpu/tools/probe_mosaic.py (the line of
// each probe's pl.pallas_call below), each checking a feature the port's
// kernels rely on. Their plain PyTorch twins (from each probe's ``expect``
// expression) live in scalecube_cluster_tpu_torch/tools/probe_kernels.py,
// which runs them and prints PASS or FAIL.
//
//   probe_smallint  (p_smallint, :64)  int8 / int16 loads and stores with
//                   converts: the age and countdown pass of the cores;
//   probe_window2d  (p_window2d, :116) a 2D row window copied into shared
//                   memory with cp.async (16 B per thread), then written
//                   out four times: window staging of a later kernel;
//   probe_accum     (p_accum, :152)    the row sums of an int32 [n, m]: the
//                   per-row count (tick_core.cu's known_cnt pattern);
//   probe_fdmask    (p_fdmask, :180)   out = (col == tgt[row]) ? key[row]
//                   : v: the FD cell mask (tick_core.cu's fd_tgt/fd_key);
//   probe_roll      (p_roll, :203)     a row roll by ``shift`` of an
//                   8-row window: the fan-out's rotated sender rows.
//
// At the probes' sizes (tens of KB) each is bound by launch latency.
// probe_accum and probe_fdmask are designed for the card at the dense main
// path's width as well ([10240, 10240] int32), where both are bound by
// device-memory bytes: each input read once, each output written once.
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
// Both take a scalar path for the whole launch when a row is off 16-byte
// alignment (m % 4 != 0, or a plane whose base is not 16-byte aligned):
// probe_accum then reads one int a lane (128 contiguous bytes a warp
// request), probe_fdmask one cell a thread. probe_fdmask indexes cells in
// 32 bits; its wrapper refuses n * m >= 2**31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void smallint_kernel(const int8_t* __restrict__ a8,
                                const int16_t* __restrict__ a16,
                                const int32_t* __restrict__ v,
                                int8_t* __restrict__ o8,
                                int16_t* __restrict__ o16,
                                int32_t* __restrict__ ov, int cells) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x) {
    const int a = a8[i];
    const bool young = a < 7;
    o8[i] = static_cast<int8_t>(young ? 0 : min(a, 119) + 1);
    o16[i] = static_cast<int16_t>(young ? 150 : max((int)a16[i] - 1, 0));
    ov[i] = young ? v[i] : -1;
  }
}

// One CTA per column tile: rows[8*idx[tile] .. +8, tile*mc .. +mc] into
// shared memory by cp.async, then out[p, tile*mc + x] = window[p % 8, x]
// for the 32 output rows. mc must be a multiple of 4 (16-byte copies).
__global__ void window2d_kernel(const int32_t* __restrict__ rows,
                                const int32_t* __restrict__ idx,
                                int32_t* __restrict__ out, int m, int mc,
                                int out_rows) {
  extern __shared__ int4 window[];
  const int tile = blockIdx.x;
  const int g = idx[tile];
  const int vecs = 8 * mc / 4;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int r = i / (mc / 4);
    const int x = (i % (mc / 4)) * 4;
    const int32_t* src = rows + (int64_t)(8 * g + r) * m + tile * mc + x;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&window[i]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(__cvta_generic_to_global(src)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int32_t* win = reinterpret_cast<const int32_t*>(window);
  for (int i = threadIdx.x; i < out_rows * mc; i += blockDim.x) {
    const int p = i / mc;
    const int x = i % mc;
    out[(int64_t)p * m + tile * mc + x] = win[(p % 8) * mc + x];
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
                              void* o8, void* o16, void* ov, int cells,
                              void* stream) {
  smallint_kernel<<<blocks_for(cells), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a8, (const int16_t*)a16, (const int32_t*)v, (int8_t*)o8,
      (int16_t*)o16, (int32_t*)ov, cells);
  return (int)cudaGetLastError();
}

extern "C" int probe_window2d(const void* rows, const void* idx, void* out,
                              int tiles, int m, int mc, int out_rows,
                              void* stream) {
  if (mc % 4 != 0 || tiles * mc > m) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * mc * sizeof(int32_t);
  window2d_kernel<<<tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)idx, (int32_t*)out, m, mc,
      out_rows);
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
  roll_kernel<<<blocks_for(rows * m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, rows, m, shift);
  return (int)cudaGetLastError();
}

// The error string of a cudaError_t, for the wrapper's exception text.
extern "C" const char* probes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
