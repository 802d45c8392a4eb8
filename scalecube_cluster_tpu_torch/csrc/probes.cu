// Feature probes of the card, CUDA C++ for sm_90a: five small kernels, one
// per probe of scalecube_cluster_tpu/tools/probe_mosaic.py, each checking a
// feature the port's kernels rely on. Their plain PyTorch twins (from each
// probe's ``expect`` expression) live in scalecube_cluster_tpu_torch/
// tools/probe_kernels.py, which runs them and prints PASS or FAIL.
//
//   probe_smallint  (p_smallint, :48)  int8 / int16 loads and stores with
//                   converts: the age and countdown pass of the cores;
//   probe_window2d  (p_window2d, :100) a 2D row window copied into shared
//                   memory with cp.async (16 B per thread), then written
//                   out four times: window staging of a later kernel;
//   probe_accum     (p_accum, :138)    row sums accumulated across column
//                   tiles by atomicAdd from parallel CTAs: the cross-block
//                   accumulation that replaces the TPU's revisited output;
//   probe_fdmask    (p_fdmask, :165)   per-row target and key tables in
//                   shared memory with a column compare: the FD cell mask;
//   probe_roll      (p_roll, :196)     a row roll by ``shift`` of an
//                   8-row window: the fan-out's rotated sender rows.
//
// Each is bound by launch latency at the probes' sizes (tens of KB).

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

// Grid (row blocks of blockDim.x rows, column tiles): each thread sums its
// row over one tile and adds it into the zero-filled acc.
__global__ void accum_kernel(const int32_t* __restrict__ x,
                             int32_t* __restrict__ acc, int n, int m, int mc) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int tile = blockIdx.y;
  int part = 0;
  for (int j = tile * mc; j < (tile + 1) * mc && j < m; ++j)
    part += x[(int64_t)row * m + j];
  atomicAdd(&acc[row], part);
}

// One CTA per 32 rows: targets and keys in shared memory, threads along
// the columns: out = (col == tgt[row]) ? key[row] : v.
__global__ void fdmask_kernel(const int32_t* __restrict__ tgt,
                              const int32_t* __restrict__ key,
                              const int32_t* __restrict__ v,
                              int32_t* __restrict__ out, int n, int m) {
  __shared__ int s_tgt[32];
  __shared__ int s_key[32];
  const int base = blockIdx.x * 32;
  if (threadIdx.x < 32 && base + threadIdx.x < n) {
    s_tgt[threadIdx.x] = tgt[base + threadIdx.x];
    s_key[threadIdx.x] = key[base + threadIdx.x];
  }
  __syncthreads();
  for (int r = 0; r < 32 && base + r < n; ++r) {
    const int64_t row = base + r;
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      out[row * m + j] = j == s_tgt[r] ? s_key[r] : v[row * m + j];
  }
}

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

extern "C" int probe_accum(const void* x, void* acc, int n, int m, int mc,
                           void* stream) {
  if (mc <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 31) / 32, (m + mc - 1) / mc);
  accum_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)acc, n, m, mc);
  return (int)cudaGetLastError();
}

extern "C" int probe_fdmask(const void* tgt, const void* key, const void* v,
                            void* out, int n, int m, void* stream) {
  fdmask_kernel<<<(n + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tgt, (const int32_t*)key, (const int32_t*)v,
      (int32_t*)out, n, m);
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
