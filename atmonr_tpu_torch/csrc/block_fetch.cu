// Block fetch of random runs of 512-byte table rows, sm_90a: the port's
// probe of random-row gather bandwidth (kernel T2).
//
// Replaces the TPU kernel tools/bench_dma_gather.py::make_dma_block_fetch
// (pallas_call at :89), which issues one DMA descriptor per random run of
// rows_per_desc consecutive 512-byte tile rows (the smallest slice a TPU DMA
// can copy out of HBM: 128 lanes of f32, 64 entries of two f32 features),
// block descriptors a grid step, all on one semaphore.
//
// What it computes, for j < n_desc and r < rpd:
//   out[j * rpd + r, :] = table[idx[j] + r, :]
// table (n_tile_rows, 128) f32, idx (n_desc,) int32, out (n_desc * rpd, 128)
// f32. A descriptor whose rows leave the table (idx[j] < 0 or
// idx[j] + rpd > n_tile_rows) is not read: its output rows are NaN, so a
// bad index never reads past the table and never passes for a right result
// (the plain version in ops/block_fetch.py raises on it).
//
// Bound on this card: nothing is computed, so bytes bound it: each fetched
// row read once and written once, plus the indices, over 3.35 TB/s. At the
// JAX tool's 2^17 rows a call (64 MiB in, 64 MiB out) that is 40.1 us. A
// table of 2^21 entries of two f32 features (16 MiB) stays in the 50 MB L2,
// so there the reads come from the L2 and the time can beat that bound; the
// 21,141,696-entry table of configs/instant_ngp_occ21.json (169 MB) does not
// fit, and every read is a row from device memory.
//
// Design: no descriptors and no semaphore. One warp copies one 512-byte row:
// each lane moves 16 bytes, one float4 load through the read-only path
// (ld.global.nc) and one streaming store (st.global.cs: out is not read
// again, so it should not push the table out of the L2). The rows are
// walked by a grid-stride loop over (descriptor, row), each warp taking
// kUnroll rows at once so that kUnroll loads are in flight before the
// first store. A grid of at most kBlocksPerSm blocks of 256 threads a
// multiprocessor keeps every SM full. TMA bulk copies (cp.async.bulk) and
// tuning are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 128;      // a 512-byte tile row
constexpr int kThreads = 256;        // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // rows in flight per warp
constexpr int kBlocksPerSm = 8;      // 2,048 threads: a full SM

__global__ void __launch_bounds__(kThreads)
block_fetch_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, long long n_rows, int rpd,
                   long long n_tile_rows) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  const float nan = __int_as_float(0x7fc00000);
  for (long long base = warp * kUnroll; base < n_rows; base += n_warps * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u;
      v[u] = make_float4(nan, nan, nan, nan);
      if (row < n_rows) {
        const long long j = row / rpd;
        const long long start = __ldg(idx + j);
        if (start >= 0 && start + rpd <= n_tile_rows) {
          const long long src = (start + row - j * rpd) * (kRowFloats / 4) + lane;
          v[u] = __ldg(table + src);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u;
      if (row < n_rows) __stcs(out + row * (kRowFloats / 4) + lane, v[u]);
    }
  }
}

}  // namespace

// out = the rows of table that idx names, rpd rows a descriptor; on
// `stream`. Returns a cudaError_t (0 on success); a launch is checked with
// cudaGetLastError.
extern "C" int block_fetch(const void* table, const void* idx, void* out,
                           long long n_tile_rows, long long n_desc, int rpd,
                           void* stream) {
  if (n_tile_rows <= 0 || n_desc < 0 || rpd < 1) return cudaErrorInvalidValue;
  const long long n_rows = n_desc * rpd;
  if (n_rows == 0) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long warps = (n_rows + kUnroll - 1) / kUnroll;
  long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  block_fetch_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(out), n_rows, rpd, n_tile_rows);
  return cudaGetLastError();
}
