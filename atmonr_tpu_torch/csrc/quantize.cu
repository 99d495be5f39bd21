// Table preparation of the q8 and f8 hash-encode modes, sm_90a: kernel K1p
// of the port.
//
// Replaces the quantizer inside the TPU kernel atmonr_tpu/ops/
// hash_gather_pallas.py::hash_encode_pallas_fwd: its pack_tables (:354),
// which quantizes the f32 master table level by level with
// quantize_level_q8 (:272) or quantize_level_f8 (:327) before the
// pallas_call. This kernel writes the int8 or float8_e4m3fn table that
// hash_gather.cu (K1) reads, and the per-level scales.
//
// What it computes, per level l of the flat (T, 2) f32 table, bit for bit as
// the plain version (ops/hash_gather.py::quantize_tables_q8 and
// quantize_tables_f8) does:
//   m_l  = max(max |t| over the level's rows, 1e-30)   (a NaN stays NaN)
//   q8:  s_l = m_l / 127; code = clamp(rint(t / s_l), -127, 127) as int8, or
//        with noise u (U[0,1), table-shaped) clamp(floor(t / s_l + u), ...)
//   f8:  s_l = 2^e with (f, e) = frexp(m_l / 448), e less one where f is
//        exactly 0.5; code = t / s_l cast to e4m3 with round to nearest even
//        (|t / s_l| <= 448 by construction, so the saturating cast never
//        saturates and equals torch's)
// Every division is a true f32 division (__fdiv_rn, never a multiply by a
// reciprocal), the add of the noise an explicit round-to-nearest add, rint
// rounds half to even as torch.round does, and the build takes no
// --use_fast_math. A table holding a NaN keeps its NaN in the scale; its
// codes are outside the bit-equality.
//
// Bound on this card: bytes. A call reads the table (8 bytes a row) and,
// with noise, the noise (8 bytes a row), and writes the codes (2 bytes a
// row) and the scales: 2.29 MB at the flagship's 126,976-row position table
// with noise, 0.68 us at 3.35 TB/s. The arithmetic is a few f32 operations
// an entry.
//
// What held the plain version back: the per-level maximum was a
// scatter_reduce ("amax") of every row into L addresses, all of them
// contended, and the whole preparation about a dozen passes over the table,
// each its own launch.
//
// Design: two launches of one geometry (ops/kernel_plan.py::quantize_plan,
// passed in as integers). Block b takes the flat rows [b R, (b + 1) R), R a
// multiple of 8. Every level's offset and size are multiples of 8 rows, so
// a float4 (two rows) never straddles a level, but a block's range may
// straddle several levels.
// 1. reduce: each thread walks its float4s and keeps the running maximum of
//    |t| of the level it is in, as the float's bits: every |t| is >= +0, so
//    the integer order of the bits is the float order (and a NaN's bits lie
//    above every number's). Where its level changes, and at the end, it
//    folds the maximum into the block's per-level maximum in shared memory
//    (a warp that ends in one level folds its 32 maxima first). The block
//    then writes partials[b, l] for every level l its range touches. No
//    global atomic and no memset: the second launch reads exactly the
//    entries the first wrote.
// 2. codes: for each level its range touches, block b reduces the partials
//    of the blocks whose ranges touch that level (b0 = offset_l / R to
//    (offset_l + rows_l - 1) / R, one warp a level) into m_l and computes
//    the scale; block b0, which holds the level's first row, stores it. The
//    block then reads its float4s again (from the L2: the first launch has
//    just read them, and every q8/f8 table the gate lets through is at most
//    32 levels x 2^16 rows, 16.8 MB) and the noise, and stores two rows'
//    four codes with one 4-byte store.
// Two plain launches and not one cooperative launch with a grid-wide sync:
// a CUDA graph captures plain launches (chip_smoke.py times every kernel by
// graph replay), and no block ever waits for another, so nothing requires
// every block to be resident at once.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;         // MAX_LEVELS in ops/kernel_plan.py
constexpr int kQuantizeThreads = 256;  // QUANTIZE_THREADS in ops/kernel_plan.py
constexpr int kWarps = kQuantizeThreads / 32;
constexpr unsigned int kFull = 0xffffffffu;

// First row of each level, and the table's row count after the last.
struct LevelSpans {
  long long offset[kMaxLevels + 1];
};

// The level of `row`, searching upwards from level `from` (a thread's rows
// only grow).
__device__ __forceinline__ int level_of(const LevelSpans& ls, int n_levels, long long row,
                                        int from) {
  int lv = from;
  while (lv + 1 < n_levels && row >= ls.offset[lv + 1]) ++lv;
  return lv;
}

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__global__ void __launch_bounds__(kQuantizeThreads)
quantize_reduce_kernel(const float4* __restrict__ table, unsigned int* __restrict__ partials,
                       long long n_rows, long long block_rows, int n_levels, LevelSpans ls) {
  __shared__ unsigned int level_max[kMaxLevels];
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long row1 = min(row0 + block_rows, n_rows);
  const int first = level_of(ls, n_levels, row0, 0);
  const int last = level_of(ls, n_levels, row1 - 1, first);
  if (threadIdx.x < kMaxLevels) level_max[threadIdx.x] = 0u;
  __syncthreads();

  int lv = first;
  unsigned int run = 0u;  // bits of the largest |t| this thread saw in level lv
  for (long long v = row0 / 2 + threadIdx.x; v < row1 / 2; v += kQuantizeThreads) {
    const int at = level_of(ls, n_levels, 2 * v, lv);
    if (at != lv) {
      atomicMax(&level_max[lv], run);
      lv = at;
      run = 0u;
    }
    const float4 t = __ldg(table + v);
    run = max(run, max(max(abs_bits(t.x), abs_bits(t.y)), max(abs_bits(t.z), abs_bits(t.w))));
  }
  // every thread of the block is here: a warp in one level folds first
  if (__all_sync(kFull, lv == __shfl_sync(kFull, lv, 0))) {
    run = __reduce_max_sync(kFull, run);
    if ((threadIdx.x & 31) == 0) atomicMax(&level_max[lv], run);
  } else {
    atomicMax(&level_max[lv], run);
  }
  __syncthreads();
  if (threadIdx.x <= last - first) {
    const int l = first + threadIdx.x;
    partials[static_cast<long long>(blockIdx.x) * n_levels + l] = level_max[l];
  }
}

// The level's scale from its largest |t|, as the plain version computes it.
template <bool kF8>
__device__ __forceinline__ float level_scale(float amax) {
  // torch.clamp(amax, min=1e-30): a NaN stays NaN (fmaxf would drop it)
  const float m = amax < 1e-30f ? 1e-30f : amax;
  if (!kF8) return __fdiv_rn(m, 127.0f);
  int e;
  const float f = frexpf(__fdiv_rn(m, 448.0f), &e);
  return ldexpf(1.0f, f == 0.5f ? e - 1 : e);
}

template <bool kNoise>
__device__ __forceinline__ unsigned int q8_code(float t, float s, float u) {
  const float v = __fdiv_rn(t, s);
  const float q = kNoise ? floorf(__fadd_rn(v, u)) : rintf(v);
  return static_cast<unsigned int>(__float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f))) & 0xffu;
}

__device__ __forceinline__ unsigned int f8_code(float t, float s) {
  return static_cast<unsigned int>(
      __nv_cvt_float_to_fp8(__fdiv_rn(t, s), __NV_SATFINITE, __NV_E4M3));
}

template <bool kF8, bool kNoise>
__global__ void __launch_bounds__(kQuantizeThreads)
quantize_codes_kernel(const float4* __restrict__ table, const float4* __restrict__ noise,
                      const unsigned int* __restrict__ partials,
                      unsigned int* __restrict__ codes, float* __restrict__ scales,
                      long long n_rows, long long block_rows, int n_levels, LevelSpans ls) {
  __shared__ float scale[kMaxLevels];
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long row1 = min(row0 + block_rows, n_rows);
  const int first = level_of(ls, n_levels, row0, 0);
  const int last = level_of(ls, n_levels, row1 - 1, first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = first + warp; l <= last; l += kWarps) {
    const long long b0 = ls.offset[l] / block_rows;
    const long long b1 = (ls.offset[l + 1] - 1) / block_rows;
    unsigned int bits = 0u;
    for (long long b = b0 + lane; b <= b1; b += 32) {
      bits = max(bits, partials[b * n_levels + l]);
    }
    bits = __reduce_max_sync(kFull, bits);
    if (lane == 0) {
      const float s = level_scale<kF8>(__uint_as_float(bits));
      scale[l] = s;
      if (b0 == blockIdx.x) scales[l] = s;
    }
  }
  __syncthreads();

  int lv = first;
  for (long long v = row0 / 2 + threadIdx.x; v < row1 / 2; v += kQuantizeThreads) {
    lv = level_of(ls, n_levels, 2 * v, lv);
    const float s = scale[lv];
    const float4 t = __ldg(table + v);
    unsigned int c0, c1, c2, c3;
    if (kF8) {
      c0 = f8_code(t.x, s), c1 = f8_code(t.y, s), c2 = f8_code(t.z, s), c3 = f8_code(t.w, s);
    } else {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kNoise) u = __ldg(noise + v);
      c0 = q8_code<kNoise>(t.x, s, u.x), c1 = q8_code<kNoise>(t.y, s, u.y);
      c2 = q8_code<kNoise>(t.z, s, u.z), c3 = q8_code<kNoise>(t.w, s, u.w);
    }
    // row 2v's two features, then row 2v + 1's, in memory order
    codes[v] = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
  }
}

template <bool kF8, bool kNoise>
cudaError_t launch_codes(const float4* table, const float4* noise,
                         const unsigned int* partials, unsigned int* codes, float* scales,
                         long long n_rows, long long block_rows, int n_levels,
                         const LevelSpans& ls, int blocks, cudaStream_t s) {
  quantize_codes_kernel<kF8, kNoise><<<blocks, kQuantizeThreads, 0, s>>>(
      table, noise, partials, codes, scales, n_rows, block_rows, n_levels, ls);
  return cudaGetLastError();
}

}  // namespace

// table (n_rows, 2) f32 -> codes (n_rows, 2) int8 (f8 = 0) or e4m3 (f8 = 1)
// and scales (n_levels,) f32, on `stream`. noise (n_rows, 2) f32 or null
// (q8 only). partials is (blocks, n_levels) of 4-byte scratch that the two
// launches share. The plan (ops/kernel_plan.py::quantize_plan): `blocks`
// blocks of block_rows rows, the last one shorter. Returns a cudaError_t (0
// on success); each launch is checked with cudaGetLastError.
extern "C" int quantize_tables(const void* table, const void* noise, void* partials,
                               void* codes, void* scales, long long n_rows, int n_levels,
                               const int* level_offset, int f8, int blocks,
                               long long block_rows, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_rows <= 0 || n_rows % 8 != 0) return cudaErrorInvalidValue;
  if (block_rows <= 0 || block_rows % 8 != 0 || blocks < 1) return cudaErrorInvalidValue;
  if ((n_rows + block_rows - 1) / block_rows != blocks) return cudaErrorInvalidValue;
  if (f8 && noise != nullptr) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(noise) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 4 != 0) {
    return cudaErrorMisalignedAddress;
  }
  LevelSpans ls;
  for (int l = 0; l < n_levels; ++l) {
    ls.offset[l] = level_offset[l];
    if (level_offset[l] % 8 != 0 || (l == 0 ? level_offset[l] != 0
                                            : level_offset[l] <= level_offset[l - 1])) {
      return cudaErrorInvalidValue;
    }
  }
  if (ls.offset[n_levels - 1] >= n_rows) return cudaErrorInvalidValue;
  ls.offset[n_levels] = n_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(table);
  const float4* u = static_cast<const float4*>(noise);
  unsigned int* p = static_cast<unsigned int*>(partials);
  unsigned int* c = static_cast<unsigned int*>(codes);
  float* sc = static_cast<float*>(scales);
  quantize_reduce_kernel<<<blocks, kQuantizeThreads, 0, s>>>(t, p, n_rows, block_rows,
                                                             n_levels, ls);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (f8) err = launch_codes<true, false>(t, u, p, c, sc, n_rows, block_rows, n_levels, ls,
                                          blocks, s);
  else if (noise) err = launch_codes<false, true>(t, u, p, c, sc, n_rows, block_rows,
                                                  n_levels, ls, blocks, s);
  else err = launch_codes<false, false>(t, u, p, c, sc, n_rows, block_rows, n_levels, ls,
                                        blocks, s);
  return err;
}
