// Multiresolution hash-encode forward over bf16, f32, int8 (q8) and
// float8_e4m3fn (f8) feature tables, sm_90a.
//
// Replaces the TPU kernel atmonr_tpu/ops/hash_gather_pallas.py::
// hash_encode_pallas_fwd in its four modes (body _fused_kernel, _scan_chunks,
// _unpack_bf16_pair, _unpack_q8_pair, _unpack_f8_pair / _decode_e4m3; the
// per-level dequantization it applies to q8 and f8 after the pallas_call is
// done here, in the kernel, after the sum).
//
// What it computes, per point p and level l (the same ops in the same order
// as the Pallas kernel and the plain PyTorch version in ops/hash_gather.py),
// with the cell, corner index and weight math of hash_common.cuh, which the
// table gradient (hash_bwd.cu) shares:
//   for each of the 2^D corners, x bit fastest:
//     acc += w * f32(table[offset_l + idx])   (f32, corner order, no FMA)
//   out[p, 2l : 2l + 2] = acc               (bf16, f32)
//                       = acc * s_l         (q8, f8: the level's scale)
// One kernel template serves the four table types; an element type says how
// the two features of a table row are loaded and turned into f32, exactly:
//   bf16  one 4-byte load; a bf16's f32 bits are its own bits << 16. Only
//         the table is rounded: weights, products and sums are f32.
//   f32   one 8-byte load.
//   q8    one 2-byte load of two int8.
//   f8    one 2-byte load of two e4m3 codes, decoded by hand as the Pallas
//         kernel does: normals by rebiasing the exponent into f32 bits,
//         E = 0 as M * 2^-9. The quantizer never emits the NaN code.
//
// The TPU kernel scans the whole level table chunk by chunk for every
// lookup because a TPU has no fast random gather, and is gated to small
// tables for that reason. Hopper has a gather. The first design here used it
// in the plainest way: one thread per (point, level), neighbouring threads on
// neighbouring levels, each corner's row read from global memory, a table of
// any size.
//
// Bound on this card: each input is read once and each output written once,
// so at the flagship's M = 196,608 points the unavoidable traffic is the
// 25.2 MB (M, 32) f32 output plus 2.4 MB of positions and the table (254 KB
// in int8 or f8, 508 KB in bf16, 1 MB in f32): about 8 us at 3.35 TB/s. The
// arithmetic (~70 f32 operations per point and level) is under 4 us at
// 67 TFLOP/s, so bytes bound it.
//
// What held the first design back: its 2^D random gathers per point and
// level (25.2 M at that shape) each fetch a 32-byte sector, and a warp
// touched all L levels at once, so every SM's working set was the whole
// table. On uniform points its time followed the table's footprint, not the
// row's width (0.057 ms at 254 KB, 0.095 ms at 508 KB, 0.127 ms at 1 MB):
// what did not fit an SM's L1 came from the L2, one sector per gather.
//
// What this design does about it (the level plan of ops/kernel_plan.py says
// whether a launch stages its levels or takes them directly):
// - staged levels: a block takes a group of 4 consecutive levels for one
//   chunk of points. It copies the 4 levels' slices of the table, in their
//   storage type, into dynamic shared memory once (16-byte loads; a level's
//   offset is a multiple of 8 rows, so of 16 bytes even for 2-byte rows),
//   then each thread gathers its point's 4 x 2^D rows from shared memory:
//   the gathers never leave the SM. Why 4 levels and not 1: a block that
//   took one level stored 8 bytes a thread at the output row's 128-byte
//   stride, one request to the L2 per thread, and those requests, not the
//   gathers, then bounded it (the same time in every table type, and less
//   than half of it with the stores left out). 4 levels are one 32-byte
//   sector of the output row; neighbouring lanes swap halves, so that every
//   store instruction writes whole sectors.
// - direct levels (a grid with a group whose slices do not fit a block's
//   shared memory: 4 x 64 KB in f32 at 2^13, anything at 2^15 and beyond; or
//   too few points for copying the slices to pay): the first design's
//   kernel, one thread per (point, level), each corner's row from global
//   memory. Blocks in level-major order were tried for these and measured
//   slower on points that come ray by ray (their stores are the strided ones
//   above), so the neighbouring-levels order stays.
// A launch is staged whole or not at all: staging only the coarse groups that
// fit, beside a direct grid for the rest, measured slower than all direct,
// and the test it put into every direct thread cost 6 to 10% at 8,192
// points.
// The arithmetic per point and level (encode below) is the first design's,
// whichever way a row is read: a point's corners are summed by one thread in
// corner order, so the result equals the plain version bit for bit. That is
// also why no level is cut into row ranges: that thread needs all its rows.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit, device time
// by CUDA-graph replay (chip_smoke.py, the first design and this one run in
// turns on one card), first design -> this one, 196,608 uniform points
// into 2^13-entry levels, bound 0.008 ms: q8 0.058 -> 0.037 ms, bf16 0.095
// -> 0.037, f8 0.054 -> 0.045 (its decode now shows), f32 0.126 -> 0.126
// (direct). bf16 on a path's own points: 0.061 -> 0.037 at that shape;
// direct and unchanged within 2% at 2^15- and 2^21-entry levels (1,048,576
// points: 0.201 -> 0.201 and 0.205 -> 0.201). The rest is in PERF.md.
//
// Bound through a plain C interface (ctypes); the launch (a grid of staged
// blocks or one of direct threads) goes on the caller's stream, allocates
// nothing, and the function returns the first CUDA error.

#include "hash_common.cuh"

namespace {

// Table element types: how one row's two features are stored, and their
// exact conversion to f32. kScaled: multiply the corner sum by the level's
// scale.
struct ElemQ8 {
  using Row = char2;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float2 decode(Row v) {
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};

struct ElemBf16 {
  using Row = uint32_t;  // feature 0 in the low half, feature 1 in the high
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float2 decode(Row v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
  }
};

struct ElemF32 {
  using Row = float2;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float2 decode(Row v) { return v; }
};

struct ElemF8 {
  using Row = uint16_t;  // feature 0 in the low byte, feature 1 in the high
  static constexpr bool kScaled = true;
  // one float8_e4m3fn code (bias 7, no infinities) -> f32
  static __device__ __forceinline__ float code(uint32_t byte) {
    const uint32_t mag = byte & 127u;
    const float v = mag >= 8u ? __uint_as_float((mag << 20) + (120u << 23))
                              : __fmul_rn(static_cast<float>(mag), 0.001953125f);
    return (byte & 128u) ? -v : v;
  }
  static __device__ __forceinline__ float2 decode(Row v) {
    return make_float2(code(v & 255u), code(v >> 8));
  }
};

constexpr int kGatherThreads = 1024;  // of a staged block (GATHER_THREADS in the plan)

// One point at one level: the corner sum in f32, in corner order, from the
// level's rows at `lvl` (shared or global memory).
template <typename Elem, int D>
__device__ __forceinline__ float2 encode(const float* __restrict__ xp,
                                         const typename Elem::Row* __restrict__ lvl,
                                         float scale, int res, bool dense,
                                         uint32_t hash_mask, float qscale) {
  const Cell<D> cell(xp, scale, res);
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    const float w = cell.weight(corner);
    const float2 v = Elem::decode(lvl[cell.index(corner, res, dense, hash_mask)]);
    acc0 = __fadd_rn(acc0, __fmul_rn(w, v.x));
    acc1 = __fadd_rn(acc1, __fmul_rn(w, v.y));
  }
  if (Elem::kScaled) {
    acc0 = __fmul_rn(acc0, qscale);
    acc1 = __fmul_rn(acc1, qscale);
  }
  return make_float2(acc0, acc1);
}

__device__ __forceinline__ float4 shfl_xor(const float4& v, int lane_mask) {
  return make_float4(__shfl_xor_sync(0xFFFFFFFFu, v.x, lane_mask),
                     __shfl_xor_sync(0xFFFFFFFFu, v.y, lane_mask),
                     __shfl_xor_sync(0xFFFFFFFFu, v.z, lane_mask),
                     __shfl_xor_sync(0xFFFFFFFFu, v.w, lane_mask));
}

// Block b takes the kGroupLevels levels of group b % n_groups for the
// points of chunk b / n_groups, neighbouring threads on neighbouring
// points. It copies its levels' slices into shared memory once, one after
// the other (16-byte loads), and gathers from there. A thread holds its
// point's kGroupLevels results, one 32-byte sector of the output row. Every
// thread of the block stays to the end (the barrier, the shuffles); a thread
// beyond the last point stores nothing.
template <typename Elem, int D>
__global__ void __launch_bounds__(kGatherThreads)
hash_gather_staged_kernel(const float* __restrict__ x,
                          const typename Elem::Row* __restrict__ table,
                          const float* __restrict__ qscale, float* __restrict__ out,
                          int64_t m, int n_levels, uint32_t hash_mask,
                          int64_t chunk_points, const LevelParams lp) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  using Row = typename Elem::Row;

  const int n_groups = (n_levels + kGroupLevels - 1) / kGroupLevels;
  const int level0 = static_cast<int>(blockIdx.x % n_groups) * kGroupLevels;
  const int64_t chunk = blockIdx.x / n_groups;

  uint32_t at[kGroupLevels];  // where in shared memory each staged level starts
  uint32_t filled = 0;
#pragma unroll
  for (int j = 0; j < kGroupLevels; ++j) {
    const int level = level0 + j;
    at[j] = filled;
    if (level < n_levels) {  // the same for the whole block
      // pointer arithmetic: the row offset is widened to 64 bits
      const uint4* src = reinterpret_cast<const uint4*>(table + lp.offset[level]);
      uint4* dst = reinterpret_cast<uint4*>(shared_raw + filled);
      const uint32_t n16 = static_cast<uint32_t>(lp.rows[level]) * sizeof(Row) / 16;
      for (uint32_t i = threadIdx.x; i < n16; i += kGatherThreads) dst[i] = __ldg(src + i);
      filled += n16 * 16;
    }
  }
  __syncthreads();

  const bool whole_sector = level0 + kGroupLevels <= n_levels && n_levels % 2 == 0;
  const bool odd = (threadIdx.x & 1u) != 0u;
  float4* out4 = reinterpret_cast<float4*>(out);
  const int64_t row16 = n_levels / 2;  // 16-byte pieces of an output row
  const int64_t p_end = (chunk + 1) * chunk_points < m ? (chunk + 1) * chunk_points : m;
  for (int64_t first = chunk * chunk_points; first < p_end; first += kGatherThreads) {
    const int64_t p = first + threadIdx.x;
    const float* xp = x + (p < p_end ? p : p_end - 1) * D;
    float2 r[kGroupLevels];
#pragma unroll
    for (int j = 0; j < kGroupLevels; ++j) {
      const int level = level0 + j;
      r[j] = make_float2(0.0f, 0.0f);
      if (level < n_levels) {  // the same for the whole block
        r[j] = encode<Elem, D>(xp, reinterpret_cast<const Row*>(shared_raw + at[j]),
                               lp.scale[level], lp.res[level], lp.dense[level] != 0,
                               hash_mask, Elem::kScaled ? qscale[level] : 1.0f);
      }
    }
    if (whole_sector) {
      // A store of 8 bytes a thread at the row's stride is one request to
      // the L2 per thread, and those requests bounded a kernel that stored
      // one level per thread. So neighbouring lanes swap halves of their
      // sectors, and each 16-byte store instruction writes whole sectors:
      // the even lane's sector first, then the odd lane's.
      const float4 lo = make_float4(r[0].x, r[0].y, r[1].x, r[1].y);
      const float4 hi = make_float4(r[2].x, r[2].y, r[3].x, r[3].y);
      const float4 other = shfl_xor(odd ? lo : hi, 1);
      const int64_t p_even = odd ? p - 1 : p;  // chunks and blocks hold even numbers of points
      const int64_t piece = level0 / 2 + (odd ? 1 : 0);
      if (p_even < p_end) out4[p_even * row16 + piece] = odd ? other : lo;
      if (p_even + 1 < p_end) out4[(p_even + 1) * row16 + piece] = odd ? hi : other;
    } else if (p < p_end) {
#pragma unroll
      for (int j = 0; j < kGroupLevels; ++j) {
        if (level0 + j < n_levels) {
          reinterpret_cast<float2*>(out)[p * n_levels + level0 + j] = r[j];
        }
      }
    }
  }
}

// One thread per (point, level), neighbouring threads on neighbouring levels
// of one point: a warp's stores are contiguous, and each corner's row comes
// from global memory (the first design's kernel).
template <typename Elem, int D>
__global__ void __launch_bounds__(kDirectThreads)
hash_gather_direct_kernel(const float* __restrict__ x,
                          const typename Elem::Row* __restrict__ table,
                          const float* __restrict__ qscale, float* __restrict__ out,
                          int64_t m, int n_levels, uint32_t hash_mask,
                          const LevelParams lp) {
  // a warp's threads read different levels' entries: from shared memory, not
  // from the parameters, where such reads are serialised
  __shared__ LevelTable lt;
  __shared__ float s_q[kMaxLevels];
  if (Elem::kScaled && threadIdx.x < n_levels) s_q[threadIdx.x] = qscale[threadIdx.x];
  lt.load(lp, n_levels);  // ends in a __syncthreads()

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDirectThreads + threadIdx.x;
  if (t >= m * n_levels) return;
  const int level = static_cast<int>(t % n_levels);
  const int64_t p = t / n_levels;
  reinterpret_cast<float2*>(out)[p * n_levels + level] = encode<Elem, D>(
      x + p * D, table + lt.offset[level], lt.scale[level], lt.res[level],
      lt.dense[level] != 0, hash_mask, Elem::kScaled ? s_q[level] : 1.0f);
}

template <typename Elem, int D>
int launch_dims(const float* x, const typename Elem::Row* table, const float* qscale,
                float* out, long long m, int n_levels, unsigned int hash_mask,
                const LevelParams& lp, bool staged, long long chunk_points,
                int shared_bytes, cudaStream_t s) {
  const long long max_grid = 2147483647LL;
  if (staged) {
    const int n_groups = (n_levels + kGroupLevels - 1) / kGroupLevels;
    const long long blocks = (m + chunk_points - 1) / chunk_points * n_groups;
    if (blocks > max_grid) return cudaErrorInvalidValue;
    static bool allowed = false;  // per instance; the first call is not captured
    if (!allowed) {
      const cudaError_t err = allow_full_shared_memory(hash_gather_staged_kernel<Elem, D>);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = true;
    }
    hash_gather_staged_kernel<Elem, D><<<static_cast<unsigned int>(blocks), kGatherThreads,
                                         shared_bytes, s>>>(
        x, table, qscale, out, m, n_levels, hash_mask, chunk_points, lp);
  } else {
    const long long blocks = (m * n_levels + kDirectThreads - 1) / kDirectThreads;
    if (blocks > max_grid) return cudaErrorInvalidValue;
    hash_gather_direct_kernel<Elem, D><<<static_cast<unsigned int>(blocks), kDirectThreads,
                                         0, s>>>(
        x, table, qscale, out, m, n_levels, hash_mask, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

// A staged plan is checked here, where the row's width is known: every
// group's slices fit the block's shared memory and can be copied 16 bytes
// at a time.
template <typename Elem>
int launch(const void* x, const void* table, const void* qscale, void* out,
           long long m, int n_dims, int n_levels, unsigned int hash_mask,
           const LevelParams& lp, bool staged, long long chunk_points, int shared_bytes,
           cudaStream_t s) {
  using Row = typename Elem::Row;
  if (Elem::kScaled && qscale == nullptr) return cudaErrorInvalidValue;
  if (staged) {
    // the staged copy and the sector stores move 16 bytes at a time
    if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
    if (chunk_points < 1 || chunk_points % kGatherThreads != 0) return cudaErrorInvalidValue;
    for (int level0 = 0; level0 < n_levels; level0 += kGroupLevels) {
      long long bytes = 0;
      for (int l = level0; l < level0 + kGroupLevels && l < n_levels; ++l) {
        if (lp.rows[l] < 8 || lp.rows[l] % 8 != 0 || lp.offset[l] % 8 != 0) {
          return cudaErrorInvalidValue;
        }
        bytes += static_cast<long long>(lp.rows[l]) * sizeof(Row);
      }
      if (bytes > shared_bytes) return cudaErrorInvalidValue;
    }
  }
  const float* xf = static_cast<const float*>(x);
  const Row* tb = static_cast<const Row*>(table);
  const float* qs = static_cast<const float*>(qscale);
  float* o = static_cast<float*>(out);
  if (n_dims == 3) {
    return launch_dims<Elem, 3>(xf, tb, qs, o, m, n_levels, hash_mask, lp, staged,
                                chunk_points, shared_bytes, s);
  }
  return launch_dims<Elem, 2>(xf, tb, qs, o, m, n_levels, hash_mask, lp, staged,
                              chunk_points, shared_bytes, s);
}

}  // namespace

// elem: 0 = q8 (int8 rows + scales), 1 = bf16, 2 = f32, 3 = f8 (e4m3 rows +
// scales). qscale is read only by the scaled types. The level plan
// (ops/kernel_plan.py) follows elem: whether blocks stage the levels, the
// points of a staged block's chunk and its dynamic shared memory.
extern "C" int hash_gather(const void* x, const void* table, const void* qscale,
                           void* out, long long m, int n_dims, int n_levels,
                           unsigned int hash_mask, const float* level_scale,
                           const int* level_res, const int* level_offset,
                           const int* level_dense, const int* level_rows, int elem,
                           int staged, long long chunk_points, int shared_bytes,
                           void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_dims != 2 && n_dims != 3) return cudaErrorInvalidValue;
  if (m <= 0) return m == 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (shared_bytes < 0 || shared_bytes > kMaxDynamicShared) return cudaErrorInvalidValue;
  LevelParams lp;
  fill_level_params(lp, n_levels, level_scale, level_res, level_offset, level_dense,
                    level_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATMONR_LAUNCH(Elem)                                                             \
  launch<Elem>(x, table, qscale, out, m, n_dims, n_levels, hash_mask, lp, staged != 0, \
               chunk_points, shared_bytes, s)
  switch (elem) {
    case 0: return ATMONR_LAUNCH(ElemQ8);
    case 1: return ATMONR_LAUNCH(ElemBf16);
    case 2: return ATMONR_LAUNCH(ElemF32);
    case 3: return ATMONR_LAUNCH(ElemF8);
    default: return cudaErrorInvalidValue;
  }
#undef ATMONR_LAUNCH
}
