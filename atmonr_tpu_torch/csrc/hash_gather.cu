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
// tables for that reason. Hopper has a gather, so this kernel reads each
// corner's entry directly and takes a table of any size.
//
// Bound on this card: each input is read once and each output written once,
// so at the flagship's M = 196,608 points the unavoidable traffic is the
// 25.2 MB (M, 32) f32 output plus 2.4 MB of positions and the table (254 KB
// in int8 or f8, 508 KB in bf16, 1 MB in f32): about 8 us at 3.35 TB/s. The
// arithmetic (~70 f32 operations per point and level) is under 4 us at
// 67 TFLOP/s, so bytes bound it. In practice the 2^D random gathers per
// point and level (25.2 M at the flagship shape) are expected to limit it:
// each touches its own 32-byte sector, in L1 or L2 while the table stays
// cache-resident, in HBM once it does not (a 2^21-entry bf16 table is
// 85 MB, larger than L2). The design makes each gather one load of the
// row's natural width and writes the two features of a level as one 8-byte
// store, with neighbouring threads on neighbouring levels so a warp's stores
// are contiguous. Staging a level in shared memory is left for a later
// change.
//
// Bound through a plain C interface (ctypes); the launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

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

template <typename Elem, int D>
__global__ void __launch_bounds__(256)
hash_gather_kernel(const float* __restrict__ x,
                   const typename Elem::Row* __restrict__ table,
                   const float* __restrict__ qscale, float* __restrict__ out,
                   int64_t m, int n_levels, uint32_t hash_mask,
                   const LevelParams lp) {
  __shared__ LevelTable lt;
  __shared__ float s_q[kMaxLevels];
  if (Elem::kScaled && threadIdx.x < n_levels) s_q[threadIdx.x] = qscale[threadIdx.x];
  lt.load(lp, n_levels);  // ends in a __syncthreads()

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m * n_levels) return;
  const int level = static_cast<int>(t % n_levels);
  const int64_t p = t / n_levels;

  const int res = lt.res[level];
  const bool dense = lt.dense[level] != 0;
  const Cell<D> cell(x + p * D, lt.scale[level], res);

  // pointer arithmetic: the row offset is widened to 64 bits
  const typename Elem::Row* lvl = table + lt.offset[level];
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    const float w = cell.weight(corner);
    const float2 v = Elem::decode(lvl[cell.index(corner, res, dense, hash_mask)]);
    acc0 = __fadd_rn(acc0, __fmul_rn(w, v.x));
    acc1 = __fadd_rn(acc1, __fmul_rn(w, v.y));
  }
  if (Elem::kScaled) {
    const float s = s_q[level];
    acc0 = __fmul_rn(acc0, s);
    acc1 = __fmul_rn(acc1, s);
  }
  reinterpret_cast<float2*>(out)[p * n_levels + level] = make_float2(acc0, acc1);
}

template <typename Elem>
int launch(const void* x, const void* table, const void* qscale, void* out,
           long long m, int n_dims, int n_levels, unsigned int hash_mask,
           const LevelParams& lp, cudaStream_t s) {
  const int threads = 256;
  const long long work = m * n_levels;
  const unsigned int blocks = static_cast<unsigned int>((work + threads - 1) / threads);
  const float* xf = static_cast<const float*>(x);
  const typename Elem::Row* tb = static_cast<const typename Elem::Row*>(table);
  const float* qs = static_cast<const float*>(qscale);
  float* o = static_cast<float*>(out);
  if (n_dims == 3) {
    hash_gather_kernel<Elem, 3><<<blocks, threads, 0, s>>>(xf, tb, qs, o, m, n_levels,
                                                          hash_mask, lp);
  } else {
    hash_gather_kernel<Elem, 2><<<blocks, threads, 0, s>>>(xf, tb, qs, o, m, n_levels,
                                                          hash_mask, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem: 0 = q8 (int8 rows + scales), 1 = bf16, 2 = f32, 3 = f8 (e4m3 rows +
// scales). qscale is read only by the scaled types.
extern "C" int hash_gather(const void* x, const void* table, const void* qscale,
                           void* out, long long m, int n_dims, int n_levels,
                           unsigned int hash_mask, const float* level_scale,
                           const int* level_res, const int* level_offset,
                           const int* level_dense, int elem, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_dims != 2 && n_dims != 3) return cudaErrorInvalidValue;
  if (m * n_levels == 0) return cudaSuccess;
  if ((m * n_levels + 255) / 256 > 2147483647LL) return cudaErrorInvalidValue;  // grid limit
  LevelParams lp;
  fill_level_params(lp, n_levels, level_scale, level_res, level_offset, level_dense);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 0:
      if (qscale == nullptr) return cudaErrorInvalidValue;
      return launch<ElemQ8>(x, table, qscale, out, m, n_dims, n_levels, hash_mask, lp, s);
    case 1:
      return launch<ElemBf16>(x, table, qscale, out, m, n_dims, n_levels, hash_mask, lp, s);
    case 2:
      return launch<ElemF32>(x, table, qscale, out, m, n_dims, n_levels, hash_mask, lp, s);
    case 3:
      if (qscale == nullptr) return cudaErrorInvalidValue;
      return launch<ElemF8>(x, table, qscale, out, m, n_dims, n_levels, hash_mask, lp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
