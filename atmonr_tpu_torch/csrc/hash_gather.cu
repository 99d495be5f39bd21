// Multiresolution hash-encode forward over int8 (q8) feature tables, sm_90a.
//
// Replaces the TPU kernel atmonr_tpu/ops/hash_gather_pallas.py::
// hash_encode_pallas_fwd in "q8" mode (body _fused_kernel, _scan_chunks,
// _unpack_q8_pair; the per-level dequantization it applies after the
// pallas_call at :459-462 is done here, in the kernel, after the sum).
//
// What it computes, per point p and level l (the same ops in the same order
// as the Pallas kernel and the plain PyTorch version in ops/hash_gather.py),
// with the cell, corner index and weight math of hash_common.cuh, which the
// table gradient (hash_bwd.cu) shares:
//   for each of the 2^D corners, x bit fastest:
//     acc += w * q[offset_l + idx]      (f32, corner order, no FMA)
//   out[p, 2l : 2l + 2] = acc * s_l
//
// The TPU kernel scans the whole level table chunk by chunk for every
// lookup because a TPU has no fast random gather. Hopper has one, so this
// kernel reads each corner's char2 entry directly.
//
// Bound on this card: each input is read once and each output written once,
// so at the flagship's M = 196,608 points the unavoidable traffic is the
// 25.2 MB (M, 32) f32 output plus 2.4 MB of positions and the 254 KB table:
// about 8 us at 3.35 TB/s. The arithmetic (~70 f32 operations per point and
// level) is under 4 us at 67 TFLOP/s, so bytes bound it. In practice the
// 2^D random 2-byte gathers per point and level (25.2 M at the flagship
// shape) are expected to limit it: each touches its own 32-byte sector, in
// L1 or L2, since the whole int8 table (254 KB) stays cache-resident. The
// design keeps the table in int8 (4x fewer bytes than f32, so it stays in
// cache), makes each gather one 2-byte load, and writes the two features of
// a level as one 8-byte store, with neighbouring threads on neighbouring
// levels so a warp's stores are contiguous. Staging a level in shared memory
// is left for a later change.
//
// Bound through a plain C interface (ctypes); the launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include "hash_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(256)
hash_gather_q8_kernel(const float* __restrict__ x,
                      const char2* __restrict__ table,
                      const float* __restrict__ qscale,
                      float* __restrict__ out, int64_t m, int n_levels,
                      uint32_t hash_mask, const LevelParams lp) {
  __shared__ LevelTable lt;
  __shared__ float s_q[kMaxLevels];
  if (threadIdx.x < n_levels) s_q[threadIdx.x] = qscale[threadIdx.x];
  lt.load(lp, n_levels);  // ends in a __syncthreads()

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m * n_levels) return;
  const int level = static_cast<int>(t % n_levels);
  const int64_t p = t / n_levels;

  const int res = lt.res[level];
  const bool dense = lt.dense[level] != 0;
  const Cell<D> cell(x + p * D, lt.scale[level], res);

  const char2* lvl = table + lt.offset[level];
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    const float w = cell.weight(corner);
    const char2 v = lvl[cell.index(corner, res, dense, hash_mask)];
    acc0 = __fadd_rn(acc0, __fmul_rn(w, static_cast<float>(v.x)));
    acc1 = __fadd_rn(acc1, __fmul_rn(w, static_cast<float>(v.y)));
  }
  const float s = s_q[level];
  reinterpret_cast<float2*>(out)[p * n_levels + level] =
      make_float2(__fmul_rn(acc0, s), __fmul_rn(acc1, s));
}

}  // namespace

extern "C" int hash_gather_q8(const void* x, const void* table,
                              const void* qscale, void* out, long long m,
                              int n_dims, int n_levels, unsigned int hash_mask,
                              const float* level_scale, const int* level_res,
                              const int* level_offset, const int* level_dense,
                              void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_dims != 2 && n_dims != 3) return cudaErrorInvalidValue;
  LevelParams lp;
  fill_level_params(lp, n_levels, level_scale, level_res, level_offset, level_dense);
  const int threads = 256;
  const long long work = m * n_levels;
  if (work == 0) return cudaSuccess;
  const unsigned int blocks = static_cast<unsigned int>((work + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const char2* tb = static_cast<const char2*>(table);
  const float* qs = static_cast<const float*>(qscale);
  float* o = static_cast<float*>(out);
  if (n_dims == 3) {
    hash_gather_q8_kernel<3><<<blocks, threads, 0, s>>>(xf, tb, qs, o, m, n_levels,
                                                       hash_mask, lp);
  } else {
    hash_gather_q8_kernel<2><<<blocks, threads, 0, s>>>(xf, tb, qs, o, m, n_levels,
                                                       hash_mask, lp);
  }
  return static_cast<int>(cudaGetLastError());
}
