// Hash-table gradient of the multiresolution hash encoding, sm_90a.
//
// Replaces the TPU kernel atmonr_tpu/ops/hash_bwd_pallas.py::
// hash_encode_pallas_bwd (body _bwd_kernel, layout helpers bwd_row_layout
// and unpack_grad_rows).
//
// What it computes: for positions x (M, D) and the output cotangent
// g (M, 2L), the cotangent of the flat (T, 2) float32 table,
//   dW[offset_l + idx, f] = sum over points p and corners c of
//                           w(p, l, c) * g[p, 2l + f],
// with idx and w recomputed from x exactly as the forward computes them
// (hash_common.cuh, shared with hash_gather.cu). It depends on x and g only,
// never on the forward's quantization: the gradient goes straight through
// to the float32 master table.
//
// The TPU kernel turns this scatter into one-hot matrix products over a
// VMEM-resident packed gradient, because a TPU has no atomics. Hopper has
// them, so this kernel is the direct form: one thread per (point, level),
// which reads its two cotangents once, forms the 2^D products w * g in
// exact float32 (__fmul_rn), and adds each into the zero-initialised output
// with one 8-byte atomicAdd(float2*) in global memory. Neighbouring threads
// take neighbouring levels of one point, so a warp's cotangent loads are
// contiguous and its atomics spread over the levels' table slices. The
// output is written in the flat table layout directly, and there is no
// table-size gate: the same kernel serves larger tables.
//
// The sum is float32 whatever bwd_mode the config names (the TPU kernel's
// bf16 mode is a matrix-unit trade that atomics do not need). Atomics add
// in an order that changes from run to run, so the result is not
// bit-reproducible: it agrees with the plain version to float32 summation
// error.
//
// Bound on this card: each input read once and the output written once is
// x (M*D*4) + g (M*2L*4) + dW (T*8) bytes, 28.6 MB at the flagship's
// M = 196,608, D = 3, about 8.5 us at 3.35 TB/s; the float32 arithmetic is
// under 3 us at 67 TFLOP/s, so bytes bound it. In practice the 2^D * M * L
// atomics (25.2 M at that shape) into a 1 MB table, which stays in L2,
// limit it, the more so where the points cluster and many threads contend
// for one row: measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W, 0.30 ms on uniform points and 0.41 ms on a trained model's sample
// points. Staging a level's slice in shared memory and pre-reducing within
// a warp are left for a later change.
//
// Bound through a plain C interface (ctypes); the launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError(). The
// caller zeroes the output.

#include "hash_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(256)
hash_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                float2* __restrict__ dtable, int64_t m, int n_levels,
                uint32_t hash_mask, const LevelParams lp) {
  __shared__ LevelTable lt;
  lt.load(lp, n_levels);  // ends in a __syncthreads()

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m * n_levels) return;
  const int level = static_cast<int>(t % n_levels);
  const int64_t p = t / n_levels;

  const int res = lt.res[level];
  const bool dense = lt.dense[level] != 0;
  const Cell<D> cell(x + p * D, lt.scale[level], res);

  const float2 gl = g[p * n_levels + level];
  float2* lvl = dtable + lt.offset[level];
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    const float w = cell.weight(corner);
    atomicAdd(lvl + cell.index(corner, res, dense, hash_mask),
              make_float2(__fmul_rn(w, gl.x), __fmul_rn(w, gl.y)));
  }
}

}  // namespace

extern "C" int hash_bwd(const void* x, const void* g, void* dtable,
                        long long m, int n_dims, int n_levels,
                        unsigned int hash_mask, const float* level_scale,
                        const int* level_res, const int* level_offset,
                        const int* level_dense, void* stream) {
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
  const float2* gf = static_cast<const float2*>(g);
  float2* dw = static_cast<float2*>(dtable);
  if (n_dims == 3) {
    hash_bwd_kernel<3><<<blocks, threads, 0, s>>>(xf, gf, dw, m, n_levels, hash_mask, lp);
  } else {
    hash_bwd_kernel<2><<<blocks, threads, 0, s>>>(xf, gf, dw, m, n_levels, hash_mask, lp);
  }
  return static_cast<int>(cudaGetLastError());
}
