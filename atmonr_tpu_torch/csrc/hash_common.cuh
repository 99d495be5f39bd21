// Index and weight math of the multiresolution hash grid, shared by the
// forward gather (hash_gather.cu) and the table gradient (hash_bwd.cu), so
// that the two cannot drift: the backward scatters into exactly the rows,
// with exactly the weights, that the forward gathered.
//
// Per point and level (the same ops in the same order as the Pallas kernels
// and the plain PyTorch version, models/hash_grid.py::level_indices):
//   pos  = x * scale_l + 0.5            (two roundings: __fmul_rn, __fadd_rn)
//   g    = floor(pos); frac = pos - g; base = clip(int(g), 0, res_l - 2)
//   corner c (x bit fastest):
//     idx = dense row-major index, or the spatial hash & (T - 1)
//     w   = prod_d (frac_d or 1 - frac_d), multiplied in dim order
// Every float op is an explicit round-to-nearest intrinsic, so nvcc cannot
// contract a multiply and an add into a fused multiply-add.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
// ops/kernel_plan.py plans with the same numbers as the next four.
// K1: a staged block takes kGroupLevels consecutive levels, one 32-byte
// sector of an output row. K2: a thread walks up to kRunPoints consecutive
// points. A staged block of K2 (one level's accumulators in shared memory)
// and a direct block of either kernel.
constexpr int kGroupLevels = 4;
constexpr int kRunPoints = 8;
constexpr int kStagedThreads = 512;
constexpr int kDirectThreads = 256;
// Dynamic shared memory a block may use on sm_90 (227 KB); the staged
// kernels hold no static shared memory.
constexpr int kMaxDynamicShared = 232448;

// Per-level constants, passed to a kernel by value. A block that works on
// one level reads its entry straight from the parameters.
struct LevelParams {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int dense[kMaxLevels];
  int rows[kMaxLevels];  // of the level's slice of the table
};

// Host side: copy the caller's per-level arrays into the by-value struct.
inline void fill_level_params(LevelParams& lp, int n_levels,
                              const float* level_scale, const int* level_res,
                              const int* level_offset, const int* level_dense,
                              const int* level_rows) {
  for (int l = 0; l < n_levels; ++l) {
    lp.scale[l] = level_scale[l];
    lp.res[l] = level_res[l];
    lp.offset[l] = level_offset[l];
    lp.dense[l] = level_dense[l];
    lp.rows[l] = level_rows[l];
  }
}

// Host side, once per kernel instance and before any launch of it that a
// CUDA graph captures: allow a kernel its dynamic shared memory beyond
// 48 KB, and give the SM's L1 / shared memory split to shared memory.
template <typename Kernel>
inline cudaError_t allow_full_shared_memory(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Instant-NGP spatial-hash primes (the first dimension's is 1)
__device__ __constant__ uint32_t kPrimes[3] = {1u, 2654435761u, 805459861u};

// A block's copy of the per-level constants in shared memory, for a kernel
// whose threads work on different levels.
struct LevelTable {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int dense[kMaxLevels];

  // Called by every thread of the block; ends in a __syncthreads().
  __device__ __forceinline__ void load(const LevelParams& lp, int n_levels) {
    if (threadIdx.x < n_levels) {
      scale[threadIdx.x] = lp.scale[threadIdx.x];
      res[threadIdx.x] = lp.res[threadIdx.x];
      offset[threadIdx.x] = lp.offset[threadIdx.x];
      dense[threadIdx.x] = lp.dense[threadIdx.x];
    }
    __syncthreads();
  }
};

// Cell of one point at one level: clipped base vertex and in-cell fraction.
template <int D>
struct Cell {
  float frac[D];
  int base[D];

  __device__ __forceinline__ Cell(const float* __restrict__ xp, float scale,
                                  int res) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float pos = __fadd_rn(__fmul_rn(xp[d], scale), 0.5f);
      const float g = floorf(pos);
      frac[d] = __fsub_rn(pos, g);
      base[d] = min(max(static_cast<int>(g), 0), res - 2);
    }
  }

  // Whether `other` lies in the same cell: then its corners are the same rows.
  __device__ __forceinline__ bool same_cell(const Cell& other) const {
    bool same = true;
#pragma unroll
    for (int d = 0; d < D; ++d) same = same && base[d] == other.base[d];
    return same;
  }

  // Row of corner `corner` within the level's table slice.
  __device__ __forceinline__ uint32_t index(int corner, int res, bool dense,
                                            uint32_t hash_mask) const {
    if (dense) {
      int stride = 1, i = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int bit = (corner >> d) & 1;
        i += (base[d] + bit) * stride;
        stride *= res;
      }
      return static_cast<uint32_t>(i);
    }
    uint32_t h = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (corner >> d) & 1;
      h ^= static_cast<uint32_t>(base[d] + bit) * kPrimes[d];
    }
    return h & hash_mask;
  }

  // D-linear interpolation weight of corner `corner`.
  __device__ __forceinline__ float weight(int corner) const {
    float w = 1.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (corner >> d) & 1;
      w = __fmul_rn(w, bit ? frac[d] : __fsub_rn(1.0f, frac[d]));
    }
    return w;
  }
};

}  // namespace
