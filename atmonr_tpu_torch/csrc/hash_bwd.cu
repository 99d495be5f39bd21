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
// them. The first design here used them in the plainest way: one thread per
// (point, level), neighbouring threads on neighbouring levels, one 8-byte
// atomicAdd(float2*) per corner into the zeroed table in global memory.
//
// Bound on this card: each input read once and the output written once is
// x (M*D*4) + g (M*2L*4) + dW (T*8) bytes, 28.6 MB at the flagship's
// M = 196,608, D = 3, about 8.5 us at 3.35 TB/s; the float32 arithmetic is
// under 3 us at 67 TFLOP/s, so bytes bound it.
//
// What held the first design back: every one of its 2^D * M * L atomics
// (25.2 M at that shape) is a read-modify-write at an L2 cache slice, and
// the whole card retires well under 100 G of them a second (0.30 ms on
// uniform points, 0.41 ms on a trained model's sample points, which contend
// for rows). A warp touched all L levels at once, so with a 2^21-entry
// table the working set was the whole 169 MB cotangent, beyond the 50 MB L2,
// and the atomics went to device memory.
//
// What this design does about it (the level plan of ops/kernel_plan.py says
// whether a launch stages its levels or takes them directly):
// - runs: a thread walks up to 8 consecutive points at one level. Points
//   come ray by ray, so at the coarse levels neighbours share a cell; while
//   the cell stays the same the thread keeps the 2^D corner sums in
//   registers and adds them once when it changes (add_run below). That takes
//   the adds that would contend for one row out of the memory system: on
//   points that come ray by ray it is most of the gain.
// - staged levels: a block works on one level for one chunk of points. It
//   zeroes the level's float32 accumulators in dynamic shared memory, walks
//   its chunk in runs, adds each run's corner sums there, synchronises, and
//   adds each non-zero row into the global table with one
//   atomicAdd(float2*). The global atomics fall from one per corner to one
//   per touched row per block. A float atomicAdd on shared memory is no
//   native instruction on this card: nvcc compiles it to a compare-and-swap
//   loop (ATOMS.CAST.SPIN in the SASS), one per float, so a staged level
//   adds at about the rate of the L2's atomics and not orders above it:
//   0.21 against 0.31 ms on uniform points at the flagship shape. A 64-bit
//   compare-and-swap of both floats was as fast on spread points and far
//   slower where points share rows. A level's accumulators may take half of
//   a block's shared memory at most: with one 128 KB block of 512 threads to
//   an SM (2^14-entry levels, 196,608 points) staging lost to the direct
//   path, 0.37 against 0.32 ms on uniform points and 0.29 against 0.17 on
//   ray-ordered ones.
// - direct levels (a grid with a slice too large for shared memory, or too
//   few points for zeroing and flushing the slices to pay): one thread per
//   (run, level), neighbouring threads on neighbouring levels, one
//   atomicAdd(float2*) per corner of a run into the table. Blocks in level-major order were tried for these
//   and measured slower (the cotangent is then read 8 bytes at a 128-byte
//   stride from device memory), so the neighbouring-levels order stays.
// Two things were tried and taken out again. A level too large for a block,
// cut into 2 to 4 row ranges (a block per range walks the chunk and keeps the
// rows of its range), repeats the level's index math in every range's blocks
// and was slower than the direct path at every shape: 1,048,576 ray-ordered
// points into 2^15-entry levels 1.86 against 0.86 ms, uniform points 2.48
// against 1.61; 524,288 points 0.92 against 0.44. And a launch that staged
// only the few coarse levels that fit, beside a direct grid for the rest,
// was slower than all direct (0.93 against 0.86 ms, 2 of 16 levels): the
// runs have merged most of the coarse levels' adds already. So a launch is
// staged whole or not at all.
// A staged block's thread does read g[p, 2*level : 2*level + 2] at that
// stride. The grid is ordered so that the blocks of all levels of one chunk
// of points run close together: the chunk's g comes from device memory once
// and from the L2 after that (leaving the read out changed the time
// little). A transposed read was not needed.
//
// The sum is float32 whatever bwd_mode the config names (the TPU kernel's
// bf16 mode is a matrix-unit trade that atomics do not need). Atomics add
// in an order that changes from run to run, and a staged level is summed
// run by run and block by block first, so the result is not
// bit-reproducible: it agrees with the plain version to float32 summation
// error.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit, device time
// by CUDA-graph replay with the zero-fill of dW inside (chip_smoke.py, the
// first design and this one run in turns on one card), first design ->
// this one: 196,608 points into 2^13-entry levels (every level staged)
// 0.308 -> 0.210 ms on uniform points and 0.415 -> 0.194 on a trained
// model's sample points, against a bound of 0.0085; with every point in one
// cell of the finest level 0.443 (1.252 with one global atomic per corner,
// scripts/bench_kernels.py). Direct levels, a path's own points: 524,288
// points into 2^15-entry levels 1.391 -> 0.490; 1,048,576 points 3.136 ->
// 0.854, and into 2^21-entry levels 4.666 -> 0.864 (bound 0.094). On
// uniform points the direct path gains nothing over the first design (1.61
// ms at 1,048,576 points into 2^15-entry levels either way): the runs merge
// only what neighbours share. The rest is in PERF.md.
//
// Bound through a plain C interface (ctypes); the launch (a grid of staged
// blocks or one of direct threads) goes on the caller's stream, allocates
// nothing, and the function returns the first CUDA error. The caller zeroes
// the output.

#include "hash_common.cuh"

namespace {

// Adds into a staged level's accumulators in shared memory.
// atomicAdd(float*) on shared memory is no native instruction on this card:
// nvcc compiles it to a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS),
// one loop per float.
struct SharedAdd {
  float2* acc;
  __device__ __forceinline__ void operator()(uint32_t row, float vx, float vy) const {
    atomicAdd(&acc[row].x, vx);
    atomicAdd(&acc[row].y, vy);
  }
};

// Adds into the level's slice of the table in global memory: one 8-byte
// atomic at the L2 cache.
struct GlobalAdd {
  float2* lvl;
  __device__ __forceinline__ void operator()(uint32_t row, float vx, float vy) const {
    atomicAdd(lvl + row, make_float2(vx, vy));
  }
};

// One thread's run of consecutive points [p, p_stop) at one level. Points
// come ray by ray, so at the coarse levels neighbouring points share a cell:
// while the cell stays the same, the 2^D corner sums are kept in registers,
// and they go to `add` once when it changes. That takes the atomics that
// would contend for one row out of the memory system.
template <int D, typename Add>
__device__ __forceinline__ void add_run(const float* __restrict__ x,
                                        const float2* __restrict__ g, int64_t p,
                                        int64_t p_stop, int n_levels, int level,
                                        float scale, int res, bool dense,
                                        uint32_t hash_mask, const Add& add) {
  Cell<D> run(x + p * D, scale, res);
  float2 sum[1 << D];
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) sum[corner] = make_float2(0.0f, 0.0f);
  for (; p < p_stop; ++p) {
    const Cell<D> cell(x + p * D, scale, res);
    if (!cell.same_cell(run)) {
#pragma unroll
      for (int corner = 0; corner < (1 << D); ++corner) {
        add(run.index(corner, res, dense, hash_mask), sum[corner].x, sum[corner].y);
        sum[corner] = make_float2(0.0f, 0.0f);
      }
      run = cell;
    }
    const float2 gl = g[p * n_levels + level];
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
      const float w = cell.weight(corner);
      sum[corner].x = __fadd_rn(sum[corner].x, __fmul_rn(w, gl.x));
      sum[corner].y = __fadd_rn(sum[corner].y, __fmul_rn(w, gl.y));
    }
  }
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    add(run.index(corner, res, dense, hash_mask), sum[corner].x, sum[corner].y);
  }
}

// Block b holds level b % n_levels for the points of chunk b / n_levels: the
// level is the fast index, so the blocks of one chunk of points run close
// together and find its positions and cotangents in the L2 cache.
template <int D>
__global__ void __launch_bounds__(kStagedThreads)
hash_bwd_staged_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                       float2* __restrict__ dtable, int64_t m, int n_levels,
                       uint32_t hash_mask, int64_t chunk_points,
                       const LevelParams lp) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  float2* acc = reinterpret_cast<float2*>(shared_raw);

  const int level = static_cast<int>(blockIdx.x % n_levels);
  const int64_t chunk = blockIdx.x / n_levels;
  const uint32_t rows = static_cast<uint32_t>(lp.rows[level]);
  const float scale = lp.scale[level];
  const int res = lp.res[level];
  const bool dense = lp.dense[level] != 0;

  for (uint32_t r = threadIdx.x; r < rows; r += kStagedThreads) {
    acc[r] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  const int64_t p_end = (chunk + 1) * chunk_points < m ? (chunk + 1) * chunk_points : m;
  const SharedAdd add{acc};
  for (int64_t p = chunk * chunk_points + static_cast<int64_t>(threadIdx.x) * kRunPoints;
       p < p_end; p += kStagedThreads * kRunPoints) {
    const int64_t p_stop = p + kRunPoints < p_end ? p + kRunPoints : p_end;
    add_run<D>(x, g, p, p_stop, n_levels, level, scale, res, dense, hash_mask, add);
  }
  __syncthreads();

  // pointer arithmetic: the row offset is widened to 64 bits
  float2* out = dtable + lp.offset[level];
  for (uint32_t r = threadIdx.x; r < rows; r += kStagedThreads) {
    const float2 v = acc[r];
    if (v.x != 0.0f || v.y != 0.0f) atomicAdd(out + r, v);
  }
}

// One thread per (run of run_points points, level), neighbouring threads on
// neighbouring levels of one run: a warp's cotangent loads are contiguous,
// and its atomics spread over the levels' slices. The plan shortens the runs
// where a launch has too few points to fill the card with threads of
// kRunPoints points each.
template <int D>
__global__ void __launch_bounds__(kDirectThreads)
hash_bwd_direct_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                       float2* __restrict__ dtable, int64_t m, int n_levels,
                       uint32_t hash_mask, int run_points, const LevelParams lp) {
  // a warp's threads read different levels' entries: from shared memory, not
  // from the parameters, where such reads are serialised
  __shared__ LevelTable lt;
  lt.load(lp, n_levels);  // ends in a __syncthreads()

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDirectThreads + threadIdx.x;
  const int level = static_cast<int>(t % n_levels);
  const int64_t p = t / n_levels * run_points;
  if (p >= m) return;
  const int64_t p_stop = p + run_points < m ? p + run_points : m;
  const GlobalAdd add{dtable + lt.offset[level]};
  add_run<D>(x, g, p, p_stop, n_levels, level, lt.scale[level], lt.res[level],
             lt.dense[level] != 0, hash_mask, add);
}

template <int D>
int launch(const float* x, const float2* g, float2* dtable, long long m, int n_levels,
           unsigned int hash_mask, const LevelParams& lp, bool staged,
           long long chunk_points, int shared_bytes, int run_points, cudaStream_t s) {
  const long long max_grid = 2147483647LL;
  if (staged) {
    const long long blocks = (m + chunk_points - 1) / chunk_points * n_levels;
    if (blocks > max_grid) return cudaErrorInvalidValue;
    static bool allowed = false;  // per instance; the first call is not captured
    if (!allowed) {
      const cudaError_t err = allow_full_shared_memory(hash_bwd_staged_kernel<D>);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = true;
    }
    hash_bwd_staged_kernel<D><<<static_cast<unsigned int>(blocks), kStagedThreads,
                                shared_bytes, s>>>(
        x, g, dtable, m, n_levels, hash_mask, chunk_points, lp);
  } else {
    const long long runs = (m + run_points - 1) / run_points;
    const long long blocks = (runs * n_levels + kDirectThreads - 1) / kDirectThreads;
    if (blocks > max_grid) return cudaErrorInvalidValue;
    hash_bwd_direct_kernel<D><<<static_cast<unsigned int>(blocks), kDirectThreads, 0, s>>>(
        x, g, dtable, m, n_levels, hash_mask, run_points, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The level plan (ops/kernel_plan.py) follows the per-level arrays: whether
// blocks stage the levels, then in chunks of chunk_points points with
// shared_bytes of dynamic shared memory a block, or threads take them
// directly, in runs of run_points points.
extern "C" int hash_bwd(const void* x, const void* g, void* dtable,
                        long long m, int n_dims, int n_levels,
                        unsigned int hash_mask, const float* level_scale,
                        const int* level_res, const int* level_offset,
                        const int* level_dense, const int* level_rows, int staged,
                        long long chunk_points, int shared_bytes, int run_points,
                        void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n_dims != 2 && n_dims != 3) return cudaErrorInvalidValue;
  if (m <= 0) return m == 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (shared_bytes < 0 || shared_bytes > kMaxDynamicShared) return cudaErrorInvalidValue;
  if (staged) {
    if (chunk_points < 1 || chunk_points % (kStagedThreads * kRunPoints)) {
      return cudaErrorInvalidValue;
    }
    for (int l = 0; l < n_levels; ++l) {
      if (level_rows[l] < 1 ||
          static_cast<long long>(level_rows[l]) * static_cast<int>(sizeof(float2)) > shared_bytes) {
        return cudaErrorInvalidValue;
      }
    }
  } else if (run_points < 1 || run_points > kRunPoints) {
    return cudaErrorInvalidValue;
  }
  LevelParams lp;
  fill_level_params(lp, n_levels, level_scale, level_res, level_offset, level_dense,
                    level_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float2* gf = static_cast<const float2*>(g);
  float2* dw = static_cast<float2*>(dtable);
  if (n_dims == 3) {
    return launch<3>(xf, gf, dw, m, n_levels, hash_mask, lp, staged != 0, chunk_points,
                     shared_bytes, run_points, s);
  }
  return launch<2>(xf, gf, dw, m, n_levels, hash_mask, lp, staged != 0, chunk_points,
                   shared_bytes, run_points, s);
}
