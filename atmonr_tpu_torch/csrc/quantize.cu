// Table preparation of the q8, f8 and bf16 hash-encode modes, sm_90a: kernel
// K1p of the port (round_bf16_kernel, the bf16 rounding, is at the end).
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
// with noise, 0.68 us at 3.35 TB/s, below the fixed cost of one launch. The
// arithmetic is a few f32 operations an entry.
//
// Design: one launch per table, one thread-block cluster per level
// (ops/kernel_plan.py::quantize_plan, passed in as integers). The grid is
// n_levels x C blocks in clusters of C (8, the portable maximum, at every
// shipped grid); cluster l is level l, and its block r takes the rows
// [off_l + r S_l, min(off_l + (r + 1) S_l, off_l + size_l)), S_l the plan's
// slice rows, a multiple of 8. A slice never crosses a level, and the last
// blocks of a small level may be empty (their maximum is +0).
// 1. Loads: a thread issues all its table float4s (two rows each), and its
//    noise float4s, before it reduces anything. The table's stay in
//    registers: at most kVecs a thread, which the plan's 256 or 512 threads
//    give at every shipped grid with C = 8. The noise is not needed until
//    the codes, so it goes by cp.async into shared memory (up to 64 KB a
//    block) and takes no registers: held in registers it took the kernel
//    from 57 to 90 registers a thread, one block of 512 threads an SM, and
//    the gate grid's 32 clusters of 8 ran in two waves.
// 2. Block maximum of |t| as the float's bits: every |t| is >= +0, so the
//    integer order of the bits is the float order (and a NaN's bits lie
//    above every number's). __reduce_max_sync in each warp, then one shared
//    word of the block.
// 3. Cluster maximum: a cluster barrier (arrive.release / wait.acquire),
//    then warp 0 reads the C blocks' words through distributed shared
//    memory and computes the scale. The maximum is exact, so every block of
//    the cluster gets the same scale; rank 0 stores it.
// 4. Codes from the registers (and the staged noise), two rows' four codes
//    in one 4-byte store.
// 5. Exit: a second cluster barrier, arrived at (relaxed) once the peers'
//    words are read and waited on before the block exits, so that no
//    block's shared memory goes while a peer still reads it.
// No global scratch, no second read of the table or the noise, no atomic.
// Where a slice holds more float4s than a thread's registers keep (C = 1 or
// 2 at the larger grids, which only the tests ask for), the block walks its
// slice in rounds for the maximum and reads it again for the codes.
//
// It replaced an earlier design of two launches over flat row ranges (the
// blocks' per-level maxima into a global partials array, then the scales
// and the codes from a second read of the table): each launch paid a
// launch's fixed latency and a memory round trip, and the second re-read
// the table and the noise from the L2. A cluster launch is captured by a CUDA graph like a
// plain one; a cooperative launch with a grid-wide sync is not needed,
// because only the C blocks of one cluster ever wait for each other, and
// the hardware schedules a cluster's blocks together.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 32;       // MAX_LEVELS in ops/kernel_plan.py
constexpr int kMaxThreads = 512;     // the plan's threads are 256 or 512
constexpr int kVecs = 8;             // QUANTIZE_VECS: float4s a thread keeps
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr unsigned int kFull = 0xffffffffu;

// First row of each level and the table's row count after the last; each
// level's slice rows.
struct Levels {
  long long offset[kMaxLevels + 1];
  int slice[kMaxLevels];
};

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned int abs_max4(const float4& t) {
  return max(max(abs_bits(t.x), abs_bits(t.y)), max(abs_bits(t.z), abs_bits(t.w)));
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

// Row 2v's two features, then row 2v + 1's, in memory order.
template <bool kF8, bool kNoise>
__device__ __forceinline__ unsigned int pack_codes(const float4& t, const float4& u, float s) {
  unsigned int c0, c1, c2, c3;
  if (kF8) {
    c0 = f8_code(t.x, s), c1 = f8_code(t.y, s), c2 = f8_code(t.z, s), c3 = f8_code(t.w, s);
  } else {
    c0 = q8_code<kNoise>(t.x, s, u.x), c1 = q8_code<kNoise>(t.y, s, u.y);
    c2 = q8_code<kNoise>(t.z, s, u.z), c3 = q8_code<kNoise>(t.w, s, u.w);
  }
  return c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
}

// The exit barrier of the cluster, split: every thread of every block
// arrives once its block has read what it reads of its peers' shared memory
// (relaxed: those reads have returned their values, and no write of this
// block needs to be seen by a peer), and waits before the block exits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A 16-byte copy from global to shared memory that bypasses the registers
// (cp.async, L2 only), and the wait for all of this thread's copies.
__device__ __forceinline__ void copy_async16(float4* shared, const float4* global) {
  const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(global) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kF8, bool kNoise>
__global__ void __launch_bounds__(kMaxThreads)
quantize_kernel(const float4* __restrict__ table, const float4* __restrict__ noise,
                unsigned int* __restrict__ codes, float* __restrict__ scales, Levels lv) {
  __shared__ unsigned int warp_max[kMaxThreads / 32];
  __shared__ unsigned int block_max;
  __shared__ float block_scale;
  extern __shared__ float4 noise_stage[];  // with noise: threads x kVecs
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int c = cluster.num_blocks();
  const unsigned int rank = cluster.block_rank();
  const int level = blockIdx.x / c;
  const long long end = lv.offset[level + 1];
  const long long row0 =
      min(lv.offset[level] + static_cast<long long>(rank) * lv.slice[level], end);
  const long long row1 = min(row0 + lv.slice[level], end);
  // the slice as float4s: [v0, v0 + n)
  const long long v0 = row0 / 2, n = (row1 - row0) / 2;
  const int threads = blockDim.x;
  const long long per_round = static_cast<long long>(threads) * kVecs;
  const bool in_registers = n <= per_round;

  float4 t[kVecs];
  unsigned int run = 0u;  // bits of the largest |t| this thread saw
  for (long long base = threadIdx.x; base < n; base += per_round) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = base + static_cast<long long>(k) * threads;
      if (i < n) {
        t[k] = __ldg(table + v0 + i);
        if (kNoise && in_registers) copy_async16(noise_stage + k * threads + threadIdx.x,
                                                 noise + v0 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (base + static_cast<long long>(k) * threads < n) run = max(run, abs_max4(t[k]));
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  run = __reduce_max_sync(kFull, run);
  if (lane == 0) warp_max[warp] = run;
  __syncthreads();
  if (warp == 0) {
    unsigned int m = lane < (threads >> 5) ? warp_max[lane] : 0u;
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) block_max = m;
  }
  cluster.sync();  // every block's word is written and visible to the cluster
  if (warp == 0) {
    unsigned int m = 0u;
    if (static_cast<unsigned int>(lane) < c) m = *cluster.map_shared_rank(&block_max, lane);
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) block_scale = level_scale<kF8>(__uint_as_float(m));
  }
  cluster_arrive_relaxed();  // this block is done with its peers' shared memory
  __syncthreads();           // block_scale
  const float s = block_scale;
  if (rank == 0 && threadIdx.x == 0) scales[level] = s;

  if (in_registers) {
    if (kNoise) copy_async_wait();  // this thread's own noise copies
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = threadIdx.x + static_cast<long long>(k) * threads;
      if (i < n) {
        const float4 u = kNoise ? noise_stage[k * threads + threadIdx.x] : t[k];
        codes[v0 + i] = pack_codes<kF8, kNoise>(t[k], u, s);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += threads) {
      const float4 a = __ldg(table + v0 + i);
      const float4 b = kNoise ? __ldg(noise + v0 + i) : a;
      codes[v0 + i] = pack_codes<kF8, kNoise>(a, b, s);
    }
  }
  cluster_wait();  // no peer reads this block's word any more
}

// The launch floor: no work, the same grid and cluster shape.
__global__ void __launch_bounds__(kMaxThreads) empty_kernel() {}

// Bytes of a block's noise stage: a float4 for each of its threads' kVecs.
size_t stage_bytes(bool noise, int threads) {
  return noise ? static_cast<size_t>(threads) * kVecs * sizeof(float4) : 0;
}

cudaLaunchConfig_t cluster_config(int n_levels, int cluster, int threads, size_t shared_bytes,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_levels * cluster, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

bool valid_shape(int n_levels, int cluster, int threads) {
  return n_levels >= 1 && n_levels <= kMaxLevels && cluster >= 1 &&
         cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

template <bool kF8, bool kNoise>
cudaError_t launch(const float4* table, const float4* noise, unsigned int* codes,
                   float* scales, const Levels& lv, int n_levels, int cluster, int threads,
                   cudaStream_t s) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config =
      cluster_config(n_levels, cluster, threads, stage_bytes(kNoise, threads), s, &attr);
  return cudaLaunchKernelEx(&config, quantize_kernel<kF8, kNoise>, table, noise, codes, scales,
                            lv);
}

// Allows the instance the largest noise stage (beyond 48 KB) on the current
// device, whatever this shape's, then asks how many of its clusters in this
// shape the device holds at once.
template <bool kF8, bool kNoise>
cudaError_t max_clusters(int n_levels, int cluster, int threads, int* out) {
  cudaError_t err = cudaFuncSetAttribute(quantize_kernel<kF8, kNoise>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(stage_bytes(kNoise, kMaxThreads)));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = cluster_config(n_levels, cluster, threads,
                                             stage_bytes(kNoise, threads), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, quantize_kernel<kF8, kNoise>, &config);
}

// The bf16 preparation: the f32 master table rounded to bfloat16, nearest
// even (cvt.rn.bf16x2.f32), as torch's cast rounds; a NaN stays a NaN, its
// payload outside the bit-equality. No level and no scale: every entry
// alone. Bound on this card: bytes, 4 read and 2 written an entry (169.1 MB
// and 84.6 MB at the 2^21 position table). A thread rounds 8 entries: two
// float4 loads, one 16-byte store; one thread per 8 entries, blocks of
// kRoundThreads. It computes what torch's cast computes, under a kernel name
// of the port's own, which a device trace can tell from the MLPs' casts.
constexpr int kRoundThreads = 256;

__device__ __forceinline__ unsigned int bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned int*>(&v);
}

__global__ void __launch_bounds__(kRoundThreads)
round_bf16_kernel(const float4* __restrict__ table, uint4* __restrict__ out, long long n8) {
  const long long i = static_cast<long long>(blockIdx.x) * kRoundThreads + threadIdx.x;
  if (i >= n8) return;
  const float4 a = __ldg(table + 2 * i), b = __ldg(table + 2 * i + 1);
  out[i] = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
}

}  // namespace

// table (n_rows, 2) f32 -> codes (n_rows, 2) int8 (f8 = 0) or e4m3 (f8 = 1)
// and scales (n_levels,) f32, on `stream`, in one launch of n_levels x
// cluster blocks of `threads` threads. noise (n_rows, 2) f32 or null (q8
// only). level_offset and slice_rows: each level's first row and its
// blocks' slice rows (ops/kernel_plan.py::quantize_plan), multiples of 8.
// Returns the cudaError_t of cudaLaunchKernelEx (0 on success), or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress without a launch.
extern "C" int quantize_tables(const void* table, const void* noise, void* codes, void* scales,
                               long long n_rows, int n_levels, const int* level_offset,
                               const int* slice_rows, int f8, int cluster, int threads,
                               void* stream) {
  if (!valid_shape(n_levels, cluster, threads)) return cudaErrorInvalidValue;
  if (n_rows <= 0 || n_rows % 8 != 0) return cudaErrorInvalidValue;
  if (f8 && noise != nullptr) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(noise) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 4 != 0) {
    return cudaErrorMisalignedAddress;
  }
  Levels lv;
  lv.offset[n_levels] = n_rows;
  for (int l = n_levels - 1; l >= 0; --l) {
    lv.offset[l] = level_offset[l];
    lv.slice[l] = slice_rows[l];
    const long long size = lv.offset[l + 1] - lv.offset[l];
    if (lv.offset[l] % 8 != 0 || size <= 0 || lv.slice[l] <= 0 || lv.slice[l] % 8 != 0 ||
        static_cast<long long>(lv.slice[l]) * cluster < size) {
      return cudaErrorInvalidValue;
    }
  }
  if (lv.offset[0] != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(table);
  const float4* u = static_cast<const float4*>(noise);
  unsigned int* c = static_cast<unsigned int*>(codes);
  float* sc = static_cast<float*>(scales);
  if (f8) return launch<true, false>(t, u, c, sc, lv, n_levels, cluster, threads, s);
  if (noise) return launch<false, true>(t, u, c, sc, lv, n_levels, cluster, threads, s);
  return launch<false, false>(t, u, c, sc, lv, n_levels, cluster, threads, s);
}

// How many clusters of the kernel's (f8, noise) instance in this shape the
// current device can hold at once (cudaOccupancyMaxActiveClusters) into
// *out: 0 means the launch cannot be scheduled. It first allows the instance
// its noise stage's dynamic shared memory on that device, which a launch of
// quantize_tables with noise at 512 threads (64 KB) needs: call it once per
// device and shape before launching. Returns a cudaError_t.
extern "C" int quantize_max_active_clusters(int f8, int noise, int n_levels, int cluster,
                                            int threads, int* out) {
  if (!valid_shape(n_levels, cluster, threads) || (f8 && noise)) return cudaErrorInvalidValue;
  if (f8) return max_clusters<true, false>(n_levels, cluster, threads, out);
  if (noise) return max_clusters<false, true>(n_levels, cluster, threads, out);
  return max_clusters<false, false>(n_levels, cluster, threads, out);
}

// One launch of an empty kernel in the same grid and cluster shape as
// quantize_tables: the fixed cost that K1p's time at a small table sits on.
// No path of the port calls it; the measurement scripts time it.
extern "C" int quantize_launch_floor(int n_levels, int cluster, int threads, void* stream) {
  if (!valid_shape(n_levels, cluster, threads)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = cluster_config(n_levels, cluster, threads, 0,
                                             static_cast<cudaStream_t>(stream), &attr);
  return cudaLaunchKernelEx(&config, empty_kernel);
}

// table (n_entries,) f32 -> out (n_entries,) bf16, each entry rounded to
// nearest even, on `stream`, in one launch of round_bf16_kernel. n_entries
// is a multiple of 8 (a table of 2 features has rows in multiples of 8 at
// every level); table and out are 16-byte aligned. Returns the cudaError_t of
// the launch (0 on success), or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress without a launch.
extern "C" int round_table_bf16(const void* table, void* out, long long n_entries,
                                void* stream) {
  if (n_entries <= 0 || n_entries % 8 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const long long n8 = n_entries / 8;
  const long long blocks = (n8 + kRoundThreads - 1) / kRoundThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(blocks), 1, 1);
  config.blockDim = dim3(kRoundThreads, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&config, round_bf16_kernel, static_cast<const float4*>(table),
                            static_cast<uint4*>(out), n8);
}
