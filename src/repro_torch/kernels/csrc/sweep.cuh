// Building blocks of the persistent sweeps over X for Hopper (sm_90a): the
// gradient sweep (hinge.cu `hinge_grad_bulk`) and the column sweep, which
// carries both the margin (hinge.cu `margin_partial_bulk`) and the sample
// surplus (sample.cu `sample_partial_bulk`).
//
// Every sweep here is a matrix-vector product or a column reduction: 0.5 to
// 1 flop per byte of X, against the card's ~20 fp32 flop/byte ridge, so HBM
// bytes bound it, and tensor cores and wgmma cannot help (a GEMV has no
// operand reuse for them to exploit). The only goal is to read X once at
// close to 3.35 TB/s. The design:
//  * persistent grid: a whole number of waves of the card's SMs (one block
//    per SM for the bulk variants); the tiling arithmetic is done in Python
//    (kernels/hinge.py `grad_plan`, `column_sweep_plan`), passed as plain
//    ints and mirrored here (`split_start`): every block gets the same
//    number of tiles, to within one;
//  * a block is one producer warp and kConsumers consumer threads. One
//    producer thread streams X into a ring of shared-memory stages
//    with cp.async.bulk copies; each stage completes on its `full` mbarrier
//    (transaction bytes). Consumers reduce from shared memory with 16-byte
//    reads and release the stage on its `empty` mbarrier, one arrival per
//    consumer warp. The ring keeps tens of KB in flight per SM (Little's
//    law: 3.35 TB/s x ~0.7 us is ~2.3 MB across 132 SMs, ~17 KB each);
//  * bulk copies need 16-byte aligned rows (fp32 n % 4 == 0, bf16
//    n % 8 == 0, an aligned base). Other inputs take each kernel's scalar
//    variant: the same walk, the same per-column order, direct loads;
//  * every sum is fp32 in an order fixed by the plan, never by timing: no
//    float atomics, so a repeated call gives the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace sweep {

constexpr int kConsumers = 256;  // consumer threads (8 warps); hinge.py SWEEP_CONSUMERS
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 8;              // ring depth at most (the plan picks)
constexpr int kMaxStageRows = 8;           // column sweep: tile rows a stage at most
constexpr int kBarrierBytes = 16 * kMaxStages;  // full[] + empty[]

// Start of run i when `total` items are cut into `parts` consecutive runs
// whose lengths differ by at most one (kernels/hinge.py split_start).
__host__ __device__ __forceinline__ int split_start(int i, int total, int parts) {
  const int q = total / parts, r = total % parts;
  return i * q + (i < r ? i : r);
}

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of X (4 fp32 or 8 bf16) as fp32 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const void* p, float* out) {
    const float4 v = *static_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const void* p, float* out) {
    const uint4 v = *static_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

// -- mbarriers and bulk copies (PTX) -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier over the consumer threads only (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Position in a ring of `stages` stages: the stage index and the parity of
// its current phase.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  int stages;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The ring's barriers live at the start of dynamic shared memory:
// full[s] completes when stage s holds its bytes (one producer arrival plus
// the transaction count); empty[s] when every consumer warp has released it.
struct Barriers {
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Barriers(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)), empty(full + kMaxStages) {}
  // thread 0 initializes; every thread of the block must call this
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kMaxStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  // producer: wait until stage r.stage is free, then expect `bytes` on it
  __device__ void acquire(const Ring& r, uint32_t bytes) {
    mbar_wait(&empty[r.stage], r.phase ^ 1u);  // passes at once on the first lap
    mbar_expect_tx(&full[r.stage], bytes);
  }
  // consumer: wait until stage r.stage holds its bytes
  __device__ void wait_full(const Ring& r) { mbar_wait(&full[r.stage], r.phase); }
  // consumer: every warp hands stage r.stage back once its lanes are done
  __device__ void release(const Ring& r) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[r.stage]);
  }
};

// -- the column sweep ----------------------------------------------------------
// X is cut into column segments of seg_cols columns and `slabs` row slabs;
// tile t is segment t / slabs, slab t % slabs (kernels/hinge.py
// ColumnSweepPlan). Each consumer thread carries accumulators for its
// columns down the tile's rows, in row order, and writes one partial per
// slab: the result does not depend on the grid.

// The column sweep's plan, as kernels/hinge.py column_sweep_plan makes it.
struct ColumnPlan {
  int m, n;
  int seg_cols;    // columns of a segment: at most kUnits * kConsumers * 16 bytes
  int slabs;
  int stage_rows;  // tile rows in one ring stage, <= kMaxStageRows
  int stages;      // ring depth, <= kMaxStages
};

struct ColumnTile {
  int r0, r1;    // rows [r0, r1)
  int c0, cols;  // columns [c0, c0 + cols)
  int slab;
};

__device__ __forceinline__ ColumnTile column_tile(int t, const ColumnPlan& p) {
  ColumnTile tl;
  const int c = t / p.slabs;
  tl.slab = t - c * p.slabs;
  tl.r0 = split_start(tl.slab, p.m, p.slabs);
  tl.r1 = split_start(tl.slab + 1, p.m, p.slabs);
  tl.c0 = c * p.seg_cols;
  tl.cols = min(p.seg_cols, p.n - tl.c0);
  return tl;
}

// Tiles [t0, t1) of this block.
__device__ __forceinline__ void block_tiles(const ColumnPlan& p, int* t0, int* t1) {
  const int tiles = ((p.n + p.seg_cols - 1) / p.seg_cols) * p.slabs;
  *t0 = split_start(blockIdx.x, tiles, gridDim.x);
  *t1 = split_start(blockIdx.x + 1, tiles, gridDim.x);
}

// Shared memory of the bulk column sweep: barriers, then `stages` stages of
// stage_rows rows of seg_cols items (kernels/hinge.py ColumnSweepPlan.smem_bytes).
__host__ __device__ __forceinline__ int column_smem_bytes(const ColumnPlan& p,
                                                          int item) {
  return kBarrierBytes + p.stages * p.stage_rows * p.seg_cols * item;
}

// 16-byte units of a bulk column sweep's segment row a consumer thread: 1,
// 2 or 4, the instantiations of each bulk column kernel (the plan keeps
// seg_cols * item <= 4 * 16 * kConsumers).
__host__ __forceinline__ int column_units(const ColumnPlan& p, int item) {
  return (p.seg_cols * item + 16 * kConsumers - 1) / (16 * kConsumers);
}

// Launch a bulk column-sweep kernel (kThreads a block) with the plan's ring
// in dynamic shared memory, which needs the attribute set first.
template <typename... Params, typename... Args>
cudaError_t launch_column_bulk(void (*kernel)(Params...), const ColumnPlan& p,
                               int item, int grid, cudaStream_t s, Args... args) {
  const int smem = column_smem_bytes(p, item);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// One bulk-variant column sweep. Consumer thread tid owns the 16-byte
// units tid + k * kConsumers (k < kUnits) of each segment row, that is the
// accumulator slots q = k * kN + e for the columns c0 + (tid + k *
// kConsumers) * kN + e. `Acc` holds kUnits * kN slots:
//   begin();  row(const float* x, int i);  store(int slab, int q, int col)
template <typename T, int kUnits, typename Acc>
__device__ __forceinline__ void column_sweep_bulk(const T* __restrict__ X,
                                                  const ColumnPlan& p, Acc& acc) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  Barriers bar(smem);
  bar.init();
  unsigned char* ring = smem + kBarrierBytes;
  const int row_bytes = p.seg_cols * static_cast<int>(sizeof(T));  // stride in a stage
  const int stage_bytes = p.stage_rows * row_bytes;
  int t0, t1;
  block_tiles(p, &t0, &t1);
  Ring r(p.stages);
  if (threadIdx.x >= kConsumers) {  // the producer warp; one thread issues
    if (threadIdx.x != kConsumers) return;
    for (int t = t0; t < t1; ++t) {
      const ColumnTile tl = column_tile(t, p);
      const uint32_t bytes = tl.cols * sizeof(T);
      for (int i = tl.r0; i < tl.r1; i += p.stage_rows, r.advance()) {
        const int rows = min(p.stage_rows, tl.r1 - i);
        bar.acquire(r, rows * bytes);
        unsigned char* dst = ring + r.stage * stage_bytes;
        const T* src = X + static_cast<size_t>(i) * p.n + tl.c0;
        for (int k = 0; k < rows; ++k)
          bulk_load(dst + k * row_bytes, src + static_cast<size_t>(k) * p.n, bytes,
                    &bar.full[r.stage]);
      }
    }
    return;
  }
  const int tid = threadIdx.x;
  for (int t = t0; t < t1; ++t) {
    const ColumnTile tl = column_tile(t, p);
    const int units = tl.cols / kN;  // rows are aligned: whole vectors
    acc.begin();
    for (int i = tl.r0; i < tl.r1; i += p.stage_rows, r.advance()) {
      const int rows = min(p.stage_rows, tl.r1 - i);
      const unsigned char* src = ring + r.stage * stage_bytes;
      bar.wait_full(r);
#pragma unroll
      for (int j = 0; j < kMaxStageRows; ++j) {
        if (j < rows) {
          float x[kUnits * kN];
#pragma unroll
          for (int k = 0; k < kUnits; ++k) {
            const int u = tid + k * kConsumers;
            if (u < units) {
              Vec<T>::load(src + j * row_bytes + u * 16, x + k * kN);
            } else {
#pragma unroll
              for (int e = 0; e < kN; ++e) x[k * kN + e] = 0.f;
            }
          }
          acc.row(x, i + j);
        }
      }
      bar.release(r);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = tid + k * kConsumers;
      if (u < units) {
#pragma unroll
        for (int e = 0; e < kN; ++e) acc.store(tl.slab, k * kN + e, tl.c0 + u * kN + e);
      }
    }
  }
}

// The scalar variant of the same walk (rows not 16-byte aligned;
// seg_cols <= kN * kConsumers): thread tid owns the columns
// c0 + tid + q * kConsumers (slot q < kN) and loads them directly.
template <typename T, typename Acc>
__device__ __forceinline__ void column_sweep_scalar(const T* __restrict__ X,
                                                    const ColumnPlan& p, Acc& acc) {
  constexpr int kN = Vec<T>::kN;
  const int tid = threadIdx.x;
  int t0, t1;
  block_tiles(p, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const ColumnTile tl = column_tile(t, p);
    acc.begin();
    for (int i = tl.r0; i < tl.r1; ++i) {
      const T* row = X + static_cast<size_t>(i) * p.n + tl.c0;
      float x[kN];
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const int j = tid + q * kConsumers;
        x[q] = j < tl.cols ? to_f32(row[j]) : 0.f;
      }
      acc.row(x, i);
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int j = tid + q * kConsumers;
      if (j < tl.cols) acc.store(tl.slab, q, tl.c0 + j);
    }
  }
}

// out[r, j] = sum over s of part[r * slabs + s, j], in slab order, for the
// kRows sums a column of a column sweep's (kRows * slabs, n) scratch: the
// partial modes' outputs (csrc/hinge.cu margin_partial, csrc/sample.cu
// sample_partial), summed exactly as their finalizers sum the slabs. One
// thread a column, 256 a block. flag (nullable): a launch whose *flag is 0
// returns at once (the margin's predicated launches).
template <int kRows>
__global__ void __launch_bounds__(256)
slab_sum_kernel(const float* __restrict__ part, int slabs, int n,
                float* __restrict__ out, const int* flag) {
  if (flag != nullptr && *flag == 0) return;
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s)
      acc += part[static_cast<size_t>(r * slabs + s) * n + j];
    out[static_cast<size_t>(r) * n + j] = acc;
  }
}

}  // namespace sweep
