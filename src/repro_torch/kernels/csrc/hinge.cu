// Squared-hinge FISTA sweeps for Hopper (sm_90a): the margin sweep
// (u = X^T w, xi = max(0, 1 - y(u + b)), loss = 1/2 sum xi^2) and the
// gradient sweep (g = -X (y * xi)). X is (m, n) row-major, features x
// samples, fp32 or bf16; every sum is taken in fp32.
//
// Replaces: src/repro/kernels/hinge.py `_margin_kernel` (entry
// `hinge_margin_pallas`) and `_grad_kernel` (entry `hinge_grad_pallas`).
//
// Bound on this card: each call reads X once (m * n * sizeof(X) bytes) and
// does 2 m n flops, ~0.5 flop per byte of fp32 X, far below the H100's
// ~20 fp32 flop/byte ridge. Both kernels are HBM-bound: at 3.35 TB/s an
// fp32 50,000 x 10,000 X takes 0.60 ms. Tensor cores and wgmma cannot help
// a matrix-vector product (no operand reuse). Both sweeps are persistent
// grids fed by a cp.async.bulk ring (csrc/sweep.cuh):
//  * margin: the column sweep of csrc/sweep.cuh, as for the sample surplus
//    (csrc/sample.cu) but with one accumulator, x.w. The TPU carries the
//    m-sum across its sequential grid, which Hopper blocks cannot do: the
//    live rows are cut into slabs and the columns into segments of up to
//    4 x 16 bytes a consumer thread (kernels/hinge.py `column_sweep_plan`
//    over valid_m rows: at 50,000 x 10,000 fp32, 3 segments of 3,360
//    columns x 44 slabs, one tile a block). One producer thread streams
//    each tile's row segments into a 4-stage ring; each consumer thread
//    carries its columns' sums down the slab in row order and writes one
//    fp32 partial a slab. A second kernel sums the slabs in order and forms
//    u and xi and per-block loss partials, which a one-block third kernel
//    sums. Every sum has a fixed order and there are no float atomics, so
//    repeated calls give bitwise-equal results (the solver's stop rule ties
//    on fp32 plateaus);
//  * gradient: one block per SM, each owning a run of consecutive live rows
//    (kernels/hinge.py `grad_plan`: runs differ by at most one row). The
//    block stages v = y * xi in shared memory once (up to 16,384 columns;
//    wider rows are cut into column chunks, v restaged per chunk). One
//    producer thread streams every row, in pieces of at most 32 KB, into a
//    ring of stages by cp.async.bulk; the 8 consumer warps together own the
//    row: each thread takes 16-byte units of the piece in a fixed order
//    against v from shared memory, then a fixed shuffle tree and a fixed
//    sum over the warps give the row's dot product. Rows >= valid_m are
//    written as 0 and never read;
//  * rows whose start is not 16-byte aligned take each sweep's scalar
//    variant (`margin_partial_scalar`, `hinge_grad_scalar`): the same walk
//    and sum order, direct loads;
//  * neither sweep reads a row >= valid_m (the gathered buffer's zero
//    padding is skipped; valid_m = 0 reads nothing and gives u = 0), and
//    ragged edges are masked in the kernels, so no padding or loss
//    correction is needed.
//
// Partial mode (a sharded run, core/distributed.py): `margin_partial` stops
// before the finalize and writes u_part = X_blk^T w_blk (the slabs summed in
// slab order by sweep::slab_sum_kernel, no bias, no xi, no loss); after the
// all-reduce over the feature axis, `margin_finalize` runs the finalize below
// on the reduced u with one slab, then the loss sum. The slab sum is the
// finalize's own sum, and 0 + u = u, so on an unsplit X the two calls give
// the bits of `margin_obj`. `margin_obj` itself is unchanged.
//
// Predicated launches: both entry points take an optional device pointer to
// an int flag. Every block of every kernel of the launch reads it first and
// returns at once when it is 0, so the launch reads no X and writes no
// output (the caller discards them); the first block of the first kernel
// then adds one to *skipped. The on-device FISTA loop (core/solver.py
// `fista_run`) predicates the monotone restart's two sweeps on "a restart
// fired" and every sweep on "the solve has not stopped", as the
// reference's lax.cond keeps the restart's sweeps conditional. A null flag
// is the unpredicated launch of the host engine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "sweep.cuh"

namespace {

constexpr int kFinThreads = 256;  // columns per finalize block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max(0, t) that propagates NaN, as jnp.maximum / torch.clamp_min do.
__device__ __forceinline__ float relu_nan(float t) {
  return (t > 0.f || t != t) ? t : 0.f;
}

// True when a predicated launch is switched off (*flag == 0): the block
// returns before any work. Counted once a launch, by block 0 of its first
// kernel (count = true).
__device__ __forceinline__ bool skip_launch(const int* flag, int* skipped,
                                            bool count) {
  if (flag == nullptr || *flag != 0) return false;
  if (count && skipped != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(skipped, 1);
  return true;
}

// Deterministic tree sum of one value per thread of a kFinThreads block.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kFinThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// One consumer thread's sums for kSlots columns down a slab:
// part[s, j] = sum_{i in slab s} X[i, j] w[i]
template <int kSlots>
struct MarginAcc {
  const float* __restrict__ w;
  float* __restrict__ part;
  int n;
  float u[kSlots];

  __device__ void begin() {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) u[q] = 0.f;
  }
  __device__ void row(const float* x, int i) {
    const float wi = __ldg(w + i);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) u[q] = fmaf(x[q], wi, u[q]);
  }
  __device__ void store(int slab, int q, int col) {
    part[static_cast<size_t>(slab) * n + col] = u[q];
  }
};

template <typename T, int kUnits>
__global__ void __launch_bounds__(sweep::kThreads, 1)
margin_partial_bulk(const T* __restrict__ X, const float* __restrict__ w,
                    const sweep::ColumnPlan p, float* __restrict__ part,
                    const int* flag, int* skipped) {
  if (skip_launch(flag, skipped, true)) return;
  MarginAcc<kUnits * sweep::Vec<T>::kN> acc{w, part, p.n};
  sweep::column_sweep_bulk<T, kUnits>(X, p, acc);
}

template <typename T>
__global__ void __launch_bounds__(sweep::kConsumers)
margin_partial_scalar(const T* __restrict__ X, const float* __restrict__ w,
                      const sweep::ColumnPlan p, float* __restrict__ part,
                      const int* flag, int* skipped) {
  if (skip_launch(flag, skipped, true)) return;
  MarginAcc<sweep::Vec<T>::kN> acc{w, part, p.n};
  sweep::column_sweep_scalar(X, p, acc);
}

template <typename T>
cudaError_t launch_margin_partial(const void* X, const float* w,
                                  const sweep::ColumnPlan& p, int bulk,
                                  int grid, float* part, const int* flag,
                                  int* skipped, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  if (!bulk) {
    margin_partial_scalar<T><<<grid, sweep::kConsumers, 0, s>>>(x, w, p, part,
                                                                flag, skipped);
    return cudaGetLastError();
  }
  const int units = sweep::column_units(p, sizeof(T));
  if (units > 4) return cudaErrorInvalidValue;
  return sweep::launch_column_bulk(units == 1   ? margin_partial_bulk<T, 1>
                                   : units == 2 ? margin_partial_bulk<T, 2>
                                                : margin_partial_bulk<T, 4>,
                                   p, sizeof(T), grid, s, x, w, p, part,
                                   flag, skipped);
}

// u = the slabs' partials summed in slab order, xi = max(0, 1 - y (u + b)),
// loss partial per block
__global__ void __launch_bounds__(kFinThreads)
margin_finalize_kernel(const float* __restrict__ part, int slabs, int n,
                       const float* __restrict__ y,
                       const float* __restrict__ b, float* __restrict__ u,
                       float* __restrict__ xi, float* __restrict__ loss_part,
                       const int* flag) {
  if (skip_launch(flag, nullptr, false)) return;
  __shared__ float red[kFinThreads];
  const int j = blockIdx.x * kFinThreads + threadIdx.x;
  float sq = 0.f;
  if (j < n) {
    float acc = 0.f;
    for (int s = 0; s < slabs; ++s) acc += part[static_cast<size_t>(s) * n + j];
    const float x = relu_nan(1.f - y[j] * (acc + *b));
    u[j] = acc;
    xi[j] = x;
    sq = x * x;
  }
  const float total = block_sum(sq, red);
  if (threadIdx.x == 0) loss_part[blockIdx.x] = total;
}

// loss = 1/2 sum of the block partials, in a fixed order (one block)
__global__ void __launch_bounds__(kFinThreads)
loss_sum_kernel(const float* __restrict__ loss_part, int count,
                float* __restrict__ loss, const int* flag) {
  if (skip_launch(flag, nullptr, false)) return;
  __shared__ float red[kFinThreads];
  float acc = 0.f;
  for (int k = threadIdx.x; k < count; k += kFinThreads) acc += loss_part[k];
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) *loss = 0.5f * total;
}

// Shared memory of the bulk gradient: barriers, the warps' row sums (two
// rows' worth), v for one column chunk, then the ring.
struct GradSmem {
  int red, v, ring, stage_bytes, total;
  __host__ __device__ GradSmem(int chunk_cols, int piece_cols, int stages,
                               int item) {
    red = sweep::kBarrierBytes;
    v = red + 2 * sweep::kConsumerWarps * 4;
    ring = sweep::round_up(v + chunk_cols * 4, 128);
    stage_bytes = sweep::round_up(piece_cols * item, 128);
    total = ring + stages * stage_bytes;
  }
};

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// g[i] = 0 for valid_m <= i < m, spread over the whole grid
__device__ __forceinline__ void zero_tail(float* g, int m, int valid_m) {
  for (int i = valid_m + blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x)
    g[i] = 0.f;
}

// v[j] = y[j] xi[j] for the chunk's columns, by the consumer threads
__device__ __forceinline__ void stage_v(float* vs, const float* __restrict__ y,
                                        const float* __restrict__ xi, int c0,
                                        int cols, int tid, int stride) {
  for (int j = tid; j < cols; j += stride) vs[j] = y[c0 + j] * xi[c0 + j];
}

// g[i] = -sum_j X[i, j] y[j] xi[j] for i < valid_m; 0 for valid_m <= i < m.
// Rows of block b: [split_start(b, valid_m, grid), split_start(b + 1, ...)).
template <typename T>
__global__ void __launch_bounds__(sweep::kThreads, 1)
hinge_grad_bulk(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ xi, int m, int n, int valid_m,
                int chunk_cols, int piece_cols, int stages,
                float* __restrict__ g, const int* flag, int* skipped) {
  if (skip_launch(flag, skipped, true)) return;
  using namespace sweep;
  extern __shared__ __align__(128) unsigned char smem[];
  const GradSmem lay(chunk_cols, piece_cols, stages, sizeof(T));
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  unsigned char* ring = smem + lay.ring;
  zero_tail(g, m, valid_m);
  Barriers bar(smem);
  bar.init();
  const int row0 = split_start(blockIdx.x, valid_m, gridDim.x);
  const int row1 = split_start(blockIdx.x + 1, valid_m, gridDim.x);
  Ring r(stages);
  if (threadIdx.x >= kConsumers) {  // the producer warp; one thread issues
    if (threadIdx.x != kConsumers) return;
    for (int c0 = 0; c0 < n; c0 += chunk_cols) {
      const int cols = min(chunk_cols, n - c0);
      for (int i = row0; i < row1; ++i) {
        const T* row = X + static_cast<size_t>(i) * n + c0;
        for (int p = 0; p < cols; p += piece_cols, r.advance()) {
          const uint32_t bytes = min(piece_cols, cols - p) * sizeof(T);
          bar.acquire(r, bytes);
          bulk_load(ring + r.stage * lay.stage_bytes, row + p, bytes,
                    &bar.full[r.stage]);
        }
      }
    }
    return;
  }
  constexpr int kN = Vec<T>::kN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int c0 = 0; c0 < n; c0 += chunk_cols) {
    const int cols = min(chunk_cols, n - c0);
    consumers_sync();  // every warp is done with the previous chunk's v
    stage_v(vs, y, xi, c0, cols, tid, kConsumers);
    consumers_sync();
    for (int i = row0; i < row1; ++i) {
      float acc[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k] = 0.f;
      for (int p = 0; p < cols; p += piece_cols, r.advance()) {
        const int units = min(piece_cols, cols - p) / kN;  // whole vectors
        const unsigned char* src = ring + r.stage * lay.stage_bytes;
        const float* v = vs + p;
        bar.wait_full(r);
        for (int q = tid; q < units; q += kConsumers) {
          float x[kN];
          Vec<T>::load(src + q * 16, x);
#pragma unroll
          for (int k = 0; k < kN; k += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(v + q * kN + k);
            acc[k] = fmaf(x[k], vv.x, acc[k]);
            acc[k + 1] = fmaf(x[k + 1], vv.y, acc[k + 1]);
            acc[k + 2] = fmaf(x[k + 2], vv.z, acc[k + 2]);
            acc[k + 3] = fmaf(x[k + 3], vv.w, acc[k + 3]);
          }
        }
        bar.release(r);
      }
#pragma unroll
      for (int w = kN / 2; w > 0; w >>= 1) {
#pragma unroll
        for (int k = 0; k < w; ++k) acc[k] += acc[k + w];
      }
      const float total = warp_sum(acc[0]);
      float* slot = red + ((i - row0) & 1) * kConsumerWarps;  // two rows' slots
      if (lane == 0) slot[warp] = total;
      consumers_sync();
      if (tid == 0) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kConsumerWarps; ++k) sum += slot[k];
        g[i] = c0 == 0 ? -sum : g[i] - sum;
      }
    }
  }
}

// The scalar variant (rows not 16-byte aligned): the same rows per block;
// warp w of the block owns rows row0 + w, row0 + w + 8, ...; v is staged in
// shared memory per column chunk; lane l reads columns l, l + 32, ... of the
// chunk into four accumulators in a fixed order.
template <typename T>
__global__ void __launch_bounds__(sweep::kConsumers)
hinge_grad_scalar(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ xi, int m, int n, int valid_m,
                  int chunk_cols, float* __restrict__ g, const int* flag,
                  int* skipped) {
  if (skip_launch(flag, skipped, true)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem);
  zero_tail(g, m, valid_m);
  const int row0 = sweep::split_start(blockIdx.x, valid_m, gridDim.x);
  const int row1 = sweep::split_start(blockIdx.x + 1, valid_m, gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < n; c0 += chunk_cols) {
    const int cols = min(chunk_cols, n - c0);
    __syncthreads();
    stage_v(vs, y, xi, c0, cols, threadIdx.x, sweep::kConsumers);
    __syncthreads();
    for (int i = row0 + warp; i < row1; i += sweep::kConsumerWarps) {
      const T* p = X + static_cast<size_t>(i) * n + c0;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int j = lane;
      for (; j + 96 < cols; j += 128) {
        a0 = fmaf(to_f32(p[j]), vs[j], a0);
        a1 = fmaf(to_f32(p[j + 32]), vs[j + 32], a1);
        a2 = fmaf(to_f32(p[j + 64]), vs[j + 64], a2);
        a3 = fmaf(to_f32(p[j + 96]), vs[j + 96], a3);
      }
      for (; j < cols; j += 32) a0 = fmaf(to_f32(p[j]), vs[j], a0);
      const float sum = warp_sum((a0 + a1) + (a2 + a3));
      if (lane == 0) g[i] = c0 == 0 ? -sum : g[i] - sum;
    }
  }
}

template <typename T>
cudaError_t launch_grad(const void* X, const float* y, const float* xi, int m,
                        int n, int valid_m, int bulk, int grid, int chunk_cols,
                        int piece_cols, int stages, float* g, const int* flag,
                        int* skipped, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  if (!bulk) {
    const int smem = chunk_cols * 4;
    cudaError_t err = cudaFuncSetAttribute(
        hinge_grad_scalar<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    hinge_grad_scalar<T><<<grid, sweep::kConsumers, smem, s>>>(
        x, y, xi, m, n, valid_m, chunk_cols, g, flag, skipped);
    return cudaGetLastError();
  }
  const int smem = GradSmem(chunk_cols, piece_cols, stages, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      hinge_grad_bulk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  hinge_grad_bulk<T><<<grid, sweep::kThreads, smem, s>>>(
      x, y, xi, m, n, valid_m, chunk_cols, piece_cols, stages, g, flag,
      skipped);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (u, xi, loss) from one read of X's first valid_m rows. The walk is the
// plan of kernels/hinge.py `column_sweep_plan` over the valid_m live rows
// (bulk, grid, seg_cols, slabs, stage_rows, stages). Scratch: part is
// (slabs, n), loss_part is (ceil(n / 256),). flag (nullable): the launch's
// predicate, a device int; skipped (nullable): a device int counting the
// launches it switched off. Returns cudaGetLastError().
int margin_obj(const void* X, int x_bf16, const float* w, const float* y,
               const float* b, int n, int valid_m, int bulk, int grid,
               int seg_cols, int slabs, int stage_rows, int stages,
               float* part, float* u, float* xi, float* loss_part,
               float* loss, const int* flag, int* skipped, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sweep::ColumnPlan p{valid_m, n, seg_cols, slabs, stage_rows, stages};
  err = x_bf16 ? launch_margin_partial<__nv_bfloat16>(X, w, p, bulk, grid, part,
                                                      flag, skipped, s)
               : launch_margin_partial<float>(X, w, p, bulk, grid, part, flag,
                                              skipped, s);
  if (err != cudaSuccess) return err;
  const int fin_blocks = (n + kFinThreads - 1) / kFinThreads;
  margin_finalize_kernel<<<fin_blocks, kFinThreads, 0, s>>>(
      part, slabs, n, y, b, u, xi, loss_part, flag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  loss_sum_kernel<<<1, kFinThreads, 0, s>>>(loss_part, fin_blocks, loss, flag);
  return cudaGetLastError();
}

// Partial mode of margin_obj: u_part = X^T w over the first valid_m rows
// (no bias), from the same sweep and the same slab sum as margin_obj's
// finalize. part: (slabs, n) scratch; u_part: (n,). flag, skipped: as for
// margin_obj. Returns cudaGetLastError().
int margin_partial(const void* X, int x_bf16, const float* w, int n,
                   int valid_m, int bulk, int grid, int seg_cols, int slabs,
                   int stage_rows, int stages, float* part, float* u_part,
                   const int* flag, int* skipped, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sweep::ColumnPlan p{valid_m, n, seg_cols, slabs, stage_rows, stages};
  err = x_bf16 ? launch_margin_partial<__nv_bfloat16>(X, w, p, bulk, grid, part,
                                                      flag, skipped, s)
               : launch_margin_partial<float>(X, w, p, bulk, grid, part, flag,
                                              skipped, s);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kFinThreads - 1) / kFinThreads;
  sweep::slab_sum_kernel<1><<<blocks, kFinThreads, 0, s>>>(part, slabs, n,
                                                           u_part, flag);
  return cudaGetLastError();
}

// The finalize of margin_obj on all-reduced margins u_red (n,): u = u_red,
// xi = max(0, 1 - y (u + b)), loss = 1/2 sum xi^2. loss_part: (ceil(n / 256),)
// scratch. flag: as for margin_obj (a switched-off launch is counted by the
// sweep's launch, not here). Returns cudaGetLastError().
int margin_finalize(const float* u_red, const float* y, const float* b, int n,
                    float* u, float* xi, float* loss_part, float* loss,
                    const int* flag, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fin_blocks = (n + kFinThreads - 1) / kFinThreads;
  margin_finalize_kernel<<<fin_blocks, kFinThreads, 0, s>>>(
      u_red, 1, n, y, b, u, xi, loss_part, flag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  loss_sum_kernel<<<1, kFinThreads, 0, s>>>(loss_part, fin_blocks, loss, flag);
  return cudaGetLastError();
}

// g = -X (y * xi) over rows < valid_m, zeros below. The walk is the plan of
// kernels/hinge.py `grad_plan` (bulk, grid, chunk_cols, piece_cols,
// stages <= sweep::kMaxStages). flag, skipped: as for margin_obj. Returns
// cudaGetLastError().
int hinge_grad(const void* X, int x_bf16, const float* y, const float* xi,
               int m, int n, int valid_m, int bulk, int grid, int chunk_cols,
               int piece_cols, int stages, float* g, const int* flag,
               int* skipped, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_grad<__nv_bfloat16>(X, y, xi, m, n, valid_m, bulk,
                                             grid, chunk_cols, piece_cols,
                                             stages, g, flag, skipped, s)
                : launch_grad<float>(X, y, xi, m, n, valid_m, bulk, grid,
                                     chunk_cols, piece_cols, stages, g, flag,
                                     skipped, s);
}

}  // extern "C"
