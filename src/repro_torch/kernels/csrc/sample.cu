// Sample-axis margin surplus for Hopper (sm_90a): per sample column x_i of
// X, the two feature-axis reductions
//   u_i = x_i . w1 + b1,   s_i = ||x_i||^2
// from one transposed read of X, then the slack finalizer of
// src/repro_torch/kernels/screen.py `sample_surplus_plain`:
//   slack_i   = min(sqrt(s_i) dw + db, has_hist ? shrink |u_i - u_prev_i| + floor : 1e30)
//   surplus_i = y_i u_i - 1 - min(slack_i, 1e30)
// Both u and the surplus are written; the sample rule keeps u as the next
// step's secant anchor. X is (m, n) row-major, features x samples, fp32 or
// bf16; every sum is fp32.
//
// Replaces: src/repro/kernels/screen.py `_sample_kernel` (entry
// `screen_bounds_pallas(axis="samples")`, wrapper kernels/ops.py
// `sample_surplus_op`, finalizer `_sample_surplus_from_acc`).
//
// Bound on this card: one read of X (m * n * sizeof(X) bytes) and 4 m n
// flops, ~1 flop per byte of fp32 X: HBM-bound (0.60 ms for an fp32
// 50,000 x 10,000 X at 3.35 TB/s). Tensor cores and wgmma cannot help a
// column reduction (no operand reuse). The design (csrc/sweep.cuh):
//  * the TPU carries the m-sum across its sequential grid; Hopper blocks
//    cannot. X is cut into tiles of a row slab x a column segment of up to
//    4 x 16 bytes a consumer thread (3,360 fp32 columns, 13 KB a row, at
//    n = 10,000); a persistent grid of one block per SM walks them
//    (kernels/hinge.py `column_sweep_plan` makes the tile count a multiple
//    of the grid: one tile a block at 50,000 x 10,000);
//  * one producer thread streams each tile's row segments into a 4-stage
//    shared-memory ring by cp.async.bulk (one copy a segment row, up to
//    48 KB a stage); each consumer thread carries the two accumulators x.w1
//    and x.x for its columns down the slab in row order, reading 16 bytes
//    of shared memory a unit. On an H100 13 KB segments ran 7% faster
//    than 4 KB ones (fewer, longer copies; scripts/torch_sweep_tune.py);
//  * each slab writes two fp32 partial column sums (x.w1, x.x) to scratch;
//    a second kernel sums the slabs in a fixed order and applies the
//    finalizer. No float atomics: repeated calls give the same bits;
//  * rows that are not 16-byte aligned (fp32 n % 4 != 0, bf16 n % 8 != 0,
//    an offset view) take `sample_partial_scalar`, the same walk with
//    direct loads; ragged edges are masked in the kernel, nothing is padded;
//  * partial mode (a sharded run, core/distributed.py): `sample_partial`
//    stops before the finalizer and writes the two column sums [x.w1, x.x]
//    as a (2, n) pair (no b1), the slabs summed in slab order
//    (sweep::slab_sum_kernel, the finalizer's own sum); after the all-reduce
//    over the feature axis, `sample_finalize` runs the finalizer on the
//    reduced pair with one split. On an unsplit X the two calls give the
//    bits of `screen_bounds_samples`, which is unchanged;
//  * both mins propagate NaN (as jnp.minimum and torch.minimum do; CUDA's
//    fminf drops it), so a poisoned anchor gives a NaN surplus, which the
//    rule keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;  // columns per finalize block
constexpr float kBig = 1e30f;  // stands in for inf (kernels/screen.py _BIG)

// min that propagates NaN from either side (jnp.minimum, torch.minimum)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// max that propagates NaN from either side (jnp.maximum, torch.maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// One consumer thread's sums for kSlots columns down a slab:
// part[s, j] = sum_{i in slab s} X[i, j] w1[i];
// part[slabs + s, j] = sum_{i in slab s} X[i, j]^2
template <int kSlots>
struct SurplusAcc {
  const float* __restrict__ w;
  float* __restrict__ part;
  int n, slabs;
  float u[kSlots], s[kSlots];

  __device__ void begin() {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) u[q] = s[q] = 0.f;
  }
  __device__ void row(const float* x, int i) {
    const float wi = __ldg(w + i);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      u[q] = fmaf(x[q], wi, u[q]);
      s[q] = fmaf(x[q], x[q], s[q]);
    }
  }
  __device__ void store(int slab, int q, int col) {
    part[static_cast<size_t>(slab) * n + col] = u[q];
    part[static_cast<size_t>(slabs + slab) * n + col] = s[q];
  }
};

template <typename T, int kUnits>
__global__ void __launch_bounds__(sweep::kThreads, 1)
sample_partial_bulk(const T* __restrict__ X, const float* __restrict__ w,
                    const sweep::ColumnPlan p, float* __restrict__ part) {
  SurplusAcc<kUnits * sweep::Vec<T>::kN> acc{w, part, p.n, p.slabs};
  sweep::column_sweep_bulk<T, kUnits>(X, p, acc);
}

template <typename T>
__global__ void __launch_bounds__(sweep::kConsumers)
sample_partial_scalar(const T* __restrict__ X, const float* __restrict__ w,
                      const sweep::ColumnPlan p, float* __restrict__ part) {
  SurplusAcc<sweep::Vec<T>::kN> acc{w, part, p.n, p.slabs};
  sweep::column_sweep_scalar(X, p, acc);
}

template <typename T>
cudaError_t launch_partial(const void* X, const float* w1,
                           const sweep::ColumnPlan& p, int bulk, int grid,
                           float* part, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  if (!bulk) {
    sample_partial_scalar<T><<<grid, sweep::kConsumers, 0, s>>>(x, w1, p, part);
    return cudaGetLastError();
  }
  const int units = sweep::column_units(p, sizeof(T));
  if (units > 4) return cudaErrorInvalidValue;
  return sweep::launch_column_bulk(units == 1   ? sample_partial_bulk<T, 1>
                                   : units == 2 ? sample_partial_bulk<T, 2>
                                                : sample_partial_bulk<T, 4>,
                                   p, sizeof(T), grid, s, x, w1, p, part);
}

// u = sum of the x.w1 partials + b1; surplus from u, ||x||^2, y, u_prev.
// scalars (kernels/screen.py pack_sample_scalars):
//   [b1, dw, db, shrink, floor, has_history, 0...], dw and db <= 1e30.
__global__ void __launch_bounds__(kThreads)
sample_finalize_kernel(const float* __restrict__ part, int splits, int n,
                       const float* __restrict__ y,
                       const float* __restrict__ u_prev,
                       const float* __restrict__ sc, float* __restrict__ u_out,
                       float* __restrict__ surplus) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const size_t ld = static_cast<size_t>(n);
  float acc_u = 0.f, acc_s = 0.f;
  for (int s = 0; s < splits; ++s) {
    acc_u += part[static_cast<size_t>(s) * ld + j];
    acc_s += part[static_cast<size_t>(splits + s) * ld + j];
  }
  const float b1 = sc[0], dw = sc[1], db = sc[2];
  const float shrink = sc[3], floor_ = sc[4];
  const bool has_hist = sc[5] > 0.5f;
  const float u = acc_u + b1;
  const float slack_tr = sqrtf(nmax(acc_s, 0.f)) * dw + db;
  const float secant = has_hist ? shrink * fabsf(u - u_prev[j]) + floor_ : kBig;
  const float slack = nmin(nmin(slack_tr, secant), kBig);
  u_out[j] = u;
  surplus[j] = y[j] * u - 1.f - slack;
}

}  // namespace

extern "C" {

// (surplus, u) for every sample column of X. The walk is the plan of
// kernels/hinge.py `column_sweep_plan` (bulk, grid, seg_cols, slabs,
// stage_rows, stages). Scratch: part is (2 * slabs, n) fp32. scalars: the
// 12 packed fp32 values of kernels/screen.py pack_sample_scalars. u_prev is
// read only when scalars[5] (has_history) is set. Returns
// cudaGetLastError().
int screen_bounds_samples(const void* X, int x_bf16, const float* w1,
                          const float* y, const float* u_prev,
                          const float* scalars, int m, int n, int bulk,
                          int grid, int seg_cols, int slabs, int stage_rows,
                          int stages, float* part, float* u, float* surplus,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sweep::ColumnPlan p{m, n, seg_cols, slabs, stage_rows, stages};
  err = x_bf16 ? launch_partial<__nv_bfloat16>(X, w1, p, bulk, grid, part, s)
               : launch_partial<float>(X, w1, p, bulk, grid, part, s);
  if (err != cudaSuccess) return err;
  const int col_blocks = (n + kThreads - 1) / kThreads;
  sample_finalize_kernel<<<col_blocks, kThreads, 0, s>>>(
      part, slabs, n, y, u_prev, scalars, u, surplus);
  return cudaGetLastError();
}

// Partial mode of screen_bounds_samples: sums (2, n) = [X^T w1, column
// sums of X * X] from the same sweep and slab sum. part: (2 * slabs, n)
// scratch. Returns cudaGetLastError().
int sample_partial(const void* X, int x_bf16, const float* w1, int m, int n,
                   int bulk, int grid, int seg_cols, int slabs, int stage_rows,
                   int stages, float* part, float* sums, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sweep::ColumnPlan p{m, n, seg_cols, slabs, stage_rows, stages};
  err = x_bf16 ? launch_partial<__nv_bfloat16>(X, w1, p, bulk, grid, part, s)
               : launch_partial<float>(X, w1, p, bulk, grid, part, s);
  if (err != cudaSuccess) return err;
  const int col_blocks = (n + kThreads - 1) / kThreads;
  sweep::slab_sum_kernel<2><<<col_blocks, kThreads, 0, s>>>(part, slabs, n,
                                                            sums, nullptr);
  return cudaGetLastError();
}

// The finalizer of screen_bounds_samples on an all-reduced (2, n) pair
// (one split): u = sums[0] + b1 and the surplus. scalars, u_prev: as for
// screen_bounds_samples. Returns cudaGetLastError().
int sample_finalize(const float* sums, int n, const float* y,
                    const float* u_prev, const float* scalars, float* u,
                    float* surplus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kThreads - 1) / kThreads;
  sample_finalize_kernel<<<col_blocks, kThreads, 0, s>>>(
      sums, 1, n, y, u_prev, scalars, u, surplus);
  return cudaGetLastError();
}

}  // extern "C"
