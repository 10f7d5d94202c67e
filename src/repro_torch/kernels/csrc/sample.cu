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
// 50,000 x 10,000 X at 3.35 TB/s). The access pattern is the margin
// kernel's (csrc/hinge.cu `margin_partial_kernel`), and so is the design:
//  * the sample axis is contiguous, so one thread owns one column and a
//    warp's load of a row segment is one 128-byte line;
//  * the TPU carries the m-sum across its sequential grid; Hopper blocks
//    cannot, so m is split across blockIdx.y (several blocks per SM) and
//    each block writes two fp32 partial column sums (x.w1 and x.x) to
//    scratch; a second kernel sums the partials in a fixed order and
//    applies the finalizer. No float atomics: repeated calls give the same
//    bits;
//  * ragged edges are masked in the kernel, so nothing is padded;
//  * both mins propagate NaN (as jnp.minimum and torch.minimum do; CUDA's
//    fminf drops it), so a poisoned anchor gives a NaN surplus, which the
//    rule keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // columns per block, both kernels
constexpr float kBig = 1e30f;  // stands in for inf (kernels/screen.py _BIG)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// min that propagates NaN from either side (jnp.minimum, torch.minimum)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// max that propagates NaN from either side (jnp.maximum, torch.maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// part[s, j] = sum_{i in split s} X[i, j] w1[i];
// part[splits + s, j] = sum_{i in split s} X[i, j]^2
template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_partial_kernel(const T* __restrict__ X, const float* __restrict__ w,
                      int m, int n, int rows_per_split, int splits,
                      float* __restrict__ part) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, m);
  const size_t ld = static_cast<size_t>(n);
  const T* p = X + static_cast<size_t>(r0) * ld + j;
  float acc_u = 0.f, acc_s = 0.f;
  int i = r0;
  for (; i + 8 <= r1; i += 8, p += 8 * ld) {
    float x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = to_f32(p[r * ld]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc_u = fmaf(x[r], __ldg(w + i + r), acc_u);
      acc_s = fmaf(x[r], x[r], acc_s);
    }
  }
  for (; i < r1; ++i, p += ld) {
    const float x = to_f32(*p);
    acc_u = fmaf(x, __ldg(w + i), acc_u);
    acc_s = fmaf(x, x, acc_s);
  }
  part[static_cast<size_t>(blockIdx.y) * ld + j] = acc_u;
  part[static_cast<size_t>(splits + blockIdx.y) * ld + j] = acc_s;
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

// (surplus, u) for every sample column of X. Scratch: part is
// (2 * splits, n) fp32. scalars: the 12 packed fp32 values of
// kernels/screen.py pack_sample_scalars. u_prev is read only when
// scalars[5] (has_history) is set. Returns cudaGetLastError().
int screen_bounds_samples(const void* X, int x_bf16, const float* w1,
                          const float* y, const float* u_prev,
                          const float* scalars, int m, int n,
                          int rows_per_split, int splits, float* part,
                          float* u, float* surplus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(col_blocks, splits);
  if (x_bf16) {
    sample_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), w1, m, n, rows_per_split,
        splits, part);
  } else {
    sample_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(X), w1, m, n, rows_per_split, splits, part);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sample_finalize_kernel<<<col_blocks, kThreads, 0, s>>>(
      part, splits, n, y, u_prev, scalars, u, surplus);
  return cudaGetLastError();
}

}  // extern "C"
