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
// fp32 50,000 x 10,000 X takes 0.60 ms. Design against that bound:
//  * both sweeps read X along n, the contiguous axis: neighbouring threads
//    read neighbouring addresses, so a warp's load is one 128-byte line;
//  * margin: the TPU carries the m-sum across its sequential grid, which
//    Hopper blocks cannot do. m is split across blockIdx.y so that there
//    are several blocks per SM (40 column tiles alone would leave most of
//    the 132 SMs idle); each block writes an fp32 partial column sum to
//    scratch and a second kernel sums the partials, forms u and xi, and
//    writes per-block loss partials that a one-block third kernel sums.
//    Every sum has a fixed order and there are no float atomics, so
//    repeated calls give bitwise-equal results (the solver's stop rule
//    ties on fp32 plateaus);
//  * gradient: one warp per 4 rows; each lane reads y*xi once per column
//    and reuses it for the 4 rows (4 independent loads in flight), then a
//    shuffle reduction. Rows >= valid_m are written as 0 and never read;
//  * the margin sweep reads only rows < valid_m (the gathered buffer's
//    zero padding is skipped), and ragged edges are masked in the kernel,
//    so no padding or loss correction is needed.
// TMA, wgmma and persistent blocks are later work; these kernels are the
// simple, correct first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMarginThreads = 256;  // columns per margin block
constexpr int kFinThreads = 256;     // columns per finalize block
constexpr int kGradThreads = 256;    // 8 warps per gradient block
constexpr int kRowsPerWarp = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max(0, t) that propagates NaN, as jnp.maximum / torch.clamp_min do.
__device__ __forceinline__ float relu_nan(float t) {
  return (t > 0.f || t != t) ? t : 0.f;
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

// part[s, j] = sum_{i in split s, i < valid_m} X[i, j] w[i]
template <typename T>
__global__ void __launch_bounds__(kMarginThreads)
margin_partial_kernel(const T* __restrict__ X, const float* __restrict__ w,
                      int n, int valid_m, int rows_per_split,
                      float* __restrict__ part) {
  const int j = blockIdx.x * kMarginThreads + threadIdx.x;
  if (j >= n) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, valid_m);
  const size_t ld = static_cast<size_t>(n);
  const T* p = X + static_cast<size_t>(r0) * ld + j;
  float acc = 0.f;
  int i = r0;
  for (; i + 8 <= r1; i += 8, p += 8 * ld) {
    float x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = to_f32(p[r * ld]);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc = fmaf(x[r], __ldg(w + i + r), acc);
  }
  for (; i < r1; ++i, p += ld) acc = fmaf(to_f32(*p), __ldg(w + i), acc);
  part[static_cast<size_t>(blockIdx.y) * ld + j] = acc;
}

// u = sum of the partials, xi = max(0, 1 - y (u + b)), loss partial per block
__global__ void __launch_bounds__(kFinThreads)
margin_finalize_kernel(const float* __restrict__ part, int splits, int n,
                       const float* __restrict__ y,
                       const float* __restrict__ b, float* __restrict__ u,
                       float* __restrict__ xi, float* __restrict__ loss_part) {
  __shared__ float red[kFinThreads];
  const int j = blockIdx.x * kFinThreads + threadIdx.x;
  float sq = 0.f;
  if (j < n) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * n + j];
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
                float* __restrict__ loss) {
  __shared__ float red[kFinThreads];
  float acc = 0.f;
  for (int k = threadIdx.x; k < count; k += kFinThreads) acc += loss_part[k];
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) *loss = 0.5f * total;
}

// g[i] = -sum_j X[i, j] y[j] xi[j] for i < valid_m; 0 for valid_m <= i < m
template <typename T>
__global__ void __launch_bounds__(kGradThreads)
hinge_grad_kernel(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ xi, int m, int n, int valid_m,
                  float* __restrict__ g) {
  const int warp = (blockIdx.x * kGradThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  if (row0 >= m) return;  // uniform across the warp
  const int live = max(0, min(kRowsPerWarp, valid_m - row0));
  const size_t ld = static_cast<size_t>(n);
  const T* p = X + static_cast<size_t>(row0) * ld;
  float acc[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  if (live == kRowsPerWarp) {
    for (int j = lane; j < n; j += 32) {
      const float v = y[j] * xi[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        acc[r] = fmaf(to_f32(p[r * ld + j]), v, acc[r]);
    }
  } else if (live > 0) {
    for (int j = lane; j < n; j += 32) {
      const float v = y[j] * xi[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        if (r < live) acc[r] = fmaf(to_f32(p[r * ld + j]), v, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (lane == r && row0 + r < m) g[row0 + r] = r < live ? -acc[r] : 0.f;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (u, xi, loss) from one read of X's first valid_m rows. Scratch: part is
// (splits, n), loss_part is (ceil(n / 256),). Returns cudaGetLastError().
int margin_obj(const void* X, int x_bf16, const float* w, const float* y,
               const float* b, int n, int valid_m, int rows_per_split,
               int splits, float* part, float* u, float* xi, float* loss_part,
               float* loss, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kMarginThreads - 1) / kMarginThreads, splits);
  if (x_bf16) {
    margin_partial_kernel<__nv_bfloat16><<<grid, kMarginThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), w, n, valid_m, rows_per_split,
        part);
  } else {
    margin_partial_kernel<float><<<grid, kMarginThreads, 0, s>>>(
        static_cast<const float*>(X), w, n, valid_m, rows_per_split, part);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int fin_blocks = (n + kFinThreads - 1) / kFinThreads;
  margin_finalize_kernel<<<fin_blocks, kFinThreads, 0, s>>>(
      part, splits, n, y, b, u, xi, loss_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  loss_sum_kernel<<<1, kFinThreads, 0, s>>>(loss_part, fin_blocks, loss);
  return cudaGetLastError();
}

// g = -X (y * xi) over rows < valid_m, zeros below. Returns cudaGetLastError().
int hinge_grad(const void* X, int x_bf16, const float* y, const float* xi,
               int m, int n, int valid_m, float* g, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (kGradThreads / 32) * kRowsPerWarp;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks == 0) return cudaSuccess;
  if (x_bf16) {
    hinge_grad_kernel<__nv_bfloat16><<<blocks, kGradThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), y, xi, m, n, valid_m, g);
  } else {
    hinge_grad_kernel<float><<<blocks, kGradThreads, 0, s>>>(
        static_cast<const float*>(X), y, xi, m, n, valid_m, g);
  }
  return cudaGetLastError();
}

}  // extern "C"
