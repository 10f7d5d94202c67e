// Feature-axis VI screen for Hopper (sm_90a): per feature row f_j of X,
// the four reductions
//   d_theta = f_j . (y theta1),  d_one = f_j . y,  d_y = f_j . 1,
//   d_sq    = f_j . f_j
// from one read of the row, then the closed-form bound on |fhat_j^T theta2|
// over the VI region (src/repro_torch/core/screening.py `_t_max` and
// `screen_bounds_from_reductions`) in registers. Only the (m,) bounds are
// written. X is (m, n) row-major, fp32 or bf16; sums are fp32.
//
// Replaces: src/repro/kernels/screen.py `_feature_kernel` (entry
// `screen_bounds_pallas(axis="features")`). The finalizer follows the
// reference's core/screening.py `_t_max`, not the Pallas `_t_cases`: it
// also treats the halfspace as uninformative when ||Qa||^2 <= 1e-9 (lam1 =
// lam_max with unbalanced classes, where a is parallel to y).
//
// Bound on this card: one read of X (m * n * sizeof(X) bytes) and ~7 m n
// flops, ~1.75 flop per byte of fp32 X: HBM-bound (0.60 ms for an fp32
// 50,000 x 10,000 X at 3.35 TB/s). Design against that bound: one warp per
// 4 rows reads along n (coalesced 128-byte lines), each lane reuses its
// y[j] and y[j] theta1[j] for the 4 rows, 16 fp32 accumulators stay in
// registers, a shuffle reduction finishes each sum, and lane r finalizes
// row r. Ragged edges are masked in the kernel; nothing is padded. Every
// max is NaN-propagating (as torch.maximum), so a poisoned anchor gives a
// NaN bound, which the caller keeps.
//
// Dynamic variant (the in-solver refresh, src/repro/core/solver.py
// `_dynamic_run`: `bound_statics` and the capped bound): optional sample
// weights s (0/1 live samples in mask mode) make the reductions
//   f_j . (y theta1), f_j . (y s), f_j . s, f_j . (f_j s),
// so the region is that of the sample-masked problem, and a flag in the
// packed scalars caps the bound at the gap sphere's
//   |d_theta| + sqrt(max(d_sq, 0)) * delta
// with a NaN-propagating min. Both stay in the one read of X; the weights
// add one 4-byte load per column, shared by the warp's 4 rows.
//
// EDPP mode (src/repro/core/rules/programs.py `_edpp_bounds`, which the
// reference evaluates in XLA from the four reductions): the same four sums
// and the same VI bound, then the EDPP projection ball on the hyperplane
//   |v_ch| + sqrt(max(r_h_sq_e, 0)) sqrt(max(d_sq - d_y^2 / ysq, 0)),
//   v_ch = d_theta + (v_v2 - mu v_v1) / 2 - (yc_e / ysq) d_y,
//   v_vk = inv_k d_one - d_theta,
// from three more packed scalars (mu, yc_e, r_h_sq_e: slots 12-14), and the
// NaN-propagating min of the two. One read of X as in the VI mode: the ball
// adds ~15 flops a feature row to the finalizer and nothing to the sweep.
// The mode is a kernel argument of both instantiations, not an
// instantiation of its own: the VI bound of both modes comes from the same
// compiled instructions, then goes to the store (VI) or into the min with
// the ball (EDPP), so edpp <= vi holds bit for bit against a VI-mode launch
// of the same instantiation on the same anchor. In two instantiations the
// compiler may fuse a multiply and an add of the VI finalizer in one and
// not in the other, and the two VI bounds then differ in their last bit.
//
// Weighted EDPP mode (the path server's padded slots, whose 0/1 sample
// weights mark the live columns): the weighted instantiation's four sums
// f_j . (y theta1), f_j . (y s), f_j . s, f_j . (f_j s) enter the same
// ball, with ysq = n_tot = sum(s) in the packed scalars, as the reference's
// `_edpp_bounds` takes them from its sample-masked `FixedStats`.
//
// d_theta output (optional, any mode): with a non-null d_theta pointer the
// finalizing lane also stores its row's d_theta = f_j . (y theta1), the sum
// it already holds in a register, so one read of a chunk of X gives both
// the chunk's bounds and the d_theta slice the chunk-skip cache keeps
// (src/repro_torch/sparse/screen_stream.py; the reference reads the chunk
// twice there, the kernel and then `row_dot`). The store is after the
// bound and touches none of its arithmetic: a null pointer gives the launch
// without the output, bit for bit.

// Partial mode (a sharded run, core/distributed.py; any of the two
// instantiations): a third template flag stops the kernel after the shuffle
// reduction and stores the four sums [d_theta, d_one, d_y, d_sq] as a
// (4, m) array through the bounds pointer, in the weighted and unweighted
// instantiations (`screen_partial_features`). After the all-reduce over the
// sample axis, `screen_finalize_features` (screen_finalize_kernel, one
// thread a feature) applies feature_bound and edpp_bound, the same device
// functions, to the reduced sums. The flag is a template argument, so the
// full launches are compiled from the source they had before it. The
// finalize holds the EDPP branch as both launch instantiations now do:
// its code around the VI finalizer is theirs, and the compiler fuses that
// finalizer's multiplies and adds as it does there (a finalize whose code
// differed from its launch's gave last-bit differences on an H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kRowsPerWarp = 4;
constexpr float kEps = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max and min that propagate NaN from either side (jnp.maximum,
// torch.minimum); fmaxf / fminf drop it
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The packed scalars of kernels/screen.py pack_shared, in its order.
struct Shared {
  float inv1, inv2, yc, ysq, r_h_sq, g0, qa_sq, a_norm, a_dot_y;
  float r_h;
  bool informative;  // halfspace_valid and ||Qa||^2 > 1e-9
  bool cap;          // slot 10: min with the gap sphere's bound
  float cap_delta;   // slot 11: the sphere's radius delta
};

// The EDPP mode's three scalars (slots 12-14 of pack_shared(..., edpp=)).
struct EdppShared {
  float mu, yc, r_h;  // r_h = sqrt(max(r_h_sq, 0))
};

__device__ __forceinline__ EdppShared load_edpp(const float* __restrict__ sc) {
  EdppShared e;
  e.mu = sc[12];
  e.yc = sc[13];
  e.r_h = sqrtf(nmax(sc[14], 0.f));
  return e;
}

__device__ __forceinline__ Shared load_shared(const float* __restrict__ sc) {
  Shared s;
  s.inv1 = sc[0];
  s.inv2 = sc[1];
  s.yc = sc[2];
  s.ysq = sc[3];
  s.r_h_sq = sc[4];
  s.g0 = sc[5];
  s.qa_sq = sc[6];
  s.a_norm = sc[7];
  s.a_dot_y = sc[8];
  s.informative = (sc[9] > 0.5f) && (s.qa_sq > 1e-9f);
  s.r_h = sqrtf(nmax(s.r_h_sq, 0.f));
  s.cap = sc[10] > 0.5f;
  s.cap_delta = sc[11];
  return s;
}

// max_{theta in K} v^T theta (core/screening.py _t_max)
__device__ __forceinline__ float t_max(float v_ch, float qv_qa, float qv_sq,
                                       const Shared& s) {
  const float qv_norm = sqrtf(nmax(qv_sq, 0.f));
  const float ball = v_ch + s.r_h * qv_norm;
  const float at_ball = s.g0 + s.r_h * qv_qa / nmax(qv_norm, kEps);
  const bool use_ball = (at_ball >= 0.f) || !s.informative || (qv_norm <= kEps);
  const float qa_sq = nmax(s.qa_sq, kEps);
  const float mu = qv_qa / qa_sq;
  const float vperp_sq = nmax(qv_sq - mu * mu * qa_sq, 0.f);
  const float rho_sq = nmax(s.r_h_sq - s.g0 * s.g0 / qa_sq, 0.f);
  const float cut = v_ch - mu * s.g0 + sqrtf(rho_sq) * sqrtf(vperp_sq);
  return use_ball ? ball : cut;
}

// core/screening.py screen_bounds_from_reductions for one feature
__device__ __forceinline__ float feature_bound(float d_theta, float d_one,
                                               float d_y, float d_sq,
                                               const Shared& s) {
  const float v_c = 0.5f * (s.inv2 * d_one + d_theta);
  const float v_ch = v_c - (s.yc / s.ysq) * d_y;
  const float qv_sq = d_sq - d_y * d_y / s.ysq;
  const float v_a = (d_theta - s.inv1 * d_one) / nmax(s.a_norm, kEps);
  const float qv_qa = v_a - d_y * s.a_dot_y / s.ysq;
  const float vi = nmax(t_max(v_ch, qv_qa, qv_sq, s),
                        t_max(-v_ch, -qv_qa, qv_sq, s));
  // only when asked: with delta = inf and d_sq = 0 the sphere term is NaN
  if (!s.cap) return vi;
  return nmin(vi, fabsf(d_theta) + sqrtf(nmax(d_sq, 0.f)) * s.cap_delta);
}

// core/screening.py edpp_bounds_from_reductions: the EDPP ball, then the
// min with the VI bound `vi` of the same anchor
__device__ __forceinline__ float edpp_bound(float d_theta, float d_one,
                                            float d_y, float d_sq, float vi,
                                            const Shared& s,
                                            const EdppShared& e) {
  const float v_v1 = s.inv1 * d_one - d_theta;
  const float v_v2 = s.inv2 * d_one - d_theta;
  const float v_c = d_theta + 0.5f * (v_v2 - e.mu * v_v1);
  const float v_ch = v_c - (e.yc / s.ysq) * d_y;
  const float qv_sq = nmax(d_sq - d_y * d_y / s.ysq, 0.f);
  const float ball = fabsf(v_ch) + e.r_h * sqrtf(qv_sq);
  return nmin(ball, vi);
}

// kWeighted: the reductions are weighted by w (n,); otherwise all ones.
// edpp: the EDPP mode. kPartial: bounds is the (4, m) output of the four
// sums, and nothing is finalized
template <typename T, bool kWeighted, bool kPartial = false>
__global__ void __launch_bounds__(kThreads)
screen_features_kernel(const T* __restrict__ X, const float* __restrict__ y,
                       const float* __restrict__ theta,
                       const float* __restrict__ w,
                       const float* __restrict__ sc, int m, int n, bool edpp,
                       float* __restrict__ bounds,
                       float* __restrict__ d_theta) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  if (row0 >= m) return;  // uniform across the warp
  const int live = min(kRowsPerWarp, m - row0);
  const size_t ld = static_cast<size_t>(n);
  const T* p = X + static_cast<size_t>(row0) * ld;
  float a_t[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  float a_o[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  float a_y[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  float a_s[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
  for (int j = lane; j < n; j += 32) {
    const float yj = y[j];
    const float ytj = yj * theta[j];
    float wj = 1.f, ywj = yj;
    if constexpr (kWeighted) {
      wj = w[j];
      ywj = yj * wj;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r < live) {
        const float x = to_f32(p[r * ld + j]);
        a_t[r] = fmaf(x, ytj, a_t[r]);
        a_o[r] = fmaf(x, ywj, a_o[r]);
        if constexpr (kWeighted) {
          const float xw = x * wj;
          a_y[r] += xw;
          a_s[r] = fmaf(xw, x, a_s[r]);
        } else {
          a_y[r] += x;
          a_s[r] = fmaf(x, x, a_s[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a_t[r] += __shfl_xor_sync(0xffffffffu, a_t[r], off);
      a_o[r] += __shfl_xor_sync(0xffffffffu, a_o[r], off);
      a_y[r] += __shfl_xor_sync(0xffffffffu, a_y[r], off);
      a_s[r] += __shfl_xor_sync(0xffffffffu, a_s[r], off);
    }
  }
  if constexpr (kPartial) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (lane == r && r < live) {
        const size_t row = static_cast<size_t>(row0 + r);
        const size_t lm = static_cast<size_t>(m);
        bounds[row] = a_t[r];
        bounds[lm + row] = a_o[r];
        bounds[2 * lm + row] = a_y[r];
        bounds[3 * lm + row] = a_s[r];
      }
    }
    return;
  }
  const Shared s = load_shared(sc);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (lane == r && r < live) {
      const float vi = feature_bound(a_t[r], a_o[r], a_y[r], a_s[r], s);
      if (edpp) {
        bounds[row0 + r] = edpp_bound(a_t[r], a_o[r], a_y[r], a_s[r], vi, s,
                                      load_edpp(sc));
      } else {
        bounds[row0 + r] = vi;
      }
      if (d_theta != nullptr) d_theta[row0 + r] = a_t[r];
    }
  }
}

template <typename T>
void launch(const T* X, const float* y, const float* theta, const float* w,
            const float* sc, int m, int n, float* bounds, float* d_theta,
            int edpp, int blocks, cudaStream_t s) {
  if (w != nullptr) {
    screen_features_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        X, y, theta, w, sc, m, n, edpp != 0, bounds, d_theta);
  } else {
    screen_features_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        X, y, theta, w, sc, m, n, edpp != 0, bounds, d_theta);
  }
}

// bounds[j] from the all-reduced sums (4, m) of the partial mode: the
// finalize of screen_features_kernel, one thread a feature, for the sums of
// either instantiation: both hold the EDPP branch (a launch argument), and
// the compiler fuses the VI finalizer's multiplies and adds as it does in a
// launch only when the code around them is the same
__global__ void __launch_bounds__(kThreads)
screen_finalize_kernel(const float* __restrict__ sums,
                       const float* __restrict__ sc, int m, bool edpp,
                       float* __restrict__ bounds) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const size_t lm = static_cast<size_t>(m);
  const float d_t = sums[j], d_o = sums[lm + j], d_y = sums[2 * lm + j],
              d_s = sums[3 * lm + j];
  const Shared s = load_shared(sc);
  const float vi = feature_bound(d_t, d_o, d_y, d_s, s);
  if (edpp) {
    bounds[j] = edpp_bound(d_t, d_o, d_y, d_s, vi, s, load_edpp(sc));
  } else {
    bounds[j] = vi;
  }
}

template <typename T>
void launch_partial(const T* X, const float* y, const float* theta,
                    const float* w, int m, int n, float* sums, int blocks,
                    cudaStream_t s) {
  if (w != nullptr) {
    screen_features_kernel<T, true, true><<<blocks, kThreads, 0, s>>>(
        X, y, theta, w, nullptr, m, n, false, sums, nullptr);
  } else {
    screen_features_kernel<T, false, true><<<blocks, kThreads, 0, s>>>(
        X, y, theta, w, nullptr, m, n, false, sums, nullptr);
  }
}

}  // namespace

extern "C" {

// bounds[j] for every feature row of X. weights: (n,) sample weights, or
// null for all ones. scalars: the packed fp32 values of kernels/screen.py
// pack_shared, 12 (slots 10-11: the gap-sphere cap), or 16 with edpp != 0
// (slots 12-14: the EDPP scalars, from the statistics weighted as the
// sums are). d_theta: (m,) output of each row's f_j . (y theta1), or null
// for none.
// Returns cudaGetLastError().
int screen_bounds_features(const void* X, int x_bf16, const float* y,
                           const float* theta, const float* weights,
                           const float* scalars, int m, int n, float* bounds,
                           float* d_theta, int edpp, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks == 0) return cudaSuccess;
  if (x_bf16) {
    launch(static_cast<const __nv_bfloat16*>(X), y, theta, weights, scalars,
           m, n, bounds, d_theta, edpp, blocks, s);
  } else {
    launch(static_cast<const float*>(X), y, theta, weights, scalars, m, n,
           bounds, d_theta, edpp, blocks, s);
  }
  return cudaGetLastError();
}

// Partial mode: sums (4, m) = [f_j . (y theta), f_j . (y w), f_j . w,
// f_j . (f_j w)] for every feature row (w = weights, or all ones when null),
// nothing finalized. Returns cudaGetLastError().
int screen_partial_features(const void* X, int x_bf16, const float* y,
                            const float* theta, const float* weights, int m,
                            int n, float* sums, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks == 0) return cudaSuccess;
  if (x_bf16) {
    launch_partial(static_cast<const __nv_bfloat16*>(X), y, theta, weights, m,
                   n, sums, blocks, s);
  } else {
    launch_partial(static_cast<const float*>(X), y, theta, weights, m, n, sums,
                   blocks, s);
  }
  return cudaGetLastError();
}

// bounds (m,) from all-reduced sums (4, m) of either instantiation and the
// packed scalars of screen_bounds_features (the cap in slots 10-11; with
// edpp != 0 the EDPP scalars in slots 12-14). Returns cudaGetLastError().
int screen_finalize_features(const float* sums, const float* scalars, int m,
                             int edpp, float* bounds, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  screen_finalize_kernel<<<blocks, kThreads, 0, s>>>(sums, scalars, m,
                                                     edpp != 0, bounds);
  return cudaGetLastError();
}

}  // extern "C"
