// Feature-axis VI screen for Hopper (sm_90a): per feature row f_j of X,
// the four reductions
//   d_theta = f_j . (y theta1),  d_one = f_j . y,  d_y = f_j . 1,
//   d_sq    = f_j . f_j
// from one read of the row, then the closed-form bound on |fhat_j^T theta2|
// over the VI region (src/repro_torch/core/screening.py `_t_max` and
// `screen_bounds_from_reductions`). X is (m, n) row-major, fp32 or bf16;
// sums are fp32.
//
// Replaces: src/repro/kernels/screen.py `_feature_kernel` (entry
// `screen_bounds_pallas(axis="features")`). The finalizer follows the
// reference's core/screening.py `_t_max`, not the Pallas `_t_cases`: it
// also treats the halfspace as uninformative when ||Qa||^2 <= 1e-9 (lam1 =
// lam_max with unbalanced classes, where a is parallel to y).
//
// Bound on this card: one read of X (m * n * sizeof(X) bytes) and ~7 m n
// flops, ~1.75 flop per byte of fp32 X, against the card's ~20 fp32
// flop/byte ridge: HBM-bound (0.60 ms for an fp32 50,000 x 10,000 X at
// 3.35 TB/s, 24.5 us for a 2,048-row chunk of it). Tensor cores cannot
// help: it is four matrix-vector products with no operand reuse. The only
// goal is to read X once at close to the HBM rate, at any m.
//
// What held the first kernel back (one warp per 4 whole rows, 32 rows a
// block, 4-byte loads strided by 32, y and theta reloaded per column): a
// 2,048-row chunk gave it 64 blocks on 132 SMs, 27% of its bound.
//
// Design (kernels/screen.py `screen_plan`, plain ints passed here):
//  * the column split is a function of n and the item size alone: a row of
//    at most 4,096 columns is one segment, a longer one is cut into
//    segments of at most 8 KB. A tile is one row's segment; one warp sums
//    it. Because the split depends on neither m, the grid nor the variant,
//    a row's bits depend only on n and the dtype: a chunk of X, a row block
//    of a grid, or the whole X give a row the same bounds bit for bit (the
//    chunked path, the 4 x 1 grid and the chunk-skip twin rely on this);
//  * two kernels. The sweep (`screen_sweep_kernel`) writes each tile's four
//    sums into a (segs * 4, m) fp32 scratch; the finalize
//    (`screen_finalize_kernel`, one thread a row) adds a row's segments in
//    segment order and applies the bound. With one segment the sweep's warp
//    finalizes its row itself. No float atomics: a repeated call gives the
//    same bits;
//  * a persistent grid of whole waves, 2 blocks of 8 warps per SM. Block b
//    takes the consecutive tiles [split_start(b), split_start(b + 1)) of the
//    segment-major order, so its tiles share one or two segments, and at any
//    time the blocks read every part of X. For each segment the block
//    stages the columns y theta1, y w and w (fp32) in shared memory once,
//    then its warps take its tiles in turn. A 2,048 x 10,000 fp32 chunk is
//    10,240 tiles of 8,000 bytes, 38 or 39 a block;
//  * 16-byte loads: a lane owns the units lane, lane + 32, ... of a tile and
//    loads 8 of them (128 bytes) before it sums them, so an SM can hold
//    64 KB of X in flight (Little's law wants ~17 KB: 3.35 TB/s x ~0.7 us
//    over 132 SMs). A warp's first loads of a segment go out before it
//    waits on the staging, and of its next tile before it stores a tile's
//    sums. Bulk variant: 16-byte vector loads (rows 16-byte aligned: fp32
//    n % 4 == 0, bf16 n % 8 == 0, an aligned base). Scalar variant (any
//    other row): the same units, one item at a time, masked at the row's
//    end; it sums in the bulk variant's order, so the two give the same
//    bits;
//  * every product and sum, of the sweep and of the finalizer, is an
//    explicit round-to-nearest intrinsic, so the compiler fuses nothing by
//    itself and every instantiation and kernel computes the same way. A lane
//    keeps one accumulator per element slot of a unit and sum; the slots are
//    added in a fixed tree, then the warp in a butterfly (every lane gets
//    the same bits).
// Tried on an H100 while this was designed, and dropped: a producer warp
// streaming the tiles through a cp.async.bulk ring (csrc/sweep.cuh's
// pattern), no faster at any shape; an L2 prefetch of a warp's next tile,
// slower; blocks owning whole rows and finalizing them in the sweep,
// slower (all blocks then read the same columns at once); the finalize
// fused into the sweep by per-row counters, slower (a fence and an atomic a
// tile); the finalize as a programmatic dependent launch, no faster. What
// is left at a 2,048-row chunk is the launches, the first staging and the
// tail, a few microseconds (PERF.md).
//
// Every max and min of the finalizer is NaN-propagating (as torch.maximum),
// so a poisoned anchor gives a NaN bound, which the caller keeps.
//
// Dynamic variant (the in-solver refresh, src/repro/core/solver.py
// `_dynamic_run`: `bound_statics` and the capped bound): optional sample
// weights s (0/1 live samples in mask mode) make the reductions
//   f_j . (y theta1), f_j . (y s), f_j . s, f_j . (f_j s),
// so the region is that of the sample-masked problem (the weighted
// instantiation of the sweep, which stages w too), and a flag in the
// packed scalars caps the bound at the gap sphere's
//   |d_theta| + sqrt(max(d_sq, 0)) * delta
// with a NaN-propagating min.
//
// EDPP mode (src/repro/core/rules/programs.py `_edpp_bounds`, which the
// reference evaluates in XLA from the four reductions): the same four sums
// and the same VI bound, then the EDPP projection ball on the hyperplane
//   |v_ch| + sqrt(max(r_h_sq_e, 0)) sqrt(max(d_sq - d_y^2 / ysq, 0)),
//   v_ch = d_theta + (v_v2 - mu v_v1) / 2 - (yc_e / ysq) d_y,
//   v_vk = inv_k d_one - d_theta,
// from three more packed scalars (mu, yc_e, r_h_sq_e: slots 12-14), and the
// NaN-propagating min of the two. It is a launch argument, and the
// finalizer's every operation is pinned, so edpp <= vi holds bit for bit
// against a VI-mode launch on the same anchor. Weighted EDPP
// mode (the path server's padded slots): the weighted sums enter the same
// ball, with ysq = n_tot = sum(s) in the packed scalars, as the
// reference's `_edpp_bounds` takes them from its sample-masked `FixedStats`.
//
// d_theta output (optional, any mode): with a non-null d_theta pointer the
// finalize also stores each row's summed d_theta = f_j . (y theta1), so one
// read of a chunk of X gives both the chunk's bounds and the d_theta slice
// the chunk-skip cache keeps (src/repro_torch/sparse/screen_stream.py). The
// store is after the bound and touches none of its arithmetic.
//
// Partial mode (a sharded run, core/distributed.py; either instantiation):
// `screen_partial_features` runs the same sweep, then adds each row's
// segments in the same order into a (4, m) array [d_theta, d_one, d_y,
// d_sq] (with one segment the sweep stores it) and stops. After the
// all-reduce over the sample axis, `screen_finalize_features` runs the full
// launch's finalize kernel on one segment. The finalizer trap: a finalize
// whose code differs from its launch's fused the VI finalizer's multiplies
// and adds differently and gave last-bit differences on an H100. Here the
// finalizer (`row_bound`) is written in explicit round-to-nearest
// intrinsics, so it gives the same bits in the finalize kernel and, with
// one segment, in the sweep; on an unsplit X a partial launch then the
// finalize give the full launch's bits, in every mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;  // kernels/screen.py SCREEN_BLOCKS_PER_SM
constexpr int kUnroll = 8;       // 16-byte units a lane loads before it sums them
constexpr int kVectors = 3;      // kernels/screen.py SCREEN_VECTORS
constexpr float kEps = 1e-30f;

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
  e.r_h = __fsqrt_rn(nmax(sc[14], 0.f));
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
  s.r_h = __fsqrt_rn(nmax(s.r_h_sq, 0.f));
  s.cap = sc[10] > 0.5f;
  s.cap_delta = sc[11];
  return s;
}

// The finalizer below is written in explicit round-to-nearest intrinsics:
// the compiler may fuse no multiply and add of it, so it gives the same bits
// in every kernel that inlines it (the sweep and the finalize kernel).

// max_{theta in K} v^T theta (core/screening.py _t_max)
__device__ __forceinline__ float t_max(float v_ch, float qv_qa, float qv_sq,
                                       const Shared& s) {
  const float qv_norm = __fsqrt_rn(nmax(qv_sq, 0.f));
  const float ball = __fadd_rn(v_ch, __fmul_rn(s.r_h, qv_norm));
  const float at_ball =
      __fadd_rn(s.g0, __fdiv_rn(__fmul_rn(s.r_h, qv_qa), nmax(qv_norm, kEps)));
  const bool use_ball = (at_ball >= 0.f) || !s.informative || (qv_norm <= kEps);
  const float qa_sq = nmax(s.qa_sq, kEps);
  const float mu = __fdiv_rn(qv_qa, qa_sq);
  const float vperp_sq = nmax(__fsub_rn(qv_sq, __fmul_rn(__fmul_rn(mu, mu), qa_sq)), 0.f);
  const float rho_sq =
      nmax(__fsub_rn(s.r_h_sq, __fdiv_rn(__fmul_rn(s.g0, s.g0), qa_sq)), 0.f);
  const float cut = __fadd_rn(__fsub_rn(v_ch, __fmul_rn(mu, s.g0)),
                              __fmul_rn(__fsqrt_rn(rho_sq), __fsqrt_rn(vperp_sq)));
  return use_ball ? ball : cut;
}

// core/screening.py screen_bounds_from_reductions for one feature
__device__ __forceinline__ float feature_bound(float d_theta, float d_one,
                                               float d_y, float d_sq,
                                               const Shared& s) {
  const float v_c = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(s.inv2, d_one), d_theta));
  const float v_ch = __fsub_rn(v_c, __fmul_rn(__fdiv_rn(s.yc, s.ysq), d_y));
  const float qv_sq = __fsub_rn(d_sq, __fdiv_rn(__fmul_rn(d_y, d_y), s.ysq));
  const float v_a =
      __fdiv_rn(__fsub_rn(d_theta, __fmul_rn(s.inv1, d_one)), nmax(s.a_norm, kEps));
  const float qv_qa = __fsub_rn(v_a, __fdiv_rn(__fmul_rn(d_y, s.a_dot_y), s.ysq));
  const float vi = nmax(t_max(v_ch, qv_qa, qv_sq, s),
                        t_max(-v_ch, -qv_qa, qv_sq, s));
  // only when asked: with delta = inf and d_sq = 0 the sphere term is NaN
  if (!s.cap) return vi;
  return nmin(vi, __fadd_rn(fabsf(d_theta),
                            __fmul_rn(__fsqrt_rn(nmax(d_sq, 0.f)), s.cap_delta)));
}

// core/screening.py edpp_bounds_from_reductions: the EDPP ball, then the
// min with the VI bound `vi` of the same anchor
__device__ __forceinline__ float edpp_bound(float d_theta, float d_one,
                                            float d_y, float d_sq, float vi,
                                            const Shared& s,
                                            const EdppShared& e) {
  const float v_v1 = __fsub_rn(__fmul_rn(s.inv1, d_one), d_theta);
  const float v_v2 = __fsub_rn(__fmul_rn(s.inv2, d_one), d_theta);
  const float v_c =
      __fadd_rn(d_theta, __fmul_rn(0.5f, __fsub_rn(v_v2, __fmul_rn(e.mu, v_v1))));
  const float v_ch = __fsub_rn(v_c, __fmul_rn(__fdiv_rn(e.yc, s.ysq), d_y));
  const float qv_sq = nmax(__fsub_rn(d_sq, __fdiv_rn(__fmul_rn(d_y, d_y), s.ysq)), 0.f);
  const float ball = __fadd_rn(fabsf(v_ch), __fmul_rn(e.r_h, __fsqrt_rn(qv_sq)));
  return nmin(ball, vi);
}

// The bound of one row from its four sums: VI (capped when the scalars
// ask), or with edpp the EDPP ball's min with it.
__device__ __forceinline__ float row_bound(float d_theta, float d_one, float d_y,
                                           float d_sq, const float* __restrict__ sc,
                                           bool edpp) {
  const Shared s = load_shared(sc);
  const float vi = feature_bound(d_theta, d_one, d_y, d_sq, s);
  return edpp ? edpp_bound(d_theta, d_one, d_y, d_sq, vi, s, load_edpp(sc)) : vi;
}

// -- the sweep -------------------------------------------------------------

// The plan of kernels/screen.py screen_plan: segments of seg_cols columns
// (the last one shorter), segs = ceil(n / seg_cols).
struct Plan {
  int m, n, seg_cols, segs;
};

// 16 bytes of X as raw bits: kN = 4 fp32 or 8 bf16 items.
template <typename T>
struct Unit {
  static constexpr int kN = 16 / sizeof(T);
  // element e of the unit as fp32 (bf16 -> fp32 is exact: the high bits)
  __device__ static float get(const uint4& v, int e) {
    const uint32_t w = e / (kN / 4) == 0 ? v.x : e / (kN / 4) == 1 ? v.y
                     : e / (kN / 4) == 2 ? v.z : v.w;
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w);
    } else {
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
};

__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// Unit u of a row segment (columns [u kN, u kN + kN) of it): zero past the
// segment's `units`. Bulk variant: one 16-byte load; scalar variant: item
// by item, the items at or past `cols` (a ragged last unit) masked.
template <typename T, bool kBulk>
__device__ __forceinline__ uint4 load_unit(const T* __restrict__ row, int u,
                                           int units, int cols) {
  constexpr int kN = Unit<T>::kN;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (u >= units) return v;
  if constexpr (kBulk) {
    v = *reinterpret_cast<const uint4*>(row + static_cast<size_t>(u) * kN);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int c = u * kN + e;
      const uint32_t b = c < cols ? bits_of(row[c]) : 0u;
      if constexpr (sizeof(T) == 4) {
        w[e] = b;
      } else {
        w[e / 2] |= (e & 1) ? (b << 16) : b;
      }
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// A lane's units u0, u0 + 32, ..., u0 + 32 (kUnroll - 1) of a row segment.
template <typename T, bool kBulk>
__device__ __forceinline__ void load_batch(const T* __restrict__ row, int u0, int units,
                                           int cols, uint4 (&raw)[kUnroll]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) raw[k] = load_unit<T, kBulk>(row, u0 + 32 * k, units, cols);
}

// kN consecutive floats of a staged column vector, from shared memory
template <int kN>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float* out) {
#pragma unroll
  for (int q = 0; q < kN; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + q);
    out[q] = v.x;
    out[q + 1] = v.y;
    out[q + 2] = v.z;
    out[q + 3] = v.w;
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// The staged columns of a segment: y theta1, y w (y when unweighted), w.
struct Staged {
  const float* t;
  const float* o;
  const float* w;
};

// The four sums of one row segment of `cols` columns: lane l sums the units
// l, l + 32, ... in that order, one accumulator per element slot (raw holds
// the lane's first batch on entry; it is free on exit); then the slots in a
// fixed tree and the warp in a butterfly, so every lane returns the
// segment's [d_theta, d_one, d_y, d_sq]. Both variants sum so.
template <typename T, bool kWeighted, bool kBulk>
__device__ __forceinline__ float4 segment_sums(const T* __restrict__ row, int cols,
                                               const Staged& v, int lane,
                                               uint4 (&raw)[kUnroll]) {
  constexpr int kN = Unit<T>::kN;
  const int units = (cols + kN - 1) / kN;  // bulk: cols % kN == 0
  float a_t[kN], a_o[kN], a_y[kN], a_s[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) a_t[e] = a_o[e] = a_y[e] = a_s[e] = 0.f;
  for (int u0 = lane; u0 < units; u0 += 32 * kUnroll) {
    if (u0 != lane) load_batch<T, kBulk>(row, u0, units, cols, raw);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + 32 * k;
      if (u < units) {
        float vt[kN], vo[kN];
        load_cols<kN>(v.t + u * kN, vt);
        load_cols<kN>(v.o + u * kN, vo);
        float vw[kWeighted ? kN : 1];
        if constexpr (kWeighted) load_cols<kN>(v.w + u * kN, vw);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const float x = Unit<T>::get(raw[k], e);
          a_t[e] = __fmaf_rn(x, vt[e], a_t[e]);
          a_o[e] = __fmaf_rn(x, vo[e], a_o[e]);
          if constexpr (kWeighted) {
            const float xw = __fmul_rn(x, vw[e]);
            a_y[e] = __fadd_rn(a_y[e], xw);
            a_s[e] = __fmaf_rn(xw, x, a_s[e]);
          } else {
            a_y[e] = __fadd_rn(a_y[e], x);
            a_s[e] = __fmaf_rn(x, x, a_s[e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = kN / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int e = 0; e < h; ++e) {
      a_t[e] = __fadd_rn(a_t[e], a_t[e + h]);
      a_o[e] = __fadd_rn(a_o[e], a_o[e + h]);
      a_y[e] = __fadd_rn(a_y[e], a_y[e + h]);
      a_s[e] = __fadd_rn(a_s[e], a_s[e + h]);
    }
  }
  return make_float4(warp_sum(a_t[0]), warp_sum(a_o[0]), warp_sum(a_y[0]),
                     warp_sum(a_s[0]));
}

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The sweep: block b takes the consecutive tiles [split_start(b, tiles,
// grid), split_start(b + 1, ...)) of the segment-major order (tile t is
// segment t / m, row t % m), so its tiles share one or two segments. For
// each, its threads stage the segment's columns in shared memory, then warp
// w sums the segment's tiles whose local index i = t - t0 is w (mod kWarps):
// part[(s * 4 + k) * m + row] = sum k of row over segment s. With one
// segment the warp finalizes its own sums at once into out: the bounds
// (m,), or with sums_only the four sums (4, m); otherwise the finalize
// kernel does, after the sweep.
template <typename T, bool kWeighted, bool kBulk>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
screen_sweep_kernel(const T* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ theta, const float* __restrict__ w,
                    const Plan p, const float* __restrict__ sc, bool edpp,
                    bool sums_only, float* __restrict__ part,
                    float* __restrict__ out, float* __restrict__ d_theta) {
  constexpr int kN = Unit<T>::kN;
  extern __shared__ __align__(16) float staged[];
  const int stride = sweep::round_up(p.seg_cols, kN);
  const Staged v{staged, staged + stride, staged + 2 * stride};
  const int tiles = p.segs * p.m;
  const int t0 = sweep::split_start(blockIdx.x, tiles, gridDim.x);
  const int t1 = sweep::split_start(blockIdx.x + 1, tiles, gridDim.x);
  if (t0 >= t1) return;  // uniform across the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t m = static_cast<size_t>(p.m);
  uint4 raw[kUnroll];
  for (int seg = t0 / p.m; seg * p.m < t1; ++seg) {
    const int c0 = seg * p.seg_cols;
    const int cols = min(p.seg_cols, p.n - c0);
    const int units = (cols + kN - 1) / kN;
    const T* base = X + c0;
    const int r0 = max(t0 - seg * p.m, 0), r1 = min(t1 - seg * p.m, p.m);
    // the warp's first loads go out before it waits on the staging
    if (r0 + warp < r1)
      load_batch<T, kBulk>(base + static_cast<size_t>(r0 + warp) * p.n, lane, units, cols,
                           raw);
    __syncthreads();  // every warp is done with the previous segment's columns
    const int padded = sweep::round_up(cols, kN);
#pragma unroll 4
    for (int j = threadIdx.x; j < padded; j += kThreads) {
      const bool in = j < cols;
      const float yj = in ? y[c0 + j] : 0.f;
      staged[j] = in ? __fmul_rn(yj, theta[c0 + j]) : 0.f;
      if constexpr (kWeighted) {
        const float wj = in ? w[c0 + j] : 0.f;
        staged[stride + j] = __fmul_rn(yj, wj);
        staged[2 * stride + j] = wj;
      } else {
        staged[stride + j] = yj;
      }
    }
    __syncthreads();
    float* seg_part = part + static_cast<size_t>(seg) * 4 * m;
    for (int r = r0 + warp; r < r1; r += kWarps) {
      const float4 sums =
          segment_sums<T, kWeighted, kBulk>(base + static_cast<size_t>(r) * p.n, cols, v,
                                            lane, raw);
      if (r + kWarps < r1)  // the next tile's first loads, under this one's tail
        load_batch<T, kBulk>(base + static_cast<size_t>(r + kWarps) * p.n, lane, units,
                             cols, raw);
      if (p.segs > 1) {
        if (lane < 4) seg_part[lane * m + r] = pick(sums, lane);
      } else if (lane == 0 && sums_only) {
        out[r] = sums.x;
        out[m + r] = sums.y;
        out[2 * m + r] = sums.z;
        out[3 * m + r] = sums.w;
      } else if (lane == 0) {
        out[r] = row_bound(sums.x, sums.y, sums.z, sums.w, sc, edpp);
        if (d_theta != nullptr) d_theta[r] = sums.x;
      }
    }
  }
}

template <typename T>
cudaError_t launch_sweep(const void* X, const float* y, const float* theta,
                         const float* w, const Plan& p, int bulk, int grid,
                         const float* sc, int edpp, bool sums_only, float* part,
                         float* out, float* d_theta, cudaStream_t s) {
  using Kernel = void (*)(const T*, const float*, const float*, const float*,
                          const Plan, const float*, bool, bool, float*, float*, float*);
  const Kernel kernel =
      w != nullptr ? (bulk ? screen_sweep_kernel<T, true, true>
                           : screen_sweep_kernel<T, true, false>)
                   : (bulk ? screen_sweep_kernel<T, false, true>
                           : screen_sweep_kernel<T, false, false>);
  const int smem = kVectors * sweep::round_up(p.seg_cols, Unit<T>::kN) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(X), y, theta, w, p, sc,
                                      edpp != 0, sums_only, part, out, d_theta);
  return cudaGetLastError();
}

// -- the finalize ------------------------------------------------------------

// Row j's four sums: the segments' partials part[(s * 4 + k) * m + j]
// added in segment order. kSums: store them to out (4, m) and stop (the
// partial mode); otherwise out[j] is the bound (row_bound: VI, capped, or
// with edpp the EDPP ball's min with VI) and, with a non-null d_theta,
// d_theta[j] the summed f_j . (y theta1). It finalizes every full launch
// and, on one segment, every all-reduced sum.
template <bool kSums>
__global__ void __launch_bounds__(kThreads)
screen_finalize_kernel(const float* __restrict__ part, int segs, int m,
                       const float* __restrict__ sc, bool edpp,
                       float* __restrict__ out, float* __restrict__ d_theta) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const size_t lm = static_cast<size_t>(m);
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = part[k * lm + j];
#pragma unroll 4
  for (int s = 1; s < segs; ++s) {
    const float* q = part + static_cast<size_t>(s) * 4 * lm + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], q[k * lm]);
  }
  if constexpr (kSums) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k * lm + j] = d[k];
  } else {
    out[j] = row_bound(d[0], d[1], d[2], d[3], sc, edpp);
    if (d_theta != nullptr) d_theta[j] = d[0];
  }
}

template <bool kSums>
cudaError_t launch_finalize(const float* part, int segs, int m, const float* sc,
                            int edpp, float* out, float* d_theta, cudaStream_t s) {
  screen_finalize_kernel<kSums><<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, segs, m, sc, edpp != 0, out, d_theta);
  return cudaGetLastError();
}

Plan make_plan(int m, int n, int seg_cols) {
  return Plan{m, n, seg_cols, (n + seg_cols - 1) / seg_cols};
}

// The sweep, and with more than one segment the finalize kernel after it.
cudaError_t run_sweep(const void* X, int x_bf16, const float* y, const float* theta,
                      const float* w, const Plan& p, int bulk, int grid, const float* sc,
                      int edpp, bool sums_only, float* part, float* out, float* d_theta,
                      cudaStream_t s) {
  const cudaError_t err =
      x_bf16 ? launch_sweep<__nv_bfloat16>(X, y, theta, w, p, bulk, grid, sc, edpp,
                                           sums_only, part, out, d_theta, s)
             : launch_sweep<float>(X, y, theta, w, p, bulk, grid, sc, edpp, sums_only,
                                   part, out, d_theta, s);
  if (err != cudaSuccess || p.segs == 1) return err;
  return sums_only
             ? launch_finalize<true>(part, p.segs, p.m, nullptr, 0, out, nullptr, s)
             : launch_finalize<false>(part, p.segs, p.m, sc, edpp, out, d_theta, s);
}

}  // namespace

extern "C" {

// bounds[j] for every feature row of X, launched as kernels/screen.py
// `screen_plan` says (bulk, grid, seg_cols). weights: (n,) sample weights,
// or null for all ones. scalars: the packed fp32 values of kernels/screen.py
// pack_shared, 12 (slots 10-11: the gap-sphere cap), or 16 with edpp != 0
// (slots 12-14: the EDPP scalars, from the statistics weighted as the sums
// are). part: the (segs * 4, m) fp32 scratch of the segments' sums (null
// with one segment). d_theta: (m,) output of each row's f_j . (y theta1),
// or null for none. Returns cudaGetLastError().
int screen_bounds_features(const void* X, int x_bf16, const float* y,
                           const float* theta, const float* weights,
                           const float* scalars, int m, int n, int bulk,
                           int grid, int seg_cols, float* part, float* bounds,
                           float* d_theta, int edpp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return run_sweep(X, x_bf16, y, theta, weights, make_plan(m, n, seg_cols), bulk, grid,
                   scalars, edpp, false, part, bounds, d_theta,
                   static_cast<cudaStream_t>(stream));
}

// Partial mode: sums (4, m) = [f_j . (y theta), f_j . (y w), f_j . w,
// f_j . (f_j w)] for every feature row (w = weights, or all ones when null),
// nothing finalized: the sweep of screen_bounds_features, then its
// segments added in segment order (part: as there). Returns
// cudaGetLastError().
int screen_partial_features(const void* X, int x_bf16, const float* y,
                            const float* theta, const float* weights, int m,
                            int n, int bulk, int grid, int seg_cols, float* part,
                            float* sums, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return run_sweep(X, x_bf16, y, theta, weights, make_plan(m, n, seg_cols), bulk, grid,
                   nullptr, 0, true, part, sums, nullptr,
                   static_cast<cudaStream_t>(stream));
}

// bounds (m,) from all-reduced sums (4, m) of either instantiation and the
// packed scalars of screen_bounds_features (the cap in slots 10-11; with
// edpp != 0 the EDPP scalars in slots 12-14): the full launch's finalize
// kernel on one segment. Returns cudaGetLastError().
int screen_finalize_features(const float* sums, const float* scalars, int m,
                             int edpp, float* bounds, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_finalize<false>(sums, 1, m, scalars, edpp, bounds, nullptr,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
