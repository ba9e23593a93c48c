// Line-opacity accumulation on Hopper (sm_90a), for a batch of models:
// alpha_line[b, d, p] = sum over lines l of alpha[b, l, d] * phi(grid[p] - nu[l])
// inside the per-(model, line, depth) window
// -iw[b, d, l] <= p - center[l] < iw[b, d, l].  The grid, the line
// frequencies and the centres are shared by the models.
//
// Replaces the JAX package's line-accumulation programs, which all compute
// this one sum on different TPU schedules:
//   stardis_tpu/opacities/voigt.py          faddeeva_real, voigt_profile,
//                                           faddeeva_real_region1
//   stardis_tpu/opacities/line_kernel.py    _accumulate_dense,
//                                           _run_panel_scan / _accumulate_panelized,
//                                           _accumulate_dense_split,
//                                           accumulate_line_opacity_blocked
//                                           (and its scatter chunk_body)
//   stardis_tpu/parallel/batch.py:225       run_batch's vmap of that sum
//                                           over a leading model axis
// The window tiers, panels and split passes there exist to avoid v5e
// scatter costs; this kernel gathers instead and needs none of them.
//
// Design: one thread owns one (model, depth, pixel) output; a block is one
// model x one depth x a tile of TILE pixels (grid z = model).  The window
// half-widths iw arrive precomputed (reference or accuracy mode), so the
// kernel is the same for both window modes.  The block finds, by binary search over the line
// centers (non-increasing: lines ascend in nu, the grid descends), the
// contiguous line range whose windows can reach the tile at this depth, and
// walks it in chunks staged through shared memory.  Each thread tests the
// window mask, evaluates the Humlicek w4 Voigt only inside it (region I where
// |x| + y > 15, else the full chain, the same formula the branchless torch
// version selects) and adds alpha * phi in a register.  Every output is
// written once: no atomics, no scatter, deterministic.
//
// What bounds it on the H100: the Voigt arithmetic of the in-window pairs
// (about 2e10 evaluations at the 100k-line, 56-depth, 10k-pixel slice;
// region I, one complex division, covers most of them) and, for deep layers
// whose strongest lines span the whole grid, the per-pair mask test over the
// full line range.  Memory traffic is small: the [D, L] line arrays stream
// once per pixel tile from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // pixels per block = threads per block
constexpr double SQRT_PI = 1.7724538509055159;
constexpr double PI = 3.141592653589793;

template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

template <typename T>
__device__ __forceinline__ T cdiv_re(T ar, T ai, T br, T bi) {
  T d = br * br + bi * bi;
  return (ar * br + ai * bi) / d;
}

// Re w(x + iy), Humlicek w4; the same regions and operation order as
// stardis_tpu_torch/opacities/voigt.py:faddeeva_real.
template <typename T>
__device__ T faddeeva_real(T x, T y) {
  const T sqrt_pi = T(SQRT_PI);
  T s = fabs(x) + y;
  T z2r, z2i;
  cmul(x, y, x, y, z2r, z2i);
  if (s > T(15.0)) {  // region I
    T n1r = -y / sqrt_pi, n1i = x / sqrt_pi;
    return cdiv_re(n1r, n1i, z2r - T(0.5), z2i);
  }
  if (s > T(5.5)) {  // region II
    T ar = z2r / sqrt_pi - T(1.4104739589), ai = z2i / sqrt_pi;
    T nr, ni;
    cmul(x, y, ar, ai, nr, ni);
    T mr = -ni, mi = nr;  // multiply by i
    T dr, di;
    cmul(z2r, z2i, z2r - T(3.0), z2i, dr, di);
    return cdiv_re(mr, mi, T(0.75) + dr, di);
  }
  T tr = y, ti = -x;
  if (y >= T(0.195) * fabs(x) - T(0.176)) {  // region III
    const T p[5] = {T(0.5642236), T(3.778987), T(11.96482), T(20.20933), T(16.4955)};
    const T q[6] = {T(1.0), T(6.699398), T(21.69274), T(39.27121), T(38.82363), T(16.4955)};
    T pr = p[0], pi = T(0);
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      T r, i;
      cmul(pr, pi, tr, ti, r, i);
      pr = r + p[k];
      pi = i;
    }
    T qr = q[0], qi = T(0);
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      T r, i;
      cmul(qr, qi, tr, ti, r, i);
      qr = r + q[k];
      qi = i;
    }
    return cdiv_re(pr, pi, qr, qi);
  }
  // region IV: w = exp(u) - t P(u)/Q(u), u = t^2
  const T p[7] = {T(-0.56419), T(1.320522), T(-35.7668), T(219.031),
                  T(-1540.787), T(3321.99), T(-36183.31)};
  const T q[8] = {T(-1.0), T(1.84144), T(-61.5704), T(364.219),
                  T(-2186.18), T(9022.23), T(-24322.8), T(32066.6)};
  T ur, ui;
  cmul(tr, ti, tr, ti, ur, ui);
  T pr = p[0], pi = T(0);
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    T r, i;
    cmul(pr, pi, ur, ui, r, i);
    pr = r + p[k];
    pi = i;
  }
  pr = -pr;
  pi = -pi;
  T nr, ni;
  cmul(tr, ti, pr, pi, nr, ni);
  T qr = q[0], qi = T(0);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    T r, i;
    cmul(qr, qi, ur, ui, r, i);
    qr = r + q[k];
    qi = i;
  }
  T fr = cdiv_re(nr, ni, qr, qi);
  return exp(fmin(ur, T(60.0))) * cos(ui) - fr;
}

// first l in [0, n) with center[l] <= c (centers non-increasing)
__device__ int first_at_or_below(const int* center, int n, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (center[mid] <= c) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(TILE)
line_opacity_kernel(const T* __restrict__ grid, const T* __restrict__ line_nu,
                    const int* __restrict__ center, const T* __restrict__ alpha,
                    const T* __restrict__ gamma, const T* __restrict__ doppler,
                    const int* __restrict__ iw, const int* __restrict__ iw_max,
                    T* __restrict__ out, int n_lines, int n_depth, int n_nu) {
  __shared__ T s_nu[TILE], s_alpha[TILE], s_gamma[TILE], s_dop[TILE];
  __shared__ int s_center[TILE], s_iw[TILE];

  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * TILE;
  const int p = p0 + threadIdx.x;
  const int p_last = min(p0 + TILE, n_nu) - 1;
  const size_t bd = (size_t)b * n_depth + d;  // row of this (model, depth)
  const int w = iw_max[bd];
  // a line reaches the tile iff its center lies in (p0 - w, p_last + w]
  const int l_begin = first_at_or_below(center, n_lines, p_last + w);
  const int l_end = first_at_or_below(center, n_lines, p0 - w);

  const size_t row = bd * n_lines;
  const T g = p < n_nu ? grid[p] : T(0);
  const T y_scale = T(SQRT_PI * PI);
  const T phi_scale = T(SQRT_PI);
  T acc = T(0);

  for (int l0 = l_begin; l0 < l_end; l0 += TILE) {
    const int n = min(TILE, l_end - l0);
    __syncthreads();
    if (threadIdx.x < n) {
      const int l = l0 + threadIdx.x;
      s_nu[threadIdx.x] = line_nu[l];
      s_center[threadIdx.x] = center[l];
      s_alpha[threadIdx.x] = alpha[row + l];
      s_gamma[threadIdx.x] = gamma[row + l];
      s_dop[threadIdx.x] = doppler[row + l];
      s_iw[threadIdx.x] = iw[row + l];
    }
    __syncthreads();
    if (p < n_nu) {
      for (int i = 0; i < n; ++i) {
        const int off = p - s_center[i];
        const int half = s_iw[i];
        if (off >= -half && off < half) {
          const T dop = s_dop[i];
          const T x = (g - s_nu[i]) / dop;
          const T y = s_gamma[i] / y_scale / dop;
          const T phi = faddeeva_real(x, y) / (phi_scale * dop);
          acc += phi * s_alpha[i];
        }
      }
    }
  }
  if (p < n_nu) out[bd * n_nu + p] = acc;
}

template <typename T>
int launch(const T* grid, const T* line_nu, const int* center, const T* alpha,
           const T* gamma, const T* doppler, const int* iw, const int* iw_max,
           T* out, int n_models, int n_lines, int n_depth, int n_nu,
           cudaStream_t stream) {
  dim3 blocks((n_nu + TILE - 1) / TILE, n_depth, n_models);
  line_opacity_kernel<T><<<blocks, TILE, 0, stream>>>(
      grid, line_nu, center, alpha, gamma, doppler, iw, iw_max, out, n_lines,
      n_depth, n_nu);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: [n_nu]; line_nu, center: [n_lines]; alpha, gamma, doppler, iw:
// [n_models, n_depth, n_lines] row-major; iw_max: [n_models, n_depth];
// out: [n_models, n_depth, n_nu].
extern "C" int line_opacity_f32(const float* grid, const float* line_nu,
                                const int* center, const float* alpha,
                                const float* gamma, const float* doppler,
                                const int* iw, const int* iw_max, float* out,
                                int n_models, int n_lines, int n_depth, int n_nu,
                                void* stream) {
  return launch<float>(grid, line_nu, center, alpha, gamma, doppler, iw, iw_max,
                       out, n_models, n_lines, n_depth, n_nu, (cudaStream_t)stream);
}

extern "C" int line_opacity_f64(const double* grid, const double* line_nu,
                                const int* center, const double* alpha,
                                const double* gamma, const double* doppler,
                                const int* iw, const int* iw_max, double* out,
                                int n_models, int n_lines, int n_depth, int n_nu,
                                void* stream) {
  return launch<double>(grid, line_nu, center, alpha, gamma, doppler, iw, iw_max,
                        out, n_models, n_lines, n_depth, n_nu, (cudaStream_t)stream);
}

extern "C" const char* line_opacity_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
