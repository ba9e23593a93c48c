// Backward of the line-opacity sum on Hopper (sm_90a), Kernel 1b.
//
// Kernel 1 (line_opacity.cu) computes, per model b,
//   out[b, d, p] = sum over lines l of alpha[b, d, l] * phi(grid[p] - nu[l])
// inside the window -iw <= p - center[l] < iw, over a pixel range
// [p_begin, p_begin + n_out) of the global grid.  Given g = dLoss/dout
// [b, d, n_out], this kernel writes, per (model, depth, line),
//   dLoss/dalpha = sum_p g phi,
//   dLoss/dgamma = alpha sum_p g dphi/dgamma,
//   dLoss/ddoppler = alpha sum_p g dphi/ddoppler,
// the sums running over the pair's window intersected with the range.
// With phi = Re w(x, y) / (sqrt(pi) D), x = dnu / D, y = gamma / (sqrt(pi)
// pi) / D, a pair only needs the three window sums
//   S_w = sum g Re w,  S_y = sum g dRe w/dy,  S_x = sum g x dRe w/dx,
// and then dL/dalpha = S_w / (sqrt(pi) D), dL/dgamma = alpha S_y /
// (sqrt(pi) pi D) / (sqrt(pi) D), dL/dD = -alpha (S_w + S_x + y S_y) /
// (sqrt(pi) D) / D (opacities/line_kernel.py:_line_grad_finish, the same
// operations in the same order).
//
// Replaces what the JAX package gets from jax.vjp / jax.grad of its line
// sum: the transpose of accumulate_line_opacity_blocked
// (stardis_tpu/opacities/line_kernel.py:1049, and the range program
// accumulate_pairs_blocked, :1316) through the Humlicek w4 chain
// (stardis_tpu/opacities/voigt.py:38-151).
//
// The derivatives are those of the rational formula each Humlicek region
// evaluates (region I where |x| + y > 15, else the full chain, as Kernel 1
// selects), written out per region: W = dw/dz for regions I and II,
// dw/dt = i W (t = y - ix) for III and IV, then dRe w/dx = Re W and
// dRe w/dy = -Im W.  Not the identity w' = -2zw + 2i/sqrt(pi), which holds
// only for the true Faddeeva function.
//
// Design: the natural owner of a backward output is a (model, depth, line)
// pair, so one warp owns one pair.  Its lanes walk the pair's own window
// [center - iw, center + iw) cut to the range, pixel p on lane
// (p - lo) mod 32, coalesced reads of the grid and of g; each lane keeps the
// three sums in registers, then a fixed shuffle tree (offsets 16, 8, 4, 2, 1)
// adds the lanes and lane 0 writes the pair's three outputs.  Every output
// is written once: no atomics, and two launches are equal bit for bit.
// There is no mask test and no line search: a warp touches exactly its
// in-window pixels.  A window of 10 pixels leaves 22 lanes idle; one that
// spans the grid (deep layers, up to 10k pixels at the 10k-pixel slice)
// takes a few hundred lane steps; the hardware schedules the 2.7M warps of
// the 47,807-line, 56-depth slice dynamically, so the long windows do not
// hold up the short ones.
//
// What bounds it on the H100: the derivative arithmetic of the in-window
// evaluations (the same 1.7e10 pairs as Kernel 1 at the 10k-pixel slice,
// ~50 FLOPs each in region I, which covers nearly all of them); memory
// traffic is the [B, D, L] line arrays once and g, which every warp of a
// depth rereads from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps = 8 (model, depth, line) pairs
constexpr double SQRT_PI = 1.7724538509055159;
constexpr double PI = 3.141592653589793;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

template <typename T>
__device__ __forceinline__ void cdiv(T ar, T ai, T br, T bi, T& cr, T& ci) {
  T d = br * br + bi * bi;
  cr = (ar * br + ai * bi) / d;
  ci = (ai * br - ar * bi) / d;
}

// P(v) and P'(v) by Horner, N coefficients from the top degree
template <typename T, int N>
__device__ __forceinline__ void horner_d(const T (&c)[N], T vr, T vi, T& pr,
                                         T& pi, T& dr, T& di) {
  pr = c[0];
  pi = T(0);
  dr = T(0);
  di = T(0);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    T r, i;
    cmul(dr, di, vr, vi, r, i);
    dr = r + pr;
    di = i + pi;
    cmul(pr, pi, vr, vi, r, i);
    pr = r + c[k];
    pi = i;
  }
}

// region I: w = (i/sqrt(pi)) z / (z^2 - 0.5); W = -(i/sqrt(pi)) (z^2 + 0.5)
// / (z^2 - 0.5)^2.  Writes Re w, dRe w/dx, dRe w/dy.
template <typename T>
__device__ __forceinline__ void region1(T x, T y, T z2r, T z2i, T& re, T& dx,
                                        T& dy) {
  const T sqrt_pi = T(SQRT_PI);
  const T ar = z2r - T(0.5), ai = z2i;
  const T d = ar * ar + ai * ai;
  re = ((-y / sqrt_pi) * ar + (x / sqrt_pi) * ai) / d;
  T cr, ci, mr, mi;
  cmul(ar, -ai, ar, -ai, cr, ci);  // conj(z^2 - 0.5)^2
  cmul(z2r + T(0.5), z2i, cr, ci, mr, mi);
  const T s = sqrt_pi * d * d;
  dx = mi / s;
  dy = mr / s;
}

// Re w and its x, y derivatives for the Humlicek region of (x, y); the same
// formulas as stardis_tpu_torch/opacities/voigt.py:faddeeva_real_grad.
template <typename T>
__device__ void faddeeva_real_grad(T x, T y, T& re, T& dx, T& dy) {
  const T sqrt_pi = T(SQRT_PI);
  const T s = fabs(x) + y;
  T z2r, z2i;
  cmul(x, y, x, y, z2r, z2i);
  if (s > T(15.0)) {
    region1(x, y, z2r, z2i, re, dx, dy);
    return;
  }
  if (s > T(5.5)) {  // region II: W = (N' - w D') / D
    const T k2 = T(1.4104739589);
    const T ar = z2r / sqrt_pi - k2, ai = z2i / sqrt_pi;
    T nr, ni;
    cmul(x, y, ar, ai, nr, ni);
    const T mr = -ni, mi = nr;  // multiply by i
    T dr, di;
    cmul(z2r, z2i, z2r - T(3.0), z2i, dr, di);
    dr = T(0.75) + dr;
    T wr, wi;
    cdiv(mr, mi, dr, di, wr, wi);
    const T npr = -(T(3.0) * z2i / sqrt_pi), npi = T(3.0) * z2r / sqrt_pi - k2;
    T dpr, dpi, er, ei, gr, gi;
    cmul(T(2.0) * x, T(2.0) * y, T(2.0) * z2r - T(3.0), T(2.0) * z2i, dpr, dpi);
    cmul(wr, wi, dpr, dpi, er, ei);
    cdiv(npr - er, npi - ei, dr, di, gr, gi);
    re = wr;
    dx = gr;
    dy = -gi;
    return;
  }
  const T tr = y, ti = -x;
  if (y >= T(0.195) * fabs(x) - T(0.176)) {  // region III: w = P(t)/Q(t)
    const T p[5] = {T(0.5642236), T(3.778987), T(11.96482), T(20.20933), T(16.4955)};
    const T q[6] = {T(1.0), T(6.699398), T(21.69274), T(39.27121), T(38.82363), T(16.4955)};
    T pr, pi, dpr, dpi, qr, qi, dqr, dqi, wr, wi, er, ei, tdr, tdi;
    horner_d(p, tr, ti, pr, pi, dpr, dpi);
    horner_d(q, tr, ti, qr, qi, dqr, dqi);
    cdiv(pr, pi, qr, qi, wr, wi);
    cmul(wr, wi, dqr, dqi, er, ei);
    cdiv(dpr - er, dpi - ei, qr, qi, tdr, tdi);  // dw/dt
    re = wr;
    dx = tdi;
    dy = tdr;
    return;
  }
  // region IV: w = exp(u) - t r(u), r = P/Q, u = t^2;
  // dw/dt = 2 t exp(u) - r - 2 u r', r' = (P' - r Q') / Q
  const T p[7] = {T(-0.56419), T(1.320522), T(-35.7668), T(219.031),
                  T(-1540.787), T(3321.99), T(-36183.31)};
  const T q[8] = {T(-1.0), T(1.84144), T(-61.5704), T(364.219),
                  T(-2186.18), T(9022.23), T(-24322.8), T(32066.6)};
  T ur, ui;
  cmul(tr, ti, tr, ti, ur, ui);
  T pr, pi, dpr, dpi, qr, qi, dqr, dqi;
  horner_d(p, ur, ui, pr, pi, dpr, dpi);
  pr = -pr;
  pi = -pi;
  dpr = -dpr;
  dpi = -dpi;
  horner_d(q, ur, ui, qr, qi, dqr, dqi);
  T nr, ni, fr, fi;
  cmul(tr, ti, pr, pi, nr, ni);
  cdiv(nr, ni, qr, qi, fr, fi);
  const T mag = exp(fmin(ur, T(60.0)));
  const T er = mag * cos(ui), ei = mag * sin(ui);
  re = er - fr;
  T rr, ri, cr, ci, drr, dri, ar, ai, br, bi;
  cdiv(pr, pi, qr, qi, rr, ri);
  cmul(rr, ri, dqr, dqi, cr, ci);
  cdiv(dpr - cr, dpi - ci, qr, qi, drr, dri);
  cmul(T(2.0) * tr, T(2.0) * ti, er, ei, ar, ai);
  cmul(T(2.0) * ur, T(2.0) * ui, drr, dri, br, bi);
  dx = ai - ri - bi;
  dy = ar - rr - br;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_opacity_grad_kernel(const T* __restrict__ grid, const T* __restrict__ line_nu,
                         const int* __restrict__ center, const T* __restrict__ alpha,
                         const T* __restrict__ gamma, const T* __restrict__ doppler,
                         const int* __restrict__ iw, const T* __restrict__ g,
                         T* __restrict__ g_alpha, T* __restrict__ g_gamma,
                         T* __restrict__ g_doppler, long long n_pairs, int n_lines,
                         int n_nu, int p_begin, int n_out) {
  // pair = (b * D + d) * L + l, the [B, D, L] element this warp owns
  const long long pair = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // whole warps leave together
  const int l = (int)(pair % n_lines);
  const long long bd = pair / n_lines;
  const int c = center[l];
  const int half = iw[pair];
  const int lo = max(max(c - half, p_begin), 0);
  const int hi = min(min(c + half, p_begin + n_out), n_nu);
  const T y_scale = T(SQRT_PI * PI);
  const T dop = doppler[pair];
  const T y = gamma[pair] / y_scale / dop;
  const T nu = line_nu[l];
  const T* grow = g + bd * n_out;  // this (model, depth)'s row of g

  T sw = T(0), sy = T(0), sx = T(0);
  for (int p = lo + lane; p < hi; p += 32) {
    const T x = (grid[p] - nu) / dop;
    T re, dx, dy;
    faddeeva_real_grad(x, y, re, dx, dy);
    const T gp = grow[p - p_begin];
    sw += gp * re;
    sy += gp * dy;
    sx += gp * (x * dx);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sw += __shfl_down_sync(FULL, sw, off);
    sy += __shfl_down_sync(FULL, sy, off);
    sx += __shfl_down_sync(FULL, sx, off);
  }
  if (lane == 0) {
    const T a = alpha[pair];
    const T inv = T(1) / (T(SQRT_PI) * dop);
    g_alpha[pair] = sw * inv;
    g_gamma[pair] = a * sy / y_scale / dop * inv;
    g_doppler[pair] = -a * (sw + sx + y * sy) * inv / dop;
  }
}

template <typename T>
int launch(const T* grid, const T* line_nu, const int* center, const T* alpha,
           const T* gamma, const T* doppler, const int* iw, const T* g, T* g_alpha,
           T* g_gamma, T* g_doppler, int n_models, int n_lines, int n_depth,
           int p_begin, int n_out, int n_nu, cudaStream_t stream) {
  const long long n_pairs = (long long)n_models * n_depth * n_lines;
  const long long warps_per_block = THREADS / 32;
  const unsigned blocks = (unsigned)((n_pairs + warps_per_block - 1) / warps_per_block);
  line_opacity_grad_kernel<T><<<blocks, THREADS, 0, stream>>>(
      grid, line_nu, center, alpha, gamma, doppler, iw, g, g_alpha, g_gamma, g_doppler,
      n_pairs, n_lines, n_nu, p_begin, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: [n_nu] (the global grid, n_nu = its length); line_nu, center:
// [n_lines]; alpha, gamma, doppler, iw: [n_models, n_depth, n_lines]
// row-major; g: [n_models, n_depth, n_out], the gradient of pixels
// [p_begin, p_begin + n_out); g_alpha, g_gamma, g_doppler: outputs shaped
// as alpha.
extern "C" int line_opacity_grad_f32(const float* grid, const float* line_nu,
                                     const int* center, const float* alpha,
                                     const float* gamma, const float* doppler,
                                     const int* iw, const float* g, float* g_alpha,
                                     float* g_gamma, float* g_doppler, int n_models,
                                     int n_lines, int n_depth, int p_begin, int n_out,
                                     int n_nu, void* stream) {
  return launch<float>(grid, line_nu, center, alpha, gamma, doppler, iw, g, g_alpha,
                       g_gamma, g_doppler, n_models, n_lines, n_depth, p_begin, n_out,
                       n_nu, (cudaStream_t)stream);
}

extern "C" int line_opacity_grad_f64(const double* grid, const double* line_nu,
                                     const int* center, const double* alpha,
                                     const double* gamma, const double* doppler,
                                     const int* iw, const double* g, double* g_alpha,
                                     double* g_gamma, double* g_doppler, int n_models,
                                     int n_lines, int n_depth, int p_begin, int n_out,
                                     int n_nu, void* stream) {
  return launch<double>(grid, line_nu, center, alpha, gamma, doppler, iw, g, g_alpha,
                        g_gamma, g_doppler, n_models, n_lines, n_depth, p_begin, n_out,
                        n_nu, (cudaStream_t)stream);
}

extern "C" const char* line_opacity_grad_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
