// Line-opacity accumulation on Hopper (sm_90a), Kernel 1, for a batch of
// models:
// alpha_line[b, d, p] = sum over lines l of alpha[b, l, d] * phi(grid[p] - nu[l])
// inside the per-(model, line, depth) window
// -iw[b, d, l] <= p - center[l] < iw[b, d, l].  The grid, the line
// frequencies and the centres are shared by the models.
//
// Replaces the JAX package's line-accumulation programs, which all compute
// this one sum on different TPU schedules:
//   stardis_tpu/opacities/voigt.py          faddeeva_real, voigt_profile,
//                                           faddeeva_real_region1 (:38-151)
//   stardis_tpu/opacities/line_kernel.py    _accumulate_dense,
//                                           _run_panel_scan / _accumulate_panelized,
//                                           _accumulate_dense_split,
//                                           accumulate_line_opacity_blocked
//                                           (:1049, and its scatter chunk_body)
//   stardis_tpu/parallel/batch.py:225       run_batch's vmap of that sum
//                                           over a leading model axis
//   stardis_tpu/opacities/line_kernel.py:1316
//                                           accumulate_pairs_blocked: the
//                                           sum over one pixel range with
//                                           a line halo, the program of each
//                                           segment (parallel/sharding.py:555)
// The window tiers, panels and split passes there exist to avoid v5e
// scatter costs; this kernel gathers instead and needs none of them.
//
// Every launch covers a pixel range [p_begin, p_begin + n_out) of the
// global grid and writes out[b, d, p - p_begin]; a full launch is the range
// [0, n_nu).  The grid, the centres and the half-windows stay global (the
// windows clamped at the global n_nu on the host), and each pixel adds its
// in-window lines in one order that no launch changes (below), with the
// same rounding whatever path its position in a block gives it, so a range
// launch equals the full launch and a segmented run the unsegmented one,
// bit for bit.  The binary search below is the line halo that
// bucket_pair_programs_per_shard selects on the host.
//
// What bounds it on the H100: the Voigt arithmetic of the in-window
// (pixel, depth, line) triples (1.7e10 at the 100k-line, 56-depth, 10k-pixel
// Sim100AA slice, 98.5 % of them in Humlicek region I; 2.6e12 at the
// 1M-pixel flagship), and the latencies of its dependent chain where a
// launch has few warps; then the regions II-IV chain, whose warps diverge
// across the three regions near a line centre; then the walk over lines
// whose window misses a block's pixels.  Memory traffic is small: the
// [B, D, L] line arrays stream from L2 once per block.  The design (PERF.md
// times each step):
//
// 1. Per-pair constants once, one reciprocal per evaluation.  A warp stages
//    CHUNK lines at a time into its own shared memory; each staging lane
//    folds its line's constants once: the window [centre - iw, centre + iw)
//    and the core guard [cl, ch) as absolute pixels, nu, 1/D,
//    y = gamma / (sqrt(pi) pi D), c0 = y^2 + 1/2, 4 y^2, and the factors
//    alpha / (pi D) and y alpha / (pi D).  Per in-window pixel, region I
//    (|x| + y > 15) is then
//      x = (grid[p] - nu) (1/D)        (subtract first: grid and nu are
//                                       offsets from a reference frequency)
//      r = 1 / ((x^2 - c0)^2 + 4 y^2 x^2) = 1 / |z^2 - 1/2|^2   (one
//                                       MUFU.RCP in float32)
//      acc += (x^2 y alpha / (pi D) + c0 y alpha / (pi D)) r,
//    i.e. sqrt(pi) Re w alpha / (pi D), since sqrt(pi) Re w = y (x^2 + c0) r:
//    seven rounded operations and the reciprocal.  Regions II-IV (1.5 % of
//    the evaluations) keep the w4 chain (core_sqrtpi_re_w, not inlined, so
//    its registers stay out of the region-I loop), each complex quotient by
//    one reciprocal, times alpha / (pi D).
// 2. Several pixels per thread.  A block owns SPAN = 32 PIXELS consecutive
//    pixels of one (model, depth) row, lane l pixels l, l + 32, ... of
//    them, so each staged line is read from shared memory once (broadcast)
//    for PIXELS independent evaluations.  Per warp and line, integer tests
//    on the staged window and core guard decide for the whole span: a
//    window that misses it skips the line; one that covers it, with the
//    span outside the guard, runs a loop with no mask and no region test,
//    two such lines at once where they follow each other; otherwise the
//    window and |x| + y > 15 are tested per pixel.  The guard only ever
//    errs wide (core_guard), so the loops select exactly the pixels the
//    per-pixel test would; both call one region-I function of explicitly
//    rounded operations (no FMA contraction can differ between them).
// 3. The lines split among SPLIT warps.  Warp w of a block sums the lines
//    l = w (mod SPLIT) in ascending order, and the block adds the warps'
//    sums in warp order: a fixed order for each pixel, set by the global
//    line index alone, whatever the launch's range.  The split gives a
//    small launch (a range of a segmented run) SPLIT times the warps to
//    hide the region-I chain's latencies, and shares each block's walk.
// Each warp's line range comes from a binary search over the centres
// (non-increasing: lines ascend in nu, the grid descends) with the row's
// widest window.  Every output is written once: no atomics, deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 4;             // warps per span, warp w on the lines l = w (mod SPLIT)
constexpr int THREADS = 32 * SPLIT;
constexpr int PIXELS = 8;            // pixels per thread
constexpr int SPAN = 32 * PIXELS;    // consecutive pixels per block
constexpr int CHUNK = 128;           // lines a warp stages at a time
constexpr double SQRT_PI = 1.7724538509055159;
constexpr double PI = 3.141592653589793;

// explicitly rounded operations: never contracted into an fma, so every
// call site of add_region1 and of the accumulation rounds the same
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// float32: the hardware reciprocal alone (one MUFU.RCP, within 1 ulp;
// __fdividef adds four instructions to scale denormal operands, and no
// operand here is one: region I's |z^2 - 1/2|^2 exceeds 10^4 and Humlicek's
// regions II-IV keep their denominators away from zero), float64: exact
__device__ __forceinline__ float recip(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ double recip(double v) { return 1.0 / v; }

// one staged (line, depth) pair; its first 16 bytes decide a warp's path
template <typename T>
struct alignas(16) Line {
  int lo, hi;  // window [lo, hi) in global pixels
  int cl, ch;  // every pixel outside [cl, ch) is in region I (core_guard)
  T nu, inv, y, c0;
  T k4;     // 4 y^2
  T s1;     // y alpha / (pi D), region I's factor
  T c0s1;   // c0 s1
  T scale;  // alpha / (pi D), the factor of sqrt(pi) Re w
};

template <typename T>
__device__ __forceinline__ T x_of(T g, T nu, T inv) {
  return mul_rn(sub_rn(g, nu), inv);
}

// acc + sqrt(pi) Re w alpha / (pi D) in region I, one reciprocal.  With
// a = z^2 - 1/2 = (x^2 - c0, 2 x y), w = (i / sqrt(pi)) z / a gives
// sqrt(pi) Re w = Re(i z conj(a)) / |a|^2 = y (x^2 + c0) / ((x^2 - c0)^2
// + 4 y^2 x^2), so the step is acc + (x^2 s1 + c0 s1) / |a|^2.  |a|^2 ~
// x^4: float32 stays finite to |x| ~ 4e9.
template <typename T>
__device__ __forceinline__ T add_region1(T acc, T x, const Line<T>& l) {
  const T xx = mul_rn(x, x);
  const T t = sub_rn(xx, l.c0);
  const T r = recip(fma_rn(t, t, mul_rn(l.k4, xx)));
  return fma_rn(fma_rn(xx, l.s1, l.c0s1), r, acc);
}

template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// Re(a / b) with one reciprocal of |b|^2
template <typename T>
__device__ __forceinline__ T cdiv_re(T ar, T ai, T br, T bi) {
  return (ar * br + ai * bi) * recip(br * br + bi * bi);
}

// sqrt(pi) Re w(x + iy) for |x| + y <= 15, Humlicek w4 regions II-IV: the
// regions and operation order of stardis_tpu_torch/opacities/voigt.py:
// faddeeva_real, 1/sqrt(pi) as a product, each quotient by one reciprocal.
// Not inlined: one body for every call site, its registers outside the
// region-I loop.
template <typename T>
__device__ __noinline__ T core_sqrtpi_re_w(T x, T y) {
  const T inv_sqrt_pi = T(1.0 / SQRT_PI);
  const T s = fabs(x) + y;
  T z2r, z2i;
  cmul(x, y, x, y, z2r, z2i);
  T re;
  if (s > T(5.5)) {  // region II
    const T ar = z2r * inv_sqrt_pi - T(1.4104739589), ai = z2i * inv_sqrt_pi;
    T nr, ni;
    cmul(x, y, ar, ai, nr, ni);
    const T mr = -ni, mi = nr;  // multiply by i
    T dr, di;
    cmul(z2r, z2i, z2r - T(3.0), z2i, dr, di);
    re = cdiv_re(mr, mi, T(0.75) + dr, di);
  } else {
    const T tr = y, ti = -x;
    if (y >= T(0.195) * fabs(x) - T(0.176)) {  // region III
      const T p[5] = {T(0.5642236), T(3.778987), T(11.96482), T(20.20933), T(16.4955)};
      const T q[6] = {T(1.0), T(6.699398), T(21.69274), T(39.27121), T(38.82363),
                      T(16.4955)};
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
      re = cdiv_re(pr, pi, qr, qi);
    } else {  // region IV: w = exp(u) - t P(u)/Q(u), u = t^2
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
      T nr, ni;
      cmul(tr, ti, -pr, -pi, nr, ni);
      T qr = q[0], qi = T(0);
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        T r, i;
        cmul(qr, qi, ur, ui, r, i);
        qr = r + q[k];
        qi = i;
      }
      re = exp(fmin(ur, T(60.0))) * cos(ui) - cdiv_re(nr, ni, qr, qi);
    }
  }
  return re * T(SQRT_PI);
}

// [cl, ch) = [c - k, c + k) around centre pixel c holding every pixel of
// regions II-IV: with grid[c - 1] >= nu >= grid[c] (line_center_indices)
// and every grid step at least step_min, a pixel k or more from the centre
// has |grid[p] - nu| >= k step_min, so |x| + y > 15 once k step_min / D
// > 15 - y.  k carries a relative margin of 1e-5 and two pixels, far
// beyond the rounding of x and of the offsets, so the guard only ever
// errs wide: a pixel inside it goes through the per-pixel test.
template <typename T>
__device__ __forceinline__ int core_guard(T y, T dop, T step_min) {
  const T reach = (T(15.0) - y) * dop / step_min * T(1.00001);
  return (int)ceil(fmin(fmax(reach, T(0)), T(1 << 30))) + 2;
}

// whether line l's window covers the span [ws, we) and the span lies
// outside the line's core guard: then every pixel of it is in the window
// and in region I
template <typename T>
__device__ __forceinline__ bool fast(const Line<T>& l, int ws, int we) {
  return l.lo <= ws && l.hi >= we && (ws >= l.ch || we <= l.cl);
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
__global__ void __launch_bounds__(THREADS)
line_opacity_kernel(const T* __restrict__ grid, const T* __restrict__ line_nu,
                    const int* __restrict__ center, const T* __restrict__ alpha,
                    const T* __restrict__ gamma, const T* __restrict__ doppler,
                    const int* __restrict__ iw, const int* __restrict__ iw_max,
                    T step_min, T* __restrict__ out, int n_lines, int n_tiles, int p_begin,
                    int n_out) {
  __shared__ Line<T> s_line[SPLIT][CHUNK];
  __shared__ T s_part[SPLIT][PIXELS][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bd = blockIdx.x / n_tiles;  // row of this (model, depth)
  const int tile = blockIdx.x - (int)bd * n_tiles;
  const int p_end = p_begin + n_out;     // global pixels of this launch: [p_begin, p_end)
  const int ws = p_begin + tile * SPAN;  // the block's span [ws, we)
  const int we = min(ws + SPAN, p_end);
  const int w = iw_max[bd];
  // a line reaches the span iff its centre lies in (ws - w, we - 1 + w]
  const int l_begin = first_at_or_below(center, n_lines, we - 1 + w);
  const int l_end = first_at_or_below(center, n_lines, ws - w);
  const int l_first = l_begin + ((warp - l_begin % SPLIT) + SPLIT) % SPLIT;  // this warp's lines

  T g[PIXELS], acc[PIXELS];
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) {
    g[k] = grid[min(ws + 32 * k + lane, we - 1)];  // past the range: a copy, never written
    acc[k] = T(0);
  }
  const long long row = bd * n_lines;
  Line<T>* s = s_line[warp];

  for (int l0 = l_first; l0 < l_end; l0 += CHUNK * SPLIT) {
    const int n = min(CHUNK, (l_end - l0 + SPLIT - 1) / SPLIT);
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      const int l = l0 + SPLIT * j;
      const int c = center[l], half = iw[row + l];
      const T dop = doppler[row + l];
      Line<T> rec;
      rec.lo = c - half;
      rec.hi = c + half;
      rec.nu = line_nu[l];
      rec.inv = T(1) / dop;
      rec.y = gamma[row + l] / T(SQRT_PI * PI) / dop;
      const int k = core_guard(rec.y, dop, step_min);
      rec.cl = c - k;
      rec.ch = c + k;
      rec.c0 = rec.y * rec.y + T(0.5);
      rec.k4 = T(4) * rec.y * rec.y;
      rec.scale = alpha[row + l] / (T(PI) * dop);
      rec.s1 = rec.y * rec.scale;
      rec.c0s1 = rec.c0 * rec.s1;
      s[j] = rec;
    }
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      if (s[i].hi <= ws || s[i].lo >= we) continue;  // the window misses the span
      const Line<T> a = s[i];
      if (fast(a, ws, we)) {
        if (i + 1 < n && fast(s[i + 1], ws, we)) {
          // two lines at once: their evaluations overlap, the sums keep
          // the line order
          const Line<T> b = s[++i];
#pragma unroll
          for (int k = 0; k < PIXELS; ++k)
            acc[k] = add_region1(add_region1(acc[k], x_of(g[k], a.nu, a.inv), a),
                                 x_of(g[k], b.nu, b.inv), b);
        } else {
#pragma unroll
          for (int k = 0; k < PIXELS; ++k)
            acc[k] = add_region1(acc[k], x_of(g[k], a.nu, a.inv), a);
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < PIXELS; ++k) {  // the test per pixel
        const int p = ws + 32 * k + lane;
        if (p >= a.lo && p < a.hi) {
          const T x = x_of(g[k], a.nu, a.inv);
          acc[k] = fabs(x) + a.y > T(15.0)
                       ? add_region1(acc[k], x, a)
                       : fma_rn(core_sqrtpi_re_w(x, a.y), a.scale, acc[k]);
        }
      }
    }
  }
  // the warps' sums added in warp order
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) s_part[warp][k][lane] = acc[k];
  __syncthreads();
  if (warp != 0) return;
  T* orow = out + bd * n_out - p_begin;  // indexed by global pixel
#pragma unroll
  for (int k = 0; k < PIXELS; ++k) {
    const int p = ws + 32 * k + lane;
    T sum = acc[k];
#pragma unroll
    for (int v = 1; v < SPLIT; ++v) sum = add_rn(sum, s_part[v][k][lane]);
    if (p < we) orow[p] = sum;
  }
}

template <typename T>
int launch(const T* grid, const T* line_nu, const int* center, const T* alpha,
           const T* gamma, const T* doppler, const int* iw, const int* iw_max,
           double step_min, T* out, int n_models, int n_lines, int n_depth, int p_begin,
           int n_out, cudaStream_t stream) {
  const int n_tiles = (n_out + SPAN - 1) / SPAN;
  const long long n_blocks = (long long)n_tiles * n_models * n_depth;
  if (n_out <= 0 || n_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  line_opacity_kernel<T><<<(unsigned)n_blocks, THREADS, 0, stream>>>(
      grid, line_nu, center, alpha, gamma, doppler, iw, iw_max, T(step_min), out, n_lines,
      n_tiles, p_begin, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: [n_nu], the global grid; line_nu, center: [n_lines]; alpha, gamma,
// doppler, iw: [n_models, n_depth, n_lines] row-major; iw_max: [n_models,
// n_depth]; step_min: the grid's smallest step grid[p - 1] - grid[p] (> 0;
// +inf for one point); out: [n_models, n_depth, n_out], pixels [p_begin,
// p_begin + n_out) of the grid.
#define LINE_OPACITY_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const T* grid, const T* line_nu, const int* center, const T* alpha, \
                      const T* gamma, const T* doppler, const int* iw, const int* iw_max, \
                      double step_min, T* out, int n_models, int n_lines, int n_depth,    \
                      int p_begin, int n_out, void* stream) {                             \
    return launch<T>(grid, line_nu, center, alpha, gamma, doppler, iw, iw_max, step_min,  \
                     out, n_models, n_lines, n_depth, p_begin, n_out,                     \
                     (cudaStream_t)stream);                                               \
  }

LINE_OPACITY_ENTRY(line_opacity_f32, float)
LINE_OPACITY_ENTRY(line_opacity_f64, double)

// pixels per block: the span whose line range one binary search selects
extern "C" int line_opacity_span_pixels(void) { return SPAN; }

extern "C" const char* line_opacity_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
