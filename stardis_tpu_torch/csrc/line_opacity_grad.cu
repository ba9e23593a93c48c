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
//   S_w = sum g Re w,  S_y = sum g dRe w/dy,
//   S_D = sum g (Re w + x dRe w/dx + y dRe w/dy),
// and then dL/dalpha = S_w / (sqrt(pi) D), dL/dgamma = alpha S_y /
// (sqrt(pi) pi D) / (sqrt(pi) D), dL/dD = -alpha S_D / (sqrt(pi) D) / D
// (opacities/line_kernel.py:_line_grad_finish, the same operations in the
// same order).  S_D is summed as one quantity: its three terms cancel at
// leading order in the far wing (y/x^2 - 2 y/x^2 + y/x^2), where summing
// them separately loses ~2 log10 |x| digits.
//
// Replaces what the JAX package gets from jax.vjp / jax.grad of its line
// sum: the transpose of accumulate_line_opacity_blocked
// (stardis_tpu/opacities/line_kernel.py:1049, and the range program
// accumulate_pairs_blocked, :1316) through the Humlicek w4 chain
// (stardis_tpu/opacities/voigt.py:38-151).
//
// The derivatives are those of the rational formula each Humlicek region
// evaluates (region I where |x| + y > 15, else the full chain, as Kernel 1
// selects), not the identity w' = -2zw + 2i/sqrt(pi), which holds only for
// the true Faddeeva function.
//
// What bounds it on the H100: the arithmetic of the in-window evaluations
// (1.7e10 at Sim100AA, 98.5 % of them in region I; 2.6e12 at the 1M-pixel
// flagship).  Memory traffic is the [B, D, L] line arrays once and the
// grid and g, which every tile of lines rereads.  The design:
//
// 1. One division per in-window evaluation.  Per pair the block hoists nu,
//    1/D and y, so x = (grid[p] - nu) * (1/D).  Region I, w = (i/sqrt(pi))
//    z / a with a = z^2 - 1/2, takes one reciprocal of |a|^2 and forms
//    q = conj(a) / |a|^2 = 1/a; then sqrt(pi) Re w = Re(i z q),
//    sqrt(pi) W = -i (q + q^2) (W = dw/dz, since a q = 1; dRe w/dx = Re W,
//    dRe w/dy = -Im W), and the combination of S_D, Re(w + z W), is
//    Im(z q^2) / sqrt(pi).  q and q^2 stay near 1/x^2 and 1/x^4, so float32
//    stays finite to |x| ~ 4e9 (|a|^2 ~ x^4), where the old quotient
//    sqrt(pi) |a|^4 overflowed at |x| ~ 6e4; beyond it every term rounds
//    to 0.  The factor sqrt(pi) leaves the pixel loop: the finishing pass
//    multiplies each window sum by 1/sqrt(pi) once.  Regions II-IV (1.5 %
//    of the evaluations) keep their chain (core_grad, not inlined), each
//    complex quotient by one reciprocal, and region II's S_D term in closed
//    form too (its three terms cancel by ~|z|^2).  A warp whose pixels of
//    one line in one chunk all lie in region I (both ends on one side of
//    the line centre, the nearer one with |x| + y > 15; x is monotone in p)
//    runs a loop without the region test, which is exact: it is the same
//    selection.
// 2. Operands from shared memory.  A block owns one (model, depth) and a
//    tile of TILE = 32 consecutive lines (sorted by frequency, so their
//    windows overlap).  It walks the tile's union span in chunks of 8 KB
//    per operand (2048 pixels in float32, 1024 in float64), staging
//    grid[chunk] and g[b, d, chunk] into shared memory with cp.async,
//    double-buffered (chunk k + 1 loads while chunk k is summed).  Within a
//    chunk each line's pixels form rows of 32, lanes on consecutive pixels;
//    the rows of all 32 lines, listed line by line, are cut into 8
//    contiguous equal shares, one per warp, so the warps stay busy whatever
//    the spread of window lengths in the tile (they vary with line strength
//    by orders of magnitude).
// 3. A fixed-order split.  The host-side schedule (line_kernel.py:
//    line_grad_schedule, torch ops) cuts each tile's span into splits of
//    split_pixels (a multiple of the chunk, chosen so that a launch has at
//    most ~2^16 splits: fewer, longer blocks measured faster than 2^13 or
//    2^19 at Sim100AA) and lists the splits tile by tile; one block takes
//    one split (a "unit").  Each lane sums its pixels of a line's rows
//    serially; a fixed shuffle tree adds the lanes; the warps' sums of a
//    chunk are added warp by warp, and the chunks' in chunk order, into the
//    line's three split sums, written to scratch[unit, 3, TILE].  A second
//    pass (line_opacity_grad_finish_kernel), one thread per (model, depth,
//    line), adds its tile's units in split order and finishes the pair.
//    No atomics: two launches are equal bit for bit.
//
// Measured on an H100 (PERF.md): ~2x its operation bound at Sim100AA, the
// regions II-IV chain taking about a fifth of the time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;    // lines per block; must match line_kernel.LINE_GRAD_TILE
// pixels staged at a time: 8 KB of each operand per buffer (2048 in float32,
// 1024 in float64); line_kernel.line_grad_chunk
template <typename T>
__host__ __device__ constexpr int chunk_pixels() {
  return 8192 / (int)sizeof(T);
}
constexpr double SQRT_PI = 1.7724538509055159;
constexpr double PI = 3.141592653589793;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// float32: the hardware reciprocal (MUFU.RCP, within 1 ulp), float64: exact
__device__ __forceinline__ float recip(float v) { return __fdividef(1.0f, v); }
__device__ __forceinline__ double recip(double v) { return 1.0 / v; }

// a / b with one reciprocal of |b|^2
template <typename T>
__device__ __forceinline__ void cdiv(T ar, T ai, T br, T bi, T& cr, T& ci) {
  const T r = recip(br * br + bi * bi);
  cr = (ar * br + ai * bi) * r;
  ci = (ai * br - ar * bi) * r;
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

// region I with one reciprocal: writes sqrt(pi) Re w, sqrt(pi) dRe w/dy
// (wy) and sqrt(pi) (Re w + x dRe w/dx + y dRe w/dy) (wd).  c0 = y^2 + 1/2,
// y2 = 2 y.  With a = z^2 - 1/2 and q = 1/a: sqrt(pi) w = i z q, and since
// a q = 1, sqrt(pi) W = -i (a + 1) q^2 = -i (q + q^2), so dRe w/dy = -Im W
// = Re(q + q^2) / sqrt(pi) and Re(w + z W) = Im(z q^2) / sqrt(pi).
template <typename T>
__device__ __forceinline__ void region1(T x, T y, T c0, T y2, T& re, T& wy, T& wd) {
  const T ar = x * x - c0, ai = x * y2;
  const T r = recip(ar * ar + ai * ai);
  const T qr = ar * r, qi = -ai * r;  // q = conj(a) / |a|^2
  const T q2r = qr * qr - qi * qi, q2i = T(2) * qr * qi;
  re = -(x * qi + y * qr);  // Re(i z q)
  wy = qr + q2r;
  wd = x * q2i + y * q2r;  // Im(z q^2)
}

// regions II-IV (|x| + y <= 15): Re w and its x, y derivatives, the same
// formulas as stardis_tpu_torch/opacities/voigt.py:faddeeva_real_grad (each
// complex quotient by one reciprocal, 1/sqrt(pi) as a product), returned as
// region1's three values; the combination Re w + x dRe w/dx + y dRe w/dy
// in closed form in region II, term by term in III and IV (|z| < 5.5).
// Not inlined: its registers stay out of the region-I loop.
template <typename T>
__device__ __noinline__ void core_grad(T x, T y, T& re_out, T& wy_out, T& wd_out) {
  const T sqrt_pi = T(SQRT_PI), inv_sqrt_pi = T(1.0 / SQRT_PI);
  const T s = fabs(x) + y;
  T z2r, z2i;
  cmul(x, y, x, y, z2r, z2i);
  T re, dx, dy;
  if (s > T(5.5)) {  // region II: W = (N' - w D') / D
    const T k2 = T(1.4104739589);
    const T ar = z2r * inv_sqrt_pi - k2, ai = z2i * inv_sqrt_pi;
    T nr, ni;
    cmul(x, y, ar, ai, nr, ni);
    const T mr = -ni, mi = nr;  // multiply by i
    T dr, di;
    cmul(z2r, z2i, z2r - T(3.0), z2i, dr, di);
    dr = T(0.75) + dr;
    T wr, wi;
    cdiv(mr, mi, dr, di, wr, wi);
    const T npr = -(T(3.0) * z2i * inv_sqrt_pi), npi = T(3.0) * z2r * inv_sqrt_pi - k2;
    T dpr, dpi, er, ei, gr, gi;
    cmul(T(2.0) * x, T(2.0) * y, T(2.0) * z2r - T(3.0), T(2.0) * z2i, dpr, dpi);
    cmul(wr, wi, dpr, dpi, er, ei);
    cdiv(npr - er, npi - ei, dr, di, gr, gi);
    // Re(w + z W) in closed form: i z (c5 z^4 + c3 z^2 + c1) / D^2 (the
    // z^7 terms of (N + z N') D - z N D' cancel exactly; summed term by
    // term the three values cancel by ~|z|^2; voigt.py:
    // faddeeva_real_region2_euler)
    const T c5 = T(2.0 * 1.4104739589 - 6.0 / SQRT_PI), c3 = T(3.0 / SQRT_PI);
    T pr = c5 * z2r + c3, pi = c5 * z2i, tr, ti;
    cmul(pr, pi, z2r, z2i, tr, ti);
    tr -= T(1.5 * 1.4104739589);
    cmul(x, y, tr, ti, pr, pi);
    T d2r, d2i, er2, ei2;
    cmul(dr, di, dr, di, d2r, d2i);
    cdiv(-pi, pr, d2r, d2i, er2, ei2);
    re_out = wr * sqrt_pi;
    wy_out = -gi * sqrt_pi;
    wd_out = er2 * sqrt_pi;
    return;
  } else if (y >= T(0.195) * fabs(x) - T(0.176)) {  // region III: w = P(t)/Q(t)
    const T tr = y, ti = -x;
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
  } else {
    // region IV: w = exp(u) - t r(u), r = P/Q, u = t^2;
    // dw/dt = 2 t exp(u) - r - 2 u r', r' = (P' - r Q') / Q
    const T tr = y, ti = -x;
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
  re_out = re * sqrt_pi;
  wy_out = dy * sqrt_pi;
  wd_out = (re + x * dx + y * dy) * sqrt_pi;
}

// stage pixels [c0, c1) of the grid and of this (model, depth)'s row of g
// into one shared buffer, asynchronously
template <typename T>
__device__ __forceinline__ void stage(T* s_grid, T* s_g, const T* __restrict__ grid,
                                      const T* __restrict__ grow, int c0, int c1) {
  for (int i = threadIdx.x; i < c1 - c0; i += THREADS) {
    __pipeline_memcpy_async(s_grid + i, grid + c0 + i, sizeof(T));
    __pipeline_memcpy_async(s_g + i, grow + c0 + i, sizeof(T));
  }
  __pipeline_commit();
}

// sums of one warp over pixels [pa, pb) of one line, lane l on pixels
// pa + l, pa + l + 32, ...; sgr, sgg are the staged grid and g, indexed by
// pixel
template <typename T>
__device__ __forceinline__ void line_sums(const T* sgr, const T* sgg, int pa, int pb, T nu,
                                          T inv, T y, int lane, T& aw, T& ay, T& ad) {
  const T c0y = y * y + T(0.5), y2 = T(2) * y;
  const T xa = (sgr[pa] - nu) * inv, xb = (sgr[pb - 1] - nu) * inv;
  if ((xa > T(0)) == (xb > T(0)) && fmin(fabs(xa), fabs(xb)) + y > T(15.0)) {
    for (int p = pa + lane; p < pb; p += 32) {  // every pixel in region I
      const T x = (sgr[p] - nu) * inv;
      T re, wy, wd;
      region1(x, y, c0y, y2, re, wy, wd);
      const T gp = sgg[p];
      aw += gp * re;
      ay += gp * wy;
      ad += gp * wd;
    }
  } else {
    for (int p = pa + lane; p < pb; p += 32) {
      const T x = (sgr[p] - nu) * inv;
      T re, wy, wd;
      if (fabs(x) + y > T(15.0)) {
        region1(x, y, c0y, y2, re, wy, wd);
      } else {
        core_grad(x, y, re, wy, wd);
      }
      const T gp = sgg[p];
      aw += gp * re;
      ay += gp * wy;
      ad += gp * wd;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_opacity_grad_kernel(const T* __restrict__ grid, const T* __restrict__ line_nu,
                         const int* __restrict__ center, const T* __restrict__ gamma,
                         const T* __restrict__ doppler, const int* __restrict__ iw,
                         const T* __restrict__ g, const int* __restrict__ tile_lo,
                         const int* __restrict__ tile_hi, const int* __restrict__ tile_start,
                         const int* __restrict__ unit_tile, T* __restrict__ scratch,
                         int n_lines, int n_tiles, int n_nu, int p_begin, int n_out,
                         int split_pixels) {
  constexpr int CHUNK = chunk_pixels<T>();
  __shared__ T s_grid[2][CHUNK];
  __shared__ T s_g[2][CHUNK];
  __shared__ int s_lo[TILE], s_hi[TILE];
  __shared__ T s_nu[TILE], s_inv[TILE], s_y[TILE];
  __shared__ int s_row[TILE + 1];       // first 32-pixel row of each line in the chunk
  __shared__ T s_part[WARPS][3][TILE];  // each warp's sums of the chunk, by line
  __shared__ T s_acc[3][TILE];          // the split's sums, by line

  const int unit = blockIdx.x;
  const int tf = unit_tile[unit];  // (model, depth) * n_tiles + tile
  const long long bd = tf / n_tiles;
  const int l0 = (tf % n_tiles) * TILE;
  const int split = unit - tile_start[tf];
  const int s0 = tile_lo[tf] + split * split_pixels;
  const int s1 = min(s0 + split_pixels, tile_hi[tf]);
  // g's row holds pixels [p_begin, p_begin + n_out): index it by pixel
  const T* grow = g + bd * n_out - p_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < TILE) {
    const int j = threadIdx.x, l = l0 + j;
    int lo = 0, hi = 0;
    T nu = T(0), inv = T(0), y = T(0);
    if (l < n_lines) {
      const long long pair = bd * n_lines + l;
      const int c = center[l], half = iw[pair];
      lo = max(max(c - half, p_begin), 0);
      hi = min(min(c + half, p_begin + n_out), n_nu);
      const T dop = doppler[pair];
      nu = line_nu[l];
      inv = T(1) / dop;
      y = gamma[pair] / T(SQRT_PI * PI) / dop;
    }
    s_lo[j] = lo;
    s_hi[j] = hi;
    s_nu[j] = nu;
    s_inv[j] = inv;
    s_y[j] = y;
  }
  for (int i = threadIdx.x; i < WARPS * 3 * TILE; i += THREADS) (&s_part[0][0][0])[i] = T(0);
  if (threadIdx.x < 3 * TILE) (&s_acc[0][0])[threadIdx.x] = T(0);
  const int n_chunks = (s1 - s0 + CHUNK - 1) / CHUNK;
  stage(s_grid[0], s_g[0], grid, grow, s0, min(s0 + CHUNK, s1));
  __syncthreads();

  for (int ck = 0; ck < n_chunks; ++ck) {
    const int c0 = s0 + ck * CHUNK, c1 = min(c0 + CHUNK, s1);
    const int buf = ck & 1;
    if (ck + 1 < n_chunks) {
      stage(s_grid[buf ^ 1], s_g[buf ^ 1], grid, grow, c1, min(c1 + CHUNK, s1));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    if (warp == 0) {  // rows of each line's window within the chunk, prefix-summed
      const int n = max(min(s_hi[lane], c1) - max(s_lo[lane], c0), 0);
      int r = (n + 31) >> 5;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, r, off);
        if (lane >= off) r += v;
      }
      s_row[lane + 1] = r;
      if (lane == 0) s_row[0] = 0;
    }
    __syncthreads();
    // warp w takes the contiguous rows [w R / WARPS, (w + 1) R / WARPS)
    const int n_rows = s_row[TILE];
    const int r0 = warp * n_rows / WARPS, r1 = (warp + 1) * n_rows / WARPS;
    const T* sgr = s_grid[buf] - c0;
    const T* sgg = s_g[buf] - c0;
    int j = 0;
    while (j < TILE && s_row[j + 1] <= r0) ++j;
    for (int r = r0; r < r1; ++j) {
      const int rows_end = min(r1, s_row[j + 1]);
      const int a = max(s_lo[j], c0), b = min(s_hi[j], c1);
      const int pa = a + 32 * (r - s_row[j]), pb = min(a + 32 * (rows_end - s_row[j]), b);
      r = rows_end;
      if (pa >= pb) continue;  // a line with no pixel in the chunk
      T aw = T(0), ay = T(0), ad = T(0);
      line_sums(sgr, sgg, pa, pb, s_nu[j], s_inv[j], s_y[j], lane, aw, ay, ad);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        aw += __shfl_down_sync(FULL, aw, off);
        ay += __shfl_down_sync(FULL, ay, off);
        ad += __shfl_down_sync(FULL, ad, off);
      }
      if (lane == 0) {
        s_part[warp][0][j] = aw;
        s_part[warp][1][j] = ay;
        s_part[warp][2][j] = ad;
      }
    }
    __syncthreads();
    if (threadIdx.x < 3 * TILE) {  // the chunk's sums, warp by warp in order
      const int k = threadIdx.x / TILE, jj = threadIdx.x % TILE;
      T sum = s_acc[k][jj];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sum += s_part[w][k][jj];
        s_part[w][k][jj] = T(0);
      }
      s_acc[k][jj] = sum;
    }
    // the next chunk's barrier orders these before s_part is written again
    // and before this buffer is restaged
  }
  __syncthreads();
  if (threadIdx.x < 3 * TILE)
    scratch[(long long)unit * 3 * TILE + threadIdx.x] = (&s_acc[0][0])[threadIdx.x];
}

// second pass: one thread per (model, depth, line) adds its tile's units in
// split order and finishes the pair as _line_grad_finish does
template <typename T>
__global__ void __launch_bounds__(THREADS)
line_opacity_grad_finish_kernel(const T* __restrict__ alpha, const T* __restrict__ doppler,
                                const int* __restrict__ tile_start,
                                const T* __restrict__ scratch, T* __restrict__ g_alpha,
                                T* __restrict__ g_gamma, T* __restrict__ g_doppler,
                                long long n_pairs, int n_lines, int n_tiles) {
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (pair >= n_pairs) return;
  const int l = (int)(pair % n_lines);
  const long long tf = pair / n_lines * n_tiles + l / TILE;
  const int j = l % TILE;
  T aw = T(0), ay = T(0), ad = T(0);
  for (int u = tile_start[tf]; u < tile_start[tf + 1]; ++u) {
    const T* part = scratch + (long long)u * 3 * TILE;
    aw += part[j];
    ay += part[TILE + j];
    ad += part[2 * TILE + j];
  }
  const T inv_sqrt_pi = T(1.0 / SQRT_PI);
  const T s_w = aw * inv_sqrt_pi, s_y = ay * inv_sqrt_pi, s_d = ad * inv_sqrt_pi;
  const T dop = doppler[pair], a = alpha[pair];
  const T inv = T(1) / (T(SQRT_PI) * dop);
  g_alpha[pair] = s_w * inv;
  g_gamma[pair] = a * s_y / T(SQRT_PI * PI) / dop * inv;
  g_doppler[pair] = -a * s_d * inv / dop;
}

template <typename T>
int launch(const T* grid, const T* line_nu, const int* center, const T* alpha,
           const T* gamma, const T* doppler, const int* iw, const T* g, T* g_alpha,
           T* g_gamma, T* g_doppler, const int* tile_lo, const int* tile_hi,
           const int* tile_start, const int* unit_tile, T* scratch, int n_models,
           int n_lines, int n_depth, int p_begin, int n_out, int n_nu, int n_units,
           int split_pixels, int tile, int chunk, cudaStream_t stream) {
  if (tile != TILE || chunk != chunk_pixels<T>() || split_pixels % chunk != 0 ||
      split_pixels <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_lines + TILE - 1) / TILE;
  if (n_units > 0) {
    line_opacity_grad_kernel<T><<<n_units, THREADS, 0, stream>>>(
        grid, line_nu, center, gamma, doppler, iw, g, tile_lo, tile_hi, tile_start,
        unit_tile, scratch, n_lines, n_tiles, n_nu, p_begin, n_out, split_pixels);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_pairs = (long long)n_models * n_depth * n_lines;
  const unsigned blocks = (unsigned)((n_pairs + THREADS - 1) / THREADS);
  line_opacity_grad_finish_kernel<T><<<blocks, THREADS, 0, stream>>>(
      alpha, doppler, tile_start, scratch, g_alpha, g_gamma, g_doppler, n_pairs, n_lines,
      n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: [n_nu] (the global grid, n_nu = its length); line_nu, center:
// [n_lines]; alpha, gamma, doppler, iw: [n_models, n_depth, n_lines]
// row-major; g: [n_models, n_depth, n_out], the gradient of pixels
// [p_begin, p_begin + n_out); g_alpha, g_gamma, g_doppler: outputs shaped
// as alpha.  The schedule (line_kernel.py:line_grad_schedule): tile_lo,
// tile_hi: [n_models * n_depth * n_tiles] union span of each tile's
// windows cut to the range; tile_start: [.. + 1] first unit of each tile;
// unit_tile: [n_units] the tile of each unit; scratch: [n_units, 3, tile];
// tile and chunk must equal the compiled TILE and chunk_pixels<T>().
#define LINE_GRAD_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const T* grid, const T* line_nu, const int* center, const T* alpha, \
                      const T* gamma, const T* doppler, const int* iw, const T* g,        \
                      T* g_alpha, T* g_gamma, T* g_doppler, const int* tile_lo,           \
                      const int* tile_hi, const int* tile_start, const int* unit_tile,    \
                      T* scratch, int n_models, int n_lines, int n_depth, int p_begin,    \
                      int n_out, int n_nu, int n_units, int split_pixels, int tile,       \
                      int chunk, void* stream) {                                          \
    return launch<T>(grid, line_nu, center, alpha, gamma, doppler, iw, g, g_alpha,        \
                     g_gamma, g_doppler, tile_lo, tile_hi, tile_start, unit_tile,         \
                     scratch, n_models, n_lines, n_depth, p_begin, n_out, n_nu, n_units,  \
                     split_pixels, tile, chunk, (cudaStream_t)stream);                    \
  }

LINE_GRAD_ENTRY(line_opacity_grad_f32, float)
LINE_GRAD_ENTRY(line_opacity_grad_f64, double)

extern "C" const char* line_opacity_grad_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
