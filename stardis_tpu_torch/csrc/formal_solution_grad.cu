// Backward of the formal solution on Hopper (sm_90a), Kernel 2b: the
// gradients of F_nu (and of I_nu, when the caller tracks it) with respect
// to the total extinction alpha and the source S, plane-parallel
// (outward) or spherical (inward-sweep) variant.
//
// Replaces what the JAX package gets from jax.vjp of raytrace
// (stardis_tpu/radiation_field/solver.py:186): the transposed associative
// scan of the depth recurrence, the weights (:40), the log-midpoint tau
// (:174), and the spherical inward sweep (:98-134).
//
// Kernel 2 (formal_solution.cu) runs, per ray (model b, frequency n, angle
// t), the recurrence I_{k+1} = f_k(I_k) = (1 - w0_k) I_k + w0_k S_{k+1} +
// second_k + third_k over the gaps k = 0 .. G-1 (the last gap with the
// constant-source jump), from I_0 = 0 or, spherical, from the inward
// sweep's result; then F[d] = corr_b sum_t w_t I_t[d].  Its forward keeps
// no intensity for this kernel: the sweeps are recomputed here.
//
// Design: Kernel 2's tile.  One block owns F frequencies of one model and
// all T angles, one thread per (frequency, angle), theta the fastest index.
//  * Staged in shared memory once per block: the mean extinction of each
//    gap m[g][f] = exp(0.5 (ln a_{g+1} + ln a_g)) (the expression and order
//    of Kernel 2 and of the JAX package's compute_taus, so tau = m ray has
//    the same bits as a per-ray tau), the source S[d][f], dLoss/dF_nu
//    gF[d][f], the chords ray[g][t] and the theta weights.  A step forms
//    tau with one product, not two logs and an exp.
//  * The forward is recomputed with Kernel 2's steps in Kernel 2's order,
//    so its intensity equals Kernel 2's bit for bit: the inward sweep
//    (spherical), then the outward sweep.  The outward variant keeps the
//    intensity entering every interior gap in shared memory, [G-1][F][T]
//    (35 KB in float32 at F = 8, T = 20), where a block of one frequency
//    can hold it.  The inward variant, and the outward one at more depths,
//    keep only a checkpoint every SPAN steps of each sweep (SPAN comes from
//    the build, -DSPAN); their reverse sweeps recompute one segment of SPAN
//    steps at a time from its checkpoint into a [SPAN][F][T] buffer and
//    walk back through it.  A step restarted at a
//    checkpoint forms the third term's carried quotient afresh, its exact
//    negation, so the segments have the forward's bits.
//  * The reverse outward sweep: lambda = dLoss/dI starts at the seed
//    (w_t corr) gF[d] + gI[d, t] of the surface, and for k = G-1 .. 0 the
//    step's adjoint adds into dLoss/d{tau_k, tau_{k+1}, S_k, S_{k+1},
//    S_{k+2}} and lambda <- seed[k] + lambda (1 - w0_k) (lambda when the
//    step passed I through).  tau_k = exp((ln a_k + ln a_{k+1})/2) ds_k, so
//    dtau_k/da = tau_k/(2a): per gap the ray has q_k = tau_bar_k tau_k / 2.
//  * Spherical only: the reverse inward sweep, g = 0 .. G-1 (the forward
//    ran G-1 .. 0), from lambda at I_0, with the reference's wrap at g = 0
//    (tau[g-1] is tau[G-1] and S[g-1] is S[G], so their gradients land on
//    those elements).
//  * The theta sums are fused: alpha_bar[d] = sum_t (q_d + q_{d-1}) / alpha_d
//    and S_bar[d] = sum_t S_bar_t[d], theta in order from 0, one thread per
//    (depth, frequency), each output written once (no atomics: two
//    launches are equal bit for bit).  A depth's q_d + q_{d-1} and S_bar
//    are final one reverse step after its lower gap's, so each ray hands
//    them to a double-buffered shared chunk of depths, summed after one
//    barrier a chunk, as in Kernel 2: outward from the surface down; inward
//    the outward reverse's sums per (depth, frequency) wait in shared memory
//    [2][D][F], and the inward reverse's, handed on from the centre up, are
//    added to them.  Nothing of size [B, D, N, T] is read or written in
//    device memory.
//  * The steps are serial and latency-bound (the divisions' and the exp's
//    latencies are hidden only by other warps), so the tile is sized by
//    the warps an SM keeps: the outward block of 8 frequencies x 20 angles
//    holds 55 KB (4 blocks, 20 warps an SM); inward, where two sweeps'
//    partial sums would need [D][F][T] twice more, the checkpoints and the
//    per-(depth, frequency) sums bring a block to 38 KB (5 blocks, 61
//    registers a thread).
//  * Each adjoint step takes one reciprocal each of safe(a), safe(b) and
//    safe(a + b), and the weights' exp once for the weights and their
//    derivative.
//
// Bits.  The outward variant sums as the first design did (per-ray partials
// q_d + q_{d-1}, then theta); its values differ from that kernel's by the
// reciprocals (a few ulp of a step's terms).  The inward variant sums the
// outward and the inward reverse's contributions over theta apart and adds
// the two sums.
//
// What the adjoint must get right:
//  * a zero chord (tau_k = 0, or tau[g-1] = 0 in the inward sweep) passes
//    the intensity through, so it passes lambda through and gives nothing
//    to its tau or S; safe(tau) (1 where tau = 0) has derivative 0 there,
//    as the plain version's torch.where gives;
//  * the weights' three regimes: the Taylor polynomials below 5e-4, zero
//    derivative when saturated (tau >= 50), and exp(-tau) in between, where
//    d/dtau of (w0, w1, w2) is e (1, tau, tau^2): written analytically here,
//    while autograd of the plain version sums w1 = w0 - tau e's cancelling
//    terms;
//  * rounding: built with -fmad=false (_cuda.KERNEL_FLAGS), like Kernel 2,
//    so the recomputed sweeps are bit-identical to the forward's.
//
// What bounds it on the H100: the latency of each ray's serial steps, not
// the bytes.  Untracked it reads alpha, source and dLoss/dF_nu and writes
// the two gradients once (5 [B, D, N] planes, 11 MB at 56 depths x 10k nu:
// 3 us at 3.35 TB/s); dLoss/dI_nu, when tracked, is read once.  Per gap an
// outward ray runs one recomputed forward step and one reverse step; an
// inward ray four forward steps (each sweep twice) and two reverse steps,
// each with the weights' exp and IEEE divisions.  Measured on an H100
// (PERF.md): 0.19 ms at Sim100AA and 0.63 ms at the giant, against 0.31
// and 0.95 ms for the first design, which read the saved intensity and
// wrote and reread two [B, D, N, T] partial buffers.

#include <cuda_runtime.h>

namespace {

// the most threads (F T) a block may have; the wrapper raises beyond it
constexpr int MAX_THREADS = 512;

template <typename T>
__device__ __forceinline__ T safe(T tau) { return tau == T(0) ? T(1) : tau; }

// the forward's weights (formal_solution.cu) and, in the middle regime,
// e = exp(-tau) (else 0)
template <typename T>
__device__ __forceinline__ void weights(T tau, T& w0, T& w1, T& w2, T& e) {
  e = T(0);
  if (tau < T(5e-4)) {
    w0 = tau * (T(1) - tau / T(2));
    w1 = tau * tau * (T(0.5) - tau / T(3));
    w2 = tau * tau * tau * (T(1.0 / 3.0) - tau / T(4));
  } else if (tau >= T(50)) {
    w0 = T(1);
    w1 = T(1);
    w2 = T(2);
  } else {
    e = exp(-tau);
    w0 = T(1) - e;
    w1 = w0 - tau * e;
    w2 = T(2) * w1 - tau * tau * e;
  }
}

// dLoss/dtau through the weights, given e = exp(-tau) and dLoss/dw0, dw1, dw2
template <typename T>
__device__ __forceinline__ T weights_adjoint(T tau, T e, T g0, T g1, T g2) {
  if (tau < T(5e-4)) {  // d/dtau of tau - tau^2/2, tau^2/2 - tau^3/3, tau^3/3 - tau^4/4
    return g0 * (T(1) - tau) + g1 * (tau * (T(1) - tau)) + g2 * (tau * tau * (T(1) - tau));
  }
  if (tau >= T(50)) return T(0);
  return e * (g0 + tau * (g1 + tau * g2));
}

// The adjoint of one forward step I' = (1 - w0(a)) I + w0(a) s1 + second +
// third, with the parabolic terms of (a, b, s0, s1, s2); the outward step k
// is (tau_k, tau_{k+1}, S_k, S_{k+1}, S_{k+2}), the inward step g is
// (tau_g, tau_{g-1}, S_{g+1}, S_g, S_{g-1}).  L = dLoss/dI'; adds
// dLoss/d{a, b, s0, s1, s2} and returns dLoss/dI.  The caller skips it on
// a zero chord.
template <typename T>
__device__ __forceinline__ T step_adjoint(T a, T b, T s0, T s1, T s2, T I, T L,
                                          T& a_bar, T& b_bar, T& s0_bar, T& s1_bar,
                                          T& s2_bar) {
  T w0, w1, w2, e;
  weights(a, w0, w1, w2, e);
  const T sa = safe(a), sb = safe(b);
  const T isa = T(1) / sa, isb = T(1) / sb, iden = T(1) / safe(a + b);
  const T r1 = a * isb, r2 = b * isa;
  const T A = (s1 - s2) * r1 - (s1 - s0) * r2;
  const T B = (s2 - s1) * isb + (s0 - s1) * isa;
  const T second = w1 * A * iden, third = w2 * B * iden;
  const T Li = L * iden;
  const T A_bar = Li * w1, B_bar = Li * w2;
  const T den_bar = -Li * (second + third);
  s0_bar += A_bar * r2 + B_bar * isa;
  s1_bar += L * w0 + A_bar * (r1 - r2) - B_bar * (isb + isa);
  s2_bar += B_bar * isb - A_bar * r1;
  const T r1_bar = A_bar * (s1 - s2), r2_bar = -A_bar * (s1 - s0);
  const T sa_bar = -((B_bar * (s0 - s1) + r2_bar * b) * isa) * isa;
  const T sb_bar = -((B_bar * (s2 - s1) + r1_bar * a) * isb) * isb;
  T da = r1_bar * isb + weights_adjoint(a, e, L * (s1 - I), Li * A, Li * B);
  T db = r2_bar * isa;
  if (a + b != T(0)) {
    da += den_bar;
    db += den_bar;
  }
  if (a != T(0)) da += sa_bar;
  if (b != T(0)) db += sb_bar;
  a_bar += da;
  b_bar += db;
  return L * (T(1) - w0);
}

// The inward variant keeps a checkpoint of each recomputed sweep every SPAN
// steps; the outward variant keeps the intensity entering every step (a
// span of 1: no segment is recomputed) unless even one frequency's block
// cannot hold that, and then a checkpoint every SPAN steps too.  Outward
// alone, the recomputed segments cost more time than their smaller shared
// footprint wins back; inward, where the partial sums of two reverse
// sweeps and two forward sweeps share the block, they win.
#ifndef SPAN
#error "build with -DSPAN=<steps> (_cuda.KERNEL_FLAGS)"
#endif
static_assert(SPAN > 1, "SPAN is the span of the recomputed segments");

// checkpoints of the outward sweep (one per span interior gaps) and of the
// inward sweep (one per SPAN gaps)
__host__ __device__ inline int outward_checkpoints(int n_depth, int span) {
  return (n_depth - 2 + span - 1) / span;
}
__host__ __device__ inline int inward_checkpoints(int n_depth) {
  return (n_depth - 1 + SPAN - 1) / SPAN;
}

// elements of one block's shared memory: m [G][F], S [D][F], gF [D][F],
// ray [G][T], w [T]; the outward checkpoints [C][F][T] (every interior
// gap's entering intensity at a span of 1); the double-buffered theta-sum
// chunks [2][2 chunk][F][T] (q_d + q_{d-1}, then S_bar); inward, the inward
// sweep's checkpoints; at a span of SPAN the segment [SPAN][F][T]; inward,
// the outward reverse's theta sums [2][D][F]
__host__ __device__ inline size_t shared_elems(int n_depth, int n_theta, int tile, int chunk,
                                               int span, bool inward) {
  const size_t gaps = (size_t)(n_depth - 1), rays = (size_t)tile * n_theta;
  const size_t planes = (size_t)outward_checkpoints(n_depth, span) + 4 * chunk +
                        (inward ? inward_checkpoints(n_depth) : 0) + (span > 1 ? SPAN : 0);
  return gaps * tile + 2 * (size_t)n_depth * tile + gaps * n_theta + n_theta + planes * rays +
         (inward ? 2 * (size_t)n_depth * tile : 0);
}

// grid (tiles of `tile` frequencies, models), block tile * n_theta threads;
// the outward sweep keeps a checkpoint every OSPAN steps (1 or SPAN; SPAN
// inward)
template <typename T, bool INWARD, int OSPAN>
__global__ void __launch_bounds__(MAX_THREADS)
trace_grad_kernel(const T* __restrict__ alpha_all, const T* __restrict__ source_all,
                  const T* __restrict__ ray_all, const T* __restrict__ w_all,
                  const T* __restrict__ correction, const T* __restrict__ g_flux,
                  const T* __restrict__ g_int, T* __restrict__ g_alpha_all,
                  T* __restrict__ g_source_all, int n_depth, int n_nu, int n_theta, int tile,
                  int chunk) {
  static_assert(OSPAN == 1 || OSPAN == SPAN, "a span of 1 or SPAN");
  static_assert(!INWARD || OSPAN == SPAN, "the inward variant recomputes its segments");
  constexpr int span = OSPAN, span_in = SPAN;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int n_gaps = n_depth - 1;
  const int threads = tile * n_theta;
  const int tid = threadIdx.x;
  const int f = tid / n_theta;
  const int t = tid - f * n_theta;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tile;
  // a thread past the grid's edge runs the last column and writes nothing
  const int nc = min(n0 + f, n_nu - 1);
  const size_t cells = (size_t)n_depth * n_nu;
  const T* alpha = alpha_all + b * cells;
  const T* source = source_all + b * cells;

  T* m = reinterpret_cast<T*>(shared_raw);
  T* s = m + (size_t)n_gaps * tile;
  T* gf = s + (size_t)n_depth * tile;
  T* ray = gf + (size_t)n_depth * tile;
  T* w = ray + (size_t)n_gaps * n_theta;
  T* ckpt = w + n_theta;
  T* part = ckpt + (size_t)outward_checkpoints(n_depth, span) * threads;
  T* ckpt_in = part + (size_t)4 * chunk * threads;  // inward only
  T* seg = ckpt_in + (size_t)(INWARD ? inward_checkpoints(n_depth) : 0) * threads;
  T* acc_q = seg + (size_t)(span > 1 ? SPAN : 0) * threads;  // inward only, [D][F] each
  T* acc_s = acc_q + (size_t)n_depth * tile;

  // --- staging: the T threads of a frequency split its gaps --------------
  {
    const int per = (n_gaps + n_theta - 1) / n_theta;
    const int g0 = t * per;
    const int g1 = min(g0 + per, n_gaps);
    if (g0 < g1) {
      T la0 = log(alpha[(size_t)g0 * n_nu + nc]);
      for (int g = g0; g < g1; ++g) {
        const T la1 = log(alpha[(size_t)(g + 1) * n_nu + nc]);
        m[g * tile + f] = exp(T(0.5) * (la1 + la0));
        la0 = la1;
      }
    }
  }
  for (int i = tid; i < n_depth * tile; i += threads) {
    const int d = i / tile;
    const size_t at = (size_t)d * n_nu + min(n0 + (i - d * tile), n_nu - 1);
    s[i] = source[at];
    gf[i] = g_flux == nullptr ? T(0) : g_flux[b * cells + at];
  }
  for (int i = tid; i < n_gaps * n_theta; i += threads)
    ray[i] = ray_all[(size_t)b * n_gaps * n_theta + i];
  for (int i = tid; i < n_theta; i += threads) w[i] = w_all[i];
  __syncthreads();

  const T* m_f = m + f;
  const T* s_f = s + f;
  const T* ray_t = ray + t;
  auto tau = [&](int g) { return m_f[g * tile] * ray_t[g * n_theta]; };
  auto src = [&](int d) { return s_f[d * tile]; };
  auto mine = [&](T* plane, int d) -> T& { return plane[(size_t)d * threads + tid]; };

  // --- Kernel 2's inward steps g = g1, g1 - 1, .., g1 - n + 1 from I, the
  // intensity entering step g1; keep(g, I) sees the intensity entering each
  // step and, last, entering step g1 - n (-1: the sweep's result) ---------
  auto inward = [&](int g1, int n, T I, auto&& keep) {
    const T tau_top = tau(n_gaps - 1);
    T tau_g = tau(g1);
    T q_g = (src(g1 + 1) - src(g1)) / safe(tau_g);  // (s_gp1 - s_g) / safe(tau_g)
    for (int g = g1; g > g1 - n; --g) {
      keep(g, I);
      const T tau_gm1 = g > 0 ? tau(g - 1) : tau_top;
      const T s_g = src(g);
      const T s_gp1 = src(g + 1);
      const T s_gm1 = src(g > 0 ? g - 1 : n_gaps);
      T w0, w1, w2, e;
      weights(tau_g, w0, w1, w2, e);
      const T denom = safe(tau_g + tau_gm1);
      const T second = w1 * ((s_g - s_gm1) * (tau_g / safe(tau_gm1)) -
                             (s_g - s_gp1) * (tau_gm1 / safe(tau_g))) / denom;
      const T q_gm1 = (s_gm1 - s_g) / safe(tau_gm1);
      const T third = w2 * (q_gm1 + q_g) / denom;
      if (tau_g != T(0) && tau_gm1 != T(0)) I = (T(1) - w0) * I + w0 * s_g + second + third;
      tau_g = tau_gm1;
      q_g = -q_gm1;
    }
    keep(g1 - n, I);
    return I;
  };
  // --- Kernel 2's outward interior steps k = k0 .. k0 + n - 1 from I, the
  // intensity entering gap k0; keep(k, I) sees the intensity entering each
  // step and, last, entering gap k0 + n ------------------------------------
  auto outward = [&](int k0, int n, T I, auto&& keep) {
    T tau_k = tau(k0);
    T s_k = src(k0);
    T s_kp1 = src(k0 + 1);
    T q_k = (s_k - s_kp1) / safe(tau_k);  // the third term's second quotient
    for (int k = k0; k < k0 + n; ++k) {
      keep(k, I);
      const T tau_kp1 = tau(k + 1);
      const T s_kp2 = src(k + 2);
      T w0, w1, w2, e;
      weights(tau_k, w0, w1, w2, e);
      const T denom = safe(tau_k + tau_kp1);
      const T second = w1 * ((s_kp1 - s_kp2) * (tau_k / safe(tau_kp1)) -
                             (s_kp1 - s_k) * (tau_kp1 / safe(tau_k))) / denom;
      const T q_kp1 = (s_kp2 - s_kp1) / safe(tau_kp1);
      const T third = w2 * (q_kp1 + q_k) / denom;
      if (tau_k != T(0)) I = (T(1) - w0) * I + w0 * s_kp1 + second + third;
      tau_k = tau_kp1;
      s_k = s_kp1;
      s_kp1 = s_kp2;
      q_k = -q_kp1;
    }
    keep(k0 + n, I);
    return I;
  };

  // --- the forward, keeping checkpoints -----------------------------------
  T I0 = T(0);
  if (INWARD) {
    I0 = inward(n_gaps - 1, n_gaps, T(0), [&](int g, T v) {
      const int i = n_gaps - 1 - g;  // the sweep's step index
      if (g >= 0 && i % span_in == 0) mine(ckpt_in, i / span_in) = v;
    });
  }
  T I_last = T(0);  // entering the last gap
  outward(0, n_gaps - 1, I0, [&](int k, T v) {
    if (k == n_gaps - 1) {
      I_last = v;
    } else if (k % span == 0) {
      mine(ckpt, k / span) = v;
    }
  });

  // --- theta sums: each ray hands over one depth's q_d + q_{d-1} and S_bar
  // at a time, in the order depth_of(0), depth_of(1), ..; after each chunk
  // of depths one thread per (depth, frequency) sums theta in order and
  // passes the sums to finish(d, frequency in the tile, sum q, sum S_bar)
  int emitted = 0, first = 0, half = 0;
  auto emit = [&](T v, T sv, auto&& depth_of, auto&& finish) {
    T* p = part + (size_t)half * 2 * chunk * threads;
    const int j = emitted - first;
    mine(p, j) = v;
    mine(p, chunk + j) = sv;
    ++emitted;
    if (j + 1 == chunk || emitted == n_depth) {
      __syncthreads();
      for (int i = tid; i < (j + 1) * tile; i += threads) {
        const int dd = i / tile;
        const int ff = i - dd * tile;
        if (n0 + ff < n_nu) {
          const T* rv = p + (size_t)dd * threads + ff * n_theta;
          const T* rs = rv + (size_t)chunk * threads;
          T qa = T(0), sa = T(0);
          for (int tt = 0; tt < n_theta; ++tt) {
            qa += rv[tt];
            sa += rs[tt];
          }
          finish(depth_of(first + dd), ff, qa, sa);
        }
      }
      first = emitted;
      half ^= 1;
    }
  };
  T* g_alpha = g_alpha_all + b * cells;
  T* g_source = g_source_all + b * cells;
  auto write = [&](int d, int ff, T qa, T sa) {
    const size_t at = (size_t)d * n_nu + n0 + ff;
    g_alpha[at] = qa / alpha[at];
    g_source[at] = sa;
  };
  auto from_surface = [&](int e) { return n_gaps - e; };
  auto outward_sums = [&](int d, int ff, T qa, T sa) {
    if (INWARD) {  // wait for the inward reverse's
      acc_q[d * tile + ff] = qa;
      acc_s[d * tile + ff] = sa;
    } else {
      write(d, ff, qa, sa);
    }
  };

  // --- the reverse outward sweep; the last gap first ----------------------
  const size_t plane = (size_t)n_nu * n_theta;  // one depth of [D, N, T]
  const T* gi = g_int == nullptr ? nullptr : g_int + b * cells * n_theta + (size_t)nc * n_theta + t;
  const T wc = w[t] * correction[b];
  auto seed = [&](int d) {
    T sd = g_flux != nullptr ? wc * gf[d * tile + f] : T(0);
    return gi != nullptr ? sd + gi[(size_t)d * plane] : sd;
  };
  T lam = seed(n_gaps);
  T tau_k = tau(n_gaps - 1);
  T c1 = T(0), c2 = T(0);  // S_bar of depths k + 1, k + 2 (here G - 1, G)
  T t_bar = T(0);          // tau_bar of gap k, completed by step k - 1
  if (tau_k != T(0)) {
    const T s0 = src(n_gaps - 1), s1 = src(n_gaps);
    T w0, w1, w2, e;
    weights(tau_k, w0, w1, w2, e);
    const T ist = T(1) / safe(tau_k);
    const T ist2 = ist * ist;
    const T third = w2 * (s0 - s1) * ist2;
    c1 += lam * w2 * ist2;
    c2 += lam * w0 - lam * w2 * ist2;
    t_bar = weights_adjoint(tau_k, e, lam * (s1 - I_last), T(0), lam * (s0 - s1) * ist2)
            - T(2) * lam * third * ist;
    lam = lam * (T(1) - w0);
  }
  lam += seed(n_gaps - 1);
  T q_hi = T(0);  // q of gap k + 2 (0 above the last gap)
  int k0 = 0;     // the first gap of the segment in ``seg``
  for (int k = n_gaps - 2; k >= 0; --k) {
    if (span > 1 && (k == n_gaps - 2 || (k + 1) % span == 0)) {  // a segment's top
      k0 = k - k % span;
      outward(k0, k - k0, mine(ckpt, k0 / span), [&](int kk, T v) { mine(seg, kk - k0) = v; });
    }
    const T I_k = span > 1 ? mine(seg, k - k0) : mine(ckpt, k);
    const T tau_kp1 = tau_k;
    tau_k = tau(k);
    T c0 = T(0), a_bar = T(0);
    if (tau_k != T(0)) {
      lam = step_adjoint(tau_k, tau_kp1, src(k), src(k + 1), src(k + 2), I_k, lam, a_bar,
                         t_bar, c0, c1, c2);
    }
    const T q_k1 = T(0.5) * t_bar * tau_kp1;  // gap k + 1 is final
    emit(q_hi + q_k1, c2, from_surface, outward_sums);  // depth k + 2
    q_hi = q_k1;
    c2 = c1;
    c1 = c0;
    t_bar = a_bar;
    lam += seed(k);
  }
  const T q_0 = T(0.5) * t_bar * tau_k;
  emit(q_hi + q_0, c2, from_surface, outward_sums);  // depth 1
  emit(q_0, c1, from_surface, outward_sums);         // depth 0
  if (!INWARD) return;

  // --- the reverse inward sweep from lam = dLoss/dI_0, the centre up; its
  // theta sums are added to the outward reverse's -------------------------
  emitted = first = 0;
  auto from_centre = [&](int e) { return e; };
  auto inward_sums = [&](int d, int ff, T qa, T sa) {
    write(d, ff, acc_q[d * tile + ff] + qa, acc_s[d * tile + ff] + sa);
  };
  const T tau_top = tau(n_gaps - 1);
  T tau_g = tau(0);
  T q_w = T(0), s_w = T(0);  // the gap-0 wrap's shares of q_{G-1} and S_bar[G]
  T q_p = T(0), q_pp = T(0);  // q of gaps g - 1 and g - 2
  T s_p = T(0), s_c = T(0);   // S_bar of depths g - 1 and g
  int i0 = 0;                 // the sweep's first step index in ``seg``
  for (int g = 0; g < n_gaps; ++g) {
    const int i = n_gaps - 1 - g;  // the sweep's step index of gap g
    if (g == 0 || (i + 1) % span_in == 0) {  // a segment's last step
      i0 = i - i % span_in;
      inward(n_gaps - 1 - i0, i - i0, mine(ckpt_in, i0 / span_in),
             [&](int gg, T v) { mine(seg, n_gaps - 1 - gg - i0) = v; });
    }
    const T J_g = mine(seg, i - i0);
    const int sm1 = g > 0 ? g - 1 : n_gaps;  // S[g-1] wraps to S[G]
    const T tau_gm1 = g > 0 ? tau(g - 1) : tau_top;  // tau[g-1] wraps to tau[G-1]
    const T tau_next = g + 1 < n_gaps ? tau(g + 1) : T(0);
    T q_g = T(0), s_n = T(0);  // q of gap g, S_bar of depth g + 1
    if (tau_g != T(0) && tau_gm1 != T(0)) {
      T a_bar = T(0), b_bar = T(0), sp_bar = T(0), sg_bar = T(0), sm_bar = T(0);
      lam = step_adjoint(tau_g, tau_gm1, src(g + 1), src(g), src(sm1), J_g, lam, a_bar, b_bar,
                         sp_bar, sg_bar, sm_bar);
      q_g = T(0.5) * a_bar * tau_g;
      const T q_b = T(0.5) * b_bar * tau_gm1;
      if (g > 0) {
        q_p += q_b;
        s_p += sm_bar;
      } else {
        q_w += q_b;
        s_w += sm_bar;
      }
      s_n = sp_bar;
      s_c += sg_bar;
    }
    if (g > 0) emit(g > 1 ? q_p + q_pp : q_p, s_p, from_centre, inward_sums);  // depth g - 1
    q_pp = q_p;
    q_p = q_g;
    s_p = s_c;
    s_c = s_n;
    tau_g = tau_next;
  }
  const T q_last = q_w + q_p;  // gap G - 1
  emit(n_gaps > 1 ? q_last + q_pp : q_last, s_p, from_centre, inward_sums);  // depth G - 1
  emit(q_last, s_w + s_c, from_centre, inward_sums);                          // depth G
}

template <typename T>
int launch(const T* alpha, const T* source, const T* ray, const T* w, const T* correction,
           const T* g_flux, const T* g_int, T* g_alpha, T* g_source, int n_models,
           int n_depth, int n_nu, int n_theta, int tile, int chunk, int span, int inward,
           cudaStream_t stream) {
  const int threads = tile * n_theta;
  if (tile < 1 || chunk < 1 || n_depth < 2 || threads > MAX_THREADS ||
      (span != SPAN && (inward || span != 1)))
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_elems(n_depth, n_theta, tile, chunk, span, inward) * sizeof(T);
  auto kernel = inward      ? trace_grad_kernel<T, true, SPAN>
                : span == 1 ? trace_grad_kernel<T, false, 1>
                            : trace_grad_kernel<T, false, SPAN>;
  if (shared > 48 * 1024) {  // above 48 KB only by the kernel's own opt-in
    const int status = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (status) return status;
  }
  const dim3 grid((unsigned)((n_nu + tile - 1) / tile), (unsigned)n_models);
  kernel<<<grid, threads, shared, stream>>>(alpha, source, ray, w, correction, g_flux, g_int,
                                            g_alpha, g_source, n_depth, n_nu, n_theta, tile,
                                            chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha, source: [n_models, n_depth, n_nu]; ray: [n_models, n_depth - 1,
// n_theta]; w: [n_theta]; correction: [n_models]; g_flux: dLoss/dF_nu
// shaped as alpha, or null; g_int: dLoss/dI_nu [n_models, n_depth, n_nu,
// n_theta], or null; g_alpha, g_source: outputs shaped as alpha; tile:
// frequencies per block; chunk: depths per theta sum; span: the outward
// sweep's checkpoint span, 1 or SPAN (SPAN when inward); inward: 1 for
// spherical models.
extern "C" int formal_solution_grad_f32(const float* alpha, const float* source,
                                        const float* ray, const float* w,
                                        const float* correction, const float* g_flux,
                                        const float* g_int, float* g_alpha, float* g_source,
                                        int n_models, int n_depth, int n_nu, int n_theta,
                                        int tile, int chunk, int span, int inward,
                                        void* stream) {
  return launch<float>(alpha, source, ray, w, correction, g_flux, g_int, g_alpha, g_source,
                       n_models, n_depth, n_nu, n_theta, tile, chunk, span, inward,
                       (cudaStream_t)stream);
}

extern "C" int formal_solution_grad_f64(const double* alpha, const double* source,
                                        const double* ray, const double* w,
                                        const double* correction, const double* g_flux,
                                        const double* g_int, double* g_alpha,
                                        double* g_source, int n_models, int n_depth, int n_nu,
                                        int n_theta, int tile, int chunk, int span,
                                        int inward, void* stream) {
  return launch<double>(alpha, source, ray, w, correction, g_flux, g_int, g_alpha, g_source,
                        n_models, n_depth, n_nu, n_theta, tile, chunk, span, inward,
                        (cudaStream_t)stream);
}

// dynamic shared bytes of one block (the wrapper's solver.trace_grad_tile
// counts the same layout; a launch checks the two agree)
extern "C" long long formal_solution_grad_shared_bytes(int n_depth, int n_theta, int tile,
                                                       int chunk, int span, int itemsize,
                                                       int inward) {
  return (long long)(shared_elems(n_depth, n_theta, tile, chunk, span, inward != 0) * itemsize);
}

extern "C" const char* formal_solution_grad_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
