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
// sweep's result; then F[d] = corr_b sum_t w_t I_t[d].  Under autograd it
// writes the buffer I[b, d, n, t], saved for this kernel, so the sweep is
// not recomputed.
//
// Pass 1, one thread per ray:
//  * spherical only: recompute the inward sweep (the forward keeps only its
//    result) and store the intensity entering each inward step in a
//    scratch buffer [B, G, N, T];
//  * the reverse outward sweep: lambda = dLoss/dI starts at the seed
//    w_t corr gF[d] + gI[d, t] of the surface, and for k = G-1 .. 0 the
//    step's adjoint adds into dLoss/d{tau_k, tau_{k+1}, S_k, S_{k+1},
//    S_{k+2}} and lambda <- seed[k] + lambda (1 - w0_k) (lambda when the
//    step passed I through);
//  * spherical only: the reverse inward sweep, g = 0 .. G-1 (the forward
//    ran G-1 .. 0), from lambda at I_0, with the reference's wrap at g = 0
//    (tau[g-1] is tau[G-1] and S[g-1] is S[G], so their gradients land on
//    those elements);
//  * tau_k = exp((ln a_k + ln a_{k+1})/2) ds_k, so dtau_k/da = tau_k/(2a):
//    the ray writes q_k = tau_bar_k tau_k / 2 per gap and S_bar per depth
//    into per-(ray, depth) partial buffers [B, D, N, T].
// Pass 2, one thread per (b, d, n): sums the partials over theta in a fixed
// order, as the forward sums the flux, and writes
// alpha_bar = (sum_t q_{d-1} + q_d) / alpha_d and S_bar.  Each output is
// written once: no atomics, two launches equal bit for bit.
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
//    so the recomputed inward sweep is bit-identical to the forward's.
//
// What bounds it on the H100: little, as for Kernel 2.  At 56 depths x 10k
// nu x 20 theta a model is ~1.1e7 reverse steps of ~106 FLOPs (the inward
// variant adds a recomputed forward step and a second reverse step per
// gap); the saved intensity is read once, and the two partial buffers are
// written and read once each.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T safe(T tau) { return tau == T(0) ? T(1) : tau; }

// the forward's weights (formal_solution.cu)
template <typename T>
__device__ __forceinline__ void weights(T tau, T& w0, T& w1, T& w2) {
  if (tau < T(5e-4)) {
    w0 = tau * (T(1) - tau / T(2));
    w1 = tau * tau * (T(0.5) - tau / T(3));
    w2 = tau * tau * tau * (T(1.0 / 3.0) - tau / T(4));
  } else if (tau >= T(50)) {
    w0 = T(1);
    w1 = T(1);
    w2 = T(2);
  } else {
    T e = exp(-tau);
    w0 = T(1) - e;
    w1 = w0 - tau * e;
    w2 = T(2) * w1 - tau * tau * e;
  }
}

// dLoss/dtau through the weights, given dLoss/dw0, dw1, dw2
template <typename T>
__device__ __forceinline__ T weights_adjoint(T tau, T g0, T g1, T g2) {
  if (tau < T(5e-4)) {  // d/dtau of tau - tau^2/2, tau^2/2 - tau^3/3, tau^3/3 - tau^4/4
    return g0 * (T(1) - tau) + g1 * (tau * (T(1) - tau)) + g2 * (tau * tau * (T(1) - tau));
  }
  if (tau >= T(50)) return T(0);
  return exp(-tau) * (g0 + tau * (g1 + tau * g2));
}

template <typename T>
__device__ __forceinline__ T tau_of(const T* alpha, const T* ray, int g, int n,
                                    int t, int n_nu, int n_theta) {
  T la1 = log(alpha[(size_t)(g + 1) * n_nu + n]);
  T la0 = log(alpha[(size_t)g * n_nu + n]);
  return exp(T(0.5) * (la1 + la0)) * ray[g * n_theta + t];
}

// One forward step I' = (1 - w0(a)) I + w0(a) s1 + second + third, with the
// parabolic terms of (a, b, s0, s1, s2); the outward step k is (tau_k,
// tau_{k+1}, S_k, S_{k+1}, S_{k+2}), the inward step g is (tau_g,
// tau_{g-1}, S_{g+1}, S_g, S_{g-1}).  The caller skips it on a zero chord.
template <typename T>
__device__ __forceinline__ T step(T a, T b, T s0, T s1, T s2, T I) {
  T w0, w1, w2;
  weights(a, w0, w1, w2);
  const T den = safe(a + b);
  const T second = w1 * ((s1 - s2) * (a / safe(b)) - (s1 - s0) * (b / safe(a))) / den;
  const T third = w2 * ((s2 - s1) / safe(b) + (s0 - s1) / safe(a)) / den;
  return (T(1) - w0) * I + w0 * s1 + second + third;
}

// The adjoint of ``step``: L = dLoss/dI'; adds dLoss/d{a, b, s0, s1, s2}
// and returns dLoss/dI.
template <typename T>
__device__ __forceinline__ T step_adjoint(T a, T b, T s0, T s1, T s2, T I, T L,
                                          T& a_bar, T& b_bar, T& s0_bar, T& s1_bar,
                                          T& s2_bar) {
  T w0, w1, w2;
  weights(a, w0, w1, w2);
  const T sa = safe(a), sb = safe(b);
  const T den = safe(a + b);
  const T r1 = a / sb, r2 = b / sa;
  const T A = (s1 - s2) * r1 - (s1 - s0) * r2;
  const T B = (s2 - s1) / sb + (s0 - s1) / sa;
  const T second = w1 * A / den, third = w2 * B / den;
  const T A_bar = L * w1 / den, B_bar = L * w2 / den;
  const T den_bar = -L * (second + third) / den;
  s0_bar += A_bar * r2 + B_bar / sa;
  s1_bar += L * w0 + A_bar * (r1 - r2) - B_bar * (T(1) / sb + T(1) / sa);
  s2_bar += B_bar / sb - A_bar * r1;
  const T r1_bar = A_bar * (s1 - s2), r2_bar = -A_bar * (s1 - s0);
  const T sa_bar = -(B_bar * (s0 - s1) + r2_bar * b) / (sa * sa);
  const T sb_bar = -(B_bar * (s2 - s1) + r1_bar * a) / (sb * sb);
  T da = r1_bar / sb + weights_adjoint(a, L * (s1 - I), L * A / den, L * B / den);
  T db = r2_bar / sa;
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

template <typename T, bool INWARD>
__global__ void __launch_bounds__(THREADS)
trace_grad_kernel(const T* __restrict__ alpha_all, const T* __restrict__ source_all,
                  const T* __restrict__ ray_all, const T* __restrict__ w,
                  const T* __restrict__ correction, const T* __restrict__ intensity_all,
                  const T* __restrict__ g_flux, const T* __restrict__ g_int,
                  T* __restrict__ q_all, T* __restrict__ s_all, T* __restrict__ scratch_all,
                  int n_models, int n_depth, int n_nu, int n_theta) {
  const long long rays = (long long)n_nu * n_theta;  // rays of one model
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= rays * n_models) return;
  const int b = (int)(gid / rays);
  const long long idx = gid - (long long)b * rays;  // n * T + t
  const int n = (int)(idx / n_theta);
  const int t = (int)(idx % n_theta);
  const int G = n_depth - 1;
  const size_t cells = (size_t)n_depth * n_nu;
  const size_t plane = (size_t)rays;  // one depth of a [D, N, T] block
  const T* alpha = alpha_all + b * cells;
  const T* source = source_all + b * cells;
  const T* ray = ray_all + (size_t)b * G * n_theta;
  const T* intensity = intensity_all + b * cells * n_theta + idx;
  T* q = q_all + b * cells * n_theta + idx;  // q[d * plane]: gap d's tau_bar tau / 2
  T* s_bar = s_all + b * cells * n_theta + idx;
  const T wc = w[t] * correction[b];
  const T* gf = g_flux ? g_flux + b * cells + n : nullptr;
  const T* gi = g_int ? g_int + b * cells * n_theta + idx : nullptr;
  auto seed = [&](int d) {
    T s = gf ? wc * gf[(size_t)d * n_nu] : T(0);
    return gi ? s + gi[(size_t)d * plane] : s;
  };
#define S(d) source[(size_t)(d) * n_nu + n]

  T* J = nullptr;  // intensity entering each inward step
  if (INWARD) {
    J = scratch_all + (size_t)b * G * plane + idx;
    const T tau_top = tau_of(alpha, ray, G - 1, n, t, n_nu, n_theta);
    T tau_g = tau_top, I = T(0);
    for (int g = G - 1; g >= 0; --g) {
      const T tau_gm1 = g > 0 ? tau_of(alpha, ray, g - 1, n, t, n_nu, n_theta) : tau_top;
      J[(size_t)g * plane] = I;
      if (tau_g != T(0) && tau_gm1 != T(0))
        I = step(tau_g, tau_gm1, S(g + 1), S(g), S(g > 0 ? g - 1 : G), I);
      tau_g = tau_gm1;
    }
  }

  // reverse outward sweep; the last gap first
  T lam = seed(G);
  T tau_k = tau_of(alpha, ray, G - 1, n, t, n_nu, n_theta);
  T c1 = T(0), c2 = T(0);  // S_bar of depths k + 1, k + 2 (here G - 1, G)
  T t_bar = T(0);          // tau_bar of gap k, completed by step k - 1
  if (tau_k != T(0)) {
    const T s0 = S(G - 1), s1 = S(G), I = intensity[(size_t)(G - 1) * plane];
    T w0, w1, w2;
    weights(tau_k, w0, w1, w2);
    const T st = safe(tau_k);
    const T third = w2 * (s0 - s1) / (st * st);
    c1 += lam * w2 / (st * st);
    c2 += lam * w0 - lam * w2 / (st * st);
    t_bar = weights_adjoint(tau_k, lam * (s1 - I), T(0), lam * (s0 - s1) / (st * st))
            - T(2) * lam * third / st;
    lam = lam * (T(1) - w0);
  }
  lam += seed(G - 1);
  for (int k = G - 2; k >= 0; --k) {
    const T tau_kp1 = tau_k;
    tau_k = tau_of(alpha, ray, k, n, t, n_nu, n_theta);
    T c0 = T(0), a_bar = T(0);
    if (tau_k != T(0)) {
      lam = step_adjoint(tau_k, tau_kp1, S(k), S(k + 1), S(k + 2),
                         intensity[(size_t)k * plane], lam, a_bar, t_bar, c0, c1, c2);
    }
    q[(size_t)(k + 1) * plane] = T(0.5) * t_bar * tau_kp1;
    s_bar[(size_t)(k + 2) * plane] = c2;
    c2 = c1;
    c1 = c0;
    t_bar = a_bar;
    lam += seed(k);
  }
  q[0] = T(0.5) * t_bar * tau_k;
  s_bar[plane] = c2;
  s_bar[0] = c1;

  if (INWARD) {
    // reverse inward sweep: lam is dLoss/dI_0, the sweep's result
    const T tau_top = tau_of(alpha, ray, G - 1, n, t, n_nu, n_theta);
    T tau_g = tau_of(alpha, ray, 0, n, t, n_nu, n_theta);
    for (int g = 0; g < G; ++g) {
      const int gm1 = g > 0 ? g - 1 : G - 1;  // tau[g-1] wraps to tau[G-1]
      const int sm1 = g > 0 ? g - 1 : G;      // S[g-1] wraps to S[G]
      const T tau_gm1 = g > 0 ? tau_of(alpha, ray, g - 1, n, t, n_nu, n_theta) : tau_top;
      const T tau_next = g + 1 < G ? tau_of(alpha, ray, g + 1, n, t, n_nu, n_theta) : T(0);
      if (tau_g != T(0) && tau_gm1 != T(0)) {
        T a_bar = T(0), b_bar = T(0), sp_bar = T(0), sg_bar = T(0), sm_bar = T(0);
        lam = step_adjoint(tau_g, tau_gm1, S(g + 1), S(g), S(sm1), J[(size_t)g * plane],
                           lam, a_bar, b_bar, sp_bar, sg_bar, sm_bar);
        q[(size_t)g * plane] += T(0.5) * a_bar * tau_g;
        q[(size_t)gm1 * plane] += T(0.5) * b_bar * tau_gm1;
        s_bar[(size_t)(g + 1) * plane] += sp_bar;
        s_bar[(size_t)g * plane] += sg_bar;
        s_bar[(size_t)sm1 * plane] += sm_bar;
      }
      tau_g = tau_next;
    }
  }
#undef S
}

// pass 2: alpha_bar[b, d, n] = sum_t (q[d-1] + q[d]) / alpha, S_bar =
// sum_t s_bar, theta in order (q[G] does not exist: gaps are 0 .. G-1)
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_sum_kernel(const T* __restrict__ alpha, const T* __restrict__ q,
                const T* __restrict__ s_bar, T* __restrict__ g_alpha,
                T* __restrict__ g_source, long long n_cells, int n_depth, int n_nu,
                int n_theta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cells) return;
  const int d = (int)((idx / n_nu) % n_depth);
  const T* qd = q + idx * n_theta;
  const T* sd = s_bar + idx * n_theta;
  const long long up = (long long)n_nu * n_theta;  // from depth d to d - 1
  T qa = T(0), sa = T(0);
  for (int t = 0; t < n_theta; ++t) {
    T v = d < n_depth - 1 ? qd[t] : T(0);
    if (d > 0) v += qd[t - up];
    qa += v;
    sa += sd[t];
  }
  g_alpha[idx] = qa / alpha[idx];
  g_source[idx] = sa;
}

template <typename T>
int launch(const T* alpha, const T* source, const T* ray, const T* w, const T* correction,
           const T* intensity, const T* g_flux, const T* g_int, T* q, T* s_bar, T* scratch,
           T* g_alpha, T* g_source, int n_models, int n_depth, int n_nu, int n_theta,
           int inward, cudaStream_t stream) {
  const long long rays = (long long)n_models * n_nu * n_theta;
  const unsigned blocks = (unsigned)((rays + THREADS - 1) / THREADS);
  if (inward) {
    trace_grad_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        alpha, source, ray, w, correction, intensity, g_flux, g_int, q, s_bar, scratch,
        n_models, n_depth, n_nu, n_theta);
  } else {
    trace_grad_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        alpha, source, ray, w, correction, intensity, g_flux, g_int, q, s_bar, scratch,
        n_models, n_depth, n_nu, n_theta);
  }
  int status = (int)cudaGetLastError();
  if (status) return status;
  const long long cells = (long long)n_models * n_depth * n_nu;
  grad_sum_kernel<T><<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      alpha, q, s_bar, g_alpha, g_source, cells, n_depth, n_nu, n_theta);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha, source: [n_models, n_depth, n_nu]; ray: [n_models, n_depth - 1,
// n_theta]; w: [n_theta]; correction: [n_models]; intensity: Kernel 2's
// intensity buffer [n_models, n_depth, n_nu, n_theta]; g_flux: dLoss/dF_nu
// shaped as alpha, or null; g_int: dLoss/dI_nu shaped as intensity, or
// null; q, s_bar: scratch shaped as intensity; scratch: [n_models,
// n_depth - 1, n_nu, n_theta] for the inward variant (else unused, may be
// null); g_alpha, g_source: outputs shaped as alpha.
extern "C" int formal_solution_grad_f32(const float* alpha, const float* source,
                                        const float* ray, const float* w,
                                        const float* correction, const float* intensity,
                                        const float* g_flux, const float* g_int, float* q,
                                        float* s_bar, float* scratch, float* g_alpha,
                                        float* g_source, int n_models, int n_depth,
                                        int n_nu, int n_theta, int inward, void* stream) {
  return launch<float>(alpha, source, ray, w, correction, intensity, g_flux, g_int, q,
                       s_bar, scratch, g_alpha, g_source, n_models, n_depth, n_nu,
                       n_theta, inward, (cudaStream_t)stream);
}

extern "C" int formal_solution_grad_f64(const double* alpha, const double* source,
                                        const double* ray, const double* w,
                                        const double* correction, const double* intensity,
                                        const double* g_flux, const double* g_int,
                                        double* q, double* s_bar, double* scratch,
                                        double* g_alpha, double* g_source, int n_models,
                                        int n_depth, int n_nu, int n_theta, int inward,
                                        void* stream) {
  return launch<double>(alpha, source, ray, w, correction, intensity, g_flux, g_int, q,
                        s_bar, scratch, g_alpha, g_source, n_models, n_depth, n_nu,
                        n_theta, inward, (cudaStream_t)stream);
}

extern "C" const char* formal_solution_grad_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
