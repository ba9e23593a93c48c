// Formal solution of the radiative-transfer equation on Hopper (sm_90a):
// van Noort (2001) short characteristics with parabolic source
// interpolation, for a batch of models, plane-parallel or spherical.
//
// Replaces, in stardis_tpu/radiation_field/solver.py:
//   raytrace            theta-weighted F_nu (+ I_nu when tracked), times the
//                       per-model photospheric correction
//   compute_taus        log-midpoint tau = exp((ln a_k + ln a_{k+1})/2) ds
//   calc_weights        w0/w1/w2 in three tau regimes (5e-4, 50)
//   single_theta_trace  parabolic interior step + last-gap boundary jump,
//                       and, with inward_rays=True, the spherical inward
//                       sweep of solver.py:98-134
//   _linear_recurrence  I_{k+1} = a_k I_k + b_k, an associative scan on the
//                       TPU; here a serial 55-step loop in registers
// and the vmapped model axis of stardis_tpu/parallel/batch.py:225.
//
// Design: pass 1 runs one thread per (model, nu, theta).  It reads the
// [D, N] extinction and source columns of its model and nu, forms tau and
// the weights gap by gap, runs the depth recurrence in registers and writes
// I[b, d, nu, theta] ([B, D, N, T], the JAX layout of I_nus per model).
// The spherical variant (INWARD) first runs the inward sweep
// I[g] = a'_g I[g+1] + b'_g from the surface gap G-1 down to gap 0,
// starting from 0; its result seeds the outward sweep.  At g = 0 the
// reference wraps: tau[g-1] is tau[G-1] and source[g-1] is source[G], the
// last element of the full source array.  Chords that miss inner shells
// have ray distance 0, so tau = 0 there, and a gap whose tau[g] or tau[g-1]
// is 0 passes the intensity through.  Each step sums (1 - w0) I + w0 S +
// second + third in the reference's order.  The inward pass recomputes tau per
// gap rather than keeping 55 values per thread.  Pass 2 runs one thread
// per (model, depth, nu) and sums w_theta I in fixed theta order, times
// the model's correction: deterministic, no atomics.
//
// Built with -fmad=false (_cuda.KERNEL_FLAGS): every product and sum rounds
// on its own, in the plain version's order, so kernel and plain agree bit
// for bit on I_nu where the weights cancel (w1 = w0 - tau e just above the
// Taylor threshold) and where the gap-0 wrap divides by a small surface tau.
//
// What bounds it on the H100: little.  At 56 depths x 10k nu x 20 theta a
// model is about 1e7 recurrence steps of ~40 flops plus two logs and an exp
// (twice that with the inward sweep), and 2 x 45 MB of float32 I traffic
// between the passes; the column reads of alpha and source are shared by
// the theta threads of one nu and hit L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T safe(T tau) { return tau == T(0) ? T(1) : tau; }

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

// alpha: this model's [D, N]; ray: this model's [G, T]
template <typename T>
__device__ __forceinline__ T tau_of(const T* alpha, const T* ray, int g, int n,
                                    int t, int n_nu, int n_theta) {
  T la1 = log(alpha[(size_t)(g + 1) * n_nu + n]);
  T la0 = log(alpha[(size_t)g * n_nu + n]);
  return exp(T(0.5) * (la1 + la0)) * ray[g * n_theta + t];
}

// Intensity at gap 0 after the inward sweep of one (model, nu, theta) ray.
template <typename T>
__device__ T inward_sweep(const T* alpha, const T* source, const T* ray, int n,
                          int t, int n_gaps, int n_nu, int n_theta) {
  const T tau_top = tau_of(alpha, ray, n_gaps - 1, n, t, n_nu, n_theta);
  T tau_g = tau_top;
  T I = T(0);
  for (int g = n_gaps - 1; g >= 0; --g) {
    const T tau_gm1 = g > 0 ? tau_of(alpha, ray, g - 1, n, t, n_nu, n_theta) : tau_top;
    const T s_g = source[(size_t)g * n_nu + n];
    const T s_gp1 = source[(size_t)(g + 1) * n_nu + n];
    const T s_gm1 = source[(size_t)(g > 0 ? g - 1 : n_gaps) * n_nu + n];
    T w0, w1, w2;
    weights(tau_g, w0, w1, w2);
    const T denom = safe(tau_g + tau_gm1);
    const T second = w1 * ((s_g - s_gm1) * (tau_g / safe(tau_gm1)) -
                           (s_g - s_gp1) * (tau_gm1 / safe(tau_g))) / denom;
    const T third = w2 * ((s_gm1 - s_g) / safe(tau_gm1) +
                          (s_gp1 - s_g) / safe(tau_g)) / denom;
    if (tau_g != T(0) && tau_gm1 != T(0)) I = (T(1) - w0) * I + w0 * s_g + second + third;
    tau_g = tau_gm1;
  }
  return I;
}

template <typename T, bool INWARD>
__global__ void __launch_bounds__(THREADS)
trace_kernel(const T* __restrict__ alpha_all, const T* __restrict__ source_all,
             const T* __restrict__ ray_all, T* __restrict__ intensity_all,
             int n_models, int n_depth, int n_nu, int n_theta) {
  const long long rays = (long long)n_nu * n_theta;  // rays of one model
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= rays * n_models) return;
  const int b = (int)(gid / rays);
  const long long idx = gid - (long long)b * rays;
  const int n = (int)(idx / n_theta);
  const int t = (int)(idx % n_theta);
  const int n_gaps = n_depth - 1;
  const size_t cells = (size_t)n_depth * n_nu;
  const T* alpha = alpha_all + b * cells;
  const T* source = source_all + b * cells;
  const T* ray = ray_all + (size_t)b * n_gaps * n_theta;
  T* intensity = intensity_all + b * cells * n_theta;
  const size_t plane = (size_t)rays;  // one depth of intensity

  T I = INWARD ? inward_sweep(alpha, source, ray, n, t, n_gaps, n_nu, n_theta) : T(0);
  intensity[idx] = I;
  T tau_k = tau_of(alpha, ray, 0, n, t, n_nu, n_theta);
  T s_k = source[n];
  T s_kp1 = source[(size_t)n_nu + n];
  for (int k = 0; k < n_gaps - 1; ++k) {
    const T tau_kp1 = tau_of(alpha, ray, k + 1, n, t, n_nu, n_theta);
    const T s_kp2 = source[(size_t)(k + 2) * n_nu + n];
    T w0, w1, w2;
    weights(tau_k, w0, w1, w2);
    const T denom = safe(tau_k + tau_kp1);
    const T second = w1 * ((s_kp1 - s_kp2) * (tau_k / safe(tau_kp1)) -
                           (s_kp1 - s_k) * (tau_kp1 / safe(tau_k))) / denom;
    const T third = w2 * ((s_kp2 - s_kp1) / safe(tau_kp1) +
                          (s_k - s_kp1) / safe(tau_k)) / denom;
    if (tau_k != T(0)) I = (T(1) - w0) * I + w0 * s_kp1 + second + third;
    intensity[(size_t)(k + 1) * plane + idx] = I;
    tau_k = tau_kp1;
    s_k = s_kp1;
    s_kp1 = s_kp2;
  }
  // last gap: constant-source boundary jump
  T w0, w1, w2;
  weights(tau_k, w0, w1, w2);
  const T st = safe(tau_k);
  const T third = w2 * (s_k - s_kp1) / (st * st);
  if (tau_k != T(0)) I = (T(1) - w0) * I + w0 * s_kp1 + third;
  intensity[(size_t)n_gaps * plane + idx] = I;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flux_kernel(const T* __restrict__ intensity, const T* __restrict__ w,
            const T* __restrict__ correction, T* __restrict__ f_nu,
            long long cells_per_model, long long n_cells, int n_theta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cells) return;
  const T* row = intensity + idx * n_theta;
  T f = T(0);
  for (int t = 0; t < n_theta; ++t) f += w[t] * row[t];
  f_nu[idx] = f * correction[idx / cells_per_model];
}

template <typename T>
int launch(const T* alpha, const T* source, const T* ray, const T* w,
           const T* correction, T* intensity, T* f_nu, int n_models,
           int n_depth, int n_nu, int n_theta, int inward, cudaStream_t stream) {
  const long long rays = (long long)n_models * n_nu * n_theta;
  const unsigned trace_blocks = (unsigned)((rays + THREADS - 1) / THREADS);
  if (inward) {
    trace_kernel<T, true><<<trace_blocks, THREADS, 0, stream>>>(
        alpha, source, ray, intensity, n_models, n_depth, n_nu, n_theta);
  } else {
    trace_kernel<T, false><<<trace_blocks, THREADS, 0, stream>>>(
        alpha, source, ray, intensity, n_models, n_depth, n_nu, n_theta);
  }
  int status = (int)cudaGetLastError();
  if (status) return status;
  const long long per_model = (long long)n_depth * n_nu;
  const long long cells = per_model * n_models;
  flux_kernel<T><<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      intensity, w, correction, f_nu, per_model, cells, n_theta);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha, source: [n_models, n_depth, n_nu]; ray: [n_models, n_depth - 1,
// n_theta]; w: [n_theta]; correction: [n_models]; intensity: [n_models,
// n_depth, n_nu, n_theta] (output, also the pass-1 buffer); f_nu:
// [n_models, n_depth, n_nu]; inward: 1 for spherical models.
extern "C" int formal_solution_f32(const float* alpha, const float* source,
                                   const float* ray, const float* w,
                                   const float* correction, float* intensity,
                                   float* f_nu, int n_models, int n_depth,
                                   int n_nu, int n_theta, int inward,
                                   void* stream) {
  return launch<float>(alpha, source, ray, w, correction, intensity, f_nu,
                       n_models, n_depth, n_nu, n_theta, inward,
                       (cudaStream_t)stream);
}

extern "C" int formal_solution_f64(const double* alpha, const double* source,
                                   const double* ray, const double* w,
                                   const double* correction, double* intensity,
                                   double* f_nu, int n_models, int n_depth,
                                   int n_nu, int n_theta, int inward,
                                   void* stream) {
  return launch<double>(alpha, source, ray, w, correction, intensity, f_nu,
                        n_models, n_depth, n_nu, n_theta, inward,
                        (cudaStream_t)stream);
}

extern "C" const char* formal_solution_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
