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
//                       TPU; here a serial loop over depth in registers
// and the vmapped model axis of stardis_tpu/parallel/batch.py:225.
//
// Design: one block owns a tile of F frequencies of one model and all T
// angles, one thread per (frequency, angle), theta the fastest index.
//  * What does not depend on theta is staged in shared memory once per
//    block: the mean extinction of each gap, m[g][f] = exp(0.5 (ln a_{g+1}
//    + ln a_g)) (the T threads of a frequency split its gaps; the same
//    expression in the same order as compute_taus, so the same bits), the
//    source S[d][f], the model's chords ray[g][t] and the theta weights.
//    A step then forms tau = m[g][f] ray[g][t] with one product and keeps
//    only the weights' exp and the divisions.
//  * The spherical variant (INWARD) first runs the inward sweep
//    I[g] = a'_g I[g+1] + b'_g from the surface gap G-1 down to gap 0,
//    starting from 0; its result seeds the outward sweep.  At g = 0 the
//    reference wraps: tau[g-1] is tau[G-1] and source[g-1] is source[G], the
//    last element of the full source array.  Chords that miss inner shells
//    have ray distance 0, so tau = 0 there, and a gap whose tau[g] or
//    tau[g-1] is 0 passes the intensity through.
//  * Each step sums (1 - w0) I + w0 S + second + third in the reference's
//    order.  The third term's quotient (s_k - s_{k+1}) / safe(tau_k) is the
//    exact negation of the previous step's (s_{k+1} - s_k) / safe(tau_k),
//    so it is carried over negated (in the inward sweep likewise); nothing
//    else is reused, so every value rounds as in the plain version.
//  * The theta sum is fused: each thread writes its intensity at every
//    depth to a shared buffer [CHUNK][F][T], and after one barrier per
//    chunk of depths one thread per (depth, frequency) sums w_t I_t in
//    theta order from 0 and writes F_nu = correction * sum.  The buffer is
//    double-buffered, so the next chunk's steps overlap the sums.  A chunk
//    of 8 depths keeps the buffer at 10 KB (float32, F = 8, T = 20), where
//    [D][F][T] would hold 72 KB and cap the blocks an SM keeps in flight.
//  * I[b, d, n, t] ([B, D, N, T], the JAX layout of I_nus per model) is
//    written only when the caller passes a buffer: when I_nu is tracked
//    (Kernel 2b recomputes the sweep and reads none).  The store is coalesced:
//    at one depth the block's threads write F T consecutive elements.
//
// Built with -fmad=false (_cuda.KERNEL_FLAGS): every product and sum rounds
// on its own, in the plain version's order, so kernel and plain agree bit
// for bit on I_nu where the weights cancel (w1 = w0 - tau e just above the
// Taylor threshold) and where the gap-0 wrap divides by a small surface tau.
//
// What bounds it on the H100: the issue of each ray's serial steps, not the
// bytes (alpha and source read once, F_nu written once: 6.7 MB at 56 depths
// x 10k nu, 2 us at 3.35 TB/s; 45 MB more when I_nu is stored).  At 20
// theta a model is 1.1e7 steps (twice that with the inward sweep); an
// interior step is 153 SASS instructions (float32, both weight branches
// and the divisions' slow-path calls counted once), of which the five IEEE
// divisions take ~10 each on their fast path (a subroutine where FCHK
// finds an operand out of its range), the weights' exp ~12, and a warp
// whose rays straddle a weight regime runs two branches.  Built with
// approximate divisions (wrong bits) the kernel takes 23-56 % less time.
// A block of 8 frequencies x 20 angles (160 threads, 40 registers in
// float32) keeps 10 blocks on an SM; 4, 12, 16 and 24 frequencies, and
// theta-sum chunks of 4 or 16 depths, ran from 4 % faster to 20 % slower
// than it, depending on the shape.

#include <cuda_runtime.h>

namespace {

// the most threads (F T) a block may have; the wrapper raises beyond it
constexpr int MAX_THREADS = 512;

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

// elements of one block's shared memory: m [G][F], S [D][F], ray [G][T],
// w [T] and the theta-sum buffer [2][chunk][F][T]
__host__ __device__ inline size_t shared_elems(int n_depth, int n_theta, int tile,
                                               int chunk) {
  const size_t gaps = (size_t)(n_depth - 1);
  return gaps * tile + (size_t)n_depth * tile + gaps * n_theta + n_theta +
         2 * (size_t)chunk * tile * n_theta;
}

// grid (tiles of `tile` frequencies, models), block tile * n_theta threads
template <typename T, bool INWARD>
__global__ void __launch_bounds__(MAX_THREADS)
trace_kernel(const T* __restrict__ alpha_all, const T* __restrict__ source_all,
             const T* __restrict__ ray_all, const T* __restrict__ w_all,
             const T* __restrict__ correction, T* __restrict__ intensity_all,
             T* __restrict__ f_nu_all, int n_depth, int n_nu, int n_theta, int tile,
             int chunk) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int n_gaps = n_depth - 1;
  const int threads = tile * n_theta;
  const int tid = threadIdx.x;
  const int f = tid / n_theta;
  const int t = tid - f * n_theta;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tile;
  const int n = n0 + f;
  const bool valid = n < n_nu;
  // a thread past the grid's edge runs the last column and writes nothing
  const int nc = valid ? n : n_nu - 1;
  const size_t cells = (size_t)n_depth * n_nu;
  const T* alpha = alpha_all + b * cells;
  const T* source = source_all + b * cells;

  T* m = reinterpret_cast<T*>(shared_raw);
  T* s = m + (size_t)n_gaps * tile;
  T* ray = s + (size_t)n_depth * tile;
  T* w = ray + (size_t)n_gaps * n_theta;
  T* buf = w + n_theta;

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
    s[i] = source[(size_t)d * n_nu + min(n0 + (i - d * tile), n_nu - 1)];
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

  // --- inward sweep (spherical) ------------------------------------------
  T I = T(0);
  if (INWARD) {
    const T tau_top = tau(n_gaps - 1);
    T tau_g = tau_top;
    // (s_gp1 - s_g) / safe(tau_g) of the surface gap
    T q_g = (src(n_gaps) - src(n_gaps - 1)) / safe(tau_g);
    for (int g = n_gaps - 1; g >= 0; --g) {
      const T tau_gm1 = g > 0 ? tau(g - 1) : tau_top;
      const T s_g = src(g);
      const T s_gp1 = src(g + 1);
      const T s_gm1 = src(g > 0 ? g - 1 : n_gaps);
      T w0, w1, w2;
      weights(tau_g, w0, w1, w2);
      const T denom = safe(tau_g + tau_gm1);
      const T second = w1 * ((s_g - s_gm1) * (tau_g / safe(tau_gm1)) -
                             (s_g - s_gp1) * (tau_gm1 / safe(tau_g))) / denom;
      const T q_gm1 = (s_gm1 - s_g) / safe(tau_gm1);
      const T third = w2 * (q_gm1 + q_g) / denom;
      if (tau_g != T(0) && tau_gm1 != T(0)) I = (T(1) - w0) * I + w0 * s_g + second + third;
      tau_g = tau_gm1;
      q_g = -q_gm1;
    }
  }

  // --- outward sweep, theta sum per chunk of depths -----------------------
  const T corr = correction[b];
  T* intensity = intensity_all == nullptr
                     ? nullptr
                     : intensity_all + b * cells * n_theta + (size_t)n * n_theta + t;
  const size_t plane = (size_t)n_nu * n_theta;  // one depth of intensity
  T* f_nu = f_nu_all + b * cells;
  T tau_k = tau(0);
  T s_k = src(0);
  T s_kp1 = src(1);
  // (s_k - s_kp1) / safe(tau_k): the third term's second quotient
  T q_k = (s_k - s_kp1) / safe(tau_k);
  for (int d0 = 0, half = 0; d0 < n_depth; d0 += chunk, half ^= 1) {
    T* part = buf + (size_t)half * chunk * threads;
    const int d1 = min(d0 + chunk, n_depth);
    for (int d = d0; d < d1; ++d) {
      if (d > 0 && d < n_gaps) {  // interior gap k = d - 1
        const T tau_kp1 = tau(d);
        const T s_kp2 = src(d + 1);
        T w0, w1, w2;
        weights(tau_k, w0, w1, w2);
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
      } else if (d > 0) {  // last gap: constant-source boundary jump
        T w0, w1, w2;
        weights(tau_k, w0, w1, w2);
        const T st = safe(tau_k);
        const T third = w2 * (s_k - s_kp1) / (st * st);
        if (tau_k != T(0)) I = (T(1) - w0) * I + w0 * s_kp1 + third;
      }
      part[(d - d0) * threads + tid] = I;
      if (intensity != nullptr && valid) intensity[(size_t)d * plane] = I;
    }
    __syncthreads();
    for (int i = tid; i < (d1 - d0) * tile; i += threads) {
      const int dd = i / tile;
      const int ff = i - dd * tile;
      if (n0 + ff < n_nu) {
        const T* row = part + dd * threads + ff * n_theta;
        T sum = T(0);
        for (int tt = 0; tt < n_theta; ++tt) sum += w[tt] * row[tt];
        f_nu[(size_t)(d0 + dd) * n_nu + n0 + ff] = sum * corr;
      }
    }
  }
}

template <typename T>
int launch(const T* alpha, const T* source, const T* ray, const T* w,
           const T* correction, T* intensity, T* f_nu, int n_models,
           int n_depth, int n_nu, int n_theta, int tile, int chunk, int inward,
           cudaStream_t stream) {
  const int threads = tile * n_theta;
  if (tile < 1 || chunk < 1 || n_depth < 2 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_elems(n_depth, n_theta, tile, chunk) * sizeof(T);
  auto kernel = inward ? trace_kernel<T, true> : trace_kernel<T, false>;
  if (shared > 48 * 1024) {  // above 48 KB only by the kernel's own opt-in
    const int status = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (status) return status;
  }
  const dim3 grid((unsigned)((n_nu + tile - 1) / tile), (unsigned)n_models);
  kernel<<<grid, threads, shared, stream>>>(alpha, source, ray, w, correction,
                                            intensity, f_nu, n_depth, n_nu,
                                            n_theta, tile, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha, source: [n_models, n_depth, n_nu]; ray: [n_models, n_depth - 1,
// n_theta]; w: [n_theta]; correction: [n_models]; intensity: [n_models,
// n_depth, n_nu, n_theta] or null (not written); f_nu: [n_models, n_depth,
// n_nu]; tile: frequencies per block; chunk: depths per theta sum; inward:
// 1 for spherical models.
extern "C" int formal_solution_f32(const float* alpha, const float* source,
                                   const float* ray, const float* w,
                                   const float* correction, float* intensity,
                                   float* f_nu, int n_models, int n_depth,
                                   int n_nu, int n_theta, int tile, int chunk,
                                   int inward, void* stream) {
  return launch<float>(alpha, source, ray, w, correction, intensity, f_nu,
                       n_models, n_depth, n_nu, n_theta, tile, chunk, inward,
                       (cudaStream_t)stream);
}

extern "C" int formal_solution_f64(const double* alpha, const double* source,
                                   const double* ray, const double* w,
                                   const double* correction, double* intensity,
                                   double* f_nu, int n_models, int n_depth,
                                   int n_nu, int n_theta, int tile, int chunk,
                                   int inward, void* stream) {
  return launch<double>(alpha, source, ray, w, correction, intensity, f_nu,
                        n_models, n_depth, n_nu, n_theta, tile, chunk, inward,
                        (cudaStream_t)stream);
}

// dynamic shared bytes of one block (the wrapper's check reads the same
// layout)
extern "C" long long formal_solution_shared_bytes(int n_depth, int n_theta, int tile,
                                                  int chunk, int itemsize) {
  return (long long)(shared_elems(n_depth, n_theta, tile, chunk) * itemsize);
}

extern "C" const char* formal_solution_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
