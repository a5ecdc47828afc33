// Train-mode batch norm for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves batch norm to XLA,
// which fuses it.  Run as PyTorch's separate elementwise and reduction
// ops, train-mode batch norm held about 78% of ResNet-50's device time on
// the H100 (the benchmark's traced resnet50-train breakdown before this
// kernel), in some 45 kernels per norm and step.  This file does the same
// arithmetic in two passes forward and two backward.
//
// What it computes, on channels_last activations x [N, C, H, W] (memory
// [M, C] with M = N*H*W rows and the channels contiguous), bf16 or f32:
//   forward   mu = sum(x)/M, q = sum(x^2)/M (f32 from the input type),
//             v = max(q - mu^2, 0) (flax's E[x^2] - E[x]^2, biased),
//             a = rsqrt(v + eps) * gamma,
//             out = relu?(round((x - mu) * a + beta)), one rounding to the
//             input type, the arithmetic f32 in the plain path's order;
//             the running statistics momentum * r + (1 - momentum) * (mu, v);
//   backward  dz = dout * [out > 0] (no mask without the ReLU),
//             dbeta = sum(dz), S = sum(dz * (x - mu)), dgamma = S * r with
//             r = rsqrt(v + eps), dv = -gamma r^3 S / 2 (0 where
//             q - mu^2 < 0: the clamp passes no gradient there),
//             dmu = -a dbeta - 2 mu dv, dq = dv, and
//             dx = round(dz a + dmu / M + 2 x dq / M):
//             the exact gradient of the forward formula.
// Between the passes the caller may average (mu, q), and later (dmu, dq),
// over a data-parallel group (phase 1, then phase 2).
//
// Bound on the H100: HBM bytes.  Each pass streams the activation once
// (statistics: read x; normalise: read x, write out; reduction: read dout
// and x; dx: read dout and x, write dx), 16 bytes an element in bf16; the
// ReLU's mask is recomputed from x, so out is not read again.  Design: a
// thread owns V consecutive channels (16-byte loads: 8 bf16 or 4 f32 when
// C allows, else one element) and walks rows with a fixed stride, four
// loads in flight; the blocks of a grid cover the channels in x and the
// rows in y, enough of them to fill every SM.  Reductions are
// deterministic, with no atomics: each thread sums its rows in order, each
// block sums its threads in order into its own row of a partial buffer
// [blocks, 2, C], and a second small kernel sums those rows in a fixed
// order.  The same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // most threads of a streaming block
constexpr int kMaxTx = 32;       // threads across the channels of one block
constexpr int kBlocksPerSm = 4;  // streaming blocks per SM in a grid
constexpr int kUnroll = 4;       // row loads in flight per thread
constexpr int kFinSlices = 8;    // row slices of the partials per finalize block

enum Phase { kReduce = 1, kApply = 2 };
enum Dtype { kF32 = 0, kBf16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// q - mu^2 in the plain path's order (no fused multiply-add), so the
// clamp sees the same sign; NaN stays NaN.
__device__ __forceinline__ float moment_diff(float mu, float q) {
  return __fsub_rn(q, __fmul_rn(mu, mu));
}
__device__ __forceinline__ float clamp0(float d) { return d < 0.f ? 0.f : d; }

// The normalised value of f, rounded to T, ReLU applied: as the forward
// writes it.  The backward calls it to recompute the ReLU's mask.
template <typename T>
__device__ __forceinline__ T normalise(float f, float mu, float a, float b, bool relu) {
  const T o = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(f, mu), a), b));
  return relu && to_f(o) <= 0.f ? round_to<T>(0.f) : o;  // NaN passes, as torch's relu
}

struct Geometry {
  int v, tx, ty, gx, gy;
};

int widest(int dtype, int c) {
  const int v = dtype == kBf16 ? 8 : 4;
  return c % v == 0 ? v : 1;
}

// Threads: tx across channels (V each), ty across rows; blocks: gx across
// channels, gy across rows.  Depends only on (dtype, M, C, the SM count),
// so the partial buffer's rows (gy) are known before a launch.
Geometry geometry(int dtype, int64_t m, int c) {
  Geometry g;
  g.v = widest(dtype, c);
  const int lanes = c / g.v;
  g.gx = (lanes + kMaxTx - 1) / kMaxTx;
  g.tx = (lanes + g.gx - 1) / g.gx;
  g.ty = kThreads / g.tx;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = ((int64_t)sms * kBlocksPerSm + g.gx - 1) / g.gx;
  const int64_t per_block = (int64_t)g.ty * kUnroll;
  const int64_t most = (m + per_block - 1) / per_block;
  int64_t gy = want < most ? want : most;
  if (gy > 65535) gy = 65535;
  g.gy = gy < 1 ? 1 : (int)gy;
  return g;
}

// Each thread's rows: r0, r0 + step, ... < m.
struct Rows {
  int64_t r0, step;
  int c0;
  bool on;
};

__device__ __forceinline__ Rows rows_of(int tx_n, int ty_n, int v, int c) {
  Rows r;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  r.c0 = (blockIdx.x * tx_n + tx) * v;
  r.on = r.c0 < c;
  r.r0 = (int64_t)blockIdx.y * ty_n + ty;
  r.step = (int64_t)gridDim.y * ty_n;
  return r;
}

// The block's V-wide sums s and t of each thread, summed over its rows of
// threads in order and written as row blockIdx.y of part [gy, 2, C].
template <int V>
__device__ __forceinline__ void block_partials(const float* s, const float* t, int tx_n,
                                               int ty_n, int c, float* __restrict__ part) {
  __shared__ float sh[2][kThreads * 8];
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int width = tx_n * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[0][ty * width + tx * V + i] = s[i];
    sh[1][ty * width + tx * V + i] = t[i];
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float a = 0.f, b = 0.f;
    for (int y = 0; y < ty_n; ++y) {
      a += sh[0][y * width + threadIdx.x];
      b += sh[1][y * width + threadIdx.x];
    }
    const int ch = blockIdx.x * width + threadIdx.x;
    if (ch < c) {
      part[(size_t)blockIdx.y * 2 * c + ch] = a;
      part[((size_t)blockIdx.y * 2 + 1) * c + ch] = b;
    }
  }
}

// Forward pass 1: sum(x) and sum(x^2) per channel, partial per block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_partial(const T* __restrict__ x, int64_t m, int c, int tx_n, int ty_n,
                  float* __restrict__ part) {
  using P = Pack<T, V>;
  const Rows w = rows_of(tx_n, ty_n, V, c);
  float s[V], t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = t[i] = 0.f;
  if (w.on) {
    const T* base = x + w.c0;
    int64_t r = w.r0;
    for (; r + (kUnroll - 1) * w.step < m; r += kUnroll * w.step) {
      P p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        p[u] = *reinterpret_cast<const P*>(base + (r + u * w.step) * c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float f = to_f(p[u].v[i]);
          s[i] += f;
          t[i] = fmaf(f, f, t[i]);
        }
    }
    for (; r < m; r += w.step) {
      const P p = *reinterpret_cast<const P*>(base + r * c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(p.v[i]);
        s[i] += f;
        t[i] = fmaf(f, f, t[i]);
      }
    }
  }
  block_partials<V>(s, t, tx_n, ty_n, c, part);
}

// The partials' two rows summed over the gy blocks in a fixed order:
// thread (slice, lane) takes rows slice, slice + 8, ...; slice 0 adds the
// eight slices in order.  Calls fin(ch, sum0, sum1).
template <typename Fin>
__device__ __forceinline__ void sum_partials(const float* __restrict__ part, int gy, int c,
                                             Fin fin) {
  __shared__ float sh[2][kFinSlices][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (ch < c)
    for (int p = slice; p < gy; p += kFinSlices) {
      a += part[(size_t)p * 2 * c + ch];
      b += part[((size_t)p * 2 + 1) * c + ch];
    }
  sh[0][slice][lane] = a;
  sh[1][slice][lane] = b;
  __syncthreads();
  if (slice == 0 && ch < c) {
    a = 0.f;
    b = 0.f;
    for (int k = 0; k < kFinSlices; ++k) {
      a += sh[0][k][lane];
      b += sh[1][k][lane];
    }
    fin(ch, a, b);
  }
}

// moments [2, C]: E[x], E[x^2].
__global__ void __launch_bounds__(kFinSlices * 32)
    finalize_moments(const float* __restrict__ part, int gy, int64_t m, int c,
                     float* __restrict__ moments) {
  const float mf = (float)m;
  sum_partials(part, gy, c, [&](int ch, float s, float t) {
    moments[ch] = s / mf;
    moments[c + ch] = t / mf;
  });
}

// Forward pass 2: normalise (+ ReLU); the blocks of row 0 write the new
// running statistics [2, C].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    apply_norm(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ moments,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ run_mean, const float* __restrict__ run_var,
               float* __restrict__ new_stats, int64_t m, int c, int tx_n, int ty_n, float eps,
               float momentum, float keep, int relu) {
  using P = Pack<T, V>;
  const Rows w = rows_of(tx_n, ty_n, V, c);
  if (!w.on) return;
  float mu[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = w.c0 + i;
    mu[i] = moments[ch];
    const float v = clamp0(moment_diff(mu[i], moments[c + ch]));
    a[i] = __fmul_rn(rsqrtf(__fadd_rn(v, eps)), gamma[ch]);
    b[i] = beta[ch];
    if (w.r0 == 0) {
      new_stats[ch] = __fadd_rn(__fmul_rn(momentum, run_mean[ch]), __fmul_rn(keep, mu[i]));
      new_stats[c + ch] = __fadd_rn(__fmul_rn(momentum, run_var[ch]), __fmul_rn(keep, v));
    }
  }
  const bool r_on = relu != 0;
  const T* xb = x + w.c0;
  T* yb = y + w.c0;
  int64_t r = w.r0;
  for (; r + (kUnroll - 1) * w.step < m; r += kUnroll * w.step) {
    P p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      p[u] = *reinterpret_cast<const P*>(xb + (r + u * w.step) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      P o;
#pragma unroll
      for (int i = 0; i < V; ++i) o.v[i] = normalise<T>(to_f(p[u].v[i]), mu[i], a[i], b[i], r_on);
      *reinterpret_cast<P*>(yb + (r + u * w.step) * c) = o;
    }
  }
  for (; r < m; r += w.step) {
    const P p = *reinterpret_cast<const P*>(xb + r * c);
    P o;
#pragma unroll
    for (int i = 0; i < V; ++i) o.v[i] = normalise<T>(to_f(p.v[i]), mu[i], a[i], b[i], r_on);
    *reinterpret_cast<P*>(yb + r * c) = o;
  }
}

// The per-channel constants both backward passes share.
template <int V>
__device__ __forceinline__ void channel_consts(const Rows& w, const float* moments,
                                               const float* gamma, const float* beta, int c,
                                               float eps, float* mu, float* a, float* b) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = w.c0 + i;
    mu[i] = moments[ch];
    const float v = clamp0(moment_diff(mu[i], moments[c + ch]));
    a[i] = __fmul_rn(rsqrtf(__fadd_rn(v, eps)), gamma[ch]);
    b[i] = beta[ch];
  }
}

// dout masked by the ReLU of the recomputed output.
template <typename T>
__device__ __forceinline__ float masked(float d, float f, float mu, float a, float b, bool relu) {
  return relu && to_f(normalise<T>(f, mu, a, b, false)) <= 0.f ? 0.f : d;
}

// Backward pass 1: sum(dz) and sum(dz * (x - mu)) per channel, partial
// per block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ moments, const float* __restrict__ gamma,
                 const float* __restrict__ beta, int64_t m, int c, int tx_n, int ty_n, float eps,
                 int relu, float* __restrict__ part) {
  using P = Pack<T, V>;
  const Rows w = rows_of(tx_n, ty_n, V, c);
  float s[V], t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = t[i] = 0.f;
  if (w.on) {
    float mu[V], a[V], b[V];
    channel_consts<V>(w, moments, gamma, beta, c, eps, mu, a, b);
    const bool r_on = relu != 0;
    const T* xb = x + w.c0;
    const T* db = dy + w.c0;
    int64_t r = w.r0;
    for (; r + (kUnroll - 1) * w.step < m; r += kUnroll * w.step) {
      P p[kUnroll], d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = *reinterpret_cast<const P*>(xb + (r + u * w.step) * c);
        d[u] = *reinterpret_cast<const P*>(db + (r + u * w.step) * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float f = to_f(p[u].v[i]);
          const float z = masked<T>(to_f(d[u].v[i]), f, mu[i], a[i], b[i], r_on);
          s[i] += z;
          t[i] = fmaf(z, __fsub_rn(f, mu[i]), t[i]);
        }
    }
    for (; r < m; r += w.step) {
      const P p = *reinterpret_cast<const P*>(xb + r * c);
      const P d = *reinterpret_cast<const P*>(db + r * c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(p.v[i]);
        const float z = masked<T>(to_f(d.v[i]), f, mu[i], a[i], b[i], r_on);
        s[i] += z;
        t[i] = fmaf(z, __fsub_rn(f, mu[i]), t[i]);
      }
    }
  }
  block_partials<V>(s, t, tx_n, ty_n, c, part);
}

// grads [4, C]: dgamma, dbeta, dmu, dq (this rank's).
__global__ void __launch_bounds__(kFinSlices * 32)
    finalize_grads(const float* __restrict__ part, int gy, int c,
                   const float* __restrict__ moments, const float* __restrict__ gamma,
                   float eps, float* __restrict__ grads) {
  sum_partials(part, gy, c, [&](int ch, float dbeta, float s) {
    const float mu = moments[ch];
    const float diff = moment_diff(mu, moments[c + ch]);
    const float r = rsqrtf(__fadd_rn(clamp0(diff), eps));
    const float g = gamma[ch];
    const float dv = diff >= 0.f ? -0.5f * g * r * r * r * s : 0.f;
    grads[ch] = s * r;
    grads[c + ch] = dbeta;
    grads[2 * c + ch] = -(r * g) * dbeta - 2.f * mu * dv;
    grads[3 * c + ch] = dv;
  });
}

// Backward pass 2: dx = dz a + dmu / M + 2 x dq / M.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_input(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
               const float* __restrict__ moments, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ grads, int64_t m, int c,
               int tx_n, int ty_n, float eps, int relu) {
  using P = Pack<T, V>;
  const Rows w = rows_of(tx_n, ty_n, V, c);
  if (!w.on) return;
  float mu[V], a[V], b[V], k1[V], k2[V];
  channel_consts<V>(w, moments, gamma, beta, c, eps, mu, a, b);
  const float mf = (float)m;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    k1[i] = grads[2 * c + w.c0 + i] / mf;
    k2[i] = 2.f * grads[3 * c + w.c0 + i] / mf;
  }
  const bool r_on = relu != 0;
  const T* xb = x + w.c0;
  const T* db = dy + w.c0;
  T* ob = dx + w.c0;
  int64_t r = w.r0;
  for (; r + (kUnroll - 1) * w.step < m; r += kUnroll * w.step) {
    P p[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = *reinterpret_cast<const P*>(xb + (r + u * w.step) * c);
      d[u] = *reinterpret_cast<const P*>(db + (r + u * w.step) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      P o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(p[u].v[i]);
        const float z = masked<T>(to_f(d[u].v[i]), f, mu[i], a[i], b[i], r_on);
        o.v[i] = round_to<T>(fmaf(z, a[i], fmaf(f, k2[i], k1[i])));
      }
      *reinterpret_cast<P*>(ob + (r + u * w.step) * c) = o;
    }
  }
  for (; r < m; r += w.step) {
    const P p = *reinterpret_cast<const P*>(xb + r * c);
    const P d = *reinterpret_cast<const P*>(db + r * c);
    P o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f(p.v[i]);
      const float z = masked<T>(to_f(d.v[i]), f, mu[i], a[i], b[i], r_on);
      o.v[i] = round_to<T>(fmaf(z, a[i], fmaf(f, k2[i], k1[i])));
    }
    *reinterpret_cast<P*>(ob + r * c) = o;
  }
}

struct Args {
  int phase, relu;
  int64_t m;
  int c;
  float eps, momentum, keep;
  const void* x;
  const void* dy;
  void* out;
  const float* gamma;
  const float* beta;
  const float* run_mean;
  const float* run_var;
  float* moments;  // [2, C]
  float* stats;    // forward: new running statistics [2, C]; backward: grads [4, C]
  float* part;     // [gy, 2, C]
};

template <typename T, int V>
int forward(const Args& a, const Geometry& g, cudaStream_t st) {
  const dim3 grid(g.gx, g.gy), block(g.tx * g.ty);
  const int fin_blocks = (a.c + 31) / 32;
  if (a.phase & kReduce) {
    stats_partial<T, V><<<grid, block, 0, st>>>(static_cast<const T*>(a.x), a.m, a.c, g.tx,
                                                g.ty, a.part);
    finalize_moments<<<fin_blocks, kFinSlices * 32, 0, st>>>(a.part, g.gy, a.m, a.c,
                                                             a.moments);
  }
  if (a.phase & kApply)
    apply_norm<T, V><<<grid, block, 0, st>>>(
        static_cast<const T*>(a.x), static_cast<T*>(a.out), a.moments, a.gamma, a.beta,
        a.run_mean, a.run_var, a.stats, a.m, a.c, g.tx, g.ty, a.eps, a.momentum, a.keep, a.relu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int backward(const Args& a, const Geometry& g, cudaStream_t st) {
  const dim3 grid(g.gx, g.gy), block(g.tx * g.ty);
  const int fin_blocks = (a.c + 31) / 32;
  if (a.phase & kReduce) {
    grad_partial<T, V><<<grid, block, 0, st>>>(static_cast<const T*>(a.x),
                                               static_cast<const T*>(a.dy), a.moments, a.gamma,
                                               a.beta, a.m, a.c, g.tx, g.ty, a.eps, a.relu,
                                               a.part);
    finalize_grads<<<fin_blocks, kFinSlices * 32, 0, st>>>(a.part, g.gy, a.c, a.moments,
                                                           a.gamma, a.eps, a.stats);
  }
  if (a.phase & kApply)
    grad_input<T, V><<<grid, block, 0, st>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<T*>(a.out),
        a.moments, a.gamma, a.beta, a.stats, a.m, a.c, g.tx, g.ty, a.eps, a.relu);
  return (int)cudaGetLastError();
}

template <bool Fwd>
int run(int dtype, const Args& a, void* stream) {
  if (a.m <= 0 || a.c <= 0 || (a.phase & 3) == 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(dtype, a.m, a.c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBf16) {
    if (g.v == 8) return Fwd ? forward<__nv_bfloat16, 8>(a, g, st) : backward<__nv_bfloat16, 8>(a, g, st);
    return Fwd ? forward<__nv_bfloat16, 1>(a, g, st) : backward<__nv_bfloat16, 1>(a, g, st);
  }
  if (dtype == kF32) {
    if (g.v == 4) return Fwd ? forward<float, 4>(a, g, st) : backward<float, 4>(a, g, st);
    return Fwd ? forward<float, 1>(a, g, st) : backward<float, 1>(a, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rows of the partial buffer [rows, 2, C] f32 that a call on (dtype, M, C)
// needs on the current device; -1 for a shape the kernels do not take.
extern "C" int ftt_bn_partial_rows(int dtype, int64_t m, int c) {
  if (m <= 0 || c <= 0 || (dtype != kF32 && dtype != kBf16)) return -1;
  return geometry(dtype, m, c).gy;
}

// The width in elements of one thread's loads: the base pointers of the
// activations must be aligned to width * element size.
extern "C" int ftt_bn_vector_width(int dtype, int c) { return widest(dtype, c); }

// phase 1: moments [2, C] from x; phase 2: out and the new running
// statistics [2, C] from moments; 3: both.  Returns cudaGetLastError().
extern "C" int ftt_bn_forward(int dtype, int phase, int relu, int64_t m, int c, float eps,
                              float momentum, float keep, const void* x, void* out,
                              const float* gamma, const float* beta, const float* run_mean,
                              const float* run_var, float* moments, float* new_stats,
                              float* part, void* stream) {
  Args a{phase, relu, m, c, eps, momentum, keep, x, nullptr, out, gamma, beta,
         run_mean, run_var, moments, new_stats, part};
  return run<true>(dtype, a, stream);
}

// phase 1: grads [4, C] (dgamma, dbeta, dmu, dq) from x and dout; phase 2:
// dx from grads' dmu and dq; 3: both.  Returns cudaGetLastError().
extern "C" int ftt_bn_backward(int dtype, int phase, int relu, int64_t m, int c, float eps,
                               const void* x, const void* dout, void* dx, const float* gamma,
                               const float* beta, const float* moments, float* grads,
                               float* part, void* stream) {
  Args a{phase, relu, m, c, eps, 0.f, 0.f, x, dout, dx, gamma, beta,
         nullptr, nullptr, const_cast<float*>(moments), grads, part};
  return run<false>(dtype, a, stream);
}
