// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel flink_tensorflow_tpu/ops/flash_attention.py:
// _build_flash_call (kernel body :192-243, pl.pallas_call :245-281),
// entered there via flash_attention (:30) and _flash_bh (:160).
//
// What it computes (the same function as the TPU kernel, not its blocks):
//   o[b,t,h,:] = softmax_k(scale * q[b,t,h,:] . k[b,k,h,:]) @ v[b,:,h,:]
//   lse[b,h,t] = log sum_k exp(scale * q . k)
// with scale = 1/sqrt(D), both products in f32 after upcasting the inputs,
// an optional causal mask k_pos <= q_pos aligned top-left (also when
// Tk != T), and rows with nothing visible giving o = 0, lse = -inf.
//
// Design:
//   - one CTA per (b*h, 64-row q tile); 256 threads;
//   - q, k, v and o are read and written strided in their [B, T, H, D]
//     layout (last dim contiguous), so the wrapper does no transpose;
//   - the k sweep is a loop inside the CTA over 64-key tiles staged in
//     shared memory (upcast to f32 on load); the causal loop stops at the
//     diagonal, so tiles above it are never read;
//   - running max, denominator and the output accumulator are f32 per row:
//     the max/denominator in shared memory, the accumulator in registers
//     (each thread owns 4 rows x D/16 columns);
//   - ragged T and Tk tails are masked here: rows past T are neither
//     loaded nor stored, keys past Tk score -inf and load as zero.
//
// Bound on the H100: at the serving shape (B=8, T=16, H=4, D=16) the work
// is a few hundred KFLOP and ~70 KB, far below a microsecond of either
// roof, so launch latency dominates.  At long T the f32 path is bound by
// the FMA rate (67 TFLOP/s outside the tensor cores): scores and P.V are
// FMA loops over shared memory.  For bf16/f16 inputs the true bound is the
// tensor cores (989 TFLOP/s); this first kernel still runs FMA in f32 and
// is therefore far from that bound.  mma.sync / wgmma with TMA-fed tiles
// are the follow-up that moves it there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 thread grid, 4 rows each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D+1], Ks[BK][D+1], Vs[BK][D], Ss[BQ][BK+1], m/l/alpha[BQ]
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t qsb, int64_t qst, int64_t qsh,
                 int64_t ksb, int64_t kst, int64_t ksh,
                 int64_t vsb, int64_t vst, int64_t vsh,
                 int causal, float scale) {
  constexpr int QS = D + 1;       // padded row strides (bank spread)
  constexpr int KS = D + 1;
  constexpr int SS = BK + 1;
  constexpr int NJ = D / 16;      // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * D;
  float* Ms = Ss + BQ * SS;
  float* Ls = Ms + BQ;
  float* As = Ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;        // 0..15 -> rows ty*4 .. ty*4+3
  const int tx = tid & 15;        // 0..15 -> cols tx + 16*j
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  // q tile, pre-scaled as the TPU kernel does (q * scale, then the dot).
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * QS + d] = (t < Tq) ? to_f32(qb[t * qst + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // Causal, top-left aligned: row t sees keys 0..t, so this tile's last
  // row (q0 + BQ - 1) bounds the sweep.
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile's readers are done with Ks/Vs/Ss
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool ok = s < Tk;
      Ks[r * KS + d] = ok ? to_f32(kb[s * kst + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vb[s * vst + d]) : 0.f;
    }
    __syncthreads();

    // Scores: each thread a 4 x 4 block (rows ty*4+i, keys tx+16*j).
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int kpos = k0 + c;
          const bool vis = kpos < Tk && (!causal || kpos <= qpos);
          Ss[r * SS + c] = vis ? s[i][j] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows w*8 .. w*8+7; each lane 2 keys.
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int rr = 0; rr < BQ / 8; ++rr) {
        const int r = warp * (BQ / 8) + rr;
        const float s0 = Ss[r * SS + lane];
        const float s1 = Ss[r * SS + lane + 32];
        float mb = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mb);
        const bool dead = isinf(m_new);             // nothing visible yet
        const float safe_m = dead ? 0.f : m_new;
        const float p0 = (dead || isinf(s0)) ? 0.f : expf(s0 - safe_m);
        const float p1 = (dead || isinf(s1)) ? 0.f : expf(s1 - safe_m);
        float ps = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        Ss[r * SS + lane] = p0;
        Ss[r * SS + lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float alpha = isinf(m_old) ? 0.f : expf(m_old - safe_m);
          Ms[r] = m_new;
          Ls[r] = Ls[r] * alpha + ps;
          As[r] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
      }
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pv[4], vv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * SS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  // Finalize: o = acc / l (l == 0 -> o = 0), lse = m + log(l) or -inf.
  const int64_t ost = (int64_t)H * D;          // o is contiguous [B, T, H, D]
  T* ob = o + (int64_t)b * Tq * ost + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= Tq) continue;
    const float l = Ls[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[t * ost + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
  if (tid < BQ && q0 + tid < Tq) {
    const float l = Ls[tid];
    lse[(int64_t)bh * Tq + q0 + tid] =
        (l == 0.f) ? -INFINITY : Ms[tid] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Tq, int Tk,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Tq, int Tk,
                       const int64_t* qs, const int64_t* ks, const int64_t* vs,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements
// for the (batch, time, head) axes of [B, T, H, D]; the D axis must be
// contiguous.  Returns the cudaError_t of the launch (0 = success).
extern "C" int ftt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int Tq, int Tk, int D,
    int64_t qsb, int64_t qst, int64_t qsh,
    int64_t ksb, int64_t kst, int64_t ksh,
    int64_t vsb, int64_t vst, int64_t vsh,
    int causal, void* stream) {
  if (Tq == 0 || B * H == 0) return 0;
  const int64_t qs[3] = {qsb, qst, qsh};
  const int64_t ks[3] = {ksb, kst, ksh};
  const int64_t vs[3] = {vsb, vst, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 1: return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 2: return (int)dispatch_d<__half>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
