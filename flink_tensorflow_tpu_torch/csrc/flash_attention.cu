// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel flink_tensorflow_tpu/ops/flash_attention.py:
// _build_flash_call (kernel body :192-243, pl.pallas_call :245-281),
// entered there via flash_attention (:30) and _flash_bh (:160).
//
// What it computes (the same function as the TPU kernel, not its blocks):
//   o[b,t,h,:] = softmax_k(scale * q[b,t,h,:] . k[b,k,h,:]) @ v[b,:,h,:]
//   lse[b,h,t] = log sum_k exp(scale * q . k)
// with scale = 1/sqrt(D), both products accumulated in f32, an optional
// causal mask k_pos <= q_pos aligned top-left (also when Tk != T), and rows
// with nothing visible giving o = 0, lse = -inf.
//
// Design (grid (q tiles, B*H); one consumer warpgroup of 128 threads per
// 64 query rows, two per CTA for bf16/f16 at D = 128, else one):
//   - q, k and v reach shared memory through TMA, from 4-D tensor maps
//     (D, H, T, B) built from the tensors' own strides, so strided
//     [B, T, H, D] views need no transpose.  Boxes are one swizzle row
//     wide (32, 64 or 128 bytes) and rows past T or Tk load as zeros.
//     K/V tiles go through a ring of STAGES slots, with one mbarrier for
//     the K and one for the V of each slot: the next tiles' copies are in
//     flight while this tile is computed, and in bf16/f16 S = Q.K^T starts
//     before the tile's V has landed.
//   - bf16/f16: S = Q.K^T is wgmma.mma_async m64nBKk16 with both operands
//     in shared memory (K stored [BK][D] is the K-major B operand);
//     O += P.V is wgmma with P in registers (the S fragments, rounded to
//     the input type, as FlashAttention does on this card) and V [BK][D]
//     as the MN-major ("transposed") B operand.
//   - f32: 3xTF32 on wgmma (m64nNk8.tf32): each operand x is split into
//     big = tf32(x) and small = x - big, and small.big + big.small + big.big
//     is accumulated in f32 (about 21 bits; plain TF32 keeps 10).  q is
//     split once and each K tile as it lands (big in place, small beside
//     it), both K-major for S.  wgmma takes tf32 B only K-major, and V
//     [BK][D] is MN-major for P.V, so each V tile is written transposed,
//     split in two, into V^T [D][BK]; P is split in registers and is the A
//     operand.  Hence f32 tiles hold 32 keys: the split copies share the
//     shared memory.
//   - S and P never leave registers.  The online softmax runs on the
//     accumulator fragments (each row lives in the 4 threads of a quad:
//     row max and sum by __shfl_xor_sync), in base 2 (ex2.approx).  The
//     causal mask is applied only on tiles that cross the diagonal, the
//     ragged-Tk mask only on the last tile; the causal sweep ends at
//     min(Tk, q0 + BQ).
//   - Host side: the shared-memory opt-in is set once per instance and
//     device; the three tensor maps are encoded per call.

// Bound on the H100: at the serving shape (B=8, T=16, H=4, D=16) the work
// is tens of nanoseconds of either roof; the host's launch path is the
// cost.  At long T, bf16/f16 are bound by the tensor cores (989 TFLOP/s)
// and f32 by 3 TF32 products (3 x FLOPs at 495 TFLOP/s).

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int WG_ROWS = 64;      // query rows per warpgroup (one wgmma M)
constexpr int WG_THREADS = 128;  // threads per warpgroup

// Shared-memory plan per (type, D); ftt_flash_attention_plan reports it and
// ops/flash_attention.py:launch_plan mirrors it.
template <typename T, int D>
struct Plan {
  static constexpr int ES = sizeof(T);
  static constexpr int DIM = D;
  // Consumer warpgroups per CTA: two share each K/V tile in bf16/f16 at
  // D = 128 (measured faster there); one elsewhere (at D <= 64 more CTAs
  // per SM measured faster, and f32's shared memory also holds the small
  // tf32 parts).
  static constexpr int WG = (ES == 2 && D == 128) ? 2 : 1;
  static constexpr int BQ = WG_ROWS * WG;  // query rows per CTA
  static constexpr int THREADS = WG_THREADS * WG;
  // Keys per shared-memory tile.  16-bit: 128 where the S fragment (BK/2
  // floats a thread) and P leave room for the O accumulator, else 64.
  // f32: 32, as q and each K tile also keep their small tf32 parts.
  static constexpr int BK = ES == 4 ? 32 : (D <= 64 ? 128 : 64);
  static constexpr int SPLIT = ES == 4;     // q and K keep a "small" copy
  // K/V ring depth: 3 in f32, whose 32-key tiles are short to compute, so
  // a copy needs two tiles' time to land; 2 in bf16/f16.
  static constexpr int STAGES = ES == 4 ? 3 : 2;
  static constexpr int KSTEP = 32 / ES;     // K depth of one wgmma: 32 bytes
  static constexpr int BOXC = (D * ES <= 128) ? D : 128 / ES;  // columns per TMA box
  static constexpr int ROWB = BOXC * ES;                         // swizzle span: 32/64/128 B
  static constexpr int NBOX = D / BOXC;
  static constexpr int Q_BYTES = BQ * D * ES;
  static constexpr int KV_BYTES = BK * D * ES;  // one K or one V tile
  static constexpr int RING = Q_BYTES + STAGES * 2 * KV_BYTES;  // offset of the small q
  // f32: small q, small K tile, then V^T big and small ([D][BK], K-major).
  static constexpr int KS = RING + Q_BYTES, VTB = KS + KV_BYTES, VTS = VTB + KV_BYTES;
  static constexpr int BARS = RING + SPLIT * (Q_BYTES + 3 * KV_BYTES);
  // 1024 B of slack to align the tiles to the swizzle atom, then q, the
  // ring of K/V slots, (f32) the small parts of q and of one K tile and
  // the split V^T, then one mbarrier for q and one each for the K and the
  // V of every ring slot.
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static constexpr int LAYOUT = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);  // wgmma swizzle code
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor (start, leading and stride byte
// offsets in 16-byte units, swizzle code in bits 62-63).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

// K-major operand (q or k: [rows][D], D contiguous), K step kk (32 bytes).
template <class P>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  const int col = kk * P::KSTEP;
  const uint32_t addr = tile + (col / P::BOXC) * rows * P::ROWB + (col % P::BOXC) * P::ES;
  return gmma_desc(addr, 16, 8 * P::ROWB, P::LAYOUT);
}

// MN-major B operand (v: [BK][D] with D = N contiguous), keys 16t..16t+15.
// LBO steps to the next box of BOXC columns, SBO to the next 8 keys.
template <class P>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int t) {
  return gmma_desc(tile + t * 16 * P::ROWB, P::BK * P::ROWB, 8 * P::ROWB, P::LAYOUT);
}

// f32 V^T ([D][32 keys], 128-byte rows, 128-byte swizzle), K step kk (8 keys).
__device__ __forceinline__ uint64_t vt_desc(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 32, 16, 1024, 1);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma.mma_async wrappers, only for the shapes the kernel runs.  Ss: A and
// B from shared memory, both K-major (S = Q.K^T, N = BK); `acc` = 0 makes
// the product overwrite d instead of adding to it.  Rs: A from registers,
// accumulating (O += P.V, N = D); 16-bit B is MN-major (transpose bit
// set), tf32 B is K-major (V^T).
template <typename T, int N>
struct Ss;
template <typename T, int N>
struct Rs;

#define FTT_ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FTT_ACC16(i) FTT_ACC8(i), FTT_ACC8(i + 8)
#define FTT_ACC32(i) FTT_ACC16(i), FTT_ACC16(i + 16)
#define FTT_ACC64 FTT_ACC32(0), FTT_ACC32(32)
#define FTT_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FTT_REGS16 FTT_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FTT_REGS32 \
  FTT_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FTT_REGS64                                                                            \
  FTT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
             "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// SHAPE "m64nNkK"; TY the PTX input type; REGS and ACC the N/2
// accumulators; A, B and P the operands a, b and the scale-d flag; TAIL
// the immediates after scale-d (scale-a, scale-b and, in 16-bit, the
// transpose bits).
#define FTT_SS(TYPE, SHAPE, TY, N, REGS, ACC, A, B, P, TAIL)                                 \
  template <>                                                                                \
  struct Ss<TYPE, N> {                                                                       \
    static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc) {  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, " A \
                   ", " B ", p, " TAIL ";\n}\n"                                              \
                   : ACC                                                                     \
                   : "l"(a), "l"(b), "r"(acc));                                              \
    }                                                                                        \
  };
#define FTT_RS(TYPE, SHAPE, TY, N, REGS, ACC, A, B, P, TAIL)                                  \
  template <>                                                                                 \
  struct Rs<TYPE, N> {                                                                        \
    static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                             \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, {" A \
                   "}, " B ", p, " TAIL ";\n}\n"                                              \
                   : ACC                                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));             \
    }                                                                                         \
  };

#define FTT_16BIT(TYPE, TY)                                                                   \
  FTT_SS(TYPE, "m64n64k16", TY, 64, FTT_REGS32, FTT_ACC32(0), "%32", "%33", "%34",            \
         "1, 1, 0, 0")                                                                        \
  FTT_SS(TYPE, "m64n128k16", TY, 128, FTT_REGS64, FTT_ACC64, "%64", "%65", "%66",             \
         "1, 1, 0, 0")                                                                        \
  FTT_RS(TYPE, "m64n16k16", TY, 16, FTT_REGS8, FTT_ACC8(0), "%8, %9, %10, %11", "%12", "%13", \
         "1, 1, 1")                                                                           \
  FTT_RS(TYPE, "m64n32k16", TY, 32, FTT_REGS16, FTT_ACC16(0), "%16, %17, %18, %19", "%20",    \
         "%21", "1, 1, 1")                                                                    \
  FTT_RS(TYPE, "m64n64k16", TY, 64, FTT_REGS32, FTT_ACC32(0), "%32, %33, %34, %35", "%36",    \
         "%37", "1, 1, 1")                                                                    \
  FTT_RS(TYPE, "m64n128k16", TY, 128, FTT_REGS64, FTT_ACC64, "%64, %65, %66, %67", "%68",     \
         "%69", "1, 1, 1")
FTT_16BIT(__nv_bfloat16, "bf16")
FTT_16BIT(__half, "f16")
FTT_SS(float, "m64n32k8", "tf32", 32, FTT_REGS16, FTT_ACC16(0), "%16", "%17", "%18", "1, 1")
FTT_RS(float, "m64n16k8", "tf32", 16, FTT_REGS8, FTT_ACC8(0), "%8, %9, %10, %11", "%12", "%13",
       "1, 1")
FTT_RS(float, "m64n32k8", "tf32", 32, FTT_REGS16, FTT_ACC16(0), "%16, %17, %18, %19", "%20",
       "%21", "1, 1")
FTT_RS(float, "m64n64k8", "tf32", 64, FTT_REGS32, FTT_ACC32(0), "%32, %33, %34, %35", "%36",
       "%37", "1, 1")
FTT_RS(float, "m64n128k8", "tf32", 128, FTT_REGS64, FTT_ACC64, "%64, %65, %66, %67", "%68",
       "%69", "1, 1")

// Two floats as one register of the 16-bit A operand (low half = first).
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// 3xTF32: x = big + small, both rounded to tf32.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  return __uint_as_float(b);
}

// 2^x; 2^-inf = +0, which the masked scores rely on.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Splits a tile in place for 3xTF32 on wgmma: x becomes big = tf32(x) and
// small = x - big goes to the same offset of `small` (the split is
// elementwise, so the swizzle carries over).
template <int BYTES>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* small, int tid) {
  float4* x4 = reinterpret_cast<float4*>(tile);
  float4* s4 = reinterpret_cast<float4*>(small);
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += WG_THREADS) {
    const float4 x = x4[i];
    const float4 big = make_float4(tf32_round(x.x), tf32_round(x.y), tf32_round(x.z), tf32_round(x.w));
    x4[i] = big;
    s4[i] = make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
  }
}

// Writes V^T split in two ([D][BK = 32], 128-byte swizzled rows) from the
// V tile [BK][D], for P.V on wgmma, which takes tf32 B only K-major.  The 8
// keys of each k8 step are stored in the order (0, 2, 4, 6, 1, 3, 5, 7): the
// A fragment from registers holds keys 2qd and 2qd+1 of the S fragment at
// k = qd and k = qd + 4.  A thread moves a 4 x 4 block: 4 keys of one
// parity (4 consecutive positions of V^T, one 16-byte chunk) x 4 columns
// (one 16-byte chunk of V), so it reads and writes 16 bytes at a time, and
// the 8 threads of a quarter-warp write 8 distinct chunks of one row.
template <class P>
__device__ __forceinline__ void split_vt(const uint8_t* v, uint8_t* vtb, uint8_t* vts, int tid) {
  constexpr int NPC = P::BK / 4;   // position chunks of a V^T row
  constexpr int NC = P::DIM / 4;   // column chunks of a V row
#pragma unroll
  for (int blk = tid; blk < NPC * NC; blk += WG_THREADS) {
    const int pc = blk % NPC, c = blk / NPC;
    const int key0 = (pc >> 1) * 8 + (pc & 1);
    float x[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t off = (4 * c / P::BOXC) * P::BK * P::ROWB + (key0 + 2 * m) * P::ROWB +
                     (4 * c % P::BOXC) * 4;
      off ^= ((off >> 7) & (P::ROWB / 16 - 1)) << 4;
      const float4 r = *reinterpret_cast<const float4*>(v + off);
      x[m][0] = r.x;
      x[m][1] = r.y;
      x[m][2] = r.z;
      x[m][3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t to = (4 * c + i) * 128 + pc * 16;
      to ^= ((to >> 7) & 7) << 4;
      const float4 big = make_float4(tf32_round(x[0][i]), tf32_round(x[1][i]),
                                     tf32_round(x[2][i]), tf32_round(x[3][i]));
      *reinterpret_cast<float4*>(vtb + to) = big;
      *reinterpret_cast<float4*>(vts + to) =
          make_float4(x[0][i] - big.x, x[1][i] - big.y, x[2][i] - big.z, x[3][i] - big.w);
    }
  }
}

// Makes this warpgroup's shared-memory writes visible to wgmma (the async
// proxy) and waits for the warpgroup.
__device__ __forceinline__ void async_fence_sync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Accumulator fragments (wgmma m64nN and mma.sync m16n8 agree per warp):
// thread (warp w, lane = 4g + qd) holds acc[4j + 2i + c] for row 16w + g + 8i
// and column 8j + 2qd + c.
template <typename T, int D>
__global__ void __launch_bounds__(Plan<T, D>::THREADS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int causal, float scale_log2) {
  using P = Plan<T, D>;
  constexpr int BK = P::BK, BQ = P::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (sQ - raw);
  const uint32_t bar_q = sQ + P::BARS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wg = tid >> 7;                         // this thread's warpgroup
  const int row0 = wg * WG_ROWS + (warp & 3) * 16;  // its warp's first q row in the CTA
  const uint32_t sQwg = WG_ROWS * P::ROWB * wg;     // its q rows' offset in each box
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  // Causal tiles late in T sweep the most keys: they go first, so the
  // longest CTAs do not start in the last wave.
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  // Causal, top-left aligned: row t sees keys 0..t, so the tile's last row
  // (q0 + BQ - 1) bounds the sweep.
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;

  // Ring slot s holds K then V of one tile, each with its own mbarrier: in
  // bf16/f16, S of a tile starts once its K has landed, while V may still
  // be in flight.
  auto slot_k = [&](int s) { return sQ + P::Q_BYTES + s * 2 * P::KV_BYTES; };
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + P::STAGES + s); };
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int j) {
    mbar_expect_tx(bar, P::KV_BYTES);
#pragma unroll
    for (int c = 0; c < P::NBOX; ++c)
      tma_load(dst + c * BK * P::ROWB, map, bar, c * P::BOXC, h, j * BK, b);
  };
  auto load_k = [&](int j) { load(&kmap, slot_k(j % P::STAGES), bar_k(j % P::STAGES), j); };
  auto load_v = [&](int j) {
    load(&vmap, slot_k(j % P::STAGES) + P::KV_BYTES, bar_v(j % P::STAGES), j);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= 2 * P::STAGES; ++s) mbar_init(bar_q + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, P::Q_BYTES);
#pragma unroll
    for (int c = 0; c < P::NBOX; ++c)
      tma_load(sQ + c * BQ * P::ROWB, &qmap, bar_q, c * P::BOXC, h, q0, b);
    for (int j = 0; j < P::STAGES && j < ntiles; ++j) {
      load_k(j);
      load_v(j);
    }
  }
  __syncwarp();  // warp 0 reconverges before the warpgroup-wide wgmma

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum
  mbar_wait(bar_q, 0);
  if constexpr (P::SPLIT) {
    split_tile<P::Q_BYTES>(smem, smem + P::RING, tid);
    async_fence_sync();
  }

  // Online softmax of tile j on its S fragments, in base 2:
  // p = 2^(s * scale_log2 - m).  Leaves P in acc_s, updates m_run and l_run,
  // and returns in alpha the factor that rescales O.
  auto softmax = [&](float* acc_s, int j, float* alpha) {
    const int k0 = j * BK;
    const bool mask = (causal && k0 + BK - 1 > q0) || k0 + BK > Tk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + row0 + g + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = acc_s[4 * jj + 2 * i + c];
          if (mask) {
            const int kpos = k0 + 8 * jj + 2 * qd + c;
            if (kpos >= Tk || (causal && kpos > qpos)) x = -INFINITY;
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx * scale_log2);
      const float safe_m = isinf(m_new) ? 0.f : m_new;  // nothing visible yet
      alpha[i] = isinf(m_run[i]) ? 0.f : ex2(m_run[i] - safe_m);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = acc_s[4 * jj + 2 * i + c];
          x = ex2(fmaf(x, scale_log2, -safe_m));  // masked: 2^-inf = 0
          rs += x;
        }
      l_run[i] = l_run[i] * alpha[i] + rs;
      m_run[i] = m_new;
    }
  };
  auto rescale = [&](const float* alpha) {
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc_o[4 * jj + 2 * i] *= alpha[i];
        acc_o[4 * jj + 2 * i + 1] *= alpha[i];
      }
  };
  // Refills ring slots once every thread is done with them; thread 0 issues
  // the copies.
  auto refill = [&](int kj, int vj) {
    __syncthreads();
    if (tid == 0) {
      if (kj < ntiles) load_k(kj);
      if (vj < ntiles) load_v(vj);
    }
    __syncwarp();
  };

  if constexpr (P::ES == 2) {
    // S = Q.K^T of tile j; O += P.V with P (this thread's S fragments,
    // rounded to the input type) as the A operand from registers.
    float acc_s[BK / 2];
    uint32_t pa[BK / 16][4];
    auto qk = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Ss<T, BK>::mma(acc_s, kmajor_desc<P>(sQ + sQwg, BQ, kk),
                         kmajor_desc<P>(slot_k(s), BK, kk), kk > 0);
    };
    auto pv = [&](int s) {
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        Rs<T, D>::mma(acc_o, pa[t], mnmajor_desc<P>(slot_k(s) + P::KV_BYTES, t));
    };
    auto pack = [&]() {
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[t][r] = pack2(acc_s[8 * t + 2 * r], acc_s[8 * t + 2 * r + 1], static_cast<T*>(nullptr));
    };
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % P::STAGES;
      mbar_wait(bar_k(s), (j / P::STAGES) & 1);
      wg_fence();
      qk(s);
      wg_commit();
      wg_wait0();
      fence_regs<BK / 2>(acc_s);
      float alpha[2];
      softmax(acc_s, j, alpha);
      rescale(alpha);
      pack();
      mbar_wait(bar_v(s), (j / P::STAGES) & 1);
      wg_fence();
      pv(s);
      wg_commit();
      wg_wait0();
      fence_regs<D / 2>(acc_o);
      refill(j + P::STAGES, j + P::STAGES);
    }
  } else {
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % P::STAGES;
      const uint32_t sK = slot_k(s), sV = sK + P::KV_BYTES;
      mbar_wait(bar_k(s), (j / P::STAGES) & 1);
      mbar_wait(bar_v(s), (j / P::STAGES) & 1);

      // S = Q.K^T in 3xTF32: small.big + big.small + big.big, all K-major
      // from shared memory (q's parts were split once, this K tile's are
      // split now, and V^T is written split for P.V below).
      float acc_s[BK / 2];
      const uint32_t sQs = sQ + P::RING, sKs = sQ + P::KS;
      split_tile<P::KV_BYTES>(smem + (sK - sQ), smem + P::KS, tid);
      split_vt<P>(smem + (sV - sQ), smem + P::VTB, smem + P::VTS, tid);
      async_fence_sync();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / P::KSTEP; ++kk) {
        Ss<T, BK>::mma(acc_s, kmajor_desc<P>(sQs, BQ, kk), kmajor_desc<P>(sK, BK, kk), kk > 0);
        Ss<T, BK>::mma(acc_s, kmajor_desc<P>(sQ, BQ, kk), kmajor_desc<P>(sKs, BK, kk), 1);
        Ss<T, BK>::mma(acc_s, kmajor_desc<P>(sQ, BQ, kk), kmajor_desc<P>(sK, BK, kk), 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs<BK / 2>(acc_s);

      float alpha[2];
      softmax(acc_s, j, alpha);
      rescale(alpha);

      // O += P.V in 3xTF32 with P split in registers.  The A fragment of a
      // k8 step wants keys qd and qd+4; the S fragment holds keys 2qd and
      // 2qd+1, and V^T stores its keys in that order.
      uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        const float a[4] = {acc_s[4 * t], acc_s[4 * t + 2], acc_s[4 * t + 1], acc_s[4 * t + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float big = tf32_round(a[r]);
          pb[t][r] = __float_as_uint(big);
          ps[t][r] = __float_as_uint(tf32_round(a[r] - big));
        }
      }
      wg_fence();
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        Rs<T, D>::mma(acc_o, ps[t], vt_desc(sQ + P::VTB, t));
        Rs<T, D>::mma(acc_o, pb[t], vt_desc(sQ + P::VTS, t));
        Rs<T, D>::mma(acc_o, pb[t], vt_desc(sQ + P::VTB, t));
      }
      wg_commit();
      wg_wait0();
      fence_regs<D / 2>(acc_o);
      refill(j + P::STAGES, j + P::STAGES);
    }
  }

  // o = acc / l (l == 0 -> o = 0), lse = m + log(l) or -inf.  o is
  // contiguous [B, T, H, D].
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = q0 + row0 + g + 8 * i;
    if (t >= Tq) continue;
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    T* orow = o + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2(orow + 8 * jj + 2 * qd, acc_o[4 * jj + 2 * i] * inv, acc_o[4 * jj + 2 * i + 1] * inv);
    if (qd == 0 && lse)
      lse[static_cast<int64_t>(bh) * Tq + t] =
          (l == 0.f) ? -INFINITY : m_run[i] * 0.69314718055994531f + logf(l);
  }
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <> constexpr CUtensorMapDataType tma_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// 4-D map (D, H, T, B) over a [B, T, H, D] tensor with element strides
// s = (batch, time, head); box (BOXC, 1, rows, 1).  A dim of size 1 takes
// any stride, so it gets a valid one.
template <typename T, int D>
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int Tn,
                  const int64_t* s, int rows) {
  using P = Plan<T, D>;
  const cuuint64_t row = D * P::ES;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Tn, (cuuint64_t)B};
  cuuint64_t strides[3] = {H > 1 ? s[2] * P::ES : row, Tn > 1 ? s[1] * P::ES : row,
                           B > 1 ? s[0] * P::ES : row};
  cuuint32_t box[4] = {(cuuint32_t)P::BOXC, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = P::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : P::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, tma_type<T>(), 4, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns a cudaError_t, or -CUresult when a tensor map cannot be encoded.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Tq, int Tk, const int64_t* qs, const int64_t* ks, const int64_t* vs, int causal,
           cudaStream_t stream) {
  using P = Plan<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  // The shared-memory opt-in is set once per device for this instance.
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(configured.load(std::memory_order_relaxed) & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return err;
    configured.fetch_or(1u << dev);
  }
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult res = make_map<T, D>(enc, &qm, q, B, H, Tq, qs, P::BQ);
  // Tk == 0: a dim of size 0 cannot be mapped; the kernel runs zero tiles
  // and never reads the k/v maps.
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  if (res == CUDA_SUCCESS && Tk > 0) res = make_map<T, D>(enc, &km, k, B, H, Tk, ks, P::BK);
  if (res == CUDA_SUCCESS && Tk > 0) res = make_map<T, D>(enc, &vm, v, B, H, Tk, vs, P::BK);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const dim3 grid((Tq + P::BQ - 1) / P::BQ, B * H);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(qm, km, vm, static_cast<T*>(o), lse, H, Tq, Tk, causal,
                                           1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int Tq, int Tk, const int64_t* qs, const int64_t* ks, const int64_t* vs,
               int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
void plan_of(int* out) {
  using P = Plan<T, D>;
  const int vals[7] = {P::BQ, P::BK, P::STAGES, P::THREADS, P::SMEM, P::BOXC, P::ROWB};
  memcpy(out, vals, sizeof(vals));
}

template <typename T>
int plan_d(int D, int* out) {
  switch (D) {
    case 16: plan_of<T, 16>(out); return 0;
    case 32: plan_of<T, 32>(out); return 0;
    case 64: plan_of<T, 64>(out); return 0;
    case 128: plan_of<T, 128>(out); return 0;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// p = {dtype, B, H, Tq, Tk, D, q strides, k strides, v strides, causal}:
// dtype 0 = float32, 1 = bfloat16, 2 = float16; strides in elements for the
// (batch, time, head) axes of [B, T, H, D].  The D axis must be contiguous,
// pointers and the strides of axes longer than 1 16-byte aligned.  lse may
// be null (not written).  Returns the cudaError_t of the launch (0 =
// success), or -CUresult if a TMA tensor map was refused.
extern "C" int ftt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, const int64_t* p, void* stream) {
  const int dtype = static_cast<int>(p[0]), B = static_cast<int>(p[1]);
  const int H = static_cast<int>(p[2]), Tq = static_cast<int>(p[3]);
  const int Tk = static_cast<int>(p[4]), D = static_cast<int>(p[5]);
  const int64_t* qs = p + 6;
  const int64_t* ks = p + 9;
  const int64_t* vs = p + 12;
  const int causal = static_cast<int>(p[15]);
  if (Tq == 0 || B * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    case 2: return dispatch_d<__half>(D, q, k, v, o, l, B, H, Tq, Tk, qs, ks, vs, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// The launch plan of one (dtype, D) instance, for the wrapper to check its
// own: out[7] = {BQ, BK, STAGES, threads, dynamic shared-memory bytes, TMA
// box columns, swizzle bytes}.  Returns 0, or cudaErrorInvalidValue.
extern "C" int ftt_flash_attention_plan(int dtype, int D, int* out) {
  switch (dtype) {
    case 0: return plan_d<float>(D, out);
    case 1: return plan_d<__nv_bfloat16>(D, out);
    case 2: return plan_d<__half>(D, out);
    default: return cudaErrorInvalidValue;
  }
}
