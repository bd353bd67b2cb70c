// flash_attention_bwd: the gradient of flash_attention (causal or
// bidirectional GQA attention) as hand-written CUDA kernels for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and XLA
// differentiates through its Pallas flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:78).  This is the
// gradient XLA takes through that forward, in the form FlashAttention-2/3
// compute it.  q, o and do are (B, Sq, Hq, D), k and v (B, Sk, Hkv, D),
// all float32 or all bfloat16, contiguous; o is the forward's output and
// lse (float32, (B, Hq, Sq)) the forward's natural-log row log-sum-exp of
// the scaled, masked scores, written by the forward kernel beside o.
// Query head h reads KV head h / (Hq / Hkv).
//
// Every call launches two kernels back to back:
//   0. flash_bwd_delta: delta = rowsum(do * o) in float32, (B, Hq, Sq),
//      16 bytes of each a thread (memory-bound: o and do read once);
//   then, by (dtype, D) alone, one of
//   1. bfloat16 at D = 64 or 128 (every full-width model of the repo):
//      flash_bwd_wgmma_kernel, on the tensor cores; Sk a multiple of 128,
//      Sq of 64;
//   2. float32 (D = 16, 32, 64, 128) and bfloat16 at D = 16 or 32 (only
//      the .reduced() configs): the float32 SIMT flash_bwd; Sq and Sk
//      multiples of 64.
// There is no fallback from one to the other.
//
// Both compute, per (q row, key) kept by the mask (causal keeps
// k_pos <= q_pos, top-left aligned):
//   P = exp(scale q.k - lse),  dP = do.v,  dS = P (dP - delta),
//   dV = sum_q P do,  dK = scale sum_q dS q,  dQ = scale sum_k dS k,
// the query heads of a group summed into their KV head.  A block owns a
// tile of keys of one KV head and walks the group's q heads and the q
// tiles that see its keys: dK and dV stay in registers and are written
// once (no other block writes them: deterministic), dQ is added across
// blocks into a zeroed float32 (B, Sq, Hq, D) buffer that the wrapper
// casts.  The order of those adds varies from run to run, so dq is not
// bit-reproducible and is held by tolerance.
//
// What bounds it: the gradient needs 2.5 times the forward's operations
// (S, dP, dV, dK, dQ: five products of the forward's two sizes), far above
// the card's operations-per-byte balance (~295 in bf16), so it is bound by
// operations: the bound is that work over the bf16 tensor-core rate (989
// TFLOP/s dense).
//
// 1. flash_bwd_wgmma_kernel, one block of two consumer warpgroups (256
//    threads) per (128-key tile, KV head, batch), launched heaviest first
//    under the causal mask.  Each warpgroup owns 64 of the keys: the M of
//    one wgmma.
//    * K and V (bf16, 128-byte swizzled, D = 128 as two 64-column boxes)
//      are loaded once by TMA.  The q tiles (64 rows) that see the keys
//      (causal: q0 + 63 >= k0) come with their dO tiles in a two-stage
//      TMA ring, lse and delta (64 floats each, bulk copies) beside them,
//      all completing on one mbarrier per stage; thread 0 refills a stage
//      as soon as both warpgroups are past their last read of it.
//    * Per q tile, each warpgroup, all bf16 x bf16 into float32:
//        S^T = K.Q^T and dP^T = V.dO^T: wgmma m64n64k16, A and B both
//          K-major from shared memory (the keys are the rows);
//        P^T = exp2(scale log2(e) S^T - log2(e) lse), masked only on
//          tiles that cross the diagonal; dS^T = P^T (dP^T - delta);
//        dV += P^T.dO and dK += dS^T.Q: wgmma m64nDk16, A = P^T or dS^T
//          from registers (the accumulator fragment of a k16 slice,
//          rounded to bf16 pairs, is the register A operand, as the
//          forward's P), B = dO or Q, (q rows x D) row-major: MN-major,
//          transpose bit set;
//        dS^T also goes to shared memory in bf16 (double-buffered, the
//          same swizzle), and after one __syncthreads
//        dQ += dS.K: wgmma m64n64k16 with A = dS read transposed from the
//          dS^T buffer and B = K (keys x D), MN-major: both transpose bits
//          set.  At D = 128 the warpgroups split D (each 64 columns over
//          all 128 keys); at D = 64 they split the keys (each its own 64,
//          all 64 columns), so both add into the same dq rows.  dq is
//          added to global memory with vector float2 atomics (red).
//    * dK (times scale) and dV are rounded to bf16 and stored once.
//    * Precision: P and dS are rounded to bf16 for the three products
//      that take them (relative error <= 2^-9 an element), as the
//      forward's P; everything else accumulates in float32.  The gradient
//      error this adds is far inside the bf16 tolerance (2e-2 rel L2).
//    * Registers: dV and dK take D / 2 floats a thread each, S^T and dP^T
//      32 each, the dQ slice 32 once S^T and dP^T are packed; at D = 128
//      that peaks near 200 of the 255 a thread may hold (ptxas -v reports
//      the spills: none expected).
//    What bounds this design below the bound: one thread issues the loads
//    and the warpgroups wait on them (no producer warp, no setmaxnreg), a
//    warpgroup's products run one after the other (no overlap of the
//    softmax with the next S^T), and dq goes through float32 atomics in
//    L2; those are later work.
// 2. flash_bwd (SIMT), one block of 256 threads per (64-key tile, KV head,
//    batch): K and V widened to float32 in shared memory, per q tile S,
//    dP, dV, dK and dQ as float32 FMAs on the CUDA cores (no tensor
//    cores, no TF32), dQ by float32 atomicAdd; it cannot beat the 67
//    TFLOP/s float32 rate.
#include <cuda.h>  // CUtensorMap and the encoder's declaration; not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------
// 0. delta = rowsum(do * o)
// ---------------------------------------------------------------------

constexpr int DELTA_THREADS = 256;

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       float) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       __nv_bfloat16) {
  return dot2(a.x, b.x) + dot2(a.y, b.y) + dot2(a.z, b.z) + dot2(a.w, b.w);
}

// one row of D elements per D * sizeof(T) / 16 lanes (2 to 32, dividing
// the warp), 16 bytes a lane; row r of the (B, Sq, Hq) rows goes to
// delta[b][h][q]
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int64_t rows, int Sq, int Hq) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int TPR = D / V;         // lanes a row
  const int64_t t = (int64_t)blockIdx.x * DELTA_THREADS + threadIdx.x;
  const int64_t row = t / TPR;
  const int part = (int)(t % TPR);
  float acc = 0.0f;
  if (row < rows) {
    const int64_t off = row * D + part * V;
    acc = dot16(*reinterpret_cast<const uint4*>(o + off),
                *reinterpret_cast<const uint4*>(dout + off), T{});
  }
#pragma unroll
  for (int s = TPR / 2; s > 0; s /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (row < rows && part == 0) {
    const int h = (int)(row % Hq);
    const int64_t bq = row / Hq;
    const int q = (int)(bq % Sq);
    const int64_t b = bq / Sq;
    delta[(b * Hq + h) * Sq + q] = acc;
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int Sq, int Hq, cudaStream_t stream) {
  constexpr int TPR = D * (int)sizeof(T) / 16;
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int64_t threads = rows * TPR;
  const unsigned blocks =
      (unsigned)((threads + DELTA_THREADS - 1) / DELTA_THREADS);
  flash_bwd_delta<T, D><<<blocks, DELTA_THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows, Sq, Hq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// 2. the SIMT kernel (float32; bf16 at D = 16, 32)
// ---------------------------------------------------------------------

constexpr int TX = 16;  // threads along a row of a tile
constexpr int TY = 16;  // thread rows
constexpr int THREADS = TX * TY;
constexpr int BQ = 64;  // q rows of a tile
constexpr int BK = 64;  // keys of a tile
constexpr int RQ = BQ / TY;  // q rows per thread
constexpr int RK = BK / TY;  // key rows per thread (dK, dV)
constexpr int CK = BK / TX;  // key columns per thread (S, dP)

// rows x D of a (.., S, H, D) tensor from row r0, head h -> float32 shared
// memory with row stride ld
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = to_f32(src[r * row_stride + d]);
  }
}

template <int D>
constexpr size_t bwd_smem() {
  // Ks, Vs [BK][D+1]; Qs, dOs [BQ][D+1]; Ps, dSs [BQ][BK+1]; lse, delta
  return sizeof(float) * ((size_t)2 * BK * (D + 1) + (size_t)2 * BQ * (D + 1) +
                          (size_t)2 * BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
              int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CD = D / TX;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* Ls = dSs + BQ * LP;
  float* Ds = Ls + BQ;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t q_row = (int64_t)Hq * D;
  const int64_t kv_row = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * Sk + k0) * kv_row + (int64_t)hk * D;

  load_tile<T, D>(Ks, LD, k + kv_off, kv_row, BK);
  load_tile<T, D>(Vs, LD, v + kv_off, kv_row, BK);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // causal: q rows below k0 see none of these keys (BQ == BK)
  const int q_start = causal ? k0 : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* lse_h = lse + ((int64_t)b * Hq + h) * Sq;
    const float* delta_h = delta + ((int64_t)b * Hq + h) * Sq;
    for (int q0 = q_start; q0 < Sq; q0 += BQ) {
      const int64_t q_off = ((int64_t)b * Sq + q0) * q_row + (int64_t)h * D;
      __syncthreads();  // the last tile's Qs, dOs, Ps, dSs are read
      load_tile<T, D>(Qs, LD, q + q_off, q_row, BQ);
      load_tile<T, D>(dOs, LD, dout + q_off, q_row, BQ);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        Ls[r] = lse_h[q0 + r];
        Ds[r] = delta_h[q0 + r];
      }
      __syncthreads();

      // S = q.k^T and dP = do.v^T for rows ty + TY i, keys tx + TX j
      float s[RQ][CK], dp[RQ][CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          qv[i] = Qs[(ty + TY * i) * LD + d];
          ov[i] = dOs[(ty + TY * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          kv[j] = Ks[(tx + TX * j) * LD + d];
          vv[j] = Vs[(tx + TX * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            s[i][j] += qv[i] * kv[j];
            dp[i][j] += ov[i] * vv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty + TY * i;
        const int q_pos = q0 + row;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int col = tx + TX * j;
          const float p = (causal && k0 + col > q_pos)
                              ? 0.0f
                              : expf(s[i][j] * scale - Ls[row]);
          Ps[row * LP + col] = p;
          dSs[row * LP + col] = p * (dp[i][j] - Ds[row]);
        }
      }
      __syncthreads();

      // dV += P^T.do and dK += dS^T.q for keys ty + TY i, columns tx + TX c
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK], ov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[r * LP + ty + TY * i];
          sv[i] = dSs[r * LP + ty + TY * i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = dOs[r * LD + tx + TX * c];
          qv[c] = Qs[r * LD + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[i][c] += pv[i] * ov[c];
            dk_acc[i][c] += sv[i] * qv[c];
          }
      }

      // dQ += scale dS.k for rows ty + TY i, columns tx + TX c
      float dq_acc[RQ][CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) dq_acc[i][c] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < BK; ++kk) {
        float sv[RQ], kv[CD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty + TY * i) * LP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * LD + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) dq_acc[i][c] += sv[i] * kv[c];
      }
      float* dq_tile = dq + q_off;
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c)
          atomicAdd(dq_tile + (ty + TY * i) * q_row + tx + TX * c,
                    scale * dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int64_t off = kv_off + (ty + TY * i) * kv_row;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[off + tx + TX * c] = from_f32<T>(dk_acc[i][c] * scale);
      dv[off + tx + TX * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float *dq, *delta;
  void *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_simt(const Args& a) {
  int err = launch_delta<T, D>(a.o, a.dout, a.delta, a.B, a.Sq, a.Hq,
                               a.stream);
  if (err != 0) return err;
  auto kern = flash_bwd<T, D>;
  constexpr size_t bytes = bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.Sk / BK, a.Hkv, a.B), THREADS, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, a.dq, (T*)a.dk, (T*)a.dv, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// 1. the Hopper kernel (bf16 at D = 64, 128): TMA, mbarriers, wgmma.
// The helpers are this file's own copies of the forward's
// (csrc/flash_attention.cu), so each library builds from one source.
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also tells the barrier how many bytes TMA will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global (map at coordinates c0..c3, innermost first) -> shared
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (16-byte aligned, a multiple
// of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of wgmma for a 128-byte-swizzled tile
// as TMA writes it: rows of 128 bytes (64 bf16), 8-row swizzle atoms of
// 1024 bytes (the stride byte offset).  `lbo` is the leading byte offset:
// unused for a K-major operand, the stride between 64-column atoms along
// M or N for an MN-major one.  Layout type 1 = SWIZZLE_128B (bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulator registers across an
// asynchronous wgmma: after wg_wait_all, they are redefined here.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma.mma_async m64n64k16, float32 += bf16 x bf16, A and B from shared
// memory; TA / TB are the transpose bits (0: K-major, 1: MN-major);
// scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16: A from registers (four
// bf16 pairs), B MN-major from shared memory (transpose bit set), d
// accumulated
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int W_BQ = 64;        // q rows of a tile
constexpr int W_BK = 128;       // keys a block (two warpgroups of 64)
constexpr int W_THREADS = 256;
constexpr int BOX_ROW = 128;    // bytes of one 64-column row of a TMA box
constexpr int ROWS8 = 16 * BOX_ROW;  // a k16 step down an MN-major tile

template <int D>
struct BwdTile {
  static constexpr int NDB = D / 64;          // 64-column boxes
  static constexpr int KV = W_BK * D * 2;     // the K or the V tile
  static constexpr int QT = W_BQ * D * 2;     // a Q or a dO tile
  static constexpr int DS = W_BK * W_BQ * 2;  // dS^T, keys x q rows, bf16
  // every tile starts on a 1024-byte boundary (the swizzle atom)
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV;
  static constexpr int Q_OFF = 2 * KV;              // stage s at + s QT
  static constexpr int DO_OFF = Q_OFF + 2 * QT;     // stage s at + s QT
  static constexpr int DS_OFF = DO_OFF + 2 * QT;    // buffer s at + s DS
  static constexpr int STAT_OFF = DS_OFF + 2 * DS;  // lse[2][64], delta[2][64]
  static constexpr int STAT = W_BQ * 4;
  static constexpr int SMEM = STAT_OFF + 4 * STAT + 1024;  // + alignment
  // dQ: D = 128 splits the columns (64 a warpgroup, over all 128 keys),
  // D = 64 the keys (64 a warpgroup, all 64 columns); N = 64 either way
  static constexpr int DQ_KEYS = D == 128 ? W_BK : 64;
};

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                           int Hq, int Hkv, int causal, float scale,
                           float scale_log2) {
  using C = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // K/V, then one per q stage
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* stats = reinterpret_cast<float*>(smem + C::STAT_OFF);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * W_BK;  // heaviest causal tiles first
  const int group = Hq / Hkv;
  // causal: a q tile sees these keys iff q0 + 63 >= k0, i.e. q0 >= k0
  const int q_start = causal ? k0 : 0;
  const int nq = Sq > q_start ? (Sq - q_start) / W_BQ : 0;
  const int total = group * nq;  // (q head, q tile) pairs, head-major

  auto load_q = [&](int it, int s) {
    const int h = hk * group + it / nq, q0 = q_start + (it % nq) * W_BQ;
    const int64_t row = ((int64_t)b * Hq + h) * Sq + q0;
    mbar_expect_tx(&bars[1 + s], 2 * C::QT + 2 * C::STAT);
#pragma unroll
    for (int db = 0; db < C::NDB; ++db) {
      tma_load(smem + C::Q_OFF + s * C::QT + db * W_BQ * BOX_ROW, &tq,
               &bars[1 + s], 64 * db, h, q0, b);
      tma_load(smem + C::DO_OFF + s * C::QT + db * W_BQ * BOX_ROW, &tdo,
               &bars[1 + s], 64 * db, h, q0, b);
    }
    bulk_load(stats + s * W_BQ, lse + row, C::STAT, &bars[1 + s]);
    bulk_load(stats + (2 + s) * W_BQ, delta + row, C::STAT, &bars[1 + s]);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && total > 0) {
    mbar_expect_tx(&bars[0], 2 * C::KV);
#pragma unroll
    for (int db = 0; db < C::NDB; ++db) {
      tma_load(smem + C::K_OFF + db * W_BK * BOX_ROW, &tk, &bars[0], 64 * db,
               hk, k0, b);
      tma_load(smem + C::V_OFF + db * W_BK * BOX_ROW, &tv, &bars[0], 64 * db,
               hk, k0, b);
    }
    load_q(0, 0);
    if (total > 1) load_q(1, 1);
  }
  __syncwarp();  // wgmma's .sync.aligned wants converged warps

  // this thread's two rows of an accumulator fragment (within the wg) and
  // its first column; element i: column 8 (i / 4) + col0 + i % 2, row r0
  // or r1 as (i / 2) % 2 is 0 or 1
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int col0 = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
  const uint32_t k_addr = smem_u32(smem + C::K_OFF);
  const uint32_t v_addr = smem_u32(smem + C::V_OFF);
  // dQ: the keys (within the block) and the 64 columns of this warpgroup
  const int dq_key = C::DQ_KEYS == W_BK ? 0 : 64 * wg;
  const int dq_box = C::DQ_KEYS == W_BK ? wg : 0;

  float dvacc[D / 2], dkacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dvacc[i] = dkacc[i] = 0.0f;

  if (total > 0) mbar_wait(&bars[0], 0);
  for (int it = 0; it < total; ++it) {
    const int s = it & 1;
    const int h = hk * group + it / nq, q0 = q_start + (it % nq) * W_BQ;
    mbar_wait(&bars[1 + s], (it >> 1) & 1);
    const uint32_t q_addr = smem_u32(smem + C::Q_OFF + s * C::QT);
    const uint32_t do_addr = smem_u32(smem + C::DO_OFF + s * C::QT);
    const float* lse_s = stats + s * W_BQ;
    const float* delta_s = stats + (2 + s) * W_BQ;

    // S^T = K Q^T and dP^T = V dO^T over D / 16 steps of k16: box
    // db = kk / 4 holds columns 64 db .. 64 db + 63, step kk % 4 is 32
    // bytes into its rows; this warpgroup's keys are rows 64 wg.. of K, V
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off =
          (kk / 4) * W_BK * BOX_ROW + 64 * wg * BOX_ROW + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * W_BQ * BOX_ROW + (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(st, sw128_desc(k_addr + a_off, 16),
                         sw128_desc(q_addr + b_off, 16), kk > 0);
      wgmma_ss_n64<0, 0>(dpt, sw128_desc(v_addr + a_off, 16),
                         sw128_desc(do_addr + b_off, 16), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    // P^T and dS^T; the mask only on tiles that cross the diagonal
    const bool diag = causal && kw0 + 63 > q0;
    const int key0 = kw0 + r0, key1 = kw0 + r1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int qpos = q0 + 8 * j + col0 + e % 2;
        float p = exp2f(fmaf(st[i], scale_log2,
                             -(e % 2 ? ls.y : ls.x) * LOG2E));
        if (diag && (e / 2 ? key1 : key0) > qpos) p = 0.0f;
        dpt[i] = p * (dpt[i] - (e % 2 ? dl.y : dl.x));
        st[i] = p;
      }
    }
    // the fragment's elements 8 kk .. 8 kk + 7 are the register A operand
    // of k16 step kk (q rows 16 kk .. 16 kk + 15)
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }

    // dS^T into buffer s (before the products below take dsa: registers
    // of an A operand in flight are not to be read): rows are keys
    // (64 wg + r), 128 bytes of 64 q values each, 16-byte chunks swizzled
    // as TMA's 128B; dsa[kk][r] holds row r % 2 ? r1 : r0, chunk
    // 2 kk + r / 2
    uint8_t* ds_buf = smem + C::DS_OFF + s * C::DS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 64 * wg + (r % 2 ? r1 : r0);
        const int chunk = 2 * kk + r / 2;
        *reinterpret_cast<uint32_t*>(ds_buf + row * BOX_ROW +
                                     ((chunk ^ (row % 8)) << 4) +
                                     4 * (lane % 4)) = dsa[kk][r];
      }
    // dV += P^T dO and dK += dS^T Q: B = dO or Q, (q rows x D) row-major,
    // MN-major; a k16 step is 16 rows down, the 64-column boxes
    // W_BQ * 128 bytes apart
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dvacc, pa[kk],
                  sw128_desc(do_addr + kk * ROWS8, W_BQ * BOX_ROW));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dkacc, dsa[kk],
                  sw128_desc(q_addr + kk * ROWS8, W_BQ * BOX_ROW));
    wg_commit();
    wg_wait_all();
    reg_fence(dvacc);
    reg_fence(dkacc);
    // the generic stores of dS^T, seen by wgmma's async proxy; then both
    // warpgroups are past their reads of stage s and have written dS^T
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && it + 2 < total) load_q(it + 2, s);
    __syncwarp();

    // dQ = dS K over this warpgroup's keys and columns: A = dS (q rows x
    // keys) read from dS^T (keys x q rows: MN-major), B = K (keys x D:
    // MN-major); a k16 step is 16 key rows down both
    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.0f;
    const uint32_t ds_addr = smem_u32(ds_buf) + dq_key * BOX_ROW;
    const uint32_t kb_addr =
        k_addr + dq_box * W_BK * BOX_ROW + dq_key * BOX_ROW;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::DQ_KEYS / 16; ++kk)
      wgmma_ss_n64<1, 1>(dqa, sw128_desc(ds_addr + kk * ROWS8, W_BK * BOX_ROW),
                         sw128_desc(kb_addr + kk * ROWS8, W_BK * BOX_ROW),
                         kk > 0);
    wg_commit();
    wg_wait_all();
    reg_fence(dqa);
    float* dq0 = dq + (((int64_t)b * Sq + q0 + r0) * Hq + h) * D +
                 64 * dq_box + col0;
    float* dq1 = dq0 + (int64_t)8 * Hq * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(reinterpret_cast<float2*>(dq0 + 8 * j),
                make_float2(scale * dqa[4 * j], scale * dqa[4 * j + 1]));
      atomicAdd(reinterpret_cast<float2*>(dq1 + 8 * j),
                make_float2(scale * dqa[4 * j + 2], scale * dqa[4 * j + 3]));
    }
  }

  // dK (times scale) and dV, rounded to bf16, stored once
  const int64_t kv_row = (int64_t)Hkv * D;
  const int64_t off0 = ((int64_t)b * Sk + kw0 + r0) * kv_row +
                       (int64_t)hk * D + col0;
  const int64_t off1 = off0 + 8 * kv_row;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dk + off0 + 8 * j) =
        pack_bf16(scale * dkacc[4 * j], scale * dkacc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dk + off1 + 8 * j) =
        pack_bf16(scale * dkacc[4 * j + 2], scale * dkacc[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(dv + off0 + 8 * j) =
        pack_bf16(dvacc[4 * j], dvacc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dv + off1 + 8 * j) =
        pack_bf16(dvacc[4 * j + 2], dvacc[4 * j + 3]);
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// fetched from the libcuda.so.1 the process has loaded already, so the
// build links nothing but the runtime.
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// a (B, S, H, D) contiguous bf16 tensor as a 4-D map (D, H, S, B), boxes
// of 64 columns x `rows` rows of one head, 128-byte swizzle
CUresult make_map(EncodeFn enc, CUtensorMap* map, const void* ptr, int B,
                  int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NOT_COMPILED = -1;  // head dim / length / dtype not taken
constexpr int ERR_NO_ENCODER = -2;    // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 2000;  // + the CUresult of the encoder

template <int D>
int launch_wgmma(const Args& a) {
  using C = BwdTile<D>;
  int err = launch_delta<__nv_bfloat16, D>(a.o, a.dout, a.delta, a.B, a.Sq,
                                           a.Hq, a.stream);
  if (err != 0) return err;
  const EncodeFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv, tdo;
  CUresult r = make_map(enc, &tq, a.q, a.B, a.Sq, a.Hq, D, W_BQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tdo, a.dout, a.B, a.Sq, a.Hq, D,
                                      W_BQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, a.k, a.B, a.Sk, a.Hkv, D,
                                      W_BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, a.v, a.B, a.Sk, a.Hkv, D,
                                      W_BK);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + (int)r;
  auto kern = flash_bwd_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.Hkv, a.B, a.Sk / W_BK), W_THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.dq, (__nv_bfloat16*)a.dk,
      (__nv_bfloat16*)a.dv, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.scale,
      a.scale * LOG2E);  // exp(x) = exp2(x log2(e))
  return (int)cudaGetLastError();
}

template <typename T>
int simt_by_head_dim(int D, const Args& a) {
  switch (D) {
    case 16: return launch_simt<T, 16>(a);
    case 32: return launch_simt<T, 32>(a);
  }
  if constexpr (sizeof(T) == 4) {  // float32 only: bf16 takes the wgmma
    switch (D) {
      case 64: return launch_simt<T, 64>(a);
      case 128: return launch_simt<T, 128>(a);
    }
  }
  return ERR_NOT_COMPILED;
}

}  // namespace

// dq is a zeroed float32 (B, Sq, Hq, D) buffer; lse is the forward's
// float32 (B, Hq, Sq) row log-sum-exp and delta float32 (B, Hq, Sq)
// scratch; dk and dv have k's shape and dtype.  bf16 at D = 64 or 128
// takes the wgmma kernel (Sq a multiple of 64, Sk of 128), everything else
// the SIMT kernel (both multiples of 64).  Returns 0, -1 for a head dim
// or length the kernel for (dtype, D) does not take, -2 if libcuda.so.1
// has no cuTensorMapEncodeTiled, 2000 + its CUresult if a tensor map was
// refused, or a CUDA error code.  The caller has checked shapes,
// contiguity and 16-byte alignment.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* dq, void* dk, void* dv, const float* lse,
    float* delta, int B, int Sq, int Sk, int Hq, int Hkv, int D, int is_bf16,
    int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || Hq == 0) return 0;
  if (Hkv == 0 || Hq % Hkv) return ERR_NOT_COMPILED;
  const Args a{q,   k,    v,     o,  dout, lse, dq,     delta,
               dk,  dv,   B,     Sq, Sk,   Hq,  Hkv,    causal,
               scale, (cudaStream_t)stream};
  if (is_bf16 && (D == 64 || D == 128)) {
    if (Sq % W_BQ || Sk % W_BK) return ERR_NOT_COMPILED;
    return D == 64 ? launch_wgmma<64>(a) : launch_wgmma<128>(a);
  }
  if (Sq % BQ || Sk % BK) return ERR_NOT_COMPILED;
  return is_bf16 ? simt_by_head_dim<__nv_bfloat16>(D, a)
                 : simt_by_head_dim<float>(D, a);
}
