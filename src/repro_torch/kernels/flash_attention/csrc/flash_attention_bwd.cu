// flash_attention_bwd: the gradient of flash_attention (causal or
// bidirectional GQA attention) as hand-written CUDA kernels for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and XLA
// differentiates through its Pallas flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:78).  This is the
// gradient XLA takes through that forward, in the form FlashAttention-2
// computes it.  q and do are (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), o
// (B, Sq, Hq, D) is the forward's output; all float32 or all bfloat16,
// contiguous; D in 16, 32, 64, 128; Sq and Sk multiples of 64.  Query head
// h reads KV head h / (Hq / Hkv).
//
// Two kernels, launched back to back by flash_attention_bwd_launch:
//   1. flash_bwd_prep, one block per (q tile of 64 rows, q head, batch):
//      the row log-sum-exp of scale * q.k^T under the forward's mask
//      (causal keeps k_pos <= q_pos; masked scores are -1e30), by the
//      forward's online max and sum, lse = m + log(l); and
//      delta = rowsum(do * o).  Both float32, (B, Hq, Sq).  The forward
//      does not write lse, so the backward recomputes it (one q.k^T pass).
//   2. flash_bwd, one block per (k tile of 64 keys, KV head, batch): the
//      K and V tiles stay in shared memory while the block walks the q
//      heads of the group and, for each, the q tiles that see the k tile
//      (causal: q0 >= k0).  Per q tile it loads q, do, lse and delta and
//      computes, all in float32:
//        S  = q.k^T,  P = exp(scale S - lse) (0 where masked),
//        dP = do.v^T, dS = P * (dP - delta);
//        dV += P^T.do and dK += dS^T.q in registers (the block owns its
//        keys: no other block writes them, so dk and dv are deterministic
//        and written once, dk times scale, in the input dtype);
//        dQ += scale dS.k, added with atomicAdd into a float32 (B, Sq, Hq,
//        D) buffer the wrapper zeroes and casts.  The order of those adds
//        varies from run to run, so dq is not bit-reproducible; a
//        deterministic dQ would need a second pass per q tile over the k
//        tiles, recomputing S and dP (about 40% more work); the atomics
//        were chosen for one pass and a simple kernel.
//
// Arithmetic: every product is a float32 FMA on the CUDA cores; bfloat16
// inputs are widened as they are loaded into shared memory, so a bf16
// gradient differs from the float32 formulas (attention_bwd_ref) only by
// the final rounding of dq, dk and dv.  No tensor cores, no TF32.
//
// What bounds it: the gradient needs 2.5 times the forward's operations
// (S, dP, dV, dK, dQ: five products of the forward's two sizes), far above
// the card's operations-per-byte balance, so it is bound by operations:
// the card's bound is that work over the bf16 tensor-core rate (989
// TFLOP/s).  This SIMT kernel cannot beat the 67 TFLOP/s float32 rate, and
// reads its shared-memory operands at about two FMAs a load; a wgmma/TMA
// redesign (as the forward's) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TX = 16;  // threads along a row of a tile
constexpr int TY = 16;  // thread rows
constexpr int THREADS = TX * TY;
constexpr int BQ = 64;  // q rows of a tile
constexpr int BK = 64;  // keys of a tile
constexpr int RQ = BQ / TY;  // q rows per thread
constexpr int RK = BK / TY;  // key rows per thread (dK, dV)
constexpr int CK = BK / TX;  // key columns per thread (S, dP)

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

// max and sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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

// ---------------------------------------------------------------------
// 1. lse and delta
// ---------------------------------------------------------------------

template <int D>
constexpr size_t prep_smem() {
  return sizeof(float) * (size_t)(BQ + BK) * (D + 1);  // Qs, Ks
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_prep(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ delta, int Sq,
                   int Sk, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int CD = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t q_row = (int64_t)Hq * D;
  const int64_t kv_row = (int64_t)Hkv * D;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * kv_row + (int64_t)hk * D;

  // delta = rowsum(do * o) for this thread's rows, straight from memory
  float* stat = lse + ((int64_t)b * Hq + h) * Sq + q0;
  float* dstat = delta + ((int64_t)b * Hq + h) * Sq + q0;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty + TY * i;
    const int64_t off = q_off + row * q_row;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      part += to_f32(dout[off + tx + TX * c]) * to_f32(o[off + tx + TX * c]);
    part = row_sum(part);
    if (tx == 0) dstat[row] = part;
  }

  load_tile<T, D>(Qs, LD, q + q_off, q_row, BQ);
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Qs is written; the last tile's Ks is read
    load_tile<T, D>(Ks, LD, kb + (int64_t)k0 * kv_row, kv_row, BK);
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx + TX * j > q_pos) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) stat[ty + TY * i] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------
// 2. dq, dk, dv
// ---------------------------------------------------------------------

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
  float *dq, *lse, *delta;
  void *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  auto prep = flash_bwd_prep<T, D>;
  auto main_kernel = flash_bwd<T, D>;
  constexpr size_t prep_bytes = prep_smem<D>();
  constexpr size_t main_bytes = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)prep_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(main_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)main_bytes);
  if (err != cudaSuccess) return (int)err;
  prep<<<dim3(a.Sq / BQ, a.Hq, a.B), THREADS, prep_bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.o, (const T*)a.dout, a.lse,
      a.delta, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  main_kernel<<<dim3(a.Sk / BK, a.Hkv, a.B), THREADS, main_bytes,
                a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                            (const T*)a.dout, a.lse, a.delta, a.dq, (T*)a.dk,
                            (T*)a.dv, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
                            a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int D, const Args& a) {
  switch (D) {
    case 16:
      return launch<T, 16>(a);
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
  }
  return -1;
}

}  // namespace

// dq is a zeroed float32 (B, Sq, Hq, D) buffer; lse and delta are float32
// (B, Hq, Sq) scratch; dk and dv have k's shape and dtype.  Returns 0, -1
// for a head dim or length the kernels do not take, or a CUDA error code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* dq, void* dk, void* dv, float* lse,
    float* delta, int B, int Sq, int Sk, int Hq, int Hkv, int D, int is_bf16,
    int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || Hq == 0) return 0;
  if (Sq % BQ || Sk % BK || Hkv == 0 || Hq % Hkv) return -1;
  const Args a{q,  k,  v,  o,   dout,   dq,    lse,
               delta, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale,
               (cudaStream_t)stream};
  return is_bf16 ? by_head_dim<__nv_bfloat16>(D, a) : by_head_dim<float>(D, a);
}
