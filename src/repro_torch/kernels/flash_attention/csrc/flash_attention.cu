// flash_attention: causal or bidirectional GQA attention with an online
// softmax, as a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:78
// (flash_attention, the Pallas TPU kernel whose body is _flash_kernel).
// q is (B, Sq, Hq, D), k and v are (B, Sk, Hkv, D), all float32 or all
// bfloat16, contiguous; the output has q's shape and dtype.  Query head h
// reads KV head h / (Hq / Hkv); no repeated K/V is materialised.
//
// Semantics held from the Pallas kernel:
//   * q, k and v are widened to float32 and both products (q.k and p.v)
//     are float32 multiply-adds on the CUDA cores: no TF32, no bf16 tensor
//     core product;
//   * scores are (q.k) * scale with scale = D ** -0.5, rounded to float32;
//   * the causal mask keeps k_pos <= q_pos (top-left aligned) and writes
//     NEG_INF = -1e30 elsewhere;
//   * the running max m, sum l and accumulator acc are float32 and follow
//     m' = max(m, rowmax(s)), alpha = exp(m - m'), p = exp(s - m'),
//     l' = alpha l + rowsum(p), acc' = alpha acc + p.v, with expf;
//   * the result is acc / max(l, 1e-30), stored in q's dtype
//     (__float2bfloat16 rounds to nearest even, as astype does).
// A K/V tile lying wholly above the diagonal is skipped: every score in it
// is masked, so it adds exp(-1e30 - m) = 0 to l and acc once m is finite,
// and m is finite after the first tile (k_pos = 0 <= q_pos for every row).
//
// Design: the Pallas grid (B, Hq, Sq/blk_q, Sk/blk_k) carried m, l and acc
// across its sequential K axis in VMEM scratch.  Here one block of 256
// threads owns one (q tile, head, batch) and loops over the K/V tiles
// itself.  The q tile and the current K and V tiles are staged in shared
// memory as float32 (rows of K and Q padded by one word so that a column
// read hits 16 different banks); each thread keeps a (BQ/16) x (BK/16)
// score tile and a (BQ/16) x (D/16) accumulator in registers, m and l for
// its rows too.  Row reductions are shuffles among the 16 lanes that share
// a row.  p goes through shared memory for the p.v product.  Causal blocks
// are launched heaviest first.
//
// What bounds it: for causal attention at Sq = Sk = S the work is about
// 2 * B * Hq * S * S * D floating-point operations against
// 2 * B * S * (Hq + Hkv) * D elements read and written, far above the
// H100's operations-per-byte balance, so the kernel is bound by operations.
// The card's bound is that work over its bf16 tensor-core rate (989 TFLOP/s
// dense); this simple design leaves the tensor cores idle and runs on the
// float32 CUDA cores (67 TFLOP/s at most), so it cannot come near the bound.
// wgmma, TMA and bf16 products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TX = 16;  // threads along a row of a tile
constexpr int TY = 16;  // thread rows
constexpr int THREADS = TX * TY;

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

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], float32
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale) {
  constexpr int RQ = BQ / TY;  // query rows per thread
  constexpr int CK = BK / TX;  // score columns per thread
  constexpr int CD = D / TX;   // output columns per thread
  constexpr int LQ = D + 1;    // padded strides (bank-conflict free columns)
  constexpr int LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LQ;
  float* Vs = Ks + BK * LQ;
  float* Ps = Vs + BK * D;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int64_t q_row = (int64_t)Hq * D;
  const int64_t kv_row = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * kv_row + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * kv_row + (int64_t)hk * D;
  T* ob = o + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * D;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * LQ + d] = to_f32(qb[r * q_row + d]);
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Qs is written; the last tile's Ks, Vs, Ps are read
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int64_t off = (int64_t)(k0 + r) * kv_row + d;
      Ks[r * LQ + d] = to_f32(kb[off]);
      Vs[r * D + d] = to_f32(vb[off]);
    }
    __syncthreads();

    // s = q . k for this thread's rows ty + TY i and columns tx + TX j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * LQ + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + TX * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += qv[i] * kv[j];
    }

    // online softmax update, one row at a time
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TY * i;
      const int q_pos = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx + TX * j > q_pos) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * LP + tx + TX * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v for this thread's rows and columns tx + TX c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + (ty + TY * i) * q_row;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      orow[tx + TX * c] = from_f32<T>(acc[i][c] / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Sk, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int BQ, int BK>
int launch(const Args& a) {
  auto kern = flash_kernel<T, D, BQ, BK>;
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sq / BQ, a.Hq, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int by_head_dim(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16, BQ, BK>(a);
    case 32: return launch<T, 32, BQ, BK>(a);
    case 64: return launch<T, 64, BQ, BK>(a);
    case 128: return launch<T, 128, BQ, BK>(a);
    default: return -1;
  }
}

template <typename T>
int by_tile(int blk_q, int blk_k, int D, const Args& a) {
  if (blk_q == 64 && blk_k == 64) return by_head_dim<T, 64, 64>(D, a);
  if (blk_q == 128 && blk_k == 64) return by_head_dim<T, 128, 64>(D, a);
  return -1;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -1 for
// a head dim, tile or dtype this file was not compiled for.  The caller has
// checked shapes, contiguity and that Sq % blk_q == 0, Sk % blk_k == 0 and
// Hq % Hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int is_bf16, int causal, int blk_q,
                                      int blk_k, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Args a{q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale,
               (cudaStream_t)stream};
  return is_bf16 ? by_tile<__nv_bfloat16>(blk_q, blk_k, D, a)
                 : by_tile<float>(blk_q, blk_k, D, a);
}
