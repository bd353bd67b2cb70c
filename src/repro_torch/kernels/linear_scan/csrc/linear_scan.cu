// linear_scan: the chunked linear-attention recurrence of RWKV-6 and
// Mamba-2 (SSD), as a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/linear_scan/linear_scan.py:84 (linear_scan,
// the Pallas TPU kernel whose body is _ls_kernel).  Per batch b and head h,
// with state S (K x V) carried over the T/c chunks of c rows:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   o_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t    (pre-update, RWKV-6)
//   o_t = r_t . S_t                                (post-update, Mamba-2)
//
// r, k are (B, T, H, K) and v is (B, T, H, V), all float32 or all bfloat16;
// log_w is (B, T, H, K) float32, u (H, K) float32 or absent, state0
// (B, H, K, V) float32.  o is (B, T, H, V) in r's dtype, the final state
// (B, H, K, V) float32.  All contiguous.
//
// Semantics held from the Pallas kernel, chunk by chunk:
//   * log_w is clamped to [lo, 0] with lo = float32(-60 / c) for the
//     caller's chunk c; P is the inclusive cumulative sum of the clamped
//     log_w over the chunk's rows, Pq = P (post) or P - log_w (pre);
//   * q_eff = r exp(Pq), k_eff = k exp(-P): the two-sided factors stay
//     inside float32 range because |P| <= 60 (no re-clamp per sub-tile);
//   * o = q_eff S + A v with A_ij = q_eff_i . k_eff_j kept for j < i (pre)
//     or j <= i (post), plus r_i . (u * k_i) on the diagonal when u is given;
//   * S' = S exp(P_last) + sum_i (k_i exp(P_last - P_i)) v_i^T;
//   * every product is a float32 multiply-add on the CUDA cores (no TF32,
//     no tensor cores), expf without fast math; bfloat16 inputs are widened
//     to float32 and o is stored with __float2bfloat16 (round to nearest
//     even, as astype does).  Sums run in another order than the oracle's
//     einsums, so results agree within float32 rounding, not bit for bit.
//
// Design: the Pallas grid (B, H, T/c) carried S in VMEM scratch along its
// sequential chunk axis.  CUDA blocks run in no order, so one block of 256
// threads owns one (b, h, 32-column slice of V) and loops over the chunks
// itself, its slice of S in shared memory.  Columns of S are independent
// (o[:, j] reads only S[:, j] and v[:, j]), so the V/32 blocks of one head
// need no exchange; each recomputes the chunk's A.  A chunk of c = 256 rows
// at K = 64 does not fit in shared memory with A (c x c) beside it, so only
// q_eff, k_eff (c x K each) and the v slice (c x 32) are staged, and A is
// streamed in 64 x 64 sub-tiles: for each 64-row query tile, the inter term
// against S, then for each key tile at or below the diagonal A_ij in shared
// memory, masked on the diagonal tile, and o_i += A_ij v_j in registers.
// The cumulative sum is a segmented scan: 256 / K row segments per column,
// each scanned by one thread, then offset by the earlier segments' totals.
// Rows past c up to the next multiple of 64 are zero, so the sub-tile loops
// need no bounds checks; any 1 <= c <= 256 is taken.
//
// What bounds it: per (b, h, chunk) the function needs about 2cKV (inter) +
// Kc(c+1) (A, lower triangle) + Vc(c+1) (A v) + 2cKV (state) float32
// operations against 4 reads of c x K values and one write of c x V, about
// 10 operations per byte at K = V = 64, c = 256: above the H100's float32
// balance (67 TFLOP/s over 3.35 TB/s = 20 would be the line for full-rate
// FMAs), so the card's bound is set by the float32 operations.  This simple
// design computes the diagonal tiles whole, recomputes A once per V slice
// and issues about one shared-memory load per two FMAs, so it runs well
// below that bound; wgmma, TMA and tensor-core products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VT = 32;     // columns of V (and S) per block
constexpr int TI = 64;     // query rows per sub-tile
constexpr int TJ = 64;     // key rows per sub-tile
constexpr int ROWS = THREADS / VT;  // 8 thread rows over a 64 x 32 tile
constexpr int AR = THREADS / 16;    // 16 thread rows over a 64 x 64 A tile

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

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// float32 words of shared memory for chunk c and key width K:
// Qe, Ke [cp][K+1], Vs [cp][VT], S [K][VT], As [TI][TJ+1], plast [K],
// diag [cp], with cp = c rounded up to TI
__host__ __device__ __forceinline__ size_t smem_words(int c, int K) {
  const size_t cp = round_up(c, TI);
  return 2 * cp * (K + 1) + cp * VT + (size_t)K * VT + TI * (TJ + 1) + K +
         cp;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    linear_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ lw,
                       const float* __restrict__ u,
                       const float* __restrict__ s0, T* __restrict__ o,
                       float* __restrict__ sT, int T_len, int H, int K, int V,
                       int c, int post, float lo) {
  const int cp = round_up(c, TI);
  const int LK = K + 1;  // padded row: a column read hits distinct banks
  constexpr int LA = TJ + 1;
  extern __shared__ float smem[];
  float* Qe = smem;
  float* Ke = Qe + cp * LK;
  float* Vs = Ke + cp * LK;
  float* S = Vs + cp * VT;
  float* As = S + K * VT;
  float* plast = As + TI * LA;
  float* diag = plast + K;

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nv = min(VT, V - v0);  // live columns of this slice
  const int64_t rowK = (int64_t)H * K;  // stride of t in r, k, log_w
  const int64_t rowV = (int64_t)H * V;  // stride of t in v, o
  const int64_t baseK = (int64_t)b * T_len * rowK + (int64_t)h * K;
  const int64_t baseV = (int64_t)b * T_len * rowV + (int64_t)h * V + v0;
  const int64_t baseS = ((int64_t)b * H + h) * K * V + v0;

  // pad rows c..cp stay zero for the whole launch; diag is zero without u
  for (int i = tid; i < cp * LK; i += THREADS) {
    Qe[i] = 0.0f;
    Ke[i] = 0.0f;
  }
  for (int i = tid; i < cp * VT; i += THREADS) Vs[i] = 0.0f;
  for (int i = tid; i < cp; i += THREADS) diag[i] = 0.0f;
  for (int i = tid; i < K * VT; i += THREADS) {
    const int kk = i / VT, vv = i % VT;
    S[i] = vv < nv ? s0[baseS + (int64_t)kk * V + vv] : 0.0f;
  }

  const int G = THREADS / K;       // row segments of the scan
  const int seg = (c + G - 1) / G;  // rows per segment
  const int ty = tid / VT, tx = tid % VT;
  const int ai = tid / 16, aj = tid % 16;
  const int n_chunks = T_len / c;

  for (int n = 0; n < n_chunks; ++n) {
    const int64_t t0 = (int64_t)n * c;
    __syncthreads();  // the last chunk's reads of Qe, Ke, Vs, S are done

    // 1. clamped log_w into Ke
    for (int i = tid; i < c * K; i += THREADS) {
      const int row = i / K, kk = i % K;
      Ke[row * LK + kk] =
          fminf(fmaxf(lw[baseK + (t0 + row) * rowK + kk], lo), 0.0f);
    }
    __syncthreads();

    // 2. inclusive cumulative sum over the chunk's rows, per column:
    // each segment scanned in place, then offset by the earlier totals
    const int g = tid / K, kc = tid % K;
    const int r_lo = g * seg, r_hi = min(c, r_lo + seg);
    if (g < G) {
      float run = 0.0f;
      for (int row = r_lo; row < r_hi; ++row) {
        run += Ke[row * LK + kc];
        Ke[row * LK + kc] = run;
      }
    }
    __syncthreads();
    float off = 0.0f;
    if (g < G) {
      for (int gg = 0; gg < g; ++gg) {
        const int end = min(c, (gg + 1) * seg);
        if (end > gg * seg) off += Ke[(end - 1) * LK + kc];
      }
    }
    __syncthreads();
    if (g < G && off != 0.0f) {
      for (int row = r_lo; row < r_hi; ++row) Ke[row * LK + kc] += off;
    }
    __syncthreads();
    if (tid < K) plast[tid] = Ke[(c - 1) * LK + tid];
    __syncthreads();

    // 3. q_eff and k_eff in place of P; the diagonal bonus r . (u * k)
    for (int i = tid; i < c * K; i += THREADS) {
      const int row = i / K, kk = i % K;
      const int64_t at = baseK + (t0 + row) * rowK + kk;
      const float P = Ke[row * LK + kk];
      const float l = fminf(fmaxf(lw[at], lo), 0.0f);
      const float Pq = post ? P : P - l;
      Qe[row * LK + kk] = to_f32(r[at]) * expf(Pq);
      Ke[row * LK + kk] = to_f32(k[at]) * expf(-P);
    }
    if (u != nullptr) {
      const int warp = tid / 32, lane = tid % 32;
      for (int row = warp; row < c; row += THREADS / 32) {
        float s = 0.0f;
        for (int kk = lane; kk < K; kk += 32) {
          const int64_t at = baseK + (t0 + row) * rowK + kk;
          s += to_f32(r[at]) * u[h * K + kk] * to_f32(k[at]);
        }
#pragma unroll
        for (int w = 16; w > 0; w /= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
        if (lane == 0) diag[row] = s;
      }
    }
    // 4. this block's slice of v
    for (int i = tid; i < c * VT; i += THREADS) {
      const int row = i / VT, vv = i % VT;
      Vs[i] = vv < nv ? to_f32(v[baseV + (t0 + row) * rowV + vv]) : 0.0f;
    }
    __syncthreads();

    // 5. o for each 64-row query tile: rows it0 + ty + 8m, column tx
    for (int it0 = 0; it0 < c; it0 += TI) {
      float acc[TI / ROWS];
#pragma unroll
      for (int m = 0; m < TI / ROWS; ++m) acc[m] = 0.0f;
      for (int kk = 0; kk < K; ++kk) {  // inter: q_eff S
        const float s = S[kk * VT + tx];
#pragma unroll
        for (int m = 0; m < TI / ROWS; ++m)
          acc[m] += Qe[(it0 + ty + ROWS * m) * LK + kk] * s;
      }
      for (int jt0 = 0; jt0 <= it0; jt0 += TJ) {
        // A tile: rows ai + 16 m, columns aj + 16 n
        float a[TI / AR][TJ / 16];
#pragma unroll
        for (int m = 0; m < TI / AR; ++m)
#pragma unroll
          for (int q = 0; q < TJ / 16; ++q) a[m][q] = 0.0f;
#pragma unroll 4
        for (int kk = 0; kk < K; ++kk) {
          float qv[TI / AR], kv[TJ / 16];
#pragma unroll
          for (int m = 0; m < TI / AR; ++m)
            qv[m] = Qe[(it0 + ai + AR * m) * LK + kk];
#pragma unroll
          for (int q = 0; q < TJ / 16; ++q)
            kv[q] = Ke[(jt0 + aj + 16 * q) * LK + kk];
#pragma unroll
          for (int m = 0; m < TI / AR; ++m)
#pragma unroll
            for (int q = 0; q < TJ / 16; ++q) a[m][q] += qv[m] * kv[q];
        }
#pragma unroll
        for (int m = 0; m < TI / AR; ++m) {
          const int gi = it0 + ai + AR * m;
#pragma unroll
          for (int q = 0; q < TJ / 16; ++q) {
            const int gj = jt0 + aj + 16 * q;
            float x = (post ? gj <= gi : gj < gi) ? a[m][q] : 0.0f;
            if (gj == gi) x += diag[gi];
            As[(ai + AR * m) * LA + aj + 16 * q] = x;
          }
        }
        __syncthreads();
        for (int j = 0; j < TJ; ++j) {  // intra: A v
          const float vj = Vs[(jt0 + j) * VT + tx];
#pragma unroll
          for (int m = 0; m < TI / ROWS; ++m)
            acc[m] += As[(ty + ROWS * m) * LA + j] * vj;
        }
        __syncthreads();  // As is rewritten by the next key tile
      }
#pragma unroll
      for (int m = 0; m < TI / ROWS; ++m) {
        const int row = it0 + ty + ROWS * m;
        if (row < c && tx < nv)
          o[baseV + (t0 + row) * rowV + tx] = from_f32<T>(acc[m]);
      }
    }

    // 6. S' = S exp(P_last) + sum_i (k_eff_i exp(P_last)) v_i^T; each
    // thread owns entries (sk, tx) and nothing else reads S meanwhile
    for (int sk = ty; sk < K; sk += ROWS) {
      const float e = expf(plast[sk]);
      float s = 0.0f;
      for (int row = 0; row < c; ++row)
        s += (Ke[row * LK + sk] * e) * Vs[row * VT + tx];
      S[sk * VT + tx] = S[sk * VT + tx] * e + s;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * VT; i += THREADS) {
    const int kk = i / VT, vv = i % VT;
    if (vv < nv) sT[baseS + (int64_t)kk * V + vv] = S[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* o, float* sT, int B,
           int T_len, int H, int K, int V, int c, int post, float lo,
           cudaStream_t stream) {
  auto kern = linear_scan_kernel<T>;
  const size_t smem = smem_words(c, K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VT - 1) / VT, H, B);
  kern<<<grid, THREADS, smem, stream>>>((const T*)r, (const T*)k,
                                        (const T*)v, lw, u, s0, (T*)o, sT,
                                        T_len, H, K, V, c, post, lo);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -1 for
// a shape this file was not written for.  The caller has checked dtypes,
// shapes and contiguity, 1 <= K <= 64, V >= 1, 1 <= c <= 256 and T % c == 0;
// u is null when there is no bonus (use_u = 0).
extern "C" int linear_scan_launch(const void* r, const void* k,
                                  const void* v, const void* lw,
                                  const void* u, const void* s0, void* o,
                                  void* sT, int B, int T_len, int H, int K,
                                  int V, int c, int is_bf16, int post,
                                  int use_u, float lo, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (K < 1 || K > 64 || V < 1 || c < 1 || c > 256 || T_len % c) return -1;
  const float* uf = use_u ? (const float*)u : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
             ? launch<__nv_bfloat16>(r, k, v, (const float*)lw, uf,
                                     (const float*)s0, o, (float*)sT, B,
                                     T_len, H, K, V, c, post, lo, st)
             : launch<float>(r, k, v, (const float*)lw, uf, (const float*)s0,
                             o, (float*)sT, B, T_len, H, K, V, c, post, lo,
                             st);
}
