// linear_scan_bwd: the gradient of the chunked linear-attention recurrence
// of RWKV-6 and Mamba-2 (linear_scan.cu), as hand-written CUDA kernels for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and XLA
// differentiates its model's chunked_linear_attn
// (src/repro/models/ssm.py:29-78), the oracle of its Pallas linear_scan
// (src/repro/kernels/linear_scan/linear_scan.py:84).  This is that
// gradient: the vector-Jacobian product with respect to r, k, v, log_w, u
// and state0, for the cotangents dO of o and dS_T of the final state
// (absent: 0).  Shapes and dtypes are the forward's: r, k (B, T, H, K), v
// and dO (B, T, H, V), all float32 or all bfloat16; log_w (B, T, H, K), u
// (H, K), dS_T (B, H, K, V) float32.  dr, dk, dv come out in r's dtype,
// dlog_w float32, du as float32 partials (B, H, nt, K) that the caller
// sums over b and the tiles (no float atomics: two calls on the same
// inputs give the same bits), dstate0 float32 (B, H, K, V).
//
// The forward's tiling is kept: tiles of up to 64 rows, none across two
// chunks (so |P| <= 60 in a tile), nt = T/c ceil(c/64) of them per (b, h).
// In a tile with P the inclusive cumulative sum of the clamped log_w (at
// float32(-60/c) for the caller's chunk c), Pq = P (post-update) or P -
// log_w (pre-update), q = r exp(Pq), kap = k exp(-P), kt = k exp(P_last -
// P), d = exp(P_last), S the state before the tile and G the gradient of
// the state after it:
//   A  = q kap^T under the causal mask M (j < i pre, j <= i post), with the
//        bonus beta_i = r_i . (u * k_i) on its diagonal in pre-update;
//   dA = dO v^T;
//   dq = dO S^T + (dA*M) kap,  dkap = (dA*M)^T q,  dv = A^T dO + kt G,
//   dkt = v G^T,  dd = sum_v G*S,  dbeta_i = dA_ii;
//   dr = dq exp(Pq) + dbeta u k,  dk = dkap exp(-P) + dkt exp(P_last - P)
//        + dbeta u r,  du = sum_i dbeta_i r_i k_i;
//   dlog_w_i = sum_{j >= i} (dq*q - dkap*kap)_j + sum_{j < i} (dkt*kt)_j
//        + dd*d - (pre-update: (dq*q)_i), zero where the clamp binds
//        (log_w outside [float32(-60/c), 0], as torch.clamp's gradient);
//   the gradient of the state before the tile is d*G + q^T dO.
// (The dkt*kt terms enter dP_j negatively and P_last positively; summed in
// reverse they leave the sum over the rows before i.)
//
// Three launches on the caller's stream, counted as one call:
//   0. reverse state pass, one block per (b, h, tile, 64-column slice of
//      V): X_t = q_t^T dO_t into a float32 scratch (B, H, nt, K, V);
//   1. reverse hand-off, one thread per (b, h, entry of the state): from
//      G = dS_T (or 0) over the tiles in reverse, X_t is overwritten with
//      G_t, the gradient of the state after tile t, and G = d_t G + X_t;
//      the last G is dstate0.  d_t comes from the forward's scratch;
//   2. gradient pass, one block per (b, h, tile), looping over V in slices
//      of 64: from the forward's S before the tile (its scratch, kept by
//      the autograd function) and G_t, everything above.  Products are
//      register tiles of 4 x 4 a thread over operands in shared memory, as
//      in the forward (mma_rows, mma_cols); the column sums of dlog_w
//      and du run over four 16-row segments a column.
// All arithmetic is float32 multiply-adds on the CUDA cores (no TF32, no
// tensor cores), expf without fast math; bfloat16 inputs are widened to
// float32, and dr, dk, dv stored with __float2bfloat16.
//
// What bounds it: the function reads r, k, v, log_w and dO once and writes
// dr, dk, dv and dlog_w once (302 MB at rwkv6-1.6b's shape, B=2, T=2048,
// H=32, K=V=64, float32: 0.090 ms at 3.35 TB/s), and the token-by-token
// backward takes about 14 K V float32 operations a token and head (7.6
// GFLOP there, 0.114 ms at 67 TFLOP/s): operations, just.  This design is
// simple first: it reads the inputs twice (passes 0 and 2), the states
// three times, and its gradient pass holds 9 tiles of shared memory (one
// block an SM) and runs eight 64 x 64 x 64 products a tile, one after the
// other, with loads not overlapped with products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;      // rows of a tile; columns of a V slice
constexpr int MAXK = 64;      // widest key the tiles hold
constexpr int LD = TILE + 4;  // row stride of every shared tile, floats
constexpr int TILE_WORDS = TILE * LD;
static_assert(THREADS == 4 * MAXK, "the column passes run 4 x 64 threads");
static_assert(THREADS == 16 * 16, "a 16 x 16 thread grid over 64 x 64");

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

__host__ __device__ __forceinline__ int cdiv(int x, int m) {
  return (x + m - 1) / m;
}

__device__ __forceinline__ float clamp_lw(float x, float lo) {
  return fminf(fmaxf(x, lo), 0.0f);
}

// Element `it` (0..15) of a thread's share of a 64 x 64 tile: row and
// column; a warp covers 32 consecutive columns of one row.
__device__ __forceinline__ int el_row(int it) {
  return (threadIdx.x + it * THREADS) / TILE;
}
__device__ __forceinline__ int el_col(int it) {
  return (threadIdx.x + it * THREADS) % TILE;
}

// acc[m][n] += sum_{e < E} X[4 ty + m][e] * Y[tx + 16 n][e] (rows of X and
// Y against each other), shared tiles row by row, E a multiple of 4.
__device__ __forceinline__ void mma_rows(const float* __restrict__ X,
                                         const float* __restrict__ Y, int E,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 2
  for (int e = 0; e < E; e += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[m] = *reinterpret_cast<const float4*>(X + (4 * ty + m) * LD + e);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      y[n] = *reinterpret_cast<const float4*>(Y + (tx + 16 * n) * LD + e);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float a = acc[m][n];
        a = fmaf(x[m].x, y[n].x, a);
        a = fmaf(x[m].y, y[n].y, a);
        a = fmaf(x[m].z, y[n].z, a);
        a = fmaf(x[m].w, y[n].w, a);
        acc[m][n] = a;
      }
  }
}

// acc[m][n] += sum_{e < E} X[e][4 ty + m] * Y[e][4 tx + n] (columns of X
// and Y against each other: outer products), shared tiles row by row.
__device__ __forceinline__ void mma_cols(const float* __restrict__ X,
                                         const float* __restrict__ Y, int E,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    const float4 x = *reinterpret_cast<const float4*>(X + e * LD + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(Y + e * LD + 4 * tx);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xs[m], ys[n], acc[m][n]);
  }
}

// In place, down each column kk < K of the first n rows of Pt: the
// inclusive cumulative sum from the tile's first row, in four segments of
// 16 rows offset by the totals before them (the forward's scan_tile, so P
// is the same bits as there).  part holds 4 x 64 floats.  Begins and ends
// with a barrier.
__device__ __forceinline__ void scan_tile(float* Pt, int n, int K,
                                          float* part) {
  __syncthreads();
  const int tid = threadIdx.x;
  const int g = tid / MAXK, kk = tid % MAXK;
  const int r_lo = g * 16, r_hi = min(n, r_lo + 16);
  float run = 0.0f;
  if (kk < K) {
    for (int row = r_lo; row < r_hi; ++row) {
      run += Pt[row * LD + kk];
      Pt[row * LD + kk] = run;
    }
  }
  part[g * MAXK + kk] = run;
  __syncthreads();
  if (kk < K && g > 0) {
    float o = part[kk];
    for (int gg = 1; gg < g; ++gg) o += part[gg * MAXK + kk];
    for (int row = r_lo; row < r_hi; ++row) Pt[row * LD + kk] += o;
  }
  __syncthreads();
}

// Tile t of chunk ch of (b, h): rows row0 .. row0 + n - 1 of T.
struct Tile {
  int64_t gt, row0;  // tile index in (b, h), its first row in T
  int n;             // its rows
};

__device__ __forceinline__ Tile tile_at(int gt, int c) {
  const int nq = cdiv(c, TILE);
  const int ch = gt / nq, t = gt % nq;
  return Tile{gt, (int64_t)ch * c + t * TILE, min(TILE, c - t * TILE)};
}

// ---------------------------------------------------------------------
// 0. reverse state pass: grid (nt * nvs, H, B)
// ---------------------------------------------------------------------

// float32 words: Pt, Qe, Dn tiles, part [4 x 64]
constexpr size_t STATE_WORDS = 3 * TILE_WORDS + 4 * MAXK;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lsb_state(const T* __restrict__ r, const float* __restrict__ lw,
              const T* __restrict__ dO, float* __restrict__ X, int T_len,
              int H, int K, int V, int c, int post, float lo) {
  extern __shared__ __align__(16) float smem[];
  float* Pt = smem;             // [row][kk]: clamped log_w, then P
  float* Qe = Pt + TILE_WORDS;  // [row][kk]: r, then q = r exp(Pq)
  float* Dn = Qe + TILE_WORDS;  // [row][col]: dO
  float* part = Dn + TILE_WORDS;

  const int nvs = cdiv(V, TILE);
  const Tile tl = tile_at(blockIdx.x / nvs, c);
  const int v0 = (blockIdx.x % nvs) * TILE, nv = min(TILE, V - v0);
  const int h = blockIdx.y, b = blockIdx.z, n = tl.n;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t rowK = (int64_t)H * K, rowV = (int64_t)H * V;
  const int64_t baseK = ((int64_t)b * T_len + tl.row0) * rowK + (int64_t)h * K;
  const int64_t baseV =
      ((int64_t)b * T_len + tl.row0) * rowV + (int64_t)h * V + v0;

  float lx[16];
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int64_t at = baseK + row * rowK + col;
    lx[it] = ok ? clamp_lw(lw[at], lo) : 0.0f;
    Pt[row * LD + col] = lx[it];
    Qe[row * LD + col] = ok ? to_f32(r[at]) : 0.0f;
    Dn[row * LD + col] = row < n && col < nv
                             ? to_f32(dO[baseV + row * rowV + col])
                             : 0.0f;
  }
  scan_tile(Pt, n, K, part);
  // a thread rewrites only the elements it wrote
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const float P = Pt[row * LD + col];
    Qe[row * LD + col] *= row < n && col < K
                              ? expf(post ? P : P - lx[it])
                              : 0.0f;
  }
  __syncthreads();
  float acc[4][4] = {};
  mma_cols(Qe, Dn, n, ty, tx, acc);  // q^T dO: (kk, col)
  const int64_t slot = ((int64_t)b * H + h) * (T_len / c * cdiv(c, TILE)) +
                       tl.gt;
  float* out = X + slot * K * V + v0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int kk = 4 * ty + m;
    if (kk >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      if (col < nv) out[(int64_t)kk * V + col] = acc[m][q];
    }
  }
}

// ---------------------------------------------------------------------
// 1. reverse hand-off: grid (ceil(K V / 256), H, B)
// ---------------------------------------------------------------------

// From G = dS_T (0 when absent) over the nt tiles of (b, h) in reverse:
// X_t is overwritten with G, the gradient of the state after tile t, then
// G = d_t G + X_t; the last G is dstate0.  Eight tiles' loads are in
// flight at a time.
__global__ void __launch_bounds__(THREADS)
    lsb_handoff(const float* __restrict__ dST, float* __restrict__ X,
                const float* __restrict__ dec, float* __restrict__ ds0,
                int H, int K, int V, int nt) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= K * V) return;
  const int kk = idx / V;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int64_t KV = (int64_t)K * V;
  float* p = X + bh * nt * KV + idx;
  const float* d = dec + bh * nt * K + kk;
  float G = dST != nullptr ? dST[bh * KV + idx] : 0.0f;
  for (int t0 = nt - 1; t0 >= 0; t0 -= 8) {
    float x[8], w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = t0 - i >= 0 ? p[(t0 - i) * KV] : 0.0f;
      w[i] = t0 - i >= 0 ? d[(int64_t)(t0 - i) * K] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 - i >= 0) {
        p[(t0 - i) * KV] = G;
        G = w[i] * G + x[i];
      }
    }
  }
  ds0[bh * KV + idx] = G;
}

// ---------------------------------------------------------------------
// 2. gradient pass: grid (nt, H, B)
// ---------------------------------------------------------------------

// float32 words: nine tiles, part [3 x 4 x 64], bonus partials [64 x 2],
// dbeta [64], d [64], dd [64]
constexpr size_t GRAD_WORDS =
    9 * TILE_WORDS + 3 * 4 * MAXK + 2 * TILE + TILE + 2 * MAXK;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lsb_grad(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const T* __restrict__ dO,
             const float* __restrict__ Sb, const float* __restrict__ Gb,
             T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
             float* __restrict__ dlw, float* __restrict__ du_part,
             int T_len, int H, int K, int V, int c, int post, float lo) {
  extern __shared__ __align__(16) float smem[];
  float* Pt = smem;              // [row][kk]: clamped log_w, then P
  float* Qe = Pt + TILE_WORDS;   // [row][kk]: r, then q
  float* Kn = Qe + TILE_WORDS;   // [row][kk]: k, then kap = k exp(-P)
  float* KtT = Kn + TILE_WORDS;  // [kk][row]: kt = k exp(P_last - P)
  float* AM = KtT + TILE_WORDS;  // [i][j]: A masked, with the bonus
  float* W0 = AM + TILE_WORDS;   // v slice; then dA*M [i][j]; then Y
  float* W1 = W0 + TILE_WORDS;   // dO slice; then (dA*M)^T [j][i]; then Z
  float* W2 = W1 + TILE_WORDS;   // S slice [kk][col]; then dO S^T; then U
  float* W3 = W2 + TILE_WORDS;   // G slice [kk][col]; then dkt; then dq*q
  float* part = W3 + TILE_WORDS;   // [3][4][64]
  float* dpart = part + 3 * 4 * MAXK;
  float* dbeta = dpart + 2 * TILE;
  float* dl = dbeta + TILE;        // d = exp(P_last)
  float* ddv = dl + MAXK;          // dd = sum_v G S

  const Tile tl = tile_at(blockIdx.x, c);
  const int h = blockIdx.y, b = blockIdx.z, n = tl.n;
  const int KP = (K + 3) & ~3;  // K rounded up to a float4: zeros past K
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t rowK = (int64_t)H * K, rowV = (int64_t)H * V;
  const int64_t baseK = ((int64_t)b * T_len + tl.row0) * rowK + (int64_t)h * K;
  const int64_t baseV = ((int64_t)b * T_len + tl.row0) * rowV + (int64_t)h * V;
  const int64_t slot = ((int64_t)b * H + h) * (T_len / c * cdiv(c, TILE)) +
                       tl.gt;
  const float* S = Sb + slot * K * V;  // the state before the tile
  const float* G = Gb + slot * K * V;  // the gradient of the state after it

  // the tile's r, k and log_w
  float lx[16];
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int64_t at = baseK + row * rowK + col;
    lx[it] = ok ? clamp_lw(lw[at], lo) : 0.0f;
    Pt[row * LD + col] = lx[it];
    Qe[row * LD + col] = ok ? to_f32(r[at]) : 0.0f;
    Kn[row * LD + col] = ok ? to_f32(k[at]) : 0.0f;
  }
  scan_tile(Pt, n, K, part);
  // q, kap, kt^T and the bonus r . (u * k), row by row
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const float P = Pt[row * LD + col];
    const float Pl = Pt[(n - 1) * LD + col];
    const float rr = Qe[row * LD + col], kr = Kn[row * LD + col];
    Qe[row * LD + col] = ok ? rr * expf(post ? P : P - lx[it]) : 0.0f;
    Kn[row * LD + col] = ok ? kr * expf(-P) : 0.0f;
    KtT[col * LD + row] = ok ? kr * expf(Pl - P) : 0.0f;
    if (u != nullptr) {
      float sb = ok ? rr * u[h * K + col] * kr : 0.0f;
#pragma unroll
      for (int sh = 16; sh > 0; sh /= 2)
        sb += __shfl_xor_sync(0xffffffffu, sb, sh);
      if (tid % 32 == 0) dpart[row * 2 + col / 32] = sb;
    }
  }
  if (tid < MAXK) dl[tid] = tid < K ? expf(Pt[(n - 1) * LD + tid]) : 0.0f;
  __syncthreads();
  {  // A = q kap^T, masked, with the bonus on the diagonal
    float a[4][4] = {};
    mma_rows(Qe, Kn, KP, ty, tx, a);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gj = tx + 16 * q;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int gi = 4 * ty + m;
        float y = (post ? gj <= gi : gj < gi) ? a[m][q] : 0.0f;
        if (u != nullptr && gj == gi) y += dpart[gi * 2] + dpart[gi * 2 + 1];
        AM[gi * LD + gj] = y;
      }
    }
  }

  // over V in slices of 64: dA, dO S^T, dkt and dd summed; dv stored
  float dA[4][4] = {}, dq1[4][4] = {}, dkt[4][4] = {};
  float dd = 0.0f;  // thread kk = tid < K
  for (int v0 = 0; v0 < V; v0 += TILE) {
    const int nv = min(TILE, V - v0);
    __syncthreads();  // AM is written; the last slice's tiles are read
#pragma unroll
    for (int it = 0; it < 16; ++it) {
      const int row = el_row(it), col = el_col(it);
      const bool okv = row < n && col < nv;
      const int64_t at = baseV + row * rowV + v0 + col;
      W0[row * LD + col] = okv ? to_f32(v[at]) : 0.0f;
      W1[row * LD + col] = okv ? to_f32(dO[at]) : 0.0f;
      // here row is kk
      const bool oks = row < K && col < nv;
      W2[row * LD + col] = oks ? S[(int64_t)row * V + v0 + col] : 0.0f;
      W3[row * LD + col] = oks ? G[(int64_t)row * V + v0 + col] : 0.0f;
    }
    __syncthreads();
    mma_rows(W1, W0, TILE, ty, tx, dA);   // dO v^T: (i, j)
    mma_rows(W1, W2, TILE, ty, tx, dq1);  // dO S^T: (i, kk)
    mma_rows(W0, W3, TILE, ty, tx, dkt);  // v G^T: (j, kk)
    if (tid < K)
      for (int col = 0; col < nv; ++col)
        dd = fmaf(W3[tid * LD + col], W2[tid * LD + col], dd);
    float acc[4][4] = {};
    mma_cols(AM, W1, n, ty, tx, acc);    // A^T dO: (j, col)
    mma_cols(KtT, W3, K, ty, tx, acc);   // kt G: (j, col)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = 4 * ty + m;
      if (row >= n) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 4 * tx + q;
        if (col < nv)
          dv[baseV + (int64_t)row * rowV + v0 + col] = from_f32<T>(acc[m][q]);
      }
    }
  }
  __syncthreads();  // every slice's tiles are read: W0-W3 take the sums
  if (tid < K) ddv[tid] = dd;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int gj = tx + 16 * q;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gi = 4 * ty + m;
      const float y = (post ? gj <= gi : gj < gi) ? dA[m][q] : 0.0f;
      W0[gi * LD + gj] = y;  // dA*M [i][j]
      W1[gj * LD + gi] = y;  // (dA*M)^T [j][i]
      if (gj == gi) dbeta[gi] = dA[m][q];
      W2[gi * LD + gj] = dq1[m][q];  // dO S^T [i][kk]
      W3[gi * LD + gj] = dkt[m][q];  // v G^T [j][kk]
    }
  }
  __syncthreads();
  float g[4][4] = {}, hk[4][4] = {};
  mma_cols(W1, Kn, n, ty, tx, g);   // (dA*M) kap: (i, kk)
  mma_cols(W0, Qe, n, ty, tx, hk);  // (dA*M)^T q: (j, kk)
  // element by element, (row, kk) = (4 ty + m, 4 tx + q): dr and dk
  // stored; Y = dq*q - dkap*kap, Z = dkt*kt, U = dbeta r k and dq*q kept
  float Y[4][4], Z[4][4], U[4][4], Dq[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = 4 * ty + m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = 4 * tx + q;
      Y[m][q] = Z[m][q] = U[m][q] = Dq[m][q] = 0.0f;
      if (row >= n || kk >= K) continue;
      const int64_t at = baseK + row * rowK + kk;
      const float P = Pt[row * LD + kk];
      const float Pl = Pt[(n - 1) * LD + kk];
      const float lwc = clamp_lw(lw[at], lo);
      const float rr = to_f32(r[at]), kr = to_f32(k[at]);
      const float dq = W2[row * LD + kk] + g[m][q];
      const float dkap = hk[m][q], dktv = W3[row * LD + kk];
      const float db = u != nullptr ? dbeta[row] : 0.0f;
      const float uk = u != nullptr ? u[h * K + kk] : 0.0f;
      dr[at] = from_f32<T>(dq * expf(post ? P : P - lwc) + db * uk * kr);
      dk[at] = from_f32<T>(dkap * expf(-P) + dktv * expf(Pl - P) +
                           db * uk * rr);
      Dq[m][q] = dq * Qe[row * LD + kk];
      Y[m][q] = Dq[m][q] - dkap * Kn[row * LD + kk];
      Z[m][q] = dktv * KtT[kk * LD + row];
      U[m][q] = db * rr * kr;
    }
  }
  __syncthreads();  // W0-W3 are read: they take Y, Z, U and dq*q
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = 4 * ty + m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = 4 * tx + q;
      W0[row * LD + kk] = Y[m][q];
      W1[row * LD + kk] = Z[m][q];
      W2[row * LD + kk] = U[m][q];
      W3[row * LD + kk] = post ? 0.0f : Dq[m][q];
    }
  }
  __syncthreads();
  // down each column kk in four segments of 16 rows: Y summed from the
  // bottom (inclusive), Z from the top (exclusive), U in total
  const int sg = tid / MAXK, kk = tid % MAXK;
  const int r_lo = sg * 16, r_hi = min(n, r_lo + 16);
  float sy = 0.0f, sz = 0.0f, su = 0.0f;
  if (kk < K)
    for (int row = r_lo; row < r_hi; ++row) {
      sy += W0[row * LD + kk];
      sz += W1[row * LD + kk];
      su += W2[row * LD + kk];
    }
  part[sg * MAXK + kk] = sy;
  part[(4 + sg) * MAXK + kk] = sz;
  part[(8 + sg) * MAXK + kk] = su;
  __syncthreads();
  if (kk < K) {
    float ry = 0.0f, rz = 0.0f;
    for (int gg = sg + 1; gg < 4; ++gg) ry += part[gg * MAXK + kk];
    for (int gg = 0; gg < sg; ++gg) rz += part[(4 + gg) * MAXK + kk];
    for (int row = r_hi - 1; row >= r_lo; --row) {
      ry += W0[row * LD + kk];
      W0[row * LD + kk] = ry;
    }
    const float last = ddv[kk] * dl[kk];
    for (int row = r_lo; row < r_hi; ++row) {
      const int64_t at = baseK + row * rowK + kk;
      const float raw = lw[at];
      const float g_lw = W0[row * LD + kk] + rz + last - W3[row * LD + kk];
      dlw[at] = raw >= lo && raw <= 0.0f ? g_lw : 0.0f;
      rz += W1[row * LD + kk];
    }
    if (sg == 0)
      du_part[slot * K + kk] = part[8 * MAXK + kk] + part[9 * MAXK + kk] +
                               part[10 * MAXK + kk] + part[11 * MAXK + kk];
  }
}

struct Args {
  const void *r, *k, *v;
  const float *lw, *u;
  const void* dO;
  const float* dST;
  const float* states;
  float* scratch;
  void *dr, *dk, *dv;
  float *dlw, *du_part, *ds0;
  int B, T_len, H, K, V, c, post;
  float lo;
  cudaStream_t stream;
};

template <typename T>
int launch_pass(int which, const Args& a) {
  const int nvs = cdiv(a.V, TILE);
  const int nt = a.T_len / a.c * cdiv(a.c, TILE);  // tiles of (b, h)
  // the forward's scratch: the state before each tile (B, H, nt, K, V),
  // then each tile's decay (B, H, nt, K)
  const float* Sb = a.states;
  const float* dec = Sb + (size_t)a.B * a.H * nt * a.K * a.V;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    auto kern = lsb_state<T>;
    const size_t smem = STATE_WORDS * sizeof(float);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nt * nvs, a.H, a.B), THREADS, smem, a.stream>>>(
        (const T*)a.r, a.lw, (const T*)a.dO, a.scratch, a.T_len, a.H, a.K,
        a.V, a.c, a.post, a.lo);
  } else if (which == 1) {
    lsb_handoff<<<dim3(cdiv(a.K * a.V, THREADS), a.H, a.B), THREADS, 0,
                  a.stream>>>(a.dST, a.scratch, dec, a.ds0, a.H, a.K, a.V,
                              nt);
  } else if (which == 2) {
    auto kern = lsb_grad<T>;
    const size_t smem = GRAD_WORDS * sizeof(float);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nt, a.H, a.B), THREADS, smem, a.stream>>>(
        (const T*)a.r, (const T*)a.k, (const T*)a.v, a.lw, a.u,
        (const T*)a.dO, Sb, a.scratch, (T*)a.dr, (T*)a.dk, (T*)a.dv, a.dlw,
        a.du_part, a.T_len, a.H, a.K, a.V, a.c, a.post, a.lo);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Run pass `which` (0 reverse state pass, 1 reverse hand-off, 2 gradient
// pass) on `stream`; returns cudaGetLastError() (0 on success), or -1 for
// a shape this file was not written for.  The caller has checked dtypes,
// shapes and contiguity, 1 <= K <= 64, V >= 1, 1 <= c <= 256 and
// T % c == 0; u is null when there is no bonus (use_u = 0), dST null when
// the final state's cotangent is 0; states is the forward's scratch (B H
// nt K (V + 1) floats, nt = T/c ceil(c/64): the state before each tile,
// then each tile's decay) and scratch holds B H nt K V floats; du_part
// is (B, H, nt, K).
extern "C" int linear_scan_bwd_pass(
    int which, const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* dO, const void* dST, const void* states,
    void* scratch, void* dr, void* dk, void* dv, void* dlw, void* du_part,
    void* ds0, int B, int T_len, int H, int K, int V, int c, int is_bf16,
    int post, int use_u, float lo, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (K < 1 || K > MAXK || V < 1 || c < 1 || c > 4 * TILE || T_len % c)
    return -1;
  const Args a{r,
               k,
               v,
               (const float*)lw,
               use_u ? (const float*)u : nullptr,
               dO,
               (const float*)dST,
               (const float*)states,
               (float*)scratch,
               dr,
               dk,
               dv,
               (float*)dlw,
               (float*)du_part,
               (float*)ds0,
               B,
               T_len,
               H,
               K,
               V,
               c,
               post,
               lo,
               (cudaStream_t)stream};
  return is_bf16 ? launch_pass<__nv_bfloat16>(which, a)
                 : launch_pass<float>(which, a);
}

// The whole backward: the three passes back to back on `stream`.
extern "C" int linear_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* dO, const void* dST, const void* states,
    void* scratch, void* dr, void* dk, void* dv, void* dlw, void* du_part,
    void* ds0, int B, int T_len, int H, int K, int V, int c, int is_bf16,
    int post, int use_u, float lo, void* stream) {
  for (int which = 0; which < 3; ++which) {
    const int rc = linear_scan_bwd_pass(which, r, k, v, lw, u, dO, dST,
                                        states, scratch, dr, dk, dv, dlw,
                                        du_part, ds0, B, T_len, H, K, V, c,
                                        is_bf16, post, use_u, lo, stream);
    if (rc != 0) return rc;
  }
  return 0;
}
