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
//   2. gradient pass, one block of 8 warps per (b, h, tile), two blocks an
//      SM: from the forward's S before the tile (its scratch, kept by the
//      autograd function) and G_t, everything above.
//      * Its eight products run on the tensor cores at float32 accuracy:
//        3xTF32 on mma.sync m16n8k8 (each operand split into a TF32 high
//        part and a TF32 remainder; lo*hi + hi*lo + hi*hi summed in
//        float32; TF32 alone keeps ~3 digits), on fragments each warp loads
//        from shared memory, a 32 x 16 block of a 64 x 64 product a warp.
//        mma.sync takes A and B as the fragments lie, so the transposed
//        operands (A^T dO, (dA*M)^T q) cost nothing more; wgmma's TF32
//        form takes only K-major operands from shared memory.
//      * 102,400 bytes of shared memory, so that two blocks share an SM
//        (one block's loads and barriers overlap the other's products):
//        four 64 x 64 tiles (the clamped log_w, q, kap, and A, then dA*M,
//        then P) and four 64 x 32 tiles of a slice of V (dO, v, S, G),
//        rows unpadded and swizzled (swz) so that fragment loads by rows
//        and by columns are free of bank conflicts.  kt = kap d is never
//        stored: d = exp(P_last) scales kap's fragments in kt G and the
//        columns of v G^T.  P is scanned again from the clamped log_w
//        (the same bits) rather than kept.
//      * r, k and log_w are read once (r and k come back from q and kap
//        for the bonus terms: r = q / exp(Pq), k = kap / exp(-P)).  Where
//        rows are 16-byte aligned (lsb_grad<T, true>), they and the V
//        slices load by cp.async (in bf16, S and G only), the first slice
//        in flight while q, kap and A are computed; else element by
//        element.  dr, dk and dv are stored from the fragments, the pair of
//        columns a lane holds in one 8-byte store (whole 32-byte sectors);
//        dlog_w from its column scan.
//      * The column sums of dlog_w (a reverse scan of F = dq*q -
//        (dkap + dkt) kap, plus the column totals of dkt kt and dd d) and
//        of du run in a fixed order: two calls give the same bits.
// Passes 0 and 1 are float32 multiply-adds on the CUDA cores, expf without
// fast math; bfloat16 inputs are widened to float32, and dr, dk, dv stored
// with __float2bfloat16.
//
// What bounds it: the function reads r, k, v, log_w and dO once and writes
// dr, dk, dv and dlog_w once (302 MB at rwkv6-1.6b's shape, B=2, T=2048,
// H=32, K=V=64, float32: 0.090 ms at 3.35 TB/s), and the token-by-token
// backward takes about 14 K V operations a token and head (7.6 GFLOP
// there), products nearly all: at float32 accuracy on the tensor cores,
// 3xTF32 at a third of the 495 TFLOP/s TF32 rate, 0.046 ms.  So the
// function is bound by its bytes.  The tiled gradient pass does eight
// 64 x 64 x 64 products a tile (8.6 GFLOP there, 25.8 as 3xTF32: 0.05 ms
// at the TF32 rate), so it is held back by its shared-memory fragment
// loads and barriers, not by the tensor cores.
// Passes 0 and 1 read the inputs and the states once more (ROADMAP).
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

// Element (r, c) of a tile with rows of ld = 64 or 32 floats (no padding)
// lies at r * ld + swz(r, c).  The XOR flips bits 2-4 of the column by the
// row, so that the mma fragments' loads by rows (lane (g, t) at (r0 + g,
// c0 + t)) and by columns (at (r0 + t, c0 + g)), r0 and c0 multiples of 8,
// each touch 32 distinct banks, and four floats from a multiple of 4 stay
// together (one 16-byte cp.async).
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ (((r & 3) << 3) | (r & 4));
}
__device__ __forceinline__ int sat(int ld, int r, int c) {
  return r * ld + swz(r, c);
}

// Where element (row, kk) of a 64-row tile lies: rows of LD floats, or
// (SW) the gradient pass's swizzled rows of 64
template <bool SW>
__device__ __forceinline__ int tile_at_rc(int row, int kk) {
  return SW ? sat(TILE, row, kk) : row * LD + kk;
}

// In place, down each column kk < K of the first n rows of Pt: the
// inclusive cumulative sum from the tile's first row, in four segments of
// 16 rows offset by the totals before them (the forward's scan_tile, so P
// is the same bits as there).  part holds 4 x 64 floats.  Begins and ends
// with a barrier.
template <bool SW = false>
__device__ __forceinline__ void scan_tile(float* Pt, int n, int K,
                                          float* part) {
  __syncthreads();
  const int tid = threadIdx.x;
  const int g = tid / MAXK, kk = tid % MAXK;
  const int r_lo = g * 16, r_hi = min(n, r_lo + 16);
  float run = 0.0f;
  if (kk < K) {
    for (int row = r_lo; row < r_hi; ++row) {
      run += Pt[tile_at_rc<SW>(row, kk)];
      Pt[tile_at_rc<SW>(row, kk)] = run;
    }
  }
  part[g * MAXK + kk] = run;
  __syncthreads();
  if (kk < K && g > 0) {
    float o = part[kk];
    for (int gg = 1; gg < g; ++gg) o += part[gg * MAXK + kk];
    for (int row = r_lo; row < r_hi; ++row) Pt[tile_at_rc<SW>(row, kk)] += o;
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
// 2. gradient pass: grid (nt, H, B), two blocks an SM
// ---------------------------------------------------------------------

constexpr int HALF = 32;          // columns of a V slice in the gradient pass
constexpr int GT = TILE * TILE;   // floats of a 64 x 64 tile
constexpr int HT = TILE * HALF;   // floats of a 64 x 32 slice tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of the committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (cvt.rna: round to nearest,
// ties away from zero, to 10 mantissa bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b: one m16n8k8 TF32 product on the tensor cores, float32 sums
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += A B over k in [k_lo, k_hi) (multiples of 8), for the
// warp's block of MT m16 tiles by NT n8 tiles at (m0, n0).  A(m, k) is
// X(m, k), or X(k, m) with AT, times ks[k] with SCALE; B(k, n) is Y(n, k),
// or Y(k, n) with BKN; X and Y are swizzled tiles with rows of ldx and ldy
// floats.  3xTF32: each operand is split into a TF32 high part and a TF32
// remainder, and lo*hi + hi*lo + hi*hi is summed in float32 (the dropped
// lo*lo is ~2^-22 of the product), which keeps float32's accuracy where
// TF32 alone keeps ~3 digits.  Fragments of mma.m16n8k8.tf32: lane (g, t)
// = (lane / 4, lane % 4) holds A(g, t), A(g + 8, t), A(g, t + 4),
// A(g + 8, t + 4), B(t, g), B(t + 4, g) and C(g, 2t), C(g, 2t + 1),
// C(g + 8, 2t), C(g + 8, 2t + 1).
template <int MT, int NT, bool AT, bool BKN, bool SCALE>
__device__ __forceinline__ void mma_block(float (&acc)[MT][NT][4],
                                          const float* __restrict__ X,
                                          int ldx,
                                          const float* __restrict__ Y,
                                          int ldy, int m0, int n0, int k_lo,
                                          int k_hi,
                                          const float* __restrict__ ks) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const int ka = k0 + t, kb = ka + 4;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + 16 * mt + g;
      float a[4];
      if constexpr (AT) {
        a[0] = X[sat(ldx, ka, m)];
        a[1] = X[sat(ldx, ka, m + 8)];
        a[2] = X[sat(ldx, kb, m)];
        a[3] = X[sat(ldx, kb, m + 8)];
      } else {
        a[0] = X[sat(ldx, m, ka)];
        a[1] = X[sat(ldx, m + 8, ka)];
        a[2] = X[sat(ldx, m, kb)];
        a[3] = X[sat(ldx, m + 8, kb)];
      }
      if constexpr (SCALE) {
        const float sa = ks[ka], sb = ks[kb];
        a[0] *= sa;
        a[1] *= sa;
        a[2] *= sb;
        a[3] *= sb;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[mt][i], al[mt][i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int nn = n0 + 8 * nt + g;
      const float b0 = BKN ? Y[sat(ldy, ka, nn)] : Y[sat(ldy, nn, ka)];
      const float b1 = BKN ? Y[sat(ldy, kb, nn)] : Y[sat(ldy, nn, kb)];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      // the small terms first; the MT products of each pass are
      // independent, so the three passes' dependent chains interleave
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma8(acc[mt][nt], al[mt], bh0, bh1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma8(acc[mt][nt], ah[mt], bl0, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma8(acc[mt][nt], ah[mt], bh0, bh1);
    }
  }
}

// p[0] = x0 and, if two, p[1] = x1, in T: one 8-byte (bf16: 4-byte) store
// where both are stored and p is aligned for it (aligned: p's element
// index is even), else element by element.  The fragments' column pairs
// (2t, 2t + 1) so write whole 32-byte sectors.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1, bool two,
                                       bool aligned) {
  if (two && aligned) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = from_f32<T>(x0);
    if (two) p[1] = from_f32<T>(x1);
  }
}

// Row and column of element e of accumulator tile (mt, nt) of the warp's
// block at (m0, n0)
__device__ __forceinline__ int acc_row(int m0, int mt, int e) {
  return m0 + 16 * mt + (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int n0, int nt, int e) {
  return n0 + 8 * nt + 2 * (threadIdx.x % 4) + e % 2;
}

// Up each column kk < K of the first n rows of a swizzled 64 x 64 tile X:
// the inclusive sum from row n - 1 up, in four segments of 16 rows offset
// by the totals below them, plus add[kk], less E (row, kk), is stored at
// out[row * ld + kk] where mask (row, kk) is set, else 0.  part holds
// 4 x 64 floats; the caller has synchronised before.
__device__ __forceinline__ void rev_scan_store(
    const float* X, const float* E, const float* add, const uint32_t* mask,
    int n, int K, float* part, float* __restrict__ out, int64_t ld) {
  const int tid = threadIdx.x;
  const int sg = tid / MAXK, kk = tid % MAXK;
  const int r_lo = sg * 16, r_hi = min(n, r_lo + 16);
  float run = 0.0f;
  if (kk < K)
    for (int row = r_lo; row < r_hi; ++row) run += X[sat(TILE, row, kk)];
  part[sg * MAXK + kk] = run;
  __syncthreads();
  if (kk < K) {
    float o = 0.0f;
    for (int gg = 3; gg > sg; --gg) o += part[gg * MAXK + kk];
    o += add[kk];
    for (int row = r_hi - 1; row >= r_lo; --row) {
      o += X[sat(TILE, row, kk)];
      const bool keep = (mask[row * 2 + kk / 32] >> (kk % 32)) & 1u;
      out[row * ld + kk] = keep ? o - E[sat(TILE, row, kk)] : 0.0f;
    }
  }
}

// Sums of x over the rows of the warp's 32 x 16 block for each of its
// columns, stored at out[col] by the lanes of the quad of row 0 (the
// shuffles run over the eight rows a quad of lanes apart)
__device__ __forceinline__ void col_sums(float (&x)[2][2], int n0,
                                         float* out) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = x[nt][e];
#pragma unroll
      for (int sh = 4; sh < 32; sh *= 2)
        v += __shfl_xor_sync(0xffffffffu, v, sh);
      if (threadIdx.x % 32 < 4) out[acc_col(n0, nt, e)] = v;
    }
}

// float32 words: four 64 x 64 tiles (clamped log_w, q, kap, A), four
// 64 x 32 slice tiles (dO, v, S, G), the scans' partials [4 x 64], the
// column sums' [2 x 2 x 64], the bonus partials [64 x 2], dbeta, d, dd d
// and u [64 each], and the clamp mask [64 x 2 words]: 102,400 bytes
constexpr size_t GRAD_WORDS = 4 * GT + 4 * HT + 4 * MAXK + 4 * MAXK +
                              2 * TILE + 4 * MAXK + 2 * TILE;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    lsb_grad(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const T* __restrict__ dO,
             const float* __restrict__ Sb, const float* __restrict__ Gb,
             T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
             float* __restrict__ dlw, float* __restrict__ du_part,
             int T_len, int H, int K, int V, int c, int post, float lo) {
  extern __shared__ __align__(16) float smem[];
  float* Lw = smem;           // [row][kk]: clamped log_w
  float* Qs = Lw + GT;        // [row][kk]: r, then q = r exp(Pq)
  float* Ks = Qs + GT;        // [row][kk]: k, then kap = k exp(-P)
  float* Am = Ks + GT;        // P; A*M with the bonus [i][j]; dA*M; P
  float* Do = Am + GT;        // [i][col] dO slice; after the slices, with
  float* Vs = Do + HT;        //   Vs, the 64 x 64 tile F [row][kk]
  float* Ss = Vs + HT;        // [kk][col] S slice
  float* Gs = Ss + HT;        // [kk][col] G slice
  float* part = Gs + HT;      // [4][64]
  float* colp = part + 4 * MAXK;  // [Z, U][32-row half][64]
  float* dpart = colp + 4 * MAXK;
  float* dbeta = dpart + 2 * TILE;
  float* dl = dbeta + TILE;   // d = exp(P_last)
  float* ddl = dl + MAXK;     // dd d = sum_v G S d
  float* us = ddl + MAXK;     // u of head h
  uint32_t* mask = reinterpret_cast<uint32_t*>(us + MAXK);  // clamp free

  const Tile tl = tile_at(blockIdx.x, c);
  const int h = blockIdx.y, b = blockIdx.z, n = tl.n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K8 = (K + 7) & ~7, n8 = (n + 7) & ~7;
  const int64_t rowK = (int64_t)H * K, rowV = (int64_t)H * V;
  const int64_t baseK = ((int64_t)b * T_len + tl.row0) * rowK + (int64_t)h * K;
  const int64_t baseV = ((int64_t)b * T_len + tl.row0) * rowV + (int64_t)h * V;
  const int64_t slot = ((int64_t)b * H + h) * (T_len / c * cdiv(c, TILE)) +
                       tl.gt;
  const float* S = Sb + slot * K * V;  // the state before the tile
  const float* G = Gb + slot * K * V;  // the gradient of the state after it
  // the warp's 32 x 16 block of a 64 x 64 product
  const int m0 = 32 * (warp % 2), n0 = 16 * (warp / 2);
  const bool lower = n0 <= m0 + 31;  // not wholly above the diagonal

  // columns v0 .. v0 + 31 of dO and v (rows of the tile) and of S and G
  // (rows kk), zeros outside: 16-byte cp.async where the rows are 16-byte
  // aligned (VEC; dO and v only in float32), else element by element
  auto load_slice = [&](int v0) {
    const int nv = min(HALF, V - v0);
    constexpr bool f32 = sizeof(T) == 4;
    if constexpr (VEC) {
#pragma unroll 1  // one chunk's four addresses live at a time
      for (int it = 0; it < 2; ++it) {
        const int ci = tid + it * THREADS, row = ci / 8, c4 = (ci % 8) * 4;
        const int o = sat(HALF, row, c4);
        const bool oks = row < K && c4 < nv;
        const int64_t as = (int64_t)row * V + v0 + c4;
        cp_async16(Ss + o, oks ? S + as : S, oks);
        cp_async16(Gs + o, oks ? G + as : G, oks);
        if constexpr (f32) {
          const bool okv = row < n && c4 < nv;
          const int64_t av = baseV + row * rowV + v0 + c4;
          cp_async16(Do + o, okv ? (const float*)dO + av : (const float*)dO,
                     okv);
          cp_async16(Vs + o, okv ? (const float*)v + av : (const float*)v,
                     okv);
        }
      }
    }
    if constexpr (!VEC || !f32) {
#pragma unroll 2
      for (int it = 0; it < HT / THREADS; ++it) {
        const int e = tid + it * THREADS, row = e / HALF, col = e % HALF;
        const int o = sat(HALF, row, col);
        const bool okv = row < n && col < nv;
        const int64_t av = baseV + row * rowV + v0 + col;
        Do[o] = okv ? to_f32(dO[av]) : 0.0f;
        Vs[o] = okv ? to_f32(v[av]) : 0.0f;
        if constexpr (!VEC) {
          const bool oks = row < K && col < nv;
          const int64_t as = (int64_t)row * V + v0 + col;
          Ss[o] = oks ? S[as] : 0.0f;
          Gs[o] = oks ? G[as] : 0.0f;
        }
      }
    }
  };
  // the tile's r, k and log_w, read once: by cp.async into the tiles where
  // they are float32 with 16-byte rows (a first group, then the first
  // slice's as a second, in flight while q, kap and A are computed), else
  // element by element below
  constexpr bool VEC_RK = VEC && sizeof(T) == 4;
  if constexpr (VEC_RK) {
#pragma unroll 2
    for (int it = 0; it < GT / 4 / THREADS; ++it) {
      const int ci = tid + it * THREADS, row = ci / 16, c4 = (ci % 16) * 4;
      const int o = sat(TILE, row, c4);
      const bool ok = row < n && c4 < K;
      const int64_t at = ok ? baseK + row * rowK + c4 : 0;
      cp_async16(Lw + o, lw + at, ok);
      cp_async16(Qs + o, (const float*)r + at, ok);
      cp_async16(Ks + o, (const float*)k + at, ok);
    }
    cp_async_commit();
  }
  load_slice(0);
  if constexpr (VEC_RK) {
    cp_async_commit();
    cp_async_wait<1>();  // r, k and log_w have landed
    __syncthreads();
  }

  // the clamp and its mask, the bonus r . (u * k) by row
  if (tid < MAXK) us[tid] = u != nullptr && tid < K ? u[h * K + tid] : 0.0f;
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int o = sat(TILE, row, col);
    float raw, rr, kr;
    if constexpr (VEC_RK) {  // zeros where !ok
      raw = Lw[o];
      rr = Qs[o];
      kr = Ks[o];
    } else {
      const int64_t at = baseK + row * rowK + col;
      raw = ok ? lw[at] : 0.0f;
      rr = ok ? to_f32(r[at]) : 0.0f;
      kr = ok ? to_f32(k[at]) : 0.0f;
    }
    const float lx = ok ? clamp_lw(raw, lo) : 0.0f;
    Lw[o] = Am[o] = lx;
    Qs[o] = rr;
    Ks[o] = kr;
    // a warp holds 32 columns of one row
    const uint32_t kept = __ballot_sync(0xffffffffu,
                                        ok && raw >= lo && raw <= 0.0f);
    if (lane == 0) mask[row * 2 + col / 32] = kept;
    if (u != nullptr) {
      float sb = ok ? rr * u[h * K + col] * kr : 0.0f;
#pragma unroll
      for (int sh = 16; sh > 0; sh /= 2)
        sb += __shfl_xor_sync(0xffffffffu, sb, sh);
      if (lane == 0) dpart[row * 2 + col / 32] = sb;
    }
  }
  scan_tile<true>(Am, n, K, part);  // P, the forward's bits
  // q and kap in place (a thread rewrites only the elements it wrote)
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int o = sat(TILE, row, col);
    const float P = Am[o];
    Qs[o] = ok ? Qs[o] * expf(post ? P : P - Lw[o]) : 0.0f;
    Ks[o] = ok ? Ks[o] * expf(-P) : 0.0f;
  }
  if (tid < MAXK)
    dl[tid] = tid < K ? expf(Am[sat(TILE, n - 1, tid)]) : 0.0f;
  __syncthreads();  // P is read: Am takes A
  {  // A = q kap^T, masked, with the bonus on the diagonal
    float a[2][2][4] = {};
    if (lower)
      mma_block<2, 2, false, false, false>(a, Qs, TILE, Ks, TILE, m0, n0, 0,
                                           K8, nullptr);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = acc_row(m0, mt, e), j = acc_col(n0, nt, e);
          float y = (post ? j <= i : j < i) ? a[mt][nt][e] : 0.0f;
          if (u != nullptr && j == i) y += dpart[i * 2] + dpart[i * 2 + 1];
          Am[sat(TILE, i, j)] = y;
        }
  }

  // over V in slices of 32: dA = dO v^T, dq = dO S^T, dkt = v G^T and
  // dd = sum G S summed; dv = A^T dO + kt G stored, kt = kap d
  float dA[2][2][4] = {}, dq[2][2][4] = {}, dks[2][2][4] = {};
  float dd = 0.0f;  // row kk = tid / 4 of S and G, columns 8 (tid % 4) + 0..7
  for (int v0 = 0; v0 < V; v0 += HALF) {
    const int nv = min(HALF, V - v0);
    if (v0 > 0) {
      __syncthreads();  // the last slice is read
      load_slice(v0);
    }
    cp_async_wait_all();
    __syncthreads();
    {
      const int kk = tid / 4, c0 = (tid % 4) * 8;
#pragma unroll
      for (int col = c0; col < c0 + 8; ++col)
        dd = fmaf(Gs[sat(HALF, kk, col)], Ss[sat(HALF, kk, col)], dd);
    }
    if (lower)
      mma_block<2, 2, false, false, false>(dA, Do, HALF, Vs, HALF, m0, n0, 0,
                                           HALF, nullptr);
    mma_block<2, 2, false, false, false>(dq, Do, HALF, Ss, HALF, m0, n0, 0,
                                         HALF, nullptr);
    mma_block<2, 2, false, false, false>(dks, Vs, HALF, Gs, HALF, m0, n0, 0,
                                         HALF, nullptr);
    // dv, the warp's 16 x 16 block (j, col): A^T dO over i >= j, then
    // kap (d G) with d on the A side
    const int j0 = 16 * (warp % 4), c0 = 16 * (warp / 4);
    float acc[1][2][4] = {};
    mma_block<1, 2, true, true, false>(acc, Am, TILE, Do, HALF, j0, c0, j0,
                                       n8, nullptr);
    mma_block<1, 2, false, true, true>(acc, Ks, TILE, Gs, HALF, j0, c0, 0, K8,
                                       dl);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int j = acc_row(j0, 0, e), col = acc_col(c0, nt, e);
        if (j < n && col < nv)
          store2(dv + baseV + j * rowV + v0 + col, acc[0][nt][e],
                 acc[0][nt][e + 1], col + 1 < nv, V % 2 == 0);
      }
  }
  __syncthreads();  // the slices and A are read
  // dA*M into Am and its diagonal into dbeta; dkt d (the gradient of kap
  // through kt = kap d) in place, and the column sums of Z = dkt kt
  {
    float z[2][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = acc_row(m0, mt, e), j = acc_col(n0, nt, e);
          const float x = dA[mt][nt][e];
          Am[sat(TILE, i, j)] = (post ? j <= i : j < i) ? x : 0.0f;
          if (i == j) dbeta[i] = x;
          dks[mt][nt][e] *= dl[j];  // here j is kk, i the row
          z[nt][e % 2] += dks[mt][nt][e] * Ks[sat(TILE, i, j)];
        }
    col_sums(z, n0, colp + (warp % 2) * MAXK);
  }
  dd += __shfl_xor_sync(0xffffffffu, dd, 1);
  dd += __shfl_xor_sync(0xffffffffu, dd, 2);
  if (tid % 4 == 0) ddl[tid / 4] = dd * dl[tid / 4];
  __syncthreads();  // Am holds dA*M
  // dq += (dA*M) kap over j <= i, dkap = (dA*M)^T q over i >= j, into dks
  mma_block<2, 2, false, true, false>(dq, Am, TILE, Ks, TILE, m0, n0, 0,
                                      min(n8, m0 + 32), nullptr);
  mma_block<2, 2, true, true, false>(dks, Am, TILE, Qs, TILE, m0, n0, m0, n8,
                                     nullptr);
  __syncthreads();  // Am is read: P again, by the same scan of log_w
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int o = sat(TILE, el_row(it), el_col(it));
    Am[o] = Lw[o];
  }
  scan_tile<true>(Am, n, K, part);
  // element by element, (row, kk) of the warp's block: dr and dk stored;
  // F = dq*q - (dkap + dkt) kap and E = (pre-update) dq*q into tiles;
  // U = dbeta r k summed by column
  float* F = Do;  // over the slice tiles of dO and v
  float* E = Ss;  // over those of S and G
  float uc[2][2] = {}, gr[2], gk[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e = 2 * (row half) + (column in pair)
        const int row = acc_row(m0, mt, e), kk = acc_col(n0, nt, e);
        const int o = sat(TILE, row, kk);
        if (e % 2 == 0) gr[0] = gr[1] = gk[0] = gk[1] = 0.0f;
        F[o] = E[o] = 0.0f;
        if (row >= n || kk >= K) continue;
        const float P = Am[o];
        const float ePq = expf(post ? P : P - Lw[o]), emP = expf(-P);
        const float q = Qs[o], kap = Ks[o];
        const float g_q = dq[mt][nt][e], g_k = dks[mt][nt][e];
        gr[e % 2] = g_q * ePq;
        gk[e % 2] = g_k * emP;
        if (u != nullptr) {  // r and k again from q and kap
          const float db = dbeta[row], uk = us[kk];
          const float rr = q / ePq, kr = kap / emP;
          gr[e % 2] += db * uk * kr;
          gk[e % 2] += db * uk * rr;
          uc[nt][e % 2] += db * rr * kr;
        }
        const float Dq = g_q * q;
        F[o] = Dq - g_k * kap;
        E[o] = post ? 0.0f : Dq;
        if (e % 2 == 1 || kk + 1 >= K) {  // the pair (kk - e % 2, +1) is done
          const int k0 = kk - e % 2;
          const int64_t at = baseK + row * rowK + k0;
          store2(dr + at, gr[0], gr[1], k0 + 1 < K, K % 2 == 0);
          store2(dk + at, gk[0], gk[1], k0 + 1 < K, K % 2 == 0);
        }
      }
  col_sums(uc, n0, colp + (2 + warp % 2) * MAXK);
  __syncthreads();
  if (tid < MAXK) {  // sum_j Z_j + dd d, by column
    ddl[tid] += colp[tid] + colp[MAXK + tid];
    if (tid < K)
      du_part[slot * K + tid] = colp[2 * MAXK + tid] + colp[3 * MAXK + tid];
  }
  __syncthreads();
  // dlog_w = sum_{j >= i} F_j + sum_j Z_j + dd d - (pre-update) dq*q,
  // zero where the clamp binds
  rev_scan_store(F, E, ddl, mask, n, K, part, dlw + baseK, rowK);
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

// The gradient pass's shared memory, and the carveout that lets two of its
// blocks share an SM
template <typename T, bool VEC>
cudaError_t grad_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      lsb_grad<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(GRAD_WORDS * sizeof(float)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lsb_grad<T, VEC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, bool VEC>
cudaError_t launch_grad(const Args& a, const float* Sb) {
  cudaError_t err = grad_attributes<T, VEC>();
  if (err != cudaSuccess) return err;
  const int nt = a.T_len / a.c * cdiv(a.c, TILE);
  lsb_grad<T, VEC><<<dim3(nt, a.H, a.B), THREADS, GRAD_WORDS * sizeof(float),
                     a.stream>>>(
      (const T*)a.r, (const T*)a.k, (const T*)a.v, a.lw, a.u, (const T*)a.dO,
      Sb, a.scratch, (T*)a.dr, (T*)a.dk, (T*)a.dv, a.dlw, a.du_part, a.T_len,
      a.H, a.K, a.V, a.c, a.post, a.lo);
  return cudaGetLastError();
}

// Whether the gradient pass may load its V slices of dO, v, S and G, and
// its r, k and log_w, by 16-byte cp.async: rows of V and of K floats from
// 16-byte aligned bases
bool vec_rows(const Args& a) {
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  return a.V % 4 == 0 && a.K % 4 == 0 && al(a.v) && al(a.dO) &&
         al(a.states) && al(a.scratch) && al(a.r) && al(a.k) && al(a.lw);
}

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
    return (int)(vec_rows(a) ? launch_grad<T, true>(a, Sb)
                             : launch_grad<T, false>(a, Sb));
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

// The gradient pass's dynamic shared memory in bytes and the blocks of it
// an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, which
// counts its registers too), for the instance that loads by cp.async (the
// main path's); returns a cudaError_t.
extern "C" int linear_scan_bwd_grad_occupancy(int is_bf16, int* smem_bytes,
                                              int* blocks) {
  *smem_bytes = (int)(GRAD_WORDS * sizeof(float));
  cudaError_t err = is_bf16 ? grad_attributes<__nv_bfloat16, true>()
                            : grad_attributes<float, true>();
  if (err != cudaSuccess) return (int)err;
  return is_bf16 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks, lsb_grad<__nv_bfloat16, true>, THREADS,
                       *smem_bytes)
                 : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks, lsb_grad<float, true>, THREADS, *smem_bytes);
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
