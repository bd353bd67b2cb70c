// linear_scan: the chunked linear-attention recurrence of RWKV-6 and
// Mamba-2 (SSD), as hand-written CUDA kernels for Hopper (sm_90a).
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
// Semantics held from the Pallas kernel:
//   * log_w is clamped to [lo, 0] with lo = float32(-60 / c) for the
//     caller's chunk c, T % c == 0; any 1 <= c <= 256, 1 <= K <= 64,
//     V >= 1;
//   * the chunked form: within a span of rows, P is the inclusive
//     cumulative sum of the clamped log_w, Pq = P (post) or P - log_w
//     (pre), q_eff = r exp(Pq), k_eff = k exp(-P), and
//     o = q_eff S + A v with A_ij = q_eff_i . k_eff_j kept for j < i (pre)
//     or j <= i (post), plus r_i . (u * k_i) on the diagonal when u is
//     given; S' = S exp(P_last) + sum_i (k_i exp(P_last - P_i)) v_i^T;
//   * every product is a float32 multiply-add on the CUDA cores (no TF32,
//     no tensor cores), expf without fast math; bfloat16 inputs are widened
//     to float32 and o is stored with __float2bfloat16 (round to nearest
//     even, as astype does).  Sums run in another order than the oracle's
//     einsums, so results agree within float32 rounding, not bit for bit.
//
// Design: the Pallas grid (B, H, T/c) carried S in VMEM scratch along its
// sequential chunk axis.  Here the span is a tile: each chunk is cut into
// tiles of up to 64 rows (ceil(c/64) a chunk, none across two chunks), so
// a tile's |P| <= 60 as a chunk's is, and the chunked form above holds
// tile by tile: it is the same recurrence, whatever the span.  Only the
// hand-off of S from tile to tile is sequential, in three launches on the
// caller's stream:
//
//   1. state pass, one block per (b, h, tile, 64-column slice of V): the
//      tile's own state dS_t = exp(P_last) sum_i (k_i exp(-P_i)) v_i^T and
//      decay d_t = exp(P_last), into a float32 scratch (B, H, nt, K, V)
//      and (B, H, nt, K), nt = T/c ceil(c/64);
//   2. hand-off, one thread per (b, h, entry of S): S_t = d_t S_{t-1} +
//      dS_t from state0 over the nt tiles in order, overwriting dS_t with
//      S_{t-1}, the state before tile t; S_nt is the final state.  A small
//      kernel of its own rather than a ticketed tail of pass 1: no counter
//      to reset between calls, no fence, the same order of sums on every
//      run;
//   3. output pass, one block per (b, h, tile, 64-column slice of V): the
//      tile's P again, o = q_eff S_{t-1} + (A masked, with the bonus) v.
//      At V <= 64 a block holds all V columns, so A is computed once.
//
// Handing S off per tile rather than per chunk leaves the output pass one
// key tile, the diagonal one, where a per-chunk hand-off needs every key
// tile at or below it: at c = 256 that is 4 tile products a query tile
// instead of 2.5 on average, and 2.2 GFLOP of products in the output pass
// instead of 6.4 at rwkv6-1.6b's shape.  The state's extra hand-offs cost
// one more read and write of (B, H, nt, K, V), 33.5 MB there.
//
// At rwkv6-1.6b's shape (B=2, T=2048, H=32, K=V=64, c=256) each pass has
// 2048 blocks, against 128 blocks for the whole scan in a design that
// walks the chunks in one block.  Each product is a register tile of 4 x 4
// outputs a thread over operands in shared memory, held row by row (rows
// 68 floats apart): one 16-byte load feeds four FMAs; a quarter warp's
// loads read one address, eight rows 68 floats apart or 128 contiguous
// bytes, so no bank is hit twice.  A tile's global loads are all issued
// before any is used.  In the diagonal product a warp stops at the key of
// its last row.
//
// What bounds it: the function reads r, k, log_w, v once and writes o once
// (169.9 MB at rwkv6-1.6b's shape, 0.0507 ms at 3.35 TB/s), above the
// 2.7 GFLOP of the recurrence token by token (0.041 ms at 67 TFLOP/s
// float32): bytes.  This design moves more: log_w, k and v in both passes
// and the states twice more, ~400 MB, and each block loads its tile, then
// computes, then stores, so too few bytes are in flight to keep memory
// busy; overlapping one tile's loads with another's products is the next
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;      // rows of a tile; columns of a V slice
constexpr int MAXK = 64;      // widest key the tiles hold
constexpr int LD = TILE + 4;  // row stride of every shared tile, floats
constexpr int TILE_WORDS = TILE * LD;
static_assert(THREADS == 4 * MAXK, "the scan runs 4 segments x 64 columns");
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
// column.  A warp covers 32 consecutive columns of one row, so global
// loads are coalesced and shared stores row by row hit 32 banks.
__device__ __forceinline__ int el_row(int it) {
  return (threadIdx.x + it * THREADS) / TILE;
}
__device__ __forceinline__ int el_col(int it) {
  return (threadIdx.x + it * THREADS) % TILE;
}

// acc[m][n] += sum_{e < E} X[4 ty + m][e] * Y[tx + 16 n][e] (rows of X and
// Y against each other), X and Y shared tiles held row by row, rows LD
// floats apart, E a multiple of 4.  A quarter warp's X loads read one
// address; its Y loads, eight rows 68 floats apart, hit distinct banks.
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
// and Y against each other: outer products), X and Y held row by row.  A
// quarter warp's X loads read one address, its Y loads 128 contiguous
// bytes.
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

// In place, down each column kk < K of the first n rows of Pt (the clamped
// log_w of the tile's rows, n <= 64): P, the inclusive cumulative sum from
// the tile's first row.  Four segments of 16 rows are scanned by one
// thread each, then offset by the totals of the segments before.  part
// holds 4 x 64 floats.  Begins and ends with a barrier.
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

// Where tile `blockIdx.x / nvs` of (b, h) lies: tiles of 64 rows split each
// chunk of c rows (the last one of a chunk n = c mod 64 rows when 64 does
// not divide c), so that no tile spans two chunks and |P| <= 60 in it.
struct Tile {
  int vs, v0, nv;    // the 64-column slice of V
  int64_t gt, row0;  // tile index in (b, h), its first row in T
  int n;             // its rows
};

__device__ __forceinline__ Tile tile_of(int c, int V) {
  const int nvs = cdiv(V, TILE), nq = cdiv(c, TILE);
  Tile tl;
  tl.vs = blockIdx.x % nvs;
  tl.gt = blockIdx.x / nvs;
  const int ch = (int)(tl.gt / nq), t = (int)(tl.gt % nq);
  tl.v0 = tl.vs * TILE;
  tl.nv = min(TILE, V - tl.v0);
  tl.row0 = (int64_t)ch * c + t * TILE;
  tl.n = min(TILE, c - t * TILE);
  return tl;
}

// ---------------------------------------------------------------------
// 1. state pass: grid (nt * nvs, H, B), nt = T/c * ceil(c / 64) tiles
// ---------------------------------------------------------------------

// float32 words: Kn, Vn, Pt tiles, part [4 x 64], exp(P_last) [64]
constexpr size_t STATE_WORDS = 3 * TILE_WORDS + 4 * MAXK + MAXK;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    linear_scan_state(const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ lw, float* __restrict__ dS,
                      float* __restrict__ dec, int T_len, int H, int K,
                      int V, int c, float lo) {
  extern __shared__ __align__(16) float smem[];
  float* Kn = smem;              // [row][kk]: k, then k exp(-P)
  float* Vn = Kn + TILE_WORDS;   // [row][col]
  float* Pt = Vn + TILE_WORDS;   // [row][kk]: clamped log_w, then P
  float* part = Pt + TILE_WORDS;
  float* dl = part + 4 * MAXK;   // exp(P_last)

  const Tile tl = tile_of(c, V);
  const int h = blockIdx.y, b = blockIdx.z, n = tl.n;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t rowK = (int64_t)H * K, rowV = (int64_t)H * V;
  const int64_t baseK = ((int64_t)b * T_len + tl.row0) * rowK + (int64_t)h * K;
  const int64_t baseV =
      ((int64_t)b * T_len + tl.row0) * rowV + (int64_t)h * V + tl.v0;

  // the tile into shared memory, every load issued before any is used
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int64_t at = baseK + row * rowK + col;
    Pt[row * LD + col] = ok ? clamp_lw(lw[at], lo) : 0.0f;
    Kn[row * LD + col] = ok ? to_f32(k[at]) : 0.0f;
    Vn[row * LD + col] = row < n && col < tl.nv
                             ? to_f32(v[baseV + row * rowV + col])
                             : 0.0f;
  }
  scan_tile(Pt, n, K, part);
  // k exp(-P); a thread rewrites only the elements it wrote
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    Kn[row * LD + col] *= row < n && col < K ? expf(-Pt[row * LD + col])
                                             : 0.0f;
  }
  if (tid < MAXK) dl[tid] = tid < K ? expf(Pt[(n - 1) * LD + tid]) : 0.0f;
  __syncthreads();
  const int64_t slot = ((int64_t)b * H + h) * (T_len / c * cdiv(c, TILE)) +
                       tl.gt;
  if (tl.vs == 0 && tid < K) dec[slot * K + tid] = dl[tid];
  // the tile's own state exp(P_last) sum_i (k_i exp(-P_i)) v_i^T
  float acc[4][4] = {};
  mma_cols(Kn, Vn, TILE, ty, tx, acc);
  float* out = dS + slot * K * V + tl.v0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int kk = 4 * ty + m;
    if (kk >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      if (col < tl.nv) out[(int64_t)kk * V + col] = acc[m][q] * dl[kk];
    }
  }
}

// ---------------------------------------------------------------------
// 2. hand-off: grid (ceil(K V / 256), H, B)
// ---------------------------------------------------------------------

// S_t = d_t S_{t-1} + dS_t over the nt tiles of (b, h) in order, from
// state0; S_{t-1}, the state before tile t, overwrites dS_t; S_nt is the
// final state.  Eight tiles' loads are in flight at a time.
__global__ void __launch_bounds__(THREADS)
    linear_scan_handoff(const float* __restrict__ s0,
                        float* __restrict__ dS,
                        const float* __restrict__ dec,
                        float* __restrict__ sT, int H, int K, int V, int nt) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= K * V) return;
  const int kk = idx / V;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int64_t KV = (int64_t)K * V;
  float* p = dS + bh * nt * KV + idx;
  const float* d = dec + bh * nt * K + kk;
  float S = s0[bh * KV + idx];
  for (int t0 = 0; t0 < nt; t0 += 8) {
    float x[8], w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = t0 + i < nt ? p[(t0 + i) * KV] : 0.0f;
      w[i] = t0 + i < nt ? d[(int64_t)(t0 + i) * K] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 + i < nt) {
        p[(t0 + i) * KV] = S;
        S = w[i] * S + x[i];
      }
    }
  }
  sT[bh * KV + idx] = S;
}

// ---------------------------------------------------------------------
// 3. output pass: grid (nt * nvs, H, B)
// ---------------------------------------------------------------------

// float32 words: Pt (S_{t-1} after the scan), Qe, Kn, Vn, AT tiles,
// part [4 x 64], bonus partials [64 x 2], the bonus [64]
constexpr size_t OUT_WORDS = 5 * TILE_WORDS + 4 * MAXK + 2 * TILE + TILE;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    linear_scan_output(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ lw,
                       const float* __restrict__ u,
                       const float* __restrict__ Sb, T* __restrict__ o,
                       int T_len, int H, int K, int V, int c, int post,
                       float lo) {
  extern __shared__ __align__(16) float smem[];
  float* Pt = smem;              // [row][kk]: clamped log_w, P; then S
  float* Qe = Pt + TILE_WORDS;   // [row][kk]: r, then r exp(Pq)
  float* Kn = Qe + TILE_WORDS;   // [row][kk]: k, then k exp(-P)
  float* Vn = Kn + TILE_WORDS;   // [row][col]
  float* AT = Vn + TILE_WORDS;   // [kk][row]: q_eff; then A^T [j][i]
  float* part = AT + TILE_WORDS;
  float* dpart = part + 4 * MAXK;
  float* diag = dpart + 2 * TILE;  // r . (u * k) of the tile's rows

  const Tile tl = tile_of(c, V);
  const int h = blockIdx.y, b = blockIdx.z, n = tl.n;
  const int KP = (K + 3) & ~3;  // K rounded up to a float4: zeros past K
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t rowK = (int64_t)H * K, rowV = (int64_t)H * V;
  const int64_t baseK = ((int64_t)b * T_len + tl.row0) * rowK + (int64_t)h * K;
  const int64_t baseV =
      ((int64_t)b * T_len + tl.row0) * rowV + (int64_t)h * V + tl.v0;
  const int64_t slot = ((int64_t)b * H + h) * (T_len / c * cdiv(c, TILE)) +
                       tl.gt;
  const float* S = Sb + slot * K * V + tl.v0;  // S_{t-1}

  // the tile and S_{t-1}, every load issued before any is used; a thread
  // reads back only what it wrote until the scan's first barrier
  float lx[16], sx[16];
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const int64_t at = baseK + row * rowK + col;
    lx[it] = ok ? clamp_lw(lw[at], lo) : 0.0f;
    Pt[row * LD + col] = lx[it];
    Qe[row * LD + col] = ok ? to_f32(r[at]) : 0.0f;
    Kn[row * LD + col] = ok ? to_f32(k[at]) : 0.0f;
    Vn[row * LD + col] = row < n && col < tl.nv
                             ? to_f32(v[baseV + row * rowV + col])
                             : 0.0f;
    // here row is kk and col a column of V
    sx[it] = row < K && col < tl.nv ? S[(int64_t)row * V + col] : 0.0f;
  }
  scan_tile(Pt, n, K, part);
  // q_eff, k_eff and the bonus
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = el_row(it), col = el_col(it);
    const bool ok = row < n && col < K;
    const float P = Pt[row * LD + col];
    const float rr = Qe[row * LD + col], kraw = Kn[row * LD + col];
    const float q = ok ? rr * expf(post ? P : P - lx[it]) : 0.0f;
    Qe[row * LD + col] = q;
    AT[col * LD + row] = q;
    Kn[row * LD + col] = ok ? kraw * expf(-P) : 0.0f;
    if (u != nullptr) {  // r . (u * k), row by row
      float sb = ok ? rr * u[h * K + col] * kraw : 0.0f;
#pragma unroll
      for (int sh = 16; sh > 0; sh /= 2)
        sb += __shfl_xor_sync(0xffffffffu, sb, sh);
      if (tid % 32 == 0) dpart[row * 2 + col / 32] = sb;
    }
  }
  __syncthreads();  // P is read: Pt takes S_{t-1}
#pragma unroll
  for (int it = 0; it < 16; ++it) Pt[el_row(it) * LD + el_col(it)] = sx[it];
  if (tid < TILE)
    diag[tid] = u != nullptr ? dpart[tid * 2] + dpart[tid * 2 + 1] : 0.0f;
  __syncthreads();

  float acc[4][4] = {};
  mma_cols(AT, Pt, KP, ty, tx, acc);  // inter: q_eff S_{t-1}
  float a[4][4] = {};
  mma_rows(Qe, Kn, KP, ty, tx, a);    // A = q_eff k_eff^T
  __syncthreads();                    // AT is read: it takes A^T
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int gj = tx + 16 * q;
    float y[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gi = 4 * ty + m;
      y[m] = (post ? gj <= gi : gj < gi) ? a[m][q] : 0.0f;  // causal mask
      if (gj == gi) y[m] += diag[gi];
    }
    *reinterpret_cast<float4*>(AT + gj * LD + 4 * ty) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
  __syncthreads();
  // intra: A v over the keys at or below this warp's last row 8w + 7
  mma_cols(AT, Vn, 8 * (tid / 32) + 8, ty, tx, acc);

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = 4 * ty + m;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      if (col < tl.nv)
        o[baseV + (int64_t)row * rowV + col] = from_f32<T>(acc[m][q]);
    }
  }
}

struct Args {
  const void *r, *k, *v;
  const float *lw, *u, *s0;
  void* o;
  float *sT, *scratch;
  int B, T_len, H, K, V, c, post;
  float lo;
  cudaStream_t stream;
};

template <typename T>
int launch_pass(int which, const Args& a) {
  const int nvs = cdiv(a.V, TILE);
  const int nt = a.T_len / a.c * cdiv(a.c, TILE);  // tiles of (b, h)
  // scratch: each tile's own state, then the state before it (B, H, nt,
  // K, V), and its decay (B, H, nt, K)
  float* dS = a.scratch;
  float* dec = dS + (size_t)a.B * a.H * nt * a.K * a.V;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    auto kern = linear_scan_state<T>;
    const size_t smem = STATE_WORDS * sizeof(float);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nt * nvs, a.H, a.B), THREADS, smem, a.stream>>>(
        (const T*)a.k, (const T*)a.v, a.lw, dS, dec, a.T_len, a.H, a.K, a.V,
        a.c, a.lo);
  } else if (which == 1) {
    linear_scan_handoff<<<dim3(cdiv(a.K * a.V, THREADS), a.H, a.B),
                          THREADS, 0, a.stream>>>(a.s0, dS, dec, a.sT, a.H,
                                                  a.K, a.V, nt);
  } else if (which == 2) {
    auto kern = linear_scan_output<T>;
    const size_t smem = OUT_WORDS * sizeof(float);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nt * nvs, a.H, a.B), THREADS, smem, a.stream>>>(
        (const T*)a.r, (const T*)a.k, (const T*)a.v, a.lw, a.u, dS,
        (T*)a.o, a.T_len, a.H, a.K, a.V, a.c, a.post, a.lo);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Run pass `which` (0 state, 1 hand-off, 2 output) on `stream`; returns
// cudaGetLastError() (0 on success), or -1 for a shape this file was not
// written for.  The caller has checked dtypes, shapes and contiguity,
// 1 <= K <= 64, V >= 1, 1 <= c <= 256 and T % c == 0; u is null when there
// is no bonus (use_u = 0); scratch holds B H nt K (V + 1) floats, nt =
// T/c ceil(c/64) tiles.
extern "C" int linear_scan_pass(int which, const void* r, const void* k,
                                const void* v, const void* lw, const void* u,
                                const void* s0, void* o, void* sT,
                                void* scratch, int B, int T_len, int H, int K,
                                int V, int c, int is_bf16, int post,
                                int use_u, float lo, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (K < 1 || K > MAXK || V < 1 || c < 1 || c > 4 * TILE || T_len % c)
    return -1;
  const Args a{r,        k,      v,     (const float*)lw,
               use_u ? (const float*)u : nullptr,
               (const float*)s0,   o,     (float*)sT,
               (float*)scratch,    B,     T_len,
               H,        K,      V,     c,
               post,     lo,     (cudaStream_t)stream};
  return is_bf16 ? launch_pass<__nv_bfloat16>(which, a)
                 : launch_pass<float>(which, a);
}

// The whole scan: the three passes back to back on `stream`.
extern "C" int linear_scan_launch(const void* r, const void* k,
                                  const void* v, const void* lw,
                                  const void* u, const void* s0, void* o,
                                  void* sT, void* scratch, int B, int T_len,
                                  int H, int K, int V, int c, int is_bf16,
                                  int post, int use_u, float lo,
                                  void* stream) {
  for (int which = 0; which < 3; ++which) {
    const int rc = linear_scan_pass(which, r, k, v, lw, u, s0, o, sT,
                                    scratch, B, T_len, H, K, V, c, is_bf16,
                                    post, use_u, lo, stream);
    if (rc != 0) return rc;
  }
  return 0;
}
