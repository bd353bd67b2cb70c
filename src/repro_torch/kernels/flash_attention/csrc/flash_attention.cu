// flash_attention: causal or bidirectional GQA attention with an online
// softmax, as hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:78
// (flash_attention, the Pallas TPU kernel whose body is _flash_kernel
// :30-72 and whose pallas_call is at :94).  q is (B, Sq, Hq, D), k and v
// are (B, Sk, Hkv, D), all float32 or all bfloat16, contiguous; the output
// has q's shape and dtype.  Query head h reads KV head h / (Hq / Hkv); no
// repeated K/V is materialised.
//
// Semantics held from the Pallas kernel by both kernels below:
//   * scores are (q.k) * scale with scale = D ** -0.5, in float32;
//   * the causal mask keeps k_pos <= q_pos (top-left aligned) and writes
//     NEG_INF = -1e30 elsewhere, before the row max;
//   * the running max m, sum l and accumulator acc are float32 and follow
//     m' = max(m, rowmax(s)), alpha = exp(m - m'), p = exp(s - m'),
//     l' = alpha l + rowsum(p), acc' = alpha acc + p.v;
//   * the result is acc / max(l, 1e-30), stored in q's dtype
//     (__float2bfloat16 rounds to nearest even, as astype does).
// Where the caller passes an lse buffer (float32, (B, Hq, Sq); the
// backward's input, flash_attention_bwd.cu), both kernels also write each
// row's natural-log log-sum-exp of the scaled, masked scores, m + log(l),
// once per row; with a null pointer nothing more is written.
// A K/V tile lying wholly above the diagonal is skipped: every score in it
// is masked, so it adds exp(-1e30 - m) = 0 to l and acc once m is finite,
// and m is finite after the first tile (k_pos = 0 <= q_pos for every row).
// Causal blocks are launched heaviest first.
//
// What bounds it: for causal attention at Sq = Sk = S the work is about
// 2 * B * Hq * S * S * D floating-point operations against
// 2 * B * S * (Hq + Hkv) * D elements read and written, far above the
// H100's operations-per-byte balance (~295 in bf16), so attention is bound
// by operations: the card's bound is that work over its bf16 tensor-core
// rate (989 TFLOP/s dense).
//
// 1. bfloat16 at D = 64, 96, 112 or 128 (every full-width attention model
//    of the repo; 96 is phi-3-vision-4.2b's 3072 / 32, 112 zamba2-7b's
//    shared block's 3584 / 32): flash_wgmma_kernel, on the tensor cores.
//    * One block of two consumer warpgroups (256 threads) owns (head,
//      batch, a 128-row q tile); each warpgroup owns 64 query rows, the M
//      of one wgmma.  K/V tiles are BK = 64 or 128 keys; the wrapper's
//      default is the faster on the H100: 128 at D = 64 and 128, 64 at
//      D = 96 and 112 (flash_wgmma_occupancy gives the blocks an SM each
//      holds).
//    * Loads are TMA (cp.async.bulk.tensor over 4-D (D, H, S, B) maps of
//      q, k and v with their real strides) into 128-byte-swizzled shared
//      memory, completing on one mbarrier per stage.  With that swizzle a
//      box row is at most 64 bf16, so D = 96 and 128 land as two 64-column
//      boxes and the wgmma descriptors step across them.  At D = 96 and
//      112 the maps keep the real inner dimension (rows of 192 or 224
//      bytes), so the second box, at column 64, reaches past the tensor:
//      TMA fills its columns D-127 with zeros on a load (the mbarrier
//      still counts the whole box, fill included) and drops them on a
//      store; the shared tiles are laid out as at D = 128.  q is loaded
//      once; K/V sit in a two-stage ring: thread 0 issues tile j+1 while
//      both warpgroups compute tile j, and a __syncthreads at the end of
//      each tile marks its stage free before it is refilled.
//    * S = q.k^T: wgmma m64nBKk16 over D / 16 k16 steps (6 at D = 96, 7 at
//      112: the zero-filled columns are never read), bf16 x bf16 into
//      float32, A =
//      q and B = the K tile from shared memory, both K-major (no
//      transpose).
//      Products of two bf16 values are exact in float32, so S equals the
//      Pallas kernel's widen-then-float32-dot up to summation order.
//    * The online softmax runs in registers on the accumulator fragment
//      (each thread holds parts of two rows; row max by shuffles over the
//      four lanes of a quad, the row sum kept per thread and reduced once
//      at the end), in base 2 with log2(e) folded into the scale.  The
//      mask is applied only on tiles that cross the diagonal; a
//      warpgroup skips a tile that lies wholly above its rows.
//    * O += P.V: wgmma m64nDk16 with A = P from registers (the float32
//      fragment of a k16 slice of S, rounded to bf16 pairs, is the layout
//      of the register A operand) and B = the V tile, (keys x D) row-major,
//      which is MN-major for B: the transpose bit is set.  O is float32,
//      D / 2 registers a thread.  At D = 96 the product is m64n96k16: N
//      covers the first 64-column swizzle atom of V and half of the second
//      (the leading byte offset steps between atoms along N), so the
//      zero-filled columns 96-127 are not read, and o holds 48 registers
//      where N = 128 against those zeros would hold 64 and do a third more
//      P.V work for nothing.  At D = 112 it is m64n112k16, reading three
//      quarters of the second atom (six of the eight 16-byte chunks of each
//      swizzled row): o holds 56 registers.
//    * Precision: P is rounded to bf16 (relative error <= 2^-9 an
//      element) where the Pallas kernel keeps it float32; l is summed from
//      the float32 P before rounding.  The output error this adds is about
//      2^-9 of |o| at the row's scale, far inside the bf16 tolerance of
//      tests/test_kernels.py (atol = rtol = 2e-2).  Not fp16: wgmma takes A
//      and B of one type, and V in fp16 could overflow.
//    * Epilogue: o / max(l, 1e-30) is rounded to bf16, written into the
//      warpgroup's own (now free) q rows in the same swizzled layout,
//      fenced to the async proxy and stored by TMA (at D = 96, 12 of the
//      16 chunks of a row, at 112, 14; the store clips at column D).  m
//      and l are in base 2, so lse = (m + log2(l)) ln 2, after the quad
//      reduction of l; one lane of each quad stores it.
//    What bounds this design below the bound: one thread issues the loads
//    and the warpgroups themselves wait on them (no producer warp, no
//    setmaxnreg), and in a warpgroup the softmax waits for S and the next
//    S for P.V (no ping-pong between warpgroups); those are later work.
// 2. float32 (any D of 16, 32, 64, 96, 112, 128) and bfloat16 at D = 16,
//    32 (only the .reduced() configs): flash_kernel, float32 FMAs on the
//    CUDA cores.  D need not be a power of two, only a multiple of 16 (each
//    thread's D / 16 accumulator columns; at BQ = 128 the tiles take
//    132,352 bytes of shared memory at D = 96, 148,736 at 112).  In the
//    backward (flash_attention_bwd.cu) bf16 at D = 112 runs on its wgmma
//    kernel, float32 at 112 and D = 96 in both dtypes on its SIMT
//    flash_bwd; each takes its lse from whichever forward ran.  q, k and v
//    are widened to float32 in shared memory and both
//    products are float32 multiply-adds: no TF32, no bf16 tensor-core
//    product, so float32 meets the reference's 2e-6.  One block of 256
//    threads owns one (q tile, head, batch) and loops over the K/V tiles
//    (the Pallas grid's sequential K axis); each thread keeps a
//    (BQ/16) x (BK/16) score tile and a (BQ/16) x (D/16) accumulator in
//    registers; p goes through shared memory for the p.v product.  It
//    cannot beat the 67 TFLOP/s float32 rate.
// Which kernel runs is fixed by (dtype, D); there is no switch.
#include <cuda.h>  // CUtensorMap and the encoder's declaration; not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// 2. the SIMT kernel (float32; bf16 at D = 16, 32)
// ---------------------------------------------------------------------


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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int causal, float scale) {
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
  if (lse != nullptr && tx == 0) {
    float* lrow = lse + ((int64_t)b * Hq + h) * Sq + q0;
#pragma unroll
    for (int i = 0; i < RQ; ++i) lrow[ty + TY * i] = m[i] + logf(l[i]);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;  // null: not written
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
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse, a.Sq, a.Sk,
      a.Hq, a.Hkv, a.causal, a.scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------
// 1. the Hopper kernel (bf16 at D = 64, 96, 112, 128): TMA, mbarriers,
//    wgmma
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

// wait until the barrier's phase of this parity has completed (the loop
// is inside the asm, as CUTLASS's ClusterBarrier::wait writes it)
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

// shared -> global (map at coordinates c0..c3)
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma for a 128-byte-swizzled tile
// as TMA writes it: rows of 128 bytes (64 bf16), 8-row swizzle atoms of
// 1024 bytes (the stride byte offset).  `lbo` is the leading byte offset:
// unused for a K-major operand, the stride between 64-column atoms along
// N for an MN-major one.  Layout type 1 = SWIZZLE_128B (bits 62-63).
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

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16.  _ss: A and B from
// shared memory, both K-major; scale_d = 0 overwrites d.  _rs: A from
// registers (four bf16 pairs), B MN-major from shared memory (transpose
// bit set), d accumulated.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

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

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, 1, 1, 1, 1;\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, 1, 1, 1, 1;\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
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
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// max and sum over the four lanes of a quad (the lanes that share a row of
// the wgmma accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int WG_BQ = 128;      // query rows a block (two warpgroups)
constexpr int WG_THREADS = 256;
constexpr int BOX_ROW = 128;    // bytes of one 64-column row of a TMA box

template <int D, int BK>
struct WgTile {
  static constexpr int NDB = (D + 63) / 64;       // 64-column boxes a row
  static constexpr int DP = 64 * NDB;             // columns a row holds
  static constexpr int Q_WG = 64 * DP * 2;        // a warpgroup's q rows
  static constexpr int KV = BK * DP * 2;          // one K or V tile
  static constexpr int SMEM = 2 * Q_WG + 2 * 2 * KV + 1024;  // + alignment
};

template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int Sk, int Hq, int Hkv,
                       int causal, float scale_log2) {
  using C = WgTile<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // q, then one per K/V stage
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * WG_BQ;
  const int n_k = (causal ? min(Sk, q0 + WG_BQ) : Sk) / BK;
  uint8_t* q_wg = smem + wg * C::Q_WG;  // q rows, then o rows, of this wg
  uint8_t* kv = smem + 2 * C::Q_WG;     // stage s: K at s * 2KV, V after

  auto load_kv = [&](int j, int s) {
    uint8_t* ks = kv + s * 2 * C::KV;
    mbar_expect_tx(&bars[1 + s], 2 * C::KV);
#pragma unroll
    for (int db = 0; db < C::NDB; ++db) {
      tma_load(ks + db * BK * BOX_ROW, &tk, &bars[1 + s], 64 * db, hk,
               j * BK, b);
      tma_load(ks + C::KV + db * BK * BOX_ROW, &tv, &bars[1 + s], 64 * db,
               hk, j * BK, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * C::Q_WG);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int db = 0; db < C::NDB; ++db)
        tma_load(smem + w * C::Q_WG + db * 64 * BOX_ROW, &tq, &bars[0],
                 64 * db, h, q0 + 64 * w, b);
    if (n_k > 0) load_kv(0, 0);
  }

  // this thread's two rows of the accumulator fragment (within the wg)
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int qpos0 = q0 + 64 * wg + r0, qpos1 = q0 + 64 * wg + r1;
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(q_wg);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(&bars[0], 0);
  for (int j = 0; j < n_k; ++j) {
    const int s = j & 1, k0 = j * BK;
    if (tid == 0 && j + 1 < n_k) load_kv(j + 1, s ^ 1);
    __syncwarp();  // wgmma's .sync.aligned wants converged warps
    if (!causal || k0 <= wg_last) {
      mbar_wait(&bars[1 + s], (j >> 1) & 1);
      const uint32_t k_addr = smem_u32(kv + s * 2 * C::KV);
      const uint32_t v_addr = k_addr + C::KV;

      // S = q k^T over D / 16 steps of k16; box db = kk / 4 holds columns
      // 64 db .. 64 db + 63, and step kk % 4 is 32 bytes into its rows
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss<BK>(sc,
                     sw128_desc(q_addr + (kk / 4) * 64 * BOX_ROW + step, 16),
                     sw128_desc(k_addr + (kk / 4) * BK * BOX_ROW + step, 16),
                     kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(sc);

      // scale (base 2), mask on the diagonal, online softmax.  Element i
      // of the fragment: column 8 (i / 4) + col0 + i % 2, row r0 or r1 as
      // (i / 2) % 2 is 0 or 1.
      const bool diag = causal && k0 + BK - 1 > wg_first;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const bool hi = (i / 2) % 2;
        float x = sc[i] * scale_log2;
        if (diag && k0 + 8 * (i / 4) + col0 + i % 2 > (hi ? qpos1 : qpos0))
          x = NEG_INF;
        sc[i] = x;
        if (hi) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const bool hi = (i / 2) % 2;
        const float p = exp2f(sc[i] - (hi ? mx1 : mx0));
        sc[i] = p;
        if (hi) sum1 += p;
        else sum0 += p;
      }
      l0 = alpha0 * l0 + sum0;  // this thread's part of the row sum
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i / 2) % 2 ? alpha1 : alpha0;

      // O += P V over BK / 16 steps of k16: the fragment's elements
      // 8 kk .. 8 kk + 7 are the register A operand of step kk; the V
      // descriptor steps 16 keys (2048 bytes) down, its 64-column boxes
      // BK * 128 bytes apart
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    sw128_desc(v_addr + kk * 16 * BOX_ROW, BK * BOX_ROW));
      wg_commit();
      wg_wait_all();
      reg_fence(o);
    }
    __syncthreads();  // every wgmma reading stage s has completed
  }

  // epilogue: o / max(l, 1e-30) in bf16 into this wg's q rows (their last
  // reader, the final S wgmma, has completed), swizzled as TMA reads them
  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float den0 = fmaxf(sum0, 1e-30f), den1 = fmaxf(sum1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + ((int64_t)b * Hq + h) * (gridDim.z * WG_BQ);
    lrow[qpos0] = (m0 + log2f(sum0)) * 0.6931471805599453f;  // ln 2
    lrow[qpos1] = (m1 + log2f(sum1)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    uint8_t* box = q_wg + (jj / 8) * 64 * BOX_ROW + 4 * (lane % 4);
    const int chunk = jj % 8;  // 16-byte chunk of the 128-byte row
    *reinterpret_cast<uint32_t*>(box + r0 * BOX_ROW +
                                 ((chunk ^ (r0 % 8)) << 4)) =
        pack_bf16(o[4 * jj] / den0, o[4 * jj + 1] / den0);
    *reinterpret_cast<uint32_t*>(box + r1 * BOX_ROW +
                                 ((chunk ^ (r1 % 8)) << 4)) =
        pack_bf16(o[4 * jj + 2] / den1, o[4 * jj + 3] / den1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int db = 0; db < C::NDB; ++db)
      tma_store(&to, q_wg + db * 64 * BOX_ROW, 64 * db, h, q0 + 64 * wg, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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
// of 64 columns x `rows` rows of one head, 128-byte swizzle; at D = 96 and
// 112 the box at column 64 is partly outside the map: zeros on a load,
// clipped on a store
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

constexpr int ERR_NOT_COMPILED = -1;  // head dim / tile / dtype not built
constexpr int ERR_NO_ENCODER = -2;    // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 2000;  // + the CUresult of the encoder

template <int D, int BK>
int launch_wgmma(const Args& a) {
  using C = WgTile<D, BK>;
  if (a.Sk == 0)  // no keys: acc / max(0, 1e-30) = 0
    return (int)cudaMemsetAsync(a.o, 0, (size_t)a.B * a.Sq * a.Hq * D * 2,
                                a.stream);
  const EncodeFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv, to;
  CUresult r = make_map(enc, &tq, a.q, a.B, a.Sq, a.Hq, D, 64);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, a.k, a.B, a.Sk, a.Hkv, D, BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, a.v, a.B, a.Sk, a.Hkv, D, BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &to, a.o, a.B, a.Sq, a.Hq, D, 64);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + (int)r;
  auto kern = flash_wgmma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, a.B, a.Sq / WG_BQ);
  kern<<<grid, WG_THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, to, a.lse, a.Sk, a.Hq, a.Hkv, a.causal,
      a.scale * 1.4426950408889634f);  // exp(x) = exp2(x log2(e))
  return (int)cudaGetLastError();
}

template <int D, int BK>
int wgmma_occupancy(int* smem_bytes, int* blocks) {
  auto kern = flash_wgmma_kernel<D, BK>;
  *smem_bytes = WgTile<D, BK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, WG_THREADS, *smem_bytes);
}

int wgmma_by_tile(int blk_q, int blk_k, int D, const Args& a) {
  if (blk_q != WG_BQ) return ERR_NOT_COMPILED;
  if (D == 64 && blk_k == 64) return launch_wgmma<64, 64>(a);
  if (D == 64 && blk_k == 128) return launch_wgmma<64, 128>(a);
  if (D == 96 && blk_k == 64) return launch_wgmma<96, 64>(a);
  if (D == 96 && blk_k == 128) return launch_wgmma<96, 128>(a);
  if (D == 112 && blk_k == 64) return launch_wgmma<112, 64>(a);
  if (D == 112 && blk_k == 128) return launch_wgmma<112, 128>(a);
  if (D == 128 && blk_k == 64) return launch_wgmma<128, 64>(a);
  if (D == 128 && blk_k == 128) return launch_wgmma<128, 128>(a);
  return ERR_NOT_COMPILED;
}

template <typename T, int BQ, int BK>
int simt_by_head_dim(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16, BQ, BK>(a);
    case 32: return launch<T, 32, BQ, BK>(a);
  }
  if constexpr (sizeof(T) == 4) {  // float32 only: bf16 takes the wgmma
    switch (D) {
      case 64: return launch<T, 64, BQ, BK>(a);
      case 96: return launch<T, 96, BQ, BK>(a);
      case 112: return launch<T, 112, BQ, BK>(a);
      case 128: return launch<T, 128, BQ, BK>(a);
    }
  }
  return ERR_NOT_COMPILED;
}

template <typename T>
int simt_by_tile(int blk_q, int blk_k, int D, const Args& a) {
  if (blk_q == 64 && blk_k == 64) return simt_by_head_dim<T, 64, 64>(D, a);
  if (blk_q == 128 && blk_k == 64) return simt_by_head_dim<T, 128, 64>(D, a);
  return ERR_NOT_COMPILED;
}

}  // namespace

// (dynamic shared bytes, blocks an SM holds at once) of the wgmma kernel
// at (D, blk_k), as the CUDA runtime counts them on the current card
// (registers and shared memory).  Returns 0, a CUDA error, or -1 for an
// instance this file does not compile.
extern "C" int flash_wgmma_occupancy(int D, int blk_k, int* smem_bytes,
                                     int* blocks) {
  int* const s = smem_bytes;
  if (D == 64 && blk_k == 64) return wgmma_occupancy<64, 64>(s, blocks);
  if (D == 64 && blk_k == 128) return wgmma_occupancy<64, 128>(s, blocks);
  if (D == 96 && blk_k == 64) return wgmma_occupancy<96, 64>(s, blocks);
  if (D == 96 && blk_k == 128) return wgmma_occupancy<96, 128>(s, blocks);
  if (D == 112 && blk_k == 64) return wgmma_occupancy<112, 64>(s, blocks);
  if (D == 112 && blk_k == 128) return wgmma_occupancy<112, 128>(s, blocks);
  if (D == 128 && blk_k == 64) return wgmma_occupancy<128, 64>(s, blocks);
  if (D == 128 && blk_k == 128) return wgmma_occupancy<128, 128>(s, blocks);
  return ERR_NOT_COMPILED;
}

// Launch on `stream`; lse is null or a float32 (B, Hq, Sq) buffer for the
// rows' log-sum-exp.  Returns cudaGetLastError() (0 on success), -1 for a
// head dim, tile or dtype this file was not compiled for, -2 if libcuda.so.1
// has no cuTensorMapEncodeTiled, 2000 + its CUresult if a tensor map was
// refused.  bf16 at D = 64, 96, 112 or 128 takes the wgmma kernel (blk_q =
// 128, blk_k = 64 or 128), everything else the SIMT kernel (blk_q = 64 or 128,
// blk_k = 64).  The caller has checked shapes, contiguity, 16-byte
// alignment, Sq % blk_q == 0, Sk % blk_k == 0 and Hq % Hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int is_bf16, int causal, int blk_q,
                                      int blk_k, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Args a{q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, scale,
               (cudaStream_t)stream};
  if (!is_bf16) return simt_by_tile<float>(blk_q, blk_k, D, a);
  if (D == 64 || D == 96 || D == 112 || D == 128)
    return wgmma_by_tile(blk_q, blk_k, D, a);
  return simt_by_tile<__nv_bfloat16>(blk_q, blk_k, D, a);
}
