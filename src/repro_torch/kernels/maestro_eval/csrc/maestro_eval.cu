// maestro_eval: the MAESTRO hardware-DSE inner loop as a hand-written CUDA
// kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/maestro_eval/maestro_eval.py::maestro_eval, the
// Pallas TPU kernel whose body is closed_form_features.  For each design
// point (num_pes int32, noc_bw float32) it evaluates the faithful engine's
// single-level analysis in closed form over static tables (tables.py) and
// writes the features runtime, macs, throughput, util, bw_req as float32.
//
// What bounds it: each design reads 8 bytes and writes 20 (28 B), so its
// bound is N * 28 B over the card's memory bandwidth (3.35 TB/s on an H100
// SXM).  The first kernel (one design a thread, each storing a 20-byte row)
// missed it by its arithmetic, not by its stores: in
// scripts/ablate_maestro_eval.py its stores alone ran near the bound and
// its arithmetic alone took twice as long, some 500 instructions a design
// at the rate the SMs take them (eight IEEE float divisions and libdevice's
// fmodf in the four float floor-divisions, int32 `/` and `%` by divisors
// known only at run time), and the two did not overlap.  This kernel takes
// ~0.19 ms per 2^24 designs on an H100 SXM at 700 W, ~75% of the bound: its
// arithmetic and its stores each take about 0.165 ms alone, and overlap.
//
// Design:
//   * DPT consecutive designs a thread; a DSE grid holds many bw for each
//     PE count (run_dse's is pes-major, as is the paper-scale sweep), so
//     designs that share n share the half of the closed form that depends
//     on n alone (pes_terms: the folding, the volumes, step_eg, macs, util,
//     bw_req); each design computes the rest (eval_design: the three
//     transfers at its bw and the runtime);
//   * floordiv_f's remainder comes from one IEEE division and one fma,
//     exactly (exact_fmod, with the domain argument); fmodf only outside
//     that domain, a slow path of this kernel;
//   * floor division by the table's constants sp_o and sp_stride is a
//     multiply and a shift with constants the host computes (FloorDiv);
//     the per-design divisor n * sp_o keeps the hardware sequence, and is
//     skipped where its dividend is 0;
//   * inputs read word by word, so a slice such as p[1:] is taken as it
//     is (16-byte loads measured no faster); each warp's rows staged in
//     shared memory and stored as contiguous 16-byte words (out, from
//     torch.empty, is 16-byte aligned, and a warp's first design a multiple
//     of 4), a ragged tail word by word.  A lane storing its own 80 bytes
//     of rows straight from registers, 16 bytes at a time, half-writes a
//     32-byte sector with each instruction, and measured slower than all
//     of the computing.
// The table's scalars come in a POD struct passed by value and the case
// rows (occ, psums_full, psums_per_ext) as a small float32 device array plus
// a count, so one compiled kernel serves every table.
//
// Parity with the plain version (closed_form_features), which is exact
// float32 op-for-op, and bit-equal to it:
//   * integer // floors (Python/JAX/torch), C's / truncates: floordiv_i and
//     FloorDiv both floor;
//   * floor_divide on floats follows jnp.floor_divide's rule (remainder,
//     subtract, divide, sign correction, round half away from zero), as
//     the plain version's _floor_divide does (torch.floor_divide rounds a
//     half down): floordiv_f, with the exact remainder fmodf gives;
//   * int32 arithmetic wraps as it does in the reference: the w* helpers;
//   * build with --fmad=false so no multiply-add is contracted (the one
//     fmaf is written out: exact_fmod needs its single rounding);
//   * ceil(log2(max(n, 1))) in float32 as the plain version takes it (the
//     integer bit length of n - 1 is one more where float(n) rounds n down
//     to a power of two, and where log2f of 2^k + 1 rounds to k, from
//     n = 2^21 + 1 on).
#include <cuda_runtime.h>
#include <stdint.h>

// floor(a / d) for a constant d >= 1 as a multiply and a shift:
// shift = 31 + ceil(log2 d) and magic = ceil(2^shift / d), which is below
// 2^32 (maestro_eval.py::_floor_div computes both).
struct FloorDiv {
  int32_t d;
  uint32_t magic, shift;
};

struct MaestroTables {
  int32_t sp_D, sp_s;
  FloorDiv o;         // sp_o
  int32_t conv_kind;  // 1 when the spatial dim couples through a conv window
  int32_t sp_window;
  FloorDiv stride;    // sp_stride
  int32_t spatial_reduces, o_coupled_spatial;
  int32_t temporal_steps;
  int32_t n_cases;
  float delta_a, delta_b, ing_full_a, ing_full_b, egress_a, egress_b;
  float noc_latency;
};

namespace {

constexpr int THREADS = 256;
constexpr int DPT = 4;                  // designs a thread, a multiple of 4
constexpr int TILE = THREADS * DPT;     // designs a block-tile
constexpr int NF = 5;                   // features a design

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// floor(a / b) for b != 0
__device__ __forceinline__ int32_t floordiv_i(int32_t a, int32_t b) {
  const int32_t q = a / b;
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int32_t cdiv_i(int32_t a, int32_t b) {
  return floordiv_i(wsub(wadd(a, b), 1), b);
}

// floor(x / d) for 0 <= x < 2^31 is (x * magic) >> shift: with
// e = magic * d - 2^shift, 0 <= e < d <= 2^(shift - 31), the product is
// x * 2^shift / d + x * e / d, and x * e < 2^shift keeps the second term
// below the distance 1/d to the next multiple.  A negative a folds to
// x = ~a = -a - 1: floor(a / d) = ~floor(~a / d).
__device__ __forceinline__ int32_t floordiv_magic(int32_t a, uint32_t magic,
                                                  uint32_t shift) {
  const int32_t neg = a >> 31;  // 0, or -1 for a < 0
  const uint32_t x = (uint32_t)(a ^ neg);
  return (int32_t)(uint32_t)(((uint64_t)x * magic) >> shift) ^ neg;
}

__device__ __forceinline__ int32_t floordiv_by(int32_t a, const FloorDiv& m) {
  return floordiv_magic(a, m.magic, m.shift);
}

// fmodf(a, b), exactly, without its loop over the exponent gap.
// Domain: b finite and |RN(a / b)| < 2^24 (so a is finite and b != 0).
// Let k = trunc(a / b).  k and k + sign(a / b) are floats, and division
// rounds monotonically, so t = trunc(RN(a / b)) is k or overshoots it by
// one.  If t = k, a - t * b is fmod(a, b) itself, a float.  If t overshoots,
// a - t * b = fmod(a, b) - sign(a) |b|: a multiple of the finer of a's and
// b's last bits, at most |b| in magnitude, so a float too when b's last bit
// is the finer; when a's is, t >= 2 makes it at most 2^-23 |a| (a few of
// a's last bits) and t = 1 makes it a - b with b/2 <= a <= 2b (Sterbenz).
// So the fmaf, which rounds once, gives a - t * b exactly, and in the
// second case adding sign(a) |b| back is exact (the sum, fmod(a, b), is a
// float).  The zero fmodf returns carries a's sign, as copysignf gives it.
// Outside the domain: fmodf.
__device__ __forceinline__ float exact_fmod(float a, float b) {
  const float q = a / b;
  if (!(fabsf(q) < 16777216.0f) || !(fabsf(b) <= 3.402823466e38f))
    return fmodf(a, b);
  float r = fmaf(-truncf(q), b, a);
  if (a >= 0.0f ? r < 0.0f : r > 0.0f) r += copysignf(b, a);
  return copysignf(r, a);
}

// jnp.floor_divide on float32 (the plain version's _floor_divide)
__device__ __forceinline__ float floordiv_f(float a, float b) {
  const float mod = exact_fmod(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = div - 1.0f;
  return roundf(div);  // rounds half away from zero, as lax.round does
}

__device__ __forceinline__ float cdiv_f(float a, float b) {
  return floordiv_f((a + b) - 1.0f, b);
}

__device__ __forceinline__ float comm(float v, float bw, float lat) {
  const float d = floordiv_f((v + bw) - 1.0f, bw) + lat;
  return v > 0.0f ? d : 0.0f;
}

__device__ __forceinline__ int32_t ext_of(int32_t size,
                                          const MaestroTables& T) {
  if (!T.conv_kind) return size;
  return size >= T.sp_window
             ? floordiv_by(wsub(size, T.sp_window), T.stride) + 1
             : 0;
}

// What a design's features take from its PE count n alone.
struct PesTerms {
  float foldsf, fwd, delta, ing_full, step_eg, comp_first, macs, util, bw_req;
};

__device__ __forceinline__ PesTerms pes_terms(int32_t n,
                                              const MaestroTables& T,
                                              const float* __restrict__ cases) {
  const int32_t o = T.o.d, s = T.sp_s, D = T.sp_D;

  // spatial folding of the one SpatialMap over n PEs
  const int32_t adv = wmul(n, o);
  const int32_t span = wadd(s, wmul(n - 1, o));
  const int32_t gap = max(wsub(D, span), 0);
  // cdiv_i(0, adv) is 0 for adv >= 1: no division by the design's own adv
  const int32_t n_folds = 1 + (gap == 0 && adv > 0 ? 0 : cdiv_i(gap, adv));
  const int32_t rem = min(wsub(D, wmul(n_folds - 1, adv)), span);
  const int32_t used = min(n, floordiv_by(wsub(wadd(rem, o), 1), T.o));
  const int32_t full =
      min(used, max(floordiv_by(wsub(rem, s), T.o) + 1, 0));
  const int32_t partial_cnt = used - full;
  const int32_t last_partial = min(max(wsub(rem, wmul(full, o)), 0), s);
  const int32_t partial = partial_cnt > 0 ? last_partial : 0;
  const int32_t is_steady = full == n ? 1 : 0;
  const int32_t steady_folds = n_folds - 1 + is_steady;
  const int32_t edge_folds = 1 - is_steady;
  const int32_t folds = n_folds;

  PesTerms P;
  const float steps_total = (float)wmul(T.temporal_steps, folds);
  const int32_t span_e = min(span, D);
  const float span_ef = (float)span_e;
  const float ext_span = (float)ext_of(span_e, T);
  const float ext_partial = (float)ext_of(partial, T);

  P.delta = T.delta_a + T.delta_b * span_ef;
  P.ing_full = T.ing_full_a + T.ing_full_b * span_ef;
  float egress = T.egress_a + T.egress_b * ext_span;
  if (T.o_coupled_spatial) egress = egress * (float)folds;
  P.step_eg = cdiv_f(egress, fmaxf(steps_total, 1.0f));
  P.fwd = T.spatial_reduces ? ceilf(log2f((float)max(n, 1))) : 0.0f;

  // the bw-free sums over the temporal case rows
  const float nf = (float)n;
  const float fullf = (float)full;
  const float sfolds = (float)steady_folds;
  const float efolds = (float)edge_folds;
  const float has_p = partial > 0 ? 1.0f : 0.0f;
  P.foldsf = (float)folds;
  float macs = 0.0f, active_steps = 0.0f;
  for (int32_t c = 0; c < T.n_cases; ++c) {
    const float occ = cases[3 * c];
    const float ps_full = cases[3 * c + 1];
    const float ps_partial = cases[3 * c + 2] * ext_partial;
    macs = macs + occ * ((sfolds * nf) * ps_full +
                         efolds * (fullf * ps_full + ps_partial));
    active_steps = active_steps + occ * (sfolds * nf + efolds * (fullf + has_p));
  }
  P.comp_first = T.n_cases > 0 ? cases[1] : 0.0f;
  P.macs = macs;
  P.util = active_steps / fmaxf(steps_total * nf, 1.0f);
  P.bw_req = (P.delta + P.step_eg) / fmaxf(P.comp_first, 1.0f);
  return P;
}

// The five features of the design (n, b), as closed_form_features computes
// them, from n's terms P.
__device__ __forceinline__ void eval_design(const PesTerms& P, float b,
                                            const MaestroTables& T,
                                            const float* __restrict__ cases,
                                            float* f) {
  const float lat = T.noc_latency;
  const float ing_sd = comm(P.delta, b, lat);
  const float egr_sd = comm(P.step_eg, b, lat);
  float runtime = 0.0f;
  for (int32_t c = 0; c < T.n_cases; ++c) {
    const float delay = fmaxf(fmaxf(cases[3 * c + 1] + P.fwd, ing_sd), egr_sd);
    runtime = runtime + (cases[3 * c] * P.foldsf) * delay;
  }
  // the first iteration is serial (no double buffering)
  const float serial =
      ((comm(P.ing_full, b, lat) + P.comp_first) + P.fwd) + egr_sd;
  const float overlapped =
      fmaxf(fmaxf(P.comp_first + P.fwd, ing_sd), egr_sd);
  runtime = fmaxf((runtime + serial) - overlapped, 1.0f);
  f[0] = runtime;
  f[1] = P.macs;
  f[2] = P.macs / runtime;
  f[3] = P.util;
  f[4] = P.bw_req;
}

// The warp's rows, row-major from out[5 * w0], its 32 * DPT designs from
// w0 on: each lane puts its DPT rows (80 bytes for DPT = 4) into the warp's
// slice of shared memory as 16-byte words, then the warp stores the slice
// as contiguous 16-byte words, 512 bytes an instruction (out is 16-byte
// aligned and w0 a multiple of 4), a ragged tail word by word.
__device__ __forceinline__ void store_rows(const float (&f)[DPT][NF],
                                           float* wst, float* __restrict__ out,
                                           int64_t w0, int64_t n_designs) {
  const int lane = threadIdx.x % 32;
  float4* mine = reinterpret_cast<float4*>(wst + lane * DPT * NF);
#pragma unroll
  for (int k = 0; k < DPT * NF / 4; ++k) {
    const int e = 4 * k;
    mine[k] = make_float4(
        f[e / NF][e % NF], f[(e + 1) / NF][(e + 1) % NF],
        f[(e + 2) / NF][(e + 2) % NF], f[(e + 3) / NF][(e + 3) % NF]);
  }
  __syncwarp();
  float* dst = out + w0 * NF;
  if (w0 + 32 * DPT <= n_designs) {
#pragma unroll
    for (int k = 0; k < DPT * NF / 4; ++k)
      reinterpret_cast<float4*>(dst)[lane + 32 * k] =
          reinterpret_cast<const float4*>(wst)[lane + 32 * k];
  } else {
    const int count = (int)(n_designs - w0) * NF;
    for (int k = lane; k < count; k += 32) dst[k] = wst[k];
  }
}

__global__ void __launch_bounds__(THREADS)
maestro_eval_kernel(const int32_t* __restrict__ pes,
                    const float* __restrict__ bw, float* __restrict__ out,
                    int64_t n_designs, MaestroTables T,
                    const float* __restrict__ cases) {
  __shared__ __align__(16) float stage[THREADS * DPT * NF];
  const int64_t w0 =
      ((int64_t)blockIdx.x * THREADS + threadIdx.x / 32 * 32) * DPT;
  if (w0 >= n_designs) return;  // the whole warp: its lanes stay together
  const int64_t i0 = w0 + (int64_t)(threadIdx.x % 32) * DPT;
  int32_t n[DPT];
  float b[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {  // past the end: (1, 1.0f), never stored
    n[j] = i0 + j < n_designs ? pes[i0 + j] : 1;
    b[j] = i0 + j < n_designs ? bw[i0 + j] : 1.0f;
  }
  float f[DPT][NF];
  PesTerms P = pes_terms(n[0], T, cases);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    // a DSE grid holds many bw for each PE count: designs that share n
    // share its terms
    if (j > 0 && n[j] != n[j - 1]) P = pes_terms(n[j], T, cases);
    eval_design(P, b[j], T, cases, f[j]);
  }
  store_rows(f, stage + threadIdx.x / 32 * 32 * DPT * NF, out, w0,
             n_designs);
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).  `out` must
// be 16-byte aligned; the inputs need only their own types' alignment.
extern "C" int maestro_eval_launch(const void* pes, const void* bw, void* out,
                                   int64_t n_designs, MaestroTables tables,
                                   const void* cases, void* stream) {
  if (n_designs <= 0) return 0;
  if ((uintptr_t)out % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int64_t blocks = (n_designs + TILE - 1) / TILE;
  maestro_eval_kernel<<<(unsigned int)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)pes, (const float*)bw, (float*)out, n_designs, tables,
      (const float*)cases);
  return (int)cudaGetLastError();
}
