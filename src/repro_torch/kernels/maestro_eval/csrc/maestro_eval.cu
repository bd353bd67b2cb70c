// maestro_eval: the MAESTRO hardware-DSE inner loop as a hand-written CUDA
// kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/maestro_eval/maestro_eval.py::maestro_eval, the
// Pallas TPU kernel whose body is closed_form_features.  For each design
// point (num_pes int32, noc_bw float32) it evaluates the faithful engine's
// single-level analysis in closed form over static tables (tables.py) and
// writes the features runtime, macs, throughput, util, bw_req as float32.
//
// What bounds it: each design reads 8 bytes and writes 20 (28 B) against
// roughly 60 float32 operations, far below the H100's operations-per-byte
// balance, so the kernel is memory-bound; its bound is N * 28 B over the
// card's memory bandwidth (3.35 TB/s on an H100 SXM).
//
// Design: one thread per design, 256 threads a block, the ragged tail masked
// (no padding).  The table's scalars come in a POD struct passed by value
// and the case rows (occ, psums_full, psums_per_ext) as a small float32
// device array plus a count, so one compiled kernel serves every table.
// Each thread stores its 5 features as one row-major 20-byte row; those
// stores are not coalesced into full sectors, which is the first thing a
// faster version would change (stage the rows through shared memory and
// write the block's tile with wide, contiguous stores).
//
// Parity with the plain version (closed_form_features), which is exact
// float32 op-for-op:
//   * integer // floors (Python/JAX/torch), C's / truncates: floordiv_i;
//   * floor_divide on floats follows jnp.floor_divide's rule (remainder,
//     subtract, divide, sign correction, round), which torch.floor_divide
//     shares: floordiv_f;
//   * int32 arithmetic wraps as it does in the reference: the w* helpers;
//   * build with --fmad=false so no multiply-add is contracted;
//   * ceil(log2(max(n, 1))) is the integer bit length of n - 1, equal to
//     the plain version's float formula for every n checked by chip_smoke.
#include <cuda_runtime.h>
#include <stdint.h>

struct MaestroTables {
  int32_t sp_D, sp_s, sp_o;
  int32_t conv_kind;  // 1 when the spatial dim couples through a conv window
  int32_t sp_window, sp_stride;
  int32_t spatial_reduces, o_coupled_spatial;
  int32_t temporal_steps;
  int32_t n_cases;
  float delta_a, delta_b, ing_full_a, ing_full_b, egress_a, egress_b;
  float noc_latency;
};

namespace {

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

// jnp.floor_divide / torch.floor_divide on float32
__device__ __forceinline__ float floordiv_f(float a, float b) {
  const float mod = fmodf(a, b);
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
             ? floordiv_i(wsub(size, T.sp_window), T.sp_stride) + 1
             : 0;
}

// ceil(log2(x)) for x >= 1
__device__ __forceinline__ int32_t log2_ceil(int32_t x) {
  return x <= 1 ? 0 : 32 - __clz(x - 1);
}

__global__ void __launch_bounds__(256)
maestro_eval_kernel(const int32_t* __restrict__ pes,
                    const float* __restrict__ bw, float* __restrict__ out,
                    int64_t n_designs, MaestroTables T,
                    const float* __restrict__ cases) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_designs) return;
  const int32_t n = pes[i];
  const float b = bw[i];
  const int32_t o = T.sp_o, s = T.sp_s, D = T.sp_D;

  // spatial folding of the one SpatialMap over n PEs
  const int32_t adv = wmul(n, o);
  const int32_t span = wadd(s, wmul(n - 1, o));
  const int32_t n_folds = 1 + cdiv_i(max(wsub(D, span), 0), adv);
  const int32_t rem = min(wsub(D, wmul(n_folds - 1, adv)), span);
  const int32_t used = min(n, cdiv_i(rem, o));
  const int32_t full =
      min(used, max(floordiv_i(wsub(rem, s), o) + 1, 0));
  const int32_t partial_cnt = used - full;
  const int32_t last_partial = min(max(wsub(rem, wmul(full, o)), 0), s);
  const int32_t partial = partial_cnt > 0 ? last_partial : 0;
  const int32_t is_steady = full == n ? 1 : 0;
  const int32_t steady_folds = n_folds - 1 + is_steady;
  const int32_t edge_folds = 1 - is_steady;
  const int32_t folds = n_folds;

  const float steps_total = (float)wmul(T.temporal_steps, folds);
  const int32_t span_e = min(span, D);
  const float span_ef = (float)span_e;
  const float ext_span = (float)ext_of(span_e, T);
  const float ext_partial = (float)ext_of(partial, T);

  const float delta = T.delta_a + T.delta_b * span_ef;
  const float ing_full = T.ing_full_a + T.ing_full_b * span_ef;
  float egress = T.egress_a + T.egress_b * ext_span;
  if (T.o_coupled_spatial) egress = egress * (float)folds;
  const float step_eg = cdiv_f(egress, fmaxf(steps_total, 1.0f));

  const float lat = T.noc_latency;
  const float ing_sd = comm(delta, b, lat);
  const float egr_sd = comm(step_eg, b, lat);
  const float fwd = T.spatial_reduces ? (float)log2_ceil(max(n, 1)) : 0.0f;

  // accumulate over the temporal case rows
  const float nf = (float)n;
  const float fullf = (float)full;
  const float sfolds = (float)steady_folds;
  const float efolds = (float)edge_folds;
  const float foldsf = (float)folds;
  const float has_p = partial > 0 ? 1.0f : 0.0f;
  float runtime = 0.0f, macs = 0.0f, active_steps = 0.0f, comp_first = 0.0f;
  for (int32_t c = 0; c < T.n_cases; ++c) {
    const float occ = cases[3 * c];
    const float ps_full = cases[3 * c + 1];
    const float ps_per_ext = cases[3 * c + 2];
    if (c == 0) comp_first = ps_full;
    const float delay = fmaxf(fmaxf(ps_full + fwd, ing_sd), egr_sd);
    runtime = runtime + (occ * foldsf) * delay;
    const float ps_partial = ps_per_ext * ext_partial;
    macs = macs + occ * ((sfolds * nf) * ps_full +
                         efolds * (fullf * ps_full + ps_partial));
    active_steps = active_steps + occ * (sfolds * nf + efolds * (fullf + has_p));
  }

  // the first iteration is serial (no double buffering)
  const float serial = ((comm(ing_full, b, lat) + comp_first) + fwd) + egr_sd;
  const float overlapped = fmaxf(fmaxf(comp_first + fwd, ing_sd), egr_sd);
  runtime = fmaxf((runtime + serial) - overlapped, 1.0f);

  const float total_steps_pe = steps_total * nf;
  float* row = out + i * 5;
  row[0] = runtime;
  row[1] = macs;
  row[2] = macs / runtime;
  row[3] = active_steps / fmaxf(total_steps_pe, 1.0f);
  row[4] = (delta + step_eg) / fmaxf(comp_first, 1.0f);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int maestro_eval_launch(const void* pes, const void* bw, void* out,
                                   int64_t n_designs, MaestroTables tables,
                                   const void* cases, void* stream) {
  if (n_designs <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_designs + threads - 1) / threads;
  maestro_eval_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)pes, (const float*)bw, (float*)out, n_designs, tables,
      (const float*)cases);
  return (int)cudaGetLastError();
}
