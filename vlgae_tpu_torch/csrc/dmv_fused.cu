// Fused DMV inside + outside pass, one thread block per sentence.
//
// Replaces the TPU kernel `_fused_kernel` of vlgae_tpu/ops/dmv_pallas.py
// (inside fill `_inside_fill_v3`, outside `_outside_fill`) for every
// n1 >= 1: the caller that wants the total and both tables at once, for a
// cotangent of one. The value-only inside pass and the two-launch pair
// (inside with saved charts, then outside with a later cotangent) are
// kernels of their own: dmv_inside.cu and dmv_outside.cu; all three run the
// one-barrier fills of dmv_common.cuh.
//
// Per sentence b it computes the single-root DMV inside charts Cr/Cl/Ir/Il
// (log or max semiring), the total Cr[len,0,NOCHILD], and the gradient of
// that total with respect to every potential, written straight into
// g_dec [B,n1,2,2,2] and g_attach [B,n1,n1,2] (no diagonal-major prep).
//
//  * log semiring: the outside pass carries log-marginals (inside + outside
//    - log Z), width-descending in a pull form: each cell reduces
//    (logsumexp) over its consumers, so no atomics are needed, and a term is
//    the consumer's log-marginal plus its split's log-weight, so the values
//    carried from width to width stay near 0 (outside scores grow to log Z,
//    and their round-off put marginals at n1 = 101 past the tolerance);
//    gradients are exp(log-marginal).
//  * max semiring: the outside pass walks the best derivations top-down,
//    marking a split of a marked cell when its two parts add up exactly to
//    the cell's value (the same float operation as the inside pass, so the
//    test is exact). The indicators are 1 on every cell of every best tree:
//    the TPU kernel's "on a best path" (it uses a tolerance of 1e-4 on the
//    score); jax.grad of the scan instead splits the gradient among exact
//    ties, and ties are outside the comparison contract. They equal the
//    pair's (dmv_outside.cu) at a cotangent of one.
//
// Bound: latency, not bytes or FLOPs. A sentence of length L is a chain of
// L + L (max) or L + L + 1 (log) dependent width steps, each ended by one
// barrier (`inside_fill_1b`, then `outside_fill_1b` on the same charts in
// place). What a step costs is the longest dependent chain of operations in
// it, so a cell's terms are spread over the lanes of a group and a
// logsumexp is a lane-parallel max, independent exps and one log
// (dmv_common.cuh), whose butterflies go level by level (the fills' FUSED
// path: a level's shuffles of every value of a task in flight together, and
// in log a lane's few terms held in registers for the sums instead of read
// twice). The inside pass runs on the first `inside_threads` of the block
// behind a named barrier of their own; the outside pass on all of them (the
// wrapper picks both from n1).
//
// Memory: eight float charts of [n1][pitch][2] a sentence: the inside
// charts Cr, Cl, Ir, Il, then four adjoint charts, OCr, OCl of the complete
// spans (log-marginals or on-best-tree flags) and two that the semirings use
// differently (log: the split sums' log-marginals OA and values AS; max: the
// incomplete spans' flags OIr, OIl). `smem_charts` of them live in dynamic
// shared memory at the odd pitch n1 | 1, beside the sentence's potentials
// (attach [n1][n1][2], dec [n1][8]), copied in by cp.async while width 0 is
// written, the rest in `scratch` at pitch n1 (L2-resident at the eval
// batch):
//   8: all of them, 64*n1*(n1|1) + 8*n1*n1 + 32*n1 bytes, n1 <= 56 on an
//      H100;
//   4: the inside charts, 32*n1*(n1|1) + 8*n1*n1 + 32*n1 bytes, and the
//      adjoint charts in scratch (32*n1*n1 bytes a sentence), 57 <= n1 <=
//      75: the log-marginal form reads eight chart values a term, and half
//      of them are then shared-memory loads;
//   0: none (64*n1*n1 bytes of scratch a sentence); with `stage` the
//      potentials alone are staged.
// The staged attach copy becomes the gradient of attach in place (width w
// reads AT[at] and writes GA[at] on the same cell; no other task touches
// it), written to g_attach once at the end.

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;
// with charts in shared memory a block has at most this many threads (the
// wrapper's rule gives at most 512 there), so a thread may hold more
// registers
constexpr int kMaxSmemThreads = 512;

// SMEM_CHARTS (8, 4 or 0) and STAGE are template arguments, so that every
// chart and potential pointer has a known address space (shared loads and
// stores, 32-bit addresses) instead of generic ones. SMEM_CHARTS > 0
// implies STAGE.
template <bool IS_MAX, int SMEM_CHARTS, bool STAGE>
__global__ void __launch_bounds__(SMEM_CHARTS ? kMaxSmemThreads : kMaxThreads)
dmv_fused_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 float* __restrict__ g_dec, float* __restrict__ g_attach,
                 float* __restrict__ scratch, int n1, int inside_threads) {
  extern __shared__ __align__(16) float smem_f[];
  // the log fills' terms held a lane where a thread has the registers for
  // them (ptxas -v, H100): four with all charts in shared memory (128
  // registers, no spill); two with the adjoint charts in scratch, whose
  // addresses take more registers (four spilled 40 bytes and ran 5-8%
  // slower at n1 = 57-75); none at 1,024 threads a block, 64 registers a
  // thread (four spilled 612 bytes and ran 15% slower at n1 = 101)
  constexpr int kHold = SMEM_CHARTS == 8 ? kRegTerms : SMEM_CHARTS == 4 ? kRegTerms / 2 : 0;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t CG = (size_t)n1 * n1 * 2;  // a chart in global memory
  const float* Dg = dec + (size_t)b * n1 * 8;
  const float* ATg = attach + (size_t)b * CG;
  float* GD = g_dec + (size_t)b * n1 * 8;
  float* GAg = g_attach + (size_t)b * CG;
  const int len = clamp_len(lengths[b], n1);
  const int n = len + 1;
  // pitch and chart size of the inside charts (f) and the adjoint ones (o)
  const int p = SMEM_CHARTS ? smem_pitch(n1) : n1;
  const int pa = SMEM_CHARTS == 8 ? p : n1;
  const size_t C = (size_t)n1 * p * 2, CA = (size_t)n1 * pa * 2;
  float* f = SMEM_CHARTS ? smem_f : scratch + (size_t)b * 8 * CG;
  float* o = SMEM_CHARTS == 8 ? smem_f + 4 * C
             : SMEM_CHARTS == 4 ? scratch + (size_t)b * 4 * CG
                                : f + 4 * C;
  // the staged potentials follow the charts in shared memory
  float* pot = smem_f + SMEM_CHARTS * C;
  if (STAGE) {
    stage_pairs(pot, ATg, n1 * n1, tid, nt);
    stage_pairs(pot + CG, Dg, n1 * 4, tid, nt);
  }
  // width 0 from global memory while the copy is in flight
  for (int c = tid; c < 2 * n; c += nt) {
    const int i = c >> 1, v = c & 1;
    f[ix(p, 0, i, v)] = Dg[dec_idx(i, RIGHT, v, STOP)];
    f[C + ix(p, 0, i, v)] = Dg[dec_idx(i, LEFT, v, STOP)];
  }
  // OA (log) and OIr (max) share a chart, AS (log) and OIl (max) another
  const OutsideCharts1b c{f,          f + C,      f + 2 * C,  f + 3 * C, o,  o + CA,
                          o + 2 * CA, o + 2 * CA, o + 3 * CA, o + 3 * CA, p, pa};
  if (IS_MAX)
    // no flags but the seed: d total / d Cr[len, 0, NC] = 1
    for (int w = warp; w <= len; w += nwarps)
      for (int i = lane; i < n - w; i += 32) {
        st2(c.OCr, pa, w, i, 0.f, w == len ? 1.f : 0.f);
        st2(c.OCl, pa, w, i, 0.f, 0.f);
        st2(c.OIr, pa, w, i, 0.f, 0.f);
        st2(c.OIl, pa, w, i, 0.f, 0.f);
      }
  cp_async_wait_all();
  __syncthreads();
  const float* D = STAGE ? pot + CG : Dg;
  const float* AT = STAGE ? pot : ATg;
  const int nt_in = min(nt, inside_threads);
  if (tid < nt_in)
    inside_fill_1b<IS_MAX, false, true, kHold>(f, f + C, f + 2 * C, f + 3 * C, D, AT, n1, p,
                                               len, tid, nt_in);
  __syncthreads();
  if (tid == 0) out[b] = f[ix(p, len, 0, NC)];
  float* GA = STAGE ? pot : GAg;
  outside_fill_1b<IS_MAX, true, kHold>(c, D, AT, GD, GA, n1, len, 1.f, tid, nt);
  // g_attach once, a warp a head row: the arcs of the sentence, zeros
  // elsewhere (in place when GA is g_attach itself)
  for (int h = warp; h < n1; h += nwarps)
    for (int ch = lane; ch < n1; ch += 32) {
      const bool arc = h < n && ch < n && h != ch;
      const size_t at = ((size_t)h * n1 + ch) * 2;
      if (!arc)
        *reinterpret_cast<float2*>(GAg + at) = make_float2(0.f, 0.f);
      else if (STAGE)
        *reinterpret_cast<float2*>(GAg + at) = *reinterpret_cast<const float2*>(GA + at);
    }
}

template <bool IS_MAX>
cudaError_t launch(const float* dec, const float* attach, const int* lengths, float* out,
                   float* g_dec, float* g_attach, float* scratch, int B, int n1,
                   int smem_charts, int stage, int threads, int inside_threads,
                   cudaStream_t s) {
  const int smem = 8 * n1 * smem_pitch(n1) * smem_charts + (stage ? 8 * n1 * n1 + 32 * n1 : 0);
  auto kernel = smem_charts == 8 ? dmv_fused_kernel<IS_MAX, 8, true>
                : smem_charts == 4 ? dmv_fused_kernel<IS_MAX, 4, true>
                : stage            ? dmv_fused_kernel<IS_MAX, 0, true>
                                   : dmv_fused_kernel<IS_MAX, 0, false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, s>>>(dec, attach, lengths, out, g_dec, g_attach, scratch, n1,
                                  inside_threads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int dmv_fused_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// dec [B,n1,2,2,2] f32, attach [B,n1,n1,2] f32, lengths [B] i32 (all
// contiguous, on the device); out [B], g_dec, g_attach like the inputs.
// `threads` per block and `inside_threads` of them for the inside pass:
// powers of two in [32, 1024] (512 with charts in shared memory).
// `smem_charts` of the eight charts live in dynamic shared memory beside the
// staged potentials (it needs `stage`): 8 (64*n1*(n1|1) + 8*n1*n1 + 32*n1
// bytes), 4, the inside charts (32*n1*(n1|1) + 8*n1*n1 + 32*n1 bytes; the
// adjoint charts in `scratch`, B*32*n1*n1 bytes), or 0 (the charts in
// `scratch`, B*64*n1*n1 bytes; `stage` copies the potentials alone into
// shared memory, 8*n1*n1 + 32*n1 bytes). Returns the error of the shared
// memory opt-in or cudaGetLastError().
int dmv_fused_launch(const float* dec, const float* attach, const int* lengths,
                     float* out, float* g_dec, float* g_attach, void* scratch,
                     int B, int n1, int is_max, int smem_charts, int stage, int threads,
                     int inside_threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > (smem_charts ? kMaxSmemThreads : kMaxThreads) ||
      (threads & (threads - 1)) || inside_threads < 32 ||
      (inside_threads & (inside_threads - 1)) ||
      (smem_charts != 0 && smem_charts != 4 && smem_charts != 8) || (smem_charts && !stage))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* scr = reinterpret_cast<float*>(scratch);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                        n1, smem_charts, stage, threads, inside_threads, s)
                         : launch<false>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                         n1, smem_charts, stage, threads, inside_threads, s);
  return (int)e;
}

}  // extern "C"
