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
// (dmv_common.cuh). The inside pass runs on the first `inside_threads` of
// the block behind a named barrier of their own; the outside pass on all of
// them (the wrapper picks both from n1).
//
// Memory: eight float charts of [n1][pitch][2] a sentence: Cr, Cl, Ir, Il,
// then OCr, OCl of the complete spans (log-marginals or on-best-tree flags)
// and two charts that the semirings use differently (log: the split sums'
// log-marginals OA and values AS; max: the incomplete spans' flags OIr,
// OIl). With `use_smem` they live in dynamic shared memory at the odd pitch
// n1 | 1 beside the sentence's potentials (attach [n1][n1][2], dec [n1][8]),
// copied in by cp.async while width 0 is written: 64*n1*(n1|1) + 8*n1*n1 +
// 32*n1 bytes, n1 <= 56 on an H100. Otherwise the charts live in `scratch`
// (64*n1*n1 bytes a sentence, L2-resident at the eval batch) and, with
// `stage`, the potentials alone are staged. The staged attach copy becomes
// the gradient of attach in place (width w reads AT[at] and writes GA[at] on
// the same cell; no other task touches it), written to g_attach once at the
// end.

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;

// SMEM and STAGE are template arguments, so that every chart and potential
// pointer has a known address space (shared loads and stores, 32-bit
// addresses) instead of generic ones. SMEM implies STAGE.
template <bool IS_MAX, bool SMEM, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
dmv_fused_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 float* __restrict__ g_dec, float* __restrict__ g_attach,
                 float* __restrict__ scratch, int n1, int inside_threads) {
  extern __shared__ __align__(16) float smem_f[];
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
  const int p = SMEM ? smem_pitch(n1) : n1;
  const size_t C = (size_t)n1 * p * 2;
  float* f = SMEM ? smem_f : scratch + (size_t)b * 8 * CG;
  // the staged potentials follow the charts in shared memory
  float* pot = smem_f + (SMEM ? 8 * C : 0);
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
  const OutsideCharts1b c{f,         f + C,     f + 2 * C, f + 3 * C, f + 4 * C, f + 5 * C,
                          f + 6 * C, f + 6 * C, f + 7 * C, f + 7 * C, p};
  if (IS_MAX)
    // no flags but the seed: d total / d Cr[len, 0, NC] = 1
    for (int w = warp; w <= len; w += nwarps)
      for (int i = lane; i < n - w; i += 32) {
        st2(c.OCr, p, w, i, 0.f, w == len ? 1.f : 0.f);
        st2(c.OCl, p, w, i, 0.f, 0.f);
        st2(c.OIr, p, w, i, 0.f, 0.f);
        st2(c.OIl, p, w, i, 0.f, 0.f);
      }
  cp_async_wait_all();
  __syncthreads();
  const float* D = STAGE ? pot + CG : Dg;
  const float* AT = STAGE ? pot : ATg;
  const int nt_in = min(nt, inside_threads);
  if (tid < nt_in)
    inside_fill_1b<IS_MAX, false, true>(f, f + C, f + 2 * C, f + 3 * C, D, AT, n1, p, len, tid,
                                        nt_in);
  __syncthreads();
  if (tid == 0) out[b] = f[ix(p, len, 0, NC)];
  float* GA = STAGE ? pot : GAg;
  outside_fill_1b<IS_MAX>(c, D, AT, GD, GA, n1, len, 1.f, tid, nt);
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
                   float* g_dec, float* g_attach, float* scratch, int B, int n1, int use_smem,
                   int stage, int threads, int inside_threads, cudaStream_t s) {
  const int smem =
      (use_smem ? 64 * n1 * smem_pitch(n1) : 0) + (stage ? 8 * n1 * n1 + 32 * n1 : 0);
  auto kernel = use_smem ? dmv_fused_kernel<IS_MAX, true, true>
                         : (stage ? dmv_fused_kernel<IS_MAX, false, true>
                                  : dmv_fused_kernel<IS_MAX, false, false>);
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
// powers of two in [32, 1024]. With use_smem (which needs `stage`) the
// charts and the potentials live in dynamic shared memory (64*n1*(n1|1) +
// 8*n1*n1 + 32*n1 bytes); otherwise the charts live in `scratch` (B*64*n1*n1
// bytes) and `stage` copies the potentials alone into shared memory
// (8*n1*n1 + 32*n1 bytes). Returns cudaGetLastError().
int dmv_fused_launch(const float* dec, const float* attach, const int* lengths,
                     float* out, float* g_dec, float* g_attach, void* scratch,
                     int B, int n1, int is_max, int use_smem, int stage, int threads,
                     int inside_threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)) ||
      inside_threads < 32 || (inside_threads & (inside_threads - 1)) ||
      (use_smem && !stage))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* scr = reinterpret_cast<float*>(scratch);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                        n1, use_smem, stage, threads, inside_threads, s)
                         : launch<false>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                         n1, use_smem, stage, threads, inside_threads, s);
  return (int)e;
}

}  // extern "C"
