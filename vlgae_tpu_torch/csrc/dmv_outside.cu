// DMV outside pass over saved inside charts, one thread block per sentence.
//
// Replaces the TPU kernel `_outside_kernel` of vlgae_tpu/ops/dmv_pallas.py
// (fill `_outside_fill`): the backward of the two-launch pair. Given the
// potentials, the charts Cr/Cl/Ir/Il that dmv_inside.cu saved (layout in
// dmv_common.cuh), the per-sentence total `logz` and the cotangent `gout`,
// it writes d(sum_b gout_b * total_b)/d dec into g_dec [B,n1,2,2,2] and
// /d attach into g_attach [B,n1,n1,2], already scaled by gout.
//
//  * log semiring: width-descending pull form (each cell reduces, by
//    logsumexp, over its consumers; no atomics) of the log-marginals
//    inside + outside - log Z: a term is the consumer's log-marginal plus
//    the log-weight of the split in the consumer's sum, (the split's sum as
//    the inside pass added it) minus the consumer's inside value, so every
//    stored value is small and no sum subtracts log Z (the outside scores of
//    K1 are as large as log Z, and their round-off at n1 = 101 put marginals
//    1.4e-4 off); gradients gout * exp(log-marginal). `logz` is not read;
//  * max semiring: walks the best derivations top-down and marks a split
//    of a marked cell when its parts add up exactly to the cell's value,
//    with the inside pass's own float addition (the split sums of the
//    incomplete spans are recomputed here: fmaxf is order-free), so
//    the indicators are gout on every cell of every best tree, as in the
//    fused kernel (dmv_fused.cu).
// Rows with gout == 0 (zero-length padding rows) are written as zeros and
// skipped. Reruns give identical bits.
//
// Bound: latency. The bytes and operations are microseconds of this card's
// peaks; a sentence of length L is a chain of width steps. The fill is
// `outside_fill_1b` (dmv_common.cuh): one barrier per width, L + 1 steps
// where the two-barrier fill of K1 takes 2L + 1. A group of lanes owns one
// start i of a width: it walks every consumer of the complete spans [i, i+w]
// and every wider term of the incomplete spans [i, i+w] at once and folds the
// same-width term in last (log), or pulls the marks of the incomplete spans
// from the complete spans that could make them by a warp vote (max).
// Memory: with `use_smem` the four saved charts are copied into shared
// memory by cp.async (a warp a chart row) beside four adjoint charts (the
// complete spans' log-marginals or flags OCr, OCl; in log the split sums'
// log-marginals OA and values AS, in max the incomplete spans' flags OIr,
// OIl;
// 64*n1*(n1|1) bytes, n1 <= 59 on an H100); otherwise the inside charts are
// read in place and the adjoints live in `scratch` (32*n1*n1 bytes per
// sentence). With `stage` the sentence's attach [n1][n1][2] and dec
// [n1][8] rows (8*n1*n1 + 32*n1 bytes) are copied into shared memory too, and
// the attach copy becomes the gradient: width w reads AT[at] and writes
// GA[at] on the same cell, no other task touches it, and the GO decisions
// sum shared memory; g_attach is written once, at the end. The wrapper
// stages wherever charts and potentials fit together (n1 <= 56 with charts in
// shared memory; with charts in global memory, while the potentials fit).

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;

// SMEM and STAGE are template arguments, so that every chart and potential
// pointer has a known address space (shared loads and stores, 32-bit
// addresses) instead of generic ones.
template <bool IS_MAX, bool SMEM, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
dmv_outside_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                   const int* __restrict__ lengths, const float* __restrict__ gout,
                   const float* __restrict__ logz, const float* __restrict__ charts,
                   float* __restrict__ g_dec, float* __restrict__ g_attach,
                   float* __restrict__ scratch, int n1) {
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
  const float go = gout[b];
  if (go == 0.f) {  // the whole block
    for (int k = tid; k < n1 * 8; k += nt) GD[k] = 0.f;
    for (int k = tid; k < n1 * n1 * 2; k += nt) GAg[k] = 0.f;
    return;
  }
  const int len = clamp_len(lengths[b], n1);
  const int n = len + 1;
  const float* G = charts + (size_t)b * 4 * CG;
  const int p = SMEM ? smem_pitch(n1) : n1;
  const size_t C = (size_t)n1 * p * 2;
  float* adj = SMEM ? smem_f + 4 * C : scratch + (size_t)b * 4 * CG;
  // the staged potentials follow the charts in shared memory; the max
  // semiring reads neither, and takes the region for the gradient alone
  float* pot = smem_f + (SMEM ? 8 * C : 0);
  if (STAGE && !IS_MAX) {
    stage_pairs(pot, ATg, n1 * n1, tid, nt);
    stage_pairs(pot + CG, Dg, n1 * 4, tid, nt);
  }
  const float* in = G;
  if (SMEM) {
    // the rows of the span triangle, a warp a row, into the odd pitch
    for (int c = 0; c < 4; ++c)
      for (int w = warp; w <= len; w += nwarps)
        for (int i = lane; i < n - w; i += 32)
          cp_async8(smem_f + c * C + ix(p, w, i, 0), G + c * CG + ((size_t)w * n1 + i) * 2);
    in = smem_f;
  }
  // OA (log) and OIr (max) share a chart, AS (log) and OIl (max) another
  const OutsideCharts1b c{in,          in + C,      in + 2 * C,  in + 3 * C,  adj, adj + C,
                          adj + 2 * C, adj + 2 * C, adj + 3 * C, adj + 3 * C, p};
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
  float* GA = STAGE ? pot : GAg;
  outside_fill_1b<IS_MAX>(c, STAGE ? pot + CG : Dg, STAGE ? pot : ATg, GD, GA, n1, len, go,
                          tid, nt);
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
cudaError_t launch(const float* dec, const float* attach, const int* lengths,
                   const float* gout, const float* logz, const float* charts, float* g_dec,
                   float* g_attach, float* scratch, int B, int n1, int use_smem, int stage,
                   int threads, cudaStream_t s) {
  const int smem =
      (use_smem ? 64 * n1 * smem_pitch(n1) : 0) + (stage ? 8 * n1 * n1 + 32 * n1 : 0);
  auto kernel = use_smem ? (stage ? dmv_outside_kernel<IS_MAX, true, true>
                                  : dmv_outside_kernel<IS_MAX, true, false>)
                         : (stage ? dmv_outside_kernel<IS_MAX, false, true>
                                  : dmv_outside_kernel<IS_MAX, false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, s>>>(dec, attach, lengths, gout, logz, charts, g_dec, g_attach,
                                  scratch, n1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dec [B,n1,2,2,2], attach [B,n1,n1,2], gout [B], logz [B], charts
// [B,4,n1,n1,2] f32 and lengths [B] i32 in; g_dec, g_attach like dec and
// attach out. `threads` per block: a power of two in [32, 1024]. With use_smem
// the block keeps 64*n1*(n1|1) bytes of charts in dynamic shared memory;
// otherwise `scratch` holds B*32*n1*n1 bytes. `stage` adds the potentials,
// 8*n1*n1 + 32*n1 bytes, to the shared memory. Returns cudaGetLastError().
int dmv_outside_launch(const float* dec, const float* attach, const int* lengths,
                       const float* gout, const float* logz, const float* charts,
                       float* g_dec, float* g_attach, float* scratch, int B, int n1,
                       int is_max, int use_smem, int stage, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, gout, logz, charts, g_dec,
                                        g_attach, scratch, B, n1, use_smem, stage, threads, s)
                         : launch<false>(dec, attach, lengths, gout, logz, charts, g_dec,
                                         g_attach, scratch, B, n1, use_smem, stage, threads, s);
  return (int)e;
}

}  // extern "C"
