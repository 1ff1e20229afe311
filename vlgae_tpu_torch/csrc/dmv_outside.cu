// DMV outside pass over saved inside charts, one thread block per sentence.
//
// Replaces the TPU kernel `_outside_kernel` of vlgae_tpu/ops/dmv_pallas.py
// (fill `_outside_fill`): the backward of the two-launch pair. Given the
// potentials, the charts Cr/Cl/Ir/Il that dmv_inside.cu saved (layout in
// dmv_common.cuh), the per-sentence total `logz` and the cotangent `gout`,
// it writes d(sum_b gout_b * total_b)/d dec into g_dec [B,n1,2,2,2] and
// /d attach into g_attach [B,n1,n1,2], already scaled by gout.
//
//  * log semiring: width-descending pull form (each adjoint cell reduces,
//    by logsumexp, over its consumers; no atomics), gradients
//    gout * exp(inside + outside - logz);
//  * max semiring: walks the best derivations top-down and marks a split
//    of a marked cell when its parts add up exactly to the cell's value,
//    with the inside pass's own float addition (the split sums of the
//    incomplete spans are recomputed here: fmaxf is order-free), so
//    the indicators are gout on every cell of every best tree, as in the
//    fused kernel (dmv_fused.cu).
// Rows with gout == 0 (zero-length padding rows) are written as zeros and
// skipped. Reruns give identical bits.
//
// Bound: latency (2L dependent steps for length L), as the inside pass. The
// fill (dmv_common.cuh, shared with dmv_fused.cu) gives every adjoint cell a
// group of lanes that walks all its consumers once: a lane-parallel max,
// independent exps, one log. With `use_smem` the four inside charts are
// copied into shared memory beside the five adjoint charts (72*n1*(n1|1)
// bytes, n1 <= 56 on an H100); otherwise the inside charts are read in place
// and the adjoints live in `scratch` (40*n1*n1 bytes per sentence).

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;

template <bool IS_MAX>
__global__ void __launch_bounds__(kMaxThreads)
dmv_outside_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                   const int* __restrict__ lengths, const float* __restrict__ gout,
                   const float* __restrict__ logz, const float* __restrict__ charts,
                   float* __restrict__ g_dec, float* __restrict__ g_attach,
                   float* __restrict__ scratch, int n1, int use_smem) {
  extern __shared__ __align__(16) float smem_f[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t CG = (size_t)n1 * n1 * 2;  // a chart in global memory
  const float* D = dec + (size_t)b * n1 * 8;
  const float* AT = attach + (size_t)b * n1 * n1 * 2;
  float* GD = g_dec + (size_t)b * n1 * 8;
  float* GA = g_attach + (size_t)b * n1 * n1 * 2;
  for (int k = tid; k < n1 * 8; k += nt) GD[k] = 0.f;
  for (int k = tid; k < n1 * n1 * 2; k += nt) GA[k] = 0.f;
  const float go = gout[b];
  if (go == 0.f) return;  // the whole block

  const float* G = charts + (size_t)b * 4 * CG;
  const int p = use_smem ? smem_pitch(n1) : n1;
  const size_t C = (size_t)n1 * p * 2;
  const float* in = G;
  float* adj = use_smem ? smem_f + 4 * C : scratch + (size_t)b * 5 * CG;
  if (use_smem) {
    // saved rows of n1 positions into rows of the shared-memory pitch
    for (size_t k = tid; k < 4 * CG; k += nt) {
      const int row = (int)(k / (2 * n1)), col = (int)(k - (size_t)row * 2 * n1);
      smem_f[(size_t)row * 2 * p + col] = G[k];
    }
    in = smem_f;
  }
  const OutsideCharts c{in, in + C, in + 2 * C, in + 3 * C, adj,
                        adj + C, adj + 2 * C, adj + 3 * C, adj + 4 * C, p};
  const int len = clamp_len(lengths[b], n1);
  __syncthreads();
  outside_fill<IS_MAX>(c, false, D, AT, GD, GA, n1, len, logz[b], go, tid, nt);
}

template <bool IS_MAX>
cudaError_t launch(const float* dec, const float* attach, const int* lengths,
                   const float* gout, const float* logz, const float* charts, float* g_dec,
                   float* g_attach, float* scratch, int B, int n1, int use_smem, int threads,
                   cudaStream_t s) {
  const int smem = use_smem ? 72 * n1 * smem_pitch(n1) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dmv_outside_kernel<IS_MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dmv_outside_kernel<IS_MAX><<<B, threads, smem, s>>>(dec, attach, lengths, gout, logz,
                                                      charts, g_dec, g_attach, scratch, n1,
                                                      use_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dec [B,n1,2,2,2], attach [B,n1,n1,2], gout [B], logz [B], charts
// [B,4,n1,n1,2] f32 and lengths [B] i32 in; g_dec, g_attach like dec and
// attach out. `threads` per block: a power of two in [32, 1024]. With use_smem
// the block keeps 72*n1*(n1|1) bytes of dynamic shared memory; otherwise
// `scratch` holds B*40*n1*n1 bytes. Returns cudaGetLastError().
int dmv_outside_launch(const float* dec, const float* attach, const int* lengths,
                       const float* gout, const float* logz, const float* charts,
                       float* g_dec, float* g_attach, float* scratch, int B, int n1,
                       int is_max, int use_smem, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, gout, logz, charts, g_dec,
                                        g_attach, scratch, B, n1, use_smem, threads, s)
                         : launch<false>(dec, attach, lengths, gout, logz, charts, g_dec,
                                         g_attach, scratch, B, n1, use_smem, threads, s);
  return (int)e;
}

}  // extern "C"
