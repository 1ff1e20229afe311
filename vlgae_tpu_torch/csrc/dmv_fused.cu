// Fused DMV inside + outside pass, one thread block per sentence.
//
// Replaces the TPU kernel `_fused_kernel` of vlgae_tpu/ops/dmv_pallas.py
// (inside fill `_inside_fill_v3`, outside `_outside_fill`) for every
// n1 >= 1: the caller that wants the total and both tables at once, for a
// cotangent of one. The value-only inside pass and the two-launch pair
// (inside with saved charts, then outside with a later cotangent) are
// kernels of their own: dmv_inside.cu and dmv_outside.cu; all three run the
// fills of dmv_common.cuh.
//
// Per sentence b it computes the single-root DMV inside charts Cr/Cl/Ir/Il
// (log or max semiring), the total Cr[len,0,NOCHILD], and the gradient of
// that total with respect to every potential, written straight into
// g_dec [B,n1,2,2,2] and g_attach [B,n1,n1,2] (no diagonal-major prep).
//
//  * log semiring: an outside pass, width-descending, in a pull form: each
//    adjoint cell reduces (logsumexp) over its consumers, so no atomics are
//    needed; gradients are exp(inside + outside - logZ) (marginals).
//  * max semiring: the outside pass walks the best derivations top-down,
//    marking a split of a marked cell when its two parts add up exactly to
//    the cell's value (the same float operation as the inside pass, so the
//    test is exact). The indicators are 1 on every cell of every best tree:
//    the TPU kernel's "on a best path" (it uses a tolerance of 1e-4 on the
//    score); jax.grad of the scan instead splits the gradient among exact
//    ties, and ties are outside the comparison contract.
//
// Bound: latency, not bytes or FLOPs. A sentence of length 50 is 4*50
// dependent width steps, each ended by a barrier. What a step costs is the
// longest dependent chain of operations inside it, so a cell's terms are
// spread over the lanes of a group (a sub-warp whose width is chosen per
// width step so that cells x lanes fill the block) and a logsumexp is a
// lane-parallel max, independent exps and one log (dmv_common.cuh). The
// block is up to 1024 threads, of which the first `inside_threads` run the
// inside fill (the wrapper picks both from n1). All charts of a
// block stay in shared memory when they fit (n1 <= 56 on an H100), with an
// odd row pitch against bank conflicts, and in a global scratch buffer
// (L2-resident at the eval batch) otherwise.
//
// Scratch per sentence: 9 float charts of [n1][pitch][2]: Cr, Cl, Ir, Il,
// their adjoints (log) or on-best-tree flags (max), and A[w][i][dir], the
// split sums of the incomplete spans before the arc score (max: their
// values; log: their adjoints). Bytes per sentence: 72 * n1 * pitch, with
// pitch = n1 | 1 in shared memory and n1 in global memory.

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;

template <bool IS_MAX>
__global__ void __launch_bounds__(kMaxThreads)
dmv_fused_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 float* __restrict__ g_dec, float* __restrict__ g_attach,
                 unsigned char* __restrict__ scratch, int n1, int use_smem,
                 int inside_threads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int p = use_smem ? smem_pitch(n1) : n1;
  const size_t C = (size_t)n1 * p * 2;
  float* f = reinterpret_cast<float*>(
      use_smem ? smem_raw : scratch + (size_t)b * 72 * (size_t)n1 * n1);
  const float* D = dec + (size_t)b * n1 * 8;
  const float* AT = attach + (size_t)b * n1 * n1 * 2;
  float* GD = g_dec + (size_t)b * n1 * 8;
  float* GA = g_attach + (size_t)b * n1 * n1 * 2;
  const int len = clamp_len(lengths[b], n1);

  for (int k = tid; k < n1 * 8; k += nt) GD[k] = 0.f;
  for (int k = tid; k < n1 * n1 * 2; k += nt) GA[k] = 0.f;
  const OutsideCharts c{f, f + C, f + 2 * C, f + 3 * C, f + 4 * C,
                        f + 5 * C, f + 6 * C, f + 7 * C, f + 8 * C, p};
  // the max semiring keeps the split sums of the incomplete spans in OA
  // (the inside fill has fewer terms a cell than the outside pass and is
  // fastest on fewer threads: shorter shuffle trees, a smaller barrier)
  const int nt_in = min(nt, inside_threads);
  if (tid < nt_in)
    inside_fill<IS_MAX, false>(f, f + C, f + 2 * C, f + 3 * C, IS_MAX ? c.OA : nullptr, D,
                               AT, n1, p, len, tid, nt_in);
  __syncthreads();
  const float total = c.Cr[ix(p, len, 0, NC)];
  if (tid == 0) out[b] = total;
  outside_fill<IS_MAX>(c, true, D, AT, GD, GA, n1, len, total, 1.f, tid, nt);
}

template <bool IS_MAX>
cudaError_t launch(const float* dec, const float* attach, const int* lengths, float* out,
                   float* g_dec, float* g_attach, unsigned char* scratch, int B, int n1,
                   int use_smem, int threads, int inside_threads, cudaStream_t s) {
  const int smem = use_smem ? 72 * n1 * smem_pitch(n1) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dmv_fused_kernel<IS_MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dmv_fused_kernel<IS_MAX><<<B, threads, smem, s>>>(dec, attach, lengths, out, g_dec,
                                                    g_attach, scratch, n1, use_smem,
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
// `threads` per block and `inside_threads` of them for the inside fill:
// powers of two in [32, 1024]. With use_smem the charts
// live in dynamic shared memory (72*n1*(n1|1) bytes), otherwise in `scratch`
// (B*72*n1*n1 bytes). Returns cudaGetLastError().
int dmv_fused_launch(const float* dec, const float* attach, const int* lengths,
                     float* out, float* g_dec, float* g_attach, void* scratch,
                     int B, int n1, int is_max, int use_smem, int threads,
                     int inside_threads, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)) ||
      inside_threads < 32 || (inside_threads & (inside_threads - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned char* scr = reinterpret_cast<unsigned char*>(scratch);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                        n1, use_smem, threads, inside_threads, s)
                         : launch<false>(dec, attach, lengths, out, g_dec, g_attach, scr, B,
                                         n1, use_smem, threads, inside_threads, s);
  return (int)e;
}

}  // extern "C"
