// DMV inside pass on its own: the per-sentence total, and optionally the
// four inside charts saved to global memory for a later outside pass
// (dmv_outside.cu).
//
// Replaces the TPU's inside kernels of vlgae_tpu/ops/dmv_pallas.py:
//   * value only   - `_inside_kernel_v3` (and `_inside_kernel_v2`,
//     `_inside_kernel` for the charts the v3 fill does not take): the primal
//     of `_make_dmv_total` when no gradient is wanted (the eval loss);
//   * charts saved - `_inside_kernel_v3_save` (`_inside_kernel_v2_save`,
//     `_inside_kernel_save`): the forward of the two-launch pair, whose
//     backward is `_outside_kernel` with the real cotangent.
// Log and max semiring, single-root constraint, lengths clamped to
// [0, n1-1]; a zero-length row gives dec[0, RIGHT, NOCHILD, STOP].
//
// Three mappings of sentences onto threads, chosen by the caller from n1
// and the card's shared-memory limit only:
//   0  warp    one warp per sentence, four sentences per block, charts in
//              shared memory, __syncwarp() between the two phases of every
//              width (the two-barrier `inside_fill`, kept as it was): for
//              n1 <= 9, where a block per sentence would leave nearly every
//              thread idle (the TPU's fill for tiny charts);
//   1  block   one block per sentence, charts (32*n1*(n1|1) bytes, an odd
//              row pitch against bank conflicts) in dynamic shared memory;
//   2  global  one block per sentence, charts in global memory (the saved
//              chart tensor itself, or a scratch buffer for the value-only
//              pass): beyond the shared-memory limit (n1 > 85 on an H100;
//              the TPU's fill for shapes short of fast memory).
//
// Bound: latency. The bytes moved and the operations done are microseconds
// of this card's peaks; a sentence of length L is a chain of width steps.
// The block mappings run `inside_fill_1b` (dmv_common.cuh): one barrier per
// width, so L dependent steps where the warp mapping's fill takes 2L. A
// group of lanes owns one start i of a width and reduces the incomplete
// spans' split sums together with every narrower term of the complete spans,
// then folds the same-width term in from registers; a logsumexp is a
// lane-parallel max, independent exps and one log. With `stage` the block
// first copies its sentence's potentials (attach [n1][n1][2], dec [n1][8];
// 8*n1*n1 + 32*n1 bytes) into shared memory by cp.async, writes width 0
// while the copy is in flight and waits for it before width 1, so no width
// waits on a read of global memory for its arc scores. The wrapper stages
// wherever charts and potentials fit together (n1 <= 75 on an H100 with
// charts in shared memory; with charts in global memory, while the
// potentials fit); otherwise the arc scores are read from global memory.
//
// Saved layout: charts [B][4][n1][n1][2] f32, (chart, w, i, v) with chart
// 0..3 = Cr, Cl, Ir, Il (see dmv_common.cuh); -1e12 outside the triangle.

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;  // block mappings
constexpr int kWarpsPerBlock = 4;  // warp mapping

// Writes one sentence's charts from `f` (shared memory, row pitch p) to `g`
// (global, row pitch n1), -1e12 on the cells outside the span triangle.
__device__ __forceinline__ void save_charts(const float* f, float* __restrict__ g, int n1,
                                            int p, int len, int tid, int nt) {
  const int C = n1 * n1 * 2;
  for (int k = tid; k < 4 * C; k += nt) {
    const int chart = k / C;
    const int r = k - chart * C;
    const int w = r / (2 * n1);
    const int i = (r - w * 2 * n1) >> 1;
    const bool valid = (i + w <= len) && !(chart >= 2 && w == 0);
    g[k] = valid ? f[chart * n1 * p * 2 + ix(p, w, i, r & 1)] : kNegInf;
  }
}

// Writes one sentence's charts from `f` (shared memory, row pitch p) to `g`
// (global, row pitch n1) as `save_charts` does: a warp a chart row, a lane
// a float pair, -1e12 on the cells outside the span triangle.
__device__ __forceinline__ void save_chart_rows(const float* f, float* __restrict__ g, int n1,
                                                int p, int len, int tid, int nt) {
  const int lane = tid & 31;
  for (int chart = 0; chart < 4; ++chart)
    for (int w = tid >> 5; w < n1; w += nt >> 5)
      for (int i = lane; i < n1; i += 32) {
        const bool valid = (i + w <= len) && !(chart >= 2 && w == 0);
        const float2 x = valid ? ld2(f + (size_t)chart * n1 * p * 2, p, w, i)
                               : make_float2(kNegInf, kNegInf);
        *reinterpret_cast<float2*>(g + ((size_t)chart * n1 + w) * n1 * 2 + i * 2) = x;
      }
}

// SMEM and STAGE are template arguments, so that every chart and potential
// pointer has a known address space (shared loads and stores, 32-bit
// addresses) instead of generic ones.
template <bool IS_MAX, bool SAVE, bool SMEM, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads)
dmv_inside_block_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                        const int* __restrict__ lengths, float* __restrict__ out,
                        float* __restrict__ charts, float* __restrict__ scratch, int n1) {
  extern __shared__ __align__(16) float smem_f[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t CG = (size_t)n1 * n1 * 2;  // a chart in global memory
  float* g = SAVE ? charts + (size_t)b * 4 * CG
                  : (SMEM ? nullptr : scratch + (size_t)b * 4 * CG);
  float* f = SMEM ? smem_f : g;
  const int p = SMEM ? smem_pitch(n1) : n1;
  const size_t C = (size_t)n1 * p * 2;
  const int len = clamp_len(lengths[b], n1);
  const float* Dg = dec + (size_t)b * n1 * 8;
  const float* ATg = attach + (size_t)b * CG;
  // the staged potentials follow the charts in shared memory
  float* pot = smem_f + (SMEM ? 4 * C : 0);
  if (STAGE) {
    stage_pairs(pot, ATg, n1 * n1, tid, nt);
    stage_pairs(pot + CG, Dg, n1 * 4, tid, nt);
  }
  if (SAVE && !SMEM) {
    for (size_t k = tid; k < 4 * C; k += nt) f[k] = kNegInf;
    __syncthreads();
  }
  // width 0 from global memory while the copy is in flight
  for (int c = tid; c < 2 * (len + 1); c += nt) {
    const int i = c >> 1, v = c & 1;
    f[ix(p, 0, i, v)] = Dg[dec_idx(i, RIGHT, v, STOP)];
    f[C + ix(p, 0, i, v)] = Dg[dec_idx(i, LEFT, v, STOP)];
  }
  cp_async_wait_all();
  __syncthreads();
  inside_fill_1b<IS_MAX>(f, f + C, f + 2 * C, f + 3 * C, STAGE ? pot + CG : Dg,
                         STAGE ? pot : ATg, n1, p, len, tid, nt);
  if (tid == 0) out[b] = f[ix(p, len, 0, NC)];
  if (SAVE && SMEM) save_chart_rows(f, g, n1, p, len, tid, nt);
}

template <bool IS_MAX, bool SAVE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dmv_inside_warp_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                       const int* __restrict__ lengths, float* __restrict__ out,
                       float* __restrict__ charts, int B, int n1) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // a whole warp; the kernel has no block-wide barrier
  const int p = smem_pitch(n1);
  const int C = n1 * p * 2;
  float* f = smem_f + warp * 4 * C;
  const int len = clamp_len(lengths[b], n1);
  inside_fill<IS_MAX, true>(f, f + C, f + 2 * C, f + 3 * C, nullptr,
                            dec + (size_t)b * n1 * 8, attach + (size_t)b * n1 * n1 * 2, n1, p,
                            len, lane, 32);
  if (lane == 0) out[b] = f[ix(p, len, 0, NC)];
  if (SAVE) save_charts(f, charts + (size_t)b * 4 * n1 * n1 * 2, n1, p, len, lane, 32);
}

template <bool IS_MAX, bool SAVE>
cudaError_t launch(const float* dec, const float* attach, const int* lengths, float* out,
                   float* charts, float* scratch, int B, int n1, int mapping, int threads,
                   int stage, cudaStream_t s) {
  const int chart_bytes = 32 * n1 * smem_pitch(n1);
  if (mapping == 0) {
    const int smem = kWarpsPerBlock * chart_bytes;
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dmv_inside_warp_kernel<IS_MAX, SAVE><<<blocks, kWarpsPerBlock * 32, smem, s>>>(
        dec, attach, lengths, out, charts, B, n1);
    return cudaGetLastError();
  }
  const int use_smem = mapping == 1;
  const int smem = (use_smem ? chart_bytes : 0) + (stage ? 8 * n1 * n1 + 32 * n1 : 0);
  auto kernel = use_smem ? (stage ? dmv_inside_block_kernel<IS_MAX, SAVE, true, true>
                                  : dmv_inside_block_kernel<IS_MAX, SAVE, true, false>)
                         : (stage ? dmv_inside_block_kernel<IS_MAX, SAVE, false, true>
                                  : dmv_inside_block_kernel<IS_MAX, SAVE, false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, s>>>(dec, attach, lengths, out, charts, scratch, n1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int dmv_inside_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// dec [B,n1,2,2,2] f32, attach [B,n1,n1,2] f32, lengths [B] i32, out [B]
// f32; with `save`, charts [B,4,n1,n1,2] f32 is written. mapping: 0 warp
// (n1 <= 9), 1 block + shared memory (32*n1*(n1|1) bytes), 2 block + global
// memory (`scratch` of B*32*n1*n1 bytes when not saving, else unused).
// `threads` per block of mappings 1 and 2: a power of two in [32, 1024].
// `stage` (mappings 1 and 2): copy the potentials into shared memory too
// (8*n1*n1 + 32*n1 more bytes). Returns cudaGetLastError().
int dmv_inside_launch(const float* dec, const float* attach, const int* lengths, float* out,
                      float* charts, float* scratch, int B, int n1, int is_max, int save,
                      int mapping, int threads, int stage, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto fn = is_max ? (save ? launch<true, true> : launch<true, false>)
                   : (save ? launch<false, true> : launch<false, false>);
  const cudaError_t e =
      fn(dec, attach, lengths, out, charts, scratch, B, n1, mapping, threads, stage, s);
  return (int)e;
}

}  // extern "C"
