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
//   0  warp    one warp per sentence, 1-4 sentences per block (the caller's
//              `threads` / 32), charts and staged potentials in each warp's
//              own slice of shared memory (32*n1*(n1|1) + 8*n1*n1 + 32*n1
//              bytes: 3,528 at n1 = 9), one __syncwarp() per width: for
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
// Every mapping runs `inside_fill_1b` (dmv_common.cuh): one barrier per
// width (__syncthreads() in a block, __syncwarp() in the warp mapping), so L
// dependent steps where the two-barrier fill takes 2L. A
// group of lanes owns one start i of a width and reduces the incomplete
// spans' split sums together with every narrower term of the complete spans,
// then folds the same-width term in from registers; a logsumexp is a
// lane-parallel max, independent exps and one log. With `stage` the block
// (or the warp) first copies its sentence's potentials (attach [n1][n1][2],
// dec [n1][8]; 8*n1*n1 + 32*n1 bytes) into shared memory by cp.async, writes
// width 0 while the copy is in flight and waits for it before width 1, so no
// width waits on a read of global memory for its arc scores. The warp
// mapping always stages; the wrapper stages the block mappings wherever
// charts and potentials fit together (n1 <= 75 on an H100 with charts in
// shared memory; with charts in global memory, while the potentials fit);
// otherwise the arc scores are read from global memory. Chart and potential
// pointers into shared memory derive from the __shared__ array at compile
// time (the block kernel's SMEM and STAGE template arguments; the warp
// kernel's always), so their loads are 32-bit shared loads.
//
// Saved layout: charts [B][4][n1][n1][2] f32, (chart, w, i, v) with chart
// 0..3 = Cr, Cl, Ir, Il (see dmv_common.cuh); -1e12 outside the triangle.

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 1024;     // block mappings
constexpr int kMaxWarpsPerBlock = 4;  // warp mapping
constexpr int kWarpMaxN1 = 9;         // its fill holds one term a lane up to here

// Writes one sentence's charts from `f` (shared memory, row pitch p) to `g`
// (global, row pitch n1): a group of 1 << lg lanes a chart row (a warp in
// the block mappings, lg = 5; in the warp mapping the power of two at least
// n1, so that 32 >> lg rows go at once), a lane a float pair, -1e12 on the
// cells outside the span triangle.
__device__ __forceinline__ void save_chart_rows(const float* f, float* __restrict__ g, int n1,
                                                int p, int len, int tid, int nt, int lg = 5) {
  const int lane = tid & ((1 << lg) - 1);
  for (int chart = 0; chart < 4; ++chart)
    for (int w = tid >> lg; w < n1; w += nt >> lg)
      for (int i = lane; i < n1; i += 1 << lg) {
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

// Floats of one sentence's slice of shared memory in the warp mapping: four
// charts at the odd pitch, then attach [n1][n1][2] and dec [n1][8] (an even
// count each, so every slice and every part of it stays 8-byte aligned).
__device__ __host__ __forceinline__ int warp_slice_floats(int n1) {
  return 8 * n1 * smem_pitch(n1) + 2 * n1 * n1 + 8 * n1;
}

// A warp a sentence, blockDim.x / 32 sentences a block, each warp on its own
// slice of shared memory: the block kernel's staging and fill at nt = 32.
template <bool IS_MAX, bool SAVE>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
dmv_inside_warp_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                       const int* __restrict__ lengths, float* __restrict__ out,
                       float* __restrict__ charts, int B, int n1) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp; the kernel has no block-wide barrier
  const int p = smem_pitch(n1);
  const int C = n1 * p * 2;
  const int CG = n1 * n1 * 2;
  float* f = smem_f + warp * warp_slice_floats(n1);
  float* pot = f + 4 * C;
  const int len = clamp_len(lengths[b], n1);
  const float* Dg = dec + (size_t)b * n1 * 8;
  stage_pairs(pot, attach + (size_t)b * CG, n1 * n1, lane, 32);
  stage_pairs(pot + CG, Dg, n1 * 4, lane, 32);
  // width 0 from global memory while the copy is in flight
  for (int c = lane; c < 2 * (len + 1); c += 32) {
    const int i = c >> 1, v = c & 1;
    f[ix(p, 0, i, v)] = Dg[dec_idx(i, RIGHT, v, STOP)];
    f[C + ix(p, 0, i, v)] = Dg[dec_idx(i, LEFT, v, STOP)];
  }
  cp_async_wait_all();
  __syncwarp();
  inside_fill_1b<IS_MAX, true>(f, f + C, f + 2 * C, f + 3 * C, pot + CG, pot, n1, p, len, lane,
                               32);
  if (lane == 0) out[b] = f[ix(p, len, 0, NC)];
  // lanes a row: the power of two at least n1 (__clz(0) = 32)
  if (SAVE) save_chart_rows(f, charts + (size_t)b * 4 * CG, n1, p, len, lane, 32, 32 - __clz(n1 - 1));
}

template <bool IS_MAX, bool SAVE>
cudaError_t launch(const float* dec, const float* attach, const int* lengths, float* out,
                   float* charts, float* scratch, int B, int n1, int mapping, int threads,
                   int stage, cudaStream_t s) {
  const int chart_bytes = 32 * n1 * smem_pitch(n1);
  if (mapping == 0) {
    const int warps = threads >> 5;
    if (warps > kMaxWarpsPerBlock || n1 > kWarpMaxN1) return cudaErrorInvalidValue;
    const int smem = warps * 4 * warp_slice_floats(n1);  // <= 14,112 bytes
    const int blocks = (B + warps - 1) / warps;
    dmv_inside_warp_kernel<IS_MAX, SAVE><<<blocks, threads, smem, s>>>(
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
// (n1 <= 9, potentials always staged), 1 block + shared memory
// (32*n1*(n1|1) bytes), 2 block + global memory (`scratch` of B*32*n1*n1
// bytes when not saving, else unused). `threads` per block: a power of two
// in [32, 1024], at most 128 (four sentences) in mapping 0, which takes n1
// <= 9 only. `stage`
// (mappings 1 and 2): copy the potentials into shared memory too
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
