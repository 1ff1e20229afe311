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
//    incomplete spans are recomputed here in the inside pass's order), so
//    the indicators are gout on every cell of every best tree, as in the
//    fused kernel (dmv_fused.cu).
// Rows with gout == 0 (zero-length padding rows) are written as zeros and
// skipped. Reruns give identical bits.
//
// Bound: latency (2L dependent steps for length L), as the inside pass.
// With `use_smem` the four inside charts are copied into shared memory
// beside the five adjoint charts (72*n1*n1 bytes, n1 <= 56 on an H100);
// otherwise the inside charts are read in place and the adjoints live in
// `scratch` (40*n1*n1 bytes per sentence).

#include "dmv_common.cuh"

namespace {

using namespace dmv;

constexpr int kMaxThreads = 128;

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
  const size_t C = (size_t)n1 * n1 * 2;
  const float* D = dec + (size_t)b * n1 * 8;
  const float* AT = attach + (size_t)b * n1 * n1 * 2;
  float* GD = g_dec + (size_t)b * n1 * 8;
  float* GA = g_attach + (size_t)b * n1 * n1 * 2;
  for (int k = tid; k < n1 * 8; k += nt) GD[k] = 0.f;
  for (int k = tid; k < n1 * n1 * 2; k += nt) GA[k] = 0.f;
  const float go = gout[b];
  if (go == 0.f) return;  // the whole block

  const float* G = charts + (size_t)b * 4 * C;
  const float* in = G;
  float* adj = use_smem ? smem_f + 4 * C : scratch + (size_t)b * 5 * C;
  if (use_smem) {
    for (size_t k = tid; k < 4 * C; k += nt) smem_f[k] = G[k];
    in = smem_f;
  }
  const float* Cr = in;
  const float* Cl = in + C;
  const float* Ir = in + 2 * C;
  const float* Il = in + 3 * C;
  float* OCr = adj;
  float* OCl = adj + C;
  float* OIr = adj + 2 * C;
  float* OIl = adj + 3 * C;
  float* OA = adj + 4 * C;  // [w][i][dir]: adjoints of the split sums (log)
  const int len = clamp_len(lengths[b], n1);
  const int n = len + 1;
#define IX(w, i, v) ix(n1, (w), (i), (v))
  __syncthreads();

  if (IS_MAX) {
    for (int w = 0; w <= len; ++w)
      for (int c = tid; c < 2 * (n - w); c += nt) {
        const int i = c >> 1, v = c & 1;
        OCr[IX(w, i, v)] = 0.f;
        OCl[IX(w, i, v)] = 0.f;
        OIr[IX(w, i, v)] = 0.f;
        OIl[IX(w, i, v)] = 0.f;
      }
    __syncthreads();
    if (tid == 0) OCr[IX(len, 0, NC)] = 1.f;
    __syncthreads();
    for (int w = len; w >= 1; --w) {
      const int ncell = n - w;
      // marked complete spans of width w mark the parts of every best split
      for (int c = tid; c < 2 * ncell; c += nt) {
        const int i = c >> 1, v = c & 1;
        if (OCl[IX(w, i, v)] > 0.f) {
          const float best = Cl[IX(w, i, v)];
          for (int t = 0; t < w; ++t)
            if (Il[IX(w - t, i + t, v)] + Cl[IX(t, i, NC)] == best) {
              OIl[IX(w - t, i + t, v)] = 1.f;
              OCl[IX(t, i, NC)] = 1.f;
            }
        }
        if (OCr[IX(w, i, v)] > 0.f) {
          const float best = Cr[IX(w, i, v)];
          for (int t = 0; t < w; ++t)
            if (Ir[IX(t + 1, i, v)] + Cr[IX(w - 1 - t, i + 1 + t, NC)] == best) {
              OIr[IX(t + 1, i, v)] = 1.f;
              OCr[IX(w - 1 - t, i + 1 + t, NC)] = 1.f;
            }
        }
      }
      __syncthreads();
      // incomplete spans of width w: arc indicators, then their children
      for (int i = tid; i < ncell; i += nt) {
        float fl[2], fr[2];
        for (int v = 0; v < 2; ++v) {
          fl[v] = OIl[IX(w, i, v)];
          fr[v] = OIr[IX(w, i, v)];
          GA[((i + w) * n1 + i) * 2 + v] = go * fl[v];
          GA[(i * n1 + i + w) * 2 + v] = go * fr[v];
        }
        if (fl[0] > 0.f || fl[1] > 0.f) {
          float best = -INFINITY;
          for (int t = 0; t < w; ++t)
            best = fmaxf(best, Cr[IX(t, i, NC)] + Cl[IX(w - 1 - t, i + 1 + t, HC)]);
          for (int t = 0; t < w; ++t)
            if (Cr[IX(t, i, NC)] + Cl[IX(w - 1 - t, i + 1 + t, HC)] == best) {
              OCr[IX(t, i, NC)] = 1.f;
              OCl[IX(w - 1 - t, i + 1 + t, HC)] = 1.f;
            }
        }
        if (fr[0] > 0.f || fr[1] > 0.f) {
          float best = -INFINITY;
          for (int t = 0; t < w; ++t)
            best = fmaxf(best, Cr[IX(t, i, HC)] + Cl[IX(w - 1 - t, i + 1 + t, NC)]);
          for (int t = 0; t < w; ++t)
            if (Cr[IX(t, i, HC)] + Cl[IX(w - 1 - t, i + 1 + t, NC)] == best) {
              OCr[IX(t, i, HC)] = 1.f;
              OCl[IX(w - 1 - t, i + 1 + t, NC)] = 1.f;
            }
        }
      }
      __syncthreads();
    }
    for (int c = tid; c < 2 * n; c += nt) {
      const int i = c >> 1, v = c & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] = go * OCr[IX(0, i, v)];
      GD[dec_idx(i, LEFT, v, STOP)] = go * OCl[IX(0, i, v)];
    }
  } else {
    const float total = logz[b];
    for (int w = len; w >= 0; --w) {
      const int ncell = n - w;
      // adjoints of the complete spans of width w (consumers are wider)
      for (int c = tid; c < 2 * ncell; c += nt) {
        const int i = c >> 1, v = c & 1;
        Lse ocl, ocr;
        if (v == NC) {
          for (int W = w + 1; W <= len - i; ++W)
            for (int u = 0; u < 2; ++u)
              ocl.add(OCl[IX(W, i, u)] + Il[IX(W - w, i + w, u)]);
          for (int j = 0; j < i; ++j) {
            ocl.add(OA[IX(w + i - j, j, RIGHT)] + Cr[IX(i - 1 - j, j, HC)]);
            for (int u = 0; u < 2; ++u)
              ocr.add(OCr[IX(w + i - j, j, u)] + Ir[IX(i - j, j, u)]);
          }
          for (int W = w + 1; W <= len - i; ++W)
            ocr.add(OA[IX(W, i, LEFT)] + Cl[IX(W - 1 - w, i + 1 + w, HC)]);
          if (w == len && i == 0) ocr.add(0.f);
        } else {
          for (int j = 0; j < i; ++j)
            ocl.add(OA[IX(w + i - j, j, LEFT)] + Cr[IX(i - 1 - j, j, NC)]);
          for (int W = w + 1; W <= len - i; ++W)
            ocr.add(OA[IX(W, i, RIGHT)] + Cl[IX(W - 1 - w, i + 1 + w, NC)]);
        }
        OCl[IX(w, i, v)] = ocl.get();
        // a root-headed span shorter than the sentence was masked forward
        OCr[IX(w, i, v)] = (i == 0 && w >= 1 && w != len) ? kNegInf : ocr.get();
      }
      __syncthreads();
      if (w == 0) break;
      // adjoints of the incomplete spans of width w, then of the split sums
      for (int i = tid; i < ncell; i += nt) {
        Lse al, ar;
        for (int v = 0; v < 2; ++v) {
          Lse oil, oir;
          for (int j = 0; j <= i; ++j)
            oil.add(OCl[IX(w + i - j, j, v)] + Cl[IX(i - j, j, NC)]);
          for (int W = w; W <= len - i; ++W)
            oir.add(OCr[IX(W, i, v)] + Cr[IX(W - w, i + w, NC)]);
          const float ol = oil.get(), orr = oir.get();
          OIl[IX(w, i, v)] = ol;
          OIr[IX(w, i, v)] = orr;
          const float il = Il[IX(w, i, v)], ir = Ir[IX(w, i, v)];
          GA[((i + w) * n1 + i) * 2 + v] = go * expf(il + ol - total);
          GA[(i * n1 + i + w) * 2 + v] = go * expf(ir + orr - total);
          al.add(ol + (AT[((i + w) * n1 + i) * 2 + v] + D[dec_idx(i + w, LEFT, v, GO)]));
          ar.add(orr + (AT[(i * n1 + i + w) * 2 + v] + D[dec_idx(i, RIGHT, v, GO)]));
        }
        OA[IX(w, i, LEFT)] = al.get();
        OA[IX(w, i, RIGHT)] = ar.get();
      }
      __syncthreads();
    }
    for (int c = tid; c < 2 * n; c += nt) {
      const int i = c >> 1, v = c & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] =
          go * expf(Cr[IX(0, i, v)] + OCr[IX(0, i, v)] - total);
      GD[dec_idx(i, LEFT, v, STOP)] =
          go * expf(Cl[IX(0, i, v)] + OCl[IX(0, i, v)] - total);
    }
  }
  __syncthreads();
  // GO decisions are shared by every arc of a head in one direction
  for (int c = tid; c < 4 * n; c += nt) {
    const int h = c >> 2, dir = (c >> 1) & 1, v = c & 1;
    float s = 0.f;
    if (dir == LEFT)
      for (int ch = 0; ch < h; ++ch) s += GA[(h * n1 + ch) * 2 + v];
    else
      for (int ch = h + 1; ch < n; ++ch) s += GA[(h * n1 + ch) * 2 + v];
    GD[dec_idx(h, dir, v, GO)] = s;
  }
#undef IX
}

template <bool IS_MAX>
cudaError_t launch(const float* dec, const float* attach, const int* lengths,
                   const float* gout, const float* logz, const float* charts, float* g_dec,
                   float* g_attach, float* scratch, int B, int n1, int use_smem,
                   cudaStream_t s) {
  const int smem = use_smem ? 72 * n1 * n1 : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dmv_outside_kernel<IS_MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // a width has at most 2*n1 cells: a warp serves n1 <= 16, two n1 <= 32
  const int threads = n1 <= 16 ? 32 : (n1 <= 32 ? 64 : kMaxThreads);
  dmv_outside_kernel<IS_MAX><<<B, threads, smem, s>>>(dec, attach, lengths, gout, logz,
                                                      charts, g_dec, g_attach, scratch, n1,
                                                      use_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dec [B,n1,2,2,2], attach [B,n1,n1,2], gout [B], logz [B], charts
// [B,4,n1,n1,2] f32 and lengths [B] i32 in; g_dec, g_attach like dec and
// attach out. With use_smem the block keeps 72*n1*n1 bytes of dynamic shared
// memory; otherwise `scratch` holds B*40*n1*n1 bytes. Returns
// cudaGetLastError().
int dmv_outside_launch(const float* dec, const float* attach, const int* lengths,
                       const float* gout, const float* logz, const float* charts,
                       float* g_dec, float* g_attach, float* scratch, int B, int n1,
                       int is_max, int use_smem, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = is_max ? launch<true>(dec, attach, lengths, gout, logz, charts, g_dec,
                                        g_attach, scratch, B, n1, use_smem, s)
                         : launch<false>(dec, attach, lengths, gout, logz, charts, g_dec,
                                         g_attach, scratch, B, n1, use_smem, s);
  return (int)e;
}

}  // extern "C"
