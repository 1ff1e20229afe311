// Fused DMV inside + outside pass, one thread block per sentence.
//
// Replaces the TPU kernel `_fused_kernel` of vlgae_tpu/ops/dmv_pallas.py
// (inside fill `_inside_fill_v3`, outside `_outside_fill`) for every
// n1 >= 1: the caller that wants the total and both tables at once, for a
// cotangent of one. The value-only inside pass and the two-launch pair
// (inside with saved charts, then outside with a later cotangent) are
// kernels of their own: dmv_inside.cu and dmv_outside.cu.
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
// Bound: latency, not bytes or FLOPs. A sentence of length 50 is ~2*51
// dependent width steps per pass with O(n) work per cell; the design keeps
// all charts of a block in shared memory when they fit (n1 <= 56 on H100)
// and in a global scratch buffer (L2-resident at the eval batch) otherwise.
//
// Chart layout (per sentence): X[(w*n1 + i)*2 + v], span [i, i+w].
// Scratch per sentence: 9 float charts: Cr, Cl, Ir, Il, their adjoints
// (log) or on-best-tree flags (max), and A[w][i][dir], the split sums of
// the incomplete spans before the arc score (max: their values; log: their
// adjoints). Bytes per sentence: 72 * n1 * n1.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e12f;  // semiring zero of the reference
constexpr int HC = 0, NC = 1;      // valence HASCHILD / NOCHILD
constexpr int LEFT = 0, RIGHT = 1;
constexpr int GO = 0, STOP = 1;
constexpr int kThreads = 128;

__device__ __forceinline__ int dec_idx(int h, int dir, int v, int d) {
  return ((h * 2 + dir) * 2 + v) * 2 + d;
}

// Online logsumexp accumulator.
struct Lse {
  float m = -INFINITY;
  float s = 0.f;
  __device__ __forceinline__ void add(float x) {
    if (x > m) {
      s = s * expf(m - x) + 1.f;
      m = x;
    } else {
      s += expf(x - m);
    }
  }
  __device__ __forceinline__ float get() const {
    return s > 0.f ? m + logf(s) : kNegInf;
  }
};


template <bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
dmv_fused_kernel(const float* __restrict__ dec, const float* __restrict__ attach,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 float* __restrict__ g_dec, float* __restrict__ g_attach,
                 unsigned char* __restrict__ scratch, int n1, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t C = (size_t)n1 * n1 * 2;
  unsigned char* base =
      use_smem ? smem_raw : scratch + (size_t)b * 72 * (size_t)n1 * n1;
  float* f = reinterpret_cast<float*>(base);
  float* Cr = f;
  float* Cl = f + C;
  float* Ir = f + 2 * C;
  float* Il = f + 3 * C;
  float* OCr = f + 4 * C;
  float* OCl = f + 5 * C;
  float* OIr = f + 6 * C;
  float* OIl = f + 7 * C;
  float* OA = f + 8 * C;  // [w][i][dir]: max: A values, log: A adjoints

  const float* D = dec + (size_t)b * n1 * 8;
  const float* AT = attach + (size_t)b * n1 * n1 * 2;
  float* GD = g_dec + (size_t)b * n1 * 8;
  float* GA = g_attach + (size_t)b * n1 * n1 * 2;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > n1 - 1 ? n1 - 1 : len);
  const int n = len + 1;
#define IX(w, i, v) ((((w) * n1) + (i)) * 2 + (v))

  for (int k = tid; k < n1 * 8; k += nt) GD[k] = 0.f;
  for (int k = tid; k < n1 * n1 * 2; k += nt) GA[k] = 0.f;
  for (int c = tid; c < 2 * n; c += nt) {
    const int i = c >> 1, v = c & 1;
    Cr[IX(0, i, v)] = D[dec_idx(i, RIGHT, v, STOP)];
    Cl[IX(0, i, v)] = D[dec_idx(i, LEFT, v, STOP)];
  }
  __syncthreads();

  // ------------------------------------------------------------ inside
  for (int w = 1; w <= len; ++w) {
    const int ncell = n - w;
    for (int i = tid; i < ncell; i += nt) {
      float al, ar;
      if (IS_MAX) {
        al = ar = -INFINITY;
        for (int t = 0; t < w; ++t) {
          const float* cr = Cr + IX(t, i, 0);
          const float* cl = Cl + IX(w - 1 - t, i + 1 + t, 0);
          al = fmaxf(al, cr[NC] + cl[HC]);
          ar = fmaxf(ar, cr[HC] + cl[NC]);
        }
        OA[IX(w, i, LEFT)] = al;
        OA[IX(w, i, RIGHT)] = ar;
      } else {
        Lse l, r;
        for (int t = 0; t < w; ++t) {
          const float* cr = Cr + IX(t, i, 0);
          const float* cl = Cl + IX(w - 1 - t, i + 1 + t, 0);
          l.add(cr[NC] + cl[HC]);
          r.add(cr[HC] + cl[NC]);
        }
        al = l.get();
        ar = r.get();
      }
      for (int v = 0; v < 2; ++v) {
        Il[IX(w, i, v)] = al + (AT[((i + w) * n1 + i) * 2 + v] +
                                D[dec_idx(i + w, LEFT, v, GO)]);
        Ir[IX(w, i, v)] = ar + (AT[(i * n1 + i + w) * 2 + v] +
                                D[dec_idx(i, RIGHT, v, GO)]);
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * ncell; c += nt) {
      const int i = c >> 1, v = c & 1;
      float cl, cr;
      if (IS_MAX) {
        cl = cr = -INFINITY;
        for (int t = 0; t < w; ++t) {
          cl = fmaxf(cl, Il[IX(w - t, i + t, v)] + Cl[IX(t, i, NC)]);
          cr = fmaxf(cr, Ir[IX(t + 1, i, v)] + Cr[IX(w - 1 - t, i + 1 + t, NC)]);
        }
      } else {
        Lse l, r;
        for (int t = 0; t < w; ++t) {
          l.add(Il[IX(w - t, i + t, v)] + Cl[IX(t, i, NC)]);
          r.add(Ir[IX(t + 1, i, v)] + Cr[IX(w - 1 - t, i + 1 + t, NC)]);
        }
        cl = l.get();
        cr = r.get();
      }
      if (i == 0 && w != len) cr = kNegInf;  // single root
      Cl[IX(w, i, v)] = cl;
      Cr[IX(w, i, v)] = cr;
    }
    __syncthreads();
  }
  const float total = Cr[IX(len, 0, NC)];
  if (tid == 0) out[b] = total;

  // ----------------------------------------------------------- outside
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
          GA[((i + w) * n1 + i) * 2 + v] = fl[v];
          GA[(i * n1 + i + w) * 2 + v] = fr[v];
        }
        if (fl[0] > 0.f || fl[1] > 0.f) {
          const float best = OA[IX(w, i, LEFT)];
          for (int t = 0; t < w; ++t)
            if (Cr[IX(t, i, NC)] + Cl[IX(w - 1 - t, i + 1 + t, HC)] == best) {
              OCr[IX(t, i, NC)] = 1.f;
              OCl[IX(w - 1 - t, i + 1 + t, HC)] = 1.f;
            }
        }
        if (fr[0] > 0.f || fr[1] > 0.f) {
          const float best = OA[IX(w, i, RIGHT)];
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
      GD[dec_idx(i, RIGHT, v, STOP)] = OCr[IX(0, i, v)];
      GD[dec_idx(i, LEFT, v, STOP)] = OCl[IX(0, i, v)];
    }
  } else {
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
      // adjoints of the incomplete spans of width w, then of A_l / A_r
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
          GA[((i + w) * n1 + i) * 2 + v] = expf(il + ol - total);
          GA[(i * n1 + i + w) * 2 + v] = expf(ir + orr - total);
          al.add(ol + (AT[((i + w) * n1 + i) * 2 + v] +
                       D[dec_idx(i + w, LEFT, v, GO)]));
          ar.add(orr + (AT[(i * n1 + i + w) * 2 + v] +
                        D[dec_idx(i, RIGHT, v, GO)]));
        }
        OA[IX(w, i, LEFT)] = al.get();
        OA[IX(w, i, RIGHT)] = ar.get();
      }
      __syncthreads();
    }
    for (int c = tid; c < 2 * n; c += nt) {
      const int i = c >> 1, v = c & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] = expf(Cr[IX(0, i, v)] + OCr[IX(0, i, v)] - total);
      GD[dec_idx(i, LEFT, v, STOP)] = expf(Cl[IX(0, i, v)] + OCl[IX(0, i, v)] - total);
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

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on device 0.
int dmv_fused_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// dec [B,n1,2,2,2] f32, attach [B,n1,n1,2] f32, lengths [B] i32 (all
// contiguous, on the device); out [B], g_dec, g_attach like the inputs.
// With use_smem the charts live in dynamic shared memory (72*n1*n1 bytes),
// otherwise in `scratch` (B*72*n1*n1 bytes). Returns cudaGetLastError().
int dmv_fused_launch(const float* dec, const float* attach, const int* lengths,
                     float* out, float* g_dec, float* g_attach, void* scratch,
                     int B, int n1, int is_max, int use_smem, void* stream) {
  if (B <= 0) return 0;
  const int smem = use_smem ? 72 * n1 * n1 : 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned char* scr = reinterpret_cast<unsigned char*>(scratch);
  if (is_max) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(dmv_fused_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    dmv_fused_kernel<true><<<B, kThreads, smem, s>>>(dec, attach, lengths, out, g_dec,
                                                     g_attach, scr, n1, use_smem);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(dmv_fused_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    dmv_fused_kernel<false><<<B, kThreads, smem, s>>>(dec, attach, lengths, out, g_dec,
                                                      g_attach, scr, n1, use_smem);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
