// Shared pieces of the separate DMV inside and outside kernels
// (dmv_inside.cu, dmv_outside.cu): constants of the reference, the online
// logsumexp, and the width-ascending inside fill. The arithmetic and its
// order are those of the fused kernel (dmv_fused.cu), so the three agree
// on totals and, in the max semiring, on the exact tie tests.
//
// Chart layout (per sentence), the one the saved charts use in global
// memory too: four float charts Cr, Cl, Ir, Il, each [n1][n1][2] indexed
// X[(w*n1 + i)*2 + v] for the span [i, i+w] with valence v, so a sentence
// is [4][n1][n1][2] floats (32*n1*n1 bytes). Cells outside the span
// triangle (i + w > len, and the width-0 row of Ir/Il) hold the semiring
// zero -1e12 in a saved chart.

#pragma once

#include <cuda_runtime.h>

namespace dmv {

constexpr float kNegInf = -1e12f;  // semiring zero of the reference
constexpr int HC = 0, NC = 1;      // valence HASCHILD / NOCHILD
constexpr int LEFT = 0, RIGHT = 1;
constexpr int GO = 0, STOP = 1;

__device__ __forceinline__ int dec_idx(int h, int dir, int v, int d) {
  return ((h * 2 + dir) * 2 + v) * 2 + d;
}

__device__ __forceinline__ int ix(int n1, int w, int i, int v) {
  return ((w * n1) + i) * 2 + v;
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

// Barrier of the threads that share one sentence: a warp or a block.
template <bool WARP>
__device__ __forceinline__ void sync_group() {
  if (WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ int clamp_len(int len, int n1) {
  return len < 0 ? 0 : (len > n1 - 1 ? n1 - 1 : len);
}

// Fills the valid cells of Cr/Cl/Ir/Il for one sentence of `len` words
// (n = len + 1 positions, root first), by `nt` threads of which this is
// `tid`. D = dec [n1][2][2][2], AT = attach [n1][n1][2]. Ends with a
// barrier, so every thread may read any cell afterwards.
template <bool IS_MAX, bool WARP>
__device__ __forceinline__ void inside_fill(float* Cr, float* Cl, float* Ir, float* Il,
                                            const float* __restrict__ D,
                                            const float* __restrict__ AT, int n1, int len,
                                            int tid, int nt) {
  const int n = len + 1;
  for (int c = tid; c < 2 * n; c += nt) {
    const int i = c >> 1, v = c & 1;
    Cr[ix(n1, 0, i, v)] = D[dec_idx(i, RIGHT, v, STOP)];
    Cl[ix(n1, 0, i, v)] = D[dec_idx(i, LEFT, v, STOP)];
  }
  sync_group<WARP>();
  for (int w = 1; w <= len; ++w) {
    const int ncell = n - w;
    for (int i = tid; i < ncell; i += nt) {
      float al, ar;
      if (IS_MAX) {
        al = ar = -INFINITY;
        for (int t = 0; t < w; ++t) {
          const float* cr = Cr + ix(n1, t, i, 0);
          const float* cl = Cl + ix(n1, w - 1 - t, i + 1 + t, 0);
          al = fmaxf(al, cr[NC] + cl[HC]);
          ar = fmaxf(ar, cr[HC] + cl[NC]);
        }
      } else {
        Lse l, r;
        for (int t = 0; t < w; ++t) {
          const float* cr = Cr + ix(n1, t, i, 0);
          const float* cl = Cl + ix(n1, w - 1 - t, i + 1 + t, 0);
          l.add(cr[NC] + cl[HC]);
          r.add(cr[HC] + cl[NC]);
        }
        al = l.get();
        ar = r.get();
      }
      for (int v = 0; v < 2; ++v) {
        Il[ix(n1, w, i, v)] = al + (AT[((i + w) * n1 + i) * 2 + v] +
                                    D[dec_idx(i + w, LEFT, v, GO)]);
        Ir[ix(n1, w, i, v)] = ar + (AT[(i * n1 + i + w) * 2 + v] +
                                    D[dec_idx(i, RIGHT, v, GO)]);
      }
    }
    sync_group<WARP>();
    for (int c = tid; c < 2 * ncell; c += nt) {
      const int i = c >> 1, v = c & 1;
      float cl, cr;
      if (IS_MAX) {
        cl = cr = -INFINITY;
        for (int t = 0; t < w; ++t) {
          cl = fmaxf(cl, Il[ix(n1, w - t, i + t, v)] + Cl[ix(n1, t, i, NC)]);
          cr = fmaxf(cr, Ir[ix(n1, t + 1, i, v)] + Cr[ix(n1, w - 1 - t, i + 1 + t, NC)]);
        }
      } else {
        Lse l, r;
        for (int t = 0; t < w; ++t) {
          l.add(Il[ix(n1, w - t, i + t, v)] + Cl[ix(n1, t, i, NC)]);
          r.add(Ir[ix(n1, t + 1, i, v)] + Cr[ix(n1, w - 1 - t, i + 1 + t, NC)]);
        }
        cl = l.get();
        cr = r.get();
      }
      if (i == 0 && w != len) cr = kNegInf;  // single root
      Cl[ix(n1, w, i, v)] = cl;
      Cr[ix(n1, w, i, v)] = cr;
    }
    sync_group<WARP>();
  }
}

}  // namespace dmv
