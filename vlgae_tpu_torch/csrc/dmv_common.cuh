// Shared pieces of the DMV chart kernels (dmv_fused.cu, dmv_inside.cu,
// dmv_outside.cu): constants of the reference, the lane-parallel semiring
// sums, the width-ascending inside fill and the width-descending outside
// fill. The three kernels run the same device code, so they agree on totals
// and, in the max semiring, on the exact tie tests.
//
// Work mapping. The threads of a sentence (a block, or a warp for tiny
// charts) are cut into groups of G consecutive lanes, G a power of two
// chosen per width and phase so that cells x G fills the threads
// (`lanes_per_task`). A group owns one chart cell and its lanes stride over
// the cell's terms. A logsumexp takes two passes: the maximum of the terms
// (lane-local, then an xor-butterfly of shuffles), then independent
// exp(term - max) summed the same way, and one log per cell, so no exp waits
// for another. The butterflies are fixed trees and every lane of a group ends
// with the same bits; there are no atomics, so reruns are bit-identical.
// fmaxf over one set of float sums is order-free, so the max semiring gives
// the bits a serial walk gives; the sums inside a term are never
// reassociated.
//
// Chart layout (per sentence): four float charts Cr, Cl, Ir, Il, each
// [n1][pitch][2] indexed X[(w*pitch + i)*2 + v] for the span [i, i+w] with
// valence v. In a SAVED chart (global memory, the hand-off between
// dmv_inside.cu and dmv_outside.cu) pitch = n1, so a sentence is
// [4][n1][n1][2] floats, and cells outside the span triangle (i + w > len,
// and the width-0 row of Ir/Il) hold the semiring zero -1e12. In shared
// memory pitch = n1 | 1: the lanes of one cell read cells a row apart, and a
// row of an odd number of float pairs puts 16 consecutive rows on 16
// different pairs of banks (a multiple of 16 pairs would put them on one).

#pragma once

#include <cuda_runtime.h>

namespace dmv {

constexpr float kNegInf = -1e12f;  // semiring zero of the reference
constexpr int HC = 0, NC = 1;      // valence HASCHILD / NOCHILD
constexpr int LEFT = 0, RIGHT = 1;
constexpr int GO = 0, STOP = 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int dec_idx(int h, int dir, int v, int d) {
  return ((h * 2 + dir) * 2 + v) * 2 + d;
}

__device__ __forceinline__ int ix(int pitch, int w, int i, int v) {
  return ((w * pitch) + i) * 2 + v;
}

// Row pitch (positions) of a chart kept in shared memory.
__device__ __host__ __forceinline__ int smem_pitch(int n1) { return n1 | 1; }

// Both valences of one cell: .x = HASCHILD, .y = NOCHILD.
__device__ __forceinline__ float2 ld2(const float* X, int pitch, int w, int i) {
  return *reinterpret_cast<const float2*>(X + ix(pitch, w, i, 0));
}

// Barrier of the `nt` threads that fill one sentence's inside charts: a
// warp, or the first nt threads (whole warps) of a block on a named barrier
// of their own, so that a block may run the inside fill on fewer threads than
// it has (the rest wait at the block's next __syncthreads()).
template <bool WARP>
__device__ __forceinline__ void sync_group(int nt) {
  if (WARP) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
  }
}

__device__ __forceinline__ int clamp_len(int len, int n1) {
  return len < 0 ? 0 : (len > n1 - 1 ? n1 - 1 : len);
}

// Lanes per task, as log2: G = 1 << lg is the largest power of two, at most
// a warp, with ntasks * G <= nt, and no wider than the terms need. Uniform
// over the sentence's threads, which split into groups by shifts (nt is a
// power of two), not by divisions.
__device__ __forceinline__ int lanes_per_task(int ntasks, int nterms, int nt) {
  int lg = 0;
  while (lg < 5 && (2 << lg) * ntasks <= nt && (1 << lg) < nterms) ++lg;
  return lg;
}

// Xor-butterflies over the G lanes of a group (every lane of the warp calls
// them; every lane of a group gets the same bits).
__device__ __forceinline__ float group_max(float x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// log of a sum of exp(term - m) terms: s == 0 is the empty sum.
__device__ __forceinline__ float lse_get(float m, float s) {
  return s > 0.f ? m + logf(s) : kNegInf;
}

// Fills the valid cells of Cr/Cl/Ir/Il for one sentence of `len` words
// (n = len + 1 positions, root first), by `nt` threads (a power of two, whole
// warps) of which this is `tid`. D = dec [n1][2][2][2], AT = attach
// [n1][n1][2]. With `A` (or nullptr) the split sums of the incomplete spans
// before the arc score are kept in A[w][i][dir]. Ends with a barrier of these
// nt threads, so each of them may read any cell afterwards.
template <bool IS_MAX, bool WARP>
__device__ __forceinline__ void inside_fill(float* Cr, float* Cl, float* Ir, float* Il,
                                            float* A, const float* __restrict__ D,
                                            const float* __restrict__ AT, int n1, int p,
                                            int len, int tid, int nt) {
  const int n = len + 1;
  for (int c = tid; c < 2 * n; c += nt) {
    const int i = c >> 1, v = c & 1;
    Cr[ix(p, 0, i, v)] = D[dec_idx(i, RIGHT, v, STOP)];
    Cl[ix(p, 0, i, v)] = D[dec_idx(i, LEFT, v, STOP)];
  }
  sync_group<WARP>(nt);
  for (int w = 1; w <= len; ++w) {
    const int ncell = n - w;
    {
      // incomplete spans [i, i+w]: one task per i, w split points
      const int lg = lanes_per_task(ncell, w, nt), G = 1 << lg;
      const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
      for (int t0 = 0; t0 < ncell; t0 += ngroups) {
        const int i = t0 + gid;
        const bool active = i < ncell;
        float ml = -INFINITY, mr = -INFINITY;
        // the arc scores come from global memory: ask for them before the
        // sums, not after
        float arc_l[2] = {0.f, 0.f}, arc_r[2] = {0.f, 0.f};
        if (active && gl == 0)
          for (int v = 0; v < 2; ++v) {
            arc_l[v] = AT[((i + w) * n1 + i) * 2 + v] + D[dec_idx(i + w, LEFT, v, GO)];
            arc_r[v] = AT[(i * n1 + i + w) * 2 + v] + D[dec_idx(i, RIGHT, v, GO)];
          }
        if (active) {
#pragma unroll 4
          for (int t = gl; t < w; t += G) {
            const float2 cr = ld2(Cr, p, t, i);
            const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
            ml = fmaxf(ml, cr.y + cl.x);
            mr = fmaxf(mr, cr.x + cl.y);
          }
        }
        ml = group_max(ml, G);
        mr = group_max(mr, G);
        float al = ml, ar = mr;
        if (!IS_MAX) {
          float sl = 0.f, sr = 0.f;
          if (active) {
#pragma unroll 4
            for (int t = gl; t < w; t += G) {
              const float2 cr = ld2(Cr, p, t, i);
              const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
              sl += expf((cr.y + cl.x) - ml);
              sr += expf((cr.x + cl.y) - mr);
            }
          }
          al = lse_get(ml, group_sum(sl, G));
          ar = lse_get(mr, group_sum(sr, G));
        }
        if (active && gl == 0) {
          if (A != nullptr) {
            A[ix(p, w, i, LEFT)] = al;
            A[ix(p, w, i, RIGHT)] = ar;
          }
          for (int v = 0; v < 2; ++v) {
            Il[ix(p, w, i, v)] = al + arc_l[v];
            Ir[ix(p, w, i, v)] = ar + arc_r[v];
          }
        }
      }
    }
    sync_group<WARP>(nt);
    {
      // complete spans: one task per (i, v), w split points
      const int ntask = 2 * ncell;
      const int lg = lanes_per_task(ntask, w, nt), G = 1 << lg;
      const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
      for (int t0 = 0; t0 < ntask; t0 += ngroups) {
        const int c = t0 + gid;
        const bool active = c < ntask;
        const int i = c >> 1, v = c & 1;
        float ml = -INFINITY, mr = -INFINITY;
        if (active) {
#pragma unroll 4
          for (int t = gl; t < w; t += G) {
            ml = fmaxf(ml, Il[ix(p, w - t, i + t, v)] + Cl[ix(p, t, i, NC)]);
            mr = fmaxf(mr, Ir[ix(p, t + 1, i, v)] + Cr[ix(p, w - 1 - t, i + 1 + t, NC)]);
          }
        }
        ml = group_max(ml, G);
        mr = group_max(mr, G);
        float cl = ml, cr = mr;
        if (!IS_MAX) {
          float sl = 0.f, sr = 0.f;
          if (active) {
#pragma unroll 4
            for (int t = gl; t < w; t += G) {
              sl += expf((Il[ix(p, w - t, i + t, v)] + Cl[ix(p, t, i, NC)]) - ml);
              sr += expf((Ir[ix(p, t + 1, i, v)] + Cr[ix(p, w - 1 - t, i + 1 + t, NC)]) - mr);
            }
          }
          cl = lse_get(ml, group_sum(sl, G));
          cr = lse_get(mr, group_sum(sr, G));
        }
        if (active && gl == 0) {
          if (i == 0 && w != len) cr = kNegInf;  // single root
          Cl[ix(p, w, i, v)] = cl;
          Cr[ix(p, w, i, v)] = cr;
        }
      }
    }
    sync_group<WARP>(nt);
  }
}

struct OutsideCharts {
  const float *Cr, *Cl, *Ir, *Il;
  float *OCr, *OCl, *OIr, *OIl, *OA;
  int p;
};

// Step k of the walk over the consumers of the complete spans [i, i+w] of
// both valences (log semiring); every (i, w) has len - w steps (plus the
// seed). A step reads two cell pairs and gives up to two terms, .x for the
// HASCHILD adjoint and .y for the NOCHILD one (-inf where there is none).
//   left (OCl): the nW = len-i-w spans [i, i+W] that the span closes on the
//     left (NOCHILD only, both valences u of the wider span: two terms, the
//     second returned in `extra`), then the arcs from j < i over it:
//     right-headed for NOCHILD, left-headed for HASCHILD;
//   right (OCr): the arcs of i over the nW wider spans (left-headed for
//     NOCHILD, right-headed for HASCHILD), then the i spans [j, i+w] it
//     closes on the right (NOCHILD only, two terms), then the seed.
__device__ __forceinline__ float2 complete_adjoint_step(const OutsideCharts& c, bool right,
                                                        int w, int i, int len, int k,
                                                        float& extra) {
  const int p = c.p;
  const int nW = len - i - w;
  extra = -INFINITY;
  if (!right) {
    if (k < nW) {
      const int W = w + 1 + k;
      const float2 o = ld2(c.OCl, p, W, i), in = ld2(c.Il, p, W - w, i + w);
      extra = o.y + in.y;
      return make_float2(-INFINITY, o.x + in.x);
    }
    const int j = k - nW;
    const float2 oa = ld2(c.OA, p, w + i - j, j), cr = ld2(c.Cr, p, i - 1 - j, j);
    return make_float2(oa.x + cr.y, oa.y + cr.x);  // HC: LEFT+NC, NC: RIGHT+HC
  }
  if (k < nW) {
    const int W = w + 1 + k;
    const float2 oa = ld2(c.OA, p, W, i), cl = ld2(c.Cl, p, W - 1 - w, i + 1 + w);
    return make_float2(oa.y + cl.y, oa.x + cl.x);  // HC: RIGHT+NC, NC: LEFT+HC
  }
  const int j = k - nW;
  if (j < i) {
    const float2 o = ld2(c.OCr, p, w + i - j, j), in = ld2(c.Ir, p, i - j, j);
    extra = o.y + in.y;
    return make_float2(-INFINITY, o.x + in.x);
  }
  return make_float2(-INFINITY, 0.f);  // the seed: d total / d Cr[len, 0, NC] = 1
}

// The outside pass of one sentence over filled inside charts: writes
// go * d total / d dec into GD [n1][2][2][2] and / d attach into GA
// [n1][n1][2] (both zeroed by the caller, a barrier before this call), by
// `nt` threads (a power of two >= 32, whole warps). OC*/OI*/OA are scratch
// charts of the inside charts' pitch. Log semiring: width-descending pull
// form, every adjoint cell a logsumexp over its consumers, gradients
// go * exp(inside + outside - total). Max semiring: walks the best
// derivations top-down and marks a split of a marked cell when its parts add
// up exactly to the cell's value, with the inside pass's own float addition;
// the split sums of the incomplete spans are read from OA when
// `a_from_inside` (the fused kernel keeps them) and recomputed, in any order
// (fmaxf), otherwise. Ends with every thread able to return.
template <bool IS_MAX>
__device__ __forceinline__ void outside_fill(const OutsideCharts& c, bool a_from_inside,
                                             const float* __restrict__ D,
                                             const float* __restrict__ AT, float* GD,
                                             float* GA, int n1, int len, float total,
                                             float go, int tid, int nt) {
  const int p = c.p;
  const int n = len + 1;
  const float *Cr = c.Cr, *Cl = c.Cl, *Ir = c.Ir, *Il = c.Il;
  float *OCr = c.OCr, *OCl = c.OCl, *OIr = c.OIr, *OIl = c.OIl, *OA = c.OA;
  if (IS_MAX) {
    for (int w = 0; w <= len; ++w)
      for (int k = tid; k < 2 * (n - w); k += nt) {
        const int i = k >> 1, v = k & 1;
        OCr[ix(p, w, i, v)] = 0.f;
        OCl[ix(p, w, i, v)] = 0.f;
        OIr[ix(p, w, i, v)] = 0.f;
        OIl[ix(p, w, i, v)] = 0.f;
      }
    __syncthreads();
    if (tid == 0) OCr[ix(p, len, 0, NC)] = 1.f;
    __syncthreads();
    for (int w = len; w >= 1; --w) {
      const int ncell = n - w;
      {
        // marked complete spans of width w mark the parts of every best
        // split: one task per (i, v, left/right), w split points
        const int ntask = 4 * ncell;
        const int lg = lanes_per_task(ntask, w, nt), G = 1 << lg;
        const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
        for (int k = gid; k < ntask; k += ngroups) {
          const int i = k >> 2, v = (k >> 1) & 1;
          if (k & 1) {
            if (OCr[ix(p, w, i, v)] > 0.f) {
              const float best = Cr[ix(p, w, i, v)];
              for (int t = gl; t < w; t += G)
                if (Ir[ix(p, t + 1, i, v)] + Cr[ix(p, w - 1 - t, i + 1 + t, NC)] == best) {
                  OIr[ix(p, t + 1, i, v)] = 1.f;
                  OCr[ix(p, w - 1 - t, i + 1 + t, NC)] = 1.f;
                }
            }
          } else if (OCl[ix(p, w, i, v)] > 0.f) {
            const float best = Cl[ix(p, w, i, v)];
            for (int t = gl; t < w; t += G)
              if (Il[ix(p, w - t, i + t, v)] + Cl[ix(p, t, i, NC)] == best) {
                OIl[ix(p, w - t, i + t, v)] = 1.f;
                OCl[ix(p, t, i, NC)] = 1.f;
              }
          }
        }
      }
      __syncthreads();
      {
        // incomplete spans of width w: arc indicators, then their children;
        // one task per (i, direction)
        const int ntask = 2 * ncell;
        const int lg = lanes_per_task(ntask, w, nt), G = 1 << lg;
        const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
        for (int t0 = 0; t0 < ntask; t0 += ngroups) {
          const int k = t0 + gid;
          const bool active = k < ntask;
          const int i = k >> 1, dir = k & 1;
          bool marked = false;
          if (active) {
            const float f0 = dir == LEFT ? OIl[ix(p, w, i, 0)] : OIr[ix(p, w, i, 0)];
            const float f1 = dir == LEFT ? OIl[ix(p, w, i, 1)] : OIr[ix(p, w, i, 1)];
            marked = f0 > 0.f || f1 > 0.f;
            if (gl == 0) {
              const int at = dir == LEFT ? ((i + w) * n1 + i) * 2 : (i * n1 + i + w) * 2;
              GA[at] = go * f0;
              GA[at + 1] = go * f1;
            }
          }
          // a left arc joins Cr[.., NC] and Cl[.., HC]; a right arc the
          // other valences
          const int vr = dir == LEFT ? NC : HC, vl = dir == LEFT ? HC : NC;
          float best;
          if (a_from_inside) {
            best = active ? OA[ix(p, w, i, dir)] : 0.f;
          } else {
            best = -INFINITY;
            if (marked)
              for (int t = gl; t < w; t += G)
                best = fmaxf(best, Cr[ix(p, t, i, vr)] + Cl[ix(p, w - 1 - t, i + 1 + t, vl)]);
            best = group_max(best, G);
          }
          if (marked)
            for (int t = gl; t < w; t += G)
              if (Cr[ix(p, t, i, vr)] + Cl[ix(p, w - 1 - t, i + 1 + t, vl)] == best) {
                OCr[ix(p, t, i, vr)] = 1.f;
                OCl[ix(p, w - 1 - t, i + 1 + t, vl)] = 1.f;
              }
        }
      }
      __syncthreads();
    }
    for (int k = tid; k < 2 * n; k += nt) {
      const int i = k >> 1, v = k & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] = go * OCr[ix(p, 0, i, v)];
      GD[dec_idx(i, LEFT, v, STOP)] = go * OCl[ix(p, 0, i, v)];
    }
  } else {
    for (int w = len; w >= 0; --w) {
      const int ncell = n - w;
      {
        // adjoints of the complete spans of width w (their consumers are
        // wider): one task per (i, left/right) for both valences, all
        // consumers in one walk of len - w steps
        const int ntask = 2 * ncell;
        const int lg = lanes_per_task(ntask, len - w + 1, nt), G = 1 << lg;
        const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
        for (int t0 = 0; t0 < ntask; t0 += ngroups) {
          const int k = t0 + gid;
          const bool active = k < ntask;
          const int i = k >> 1;
          const bool right = k & 1;
          const int nsteps =
              !active ? 0 : len - w + ((right && w == len && i == 0) ? 1 : 0);
          float m0 = -INFINITY, m1 = -INFINITY, extra;
#pragma unroll 4
          for (int t = gl; t < nsteps; t += G) {
            const float2 x = complete_adjoint_step(c, right, w, i, len, t, extra);
            m0 = fmaxf(m0, x.x);
            m1 = fmaxf(m1, fmaxf(x.y, extra));
          }
          m0 = group_max(m0, G);
          m1 = group_max(m1, G);
          // an adjoint without any term keeps s = 0 (exp(-inf - 0) = 0)
          const float r0 = m0 == -INFINITY ? 0.f : m0;
          const float r1 = m1 == -INFINITY ? 0.f : m1;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
          for (int t = gl; t < nsteps; t += G) {
            const float2 x = complete_adjoint_step(c, right, w, i, len, t, extra);
            // an absent term is -inf and adds exp(-inf) = 0
            s0 += expf(x.x - r0);
            s1 += expf(x.y - r1) + expf(extra - r1);
          }
          const float v0 = lse_get(m0, group_sum(s0, G));
          const float v1 = lse_get(m1, group_sum(s1, G));
          if (active && gl == 0) {
            if (right) {
              // a root-headed span shorter than the sentence was masked forward
              const bool masked = i == 0 && w >= 1 && w != len;
              OCr[ix(p, w, i, HC)] = masked ? kNegInf : v0;
              OCr[ix(p, w, i, NC)] = masked ? kNegInf : v1;
            } else {
              OCl[ix(p, w, i, HC)] = v0;
              OCl[ix(p, w, i, NC)] = v1;
            }
          }
        }
      }
      __syncthreads();
      if (w == 0) break;
      {
        // adjoints of the incomplete spans of width w, then of the split
        // sums: one task per (i, direction) for both valences
        const int ntask = 2 * ncell;
        const int lg = lanes_per_task(ntask, len - w + 1, nt), G = 1 << lg;
        const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
        for (int t0 = 0; t0 < ntask; t0 += ngroups) {
          const int k = t0 + gid;
          const bool active = k < ntask;
          const int i = k >> 1, dir = k & 1;
          // left: spans [j, i+w] closed by a left-headed Il; right: spans
          // [i, i+W] closed by a right-headed Ir
          const int nterms = !active ? 0 : (dir == LEFT ? i + 1 : len - i - w + 1);
          const int at = dir == LEFT ? ((i + w) * n1 + i) * 2 : (i * n1 + i + w) * 2;
          // the arc scores come from global memory: ask for them early
          float arc0 = 0.f, arc1 = 0.f;
          if (active && gl == 0) {
            const float* dgo = D + (dir == LEFT ? dec_idx(i + w, LEFT, 0, GO)
                                                : dec_idx(i, RIGHT, 0, GO));
            arc0 = AT[at] + dgo[0];
            arc1 = AT[at + 1] + dgo[2];
          }
          float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll 4
          for (int t = gl; t < nterms; t += G) {
            const float2 o = dir == LEFT ? ld2(OCl, p, w + i - t, t) : ld2(OCr, p, w + t, i);
            const float in = dir == LEFT ? Cl[ix(p, i - t, t, NC)] : Cr[ix(p, t, i + w, NC)];
            m0 = fmaxf(m0, o.x + in);
            m1 = fmaxf(m1, o.y + in);
          }
          m0 = group_max(m0, G);
          m1 = group_max(m1, G);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
          for (int t = gl; t < nterms; t += G) {
            const float2 o = dir == LEFT ? ld2(OCl, p, w + i - t, t) : ld2(OCr, p, w + t, i);
            const float in = dir == LEFT ? Cl[ix(p, i - t, t, NC)] : Cr[ix(p, t, i + w, NC)];
            s0 += expf((o.x + in) - m0);
            s1 += expf((o.y + in) - m1);
          }
          const float o0 = lse_get(m0, group_sum(s0, G));
          const float o1 = lse_get(m1, group_sum(s1, G));
          if (active && gl == 0) {
            const int cell = ix(p, w, i, 0);
            float* O = dir == LEFT ? OIl : OIr;
            const float* I = dir == LEFT ? Il : Ir;
            O[cell] = o0;
            O[cell + 1] = o1;
            GA[at] = go * expf(I[cell] + o0 - total);
            GA[at + 1] = go * expf(I[cell + 1] + o1 - total);
            // the adjoint of the split sum joins the two valences
            const float x = o0 + arc0;
            const float y = o1 + arc1;
            const float mm = fmaxf(x, y);
            OA[ix(p, w, i, dir)] = mm + logf(expf(x - mm) + expf(y - mm));
          }
        }
      }
      __syncthreads();
    }
    for (int k = tid; k < 2 * n; k += nt) {
      const int i = k >> 1, v = k & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] =
          go * expf(Cr[ix(p, 0, i, v)] + OCr[ix(p, 0, i, v)] - total);
      GD[dec_idx(i, LEFT, v, STOP)] =
          go * expf(Cl[ix(p, 0, i, v)] + OCl[ix(p, 0, i, v)] - total);
    }
  }
  __syncthreads();
  {
    // GO decisions are shared by every arc of a head in one direction: one
    // task per (head, direction, valence), a fixed tree over its arcs
    const int ntask = 4 * n;
    const int lg = lanes_per_task(ntask, n, nt), G = 1 << lg;
    const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
    for (int t0 = 0; t0 < ntask; t0 += ngroups) {
      const int k = t0 + gid;
      const bool active = k < ntask;
      const int h = k >> 2, dir = (k >> 1) & 1, v = k & 1;
      const int lo = dir == LEFT ? 0 : h + 1, hi = dir == LEFT ? h : n;
      float s = 0.f;
      if (active)
        for (int ch = lo + gl; ch < hi; ch += G) s += GA[(h * n1 + ch) * 2 + v];
      s = group_sum(s, G);
      if (active && gl == 0) GD[dec_idx(h, dir, v, GO)] = s;
    }
  }
}

}  // namespace dmv
