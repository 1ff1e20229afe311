// Shared pieces of the DMV chart kernels (dmv_fused.cu, dmv_inside.cu,
// dmv_outside.cu): constants of the reference, the lane-parallel semiring
// sums, and the two fills every kernel runs, each with ONE barrier per chart
// width:
//
//  * `inside_fill_1b`: every mapping of dmv_inside.cu (K2
//    `_inside_kernel_v3`, K3a `_inside_kernel_v3_save`, K4
//    `_inside_kernel_v2(_save)` on a warp a sentence and
//    `_inside_kernel(_save)`) and the inside pass of K1 (dmv_fused.cu,
//    `_fused_kernel`);
//  * `outside_fill_1b`: dmv_outside.cu (K3b `_outside_kernel`) and the
//    outside pass of K1, in place on the charts its inside pass filled.
//
// What bounds them is latency: a pass over a sentence of length L is a chain
// of width steps, each ended by a barrier, and the bytes and operations are
// microseconds of the card's peaks. A width has two phases, and the second
// needs exactly one term from the first, which belongs to the same start i:
//   inside:       Cl[w][i] reads Il[w][i] (split t = 0), Cr[w][i] reads
//                 Ir[w][i] (t = w - 1); every other term is narrower;
//   log outside:  OIl[w][i] reads OCl[w][i] (t = i), OIr[w][i] reads
//                 OCr[w][i] (t = 0); every other term is wider;
//   max outside:  only the complete spans [i, i+w] themselves mark OIl[w][i]
//                 and OIr[w][i] among the spans of width w.
// So a group of lanes owns one start i (both directions and both valences)
// for both phases of a width: it reduces the first phase's terms and every
// other term of the second together, then folds the same-width term in last,
// out of registers (the butterflies leave every reduced value in every lane
// of the group), into the running max or the (max, sum) pair of the
// logsumexp. In the max outside pass the marks of the incomplete spans are
// pulled, not pushed: a group asks every complete span that could mark its
// cell (the same-width one included, whose flag is behind the last barrier)
// and learns the answer with a warp vote. A pass is L dependent steps, where
// a barrier between the two phases of a width would make it 2L. The log
// outside pass carries log-marginals (inside + outside - log Z) from width
// to width: values near 0, where outside scores grow to log Z and carry its
// round-off into every marginal.
//
// Work mapping. The threads of a sentence (a block, or a warp for tiny
// charts) are cut into groups of G consecutive lanes, G a power of two
// chosen per width so that tasks x G fills the threads (`lanes_per_task`).
// A group owns one task and its lanes stride over the task's terms. A
// logsumexp takes two passes: the maximum of the terms (lane-local, then an
// xor-butterfly of shuffles), then independent exp(term - max) summed the
// same way, and one log per cell, so no exp waits for another. The
// butterflies are fixed trees and every lane of a group ends with the same
// bits; there are no atomics, so reruns are bit-identical. fmaxf over one set
// of float sums is order-free, so the max semiring gives the bits a serial
// walk gives; the sums inside a term are never reassociated.
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
// The fills read and write only the cells of the span triangle.

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

// Six xor-butterflies over the G lanes of a group, level by level, so that a
// level's six shuffles are in flight together where six calls of group_max
// (MAX) or group_sum would wait on one tree after another. The same trees,
// so the same bits.
template <bool MAX>
__device__ __forceinline__ void group_reduce6(float& a, float& b, float& c, float& d,
                                              float& e, float& f, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float a2 = __shfl_xor_sync(kFull, a, off), b2 = __shfl_xor_sync(kFull, b, off);
    const float c2 = __shfl_xor_sync(kFull, c, off), d2 = __shfl_xor_sync(kFull, d, off);
    const float e2 = __shfl_xor_sync(kFull, e, off), f2 = __shfl_xor_sync(kFull, f, off);
    a = MAX ? fmaxf(a, a2) : a + a2;
    b = MAX ? fmaxf(b, b2) : b + b2;
    c = MAX ? fmaxf(c, c2) : c + c2;
    d = MAX ? fmaxf(d, d2) : d + d2;
    e = MAX ? fmaxf(e, e2) : e + e2;
    f = MAX ? fmaxf(f, f2) : f + f2;
  }
}

// N xor-butterflies over the G lanes of a group, level by level, as
// group_reduce6 (K1's reductions of the outside pass: eight in log, two in
// max). The same trees, so the same bits.
template <bool MAX, int N>
__device__ __forceinline__ void group_reduce(float (&x)[N], int G) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    float y[N];
#pragma unroll
    for (int q = 0; q < N; ++q) y[q] = __shfl_xor_sync(kFull, x[q], off);
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = MAX ? fmaxf(x[q], y[q]) : x[q] + y[q];
  }
}

// A lane of K1's block path keeps its terms of a task in registers for the
// logsumexp's second pass, instead of reading their cells again, while they
// number at most HOLD (ceil(terms / G), uniform over the block): the fills'
// template argument, this many where a thread has the registers for them.
constexpr int kRegTerms = 4;

// log of a sum of exp(term - m) terms: s == 0 is the empty sum.
__device__ __forceinline__ float lse_get(float m, float s) {
  return s > 0.f ? m + logf(s) : kNegInf;
}

// An asynchronous copy of one float pair from global to shared memory
// (cp.async, 8 bytes: a sentence's potentials start only 8-byte aligned at
// odd n1, and a saved chart row lands on an odd pitch).
__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Waits for every cp.async this thread issued (a barrier then publishes them).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying `pairs` float pairs from g to s, by the nt threads.
__device__ __forceinline__ void stage_pairs(float* s, const float* g, int pairs, int tid,
                                            int nt) {
  for (int k = tid; k < pairs; k += nt) cp_async8(s + 2 * k, g + 2 * k);
}

__device__ __forceinline__ void st2(float* X, int pitch, int w, int i, float hc, float nc) {
  *reinterpret_cast<float2*>(X + ix(pitch, w, i, 0)) = make_float2(hc, nc);
}

// The log of a sum whose other terms gave (m, s): their maximum and their
// sum of exp(term - m), s == 0 when there are none; x is the last term. An
// empty sum (every term -inf) gives log(0) = -inf; no branch.
__device__ __forceinline__ float lse_fold(float m, float s, float x) {
  const float mm = fmaxf(m, x);
  const float r = mm == -INFINITY ? 0.f : mm;
  return r + logf((s > 0.f ? s * expf(m - r) : 0.f) + expf(x - r));
}

// lse_get in the log-marginal form of the outside pass, where an empty sum
// is -inf (a marginal of 0), not the semiring zero.
__device__ __forceinline__ float lse_get_l(float m, float s) {
  return s > 0.f ? m + logf(s) : -INFINITY;
}

// Whether `pred` holds in any lane of this lane's group of G (a warp vote;
// every lane of the warp calls it).
__device__ __forceinline__ bool group_any(bool pred, int G, int tid) {
  const unsigned votes = __ballot_sync(kFull, pred);
  const unsigned mask = G == 32 ? kFull : ((1u << G) - 1u) << ((tid & 31) & ~(G - 1));
  return (votes & mask) != 0u;
}

// The six values of split point t of the inside task (w, i), as the loops of
// inside_fill_1b compute them (its FUSED path): the split sums of Il and Ir,
// then Cl's and Cr's terms for both valences, -inf for the same-width ones.
__device__ __forceinline__ void inside_terms(const float* Cr, const float* Cl, const float* Ir,
                                             const float* Il, int p, int w, int i, int t,
                                             float (&v)[6]) {
  const float2 cr = ld2(Cr, p, t, i);
  const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
  const float2 il = ld2(Il, p, w - t, i + t);
  const float2 ir = ld2(Ir, p, t + 1, i);
  const float cl_nc = Cl[ix(p, t, i, NC)];
  const float cr_nc = Cr[ix(p, w - 1 - t, i + 1 + t, NC)];
  const bool lo = t > 0, hi = t < w - 1;
  v[0] = cr.y + cl.x;
  v[1] = cr.x + cl.y;
  v[2] = lo ? il.x + cl_nc : -INFINITY;
  v[3] = lo ? il.y + cl_nc : -INFINITY;
  v[4] = hi ? ir.x + cr_nc : -INFINITY;
  v[5] = hi ? ir.y + cr_nc : -INFINITY;
}

// The inside fill with one barrier per width, for the nt threads of a
// sentence (a power of two, whole warps): a block, whose barrier is
// __syncthreads(); with FUSED (K1) the first nt threads of a block, whose
// barrier is the named barrier 1 of those threads alone (K1 runs its inside
// pass on fewer threads than its outside pass; the others wait at the
// block's next __syncthreads()), whose six butterflies a reduction go level
// by level and whose lanes hold their terms for the log sums while they
// number at most HOLD; or with WARP one warp (nt = 32) of a block whose other
// warps fill other sentences, whose barrier is __syncwarp(), whose lanes
// hold one term each (n1 <= 9) and whose six butterflies a reduction go level
// by level (group_reduce6). Width 0 (Cr/Cl[0]
// = the STOP decisions) and a barrier come first, from the caller. Per width
// w a group owns the start i: Il/Ir[w][i] (w split points) and Cl/Cr[w][i]
// (w split points, of which the same-width one, Il[w][i] or Ir[w][i], is
// folded in last). D = dec [n1][2][2][2], AT = attach [n1][n1][2], in shared
// or global memory. Ends with a barrier.
template <bool IS_MAX, bool WARP = false, bool FUSED = false, int HOLD = 0>
__device__ __forceinline__ void inside_fill_1b(float* Cr, float* Cl, float* Ir, float* Il,
                                               const float* D, const float* AT, int n1, int p,
                                               int len, int tid, int nt) {
  const int n = len + 1;
  for (int w = 1; w <= len; ++w) {
    const int ncell = n - w;
    const int lg = lanes_per_task(ncell, w, nt), G = 1 << lg;
    const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
    for (int t0 = 0; t0 < ncell; t0 += ngroups) {
      const int i = t0 + gid;
      const bool active = i < ncell;
      // what the fold needs besides the reductions, asked for first: the arc
      // scores and the width-0 cells of the same-width terms
      float arc_l[2] = {0.f, 0.f}, arc_r[2] = {0.f, 0.f}, cnl = 0.f, cnr = 0.f;
      if (active && gl == 0) {
        for (int v = 0; v < 2; ++v) {
          arc_l[v] = AT[((i + w) * n1 + i) * 2 + v] + D[dec_idx(i + w, LEFT, v, GO)];
          arc_r[v] = AT[(i * n1 + i + w) * 2 + v] + D[dec_idx(i, RIGHT, v, GO)];
        }
        cnl = Cl[ix(p, 0, i, NC)];
        cnr = Cr[ix(p, 0, i + w, NC)];
      }
      // the split sums of Il and Ir; Cl[w][i][v] over t >= 1; Cr[w][i][v]
      // over t <= w - 2. The loop has no branch: the same-width terms' cells
      // (Il[w][i] at t = 0, Ir[w][i] at t = w - 1) are read, not written
      // yet, and their terms replaced by -inf; they are folded in after the
      // reduction
      float ml = -INFINITY, mr = -INFINITY;
      float mcl0 = -INFINITY, mcl1 = -INFINITY, mcr0 = -INFINITY, mcr1 = -INFINITY;
      const int nterm = active ? w : 0;
      // with WARP a lane holds at most one term, t = gl (n1 <= 9 on 32 lanes:
      // G is the power of two at least w), and keeps it for the sums in t*
      // instead of reading its cells again; a step is then a chain of one
      // warp's instructions that no other warp hides, so its six trees go
      // level by level. Both give the bits of the loops below
      float tl, tr, tcl0, tcl1, tcr0, tcr1;
      // with FUSED, a lane's held terms (inside_terms)
      [[maybe_unused]] bool held = false;
      [[maybe_unused]] float x[HOLD > 0 ? HOLD : 1][6];
      if constexpr (WARP) {
        if (gl < nterm) {
          const int t = gl;
          const float2 cr = ld2(Cr, p, t, i);
          const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
          const float2 il = ld2(Il, p, w - t, i + t);
          const float2 ir = ld2(Ir, p, t + 1, i);
          const float cl_nc = Cl[ix(p, t, i, NC)];
          const float cr_nc = Cr[ix(p, w - 1 - t, i + 1 + t, NC)];
          const bool lo = t > 0, hi = t < w - 1;
          ml = fmaxf(ml, cr.y + cl.x);
          mr = fmaxf(mr, cr.x + cl.y);
          mcl0 = fmaxf(mcl0, lo ? il.x + cl_nc : -INFINITY);
          mcl1 = fmaxf(mcl1, lo ? il.y + cl_nc : -INFINITY);
          mcr0 = fmaxf(mcr0, hi ? ir.x + cr_nc : -INFINITY);
          mcr1 = fmaxf(mcr1, hi ? ir.y + cr_nc : -INFINITY);
        }
        tl = ml, tr = mr, tcl0 = mcl0, tcl1 = mcl1, tcr0 = mcr0, tcr1 = mcr1;
        group_reduce6<true>(ml, mr, mcl0, mcl1, mcr0, mcr1, G);
      } else if constexpr (FUSED) {
        // K1's block path: the terms of the loops below in the same order,
        // in log held in registers while a lane has at most HOLD of
        // them (ceil(w / G), uniform over the threads), and the six trees
        // level by level; so the bits of the loops below
        auto max6 = [&](const float (&v)[6]) {
          ml = fmaxf(ml, v[0]);
          mr = fmaxf(mr, v[1]);
          mcl0 = fmaxf(mcl0, v[2]);
          mcl1 = fmaxf(mcl1, v[3]);
          mcr0 = fmaxf(mcr0, v[4]);
          mcr1 = fmaxf(mcr1, v[5]);
        };
        held = HOLD > 0 && !IS_MAX && ((w + G - 1) >> lg) <= HOLD;
        if (held) {
#pragma unroll
          for (int k = 0; k < HOLD; ++k)
            if (gl + k * G < nterm) {
              inside_terms(Cr, Cl, Ir, Il, p, w, i, gl + k * G, x[k]);
              max6(x[k]);
            }
        } else {
#pragma unroll 4
          for (int t = gl; t < nterm; t += G) {
            float y[6];
            inside_terms(Cr, Cl, Ir, Il, p, w, i, t, y);
            max6(y);
          }
        }
        group_reduce6<true>(ml, mr, mcl0, mcl1, mcr0, mcr1, G);
      } else {
#pragma unroll 4
        for (int t = gl; t < nterm; t += G) {
          const float2 cr = ld2(Cr, p, t, i);
          const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
          const float2 il = ld2(Il, p, w - t, i + t);
          const float2 ir = ld2(Ir, p, t + 1, i);
          const float cl_nc = Cl[ix(p, t, i, NC)];
          const float cr_nc = Cr[ix(p, w - 1 - t, i + 1 + t, NC)];
          const bool lo = t > 0, hi = t < w - 1;
          ml = fmaxf(ml, cr.y + cl.x);
          mr = fmaxf(mr, cr.x + cl.y);
          mcl0 = fmaxf(mcl0, lo ? il.x + cl_nc : -INFINITY);
          mcl1 = fmaxf(mcl1, lo ? il.y + cl_nc : -INFINITY);
          mcr0 = fmaxf(mcr0, hi ? ir.x + cr_nc : -INFINITY);
          mcr1 = fmaxf(mcr1, hi ? ir.y + cr_nc : -INFINITY);
        }
        ml = group_max(ml, G);
        mr = group_max(mr, G);
        mcl0 = group_max(mcl0, G);
        mcl1 = group_max(mcl1, G);
        mcr0 = group_max(mcr0, G);
        mcr1 = group_max(mcr1, G);
      }
      float sl = 0.f, sr = 0.f, scl0 = 0.f, scl1 = 0.f, scr0 = 0.f, scr1 = 0.f;
      if (!IS_MAX) {
        // a sum without any term keeps s = 0 (exp(-inf - 0) = 0)
        const float rcl0 = mcl0 == -INFINITY ? 0.f : mcl0;
        const float rcl1 = mcl1 == -INFINITY ? 0.f : mcl1;
        const float rcr0 = mcr0 == -INFINITY ? 0.f : mcr0;
        const float rcr1 = mcr1 == -INFINITY ? 0.f : mcr1;
        if constexpr (WARP) {
          if (gl < nterm) {
            sl = expf(tl - ml);
            sr = expf(tr - mr);
            scl0 = expf(tcl0 - rcl0);
            scl1 = expf(tcl1 - rcl1);
            scr0 = expf(tcr0 - rcr0);
            scr1 = expf(tcr1 - rcr1);
          }
          group_reduce6<false>(sl, sr, scl0, scl1, scr0, scr1, G);
        } else if constexpr (FUSED) {
          auto sum6 = [&](const float (&v)[6]) {
            sl += expf(v[0] - ml);
            sr += expf(v[1] - mr);
            scl0 += expf(v[2] - rcl0);
            scl1 += expf(v[3] - rcl1);
            scr0 += expf(v[4] - rcr0);
            scr1 += expf(v[5] - rcr1);
          };
          if (held) {
#pragma unroll
            for (int k = 0; k < HOLD; ++k)
              if (gl + k * G < nterm) sum6(x[k]);
          } else {
#pragma unroll 4
            for (int t = gl; t < nterm; t += G) {
              float y[6];
              inside_terms(Cr, Cl, Ir, Il, p, w, i, t, y);
              sum6(y);
            }
          }
          group_reduce6<false>(sl, sr, scl0, scl1, scr0, scr1, G);
        } else {
#pragma unroll 4
          for (int t = gl; t < nterm; t += G) {
            const float2 cr = ld2(Cr, p, t, i);
            const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
            const float2 il = ld2(Il, p, w - t, i + t);
            const float2 ir = ld2(Ir, p, t + 1, i);
            const float cl_nc = Cl[ix(p, t, i, NC)];
            const float cr_nc = Cr[ix(p, w - 1 - t, i + 1 + t, NC)];
            const bool lo = t > 0, hi = t < w - 1;
            sl += expf((cr.y + cl.x) - ml);
            sr += expf((cr.x + cl.y) - mr);
            scl0 += expf((lo ? il.x + cl_nc : -INFINITY) - rcl0);
            scl1 += expf((lo ? il.y + cl_nc : -INFINITY) - rcl1);
            scr0 += expf((hi ? ir.x + cr_nc : -INFINITY) - rcr0);
            scr1 += expf((hi ? ir.y + cr_nc : -INFINITY) - rcr1);
          }
          sl = group_sum(sl, G);
          sr = group_sum(sr, G);
          scl0 = group_sum(scl0, G);
          scl1 = group_sum(scl1, G);
          scr0 = group_sum(scr0, G);
          scr1 = group_sum(scr1, G);
        }
      }
      if (active && gl == 0) {
        const float al = IS_MAX ? ml : lse_get(ml, sl);
        const float ar = IS_MAX ? mr : lse_get(mr, sr);
        const float il0 = al + arc_l[0], il1 = al + arc_l[1];
        const float ir0 = ar + arc_r[0], ir1 = ar + arc_r[1];
        // the same-width terms: Cl's split t = 0, Cr's split t = w - 1
        const float xl0 = il0 + cnl, xl1 = il1 + cnl, xr0 = ir0 + cnr, xr1 = ir1 + cnr;
        const float cl0 = IS_MAX ? fmaxf(mcl0, xl0) : lse_fold(mcl0, scl0, xl0);
        const float cl1 = IS_MAX ? fmaxf(mcl1, xl1) : lse_fold(mcl1, scl1, xl1);
        float cr0 = IS_MAX ? fmaxf(mcr0, xr0) : lse_fold(mcr0, scr0, xr0);
        float cr1 = IS_MAX ? fmaxf(mcr1, xr1) : lse_fold(mcr1, scr1, xr1);
        if (i == 0 && w != len) cr0 = cr1 = kNegInf;  // single root
        st2(Il, p, w, i, il0, il1);
        st2(Ir, p, w, i, ir0, ir1);
        st2(Cl, p, w, i, cl0, cl1);
        st2(Cr, p, w, i, cr0, cr1);
      }
    }
    if constexpr (WARP)
      __syncwarp();
    else if constexpr (FUSED)
      asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
    else
      __syncthreads();
  }
}

// The charts of the one-barrier outside pass: the four inside charts and
// four more. In the log semiring, log-marginals (inside + outside - log Z):
// OCr, OCl of the complete spans, OA[w][i][dir] of the incomplete spans'
// split sums, and AS[w][i][dir], the split sums' values; no incomplete
// span's own log-marginal is stored (a group computes its own and nothing
// else reads it). In the max semiring, on-best-tree flags: OCr, OCl of the
// complete spans, OIr, OIl of the incomplete spans (in OA's and AS's place).
// p is the inside charts' pitch; pa the four others' (read only with FUSED:
// K1 keeps its inside charts in shared memory and the others in global
// scratch at 57 <= n1 <= 75 on an H100; every other caller has one pitch).
struct OutsideCharts1b {
  const float *Cr, *Cl, *Ir, *Il;
  float *OCr, *OCl, *OA, *OIr, *OIl, *AS;
  int p, pa;
};

// The outside pass with one barrier per width over filled inside charts, by
// the nt threads of a block (a power of two, whole warps). The caller has
// zeroed OCr/OCl/OIr/OIl and seeded OCr[len][0][NC] = 1 in the max semiring,
// and ends the staging with a barrier. Writes go * d total / d attach into
// GA [n1][n1][2] on the arcs of the sentence (any other cell is left as it
// was; in place of AT when both are the same shared buffer: a task reads
// AT[at] before it writes GA[at], and no other task touches that cell) and
// every entry of GD [n1][2][2][2] (global memory). GA is final after the
// last width's barrier: the STOP and GO decisions follow it and only read
// GA.
//   log: per width w (len down to 0) a group owns the start i: the
//     log-marginals of Cl/Cr[w][i] (len - w consumer terms each, wider cells
//     only), then, for w >= 1, of Il/Ir[w][i] (len - w wider terms, and the
//     same-width Cl/Cr[w][i] folded in last), the arc marginals, OA and AS
//     [w][i]. A term is the consumer's log-marginal plus the split's
//     log-weight, (the split's sum as the inside pass added it) minus the
//     consumer's inside value: autograd's softmax weight, in logs;
//   max: per width w (len down to 1) a group owns the start i, and works
//     only where a flag of its cells is set: marked complete spans [i, i+w]
//     mark both parts of each best split, the narrower ones in shared memory,
//     the same-width incomplete span (Il[w][i] at split 0, Ir[w][i] at split
//     w - 1) by a warp vote over the group; with the flags wider spans set
//     on OIl/OIr[w][i] before the barrier, a marked incomplete span marks
//     the parts of its best splits. Every stored mark goes to a narrower
//     cell.
// With FUSED (K1) the adjoint charts have their own pitch c.pa, and the
// reductions go level by level: eight trees in log (a lane's terms held
// for the sums while they number at most HOLD), best_l and best_r
// together in max. The same terms, trees and order, so the same bits.
template <bool IS_MAX, bool FUSED = false, int HOLD = 0>
__device__ __forceinline__ void outside_fill_1b(const OutsideCharts1b& c,
                                                const float* D, const float* AT, float* GD,
                                                float* GA, int n1, int len, float go, int tid,
                                                int nt) {
  const int p = c.p;
  const int pa = FUSED ? c.pa : p;
  const int n = len + 1;
  const float *Cr = c.Cr, *Cl = c.Cl, *Ir = c.Ir, *Il = c.Il;
  float *OCr = c.OCr, *OCl = c.OCl, *OA = c.OA;
  if (IS_MAX) {
    float *OIr = c.OIr, *OIl = c.OIl;
    for (int w = len; w >= 1; --w) {
      const int ncell = n - w;
      const int lg = lanes_per_task(ncell, w, nt), G = 1 << lg;
      const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
      for (int t0 = 0; t0 < ncell; t0 += ngroups) {
        const int i = t0 + gid;
        const bool active = i < ncell;
        // the flags of the task's four cells, set by wider spans before the
        // barrier
        bool fl0 = false, fl1 = false, fr0 = false, fr1 = false;
        bool ol0 = false, ol1 = false, or0 = false, or1 = false;
        float2 bl = make_float2(0.f, 0.f), br = bl;
        if (active) {
          const float2 a = ld2(OCl, pa, w, i), b = ld2(OCr, pa, w, i);
          const float2 d = ld2(OIl, pa, w, i), e = ld2(OIr, pa, w, i);
          fl0 = a.x > 0.f, fl1 = a.y > 0.f, fr0 = b.x > 0.f, fr1 = b.y > 0.f;
          ol0 = d.x > 0.f, ol1 = d.y > 0.f, or0 = e.x > 0.f, or1 = e.y > 0.f;
          bl = ld2(Cl, p, w, i), br = ld2(Cr, p, w, i);
        }
        const bool busy = fl0 || fl1 || fr0 || fr1 || ol0 || ol1 || or0 || or1;
        float best_l = -INFINITY, best_r = -INFINITY;
        // the same-width incomplete spans' marks this lane found
        bool sl0 = false, sl1 = false, sr0 = false, sr1 = false;
        const int nsplit = busy ? w : 0;
        for (int t = gl; t < nsplit; t += G) {
          // marked complete spans of width w: both parts of each best split
          const float2 sub_l = ld2(Il, p, w - t, i + t);
          const float cl_nc = Cl[ix(p, t, i, NC)];
          const bool hl0 = fl0 && sub_l.x + cl_nc == bl.x;
          const bool hl1 = fl1 && sub_l.y + cl_nc == bl.y;
          if (hl0 || hl1) OCl[ix(pa, t, i, NC)] = 1.f;
          if (t == 0) {
            sl0 = hl0, sl1 = hl1;
          } else {
            if (hl0) OIl[ix(pa, w - t, i + t, 0)] = 1.f;
            if (hl1) OIl[ix(pa, w - t, i + t, 1)] = 1.f;
          }
          const float2 sub_r = ld2(Ir, p, t + 1, i);
          const float cr_nc = Cr[ix(p, w - 1 - t, i + 1 + t, NC)];
          const bool hr0 = fr0 && sub_r.x + cr_nc == br.x;
          const bool hr1 = fr1 && sub_r.y + cr_nc == br.y;
          if (hr0 || hr1) OCr[ix(pa, w - 1 - t, i + 1 + t, NC)] = 1.f;
          if (t == w - 1) {
            sr0 = hr0, sr1 = hr1;
          } else {
            if (hr0) OIr[ix(pa, t + 1, i, 0)] = 1.f;
            if (hr1) OIr[ix(pa, t + 1, i, 1)] = 1.f;
          }
          // the split sums of the incomplete spans [i, i+w]
          const float2 cr = ld2(Cr, p, t, i);
          const float2 cl = ld2(Cl, p, w - 1 - t, i + 1 + t);
          best_l = fmaxf(best_l, cr.y + cl.x);
          best_r = fmaxf(best_r, cr.x + cl.y);
        }
        // every lane of the warp votes (no short circuit before a vote)
        const bool vl0 = group_any(sl0, G, tid), vl1 = group_any(sl1, G, tid);
        const bool vr0 = group_any(sr0, G, tid), vr1 = group_any(sr1, G, tid);
        const bool pl0 = ol0 || vl0, pl1 = ol1 || vl1, pr0 = or0 || vr0, pr1 = or1 || vr1;
        if constexpr (FUSED) {
          float best[2] = {best_l, best_r};
          group_reduce<true, 2>(best, G);
          best_l = best[0], best_r = best[1];
        } else {
          best_l = group_max(best_l, G);
          best_r = group_max(best_r, G);
        }
        if (active && gl == 0) {
          const int atl = ((i + w) * n1 + i) * 2, atr = (i * n1 + i + w) * 2;
          GA[atl] = go * (pl0 ? 1.f : 0.f);
          GA[atl + 1] = go * (pl1 ? 1.f : 0.f);
          GA[atr] = go * (pr0 ? 1.f : 0.f);
          GA[atr + 1] = go * (pr1 ? 1.f : 0.f);
        }
        // a left arc joins Cr[.., NC] and Cl[.., HC]; a right arc the other
        // valences
        if (active && (pl0 || pl1))
          for (int t = gl; t < w; t += G)
            if (Cr[ix(p, t, i, NC)] + Cl[ix(p, w - 1 - t, i + 1 + t, HC)] == best_l) {
              OCr[ix(pa, t, i, NC)] = 1.f;
              OCl[ix(pa, w - 1 - t, i + 1 + t, HC)] = 1.f;
            }
        if (active && (pr0 || pr1))
          for (int t = gl; t < w; t += G)
            if (Cr[ix(p, t, i, HC)] + Cl[ix(p, w - 1 - t, i + 1 + t, NC)] == best_r) {
              OCr[ix(pa, t, i, HC)] = 1.f;
              OCl[ix(pa, w - 1 - t, i + 1 + t, NC)] = 1.f;
            }
      }
      __syncthreads();
    }
    for (int k = tid; k < 2 * n; k += nt) {
      const int i = k >> 1, v = k & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] = go * OCr[ix(pa, 0, i, v)];
      GD[dec_idx(i, LEFT, v, STOP)] = go * OCl[ix(pa, 0, i, v)];
    }
  } else {
    // log-marginals: LCr/LCl (OCr/OCl) of the complete spans, LA (OA) of the
    // split sums, and the split sums' values A (AS), recovered from the
    // incomplete span and its arc score
    float* AS = c.AS;
    for (int w = len; w >= 0; --w) {
      const int ncell = n - w;
      const int lg = lanes_per_task(ncell, len - w + 1, nt), G = 1 << lg;
      const int ngroups = nt >> lg, gid = tid >> lg, gl = tid & (G - 1);
      for (int t0 = 0; t0 < ncell; t0 += ngroups) {
        const int i = t0 + gid;
        const bool active = i < ncell;
        const int nW = active ? len - i - w : 0, nj = active ? i : 0;
        const int atl = ((i + w) * n1 + i) * 2, atr = (i * n1 + i + w) * 2;
        // the task's own cells, in every lane; the arc scores in the first
        float2 own_cl = make_float2(0.f, 0.f), own_cr = own_cl, own_il = own_cl, own_ir = own_cl;
        float arc_l[2] = {0.f, 0.f}, arc_r[2] = {0.f, 0.f}, cnl = 0.f, cnr = 0.f;
        if (active) {
          own_cl = ld2(Cl, p, w, i), own_cr = ld2(Cr, p, w, i);
          if (w >= 1) own_il = ld2(Il, p, w, i), own_ir = ld2(Ir, p, w, i);
          if (gl == 0 && w >= 1) {
            for (int v = 0; v < 2; ++v) {
              arc_l[v] = AT[atl + v] + D[dec_idx(i + w, LEFT, v, GO)];
              arc_r[v] = AT[atr + v] + D[dec_idx(i, RIGHT, v, GO)];
            }
            cnl = Cl[ix(p, 0, i, NC)];
            cnr = Cr[ix(p, 0, i + w, NC)];
          }
        }
        // m[0..1] LCl[w][i][HC, NC], m[2..3] LCr[w][i], m[4..5] LIl[w][i]
        // over t < i, m[6..7] LIr[w][i] over t >= 1. A term is the consumer's
        // log-marginal plus its split's log-weight (the split's sum minus the
        // consumer's inside value, the sum added as the inside pass added
        // it). Two loops without branches: the wider spans over [i, i+w]
        // (k < nW; the consumers of both complete spans and LIr's t = k + 1),
        // and the spans from j < i (the arcs over both complete spans and
        // LIl's t = j); at w = 0 the incomplete spans' terms are -inf
        const bool inc = w >= 1;
        // the seed: the whole sentence's log-marginal is 0, one lane's term
        const bool seed = active && gl == 0 && w == len;
        float m[8], s[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) m[q] = -INFINITY, s[q] = 0.f;
        if (seed) m[3] = 0.f;
        if constexpr (FUSED) {
          // K1: the terms of the loops below in the same order, held in
          // registers while a lane has at most HOLD of either kind
          // (ceil((len - w) / G) bounds both, uniform over the block), and
          // the eight trees level by level; so the bits of the loops below
          auto wide = [&](int k, float (&v)[6]) {
            const int W = w + 1 + k;
            const float2 lcl = ld2(OCl, pa, W, i), clw = ld2(Cl, p, W, i),
                         in = ld2(Il, p, W - w, i + w);
            const float2 la = ld2(OA, pa, W, i), a = ld2(AS, pa, W, i);
            const float2 cl = ld2(Cl, p, W - 1 - w, i + 1 + w);
            const float2 lcr = ld2(OCr, pa, W, i), crw = ld2(Cr, p, W, i);
            const float cn = Cr[ix(p, k + 1, i + w, NC)];
            v[0] = lcl.x + ((in.x + own_cl.y) - clw.x);
            v[1] = lcl.y + ((in.y + own_cl.y) - clw.y);
            v[2] = la.y + ((own_cr.x + cl.y) - a.y);
            v[3] = la.x + ((own_cr.y + cl.x) - a.x);
            v[4] = inc ? lcr.x + ((own_ir.x + cn) - crw.x) : -INFINITY;
            v[5] = inc ? lcr.y + ((own_ir.y + cn) - crw.y) : -INFINITY;
          };
          auto near = [&](int j, float (&v)[6]) {
            const int W = w + i - j;
            const float2 la = ld2(OA, pa, W, j), a = ld2(AS, pa, W, j),
                         cr = ld2(Cr, p, i - 1 - j, j);
            const float2 lcr = ld2(OCr, pa, W, j), crw = ld2(Cr, p, W, j),
                         in = ld2(Ir, p, i - j, j);
            const float2 lcl = ld2(OCl, pa, W, j), clw = ld2(Cl, p, W, j);
            const float cn = Cl[ix(p, i - j, j, NC)];
            v[0] = la.x + ((cr.y + own_cl.x) - a.x);
            v[1] = la.y + ((cr.x + own_cl.y) - a.y);
            v[2] = lcr.x + ((in.x + own_cr.y) - crw.x);
            v[3] = lcr.y + ((in.y + own_cr.y) - crw.y);
            v[4] = inc ? lcl.x + ((own_il.x + cn) - clw.x) : -INFINITY;
            v[5] = inc ? lcl.y + ((own_il.y + cn) - clw.y) : -INFINITY;
          };
          auto max_wide = [&](const float (&v)[6]) {
            m[1] = fmaxf(m[1], fmaxf(v[0], v[1]));
            m[2] = fmaxf(m[2], v[2]);
            m[3] = fmaxf(m[3], v[3]);
            m[6] = fmaxf(m[6], v[4]);
            m[7] = fmaxf(m[7], v[5]);
          };
          auto max_near = [&](const float (&v)[6]) {
            m[0] = fmaxf(m[0], v[0]);
            m[1] = fmaxf(m[1], v[1]);
            m[3] = fmaxf(m[3], fmaxf(v[2], v[3]));
            m[4] = fmaxf(m[4], v[4]);
            m[5] = fmaxf(m[5], v[5]);
          };
          const bool held = HOLD > 0 && ((len - w + G - 1) >> lg) <= HOLD;
          float xw[HOLD > 0 ? HOLD : 1][6], xj[HOLD > 0 ? HOLD : 1][6];
          if (held) {
#pragma unroll
            for (int u = 0; u < HOLD; ++u)
              if (gl + u * G < nW) {
                wide(gl + u * G, xw[u]);
                max_wide(xw[u]);
              }
#pragma unroll
            for (int u = 0; u < HOLD; ++u)
              if (gl + u * G < nj) {
                near(gl + u * G, xj[u]);
                max_near(xj[u]);
              }
          } else {
#pragma unroll 2
            for (int k = gl; k < nW; k += G) {
              float v[6];
              wide(k, v);
              max_wide(v);
            }
#pragma unroll 2
            for (int j = gl; j < nj; j += G) {
              float v[6];
              near(j, v);
              max_near(v);
            }
          }
          group_reduce<true, 8>(m, G);
          float r[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) r[q] = m[q] == -INFINITY ? 0.f : m[q];
          if (seed) s[3] = expf(0.f - r[3]);
          auto sum_wide = [&](const float (&v)[6]) {
            s[1] += expf(v[0] - r[1]) + expf(v[1] - r[1]);
            s[2] += expf(v[2] - r[2]);
            s[3] += expf(v[3] - r[3]);
            s[6] += expf(v[4] - r[6]);
            s[7] += expf(v[5] - r[7]);
          };
          auto sum_near = [&](const float (&v)[6]) {
            s[0] += expf(v[0] - r[0]);
            s[1] += expf(v[1] - r[1]);
            s[3] += expf(v[2] - r[3]) + expf(v[3] - r[3]);
            s[4] += expf(v[4] - r[4]);
            s[5] += expf(v[5] - r[5]);
          };
          if (held) {
#pragma unroll
            for (int u = 0; u < HOLD; ++u)
              if (gl + u * G < nW) sum_wide(xw[u]);
#pragma unroll
            for (int u = 0; u < HOLD; ++u)
              if (gl + u * G < nj) sum_near(xj[u]);
          } else {
#pragma unroll 2
            for (int k = gl; k < nW; k += G) {
              float v[6];
              wide(k, v);
              sum_wide(v);
            }
#pragma unroll 2
            for (int j = gl; j < nj; j += G) {
              float v[6];
              near(j, v);
              sum_near(v);
            }
          }
          group_reduce<false, 8>(s, G);
        } else {
#pragma unroll 2
          for (int k = gl; k < nW; k += G) {
            const int W = w + 1 + k;
            const float2 lcl = ld2(OCl, pa, W, i), clw = ld2(Cl, p, W, i), in = ld2(Il, p, W - w, i + w);
            const float2 la = ld2(OA, pa, W, i), a = ld2(AS, pa, W, i);
            const float2 cl = ld2(Cl, p, W - 1 - w, i + 1 + w);
            const float2 lcr = ld2(OCr, pa, W, i), crw = ld2(Cr, p, W, i);
            const float cn = Cr[ix(p, k + 1, i + w, NC)];
            m[1] = fmaxf(m[1], fmaxf(lcl.x + ((in.x + own_cl.y) - clw.x),
                                     lcl.y + ((in.y + own_cl.y) - clw.y)));
            m[2] = fmaxf(m[2], la.y + ((own_cr.x + cl.y) - a.y));
            m[3] = fmaxf(m[3], la.x + ((own_cr.y + cl.x) - a.x));
            m[6] = fmaxf(m[6], inc ? lcr.x + ((own_ir.x + cn) - crw.x) : -INFINITY);
            m[7] = fmaxf(m[7], inc ? lcr.y + ((own_ir.y + cn) - crw.y) : -INFINITY);
          }
#pragma unroll 2
          for (int j = gl; j < nj; j += G) {
            const int W = w + i - j;
            const float2 la = ld2(OA, pa, W, j), a = ld2(AS, pa, W, j), cr = ld2(Cr, p, i - 1 - j, j);
            const float2 lcr = ld2(OCr, pa, W, j), crw = ld2(Cr, p, W, j), in = ld2(Ir, p, i - j, j);
            const float2 lcl = ld2(OCl, pa, W, j), clw = ld2(Cl, p, W, j);
            const float cn = Cl[ix(p, i - j, j, NC)];
            m[0] = fmaxf(m[0], la.x + ((cr.y + own_cl.x) - a.x));
            m[1] = fmaxf(m[1], la.y + ((cr.x + own_cl.y) - a.y));
            m[3] = fmaxf(m[3], fmaxf(lcr.x + ((in.x + own_cr.y) - crw.x),
                                     lcr.y + ((in.y + own_cr.y) - crw.y)));
            m[4] = fmaxf(m[4], inc ? lcl.x + ((own_il.x + cn) - clw.x) : -INFINITY);
            m[5] = fmaxf(m[5], inc ? lcl.y + ((own_il.y + cn) - clw.y) : -INFINITY);
          }
          float r[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            m[q] = group_max(m[q], G);
            // a sum without any term keeps s = 0 (exp(-inf - 0) = 0)
            r[q] = m[q] == -INFINITY ? 0.f : m[q];
          }
          if (seed) s[3] = expf(0.f - r[3]);
#pragma unroll 2
          for (int k = gl; k < nW; k += G) {
            const int W = w + 1 + k;
            const float2 lcl = ld2(OCl, pa, W, i), clw = ld2(Cl, p, W, i), in = ld2(Il, p, W - w, i + w);
            const float2 la = ld2(OA, pa, W, i), a = ld2(AS, pa, W, i);
            const float2 cl = ld2(Cl, p, W - 1 - w, i + 1 + w);
            const float2 lcr = ld2(OCr, pa, W, i), crw = ld2(Cr, p, W, i);
            const float cn = Cr[ix(p, k + 1, i + w, NC)];
            s[1] += expf((lcl.x + ((in.x + own_cl.y) - clw.x)) - r[1]) +
                    expf((lcl.y + ((in.y + own_cl.y) - clw.y)) - r[1]);
            s[2] += expf((la.y + ((own_cr.x + cl.y) - a.y)) - r[2]);
            s[3] += expf((la.x + ((own_cr.y + cl.x) - a.x)) - r[3]);
            s[6] += expf((inc ? lcr.x + ((own_ir.x + cn) - crw.x) : -INFINITY) - r[6]);
            s[7] += expf((inc ? lcr.y + ((own_ir.y + cn) - crw.y) : -INFINITY) - r[7]);
          }
#pragma unroll 2
          for (int j = gl; j < nj; j += G) {
            const int W = w + i - j;
            const float2 la = ld2(OA, pa, W, j), a = ld2(AS, pa, W, j), cr = ld2(Cr, p, i - 1 - j, j);
            const float2 lcr = ld2(OCr, pa, W, j), crw = ld2(Cr, p, W, j), in = ld2(Ir, p, i - j, j);
            const float2 lcl = ld2(OCl, pa, W, j), clw = ld2(Cl, p, W, j);
            const float cn = Cl[ix(p, i - j, j, NC)];
            s[0] += expf((la.x + ((cr.y + own_cl.x) - a.x)) - r[0]);
            s[1] += expf((la.y + ((cr.x + own_cl.y) - a.y)) - r[1]);
            s[3] += expf((lcr.x + ((in.x + own_cr.y) - crw.x)) - r[3]) +
                    expf((lcr.y + ((in.y + own_cr.y) - crw.y)) - r[3]);
            s[4] += expf((inc ? lcl.x + ((own_il.x + cn) - clw.x) : -INFINITY) - r[4]);
            s[5] += expf((inc ? lcl.y + ((own_il.y + cn) - clw.y) : -INFINITY) - r[5]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) s[q] = group_sum(s[q], G);
        }
        if (active && gl == 0) {
          const float lcl0 = lse_get_l(m[0], s[0]), lcl1 = lse_get_l(m[1], s[1]);
          // a root-headed span shorter than the sentence was masked forward
          const bool masked = i == 0 && w >= 1 && w != len;
          const float lcr0 = masked ? -INFINITY : lse_get_l(m[2], s[2]);
          const float lcr1 = masked ? -INFINITY : lse_get_l(m[3], s[3]);
          st2(OCl, pa, w, i, lcl0, lcl1);
          st2(OCr, pa, w, i, lcr0, lcr1);
          if (w >= 1) {
            // the same-width terms: LIl's t = i (Cl[w][i]), LIr's t = 0
            // (Cr[w][i])
            const float lil0 = lse_fold(m[4], s[4], lcl0 + ((own_il.x + cnl) - own_cl.x));
            const float lil1 = lse_fold(m[5], s[5], lcl1 + ((own_il.y + cnl) - own_cl.y));
            const float lir0 = lse_fold(m[6], s[6], lcr0 + ((own_ir.x + cnr) - own_cr.x));
            const float lir1 = lse_fold(m[7], s[7], lcr1 + ((own_ir.y + cnr) - own_cr.y));
            GA[atl] = go * expf(lil0);
            GA[atl + 1] = go * expf(lil1);
            GA[atr] = go * expf(lir0);
            GA[atr + 1] = go * expf(lir1);
            // a split sum's log-marginal joins the two valences; its value is
            // the incomplete span's less the arc score, at the valence whose
            // arc score is the larger (a masked arc's is -1e12)
            st2(OA, pa, w, i, lse_fold(lil0, lil0 == -INFINITY ? 0.f : 1.f, lil1),
                lse_fold(lir0, lir0 == -INFINITY ? 0.f : 1.f, lir1));
            const int vl = arc_l[1] > arc_l[0], vr = arc_r[1] > arc_r[0];
            st2(AS, pa, w, i, (vl ? own_il.y : own_il.x) - arc_l[vl],
                (vr ? own_ir.y : own_ir.x) - arc_r[vr]);
          }
        }
      }
      __syncthreads();
    }
    for (int k = tid; k < 2 * n; k += nt) {
      const int i = k >> 1, v = k & 1;
      GD[dec_idx(i, RIGHT, v, STOP)] = go * expf(OCr[ix(pa, 0, i, v)]);
      GD[dec_idx(i, LEFT, v, STOP)] = go * expf(OCl[ix(pa, 0, i, v)]);
    }
  }
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
  for (int k = n * 8 + tid; k < n1 * 8; k += nt) GD[k] = 0.f;  // heads past the sentence
}

}  // namespace dmv
