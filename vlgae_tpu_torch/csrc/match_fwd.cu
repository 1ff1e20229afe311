// Fused matching maxes, forward: K5.
//
// Replaces the TPU kernel `_fwd_kernel` of vlgae_tpu/ops/match_pallas.py
// (launched by `_fwd_impl`, with its caller-side fold). For images a and
// captions b:
//   att[b,a,q,v] = txt[b,q,:] . vis[a,v,:] + vbias[a,v] + tbias[b,q]
//   logit[b,a,q]   = max_v att,  logit_idx[b,a,q]   = first such v
//   logit_v[b,a,v] = max_q att,  logit_v_idx[b,a,v] = first such q
// bf16 operands, f32 products and accumulation (k in order 0..D-1), f32
// biases. No [B,A,Q,V] tensor is ever stored.
//
// One block per (image a, tile of kCapTile captions). For each caption the
// block walks q-chunks of kTQ and v-tiles of kTV, and stages kKC-deep
// slices of txt and vis through shared memory (transposed to k-major, as
// f32); each of the 256 threads holds an 8 (q) x 4 (v) register tile. The
// max over v is carried in registers across v-tiles and reduced over the
// 16 threads of a half-warp; the max over q is reduced through shared
// memory and carried across q-chunks in the logit_v output itself (one
// owner thread per v). Ties: strict '>' in ascending index order, and the
// smaller index on equal values when partial winners merge.
//
// Bound: FMA throughput on the CUDA cores (plain f32 FMA, no tensor
// cores); at the recipe shape A=B=64, Q=102, V=703, D=128 the product is
// ~75 GFLOP. mma/wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 128;  // q rows per chunk (16 row groups x 8)
constexpr int kTV = 64;   // v columns per tile (16 column groups x 4)
constexpr int kKC = 32;   // contraction slice
constexpr int kCapTile = 4;
constexpr int kTQP = kTQ + 4;  // padded smem row strides
constexpr int kTVP = kTV + 4;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
match_fwd_kernel(const __nv_bfloat16* __restrict__ vis,   // [A, V, D]
                 const __nv_bfloat16* __restrict__ txt,   // [B, Q, D]
                 const float* __restrict__ vbias,         // [A, V]
                 const float* __restrict__ tbias,         // [B, Q]
                 float* __restrict__ logit, int* __restrict__ logit_idx,      // [B, A, Q]
                 float* __restrict__ logit_v, int* __restrict__ logit_v_idx,  // [B, A, V]
                 int A, int V, int D, int B, int Q) {
  __shared__ __align__(16) float ts[kKC][kTQP];
  __shared__ __align__(16) float vs[kKC][kTVP];
  __shared__ float red_v[16][kTV];
  __shared__ int red_i[16][kTV];

  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // q group: rows ty*8 .. ty*8+7
  const int tx = tid & 15;  // v group: cols tx*4 .. tx*4+3
  const __nv_bfloat16* vis_a = vis + (size_t)a * V * D;

  for (int bi = 0; bi < kCapTile; ++bi) {
    const int b = blockIdx.y * kCapTile + bi;
    if (b >= B) break;
    const __nv_bfloat16* txt_b = txt + (size_t)b * Q * D;
    float* lg = logit + ((size_t)b * A + a) * Q;
    int* lgi = logit_idx + ((size_t)b * A + a) * Q;
    float* lv = logit_v + ((size_t)b * A + a) * V;
    int* lvi = logit_v_idx + ((size_t)b * A + a) * V;

    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      float rmax[8];
      int ridx[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        rmax[r] = -INFINITY;
        ridx[r] = 0;
      }
      for (int v0 = 0; v0 < V; v0 += kTV) {
        float acc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

        for (int k0 = 0; k0 < D; k0 += kKC) {
          // stage txt[q0:q0+kTQ, k0:k0+kKC] and vis[v0:v0+kTV, k0:k0+kKC]
          for (int e = tid; e < kTQ * kKC; e += kThreads) {
            const int q = e / kKC, k = e % kKC;
            const int gq = q0 + q, gk = k0 + k;
            ts[k][q] = (gq < Q && gk < D)
                           ? __bfloat162float(txt_b[(size_t)gq * D + gk]) : 0.f;
          }
          for (int e = tid; e < kTV * kKC; e += kThreads) {
            const int v = e / kKC, k = e % kKC;
            const int gv = v0 + v, gk = k0 + k;
            vs[k][v] = (gv < V && gk < D)
                           ? __bfloat162float(vis_a[(size_t)gv * D + gk]) : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kKC; ++k) {
            const float4 t0 = *reinterpret_cast<const float4*>(&ts[k][ty * 8]);
            const float4 t1 = *reinterpret_cast<const float4*>(&ts[k][ty * 8 + 4]);
            const float4 vv = *reinterpret_cast<const float4*>(&vs[k][tx * 4]);
            const float tq[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
            const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(tq[r], vc[c], acc[r][c]);
          }
          __syncthreads();
        }

        // epilogue: biases, running max over v, this tile's max over q
        float cmax[4];
        int cidx[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cmax[c] = -INFINITY;
          cidx[c] = 0;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int q = q0 + ty * 8 + r;
          const float tb = q < Q ? tbias[(size_t)b * Q + q] : -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int v = v0 + tx * 4 + c;
            const float vb = v < V ? vbias[(size_t)a * V + v] : -INFINITY;
            const float x = acc[r][c] + vb + tb;
            if (x > rmax[r]) {
              rmax[r] = x;
              ridx[r] = v;
            }
            if (x > cmax[c]) {
              cmax[c] = x;
              cidx[c] = q;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          red_v[ty][tx * 4 + c] = cmax[c];
          red_i[ty][tx * 4 + c] = cidx[c];
        }
        __syncthreads();
        if (tid < kTV) {
          const int v = v0 + tid;
          if (v < V) {
            float m = red_v[0][tid];
            int mi = red_i[0][tid];
            for (int g = 1; g < 16; ++g)
              if (red_v[g][tid] > m) {
                m = red_v[g][tid];
                mi = red_i[g][tid];
              }
            // carry across q-chunks: earlier chunks hold smaller q
            if (q0 == 0 || m > lv[v]) {
              lv[v] = m;
              lvi[v] = mi;
            }
          }
        }
        __syncthreads();
      }
      // max over v: merge the 16 column groups of each row group
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float m = rmax[r];
        int mi = ridx[r];
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1) {
          const float om = __shfl_xor_sync(0xffffffffu, m, off);
          const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
          if (better(om, oi, m, mi)) {
            m = om;
            mi = oi;
          }
        }
        const int q = q0 + ty * 8 + r;
        if (tx == 0 && q < Q) {
          lg[q] = m;
          lgi[q] = mi;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// vis [A,V,D] bf16, txt [B,Q,D] bf16, vbias [A,V] f32, tbias [B,Q] f32;
// logit/logit_idx [B,A,Q] f32/i32, logit_v/logit_v_idx [B,A,V] f32/i32.
// Returns cudaGetLastError().
int match_fwd_launch(const void* vis, const void* txt, const float* vbias,
                     const float* tbias, float* logit, int* logit_idx,
                     float* logit_v, int* logit_v_idx, int A, int V, int D,
                     int B, int Q, void* stream) {
  if (A <= 0 || B <= 0 || Q <= 0 || V <= 0) return 0;
  dim3 grid(A, (B + kCapTile - 1) / kCapTile);
  match_fwd_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(vis),
      reinterpret_cast<const __nv_bfloat16*>(txt), vbias, tbias, logit, logit_idx,
      logit_v, logit_v_idx, A, V, D, B, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
