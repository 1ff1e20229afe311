// Fused matching maxes, backward: K6.
//
// Replaces the TPU kernel `_bwd_kernel` of vlgae_tpu/ops/match_pallas.py
// (launched by `_match_bwd`). With the first-winner indices of the forward
// (K5, csrc/match_fwd.cu) and the cotangents dm = d logit [B,A,Q], dmv =
// d logit_v [B,A,V], the weight of the cell (b, a, q, v) is
//   w = bf16( dm[b,a,q]·[idx[b,a,q]==v] + dmv[b,a,v]·[vidx[b,a,v]==q] )
// (rounded AFTER the two directions are summed, as the TPU kernel does), and
//   dvis[a,v,:] = sum_{b,q} w · txt[b,q,:]      dtxt[b,q,:] = sum_{a,v} w · vis[a,v,:]
// with f32 accumulation; both results are stored as bf16.
//
// The TPU kernel builds the dense winner mask and runs two masked GEMMs
// because its matrix unit wants them. Here the sums are gathered over the
// winners only: a row (a, v) of dvis receives, for every caption b, the row
// txt[b, vidx[b,a,v]] (its q-direction winner) plus the rows txt[b,q] of the
// cells whose v-direction winner is v; per image that is at most B·V + B·Q
// non-zero weights instead of a B·Q x V mask. The two outputs are the same
// computation with the roles of (image, v) and (caption, q) swapped, so one
// kernel serves both:
//   owner rows n of group g (dvis: v of image a; dtxt: q of caption b),
//   partner rows m of group o (dvis: q of caption b; dtxt: v of image a),
//   own_win  = the partner winner of an owner row  (dvis: vidx; dtxt: idx),
//   cross_win = the owner winner of a partner row  (dvis: idx;  dtxt: vidx).
//
// Owner computes, no float atomics: one block owns kRows output rows of one
// group and one slice of the partner groups o (split-K: real winners
// concentrate on a few rows, so a row's contributions are spread over
// several blocks), accumulates them in shared memory, each thread a fixed
// set of feature columns, adding contributions in a fixed order (ascending
// o, then ascending m), and writes an f32 partial; a second kernel adds the
// partials of each element in slice order and rounds to bf16. Two runs
// give bit-identical gradients.
//   part 1: for every o, the owner row's own winner m, weight
//           bf16(own_cot + cross_cot if that partner's winner is the row);
//   part 2: for every o, the partner rows m whose winner lies in the tile
//           (and that are not the row's own winner, already counted), weight
//           bf16(cross_cot); found by scanning cross_win in chunks and
//           compacting the hits in order with warp ballots.
//
// Bound: at the recipe training shape (A=B=64, Q=102, V=739, D=128) about
// 2·64·64·(739+102)·128 ≈ 0.9 GFLOP of gathered FMA plus the scans of the
// index tables (part 2 reads B·Q entries per dvis tile and A·V per dtxt
// tile, over all slices); latency of the gathers and the scans, not FLOPs.
// Tensor cores, TMA and a compacted winner list shared across tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // owner rows per block
// kRows * kMaxD * 4 bytes = 48 KB of dynamic shared memory; with the 2 KB
// of static arrays that is over the default 48 KB, so rows_pass opts in
constexpr int kMaxD = 384;
constexpr int kUnroll = 8;     // gathered rows in flight per thread
// slices of the partner groups (split-K): dvis rows sum over captions b
// (a hot v gets at most B·Q cells), dtxt rows over images a (a hot q gets
// up to A·V cells, so more slices)
constexpr int kSplitsV = 4;
constexpr int kSplitsQ = 16;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[r_k][d] += w_k * src[off_k + d] for the listed entries k = 0..cnt-1,
// in ascending k for every (row, column): the same sums in the same order
// as a plain loop, with kUnroll gathers issued before their FMAs.
__device__ __forceinline__ void accumulate(float* acc, const __nv_bfloat16* src,
                                           const int* s_r, const float* s_w,
                                           const long long* s_off, int cnt, int D,
                                           int tid) {
  for (int k0 = 0; k0 < cnt; k0 += kUnroll) {
    for (int d = tid; d < D; d += kThreads) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = (k0 + u < cnt && s_r[k0 + u] >= 0)
                   ? __bfloat162float(src[s_off[k0 + u] + d]) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < cnt && s_r[k0 + u] >= 0) {
          float* a = acc + s_r[k0 + u] * D + d;
          *a = fmaf(s_w[k0 + u], v[u], *a);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
match_bwd_rows_kernel(const __nv_bfloat16* __restrict__ src,   // [O, M, D] partner rows
                      const int* __restrict__ own_win,         // [B, A, N]
                      const float* __restrict__ own_cot,       // [B, A, N]
                      const int* __restrict__ cross_win,       // [B, A, M]
                      const float* __restrict__ cross_cot,     // [B, A, M]
                      float* __restrict__ part,                // [S, G, N, D]
                      int G, int N, int O, int M, int D, int so, int sg) {
  extern __shared__ float acc[];  // [kRows][D]
  __shared__ int s_r[kThreads];
  __shared__ long long s_off[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ int s_cnt[kWarps];

  const int g = blockIdx.x;
  const int n0 = blockIdx.y * kRows;
  const int nr = min(kRows, N - n0);
  const int per = (O + gridDim.z - 1) / gridDim.z;
  const int o0 = blockIdx.z * per;
  const int o1 = min(O, o0 + per);
  const int no = max(0, o1 - o0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < kRows * D; e += kThreads) acc[e] = 0.f;
  __syncthreads();

  // part 1: the own winner of every owner row, for every o of the slice
  const int total1 = no * nr;
  for (int base = 0; base < total1; base += kThreads) {
    const int e = base + tid;
    int r = -1;
    if (e < total1) {
      const int o = o0 + e / nr;
      r = e - (o - o0) * nr;
      const size_t off = (size_t)o * so + (size_t)g * sg;
      const int n = n0 + r;
      const int m = own_win[off * N + n];
      if ((unsigned)m < (unsigned)M) {
        float w = own_cot[off * N + n];
        if (cross_win[off * M + m] == n) w += cross_cot[off * M + m];
        s_off[tid] = ((long long)o * M + m) * D;
        s_w[tid] = bf16_round(w);
      } else {
        r = -1;
      }
    }
    s_r[tid] = r;
    __syncthreads();
    accumulate(acc, src, s_r, s_w, s_off, min(kThreads, total1 - base), D, tid);
    __syncthreads();
  }

  // part 2: partner rows whose winner lies in this tile (other than the
  // row's own winner), in ascending (o, m) order
  for (int o = o0; o < o1; ++o) {
    const size_t off = (size_t)o * so + (size_t)g * sg;
    for (int m0 = 0; m0 < M; m0 += kThreads) {
      const int m = m0 + tid;
      bool hit = false;
      int r = 0;
      float w = 0.f;
      if (m < M) {
        const int n = cross_win[off * M + m];
        r = n - n0;
        if (r >= 0 && r < nr && own_win[off * N + n] != m) {
          hit = true;
          w = bf16_round(cross_cot[off * M + m]);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_cnt[warp] = __popc(ballot);
      __syncthreads();
      int pos = __popc(ballot & ((1u << lane) - 1u));
      int total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k < warp) pos += s_cnt[k];
        total += s_cnt[k];
      }
      if (hit) {
        s_r[pos] = r;
        s_off[pos] = ((long long)o * M + m) * D;
        s_w[pos] = w;
      }
      __syncthreads();
      accumulate(acc, src, s_r, s_w, s_off, total, D, tid);
      __syncthreads();
    }
  }

  float* dst = part + (((size_t)blockIdx.z * G + g) * N + n0) * D;
  for (int e = tid; e < nr * D; e += kThreads) dst[e] = acc[e];
}

// out[i] = bf16(sum over slices z, in order, of part[z][i])
__global__ void match_bwd_reduce_kernel(const float* __restrict__ part,
                                        __nv_bfloat16* __restrict__ out,
                                        int S, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int z = 1; z < S; ++z) acc += part[(size_t)z * n + i];
    out[i] = __float2bfloat16_rn(acc);
  }
}

int splits(int O, int k) { return O < k ? O : k; }

// One direction: the partial sums of every slice, then their reduction.
cudaError_t rows_pass(const __nv_bfloat16* src, const int* own_win,
                      const float* own_cot, const int* cross_win,
                      const float* cross_cot, __nv_bfloat16* out, float* part,
                      int G, int N, int O, int M, int D, int so, int sg, int S,
                      cudaStream_t s) {
  dim3 grid(G, (N + kRows - 1) / kRows, S);
  const size_t smem = (size_t)kRows * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      match_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((size_t)kRows * kMaxD * sizeof(float)));
  if (err != cudaSuccess) return err;
  match_bwd_rows_kernel<<<grid, kThreads, smem, s>>>(
      src, own_win, own_cot, cross_win, cross_cot, part, G, N, O, M, D, so, sg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)G * N * D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  match_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(part, out, S, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of the workspace that match_bwd_launch needs.
long long match_bwd_workspace(int A, int V, int D, int B, int Q) {
  const long long wv = (long long)splits(B, kSplitsV) * A * V * D;
  const long long wq = (long long)splits(A, kSplitsQ) * B * Q * D;
  return wv > wq ? wv : wq;
}

// vis [A,V,D] bf16, txt [B,Q,D] bf16; idx [B,A,Q] i32 (v winners), vidx
// [B,A,V] i32 (q winners); dm [B,A,Q], dmv [B,A,V] f32 cotangents;
// dvis [A,V,D], dtxt [B,Q,D] bf16 outputs; work: match_bwd_workspace()
// floats. D <= 384. Returns cudaGetLastError() (cudaErrorInvalidValue for
// an unsupported D).
int match_bwd_launch(const void* vis, const void* txt, const int* idx,
                     const int* vidx, const float* dm, const float* dmv,
                     void* dvis, void* dtxt, float* work, int A, int V, int D,
                     int B, int Q, void* stream) {
  if (D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (A <= 0 || B <= 0 || Q <= 0 || V <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* vis_p = reinterpret_cast<const __nv_bfloat16*>(vis);
  const __nv_bfloat16* txt_p = reinterpret_cast<const __nv_bfloat16*>(txt);
  // dvis: owner (a, v), partner (b, q); offset into [B, A, *] = b*A + a
  cudaError_t err = rows_pass(txt_p, vidx, dmv, idx, dm,
                              reinterpret_cast<__nv_bfloat16*>(dvis), work,
                              A, V, B, Q, D, /*so=*/A, /*sg=*/1,
                              splits(B, kSplitsV), s);
  if (err != cudaSuccess) return (int)err;
  // dtxt: owner (b, q), partner (a, v); offset = b*A + a
  return (int)rows_pass(vis_p, idx, dm, vidx, dmv,
                        reinterpret_cast<__nv_bfloat16*>(dtxt), work,
                        B, Q, A, V, D, /*so=*/1, /*sg=*/A,
                        splits(A, kSplitsQ), s);
}

}  // extern "C"
