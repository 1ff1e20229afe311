// The held experts of a routed MoE layer, grouped SwiGLU MLP: K7.
//
// Replaces no TPU kernel: the JAX package has no routed encoder. It was
// added with the granite-4.0-h caption encoder (models/granite_hybrid.py),
// whose MoE layers hold a slice [e0, e1) of the router's experts. A plain
// form either loops over the experts (a `nonzero` and a host sync each) or
// computes every held expert for every position; this kernel does neither.
//
// Given the normed states x [T, H] (bf16), each position's top-k expert ids
// sel [T, K] (int64) and gates [T, K] (f32), the real-position mask [T] and
// the held experts' weights W_in [nh, 2I, H] (rows 0..I-1 gate, I..2I-1 up)
// and W_out [nh, H, I] (bf16), it writes
//   out[t, :] = sum over slots k in order, sel[t, k] in [e0, e1), mask[t]:
//               gates[t, k] * W_out[e] · bf16(silu(g) * u),
//   (g, u)    = W_in[e] · x[t]          (bf16 operands, f32 sums)
// with e = sel[t, k] - e0; 0 where a position has no held expert.
//
// Six launches on the caller's stream, no host sync, no float atomics, the
// same bits on every rerun:
//  1. route (count): a block per 128 positions; each position's held
//     experts as a bit mask, counted per expert by warp ballots.
//  2. plan: one block; per expert its pair count and start (experts in
//     order, pairs of an expert in position order), each route block's
//     offset for each expert, and the table of GEMM tiles: (expert, first
//     pair, rows) for every BM pairs of an expert.
//  3. route (scatter): the same ballots rank each (position, expert) pair;
//     its row takes the position and the gate, and pair_pos[t, k] names the
//     row of slot k (-1: not held, or not a real position).
//  4. up: persistent blocks walk (tile, column block) items, column blocks
//     slowest, so blocks in flight share one block of an expert's weights
//     in L2. A 64 x 128 tile: the pairs' rows of x gathered by cp.async,
//     the gate and up rows j0..j0+63 of W_in, bf16 WMMA with f32 sums,
//     SwiGLU in the epilogue, the activation stored as bf16 [pairs, I].
//  5. down: the same walk over the activation and W_out, the epilogue
//     scales by the pair's gate and stores f32 rows y [pairs, H].
//  6. combine: out[t] = sum over k of y[pair_pos[t, k]] in slot order.
//
// Bound (flops/granite.py): each held expert with a pair reads its 2·3·H·I
// bytes of weights once; 2·3·H·I operations a pair. At the granite layer
// (H = 4096, I = 768, 9 of 72 experts, about 2,000 pairs of 1,600
// positions) both are about 50 us; y's f32 round trip (about 30 MB) is what
// this first design adds beyond them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace k7 {

constexpr int kRouteTokens = 128;  // positions of a route block (4 warps)
constexpr int kMaxHeld = 64;       // held experts: one 64-bit mask a position
constexpr int kMaxTopK = 16;
constexpr int BM = 64;             // pairs of a GEMM tile
constexpr int BN = 128;            // output columns of a GEMM tile
constexpr int BK = 32;             // depth of a stage
constexpr int LDS = BK + 8;        // shared row of a stage (bf16), 80 bytes
constexpr int LDC = BN + 4;        // shared row of the epilogue (f32)
constexpr int kThreads = 256;      // 8 warps: 2 x 4 of 32 x 32
constexpr int kStageBytes = (BM + BN) * LDS * 2;
constexpr int kSmemBytes =
    (2 * kStageBytes > BM * LDC * 4) ? 2 * kStageBytes : BM * LDC * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = full ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Route: the held experts of position t as a mask, ranked by ballots. With
// SCATTER false the block's counts per expert go to count[block][e]; with it
// true, each pair is placed at off[block][e] + its rank in the block.
template <bool SCATTER>
__global__ void __launch_bounds__(kRouteTokens) moe_route(
    const long long* __restrict__ sel, const float* __restrict__ gates,
    const bool* __restrict__ mask, int T, int K, int e0, int nh, int* __restrict__ count,
    const int* __restrict__ off, int* __restrict__ row_token, float* __restrict__ row_gate,
    int* __restrict__ pair_pos) {
  __shared__ int warp_count[kRouteTokens / 32][kMaxHeld];
  const int t = blockIdx.x * kRouteTokens + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long held = 0;
  int slot_of[kMaxTopK];
  if (t < T) {
    const bool live = mask[t];
    for (int k = 0; k < K; ++k) {
      const long long e = sel[(long long)t * K + k] - e0;
      slot_of[k] = (live && e >= 0 && e < nh) ? static_cast<int>(e) : -1;
      if (slot_of[k] >= 0) held |= 1ull << slot_of[k];
      if (SCATTER) pair_pos[(long long)t * K + k] = -1;
    }
  }
  for (int e = 0; e < nh; ++e) {
    const unsigned b = __ballot_sync(0xffffffffu, (held >> e) & 1ull);
    if (lane == 0) warp_count[warp][e] = __popc(b);
  }
  __syncthreads();
  if (!SCATTER) {
    for (int e = threadIdx.x; e < nh; e += blockDim.x) {
      int s = 0;
      for (int w = 0; w < kRouteTokens / 32; ++w) s += warp_count[w][e];
      count[blockIdx.x * nh + e] = s;
    }
    return;
  }
  const unsigned lower = (1u << lane) - 1u;
  for (int e = 0; e < nh; ++e) {
    const unsigned b = __ballot_sync(0xffffffffu, (held >> e) & 1ull);
    if ((held >> e) & 1ull) {
      int pos = off[blockIdx.x * nh + e] + __popc(b & lower);
      for (int w = 0; w < warp; ++w) pos += warp_count[w][e];
      for (int k = 0; k < K; ++k) {
        if (slot_of[k] == e) {
          pair_pos[(long long)t * K + k] = pos;
          row_token[pos] = t;
          row_gate[pos] = gates[(long long)t * K + k];
        }
      }
    }
  }
}

// Plan: expert starts, each route block's offsets, the tile table.
__global__ void moe_plan(const int* __restrict__ count, int n_rt, int nh, int* __restrict__ off,
                         int* __restrict__ tiles, int* __restrict__ n_tiles) {
  __shared__ int total[kMaxHeld];
  __shared__ int start[kMaxHeld + 1];
  const int e = threadIdx.x;
  if (e < nh) {
    int s = 0;
    for (int b = 0; b < n_rt; ++b) s += count[b * nh + e];
    total[e] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    start[0] = 0;
    int nt = 0;
    for (int x = 0; x < nh; ++x) {
      start[x + 1] = start[x] + total[x];
      for (int r = 0; r < total[x]; r += BM) {
        tiles[3 * nt] = x;
        tiles[3 * nt + 1] = start[x] + r;
        tiles[3 * nt + 2] = min(BM, total[x] - r);
        ++nt;
      }
    }
    *n_tiles = nt;
  }
  __syncthreads();
  if (e < nh) {
    int s = start[e];
    for (int b = 0; b < n_rt; ++b) {
      off[b * nh + e] = s;
      s += count[b * nh + e];
    }
  }
}

// One grouped GEMM. UP: A = x rows gathered by row_token (K = H), B = the
// gate and up rows of W_in[e] (64 each), out = act [pairs, I] (bf16).
// DOWN: A = act rows (K = I), B = rows n0..n0+127 of W_out[e], out = y
// [pairs, H] (f32, times the pair's gate).
template <bool UP>
__global__ void __launch_bounds__(kThreads) moe_gemm(
    const __nv_bfloat16* __restrict__ a_src, const int* __restrict__ row_token,
    const float* __restrict__ row_gate, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ tiles, const int* __restrict__ n_tiles_ptr, int H, int I,
    __nv_bfloat16* __restrict__ act, float* __restrict__ y) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int Kd = UP ? H : I;               // the product's depth
  const int n_cols = UP ? I / (BN / 2) : H / BN;  // column blocks
  const int n_tiles = *n_tiles_ptr;
  const int items = n_tiles * n_cols;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;  // the warp's 32 x 32 of the tile
  const int nk = Kd / BK;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % n_tiles, col = item / n_tiles;
    const int e = tiles[3 * tile], row0 = tiles[3 * tile + 1], rows = tiles[3 * tile + 2];
    const __nv_bfloat16* we = w + (long long)e * (UP ? 2LL * I * H : (long long)H * I);

    // this thread's A chunk (one of BM x BK/8) and B chunks (two of BN x BK/8)
    const int ar = tid >> 2, ac = (tid & 3) * 8;
    const bool a_full = ar < rows;
    const __nv_bfloat16* a_row;
    if (UP) {
      a_row = a_src + (long long)(a_full ? row_token[row0 + ar] : row_token[row0]) * H;
    } else {
      a_row = a_src + (long long)(row0 + (a_full ? ar : 0)) * I;
    }
    const __nv_bfloat16* b_row[2];
    for (int q = 0; q < 2; ++q) {
      const int br = ar + 64 * q;
      int wrow;
      if (UP) {
        const int j0 = col * (BN / 2);
        wrow = br < 64 ? j0 + br : I + j0 + (br - 64);
      } else {
        wrow = col * BN + br;
      }
      b_row[q] = we + (long long)wrow * Kd;
    }

    auto load_stage = [&](int stage, int kt) {
      __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + stage * kStageBytes);
      __nv_bfloat16* Bs = As + BM * LDS;
      const int k0 = kt * BK + ac;
      cp_async16(As + ar * LDS + ac, a_row + k0, a_full);
      for (int q = 0; q < 2; ++q) cp_async16(Bs + (ar + 64 * q) * LDS + ac, b_row[q] + k0, true);
      cp_async_commit();
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    load_stage(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load_stage((kt + 1) & 1, kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* As =
          reinterpret_cast<const __nv_bfloat16*>(smem + (kt & 1) * kStageBytes);
      const __nv_bfloat16* Bs = As + BM * LDS;
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * LDS + kk, LDS);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (wc * 32 + j * 16) * LDS + kk, LDS);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

    float* Cs = reinterpret_cast<float*>(smem);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
    if (UP) {
      const int j0 = col * (BN / 2);
      for (int idx = tid; idx < BM * (BN / 2); idx += kThreads) {
        const int r = idx / (BN / 2), c = idx % (BN / 2);
        if (r < rows) {
          const float g = Cs[r * LDC + c], u = Cs[r * LDC + BN / 2 + c];
          act[(long long)(row0 + r) * I + j0 + c] = __float2bfloat16(g / (1.0f + expf(-g)) * u);
        }
      }
    } else {
      const int n0 = col * BN;
      for (int idx = tid; idx < BM * (BN / 4); idx += kThreads) {
        const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        if (r < rows) {
          const float gw = row_gate[row0 + r];
          const float* src = Cs + r * LDC + c;
          *reinterpret_cast<float4*>(y + (long long)(row0 + r) * H + n0 + c) =
              make_float4(src[0] * gw, src[1] * gw, src[2] * gw, src[3] * gw);
        }
      }
    }
    __syncthreads();  // Cs is the next item's stage 0
  }
}

// out[t] = sum over slots k in order of y[pair_pos[t, k]]; 0 with none.
__global__ void __launch_bounds__(256) moe_combine(const float* __restrict__ y,
                                                   const int* __restrict__ pair_pos, int K,
                                                   int H, float* __restrict__ out) {
  const int t = blockIdx.x;
  int pos[kMaxTopK];
  for (int k = 0; k < K; ++k) pos[k] = pair_pos[(long long)t * K + k];
  for (int c = threadIdx.x * 4; c < H; c += blockDim.x * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < K; ++k) {
      if (pos[k] >= 0) {
        const float4 v = *reinterpret_cast<const float4*>(y + (long long)pos[k] * H + c);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    *reinterpret_cast<float4*>(out + (long long)t * H + c) = s;
  }
}

}  // namespace k7

using namespace k7;

extern "C" {

int moe_max_held() { return kMaxHeld; }
int moe_max_top_k() { return kMaxTopK; }
int moe_tile_rows() { return BM; }
int moe_route_tokens() { return kRouteTokens; }

// x [T, H] bf16; sel [T, K] int64; gates [T, K] f32; mask [T] bool; w_in
// [nh, 2I, H], w_out [nh, H, I] bf16; out [T, H] f32. Scratch laid out by
// the caller (ops/moe.py::moe_plan): ints = count and off [n_rt, nh] each,
// row_token [P], pair_pos [T, K], tiles [max_tiles, 3], n_tiles [1];
// row_gate [P] f32; act [P, I] bf16; y [P, H] f32, P = T * min(K, nh) the
// most pairs there can be. `blocks`: the GEMMs' persistent grid. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for shapes
// the kernel does not take).
int moe_experts_launch(const void* x, const long long* sel, const float* gates,
                       const bool* mask, const void* w_in, const void* w_out, float* out,
                       int* ints, float* row_gate, void* act, float* y, int T, int K, int H,
                       int I, int e0, int nh, int max_tiles, int blocks, void* stream) {
  if (nh <= 0 || nh > kMaxHeld || K <= 0 || K > kMaxTopK || H % BN || I % (BN / 2) ||
      H % BK || I % BK || T < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_rt = (T + kRouteTokens - 1) / kRouteTokens;
  const long long P = (long long)T * (K < nh ? K : nh);
  int* count = ints;
  int* off = count + n_rt * nh;
  int* row_token = off + n_rt * nh;
  int* pair_pos = row_token + P;
  int* tiles = pair_pos + (long long)T * K;
  int* n_tiles = tiles + 3 * max_tiles;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* actb = reinterpret_cast<__nv_bfloat16*>(act);

  moe_route<false><<<n_rt, kRouteTokens, 0, s>>>(sel, gates, mask, T, K, e0, nh, count,
                                                 nullptr, nullptr, nullptr, nullptr);
  moe_plan<<<1, kMaxHeld, 0, s>>>(count, n_rt, nh, off, tiles, n_tiles);
  moe_route<true><<<n_rt, kRouteTokens, 0, s>>>(sel, gates, mask, T, K, e0, nh, nullptr, off,
                                                row_token, row_gate, pair_pos);
  moe_gemm<true><<<blocks, kThreads, 0, s>>>(xb, row_token, row_gate,
                                             reinterpret_cast<const __nv_bfloat16*>(w_in),
                                             tiles, n_tiles, H, I, actb, nullptr);
  moe_gemm<false><<<blocks, kThreads, 0, s>>>(actb, row_token, row_gate,
                                              reinterpret_cast<const __nv_bfloat16*>(w_out),
                                              tiles, n_tiles, H, I, nullptr, y);
  moe_combine<<<T, 256, 0, s>>>(y, pair_pos, K, H, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
