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
// because its matrix unit wants them. Only about B·A·(Q+V) of the B·A·Q·V
// weights are non-zero, so here every output row gathers its winners' rows.
// The two outputs are one computation with the roles of (image, v) and
// (caption, q) swapped; a "direction" names
//   owner rows n of group g   (dvis: v of image a;   dtxt: q of caption b),
//   partner rows m of group o (dvis: q of caption b; dtxt: v of image a),
//   own_win   = the partner winner of an owner row (dvis: vidx; dtxt: idx),
//   cross_win = the owner winner of a partner row  (dvis: idx;  dtxt: vidx).
// The row (g, n) sums, in this order,
//   own partners:   for o = 0..O-1, m = own_win(o,g,n), weight
//                   bf16(own_cot + cross_cot if cross_win(o,g,m) == n);
//   cross partners: the (o, m) with cross_win(o,g,m) == n other than the own
//                   one (already counted), weight bf16(cross_cot), in
//                   ascending (o, m).
//
// Three launches, no float atomics, bit-identical reruns:
//  1. build: a block per group (a caption or an image of the index table)
//     writes the group's partners grouped by owner row, stable, as a list
//     of o·M + m (integer counts in shared memory: a count walk and a place
//     walk, each warp over a fixed range of the group's cells, equal keys
//     ranked by warp ballots), and the start of every row in the
//     "positions" of its direction: row (g, n) holds O own positions, then
//     its cross positions. A key outside [0, N) goes to a pseudo-row n = N
//     of its group that is never written.
//  2. rows: the positions of a direction are cut into segments of S; a warp
//     takes one segment and walks it 32 positions at a time: each lane
//     decodes one position (row, partner, weight), the weighted ones are
//     compacted in order into shared memory, then the warp takes each row
//     of the step in turn and gathers its partner rows, 4 in flight, each
//     one coalesced load of 8 bytes a lane (4 features a lane; a 2-byte
//     scalar path for D % 4 != 0 or unaligned operands), summing them in
//     registers. A row that lies wholly in the segment is stored as bf16; a
//     row cut by a segment boundary stores an f32 partial in one of two
//     slots of the segment (slot 0: the row that began before it, slot 1:
//     the row that goes on after it).
//  3. finish: a warp for each segment in which a cut row ends adds that
//     row's partials in segment order and stores bf16.
//
// Bound: every winning cell is gathered once for dvis and once for dtxt
// (about 6.4 M rows of 256 bytes at the recipe training shape A=B=64, Q=102,
// V=739, D=128), from L2: vis (12.1 MB) and txt (1.7 MB) stay in the 50 MB
// L2, as do the index tables the decode reads (scattered 4-byte loads, 2-4
// a position): about 2.4 GB of L2 traffic a call at that shape, against
// 1.6 GFLOP of FMAs, so L2 throughput, not arithmetic, is the wall. More
// rows in flight (8, 16, 32) and more warps a multiprocessor measured
// slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 384;
constexpr int kWarpsPerBlock = 4;     // rows and finish kernels
constexpr int kKeysAhead = 8;         // keys a lane loads before ranking them
constexpr int kRowsInFlight = 4;      // partner rows a warp loads before summing
constexpr unsigned kFull = 0xffffffffu;

struct Dir {
  const __nv_bfloat16* src;   // [O, M, D] partner rows
  const int* own_win;         // [B, A, N]
  const float* own_cot;       // [B, A, N]
  const int* cross_win;       // [B, A, M]
  const float* cross_cot;     // [B, A, M]
  int* list;                  // [G, O*M] partners grouped by owner row
  int* pos;                   // [G*(N+1) + 1] first position of each row
  __nv_bfloat16* out;         // [G, N, D]
  int G, N, O, M, so, sg;     // (o, g) -> index table row o*so + g*sg
  int T;                      // positions: G*O*(N + M)
  int chunk0;                 // first segment of this direction
  int warps;                  // build warps a group
};

struct Dirs {
  Dir d[2];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------- build

// the lanes whose key equals this lane's, among the lanes with a key >= 0,
// by one ballot per bit of the keys (keys < 2^bits): __match_any_sync's
// result at a fraction of its cost
__device__ __forceinline__ unsigned same_key(int key, int bits) {
  unsigned same = __ballot_sync(kFull, key >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool set = (key >> b) & 1;
    const unsigned on = __ballot_sync(kFull, set);
    same &= set ? on : ~on;
  }
  return same;
}

// A block per group (the groups of direction 0, then of direction 1); warp
// w walks the partner groups o of a fixed range, each a row of M cells in
// canonical order. The count walk adds 1 for each cell to its warp's count
// of the cell's key (integer shared-memory atomics: the counts, not their
// order, matter). The place walk takes the same cells in the same order,
// ranks equal keys of one step of 32 lanes with same_key(), and writes
// each cell at its warp's running position for its key plus its rank.
__global__ void match_bwd_build_kernel(Dirs dirs) {
  extern __shared__ int sm[];
  const int dir = blockIdx.x >= dirs.d[0].G;
  const Dir& p = dirs.d[dir];
  const int g = blockIdx.x - (dir ? dirs.d[0].G : 0);
  const int N1 = p.N + 1, W = p.warps, M = p.M;
  const long long cells = (long long)p.O * M;
  int* cnt = sm;              // [W][N1]: counts, then running positions
  int* tot = cnt + W * N1;    // [N1]: totals, then first cross position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int o_lo = p.O * warp / W, o_hi = p.O * (warp + 1) / W;
  const int bits = 32 - __clz(p.N);  // keys 0..N
  int* list = p.list + (size_t)g * cells;

  for (int e = tid; e < W * N1; e += blockDim.x) cnt[e] = 0;
  __syncthreads();

  // one walk over the warp's cells; the key of (o, m) is its owner row, or
  // N when it names none, and below 0 past the row's end
  auto walk = [&](bool place) {
    for (int o = o_lo; o < o_hi; ++o) {
      const int* row = p.cross_win + ((size_t)o * p.so + (size_t)g * p.sg) * M;
      for (int m0 = 0; m0 < M; m0 += 32 * kKeysAhead) {
        int keys[kKeysAhead];
#pragma unroll
        for (int b = 0; b < kKeysAhead; ++b) {
          const int m = m0 + 32 * b + lane;
          const int n = m < M ? __ldg(row + m) : -1;
          keys[b] = m >= M ? -1 - lane : (unsigned)n < (unsigned)p.N ? n : p.N;
        }
#pragma unroll
        for (int b = 0; b < kKeysAhead; ++b) {
          const int key = keys[b];
          if (!place) {
            if (key >= 0) atomicAdd(cnt + warp * N1 + key, 1);
            continue;
          }
          if (m0 + 32 * b >= M) break;
          const unsigned same = same_key(key, bits);
          if (key >= 0) list[cnt[warp * N1 + key] + __popc(same & lt)] = o * M + m0 + 32 * b + lane;
          __syncwarp();
          if (key >= 0 && (same & lt) == 0) cnt[warp * N1 + key] += __popc(same);
          __syncwarp();
        }
      }
    }
  };

  if (warp < W) walk(false);
  __syncthreads();
  for (int n = tid; n < N1; n += blockDim.x) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const int c = cnt[w * N1 + n];
      cnt[w * N1 + n] = run;
      run += c;
    }
    tot[n] = run;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the totals over the rows
    int carry = 0;
    for (int n0 = 0; n0 < N1; n0 += 32) {
      const int n = n0 + lane;
      const int v = n < N1 ? tot[n] : 0;
      int inc = v;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, s);
        if (lane >= s) inc += t;
      }
      if (n < N1) tot[n] = carry + inc - v;
      carry += __shfl_sync(kFull, inc, 31);
    }
  }
  __syncthreads();
  for (int n = tid; n < N1; n += blockDim.x) {
    // O own positions of each earlier row, then the cross ones
    p.pos[(size_t)g * N1 + n] = (g * p.N + n) * p.O + (int)(g * cells) + tot[n];
    for (int w = 0; w < W; ++w) cnt[w * N1 + n] += tot[n];
  }
  if (g == p.G - 1 && tid == 0) p.pos[(size_t)p.G * N1] = p.T;
  __syncthreads();
  if (warp < W) walk(true);
}

// ----------------------------------------------------------------- rows

// features of a lane: VEC consecutive ones in each of NG groups of 32·VEC
template <int VEC, int NG>
struct Row {
  float a[NG][VEC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[j][e] = 0.f;
  }
};

template <int VEC, int NG>
struct Raw {
  // VEC = 4: one 8-byte load a group; VEC = 1: one bf16 a group
  uint2 v[NG];
};

template <int VEC, int NG>
__device__ __forceinline__ void load_row(Raw<VEC, NG>& r, const __nv_bfloat16* row,
                                         int lane, int D) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int f = j * 32 * VEC + lane * VEC;
    if (f < D) {
      if constexpr (VEC == 4) {
        r.v[j] = __ldg(reinterpret_cast<const uint2*>(row + f));
      } else {
        r.v[j].x = __ldg(reinterpret_cast<const unsigned short*>(row + f));
      }
    }
  }
}

template <int VEC, int NG>
__device__ __forceinline__ void fma_row(Row<VEC, NG>& acc, const Raw<VEC, NG>& r,
                                        float w, int lane, int D) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int f = j * 32 * VEC + lane * VEC;
    if (f < D) {
      if constexpr (VEC == 4) {
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.v[j].x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.v[j].y));
        acc.a[j][0] = fmaf(w, lo.x, acc.a[j][0]);
        acc.a[j][1] = fmaf(w, lo.y, acc.a[j][1]);
        acc.a[j][2] = fmaf(w, hi.x, acc.a[j][2]);
        acc.a[j][3] = fmaf(w, hi.y, acc.a[j][3]);
      } else {
        const float x = __uint_as_float(r.v[j].x << 16);
        acc.a[j][0] = fmaf(w, x, acc.a[j][0]);
      }
    }
  }
}

// store a finished row as bf16, or its partial as f32
template <int VEC, int NG>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const Row<VEC, NG>& acc,
                                           int lane, int D) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int f = j * 32 * VEC + lane * VEC;
    if (f < D) {
      if constexpr (VEC == 4) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc.a[j][0], acc.a[j][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc.a[j][2], acc.a[j][3]);
        uint2 u;
        u.x = *reinterpret_cast<unsigned*>(&lo);
        u.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(dst + f) = u;
      } else {
        dst[f] = __float2bfloat16_rn(acc.a[j][0]);
      }
    }
  }
}

template <int VEC, int NG>
__device__ __forceinline__ void store_f32(float* dst, const Row<VEC, NG>& acc, int lane,
                                          int D) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int f = j * 32 * VEC + lane * VEC;
    if (f < D) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[f + e] = acc.a[j][e];
    }
  }
}

template <int VEC, int NG, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
match_bwd_rows_kernel(Dirs dirs, float* __restrict__ work, int* __restrict__ fin,
                      int D, int S, int chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= chunks) return;
  const Dir& p = dirs.d[c >= dirs.d[1].chunk0];
  const int N = p.N, N1 = p.N + 1, O = p.O, M = p.M;
  const int R = p.G * N1;
  const int p0 = (c - p.chunk0) * S;
  const int p1 = min(p0 + S, p.T);
  const int* __restrict__ pos = p.pos;
  __shared__ int2 ents[kWarpsPerBlock][32];  // (partner, weight) of a step
  int2* ent = ents[threadIdx.x >> 5];
  if (lane == 0) fin[c] = -1;

  // the row that holds p0: a 32-way search over the row starts
  int lo = 0, hi = R;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, i < hi && __ldg(pos + i) <= p0);
    lo += (31 - __clz(le)) * step;
    hi = min(lo + step, hi);
  }
  int r_base = lo;

  Row<VEC, NG> acc;
  acc.zero();
  int cur = -1, cur_s = 0, cur_e = 0;

  auto flush = [&]() {
    const int g = cur / N1, n = cur - g * N1;
    if (n == N) return;  // keys that name no owner row
    if (cur_s >= p0 && cur_e <= p1) {
      store_bf16(p.out + ((size_t)g * N + n) * D, acc, lane, D);
    } else {
      const int slot = cur_s < p0 ? 0 : 1;
      store_f32(work + ((size_t)c * 2 + slot) * D, acc, lane, D);
      if (slot == 0 && cur_e <= p1 && lane == 0) fin[c] = cur;
    }
  };

  for (int b0 = p0; b0 < p1;) {
    // starts and ends of the 32 rows from r_base (rows may be empty only
    // when they are pseudo-rows)
    const int r = r_base + lane;
    const int s_l = r < R ? __ldg(pos + r) : INT32_MAX;
    const int e_l = r < R ? __ldg(pos + r + 1) : INT32_MAX;
    const int bend = min(min(b0 + 32, p1), __shfl_sync(kFull, e_l, 31));
    const int q = b0 + lane;
    const bool active = q < bend;
    int kk = 0;  // the last of those rows that starts at or before q
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, s_l, kk + step) <= q) kk += step;
    }
    const int row_s = __shfl_sync(kFull, s_l, kk);
    const int row_e = __shfl_sync(kFull, e_l, kk);
    const int row = r_base + kk;

    // decode this lane's position: partner row and weight
    float w = 0.f;
    int partner = 0;
    if (active) {
      const int g = row / N1, n = row - g * N1;
      const int k = q - row_s;
      if (n < N) {
        if (k < O) {
          const size_t t = (size_t)k * p.so + (size_t)g * p.sg;
          const int m = __ldg(p.own_win + t * N + n);
          if ((unsigned)m < (unsigned)M) {
            float x = __ldg(p.own_cot + t * N + n);
            if (__ldg(p.cross_win + t * M + m) == n) x += __ldg(p.cross_cot + t * M + m);
            w = bf16_round(x);
            partner = k * M + m;
          }
        } else {
          // row (g, n) starts at (g*N + n)*O + (its first list entry)
          const int e = __ldg(p.list + (q - (g * N + n + 1) * O));
          const int o = e / M, m = e - o * M;
          const size_t t = (size_t)o * p.so + (size_t)g * p.sg;
          if (__ldg(p.own_win + t * N + n) != m) {
            w = bf16_round(__ldg(p.cross_cot + t * M + m));
            partner = e;
          }
        }
      }
    }
    // the weighted positions, compacted in order into this warp's slots
    const unsigned lt = (1u << lane) - 1u;
    const unsigned nz = __ballot_sync(kFull, active && w != 0.f);
    if (active && w != 0.f) ent[__popc(nz & lt)] = make_int2(partner, __float_as_int(w));
    __syncwarp();
    // the runs of one row each: from the batch's first position and from
    // every position where a row starts
    unsigned starts = __ballot_sync(kFull, active && (lane == 0 || q == row_s));
    while (starts) {
      const int j0 = __ffs(starts) - 1;
      starts &= starts - 1;
      const unsigned upto = starts ? (1u << (__ffs(starts) - 1)) - 1u : kFull;
      const int ru = __shfl_sync(kFull, row, j0);
      const int su = __shfl_sync(kFull, row_s, j0);
      const int eu = __shfl_sync(kFull, row_e, j0);
      if (ru != cur) {
        if (cur >= 0) flush();
        cur = ru;
        cur_s = su;
        cur_e = eu;
        acc.zero();
      }
      const int i1 = __popc(nz & upto);
      for (int i = __popc(nz & ((1u << j0) - 1u)); i < i1; i += U) {
        Raw<VEC, NG> raw[U];
        int2 eu2[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i + u < i1) {
            eu2[u] = ent[i + u];
            load_row(raw[u], p.src + (size_t)eu2[u].x * D, lane, D);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i + u < i1) fma_row(acc, raw[u], __int_as_float(eu2[u].y), lane, D);
        }
      }
    }
    __syncwarp();

    // the first row of the next step: the last that starts at or before
    // bend (or past all 32 when every one of them ends by then)
    const int nle = __popc(__ballot_sync(kFull, s_l <= bend)) - 1;
    r_base += (nle == 31 && __shfl_sync(kFull, e_l, 31) <= bend) ? 32 : nle;
    b0 = bend;
  }
  if (cur >= 0) flush();
}

// ---------------------------------------------------------------- finish

// a row cut by segment boundaries: its slot-1 partial in the segment where
// it starts, then the slot-0 partials up to the segment c where it ends
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
match_bwd_finish_kernel(Dirs dirs, const float* __restrict__ work,
                        const int* __restrict__ fin, int D, int S, int chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= chunks) return;
  const int row = fin[c];
  if (row < 0) return;
  const Dir p = dirs.d[c >= dirs.d[1].chunk0];
  const int N1 = p.N + 1;
  const int g = row / N1, n = row - g * N1;
  const int c0 = p.chunk0 + p.pos[row] / S;
  __nv_bfloat16* dst = p.out + ((size_t)g * p.N + n) * D;
  for (int f = lane; f < D; f += 32) {
    float a = work[((size_t)c0 * 2 + 1) * D + f];
    for (int cc = c0 + 1; cc <= c; ++cc) a += work[((size_t)cc * 2) * D + f];
    dst[f] = __float2bfloat16_rn(a);
  }
}

template <int VEC, int NG>
cudaError_t launch_rows(const Dirs& dirs, float* work, int* fin, int D, int S,
                        int chunks, cudaStream_t s) {
  const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  match_bwd_rows_kernel<VEC, NG, kRowsInFlight><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      dirs, work, fin, D, S, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int match_bwd_max_d() { return kMaxD; }

// vis [A,V,D] bf16, txt [B,Q,D] bf16; idx [B,A,Q] i32 (v winners), vidx
// [B,A,V] i32 (q winners); dm [B,A,Q], dmv [B,A,V] f32 cotangents;
// dvis [A,V,D], dtxt [B,Q,D] bf16 outputs. Scratch, laid out by the caller
// (ops/match.py::match_bwd_plan): the winner lists of dvis [A, B*Q] and of
// dtxt [B, A*V], their row starts [A*(V+1)+1] and [B*(Q+1)+1], one mark a
// segment, and `work`, two rows of D floats a segment. T = A*B*(V+Q)
// positions a direction, in `per` segments of S. `vec`: 8-byte feature
// loads (D % 4 == 0, operands 8-byte aligned), else 2-byte ones. warps_*:
// warps of a build block, with build_smem bytes of shared memory. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D).
int match_bwd_launch(const void* vis, const void* txt, const int* idx,
                     const int* vidx, const float* dm, const float* dmv,
                     void* dvis, void* dtxt, int* list_vis, int* list_txt,
                     int* starts_vis, int* starts_txt, int* marks, float* work, int A,
                     int V, int D, int B, int Q, int T, int S, int per, int vec,
                     int warps_vis, int warps_txt, int build_smem, void* stream) {
  if (D <= 0 || D > kMaxD || S <= 0) return (int)cudaErrorInvalidValue;
  if (A <= 0 || B <= 0 || Q <= 0 || V <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int chunks = 2 * per;
  Dirs dirs;
  // dvis: owner (a, v), partner (b, q); index table row b*A + a
  dirs.d[0] = Dir{reinterpret_cast<const __nv_bfloat16*>(txt), vidx, dmv, idx, dm,
                  list_vis, starts_vis, reinterpret_cast<__nv_bfloat16*>(dvis),
                  A, V, B, Q, /*so=*/A, /*sg=*/1, T, 0, warps_vis};
  // dtxt: owner (b, q), partner (a, v)
  dirs.d[1] = Dir{reinterpret_cast<const __nv_bfloat16*>(vis), idx, dm, vidx, dmv,
                  list_txt, starts_txt,
                  reinterpret_cast<__nv_bfloat16*>(dtxt),
                  B, Q, A, V, /*so=*/1, /*sg=*/A, T, per, warps_txt};

  cudaError_t err = cudaFuncSetAttribute(
      match_bwd_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, build_smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (warps_vis > warps_txt ? warps_vis : warps_txt);
  match_bwd_build_kernel<<<A + B, threads, build_smem, s>>>(dirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (!vec) err = launch_rows<1, kMaxD / 32>(dirs, work, marks, D, S, chunks, s);
  else if (D <= 128) err = launch_rows<4, 1>(dirs, work, marks, D, S, chunks, s);
  else if (D <= 256) err = launch_rows<4, 2>(dirs, work, marks, D, S, chunks, s);
  else err = launch_rows<4, 3>(dirs, work, marks, D, S, chunks, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  match_bwd_finish_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(dirs, work, marks, D, S,
                                                                  chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
