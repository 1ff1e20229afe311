// Fused matching maxes, forward: K5.
//
// Replaces the TPU kernel `_fwd_kernel` of vlgae_tpu/ops/match_pallas.py
// (launched by `_fwd_impl`, with its caller-side fold). For images a and
// captions b:
//   att[b,a,q,v] = txt[b,q,:] . vis[a,v,:] + vbias[a,v] + tbias[b,q]
//   logit[b,a,q]   = max_v att,  logit_idx[b,a,q]   = first such v
//   logit_v[b,a,v] = max_q att,  logit_v_idx[b,a,v] = first such q
// bf16 operands, f32 products and accumulation, f32 biases added as
// (dot + vbias) + tbias. No [B,A,Q,V] tensor is ever stored.
//
// Bound: operations, on the bf16 tensor cores (2*A*B*Q*V*D; 75 GFLOP at the
// recipe shape A=B=64, Q=102, V=703, D=128); the inputs (14 MB) stay in L2.
//
// Design. The product runs as `wgmma.mma_async.sync.aligned.m64n104k16`
// (bf16 x bf16 -> f32): a warpgroup multiplies 64 image rows (M) by the 104
// words of a q-chunk (N) straight from shared memory, both operands K-major
// in the 128-byte swizzle, and keeps the 64 x 104 sums in 52 registers a
// thread. V = 703 is 11 tiles of 64 rows; Q = 102 is one chunk of 13 x 8
// (words as M would waste a fifth of 128 rows). The kernel is also built for
// N = 120 (captions padded to 56 words, the recipe's longest, give Q = 114:
// the most that registers and shared memory hold), 72 and 40: a batch takes
// the narrowest that holds its words in one chunk (every chunk is a pass over
// the images, with a cost of its own), and a longer one equal chunks.
//  * One block of two warpgroups serves kCapTile = 4 captions, two per
//    warpgroup, and every `groups`-th image. The captions' rows (4 x 104 x
//    128 bf16 = 104 KB) are staged once and stay resident in shared memory;
//    the rows of the block's images stream through a ring of kStages = 3
//    tiles of kVT = 64 rows (16 KB each; their 64 biases in a ring of 4),
//    copied with 16-byte `cp.async` two tiles ahead, one __syncthreads() per
//    tile; the ring runs on from one image into the next. The caller picks `groups` so
//    that the grid is about one block a multiprocessor (8 x 16 blocks at the
//    recipe shape): L2-to-shared traffic is then ceil(B/4) * (A*V + groups *
//    4*Q) * D * 2 bytes (198 MB), against 291 MB with a block per (image, 4
//    captions), whose start-up and drain were exposed eight times a
//    multiprocessor. With one image resident instead (180-189 KB) no second
//    stage of anything would fit.
//  * A tile gives a warpgroup two jobs (its two captions): eight wgmmas,
//    then the epilogue. The tensor cores idle during an epilogue and the CUDA
//    cores during the wgmmas, so warpgroup 1 runs half a job behind
//    warpgroup 0. The warpgroup index is broadcast from lane 0 and the
//    wgmmas sit in no branch that depends on a thread: otherwise ptxas waits
//    for each wgmma before it issues the next.
//  * Epilogue in registers: the biases are added to the accumulator
//    fragment (rows 16*warp + lane/4 and + 8, columns 8*j + 2*(lane%4) and
//    + 1). The max over q of a row is complete inside the job: the thread's
//    26 columns in ascending q, then the 4 lanes of the row by shuffles,
//    written once to logit_v. The max over v of a column is carried in 26
//    (value, index) register pairs per caption across the image's tiles
//    (ascending v in a thread, so `>` keeps the first winner); at the end of
//    the image its 32 candidates (8 lanes x 4 warps) go through shared
//    memory once and one thread per word picks the best and writes logit.
//    Every merge compares (value, then smaller index). Padded rows and
//    columns carry -inf and never win; a wholly masked row ties at -1e9 and
//    gives index 0.
//  * Ragged shapes: rows past V or Q and columns past D are zero in shared
//    memory. Q beyond the widest build takes more q-chunks, each a pass over
//    the images (the row max is then carried in logit_v by its owner
//    thread). D > 128 takes more k-chunks, on a plain path of the same kernel
//    that restages both operands for every chunk and accumulates. A D whose rows are not 16-byte aligned is staged by 2-byte
//    loads into the same layout.
// Where the time goes and what was tried: PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;
constexpr int kCapPerWG = 2;
constexpr int kCapTile = kWarpgroups * kCapPerWG;  // captions per block
constexpr int kThreads = kWarpgroups * 128;
constexpr int kVT = 64;              // image rows per stage (the wgmma's M)
constexpr int kKC = 128;             // contraction per stage: two 64-wide halves
constexpr int kStages = 3;    // ring of image tiles: this one and two ahead
constexpr int kVbStages = 4;  // ring of their biases: one more, for the job held back
constexpr int kVisHalf = kVT * 128;            // 8192
constexpr int kVisStage = 2 * kVisHalf;        // 16384
constexpr int kVisBytes = kStages * kVisStage; // 49152
constexpr int kVbBytes = kVbStages * kVT * 4;  // 1024: the tiles' biases

// What depends on NT, the n8 column groups of a q-chunk (the wgmma's N / 8):
// the kernel is built for NT = 5, 9, 13 and 15 (chunks of 40, 72, 104 and 120
// words) and the caller picks the one that wastes the fewest columns. The
// comments give the bytes at NT = 13.
template <int NT>
struct Shape {
  static constexpr int kQC = NT * 8;             // words per q-chunk
  static constexpr int kTxtHalf = kQC * 128;     // bytes of one K-half of a caption
  static constexpr int kTxtCap = 2 * kTxtHalf;   // 26624
  static constexpr int kTxtBytes = kCapTile * kTxtCap;  // 106496
  static constexpr int kTbBytes = kCapTile * kQC * 4;   // 1664
  // per warpgroup: 16 candidates for each column (its 4 warps x 8 row
  // lanes, halved by one shuffle)
  static constexpr int kMergeBytes = kWarpgroups * 16 * kQC * 8;  // 26624
  // + 1024: the swizzled tiles must start on a 1024-byte boundary
  static constexpr int kSmemBytes =
      kTxtBytes + kVisBytes + kTbBytes + kVbBytes + kMergeBytes + 1024;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes shared memory written by this thread (st.shared, cp.async that has
// completed) visible to the wgmma unit, which reads through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes (64 bf16), groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused in this mode
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset between 8-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving uses of the accumulators across the
// asynchronous wgmmas.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] * B[8*NT x 16]^T, both from shared memory: one
// specialization per instruction shape (its 4*NT accumulators are operands).
template <int NT>
struct Wgmma;
template <>
struct Wgmma<5> {
  static __device__ __forceinline__ void mma(float (&d)[20], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
        "%20, %21, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};
template <>
struct Wgmma<9> {
  static __device__ __forceinline__ void mma(float (&d)[36], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
        "%36, %37, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};
template <>
struct Wgmma<13> {
  static __device__ __forceinline__ void mma(float (&d)[52], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
        "%52, %53, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};
template <>
struct Wgmma<15> {
  static __device__ __forceinline__ void mma(float (&d)[60], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %62, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
        "%60, %61, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};

// Stages rows [0, n_rows) x columns [k0, k0 + kKC) of a row-major [*, D] bf16
// matrix as two K-halves of [n_rows][64] in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r & 7)); rows >= n_valid and columns >= D
// are zero. `aligned`: rows are 16-byte aligned (cp.async).
__device__ __forceinline__ void stage_rows(uint32_t dst, unsigned char* dst_ptr,
                                           const __nv_bfloat16* __restrict__ src, int n_rows,
                                           int n_valid, int k0, int D, bool aligned, int tid) {
  for (int e = tid; e < n_rows * 16; e += kThreads) {
    const int row = e >> 4, chunk = e & 15;
    const int k = k0 + chunk * 8;
    const uint32_t off = (uint32_t)((chunk >> 3) * n_rows * 128 + row * 128 +
                                    (((chunk & 7) ^ (row & 7)) << 4));
    if (row < n_valid && k < D) {
      const __nv_bfloat16* g = src + (size_t)row * D + k;
      if (aligned) {
        cp_async16(dst + off, g);
        continue;
      }
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = k + j < D ? g[j] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst_ptr + off) = *reinterpret_cast<const uint4*>(tmp);
    } else {
      *reinterpret_cast<uint4*>(dst_ptr + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The wgmmas of one job: n_ks k-steps of 16 over the staged chunk.
template <int NT>
__device__ __forceinline__ void multiply(float (&acc)[NT * 4], uint32_t vis_tile,
                                         uint32_t txt_cap, int n_ks, int accumulate) {
  constexpr int kTxtHalf = Shape<NT>::kTxtHalf;
  fence_acc(acc);
  wgmma_fence();
  if (n_ks == kKC / 16) {
    // the whole stage: eight wgmmas in a straight line, nothing between them
    const uint64_t da = smem_desc(vis_tile), db = smem_desc(txt_cap);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      // descriptor addresses count 16-byte units
      const uint64_t a_off = ((ks >> 2) * kVisHalf + (ks & 3) * 32) >> 4;
      const uint64_t b_off = ((ks >> 2) * kTxtHalf + (ks & 3) * 32) >> 4;
      if (ks == 0)
        Wgmma<NT>::mma(acc, da, db, accumulate);
      else
        Wgmma<NT>::mma(acc, da + a_off, db + b_off, 1);
    }
  } else {
    for (int ks = 0; ks < n_ks; ++ks) {
      const uint32_t half = ks >> 2, within = (ks & 3) * 32;
      Wgmma<NT>::mma(acc, smem_desc(vis_tile + half * kVisHalf + within),
                     smem_desc(txt_cap + half * kTxtHalf + within), accumulate || ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_acc(acc);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x.x), "=f"(x.y) : "r"(addr));
  return x;
}

struct Job {
  uint32_t vb;  // shared address of the tile's image biases [kVT]
  uint32_t tb;  // shared address of the caption's word biases [kQC]
  float* lv;        // logit_v + (b * A + a) * V
  int* lvi;
  int V, q0;
};

// Epilogue of one job on the tile's rows row0 + lane/4 (+ 8), image rows
// v0 + those.
template <int NT>
__device__ __forceinline__ void compare(const float (&acc)[NT * 4], float (&cmax)[NT][2],
                                        int (&cidx)[NT][2], const Job& jb, int v0, int row0,
                                        int lane) {
  constexpr int kNT = NT;
  const int g = lane >> 2, t4 = lane & 3;
  // the row max runs as two chains (even and odd column groups), merged below
  float vb[2], rmax[2][2];
  int vrow[2], ridx[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    vrow[h] = v0 + row0 + h * 8 + g;
    vb[h] = lds(jb.vb + (row0 + h * 8 + g) * 4);  // -inf past V
    rmax[h][0] = rmax[h][1] = -INFINITY;
    ridx[h][0] = ridx[h][1] = 0;
  }
  float2 tb_next = lds2(jb.tb + (2 * t4) * 4);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 tb = tb_next;
    // the next column group's biases are asked for a group ahead
    if (j + 1 < kNT) tb_next = lds2(jb.tb + ((j + 1) * 8 + 2 * t4) * 4);
    const int q = jb.q0 + j * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = (acc[j * 4 + h * 2 + e] + vb[h]) + (e ? tb.y : tb.x);
        if (x > rmax[h][j & 1]) {
          rmax[h][j & 1] = x;
          ridx[h][j & 1] = q + e;
        }
        if (x > cmax[j][e]) {
          cmax[j][e] = x;
          cidx[j][e] = vrow[h];
        }
      }
  }
  // max over q: the 4 lanes that share a row, then one store per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = rmax[h][0];
    int mi = ridx[h][0];
    if (better(rmax[h][1], ridx[h][1], m, mi)) {
      m = rmax[h][1];
      mi = ridx[h][1];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (better(om, oi, m, mi)) {
        m = om;
        mi = oi;
      }
    }
    // later q-chunks hold larger q: only a larger value replaces
    if (t4 == 0 && vrow[h] < jb.V && (jb.q0 == 0 || m > jb.lv[vrow[h]])) {
      jb.lv[vrow[h]] = m;
      jb.lvi[vrow[h]] = mi;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
match_fwd_kernel(const __nv_bfloat16* __restrict__ vis,   // [A, V, D]
                 const __nv_bfloat16* __restrict__ txt,   // [B, Q, D]
                 const float* __restrict__ vbias,         // [A, V]
                 const float* __restrict__ tbias,         // [B, Q]
                 float* __restrict__ logit, int* __restrict__ logit_idx,      // [B, A, Q]
                 float* logit_v, int* logit_v_idx,                            // [B, A, V]
                 int A, int V, int D, int B, int Q, int aligned) {
  constexpr int kNT = NT, kQC = Shape<NT>::kQC, kTxtCap = Shape<NT>::kTxtCap,
                kTxtBytes = Shape<NT>::kTxtBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* txt_s = smem;
  unsigned char* vis_s = smem + kTxtBytes;
  float* tb_s = reinterpret_cast<float*>(smem + kTxtBytes + kVisBytes);
  float* vb_s = tb_s + kCapTile * kQC;
  float* merge_v = vb_s + kVbStages * kVT;
  int* merge_i = reinterpret_cast<int*>(merge_v + kWarpgroups * 16 * kQC);
  const uint32_t txt_a = (uint32_t)__cvta_generic_to_shared(txt_s);
  const uint32_t vis_a = (uint32_t)__cvta_generic_to_shared(vis_s);
  const uint32_t vb_a = (uint32_t)__cvta_generic_to_shared(vb_s);
  const uint32_t tb_a = (uint32_t)__cvta_generic_to_shared(tb_s);

  const int groups = gridDim.x;
  const int n_img = (A - (int)blockIdx.x + groups - 1) / groups;  // images of this block
  const int b0 = blockIdx.y * kCapTile;
  const int tid = threadIdx.x;
  // warpgroup: broadcast from lane 0, so that the compiler sees a value that
  // is uniform over the warp and keeps the wgmmas of a branch on it in flight
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;         // warp of the warpgroup: rows 16*warp..+15
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;
  const int n_vt = (V + kVT - 1) / kVT;
  const int n_kc = (D + kKC - 1) / kKC;
  const int n_tiles = n_img * n_vt;  // the block's tile sequence: image-major
  bool cap_valid[kCapPerWG];
#pragma unroll
  for (int c = 0; c < kCapPerWG; ++c) cap_valid[c] = b0 + wg * kCapPerWG + c < B;

  for (int q0 = 0; q0 < Q; q0 += kQC) {
    const int q_valid = min(kQC, Q - q0);
    // biases of the captions' words (-inf past Q or past B)
    for (int e = tid; e < kCapTile * kQC; e += kThreads) {
      const int c = e / kQC, q = e - c * kQC;
      tb_s[e] = (b0 + c < B && q < q_valid) ? tbias[(size_t)(b0 + c) * Q + q0 + q]
                                            : -INFINITY;
    }
    auto stage_txt = [&](int kc) {
      for (int c = 0; c < kCapTile; ++c) {
        const int bb = b0 + c;
        stage_rows(txt_a + c * kTxtCap, txt_s + c * kTxtCap,
                   txt + ((size_t)min(bb, B - 1) * Q + q0) * D, kQC, bb < B ? q_valid : 0,
                   kc * kKC, D, aligned, tid);
      }
    };
    // tile vt of image a, the t-th of the block (rows and biases), into its
    // ring buffers; a thread's four 16-byte chunks of a full 64 x 128 tile
    // sit 16 rows apart: the same chunk column and the same swizzle phase
    const int f_row = tid >> 4, f_chunk = tid & 15;
    const uint32_t f_off = (uint32_t)((f_chunk >> 3) * kVisHalf + f_row * 128 +
                                      (((f_chunk & 7) ^ (f_row & 7)) << 4));
    const size_t f_src = (size_t)f_row * D + f_chunk * 8;
    auto stage_vis = [&](int a, int vt, int kc, int t) {
      const int buf = t % kStages, vbuf = t % kVbStages;
      if (aligned && D == kKC && (vt + 1) * kVT <= V) {
        const __nv_bfloat16* src = vis + ((size_t)a * V + (size_t)vt * kVT) * D + f_src;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async16(vis_a + buf * kVisStage + f_off + i * 2048, src + (size_t)i * 16 * D);
      } else {
        stage_rows(vis_a + buf * kVisStage, vis_s + buf * kVisStage,
                   vis + ((size_t)a * V + (size_t)vt * kVT) * D, kVT, min(kVT, V - vt * kVT),
                   kc * kKC, D, aligned, tid);
      }
      if (tid < kVT && kc == 0) {
        const int v = vt * kVT + tid;
        if (v < V)
          cp_async4(vb_a + (vbuf * kVT + tid) * 4, vbias + (size_t)a * V + v);
        else
          vb_s[vbuf * kVT + tid] = -INFINITY;
      }
    };
    float acc[kNT * 4];
    float cmax[kCapPerWG][kNT][2];
    int cidx[kCapPerWG][kNT][2];
    auto reset_columns = [&]() {
#pragma unroll
      for (int c = 0; c < kCapPerWG; ++c)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          cmax[c][j][0] = cmax[c][j][1] = -INFINITY;
          cidx[c][j][0] = cidx[c][j][1] = 0;
        }
    };
    reset_columns();
    // one job: caption c's epilogue on the accumulators of tile vt of image a,
    // the t-th of the block
    auto job = [&](int c, int a, int vt, int t) {
      const int cap = wg * kCapPerWG + c;
      const size_t ba = (size_t)(b0 + cap) * A + a;
      const Job jb{vb_a + (t % kVbStages) * kVT * 4, tb_a + cap * kQC * 4, logit_v + ba * V,
                   logit_v_idx + ba * V, V, q0};
      compare<NT>(acc, cmax[c], cidx[c], jb, vt * kVT, row0, lane);
    };
    // End of an image, each warpgroup for its own captions: the max over v
    // of a column has 32 candidates (8 lanes x 4 warps hold different rows).
    // One shuffle halves them; 16 go through shared memory, a row per (warp,
    // lane/4 % 4), and one thread per word picks the best and stores it. The
    // barriers are the warpgroup's own (named), so the other warpgroup is
    // not held up.
    auto finish_image = [&](int a) {
      float* sv = merge_v + wg * 16 * kQC;
      int* si = merge_i + wg * 16 * kQC;
      const int tq = tid & 127;
#pragma unroll
      for (int c = 0; c < kCapPerWG; ++c) {
        const int cap = wg * kCapPerWG + c;
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the rows are free
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float m[2] = {cmax[c][j][0], cmax[c][j][1]};
          int mi[2] = {cidx[c][j][0], cidx[c][j][1]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float om = __shfl_xor_sync(0xffffffffu, m[e], 16);
            const int oi = __shfl_xor_sync(0xffffffffu, mi[e], 16);
            if (better(om, oi, m[e], mi[e])) {
              m[e] = om;
              mi[e] = oi;
            }
          }
          if (g < 4) {
            const int o = (warp * 4 + g) * kQC + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(sv + o) = make_float2(m[0], m[1]);
            *reinterpret_cast<int2*>(si + o) = make_int2(mi[0], mi[1]);
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (tq < q_valid && b0 + cap < B) {
          float m = sv[tq];
          int mi = si[tq];
#pragma unroll 8
          for (int r = 1; r < 16; ++r) {
            const float om = sv[r * kQC + tq];
            const int oi = si[r * kQC + tq];
            if (better(om, oi, m, mi)) {
              m = om;
              mi = oi;
            }
          }
          const size_t o = ((size_t)(b0 + cap) * A + a) * Q + q0 + tq;
          logit[o] = m;
          logit_idx[o] = mi;
        }
      }
      reset_columns();
    };

    // the block's tiles in order: image a (every groups-th), tile vt of it
    auto advance = [&](int& a, int& vt) {
      if (++vt == n_vt) {
        vt = 0;
        a += groups;
      }
    };
    if (n_kc == 1) {
      const int n_ks = (D + 15) >> 4;
      int a = blockIdx.x, vt = 0;      // tile t
      int a_prev = a, vt_prev = 0;     // tile t - 1
      int a_ahead = a, vt_ahead = 0;   // tile t + 2
      stage_txt(0);
      stage_vis(a_ahead, vt_ahead, 0, 0);
      cp_async_commit();
      advance(a_ahead, vt_ahead);
      if (n_tiles > 1) stage_vis(a_ahead, vt_ahead, 0, 1);
      cp_async_commit();
      advance(a_ahead, vt_ahead);
      for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<1>();    // this tile has landed (one newer may fly)
        fence_async_shared();
        __syncthreads();       // ... for every thread; the tile of t-2 is free
        if (t + 2 < n_tiles) stage_vis(a_ahead, vt_ahead, 0, t + 2);
        cp_async_commit();
        const uint32_t tile = vis_a + (t % kStages) * kVisStage;
        // The tensor cores idle during an epilogue and the CUDA cores during
        // the wgmmas, so the two warpgroups run half a job apart: warpgroup 1
        // first compares the job it held back (its second caption on the
        // tile before), whose biases are still in the ring.
        if (wg == 1 && t > 0) {
          if (cap_valid[1]) job(1, a_prev, vt_prev, t - 1);
          if (vt_prev == n_vt - 1) finish_image(a_prev);
        }
        // (a caption past B multiplies rows of zeros: the wgmmas stay out of
        // branches that the threads could take differently)
        multiply<NT>(acc, tile, txt_a + (wg * kCapPerWG) * kTxtCap, n_ks, 0);
        if (cap_valid[0]) job(0, a, vt, t);
        multiply<NT>(acc, tile, txt_a + (wg * kCapPerWG + 1) * kTxtCap, n_ks, 0);
        if (wg == 0) {
          if (cap_valid[1]) job(1, a, vt, t);
          if (vt == n_vt - 1) finish_image(a);
        }
        a_prev = a;
        vt_prev = vt;
        advance(a, vt);
        advance(a_ahead, vt_ahead);
      }
      if (wg == 1) {
        if (cap_valid[1]) job(1, a_prev, vt_prev, n_tiles - 1);
        finish_image(a_prev);
      }
    } else {
      // D beyond one stage: every (tile, caption, k-chunk) restages both
      // operands into the first buffers and accumulates; no overlap
      int a = blockIdx.x, vt = 0;
      for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
        for (int c = 0; c < kCapPerWG; ++c) {
          for (int kc = 0; kc < n_kc; ++kc) {
            __syncthreads();  // the buffers are free
            stage_txt(kc);
            stage_vis(a, vt, kc, 0);
            cp_async_commit();
            cp_async_wait<0>();
            fence_async_shared();
            __syncthreads();
            multiply<NT>(acc, vis_a, txt_a + (wg * kCapPerWG + c) * kTxtCap,
                     min(kKC, D - kc * kKC + 15) >> 4, kc > 0);
          }
          if (cap_valid[c]) job(c, a, vt, 0);
        }
        if (vt == n_vt - 1) finish_image(a);
        advance(a, vt);
      }
    }
    // the next q-chunk restages the captions' rows and biases
    cp_async_wait<0>();
    __syncthreads();
  }
}

template <int NT>
cudaError_t launch(const void* vis, const void* txt, const float* vbias, const float* tbias,
                   float* logit, int* logit_idx, float* logit_v, int* logit_v_idx, int A,
                   int V, int D, int B, int Q, int groups, int aligned, cudaStream_t stream) {
  constexpr int smem = Shape<NT>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(match_fwd_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(groups, (B + kCapTile - 1) / kCapTile);
  match_fwd_kernel<NT><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(vis),
      reinterpret_cast<const __nv_bfloat16*>(txt), vbias, tbias, logit, logit_idx,
      logit_v, logit_v_idx, A, V, D, B, Q, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block with q-chunks of 8 * nt words, in bytes
// (0 for an nt the kernel is not built for).
int match_fwd_smem_bytes(int nt) {
  switch (nt) {
    case 5: return Shape<5>::kSmemBytes;
    case 9: return Shape<9>::kSmemBytes;
    case 13: return Shape<13>::kSmemBytes;
    case 15: return Shape<15>::kSmemBytes;
    default: return 0;
  }
}

// vis [A,V,D] bf16, txt [B,Q,D] bf16, vbias [A,V] f32, tbias [B,Q] f32;
// logit/logit_idx [B,A,Q] f32/i32, logit_v/logit_v_idx [B,A,V] f32/i32.
// `groups`: a block serves 4 captions and every groups-th image (1 <= groups
// <= A; the grid is groups x ceil(B/4) blocks). `nt`: the words go in
// q-chunks of 8 * nt (5, 9, 13 or 15). `aligned`: D % 8 == 0 and both operand
// pointers are 16-byte aligned, so rows can be copied by 16-byte cp.async.
// Returns cudaGetLastError().
int match_fwd_launch(const void* vis, const void* txt, const float* vbias,
                     const float* tbias, float* logit, int* logit_idx,
                     float* logit_v, int* logit_v_idx, int A, int V, int D,
                     int B, int Q, int groups, int nt, int aligned, void* stream) {
  if (A <= 0 || B <= 0 || Q <= 0 || V <= 0) return 0;
  if (groups < 1 || groups > A) return (int)cudaErrorInvalidValue;
  if (aligned && (D % 8 != 0 || ((uintptr_t)vis | (uintptr_t)txt) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MATCH_FWD_LAUNCH(NT)                                                          \
  case NT:                                                                            \
    return (int)launch<NT>(vis, txt, vbias, tbias, logit, logit_idx, logit_v,         \
                           logit_v_idx, A, V, D, B, Q, groups, aligned, s);
  switch (nt) {
    MATCH_FWD_LAUNCH(5)
    MATCH_FWD_LAUNCH(9)
    MATCH_FWD_LAUNCH(13)
    MATCH_FWD_LAUNCH(15)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MATCH_FWD_LAUNCH
}

}  // extern "C"
