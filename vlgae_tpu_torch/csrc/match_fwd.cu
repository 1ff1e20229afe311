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
// In practice the epilogue bounds both kernels: two bias adds and two
// compare-selects an element on the CUDA cores issue more instructions than
// the tensor cores take cycles for the element's 128 multiply-adds.
//
// Two kernels; ops/match.py::match_fwd_plan picks one.
//
// `match_fwd_tma_kernel`: q-chunks of 120 and 136 words (NT = 15, 17),
// rows 16-byte aligned, D <= 128, V <= 65536. Q = 114 (exp=vlgae's longest
// captions) is one chunk of 120, Q = 130 (exp=vlgae_vit's) one of 136 and
// Q = 3,306 (word+alldep) 25 of 136: each chunk a pass over the images.
//  * The product runs as `wgmma.mma_async.sync.aligned.m64nNk16` (bf16 x
//    bf16 -> f32): 64 image rows (M) by the chunk's words (N), both operands
//    K-major in the 128-byte swizzle, read straight from shared memory.
//  * One block: a producer warpgroup and two consumer warpgroups of one
//    caption each (TmaShape), the captions' rows resident for the q-chunk.
//    Producer warp 0 streams the block's image tiles (64 rows x 128
//    features, 16 KB) by `cp.async.bulk.tensor` (TMA, 128-byte swizzle,
//    rows past V and features past D zero-filled) into a ring of kStages
//    buffers, each with a full and an empty `mbarrier`, and the tiles' 64
//    image biases by cp.async beside them, counted on the same full
//    barrier; its warpgroup gives registers to the consumers (`setmaxnreg`).
//    No block-wide barrier in the loop; the consumers issue no copies.
//  * A job is one (tile, caption): eight wgmmas, then its epilogue; the two
//    warpgroups, free of any block-wide barrier, overlap each other's
//    wgmmas and epilogues. The kernel also runs with two accumulator sets
//    a warpgroup (TmaShape::kAccSets): it issues job j into one and runs
//    job j-1's epilogue on the other while the tensor cores work on j; at
//    these widths their registers spill. Nothing that runs while a set is
//    in flight branches on a thread's values (stores and loads are
//    predicated, the barrier spin is one asm block), and no set is in
//    flight across a branch or a loop's back edge: otherwise ptxas waits
//    for each wgmma before it issues the next (C7514, C7518). The
//    warpgroup index is broadcast from lane 0 for the same reason.
//  * The grid: `groups` x ceil(B / 2) blocks, a block serving two captions
//    and every `groups`-th image, about one block a multiprocessor
//    (ops/match.py::match_fwd_groups).
//
// `match_fwd_kernel` (PR 4's design): chunks of 40 to 104 words, where no
// TMA design timed here beat it, and any chunk when D > 128 or operands are
// not 16-byte aligned (builds NT = 5, 9, 13, 15). Two warpgroups, four
// captions resident, image tiles in a three-stage `cp.async` ring with one
// __syncthreads() a tile, warpgroup 1 half a job behind warpgroup 0; D > 128
// restages both operands for every k-chunk; rows not 16-byte aligned are
// staged by 2-byte loads.
//
// Both epilogues, in registers: a thread adds its two rows' image biases
// (-inf past V) and the words' biases to the accumulator fragment (rows
// 16*warp + lane/4 and + 8, columns 8*j + 2*(lane%4) and + 1). The max over
// q of a row is complete inside the job: the thread's columns in ascending
// q, then the 4 lanes of the row by shuffles, written once to logit_v (a
// later q-chunk replaces it only with a larger value). The max over v of a
// column is carried in (value, index) registers per caption across the
// image's tiles (ascending v in a thread, so `>` keeps the first winner; on
// the TMA kernel two columns' indices share a register, 16 bits each); at
// the end of the image the candidates of the warpgroup's rows meet through
// shared memory and one thread a word picks the best and writes logit.
// Every merge compares (value, then smaller index), so both kernels give
// the same bits. Padded rows and columns carry -inf and never win; a wholly
// masked row ties at -1e9 and gives index 0.
// Where the time goes and what was tried: PERF.md, section 6.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVT = 64;    // image rows per tile (the wgmma's M)
constexpr int kKC = 128;   // contraction per tile: two 64-wide halves
constexpr int kVisHalf = kVT * 128;      // 8192
constexpr int kVisStage = 2 * kVisHalf;  // 16384

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
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
template <>
struct Wgmma<17> {
  static __device__ __forceinline__ void mma(float (&d)[68], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, "
        "%68, %69, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};

// Stages rows [0, n_rows) x columns [k0, k0 + kKC) of a row-major [*, D] bf16
// matrix as two K-halves of [n_rows][64] in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r & 7)), `n_threads` threads from `tid`;
// rows >= n_valid and columns >= D are zero. `aligned`: rows are 16-byte
// aligned (cp.async).
__device__ __forceinline__ void stage_rows(uint32_t dst, unsigned char* dst_ptr,
                                           const __nv_bfloat16* __restrict__ src, int n_rows,
                                           int n_valid, int k0, int D, bool aligned, int tid,
                                           int n_threads) {
  for (int e = tid; e < n_rows * 16; e += n_threads) {
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

// Issues the wgmmas of one job, n_ks k-steps of 16 over the staged chunk, as
// one commit group; `txt_half` is the bytes of one K-half of the caption.
template <int NT>
__device__ __forceinline__ void issue_mma(float (&acc)[NT * 4], uint32_t vis_tile,
                                          uint32_t txt_cap, int n_ks, int accumulate) {
  constexpr int kTxtHalf = NT * 8 * 128;
  fence_acc(acc);
  wgmma_fence();
  if (n_ks == kKC / 16) {
    // the whole tile: eight wgmmas in a straight line, nothing between them
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
}

// The wgmmas of one job, waited for.
template <int NT>
__device__ __forceinline__ void multiply(float (&acc)[NT * 4], uint32_t vis_tile,
                                         uint32_t txt_cap, int n_ks, int accumulate) {
  issue_mma<NT>(acc, vis_tile, txt_cap, n_ks, accumulate);
  wgmma_wait<0>();
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

// Predicated accesses, each one instruction under a predicate: code that
// runs while a warpgroup's wgmmas are in flight must not branch on a value
// that differs between threads, or ptxas serializes the wgmmas (C7518).
__device__ __forceinline__ float ld_global_rw_if(const float* p, bool pred, float otherwise) {
  float x = otherwise;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p ld.global.f32 %0, [%1];\n}\n"
      : "+f"(x)
      : "l"(p), "r"((int)pred)
      : "memory");
  return x;
}
__device__ __forceinline__ void st_global_if(float* p, float v, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}\n" ::"l"(p),
               "f"(v), "r"((int)pred));
}
__device__ __forceinline__ void st_global_if(int* p, int v, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b32 [%0], %1;\n}\n" ::"l"(p),
               "r"(v), "r"((int)pred));
}
__device__ __forceinline__ void st_shared_if(uint32_t addr, float v, int i, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p st.shared.v2.b32 [%0], {%1, %2};\n}\n" ::"r"(
          addr),
      "f"(v), "r"(i), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void lds_pair(uint32_t addr, float& v, int& i) {
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=f"(v), "=r"(i) : "r"(addr) : "memory");
}

struct Job {
  uint32_t tb;  // shared address of the caption's word biases [kQC]
  float* lv;    // logit_v + (b * A + a) * V
  int* lvi;
  int V, q0;
};

// The column carry's indices: an int a column, or (kPacked) the two
// columns 8*j + 2*(lane%4) and + 1 of a thread in the low and high 16 bits
// of one register (V <= 65536), which frees NT registers.
template <int NT, bool kPacked>
struct ColIdx {
  using type = int[NT][2];
};
template <int NT>
struct ColIdx<NT, true> {
  using type = uint32_t[NT];
};

// Epilogue of one job on the tile's rows row0 + lane/4 (+ 8), image rows
// v0 + those, whose image biases are vb (-inf past V); `live`: the caption
// exists (its row maxes are stored). kTma: the row maxes are stored by
// predicated instructions, not under a branch (the TMA kernel runs the
// epilogue while wgmmas are in flight), and the column indices are packed.
template <int NT, bool kTma>
__device__ __forceinline__ void compare(const float (&acc)[NT * 4], float (&cmax)[NT][2],
                                        typename ColIdx<NT, kTma>::type& cidx,
                                        const float (&vb)[2], const Job& jb, int v0, int row0,
                                        int lane, bool live) {
  constexpr int kNT = NT;
  // the row max runs as kChains chains (column groups j % kChains), merged
  // below; the words' biases are read a group ahead (kTbAhead)
  constexpr int kChains = kTma ? 1 : 2;
  constexpr bool kTbAhead = true;
  const int g = lane >> 2, t4 = lane & 3;
  float rmax[2][kChains];
  int vrow[2], ridx[2][kChains];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    vrow[h] = v0 + row0 + h * 8 + g;
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      rmax[h][k] = -INFINITY;
      ridx[h][k] = 0;
    }
  }
  float2 tb_next = lds2(jb.tb + (2 * t4) * 4);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 tb = kTbAhead ? tb_next : lds2(jb.tb + (j * 8 + 2 * t4) * 4);
    // the next column group's biases are asked for a group ahead
    if (kTbAhead && j + 1 < kNT) tb_next = lds2(jb.tb + ((j + 1) * 8 + 2 * t4) * 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = (acc[j * 4 + h * 2 + e] + vb[h]) + (e ? tb.y : tb.x);
        // the row's index as the column's offset in the chunk, a constant
        // (q0 + 2*(lane%4) is added once below)
        if (x > rmax[h][j % kChains]) {
          rmax[h][j % kChains] = x;
          ridx[h][j % kChains] = j * 8 + e;
        }
        if (x > cmax[j][e]) {
          cmax[j][e] = x;
          if constexpr (kTma)
            cidx[j] = __byte_perm(cidx[j], vrow[h], e ? 0x5410 : 0x3254);
          else
            cidx[j][e] = vrow[h];
        }
      }
  }
  // max over q: the 4 lanes that share a row, then one store per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = rmax[h][0];
    int mi = ridx[h][0];
#pragma unroll
    for (int k = 1; k < kChains; ++k) {
      if (better(rmax[h][k], ridx[h][k], m, mi)) {
        m = rmax[h][k];
        mi = ridx[h][k];
      }
    }
    mi += jb.q0 + 2 * t4;
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
    if constexpr (kTma) {
      const bool own = live && t4 == 0 && vrow[h] < jb.V;
      const float before = ld_global_rw_if(jb.lv + vrow[h], own && jb.q0 > 0, -INFINITY);
      const bool write = own && (jb.q0 == 0 || m > before);
      st_global_if(jb.lv + vrow[h], m, write);
      st_global_if(jb.lvi + vrow[h], mi, write);
    } else if (live && t4 == 0 && vrow[h] < jb.V && (jb.q0 == 0 || m > jb.lv[vrow[h]])) {
      jb.lv[vrow[h]] = m;
      jb.lvi[vrow[h]] = mi;
    }
  }
}

template <int NT>
__device__ __forceinline__ void reset_columns(float (&cmax)[NT][2], int (&cidx)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    cmax[j][0] = cmax[j][1] = -INFINITY;
    cidx[j][0] = cidx[j][1] = 0;
  }
}
template <int NT>
__device__ __forceinline__ void reset_columns(float (&cmax)[NT][2], uint32_t (&cidx)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    cmax[j][0] = cmax[j][1] = -INFINITY;
    cidx[j] = 0;
  }
}

// ---------------------------------------------------------------------------
// The TMA kernel: a producer warpgroup and kConsumerWGs consumer warpgroups.

constexpr int kStages = 6;  // image tiles in flight: the ring
constexpr int kMergeRows = 4;  // column candidates a warpgroup leaves: one a warp

// What depends on NT, the n8 column groups of a q-chunk (the wgmma's N / 8):
// built for NT = 15 and 17 (chunks of 120 and 136 words). Consumer
// warpgroups of one caption each, 240 registers a thread with two (the
// producer warpgroup keeps 24). One accumulator set (4*NT registers) and
// the caption's column carry (3*NT) fit at both widths; two sets spill
// (scripts/time_torch_k5_variants.py, PERF.md section 6).
template <int NT>
struct TmaShape {
  static constexpr int kConsumerWGs = 2;
  static constexpr int kAccSets = 1;
  static constexpr int kThreads = (kConsumerWGs + 1) * 128;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumerWGs == 3 ? 160 : 240;
  static constexpr int kCapTile = kConsumerWGs;  // captions per block
  static constexpr int kQC = NT * 8;              // words per q-chunk
  static constexpr int kTxtCap = 2 * kQC * 128;   // bytes of a caption's rows
  static constexpr int kVisBytes = kStages * kVisStage;
  static constexpr int kVbBytes = kStages * kVT * 4;  // the tiles' image biases
  static constexpr int kTxtBytes = kCapTile * kTxtCap;
  static constexpr int kTbBytes = kCapTile * kQC * 4;
  static constexpr int kMergeBytes = kConsumerWGs * kMergeRows * kQC * 8;
  static constexpr int kBarBytes = 2 * kStages * 8;
  // + 1024: the swizzled tiles must start on a 1024-byte boundary
  static constexpr int kSmemBytes =
      kVisBytes + kTxtBytes + kVbBytes + kTbBytes + kMergeBytes + kBarBytes + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// A 4-byte copy of `src` (or 0 where `!valid`) into shared memory.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// The barrier's current phase also waits for this thread's cp.asyncs so far.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the phase of `parity` has completed. The spin is one asm
// block, so that no branch of the compiler's sits between a warpgroup's
// wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          bar),
      "r"((int)pred)
      : "memory");
}
// One box of the 3-D tensor map (features, rows, images) at (c0, c1, c2)
// into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

template <int NT>
__global__ void __launch_bounds__(TmaShape<NT>::kThreads, 1)
match_fwd_tma_kernel(const __grid_constant__ CUtensorMap vis_map,  // [A, V, D] bf16
                     const __nv_bfloat16* __restrict__ txt,       // [B, Q, D]
                     const float* __restrict__ vbias,             // [A, V]
                     const float* __restrict__ tbias,             // [B, Q]
                     float* __restrict__ logit, int* __restrict__ logit_idx,  // [B, A, Q]
                     float* logit_v, int* logit_v_idx,                        // [B, A, V]
                     int A, int V, int D, int B, int Q) {
  using S = TmaShape<NT>;
  constexpr int kNT = NT, kQC = S::kQC, kTxtCap = S::kTxtCap;
  constexpr int kConsumerWGs = S::kConsumerWGs, kAccSets = S::kAccSets;
  constexpr int kAll = 1 + kConsumerWGs;  // the named barrier of every consumer
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* txt_s = smem + S::kVisBytes;
  float* vb_s = reinterpret_cast<float*>(txt_s + S::kTxtBytes);
  float* tb_s = vb_s + kStages * kVT;
  const uint32_t vis_a = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t txt_a = (uint32_t)__cvta_generic_to_shared(txt_s);
  const uint32_t vb_a = (uint32_t)__cvta_generic_to_shared(vb_s);
  const uint32_t tb_a = (uint32_t)__cvta_generic_to_shared(tb_s);
  const uint32_t merge_a = tb_a + S::kTbBytes;   // per warpgroup [kMergeRows][kQC] pairs
  const uint32_t full_a = merge_a + S::kMergeBytes;
  const uint32_t empty_a = full_a + kStages * 8;

  const int groups = gridDim.x;
  const int n_img = (A - (int)blockIdx.x + groups - 1) / groups;  // images of this block
  const int b0 = blockIdx.y * S::kCapTile;
  const int n_vt = (V + kVT - 1) / kVT;
  const int n_tiles = n_img * n_vt;  // a q-chunk's tiles: image-major
  const int tid = threadIdx.x;
  // warpgroup: broadcast from lane 0, so that the compiler sees a value that
  // is uniform over the warp and keeps the wgmmas of a branch on it in flight
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_a + s * 8, 1);                      // the producer's expect_tx
      mbar_init(empty_a + s * 8, kConsumerWGs * 4);      // a lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: warp 0 keeps the ring full, tile after tile, for every
    // q-chunk; a stage is refilled once every consumer warp let it go. Its
    // lanes copy the tile's 64 image biases by cp.async (0 past V), each
    // tracked on the stage's full barrier, then lane 0 asks for the rows by
    // TMA and arrives with their bytes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (tid < 32) {
      if (tid == 0)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vis_map))
                     : "memory");
      int s = 0;
      uint32_t phase = 0;  // of the ring's current round
      for (int q0 = 0; q0 < Q; q0 += kQC)
        for (int a = blockIdx.x; a < A; a += groups) {
          const float* vb_img = vbias + (size_t)a * V;
          for (int vt = 0; vt < n_vt; ++vt) {
            mbar_wait(empty_a + s * 8, phase ^ 1);
#pragma unroll
            for (int r = tid; r < kVT; r += 32) {
              const int v = vt * kVT + r;
              cp_async4_zfill(vb_a + (s * kVT + r) * 4, vb_img + min(v, V - 1), v < V);
            }
            cp_async_mbar_arrive(full_a + s * 8);
            __syncwarp();
            if (tid == 0) {
              mbar_arrive_expect_tx(full_a + s * 8, kVisStage);
              const uint32_t dst = vis_a + s * kVisStage;
              tma_load_3d(dst, &vis_map, 0, vt * kVT, a, full_a + s * 8);
              tma_load_3d(dst + kVisHalf, &vis_map, 64, vt * kVT, a, full_a + s * 8);
            }
            if (++s == kStages) {
              s = 0;
              phase ^= 1;
            }
          }
        }
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
  const int cw = wg - 1;
  const int ctid = tid - 128;        // 0 .. 128 * kConsumerWGs - 1 over the consumers
  const int warp = (tid >> 5) & 3;   // warp of the warpgroup: rows 16*warp..+15
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;
  const int n_ks = (D + 15) >> 4;
  const int cap = cw;  // this warpgroup's caption of the block
  const bool cap_valid = b0 + cap < B;

  float acc[kAccSets][kNT * 4];
  float cmax[kNT][2];
  uint32_t cidx[kNT];  // packed: columns 2*j and 2*j + 1 of the thread
  int T0 = 0;             // ring position of the q-chunk's first tile
  for (int q0 = 0; q0 < Q; q0 += kQC, T0 += n_tiles) {
    const int q_valid = min(kQC, Q - q0);
    // the captions' rows and word biases of this q-chunk (-inf past Q or B),
    // once every consumer is done with the last chunk's
    if (q0 > 0) named_barrier(kAll, kConsumerWGs * 128);
    for (int e = ctid; e < S::kCapTile * kQC; e += kConsumerWGs * 128) {
      const int c = e / kQC, q = e - c * kQC;
      tb_s[e] = (b0 + c < B && q < q_valid) ? tbias[(size_t)(b0 + c) * Q + q0 + q] : -INFINITY;
    }
    for (int c = 0; c < S::kCapTile; ++c) {
      const int bb = b0 + c;
      stage_rows(txt_a + c * kTxtCap, txt_s + c * kTxtCap,
                 txt + ((size_t)min(bb, B - 1) * Q + q0) * D, kQC, bb < B ? q_valid : 0, 0, D,
                 true, ctid, kConsumerWGs * 128);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    named_barrier(kAll, kConsumerWGs * 128);
    reset_columns<NT>(cmax, cidx);

    // job t: the warpgroup's caption on the block's tile t (image-major),
    // into accumulator set `set`, a compile-time constant, so that every
    // register array is indexed statically
    auto issue = [&](int t, auto set) {
      constexpr int st = decltype(set)::value;
      const int T = T0 + t;
      mbar_wait(full_a + (T % kStages) * 8, (T / kStages) & 1);
      // (a caption past B multiplies rows of zeros: the wgmmas stay out of
      // branches that the threads could take differently)
      issue_mma<NT>(acc[st], vis_a + (T % kStages) * kVisStage, txt_a + cap * kTxtCap, n_ks,
                    0);
    };
    // job t's epilogue once its wgmmas completed; the tile goes back to the
    // producer
    auto retire = [&](int t, auto set) {
      constexpr int st = decltype(set)::value;
      fence_acc(acc[st]);
      const int vt = t % n_vt, a = blockIdx.x + (t / n_vt) * groups;
      const int s = (T0 + t) % kStages;
      // this thread's two rows' image biases (-inf past V), read before the
      // tile goes back to the producer
      float vb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + h * 8 + g;
        const float x = lds(vb_a + (s * kVT + r) * 4);
        vb[h] = vt * kVT + r < V ? x : -INFINITY;
      }
      mbar_arrive_if(empty_a + s * 8, lane == 0);
      const size_t ba = (size_t)(b0 + cap) * A + a;
      const Job jb{tb_a + cap * kQC * 4, logit_v + ba * V, logit_v_idx + ba * V, V, q0};
      compare<NT, true>(acc[st], cmax, cidx, vb, jb, vt * kVT, row0, lane, cap_valid);
      if (vt != n_vt - 1) return;
      // End of an image: the caption's 32 candidates a column (8 row
      // lanes x 4 warps) fold by shuffles to one a warp; those go through
      // shared memory and one thread a word picks the best and stores it.
      // The barriers are the warpgroup's own (named): the other warpgroup
      // and the tensor cores go on.
      // (value, index) pairs: row r of the warpgroup's buffer, column q
      const uint32_t merge = merge_a + cw * kMergeRows * kQC * 8;
      named_barrier(1 + cw, 128);  // the rows are free
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = cmax[jj][e];
          int mi = (int)(e ? cidx[jj] >> 16 : cidx[jj] & 0xFFFFu);
#pragma unroll
          for (int off = 4; off <= 16; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, off);
            const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
            if (better(om, oi, m, mi)) {
              m = om;
              mi = oi;
            }
          }
          st_shared_if(merge + (warp * kQC + jj * 8 + 2 * t4 + e) * 8, m, mi, g == 0);
        }
      }
      named_barrier(1 + cw, 128);
#pragma unroll
      for (int k = 0; k < (kQC + 127) / 128; ++k) {
        const int tq = (tid & 127) + k * 128;
        const int tqc = min(tq, kQC - 1);
        float m;
        int mi;
        lds_pair(merge + tqc * 8, m, mi);
#pragma unroll
        for (int r = 1; r < kMergeRows; ++r) {
          float om;
          int oi;
          lds_pair(merge + (r * kQC + tqc) * 8, om, oi);
          if (better(om, oi, m, mi)) {
            m = om;
            mi = oi;
          }
        }
        const size_t o = ((size_t)(b0 + cap) * A + a) * Q + q0 + tq;
        const bool store = cap_valid && tq < q_valid;
        st_global_if(logit + o, m, store);
        st_global_if(logit_idx + o, mi, store);
      }
      reset_columns<NT>(cmax, cidx);
    };

    using I0 = std::integral_constant<int, 0>;
    using I1 = std::integral_constant<int, 1>;
    if constexpr (kAccSets == 2) {
      // job t's wgmmas are in flight while job t-1's epilogue runs; even jobs
      // take set 0, odd ones set 1. Every half ends in wait_group 0, so that
      // no set is in flight across a branch or the loop's back edge, where
      // the compiler's copies would read it (ptxas then serializes every
      // wgmma, C7514).
      issue(0, I0{});
      wgmma_wait<0>();
      int t = 1;
      for (; t + 1 < n_tiles; t += 2) {
        issue(t, I1{});
        retire(t - 1, I0{});
        wgmma_wait<0>();
        issue(t + 1, I0{});
        retire(t, I1{});
        wgmma_wait<0>();
      }
      if (t < n_tiles) {
        issue(t, I1{});
        retire(t - 1, I0{});
        wgmma_wait<0>();
        retire(t, I1{});
      } else {
        retire(t - 1, I0{});
      }
    } else {
      // one set: each job's wgmmas, waited for, then its epilogue
      for (int t = 0; t < n_tiles; ++t) {
        issue(t, I0{});
        wgmma_wait<0>();
        retire(t, I0{});
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PR 4's kernel: chunks of 40 to 104 words, and rows the TMA kernel does not
// take (D > 128, operands not 16-byte aligned, V > 65536).

constexpr int kWarpgroups = 2;
constexpr int kCapPerWG = 2;
constexpr int kCapTile = kWarpgroups * kCapPerWG;  // captions per block
constexpr int kThreads = kWarpgroups * 128;
constexpr int kRing = 3;      // ring of image tiles: this one and two ahead
constexpr int kVbRing = 4;    // ring of their biases: one more, for the job held back
constexpr int kVisBytes = kRing * kVisStage;  // 49152
constexpr int kVbBytes = kVbRing * kVT * 4;   // 1024: the tiles' biases

// What depends on NT: built for NT = 5, 9, 13 and 15 (chunks of 40, 72,
// 104 and 120 words). The comments give the bytes at NT = 13.
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
  float* merge_v = vb_s + kVbRing * kVT;
  int* merge_i = reinterpret_cast<int*>(merge_v + kWarpgroups * 16 * kQC);
  const uint32_t txt_a = (uint32_t)__cvta_generic_to_shared(txt_s);
  const uint32_t vis_a = (uint32_t)__cvta_generic_to_shared(vis_s);
  const uint32_t vb_a = (uint32_t)__cvta_generic_to_shared(vb_s);
  const uint32_t tb_a = (uint32_t)__cvta_generic_to_shared(tb_s);

  const int groups = gridDim.x;
  const int n_img = (A - (int)blockIdx.x + groups - 1) / groups;  // images of this block
  const int b0 = blockIdx.y * kCapTile;
  const int tid = threadIdx.x;
  // warpgroup: broadcast from lane 0 (see the TMA kernel)
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
                   kc * kKC, D, aligned, tid, kThreads);
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
      const int buf = t % kRing, vbuf = t % kVbRing;
      if (aligned && D == kKC && (vt + 1) * kVT <= V) {
        const __nv_bfloat16* src = vis + ((size_t)a * V + (size_t)vt * kVT) * D + f_src;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async16(vis_a + buf * kVisStage + f_off + i * 2048, src + (size_t)i * 16 * D);
      } else {
        stage_rows(vis_a + buf * kVisStage, vis_s + buf * kVisStage,
                   vis + ((size_t)a * V + (size_t)vt * kVT) * D, kVT, min(kVT, V - vt * kVT),
                   kc * kKC, D, aligned, tid, kThreads);
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
    auto reset_all = [&]() {
#pragma unroll
      for (int c = 0; c < kCapPerWG; ++c) reset_columns<NT>(cmax[c], cidx[c]);
    };
    reset_all();
    // one job: caption c's epilogue on the accumulators of tile vt of image a,
    // the t-th of the block
    auto job = [&](int c, int a, int vt, int t) {
      const int cap = wg * kCapPerWG + c;
      const size_t ba = (size_t)(b0 + cap) * A + a;
      const Job jb{tb_a + cap * kQC * 4, logit_v + ba * V, logit_v_idx + ba * V, V, q0};
      const uint32_t vb_tile = vb_a + (t % kVbRing) * kVT * 4;
      const float vb[2] = {lds(vb_tile + (row0 + g) * 4), lds(vb_tile + (row0 + 8 + g) * 4)};
      compare<NT, false>(acc, cmax[c], cidx[c], vb, jb, vt * kVT, row0, lane, true);
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
        named_barrier(1 + wg, 128);  // the rows are free
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
        named_barrier(1 + wg, 128);
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
      reset_all();
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
        const uint32_t tile = vis_a + (t % kRing) * kVisStage;
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

// ---------------------------------------------------------------------------
// Launches.

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (so that
// the library need not link libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int NT>
cudaError_t launch_tma(const void* vis, const void* txt, const float* vbias, const float* tbias,
                       float* logit, int* logit_idx, float* logit_v, int* logit_v_idx, int A,
                       int V, int D, int B, int Q, int groups, cudaStream_t stream) {
  using S = TmaShape<NT>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // vis as (features, rows, images): a box is 64 features (128 bytes, the
  // swizzle span) x 64 rows of one image; what lies past D or V reads as 0
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)V, (cuuint64_t)A};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)V * D * 2};
  const cuuint32_t box[3] = {64, kVT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(vis), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(match_fwd_tma_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       S::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(groups, (B + S::kCapTile - 1) / S::kCapTile);
  match_fwd_tma_kernel<NT><<<grid, S::kThreads, S::kSmemBytes, stream>>>(
      map, reinterpret_cast<const __nv_bfloat16*>(txt), vbias, tbias, logit, logit_idx, logit_v,
      logit_v_idx, A, V, D, B, Q);
  return cudaGetLastError();
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

// `staging`: 2 = TMA (`match_fwd_tma_kernel`: D <= 128, D % 8 == 0, both
// operands 16-byte aligned, V <= 65536), 1 = 16-byte cp.async, 0 = 2-byte
// loads (both `match_fwd_kernel`).

// Dynamic shared memory of one block with q-chunks of 8 * nt words, in bytes
// (0 for an nt that path is not built for).
int match_fwd_smem_bytes(int nt, int staging) {
  if (staging == 2) {
    switch (nt) {
      case 15: return TmaShape<15>::kSmemBytes;
      case 17: return TmaShape<17>::kSmemBytes;
      default: return 0;
    }
  }
  switch (nt) {
    case 5: return Shape<5>::kSmemBytes;
    case 9: return Shape<9>::kSmemBytes;
    case 13: return Shape<13>::kSmemBytes;
    case 15: return Shape<15>::kSmemBytes;
    default: return 0;
  }
}

// Captions one block serves (0 for an nt that path is not built for).
int match_fwd_cap_tile(int nt, int staging) {
  if (match_fwd_smem_bytes(nt, staging) == 0) return 0;
  if (staging != 2) return kCapTile;
  return nt == 15 ? TmaShape<15>::kCapTile : TmaShape<17>::kCapTile;
}

// vis [A,V,D] bf16, txt [B,Q,D] bf16, vbias [A,V] f32, tbias [B,Q] f32;
// logit/logit_idx [B,A,Q] f32/i32, logit_v/logit_v_idx [B,A,V] f32/i32.
// `groups`: a block serves match_fwd_cap_tile(nt, staging) captions and
// every groups-th image (1 <= groups <= A). `nt`: the words go in q-chunks
// of 8 * nt. Returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the path does not take).
int match_fwd_launch(const void* vis, const void* txt, const float* vbias,
                     const float* tbias, float* logit, int* logit_idx,
                     float* logit_v, int* logit_v_idx, int A, int V, int D,
                     int B, int Q, int groups, int nt, int staging, void* stream) {
  if (A <= 0 || B <= 0 || Q <= 0 || V <= 0) return 0;
  if (groups < 1 || groups > A) return (int)cudaErrorInvalidValue;
  const bool aligned16 = ((uintptr_t)vis | (uintptr_t)txt) % 16 == 0;
  if (staging != 0 && (D % 8 != 0 || !aligned16)) return (int)cudaErrorInvalidValue;
  if (staging == 2 && (D > kKC || V > 65536)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MATCH_FWD_TMA(NT)                                                             \
  case NT:                                                                            \
    return (int)launch_tma<NT>(vis, txt, vbias, tbias, logit, logit_idx, logit_v,     \
                               logit_v_idx, A, V, D, B, Q, groups, s);
#define MATCH_FWD_LAUNCH(NT)                                                          \
  case NT:                                                                            \
    return (int)launch<NT>(vis, txt, vbias, tbias, logit, logit_idx, logit_v,         \
                           logit_v_idx, A, V, D, B, Q, groups, staging, s);
  if (staging == 2) {
    switch (nt) {
      MATCH_FWD_TMA(15)
      MATCH_FWD_TMA(17)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (nt) {
    MATCH_FWD_LAUNCH(5)
    MATCH_FWD_LAUNCH(9)
    MATCH_FWD_LAUNCH(13)
    MATCH_FWD_LAUNCH(15)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MATCH_FWD_TMA
#undef MATCH_FWD_LAUNCH
}

}  // extern "C"
