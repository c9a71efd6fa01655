// Flash-attention backward for Hopper's tensor cores: dQ, dK, dV of
// flash_attention.cu's forward.
//
// The reference package has no backward kernel: JAX differentiates its
// plain attention (src/repro/models/attention.py:77, _full_attention and
// _chunked_attention).  The port's training path sends attention through
// the forward kernel, so its gradient comes from here.  Same layouts and
// masks as the forward: q/dO/dQ [B, Sq, Hq, D], k/v/dK/dV [B, Sk, Hkv, D]
// (f32 or bf16), o [B, Sq, Hq, D] f32 (the forward's output before any
// cast), lse [B, Hq, Sq] f32 (the forward's row log-sum-exp of the scaled
// scores; +inf for a row with no visible key).  Query row i sits at key
// position i + (Sk - Sq); key j is visible to it where j < Sk, j <= i + off
// (causal) and j > i + off - window (sliding window).
//
// The arithmetic, with s = q.k the raw score:
//   D_i  = sum_d dO[i, d] O[i, d]                      (flash_bwd_delta)
//   P_ij = exp(s_ij * scale - lse_i)  where visible, else 0
//   dP_ij = dO_i . V_j,   dS_ij = P_ij (dP_ij - D_i)
//   dV_j = sum_i P_ij dO_i,   dK_j = scale sum_i dS_ij Q_i   (dK/dV kernel)
//   dQ_i = scale sum_j dS_ij K_j                            (dQ kernel)
// P is exp2(s * scale log2(e) - lse log2(e)) on the SFU, as the forward
// takes it.  A fully masked row has P = 0 and so no gradient (never NaN).
//
// Deterministic, with no atomics.  The dK/dV kernel gives one CTA a 64-key
// tile of one KV head and loops over the query heads of its GQA group and
// the query tiles that can see the tile, with dK and dV in registers; the
// dQ kernel gives one CTA 64 query rows of one head and loops over the key
// tiles they can see, with dQ in registers.  Each output is written by one
// CTA and summed in a fixed order, so two runs give the same bits.  Both
// kernels recompute S and dP, so they take 14 D flops a visible (q, k)
// pair against the 10 D of the five products.  The dK/dV grid runs the
// low key tiles first and the dQ grid the last query tiles first: under a
// causal mask those see the most tiles.
//
// What bounds it on this card: operations.  At stablelm-1.6b's training
// shape ([1, 4096, 32, 64] causal, 268 M visible pairs a launch) the
// 14 D flops a pair are 241 GFLOP: 0.244 ms at bf16's 989 TFLOP/s, and,
// as 3xTF32 (three TF32 products a product), 1.46 ms at 495 TFLOP/s for
// f32.  The bytes (q, k, v, dO, o, lse in, dq, dk, dv out) are 0.2 GB,
// 0.06 ms at 3.35 TB/s; one exp a pair on the SFUs (16 a clock an SM)
// adds about 0.07 ms.  Every product therefore runs on the tensor cores,
// the looped-over tiles stream through a ring of two stages in shared
// memory by cp.async (16 bytes a copy, rows past Sq or Sk zero-filled)
// while the last stage computes, and tiles every pair of which is visible
// skip the per-element mask.
//
// f32 (flash_bwd_dkdv_f32, flash_bwd_dq_f32): four warps of 16 rows (keys
// in dK/dV, queries in dQ).  All five products are mma.sync m16n8k8 TF32
// in three terms, a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, split in
// registers as the forward splits them (hi = x rounded to TF32 by two
// integer operations, lo = x - hi), which keeps the result f32-accurate
// whatever torch.backends.cuda.matmul.allow_tf32 says.  In the dK/dV kernel
// a warp computes S^T = K.Q^T and dP^T = V.dO^T, so that the accumulator
// fragments of P^T and dS^T are the A fragments of dV += P^T.dO and
// dK += dS^T.Q unchanged (within each group of 8 queries the fragment's
// column c < 4 holds query 2c and column c + 4 query 2c + 1, which leaves
// the sum as it is); in the dQ kernel S = Q.K^T gives dS as the A fragment
// of dQ += dS.K.  The tensor cores round each mma's sum toward zero, so
// one chain of mmas into dQ over whisper's 1500 cross-attention keys
// drifted 1.1e-5 normwise, past the 1e-5 limit: each tile's dV, dK or dQ
// sums in a zeroed accumulator that is then added to the running one in
// f32 (round to nearest).  Every tile lies in shared memory as f32 rows
// of stride D + 4 floats, so that the 32 lanes of every fragment load hit
// distinct banks.  The looped-over tile has 64 rows for D <= 64 and 32
// above (the accumulators of dK and dV take D floats a thread).  wgmma is
// not used for f32: its TF32 form takes K-major operands only, and three
// of the five products have an MN-major one.
//
// bf16 (flash_bwd_dkdv_bf16, flash_bwd_dq_bf16): one warpgroup a CTA, 64
// rows, every product a wgmma with f32 accumulators.  In the dK/dV kernel
// S^T = K.Q^T and dP^T = V.dO^T take both operands K-major from shared
// memory; dV += P^T.dO and dK += dS^T.Q take P^T and dS^T from registers
// (the accumulator fragment, rounded once to bf16, is the A fragment) and
// dO and Q as the MN-major B operand.  In the dQ kernel S = Q.K^T and
// dP = dO.V^T, then dQ += dS.K with K MN-major.  A tile lies in shared
// memory once, in the no-swizzle core-matrix layout (8 rows x 16 bytes,
// contiguous): the same core matrices serve as K-major (rows along N) and
// as MN-major operand (rows along K), only the descriptor's two strides
// change.  For D = 120 the contraction is padded to 128 with zero columns
// in shared memory, never in device memory.  The ring is fed by the
// warpgroup's own cp.async copies and a CTA barrier; with one warpgroup a
// CTA and 48-98 KB of shared memory, two to four CTAs share an SM, and
// one CTA's products run while another does its exponentials (a
// producer warpgroup, as in the forward, would cap every thread at 168
// registers, and the dK/dV accumulators alone take 2 * D / 2 + 2 * BI / 2).
// The looped-over query tile is 64 rows for D <= 64 and 32 above.
//
// On an H100 80GB HBM3 at 700 W, at stablelm's shape: 4.35 ms in f32 and
// 1.13 ms in bf16, 3.0x and 4.7x the 14 D bound (the earlier CUDA-core
// design: 10.0 ms in both; PERF.md section 6).
//
// Left for later: TMA loads with swizzled tiles, two consumer warpgroups
// with a producer and setmaxnreg, issuing the next tile's S^T while the
// last tile's dV and dK run, and a single pass that adds dQ in a fixed
// order (the dQ kernel's recomputation of S and dP is 4 D of the 14 D).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BT = 64;          // keys a dK/dV CTA, query rows a dQ CTA
constexpr int NT = 128;         // threads a CTA: four warps, a warpgroup

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; zeros where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hi: x rounded to TF32 (10 mantissa bits, nearest, ties away from zero,
// as cvt.rna.tf32.f32); lo: x - hi, exact in f32, which the tensor core
// reads as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in three TF32 terms, the small ones first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// orders this thread's generic-proxy view of shared memory (cp.async and
// st.shared) with its async-proxy accesses (wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes stored contiguously; `lead` is the byte step between core
// matrices along the contraction (K), `stride` along M or N, for a
// K-major and an MN-major operand alike.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both K-major in shared memory
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int accumulate);

// d[64 x N] += A[64 x 16] . B[16 x N], A from registers, B MN-major in
// shared memory
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                                uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                                uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<120>(
    float (&d)[60], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59}, "
      "{%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Masks and the row sums D

struct Mask {
  int off, sq, sk, causal, window;

  __device__ bool visible(int i, int j) const {
    const int pos = i + off;
    return i < sq && j < sk && (!causal || j <= pos) &&
           (window < 0 || j > pos - window);
  }

  // every pair of query rows [q0, q0 + nq) x keys [k0, k0 + nk) visible
  __device__ bool full(int q0, int nq, int k0, int nk) const {
    return q0 + nq <= sq && k0 + nk <= sk &&
           (!causal || k0 + nk - 1 <= q0 + off) &&
           (window < 0 || k0 > q0 + nq - 1 + off - window);
  }

  // the query rows [lo, hi) that can see a key of [k0, k0 + BT)
  __device__ void rows(int k0, int& lo, int& hi) const {
    const int k_last = min(k0 + BT, sk) - 1;
    lo = causal ? max(0, k0 - off) : 0;
    hi = window >= 0 ? min(sq, k_last - off + window) : sq;
  }

  // the keys [lo, hi) that query rows [q0, q0 + BT) can see
  __device__ void keys(int q0, int& lo, int& hi) const {
    const int r_last = min(q0 + BT, sq) - 1;
    lo = window >= 0 ? max(0, q0 + off - window + 1) : 0;
    hi = causal ? min(sk, r_last + off + 1) : sk;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D_i = sum_d dO[i, d] O[i, d]: one warp a row of [B, Sq, Hq], into
// delta [B, Hq, Sq]; lanes take every 32nd element, then a shuffle tree
template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ dout,
                                const float* __restrict__ o,
                                float* __restrict__ delta, long long n_rows,
                                int sq, int hq, int dh) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* dp = dout + row * dh;
  const float* op = o + row * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s = __fmaf_rn(to_f32(dp[d]), op[d], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long long bi = row / hq;        // b * sq + i
    const int h = (int)(row - bi * hq);
    const long long b = bi / sq;
    const int i = (int)(bi - b * sq);
    delta[(b * hq + h) * sq + i] = s;
  }
}

// P and dS of one accumulator element in place: s the raw score, dp the
// score's dP; nl = -lse log2(e), dd = D of its query row
__device__ __forceinline__ void p_ds(float& s, float& dp, float scale2,
                                     float nl, float dd, bool seen) {
  const float p = seen ? ex2(__fmaf_rn(s, scale2, nl)) : 0.f;
  s = p;
  dp = p * (dp - dd);
}

// ---------------------------------------------------------------------------
// float32: mma.sync m16n8k8 TF32, three terms

template <int D>
struct F32Cfg {
  static constexpr int LD = D + 4;                 // row stride (floats)
  static constexpr int BI = D <= 64 ? 64 : 32;     // rows a looped tile
  // the looped-over tiles of a stage: two of [BI][LD], then (dK/dV) the
  // lse and D of its BI rows
  static constexpr int STAGE = 2 * BI * LD + 2 * BI;
  static constexpr int BYTES = (2 * BT * LD + 2 * STAGE) * 4;
};

// Rows [row0, row0 + n) of a [rows, D] f32 slice with row stride `stride`
// (elements) into dst [n][ld] by cp.async; rows at or past n_rows are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src, int row0,
                                              int n, int n_rows,
                                              long long stride, int tid) {
  constexpr int C4 = D / 4;
  for (int idx = tid; idx < n * C4; idx += NT) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    const bool ok = row0 + r < n_rows;
    cp_async16(smem_u32(dst + r * ld + c),
               src + (ok ? (row0 + r) * stride + c : 0), ok);
  }
}

// n floats [row0, row0 + n) of a row-indexed vector into shared memory
// at dst by cp.async (zeros past n_rows)
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int row0, int n, int n_rows,
                                         int tid) {
  if (tid < n) {
    const bool ok = row0 + tid < n_rows;
    cp_async4(dst + 4 * tid, src + (ok ? row0 + tid : 0), ok);
  }
}

// acc[j] (+)= A.B^T for a warp's 16 rows of A (a: their first row, row
// stride LD) and NJ groups of 8 rows of B (b: its first row), over D; the
// three TF32 terms of each product
template <int D, int NJ>
__device__ __forceinline__ void dot_rows(float (&acc)[NJ][4], const float* a,
                                         const float* b, int g, int t) {
  constexpr int LD = F32Cfg<D>::LD;
  const float* ar = a + g * LD + t;
  const float* br = b + g * LD + t;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(ar[8 * kk], ah[0], al[0]);
    split_tf32(ar[8 * LD + 8 * kk], ah[1], al[1]);
    split_tf32(ar[8 * kk + 4], ah[2], al[2]);
    split_tf32(ar[8 * LD + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_3xtf32(acc[j], ah, al, br[8 * j * LD + 8 * kk],
                 br[8 * j * LD + 8 * kk + 4]);
  }
}

// out[dn] += X.B for X the accumulator fragments x[j] (a warp's 16 rows by
// NJ groups of 8 along the contraction, each group's columns in the
// fragment's permuted order) and B [8 NJ][D] in shared memory (b: row 0).
// The tensor cores round each mma's sum toward zero, so a long chain of
// them into one accumulator drifts toward zero (over 1500 keys about
// 1.4e-5 normwise, past the 1e-5 limit): the tile's sum goes into a
// zeroed accumulator of CW column groups, which is then added to out in
// f32 (round to nearest), and the drift stays within one tile.
template <int D, int NJ>
__device__ __forceinline__ void acc_rows(float (&out)[D / 8][4],
                                         const float (&x)[NJ][4],
                                         const float* b, int g, int t) {
  constexpr int LD = F32Cfg<D>::LD, ND = D / 8;
  constexpr int CW = D <= 64 ? ND : 4;          // registers: 4 CW a thread
#pragma unroll
  for (int c0 = 0; c0 < ND; c0 += CW) {
    float tile[CW][4];
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(x[j][0], ah[0], al[0]);
      split_tf32(x[j][2], ah[1], al[1]);
      split_tf32(x[j][1], ah[2], al[2]);
      split_tf32(x[j][3], ah[3], al[3]);
      const float* br = b + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (c0 + c < ND)
          mma_3xtf32(tile[c], ah, al, br[8 * (c0 + c)],
                     br[LD + 8 * (c0 + c)]);
    }
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (c0 + c < ND)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[c0 + c][e] += tile[c][e];
  }
}

// a warp's 16 rows [row0, row0 + 16) of dst [rows, D] (row stride
// `stride`; rows at or past n_rows skipped) <- acc * mul
template <int D, typename T>
__device__ __forceinline__ void store_frag(T* dst, const float (&acc)[D / 8][4],
                                           float mul, int row0, int n_rows,
                                           long long stride, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= n_rows) continue;
    T* p = dst + r * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float x = acc[dn][2 * i] * mul, y = acc[dn][2 * i + 1] * mul;
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(p + 8 * dn) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * dn) =
            __floats2bfloat162_rn(x, y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int n_bhk, int sq, int sk, int hq,
                   int hkv, int causal, int window, float scale) {
  using C = F32Cfg<D>;
  constexpr int LD = C::LD, BI = C::BI, NJ = BI / 8, ND = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [BT][LD]
  float* Vs = Ks + BT * LD;         // [BT][LD]
  float* ring = Vs + BT * LD;       // 2 x (Q, dO [BI][LD], lse, D [BI])

  const int bhk = blockIdx.x % n_bhk;
  const int k0 = blockIdx.x / n_bhk * BT;
  const int b = bhk / hkv;
  const int hk = bhk - b * hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;
  const int rep = hq / hkv;
  const float scale2 = scale * LOG2E;

  int i_lo, i_hi;
  mk.rows(k0, i_lo, i_hi);
  i_lo = i_lo / BI * BI;
  const int n_it = i_hi > i_lo ? (i_hi - i_lo + BI - 1) / BI : 0;
  const int n_steps = rep * n_it;   // (query head, query tile) pairs

  auto stage = [&](int n) { return ring + (n & 1) * C::STAGE; };
  auto load_step = [&](int n) {
    const int hh = n / n_it;
    const int q0 = i_lo + (n - hh * n_it) * BI;
    const int h = hk * rep + hh;
    const long long q_base = ((long long)b * sq * hq + h) * D;
    const long long l_base = ((long long)b * hq + h) * sq;
    float* st = stage(n);
    load_rows_f32<D>(st, LD, q + q_base, q0, BI, sq, q_stride, tid);
    load_rows_f32<D>(st + BI * LD, LD, dout + q_base, q0, BI, sq, q_stride,
                     tid);
    load_vec(smem_u32(st + 2 * BI * LD), lse + l_base, q0, BI, sq, tid);
    load_vec(smem_u32(st + 2 * BI * LD + BI), delta + l_base, q0, BI, sq,
             tid);
  };

  if (n_steps > 0) {
    load_rows_f32<D>(Ks, LD, k + k_base, k0, BT, sk, k_stride, tid);
    load_rows_f32<D>(Vs, LD, v + k_base, k0, BT, sk, k_stride, tid);
    load_step(0);
  }
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int key = k0 + 16 * warp + g;      // and key + 8
  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);             // its stage was released at n - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qs = stage(n);
    const float* dOs = Qs + BI * LD;
    const float* Ls = dOs + BI * LD;
    const float* Dls = Ls + BI;
    const int q0 = i_lo + (n % n_it) * BI;

    // S^T = K.Q^T, dP^T = V.dO^T: the warp's 16 keys x BI queries;
    // s[j][2 i + e] is key + 8 i, query q0 + 8 j + 2 t + e
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    dot_rows<D, NJ>(s, Ks + 16 * warp * LD, Qs, g, t);
    dot_rows<D, NJ>(dp, Vs + 16 * warp * LD, dOs, g, t);

    const bool full = mk.full(q0, BI, k0, BT);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float nl = -Ls[col] * LOG2E;
        const float dd = Dls[col];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p_ds(s[j][2 * i + e], dp[j][2 * i + e], scale2, nl, dd,
               full || mk.visible(q0 + col, key + 8 * i));
      }

    // dV += P^T.dO, dK += dS^T.Q over the BI queries
    acc_rows<D, NJ>(dva, s, dOs, g, t);
    acc_rows<D, NJ>(dka, dp, Qs, g, t);
    __syncthreads();                // the stage is free for n + 2
  }
  cp_async_wait<0>();
  store_frag<D>(dk + k_base, dka, scale, k0 + 16 * warp, sk, k_stride, g, t);
  store_frag<D>(dv + k_base, dva, 1.f, k0 + 16 * warp, sk, k_stride, g, t);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int n_bh, int n_qb, int sq, int sk, int hq, int hkv,
                 int causal, int window, float scale) {
  using C = F32Cfg<D>;
  constexpr int LD = C::LD, BJ = C::BI, NJ = BJ / 8, ND = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BT][LD]
  float* dOs = Qs + BT * LD;        // [BT][LD]
  float* ring = dOs + BT * LD;      // 2 x (K, V [BJ][LD])

  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qb - 1 - blockIdx.x / n_bh) * BT;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long q_base = ((long long)b * sq * hq + h) * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;
  const float scale2 = scale * LOG2E;

  int lo, hi;
  mk.keys(q0, lo, hi);
  const int j_lo = lo / BJ * BJ;
  const int n_tiles = hi > j_lo ? (hi - j_lo + BJ - 1) / BJ : 0;

  auto stage = [&](int n) { return ring + (n & 1) * 2 * BJ * LD; };
  auto load_tile = [&](int n) {
    float* st = stage(n);
    const int kt0 = j_lo + n * BJ;
    load_rows_f32<D>(st, LD, k + k_base, kt0, BJ, sk, k_stride, tid);
    load_rows_f32<D>(st + BJ * LD, LD, v + k_base, kt0, BJ, sk, k_stride,
                     tid);
  };

  // the thread's two query rows, row and row + 8
  const int row = q0 + 16 * warp + g;
  float nl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const long long at = ((long long)b * hq + h) * sq + r;
    nl[i] = r < sq ? -lse[at] * LOG2E : 0.f;
    dd[i] = r < sq ? delta[at] : 0.f;
  }
  if (n_tiles > 0) {
    load_rows_f32<D>(Qs, LD, q + q_base, q0, BT, sq, q_stride, tid);
    load_rows_f32<D>(dOs, LD, dout + q_base, q0, BT, sq, q_stride, tid);
    load_tile(0);
  }
  cp_async_commit();

  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) {
      load_tile(n + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = stage(n);
    const float* Vs = Ks + BJ * LD;
    const int kt0 = j_lo + n * BJ;

    // S = Q.K^T, dP = dO.V^T: the warp's 16 rows x BJ keys; s[j][2 i + e]
    // is row + 8 i, key kt0 + 8 j + 2 t + e
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    dot_rows<D, NJ>(s, Qs + 16 * warp * LD, Ks, g, t);
    dot_rows<D, NJ>(dp, dOs + 16 * warp * LD, Vs, g, t);

    const bool full = mk.full(q0, BT, kt0, BJ);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p_ds(s[j][2 * i + e], dp[j][2 * i + e], scale2, nl[i], dd[i],
               full || mk.visible(row + 8 * i, kt0 + 8 * j + 2 * t + e));

    acc_rows<D, NJ>(dqa, dp, Ks, g, t);      // dQ += dS.K
    __syncthreads();
  }
  cp_async_wait<0>();
  store_frag<D>(dq + q_base, dqa, scale, q0 + 16 * warp, sq, q_stride, g, t);
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma, one warpgroup a CTA

template <int D>
struct Bf16Cfg {
  static constexpr int DP = (D + 15) / 16 * 16;     // contraction over D
  static constexpr int RG = DP / 8 * 128;           // bytes: 8 rows
  static constexpr int BI = D <= 64 ? 64 : 32;      // dK/dV: queries a step
  static constexpr int TILE = BT * DP * 2;          // bytes: 64 rows
  static constexpr int ITILE = BI * DP * 2;         // bytes: BI rows
  // dK/dV: K, V, then two stages of (Q, dO [BI], lse, D [BI] f32)
  static constexpr int KV_STAGE = 2 * ITILE + 8 * BI;
  static constexpr int KV_BYTES = 2 * TILE + 2 * KV_STAGE;
  // dQ: Q, dO, then two stages of (K, V)
  static constexpr int Q_BYTES = 2 * TILE + 2 * 2 * TILE;
};

// byte offset of element (r, c) of a tile (r a row, c along D) in the
// core-matrix layout, for a 16-byte chunk (c a multiple of 8): core
// matrix (r / 8, c / 8) at r / 8 * RG + c / 8 * 128.  As a K-major
// operand (rows along M or N, D the contraction) its descriptor steps 128
// along K and RG along M/N; as an MN-major one (rows the contraction, D
// along N) RG along K and 128 along N.
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (r >> 3) * Bf16Cfg<D>::RG + (c >> 3) * 128 + (r & 7) * 16;
}

// Rows [row0, row0 + n) of a [rows, D] bf16 slice (row stride `stride`
// elements) into the tile at `dst` by cp.async; rows at or past n_rows
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_bf16(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n, int n_rows,
                                               long long stride, int tid) {
  constexpr int CH = D / 8;         // 16-byte chunks a row
  for (int idx = tid; idx < n * CH; idx += NT) {
    const int r = idx / CH;
    const int c = 8 * (idx - r * CH);
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + tile_off<D>(r, c),
               src + (ok ? (row0 + r) * stride + c : 0), ok);
  }
}

// zero the contraction's padding columns D .. DP - 1 of `rows` rows of
// tiles at `base` (tiles of BT rows, one after another)
template <int D>
__device__ __forceinline__ void zero_pad(unsigned char* base, int rows,
                                         int tid) {
  constexpr int PAD = (Bf16Cfg<D>::DP - D) / 8;
  if constexpr (PAD > 0) {
    for (int idx = tid; idx < rows * PAD; idx += NT) {
      const int r = idx / PAD;
      const int col = D + 8 * (idx - r * PAD);
      *reinterpret_cast<uint4*>(base + tile_off<D>(r, col)) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// an accumulator tile of 64 rows x N (N / 2 floats a thread) as the A
// fragments of the next product, rounded to bf16 once: its columns
// 16 kt .. 16 kt + 15 are the A fragment of step kt
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&x)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kt][r] = pack_bf16(x[8 * kt + 2 * r], x[8 * kt + 2 * r + 1]);
}

// acc[64 x N] = A.B^T over DP, A and B K-major tiles at `a` and `b`
template <int D, int N>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a,
                                        uint32_t b) {
  constexpr int RG = Bf16Cfg<D>::RG;
#pragma unroll
  for (int kk = 0; kk < Bf16Cfg<D>::DP / 16; ++kk)
    wgmma_ss<N>(acc, smem_desc(a + 256 * kk, 128, RG),
                smem_desc(b + 256 * kk, 128, RG), kk > 0);
}

// acc[64 x D] += X.B over K rows, X in A fragments and B the tile at `b`
// (K rows of D) as the MN-major operand
template <int D, int K>
__device__ __forceinline__ void gemm_rs(float (&acc)[D / 2],
                                        const uint32_t (&x)[K / 16][4],
                                        uint32_t b) {
  constexpr int RG = Bf16Cfg<D>::RG;
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt)
    wgmma_rs<D>(acc, x[kt], smem_desc(b + 2 * RG * kt, RG, 128));
}

template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst,
                                          const float (&acc)[D / 2],
                                          float mul, int row0, int n_rows,
                                          long long stride, int g, int t) {
  store_frag<D>(dst, reinterpret_cast<const float(&)[D / 8][4]>(acc), mul,
                row0, n_rows, stride, g, t);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int n_bhk, int sq,
                    int sk, int hq, int hkv, int causal, int window,
                    float scale) {
  using C = Bf16Cfg<D>;
  constexpr int BI = C::BI;
  extern __shared__ __align__(128) unsigned char smem_b[];
  const uint32_t sK = smem_u32(smem_b);
  const uint32_t sV = sK + C::TILE;
  const uint32_t ring = sV + C::TILE;      // 2 x (Q, dO, lse, D)

  const int bhk = blockIdx.x % n_bhk;
  const int k0 = blockIdx.x / n_bhk * BT;
  const int b = bhk / hkv;
  const int hk = bhk - b * hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;
  const int rep = hq / hkv;
  const float scale2 = scale * LOG2E;

  int i_lo, i_hi;
  mk.rows(k0, i_lo, i_hi);
  i_lo = i_lo / BI * BI;
  const int n_it = i_hi > i_lo ? (i_hi - i_lo + BI - 1) / BI : 0;
  const int n_steps = rep * n_it;   // (query head, query tile) pairs

  auto stage = [&](int n) { return ring + (n & 1) * C::KV_STAGE; };
  auto load_step = [&](int n) {
    const int hh = n / n_it;
    const int q0 = i_lo + (n - hh * n_it) * BI;
    const int h = hk * rep + hh;
    const long long q_base = ((long long)b * sq * hq + h) * D;
    const long long l_base = ((long long)b * hq + h) * sq;
    const uint32_t st = stage(n);
    load_rows_bf16<D>(st, q + q_base, q0, BI, sq, q_stride, tid);
    load_rows_bf16<D>(st + C::ITILE, dout + q_base, q0, BI, sq, q_stride,
                      tid);
    load_vec(st + 2 * C::ITILE, lse + l_base, q0, BI, sq, tid);
    load_vec(st + 2 * C::ITILE + 4 * BI, delta + l_base, q0, BI, sq, tid);
  };

  // K, V and both stages' Q, dO: 2 BT + 4 BI rows of padding
  zero_pad<D>(smem_b, 2 * BT, tid);
  zero_pad<D>(smem_b + 2 * C::TILE, BI * 2, tid);
  zero_pad<D>(smem_b + 2 * C::TILE + C::KV_STAGE, BI * 2, tid);
  if (n_steps > 0) {
    load_rows_bf16<D>(sK, k + k_base, k0, BT, sk, k_stride, tid);
    load_rows_bf16<D>(sV, v + k_base, k0, BT, sk, k_stride, tid);
    load_step(0);
  }
  cp_async_commit();

  float dka[D / 2], dva[D / 2], st[BI / 2], dpt[BI / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BI / 2; ++i) st[i] = dpt[i] = 0.f;

  const int key = k0 + 16 * warp + g;      // and key + 8
  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);             // its stage was released at n - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    fence_proxy_async();
    const uint32_t sQ = stage(n);
    const uint32_t sdO = sQ + C::ITILE;
    const float* Ls = reinterpret_cast<const float*>(
        smem_b + (sQ - sK) + 2 * C::ITILE);
    const float* Dls = Ls + BI;
    const int q0 = i_lo + (n % n_it) * BI;

    // S^T = K.Q^T, dP^T = V.dO^T: 64 keys x BI queries; st[4 j + 2 i + e]
    // is key + 8 i, query q0 + 8 j + 2 t + e
    wgmma_fence();
    gemm_ss<D, BI>(st, sK, sQ);
    gemm_ss<D, BI>(dpt, sV, sdO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool full = mk.full(q0, BI, k0, BT);
#pragma unroll
    for (int j = 0; j < BI / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float nl = -Ls[col] * LOG2E;
        const float dd = Dls[col];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p_ds(st[4 * j + 2 * i + e], dpt[4 * j + 2 * i + e], scale2, nl, dd,
               full || mk.visible(q0 + col, key + 8 * i));
      }
    uint32_t pa[BI / 16][4], da[BI / 16][4];
    to_a_frags<BI>(st, pa);
    to_a_frags<BI>(dpt, da);

    // dV += P^T.dO, dK += dS^T.Q over the BI queries
    wgmma_fence();
    gemm_rs<D, BI>(dva, pa, sdO);
    gemm_rs<D, BI>(dka, da, sQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();                // the stage is free for n + 2
  }
  cp_async_wait<0>();
  store_acc<D>(dk + k_base, dka, scale, k0 + 16 * warp, sk, k_stride, g, t);
  store_acc<D>(dv + k_base, dva, 1.f, k0 + 16 * warp, sk, k_stride, g, t);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int n_bh, int n_qb, int sq,
                  int sk, int hq, int hkv, int causal, int window,
                  float scale) {
  using C = Bf16Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem_b[];
  const uint32_t sQ = smem_u32(smem_b);
  const uint32_t sdO = sQ + C::TILE;
  const uint32_t ring = sdO + C::TILE;     // 2 x (K, V)

  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qb - 1 - blockIdx.x / n_bh) * BT;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long q_base = ((long long)b * sq * hq + h) * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;
  const float scale2 = scale * LOG2E;

  int lo, hi;
  mk.keys(q0, lo, hi);
  const int j_lo = lo / BT * BT;
  const int n_tiles = hi > j_lo ? (hi - j_lo + BT - 1) / BT : 0;

  auto stage = [&](int n) { return ring + (n & 1) * 2 * C::TILE; };
  auto load_tile = [&](int n) {
    const uint32_t st = stage(n);
    const int kt0 = j_lo + n * BT;
    load_rows_bf16<D>(st, k + k_base, kt0, BT, sk, k_stride, tid);
    load_rows_bf16<D>(st + C::TILE, v + k_base, kt0, BT, sk, k_stride, tid);
  };

  // the thread's two query rows, row and row + 8
  const int row = q0 + 16 * warp + g;
  float nl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const long long at = ((long long)b * hq + h) * sq + r;
    nl[i] = r < sq ? -lse[at] * LOG2E : 0.f;
    dd[i] = r < sq ? delta[at] : 0.f;
  }
  zero_pad<D>(smem_b, 6 * BT, tid);        // Q, dO and both stages' K, V
  if (n_tiles > 0) {
    load_rows_bf16<D>(sQ, q + q_base, q0, BT, sq, q_stride, tid);
    load_rows_bf16<D>(sdO, dout + q_base, q0, BT, sq, q_stride, tid);
    load_tile(0);
  }
  cp_async_commit();

  float dqa[D / 2], s[BT / 2], dp[BT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) {
      load_tile(n + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    fence_proxy_async();
    const uint32_t sK = stage(n);
    const uint32_t sV = sK + C::TILE;
    const int kt0 = j_lo + n * BT;

    // S = Q.K^T, dP = dO.V^T: 64 rows x 64 keys; s[4 j + 2 i + e] is
    // row + 8 i, key kt0 + 8 j + 2 t + e
    wgmma_fence();
    gemm_ss<D, BT>(s, sQ, sK);
    gemm_ss<D, BT>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool full = mk.full(q0, BT, kt0, BT);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p_ds(s[4 * j + 2 * i + e], dp[4 * j + 2 * i + e], scale2, nl[i],
               dd[i],
               full || mk.visible(row + 8 * i, kt0 + 8 * j + 2 * t + e));
    uint32_t da[BT / 16][4];
    to_a_frags<BT>(dp, da);

    wgmma_fence();
    gemm_rs<D, BT>(dqa, da, sK);            // dQ += dS.K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
    fence_regs(da);
    __syncthreads();                // the stage is free for n + 2
  }
  cp_async_wait<0>();
  store_acc<D>(dq + q_base, dqa, scale, q0 + 16 * warp, sq, q_stride, g, t);
}

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float* o;
  const void* dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, sq, sk, hq, hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T>
int launch(const Args& a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using KvFn = void (*)(const T*, const T*, const T*, const T*, const float*,
                        const float*, T*, T*, int, int, int, int, int, int,
                        int, float);
  using QFn = void (*)(const T*, const T*, const T*, const T*, const float*,
                       const float*, T*, int, int, int, int, int, int, int,
                       int, float);
  KvFn dkdv;
  QFn dq;
  int kv_bytes, q_bytes;
  if constexpr (F32) {
    dkdv = flash_bwd_dkdv_f32<D>;
    dq = flash_bwd_dq_f32<D>;
    kv_bytes = F32Cfg<D>::BYTES;
    q_bytes = (2 * BT * F32Cfg<D>::LD + 4 * F32Cfg<D>::BI * F32Cfg<D>::LD)
              * 4;
  } else {
    dkdv = flash_bwd_dkdv_bf16<D>;
    dq = flash_bwd_dq_bf16<D>;
    kv_bytes = Bf16Cfg<D>::KV_BYTES;
    q_bytes = Bf16Cfg<D>::Q_BYTES;
  }
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const long long n_rows = (long long)a.B * a.sq * a.hq;
  const long long delta_blocks = (n_rows + 7) / 8;
  const int n_kb = (a.sk + BT - 1) / BT;
  const int n_qb = (a.sq + BT - 1) / BT;
  const long long kv_blocks = (long long)a.B * a.hkv * n_kb;
  const long long q_blocks = (long long)a.B * a.hq * n_qb;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;

  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;

  flash_bwd_delta<T><<<(unsigned)delta_blocks, 256, 0, a.stream>>>(
      dout, a.o, a.delta, n_rows, a.sq, a.hq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)kv_blocks, NT, kv_bytes, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B * a.hkv, a.sq, a.sk, a.hq, a.hkv, a.causal,
      a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<(unsigned)q_blocks, NT, q_bytes, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.B * a.hq, n_qb,
      a.sq, a.sk, a.hq, a.hkv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const Args& a) {
  switch (dh) {
    case 16: return launch<16, T>(a);
    case 32: return launch<32, T>(a);
    case 64: return launch<64, T>(a);
    case 120: return launch<120, T>(a);
    case 128: return launch<128, T>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dQ, dK, dV of flash_mha_lse's forward.  q, k, v, dout, dq, dk, dv in the
// input dtype (0 = float32, 1 = bfloat16); o, lse f32 as the forward wrote
// them; delta a f32 workspace of B * Hq * Sq.  window < 0: no window.
// Launches three kernels on `stream`; returns the first launch error.
extern "C" int flash_mha_bwd(const void* q, const void* k, const void* v,
                             const float* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int B, int sq, int sk,
                             int hq, int hkv, int dh, int dtype, int causal,
                             int window, float scale, void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, sq, sk, hq, hkv,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(dh, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dh, a);
  return (int)cudaErrorInvalidValue;
}
