// Blocked online-softmax attention forward (flash attention) for Hopper's
// tensor cores.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_mha_kernel (body
// _flash_kernel): q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (f32 or bf16, the
// model layer's layout), out [B, Sq, Hq, D] f32.  Query row i sits at key
// position i + (Sk - Sq); key j is visible to it where j < Sk, j <= i + off
// (causal) and j > i + off - window (sliding window).  A row with no
// visible key gives 0.  Query head h reads KV head h / (Hq / Hkv), so GQA
// needs no repeated K/V in memory.
//
// What bounds it on this card: operations, and the exponentials beside
// them.  At the serving path's prefill (B = 4, Sq = Sk = 5120, 32 heads
// over 8 KV heads, D = 120, window 4096) there are 1.61 G visible (q, k)
// pairs a launch.  bf16 inputs: 4 D flops a pair (q.k and p.v) on the
// tensor cores at 989 TFLOP/s, 0.78 ms.  f32 inputs: 3xTF32 makes it
// 12 D flops a pair at the 495 TFLOP/s TF32 rate, 4.69 ms.  Either way
// one exp a pair at 16 a clock an SM on the SFUs is a second bound of
// about 0.39 ms, so softmax work has to stay small beside the MMAs.
// Inputs and output move 0.2 GB, 0.06 ms at 3.35 TB/s.
//
// One design for both types: a CTA takes 128 query rows of one (batch,
// head) and walks 64-key tiles of K and V through a ring of stages in
// shared memory (two for f32, three for bf16), so that later tiles load
// (cp.async, 16 bytes a copy, rows past Sk zero-filled) while a tile
// computes.  Both products run on the tensor cores with f32
// accumulators.  The scores S = Q.K^T stay in registers and the online
// softmax works on the accumulator fragments: a row's max is taken on the
// raw scores with a quad's shuffles, p = exp2(s * c - m * c) with
// c = scale * log2(e) as one fma, masked scores become -inf so that their
// p is 0, a row that has seen no key yet keeps m = -inf and takes exp2
// against 0 (no NaN), and the row sum is kept per thread and reduced once
// at the end.  p is fed back to the P.V product from registers.  Key
// tiles that the causal and window masks hide from every row of the CTA
// are skipped; in the reference such a tile has alpha = 1 and p = 0, so
// skipping is exact.  Tiles every row sees in full skip the per-element
// mask.  The grid orders (batch, head) fastest, so a KV group's heads
// share K/V in L2, and runs the last query block (the most key tiles in a
// causal prefill) first.
//
// bf16 (flash_fwd_bf16): three warpgroups.  The first is the producer:
// its 128 threads issue the cp.async copies into the ring and signal a
// stage's `full` mbarrier through cp.async.mbarrier.arrive.noinc (with
// one producer warp alone the kernel took 21 % longer at the serving
// shape: the warp's copies took issue slots from the consumer warp on its
// scheduler, and a warpgroup's wgmma waits for its slowest warp; with two
// stages instead of three, 33 % longer).  The two consumer warpgroups
// (64 rows each) release a stage on its `empty` mbarrier.  A consumer
// issues one batch of MMAs a key tile, S of tile j and P.V of tile j - 1,
// and runs the softmax of tile j while the other consumer's batch has
// the tensor cores; the first and last batches are peeled off, so that no
// wgmma issues under a branch (ptxas serializes them otherwise).
// S = Q.K^T is wgmma.mma_async m64n64k16 with Q and the K tile in shared
// memory, both K-major in the no-swizzle core-matrix layout (8 rows x 16
// bytes, contiguous); for D = 120 the contraction is padded to 128 with
// zero columns of Q and K in shared memory, never in device memory.
// O += P.V is wgmma m64nDk16 with P from registers (the accumulator
// fragment of S is the A fragment of P.V) and V as the MN-major B operand,
// copied as it lies in memory.  P goes in as two bf16 terms, P_hi.V +
// P_lo.V with P_hi = bf16(p) and P_lo = bf16(p - P_hi): P rounded once to
// bf16 misses the bf16 tolerance against the plain version by about 10x.
//
// f32 (flash_fwd_f32): eight warps of 16 rows each, every thread issuing
// cp.async.  Both products are mma.sync m16n8k8 TF32 in three terms,
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, split in registers from one
// f32 tile in shared memory: hi is x rounded to TF32 as cvt.rna.tf32.f32
// would (done in two integer operations: with the conversion instruction
// the kernel was much slower), lo = x - hi, which the tensor core reads as
// TF32.  That keeps the result f32-accurate (within 1e-5 of the plain
// f32 version on N(0, 1) inputs at the serving shape; one TF32 rounding
// gives about 1e-3) whatever torch.backends.cuda.matmul.allow_tf32 says.
// Within each group of 8 along the contraction, the fragment's column
// c < 4 holds element 2c and column c + 4 element 2c + 1 (for Q.K^T
// along D, for P.V along the keys): the sum is the same, the Q and K
// fragments load as float2, and P's accumulator fragment is P.V's A
// fragment unchanged.  wgmma is not used for f32: its TF32 form takes
// K-major operands only, so V would need a transposed copy and the hi/lo
// terms staged tiles, about twice the shared memory.
//
// Left for later: TMA loads with swizzled tiles, Q in registers, a
// persistent grid, and a split-K path for short query blocks (decode,
// Sq = 1, uses one row of a 128-row CTA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -__builtin_huge_valf();
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;         // query rows a CTA
constexpr int BK = 64;          // keys a tile
constexpr int STAGES = 2;       // K/V ring depth

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The row's log-sum-exp of the scaled scores, m * scale + log(l), into
// lse [B, Hq, Sq] (what the backward kernel recomputes P from).  A row
// with no visible key gets +inf, so that exp(s * scale - lse) is 0 there.
__device__ __forceinline__ void store_lse(float* lse, int b, int h, int hq,
                                          int sq, int r, float m, float l,
                                          float scale) {
  lse[((long long)b * hq + h) * sq + r] =
      l == 0.f ? __builtin_huge_valf() : m * scale + logf(l);
}

// Which key tiles the CTA's rows [q0, q0 + BQ) can see, and whether a
// tile is seen in full by every row (no per-element mask needed).
struct Span {
  int k_lo, n_tiles, r_first, r_last, off, sk, causal, window;

  __device__ Span(int q0, int sq, int sk_, int causal_, int window_)
      : off(sk_ - sq), sk(sk_), causal(causal_), window(window_) {
    r_first = q0;
    r_last = min(q0 + BQ, sq) - 1;
    int lo = 0, hi = sk;
    if (window >= 0) lo = max(0, r_first + off - window + 1);
    if (causal) hi = min(sk, r_last + off + 1);
    k_lo = (lo / BK) * BK;
    n_tiles = hi > k_lo ? (hi - k_lo + BK - 1) / BK : 0;
  }

  __device__ bool full(int k0) const {
    return k0 + BK <= sk && (!causal || k0 + BK - 1 <= r_first + off) &&
           (window < 0 || k0 > r_last + off - window);
  }

  __device__ bool visible(int row, int sq, int col) const {
    const int pos = row + off;
    return row < sq && col < sk && (!causal || col <= pos) &&
           (window < 0 || col > pos - window);
  }
};

// One row pair's online-softmax step on 2 * NJ scores of rows (row, row +
// 8): s[4 j + 2 i + e] is row + 8 i, key k0 + 8 j + 2 t + e.  Scores are
// replaced by p = exp2(s * scale2 - m * scale2); m (in score units) and
// the per-thread partial sums l are updated; alpha[i] is the factor for
// row i's output so far.  Masked scores become -inf, so their p is 0; a
// row that has seen no key yet keeps m = -inf and takes exp2 against 0.
template <int NJ>
__device__ __forceinline__ void online_softmax(float* s, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Span& sp, bool full,
                                               int row, int sq, int k0,
                                               int t, float scale2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!full) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!sp.visible(row + 8 * i, sq, k0 + 8 * j + 2 * t + e))
            s[4 * j + 2 * i + e] = NEG_INF;
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[4 * j + 2 * i + e]);
    mx = quad_max(mx);
    const float m_new = fmaxf(m[i], mx);
    const float base = m_new == NEG_INF ? 0.f : m_new * scale2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = ex2(__fmaf_rn(x, scale2, -base));
        sum += x;
      }
    alpha[i] = ex2(__fmaf_rn(m[i], scale2, -base));
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// ---------------------------------------------------------------------------
// float32: mma.sync m16n8k8 TF32, three terms

// hi: x rounded to TF32 (10 mantissa bits, nearest, ties away from zero:
// what cvt.rna.tf32.f32 gives, in two integer operations instead of a
// conversion); lo: the rest x - hi, exact in f32, which the tensor core
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
                                           const uint32_t (&al)[4],
                                           const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b[0], bh0, bl0);
  split_tf32(b[1], bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D>
struct F32Cfg {
  static constexpr int NT = 256;                   // 8 warps x 16 rows
  static constexpr int LDK = (D + 31) / 32 * 32 + 8;  // Q, K row stride
  static constexpr int LDV = (D + 31) / 32 * 32 + 4;  // V row stride
  static constexpr int STAGE = BK * (LDK + LDV);   // floats a ring stage
  static constexpr int BYTES = (BQ * LDK + STAGES * STAGE) * 4;
};

// Rows [row0, row0 + n) of a [rows, D] f32 slice with row stride `stride`
// (elements) into dst [n][ld] by cp.async; rows at or past n_rows are
// zero-filled.
template <int D, int NT>
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

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::NT, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int n_bh, int n_qb, int sq, int sk,
              int hq, int hkv, int causal, int window, float scale) {
  using C = F32Cfg<D>;
  constexpr int ND = D / 8;       // 8-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][LDK]
  float* ring = Qs + BQ * C::LDK; // STAGES x (K [BK][LDK], V [BK][LDV])

  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row = q0 + warp * 16 + g;      // and row + 8

  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const float* qp = q + ((long long)b * sq * hq + h) * D;
  const float* kp = k + ((long long)b * sk * hkv + hk) * D;
  const float* vp = v + ((long long)b * sk * hkv + hk) * D;
  const Span sp(q0, sq, sk, causal, window);
  const float scale2 = scale * LOG2E;

  auto load_tile = [&](int it) {
    float* Ks = ring + (it % STAGES) * C::STAGE;
    const int k0 = sp.k_lo + it * BK;
    load_rows_f32<D, C::NT>(Ks, C::LDK, kp, k0, BK, sk, k_stride, tid);
    load_rows_f32<D, C::NT>(Ks + BK * C::LDK, C::LDV, vp, k0, BK, sk,
                            k_stride, tid);
  };

  load_rows_f32<D, C::NT>(Qs, C::LDK, qp, q0, BQ, sq, q_stride, tid);
  if (sp.n_tiles > 0) load_tile(0);
  cp_async_commit();

  float o[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const float* q_lo = Qs + (warp * 16 + g) * C::LDK + 2 * t;
  for (int it = 0; it < sp.n_tiles; ++it) {
    if (it + 1 < sp.n_tiles) {
      load_tile(it + 1);            // its stage was released at it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = ring + (it % STAGES) * C::STAGE;
    const float* Vs = Ks + BK * C::LDK;
    const int k0 = sp.k_lo + it * BK;

    // S = Q.K^T: 16 rows x 64 keys a warp, s[j] holds keys 8 j ..
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < ND; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(q_lo + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(q_lo + 8 * C::LDK + 8 * kk);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            Ks + (8 * j + g) * C::LDK + 8 * kk + 2 * t);
        const float bb[2] = {y.x, y.y};
        mma_3xtf32(s[j], ah, al, bb);
      }
    }

    float alpha[2];
    online_softmax<BK / 8>(&s[0][0], m, l, alpha, sp, sp.full(k0), row, sq,
                           k0, t, scale2);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P.V: p of keys 8 j + 2 t, + 1 are the A fragment's columns t,
    // t + 4; V rows 8 j + 2 t, + 1 the B fragment's rows t, t + 4
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* v0 = Vs + (8 * j + 2 * t) * C::LDV + g;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const float bb[2] = {v0[8 * dn], v0[C::LDV + 8 * dn]};
        mma_3xtf32(o[dn], ah, al, bb);
      }
    }
    __syncthreads();                // the stage is free for it + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const float li = quad_sum(l[i]);
    if (r >= sq) continue;
    if (lse != nullptr && t == 0)
      store_lse(lse, b, h, hq, sq, r, m[i], li, scale);
    const float denom = li == 0.f ? 1.f : li;
    float* op = out + (((long long)b * sq + r) * hq + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(op + 8 * dn) =
          make_float2(o[dn][2 * i] / denom, o[dn][2 * i + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma with one producer warp

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// orders this thread's generic-proxy view of shared memory (cp.async and
// st.shared) before its async-proxy accesses (wgmma operand reads)
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
// matrices along the contraction, `stride` along M or N (for K-major Q and
// K and for MN-major V alike).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

// S[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59}, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
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

constexpr int BF16_STAGES = 3;  // K/V ring depth of the bf16 path

template <int D>
struct Bf16Cfg {
  static constexpr int NT = 384;              // producer + 2 consumer WGs
  static constexpr int DP = (D + 15) / 16 * 16;   // Q.K^T contraction
  static constexpr int ROW_GROUP = DP / 8 * 128;  // bytes: 8 rows of Q, K
  static constexpr int V_GROUP = BK / 8 * 128;    // bytes: 8 columns of V
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int K_BYTES = BK * DP * 2;
  static constexpr int V_BYTES = BK * D * 2;
  static constexpr int BAR = Q_BYTES + BF16_STAGES * (K_BYTES + V_BYTES);
  static constexpr int BYTES = BAR + 8 * (2 * BF16_STAGES + 1);
};

// byte offset of element (r, c) of a K-major tile (Q, K: r a row, c along
// D) and of (key, d) of an MN-major V tile, for a 16-byte chunk (c, d
// multiples of 8)
template <int D>
__device__ __forceinline__ uint32_t kmajor(int r, int c) {
  return (r >> 3) * Bf16Cfg<D>::ROW_GROUP + (c >> 3) * 128 + (r & 7) * 16;
}

template <int D>
__device__ __forceinline__ uint32_t mnmajor(int key, int d) {
  return (d >> 3) * Bf16Cfg<D>::V_GROUP + (key >> 3) * 128 + (key & 7) * 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory addresses and geometry of one consumer warpgroup.
struct Bf16Ctx {
  uint32_t qa, sK, sV, bar;
  int row, sq, t;
  float scale2;
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return bar + 8 * (BF16_STAGES + s);
  }
};

// P of a 64 x 64 score tile as the A fragments of the P.V product, in
// two bf16 terms: S's fragment of keys 16 kt .. + 15 is the A fragment of
// step kt
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[8 * kt + 2 * r], y = s[8 * kt + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      ph[kt][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kt][r] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
    }
}

__device__ __forceinline__ void wait_tile(const Bf16Ctx& c, int it) {
  mbar_wait(c.full(it % BF16_STAGES), (it / BF16_STAGES) & 1);
  fence_proxy_async();
}

// S = Q.K^T of tile `it` over DP / 16 steps of 16
template <int D>
__device__ __forceinline__ void qk_batch(float (&s)[BK / 2],
                                         const Bf16Ctx& c, int it) {
  using C = Bf16Cfg<D>;
  const uint32_t ka = c.sK + (it % BF16_STAGES) * C::K_BYTES;
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk)
    wgmma_ss_n64(s, smem_desc(c.qa + 256 * kk, 128, C::ROW_GROUP),
                 smem_desc(ka + 256 * kk, 128, C::ROW_GROUP), kk > 0);
}

// O += P_hi.V + P_lo.V of tile `it` over 4 steps of 16 keys
template <int D>
__device__ __forceinline__ void pv_batch(float (&o)[D / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         const Bf16Ctx& c, int it) {
  using C = Bf16Cfg<D>;
  const uint32_t va = c.sV + (it % BF16_STAGES) * C::V_BYTES;
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    const uint64_t dv = smem_desc(va + 256 * kt, 128, C::V_GROUP);
    wgmma_rs<D>(o, ph[kt], dv);
    wgmma_rs<D>(o, pl[kt], dv);
  }
}

// the online softmax of tile `it` on its scores s, O rescaled to the new
// row maxima, and P split into the A fragments of the next P.V
template <int D>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&o)[D / 2], uint32_t (&ph)[BK / 16][4],
    uint32_t (&pl)[BK / 16][4], float (&m)[2], float (&l)[2],
    const Bf16Ctx& c, const Span& sp, int it) {
  const int k0 = sp.k_lo + it * BK;
  float alpha[2];
  online_softmax<BK / 8>(s, m, l, alpha, sp, sp.full(k0), c.row, c.sq, k0,
                         c.t, c.scale2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0]; o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1]; o[4 * j + 3] *= alpha[1];
  }
  split_p(s, ph, pl);
}

template <int D>
__global__ void __launch_bounds__(Bf16Cfg<D>::NT, 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int n_bh, int n_qb, int sq, int sk,
               int hq, int hkv, int causal, int window, float scale) {
  using C = Bf16Cfg<D>;
  constexpr int CH = D / 8;                   // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem_b[];
  Bf16Ctx c;
  const uint32_t sQ = smem_u32(smem_b);
  c.sK = sQ + C::Q_BYTES;                     // STAGES x [BK][DP]
  c.sV = c.sK + BF16_STAGES * C::K_BYTES;     // STAGES x [BK][D]
  c.bar = sQ + C::BAR;
  const uint32_t q_full = c.bar + 16 * BF16_STAGES;

  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const Span sp(q0, sq, sk, causal, window);

  if (tid == 0) {
    for (int s = 0; s < BF16_STAGES; ++s) {
      mbar_init(c.full(s), 128);
      mbar_init(c.empty(s), 2);
    }
    mbar_init(q_full, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::DP != D) {
    // zero the contraction's padding columns of Q and of every K stage
    constexpr int PAD = (C::DP - D) / 8;
    for (int idx = tid; idx < (BQ + BF16_STAGES * BK) * PAD;
         idx += C::NT) {
      const int r = idx / PAD;
      const int col = D + 8 * (idx - r * PAD);
      const uint32_t off = r < BQ ? kmajor<D>(r, col)
                                  : C::Q_BYTES + kmajor<D>(r - BQ, col);
      *reinterpret_cast<uint4*>(smem_b + off) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: its 128 threads issue every copy
    const long long q_stride = (long long)hq * D;
    const long long k_stride = (long long)hkv * D;
    const __nv_bfloat16* qp = q + ((long long)b * sq * hq + h) * D;
    const __nv_bfloat16* kp = k + ((long long)b * sk * hkv + hk) * D;
    const __nv_bfloat16* vp = v + ((long long)b * sk * hkv + hk) * D;
    for (int idx = tid; idx < BQ * CH; idx += 128) {
      const int r = idx / CH;
      const int col = 8 * (idx - r * CH);
      const bool ok = q0 + r < sq;
      cp_async16(sQ + kmajor<D>(r, col),
                 qp + (ok ? (q0 + r) * q_stride + col : 0), ok);
    }
    cp_async_arrive(q_full);
    for (int it = 0; it < sp.n_tiles; ++it) {
      const int s = it % BF16_STAGES;
      mbar_wait(c.empty(s), ((it / BF16_STAGES) & 1) ^ 1);
      const int k0 = sp.k_lo + it * BK;
      for (int idx = tid; idx < BK * CH; idx += 128) {
        const int r = idx / CH;
        const int col = 8 * (idx - r * CH);
        const bool ok = k0 + r < sk;
        const long long src = ok ? (k0 + r) * k_stride + col : 0;
        cp_async16(c.sK + s * C::K_BYTES + kmajor<D>(r, col), kp + src, ok);
        cp_async16(c.sV + s * C::V_BYTES + mnmajor<D>(r, col), vp + src,
                   ok);
      }
      cp_async_arrive(c.full(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warpgroup w: rows q0 + 64 w .. + 63
  const int w = tid / 128 - 1;
  c.t = tid & 3;
  c.row = q0 + 64 * w + 16 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
  c.sq = sq;
  c.scale2 = scale * LOG2E;
  c.qa = sQ + w * 8 * C::ROW_GROUP;

  float o[D / 2], sc[BK / 2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

  // One batch of MMAs a key tile: S of tile it and P.V of tile it - 1,
  // then the softmax of tile it on S while the other consumer
  // warpgroup's batch runs on the tensor cores.  Between batches P of
  // tile it - 1 is in ph, pl and O holds every tile before it - 1,
  // rescaled.  The first and last batches are peeled off, so that no
  // wgmma is issued under a branch.
  mbar_wait(q_full, 0);
  const int n = sp.n_tiles;
  if (n > 0) {
    wait_tile(c, 0);
    wgmma_fence();
    qk_batch<D>(sc, c, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    softmax_tile<D>(sc, o, ph, pl, m, l, c, sp, 0);
    for (int it = 1; it < n; ++it) {
      wait_tile(c, it);
      wgmma_fence();
      qk_batch<D>(sc, c, it);
      pv_batch<D>(o, ph, pl, c, it - 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      if ((tid & 127) == 0) mbar_arrive(c.empty((it - 1) % BF16_STAGES));
      softmax_tile<D>(sc, o, ph, pl, m, l, c, sp, it);
    }
    wgmma_fence();
    pv_batch<D>(o, ph, pl, c, n - 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if ((tid & 127) == 0) mbar_arrive(c.empty((n - 1) % BF16_STAGES));
  }

  const int t = c.t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = c.row + 8 * i;
    const float li = quad_sum(l[i]);
    if (r >= sq) continue;
    if (lse != nullptr && t == 0)
      store_lse(lse, b, h, hq, sq, r, m[i], li, scale);
    const float denom = li == 0.f ? 1.f : li;
    float* op = out + (((long long)b * sq + r) * hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) = make_float2(
          o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
  }
}

// ---------------------------------------------------------------------------

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, float* out,
           float* lse, int B, int sq, int sk, int hq, int hkv, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int threads = F32 ? F32Cfg<D>::NT : Bf16Cfg<D>::NT;
  constexpr int bytes = F32 ? F32Cfg<D>::BYTES : Bf16Cfg<D>::BYTES;
  void (*kern)(const T*, const T*, const T*, float*, float*, int, int, int,
               int, int, int, int, int, float);
  if constexpr (F32) kern = flash_fwd_f32<D>;
  else kern = flash_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_bh = B * hq;
  const int n_qb = (sq + BQ - 1) / BQ;
  const long long blocks = (long long)n_bh * n_qb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, lse, n_bh, n_qb, sq, sk, hq, hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v,
             float* out, float* lse, int B, int sq, int sk, int hq, int hkv,
             int causal, int window, float scale, cudaStream_t stream) {
#define FLASH_CASE(DH)                                                    \
  case DH:                                                                \
    return launch<DH, T>(q, k, v, out, lse, B, sq, sk, hq, hkv, causal,  \
                         window, scale, stream);
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(120)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0: no window.  lse, where
// not null, receives each row's log-sum-exp [B, Hq, Sq] (float32), for the
// backward kernel (flash_attention_bwd.cu).  Returns the launch's
// cudaGetLastError().
extern "C" int flash_mha_lse(const void* q, const void* k, const void* v,
                             float* out, float* lse, int B, int sq, int sk,
                             int hq, int hkv, int dh, int dtype, int causal,
                             int window, float scale, void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, out, lse, B, sq, sk, hq, hkv, causal,
                           window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, out, lse, B, sq, sk, hq, hkv,
                                   causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The forward alone, as flash_mha_lse with no lse.
extern "C" int flash_mha(const void* q, const void* k, const void* v,
                         float* out, int B, int sq, int sk, int hq, int hkv,
                         int dh, int dtype, int causal, int window,
                         float scale, void* stream) {
  return flash_mha_lse(q, k, v, out, nullptr, B, sq, sk, hq, hkv, dh, dtype,
                       causal, window, scale, stream);
}
