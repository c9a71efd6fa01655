// Blocked online-softmax attention forward (flash attention) for Hopper.
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
// What bounds it on this card: operations.  At the serving path's prefill
// (Sq = Sk = 5120, 32 heads over 8 KV heads, D = 120, window 4096) a head
// has 12.6 M visible (q, k) pairs at 4 D flops each (q.k and p.v): 193
// GFLOP a launch, 2.9 ms at the 67 TFLOP/s f32 rate outside the tensor
// cores, against 0.2 GB of inputs and output, 0.06 ms at 3.35 TB/s.
//
// Design (simple first): one CTA of 256 threads (16 x 16) per 64 query
// rows of one (batch, head).  The CTA keeps its Q tile in shared memory
// and walks 64-key tiles of K and V, which it stages in shared memory
// (dynamic, ~97 KB at D = 128, so two CTAs share an SM).  Thread (ty, tx)
// computes the 4 x 4 scores of rows ty + 16 i and keys tx + 16 j with f32
// FMAs, keeps the running max m, sum l and its 4 x ceil(D/16) slice of the
// output in registers, and reduces a row's max and sum over the 16
// threads of a half-warp with shuffles.  P goes through shared memory
// (over the K tile, which is dead by then) for the P.V product.  Masked
// scores are NEG and their p is set to 0 explicitly: while every key so
// far is masked, m is NEG and exp(s - m) would be 1.  Key tiles that the
// causal and window masks hide from every row of the block are skipped;
// in the reference such a tile has alpha = 1 and p = 0, so skipping is
// exact.  The last CTAs of a causal prefill have the most tiles, so the
// grid runs query blocks from the last to the first.
//
// Left for later: tensor cores (wgmma; f32 inputs would need TF32 splits
// to hold the f32 tolerance), TMA or cp.async double buffering of the K/V
// tiles, P kept in registers, and a split-K path for short query blocks
// (decode, Sq = 1, uses one row of a 64-row CTA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows a CTA
constexpr int BK = 64;          // keys a tile
constexpr int NT = 256;         // threads a CTA: 16 x 16
constexpr int PS = BK + 1;      // row stride of the P tile (floats)
constexpr float NEG = -1e30f;

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Rows [row0, row0 + 64) of a [rows, D] slice with row stride `stride`
// (elements) into dst [64][LD]; rows at or past n_rows become zeros.
template <int D, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int n_rows,
                                          long long stride) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * C4; idx += NT) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4(src + (row0 + r) * stride + c, x);
    float* d = dst + r * LD + c;
    d[0] = x[0]; d[1] = x[1]; d[2] = x[2]; d[3] = x[3];
  }
}

template <int D>
struct Layout {
  static constexpr int DJ = (D + 15) / 16;   // output columns a thread
  static constexpr int QS = D + 1;           // Q and K row strides (odd:
  static constexpr int KS = D + 1;           //  no bank conflicts)
  static constexpr int VS = DJ * 16;         // V row stride, zero padded
  static constexpr int KP = (BK * KS > BQ * PS) ? BK * KS : BQ * PS;
  static constexpr int FLOATS = BQ * QS + KP + BK * VS;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D, typename T>
__global__ void __launch_bounds__(NT, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, float* __restrict__ out, int n_bh,
          int n_qb, int sq, int sk, int hq, int hkv, int causal, int window,
          float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QS]
  float* Ks = Qs + BQ * L::QS;      // [BK][KS], then P [BQ][PS]
  float* Vs = Ks + L::KP;           // [BK][VS]

  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = qb * BQ;
  const int off = sk - sq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const T* qp = q + ((long long)b * sq * hq + h) * D;
  const T* kp = k + ((long long)b * sk * hkv + hk) * D;
  const T* vp = v + ((long long)b * sk * hkv + hk) * D;

  // V's padding columns stay zero: tiles write only columns < D
  for (int i = threadIdx.x; i < BK * L::VS; i += NT) Vs[i] = 0.f;
  load_tile<D, L::QS>(Qs, qp, q0, sq, q_stride);

  // key tiles some row of this block can see
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_lo = 0, k_hi = sk;
  if (window >= 0) k_lo = max(0, q0 + off - window + 1);
  if (causal) k_hi = min(sk, q_last + off + 1);
  k_lo = (k_lo / BK) * BK;

  float m[4], l[4], o[4][L::DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < L::DJ; ++jj) o[i][jj] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();              // the last tile's P and V are consumed
    load_tile<D, L::KS>(Ks, kp, k0, sk, k_stride);
    load_tile<D, L::VS>(Vs, vp, k0, sk, k_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const int pos = row + off;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = row < sq && col < sk && (!causal || col <= pos) &&
                (window < 0 || col > pos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < L::DJ; ++jj) o[i][jj] *= alpha;
    }

    __syncthreads();              // every score is read out of the K tile
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[L::DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jj = 0; jj < L::DJ; ++jj) vv[jj] = Vs[kk * L::VS + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < L::DJ; ++jj) o[i][jj] = fmaf(pv[i], vv[jj], o[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* op = out + (((long long)b * sq + row) * hq + h) * D;
#pragma unroll
    for (int jj = 0; jj < L::DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) op[d] = o[i][jj] / denom;
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int sq, int sk, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  using L = Layout<D>;
  auto kern = flash_fwd<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_bh = B * hq;
  const int n_qb = (sq + BQ - 1) / BQ;
  const long long blocks = (long long)n_bh * n_qb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, n_bh, n_qb, sq, sk, hq, hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v,
             float* out, int B, int sq, int sk, int hq, int hkv, int causal,
             int window, float scale, cudaStream_t stream) {
#define FLASH_CASE(DH)                                                    \
  case DH:                                                                \
    return launch<DH, T>(q, k, v, out, B, sq, sk, hq, hkv, causal, window, \
                         scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16.  window < 0: no window.  Returns the
// launch's cudaGetLastError().
extern "C" int flash_mha(const void* q, const void* k, const void* v,
                         float* out, int B, int sq, int sk, int hq, int hkv,
                         int dh, int dtype, int causal, int window,
                         float scale, void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, out, B, sq, sk, hq, hkv, causal,
                           window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, out, B, sq, sk, hq, hkv,
                                   causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
