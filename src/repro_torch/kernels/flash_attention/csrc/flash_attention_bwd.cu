// Flash-attention backward: dQ, dK, dV of flash_attention.cu's forward.
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
//   dV_j = sum_i P_ij dO_i,   dK_j = scale sum_i dS_ij Q_i   (flash_bwd_dkdv)
//   dQ_i = scale sum_j dS_ij K_j                            (flash_bwd_dq)
// A fully masked row has P = 0 and so no gradient (never NaN).
//
// Deterministic, with no atomics: flash_bwd_dkdv gives one CTA a 64-key
// tile of one KV head and loops over the query heads of its GQA group and
// the query tiles that can see the tile, summing into registers in a fixed
// order; flash_bwd_dq gives one CTA 64 query rows of one head and loops
// over the key tiles they can see.  S and dP are recomputed in both, so
// the kernels take 14 D flops a visible (q, k) pair against the 10 D of
// the five products; and each of the three kernels reads what it needs
// from device memory on its own.
//
// A simple design on the CUDA cores, in f32 for both input types (bf16 is
// widened as it is loaded, and the gradients are rounded to bf16 as they
// are stored): 256 threads as 16 x 16; every tile of 64 rows sits in
// shared memory as f32 with a row stride of D + 4 floats (float4 loads,
// and rows of one 8-thread phase fall in distinct banks); a thread holds a
// 4 x 4 block of S and dP (rows ty + 16 a, keys tx + 16 b) and, of a 64 x D
// output, rows ty + 16 a by float4 columns tx + 16 c.  Every product is an
// explicit fused multiply-add (the library builds with -fmad=false).  No
// tensor cores, no asynchronous copies, no overlap of loads with compute:
// TF32 or 3xTF32 mma.sync, wgmma and TMA are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BT = 64;          // query rows or keys a tile
constexpr int NT = 256;         // threads a CTA (16 x 16)
constexpr int LDP = BT + 4;     // row stride of a P or dS tile (floats)

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;               // Q, dO, K, V row stride
  static constexpr int C4 = D / 4;               // float4 columns a row
  static constexpr int NC = (C4 + 15) / 16;      // of them a thread
  static constexpr int DKDV_BYTES = (4 * BT * LD + 2 * BT * LDP + 2 * BT) * 4;
  static constexpr int DQ_BYTES = (4 * BT * LD + BT * LDP + 2 * BT) * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int E>
__device__ __forceinline__ float comp(const float4& x) {
  return E == 0 ? x.x : E == 1 ? x.y : E == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& b) {
  acc.x = __fmaf_rn(w, b.x, acc.x);
  acc.y = __fmaf_rn(w, b.y, acc.y);
  acc.z = __fmaf_rn(w, b.z, acc.z);
  acc.w = __fmaf_rn(w, b.w, acc.w);
}

struct Mask {
  int off, sq, sk, causal, window;

  __device__ bool visible(int i, int j) const {
    const int pos = i + off;
    return i < sq && j < sk && (!causal || j <= pos) &&
           (window < 0 || j > pos - window);
  }
};

// Rows [row0, row0 + BT) of a [rows, D] slice with row stride `stride`
// (elements) into dst [BT][LD] as f32; rows at or past n_rows are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, long long stride,
                                          int tid) {
  for (int idx = tid; idx < BT * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * Cfg<D>::LD + c] =
        row0 + r < n_rows ? to_f32(src[(row0 + r) * stride + c]) : 0.f;
  }
}

// acc[a][b] = A[ty + 16 a] . B[tx + 16 b] over D, both tiles [BT][LD]
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = Cfg<D>::LD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = acc[a][b];
        s = __fmaf_rn(x[a].x, y[b].x, s);
        s = __fmaf_rn(x[a].y, y[b].y, s);
        s = __fmaf_rn(x[a].z, y[b].z, s);
        acc[a][b] = __fmaf_rn(x[a].w, y[b].w, s);
      }
  }
}

// acc[a][c] += sum_i A[ty + 16 a][i] * B[i][4 (tx + 16 c) ..], A [BT][LDP]
// (a P or dS tile), B [BT][LD]
template <int D>
__device__ __forceinline__ void accumulate(float4 (&acc)[4][Cfg<D>::NC],
                                           const float* A, const float* B,
                                           int ty, int tx) {
  constexpr int LD = Cfg<D>::LD;
  constexpr int NC = Cfg<D>::NC;
  constexpr int C4 = Cfg<D>::C4;
#pragma unroll 2
  for (int i = 0; i < BT; i += 4) {
    float4 w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      w[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LDP + i);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int c4 = tx + 16 * c;
      if (C4 % 16 != 0 && c4 >= C4) continue;
      const float* bp = B + i * LD + 4 * c4;
      const float4 b0 = *reinterpret_cast<const float4*>(bp);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + LD);
      const float4 b2 = *reinterpret_cast<const float4*>(bp + 2 * LD);
      const float4 b3 = *reinterpret_cast<const float4*>(bp + 3 * LD);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        fma4(acc[a][c], comp<0>(w[a]), b0);
        fma4(acc[a][c], comp<1>(w[a]), b1);
        fma4(acc[a][c], comp<2>(w[a]), b2);
        fma4(acc[a][c], comp<3>(w[a]), b3);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float4 (&acc)[4][Cfg<D>::NC]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < Cfg<D>::NC; ++c) acc[a][c] = make_float4(0, 0, 0, 0);
}

// rows row0 + ty + 16 a (< n_rows) of dst [rows, D] (row stride `stride`)
// <- acc * mul
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float4 (&acc)[4][Cfg<D>::NC],
                                           float mul, int row0, int n_rows,
                                           long long stride, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < Cfg<D>::NC; ++c) {
      const int c4 = tx + 16 * c;
      if (c4 >= Cfg<D>::C4) continue;
      T* p = dst + r * stride + 4 * c4;
      store(p, acc[a][c].x * mul);
      store(p + 1, acc[a][c].y * mul);
      store(p + 2, acc[a][c].z * mul);
      store(p + 3, acc[a][c].w * mul);
    }
  }
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

// P and dS of a (query tile, key tile) pair from the raw scores and dP
__device__ __forceinline__ void p_ds(float (&s)[4][4], float (&dp)[4][4],
                                     const Mask& mk, const float* Ls,
                                     const float* Dls, int q0, int k0,
                                     float scale, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      const float p = mk.visible(q0 + i, k0 + j)
                          ? expf(s[a][b] * scale - Ls[i])
                          : 0.f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - Dls[i]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int n_kb, int sq,
               int sk, int hq, int hkv, int causal, int window, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * C::LD;
  float* Qs = Vs + BT * C::LD;
  float* dOs = Qs + BT * C::LD;
  float* Pt = dOs + BT * C::LD;     // [key][query]
  float* dSt = Pt + BT * LDP;       // [key][query]
  float* Ls = dSt + BT * LDP;
  float* Dls = Ls + BT;

  const int kb = blockIdx.x % n_kb;
  const int bhk = blockIdx.x / n_kb;
  const int b = bhk / hkv;
  const int hk = bhk - b * hkv;
  const int k0 = kb * BT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;

  load_tile<D>(Ks, k + k_base, k0, sk, k_stride, tid);
  load_tile<D>(Vs, v + k_base, k0, sk, k_stride, tid);

  // the query rows that can see a key of [k0, k_last]
  const int k_last = min(k0 + BT, sk) - 1;
  int i_lo = causal ? max(0, k0 - mk.off) : 0;
  const int i_hi = window >= 0 ? min(sq, k_last - mk.off + window) : sq;
  i_lo = (i_lo / BT) * BT;

  float4 dka[4][C::NC], dva[4][C::NC];
  zero<D>(dka);
  zero<D>(dva);
  const int rep = hq / hkv;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long q_base = ((long long)b * sq * hq + h) * D;
    const float* lp = lse + ((long long)b * hq + h) * sq;
    const float* dl = delta + ((long long)b * hq + h) * sq;
    for (int q0 = i_lo; q0 < i_hi; q0 += BT) {
      __syncthreads();              // the last tile's readers are done
      load_tile<D>(Qs, q + q_base, q0, sq, q_stride, tid);
      load_tile<D>(dOs, dout + q_base, q0, sq, q_stride, tid);
      if (tid < BT) {
        const int r = q0 + tid;
        Ls[tid] = r < sq ? lp[r] : __builtin_huge_valf();
        Dls[tid] = r < sq ? dl[r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<D>(s, Qs, Ks, ty, tx);
      dot_tile<D>(dp, dOs, Vs, ty, tx);
      p_ds(s, dp, mk, Ls, Dls, q0, k0, scale, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          Pt[(tx + 16 * bb) * LDP + ty + 16 * a] = s[a][bb];
          dSt[(tx + 16 * bb) * LDP + ty + 16 * a] = dp[a][bb];
        }
      __syncthreads();
      accumulate<D>(dva, Pt, dOs, ty, tx);
      accumulate<D>(dka, dSt, Qs, ty, tx);
    }
  }
  store_rows<D>(dk + k_base, dka, scale, k0, sk, k_stride, ty, tx);
  store_rows<D>(dv + k_base, dva, 1.f, k0, sk, k_stride, ty, tx);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int n_bh, int n_qb, int sq, int sk, int hq,
             int hkv, int causal, int window, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * C::LD;
  float* Ks = dOs + BT * C::LD;
  float* Vs = Ks + BT * C::LD;
  float* dSs = Vs + BT * C::LD;     // [query][key]
  float* Ls = dSs + BT * LDP;
  float* Dls = Ls + BT;

  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = qb * BT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const Mask mk{sk - sq, sq, sk, causal, window};
  const long long q_stride = (long long)hq * D;
  const long long k_stride = (long long)hkv * D;
  const long long q_base = ((long long)b * sq * hq + h) * D;
  const long long k_base = ((long long)b * sk * hkv + hk) * D;

  load_tile<D>(Qs, q + q_base, q0, sq, q_stride, tid);
  load_tile<D>(dOs, dout + q_base, q0, sq, q_stride, tid);
  if (tid < BT) {
    const int r = q0 + tid;
    const long long at = ((long long)b * hq + h) * sq + r;
    Ls[tid] = r < sq ? lse[at] : __builtin_huge_valf();
    Dls[tid] = r < sq ? delta[at] : 0.f;
  }

  // the key tiles rows [q0, r_last] can see, as the forward's Span
  const int r_last = min(q0 + BT, sq) - 1;
  const int lo = window >= 0 ? max(0, q0 + mk.off - window + 1) : 0;
  const int hi = causal ? min(sk, r_last + mk.off + 1) : sk;

  float4 dqa[4][C::NC];
  zero<D>(dqa);
  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    __syncthreads();                // the last tile's readers are done
    load_tile<D>(Ks, k + k_base, k0, sk, k_stride, tid);
    load_tile<D>(Vs, v + k_base, k0, sk, k_stride, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, Qs, Ks, ty, tx);
    dot_tile<D>(dp, dOs, Vs, ty, tx);
    p_ds(s, dp, mk, Ls, Dls, q0, k0, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        dSs[(ty + 16 * a) * LDP + tx + 16 * bb] = dp[a][bb];
    __syncthreads();
    accumulate<D>(dqa, dSs, Ks, ty, tx);
  }
  store_rows<D>(dq + q_base, dqa, scale, q0, sq, q_stride, ty, tx);
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
  using C = Cfg<D>;
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
      flash_bwd_dkdv<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DKDV_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::DQ_BYTES);
  if (err != cudaSuccess) return (int)err;

  flash_bwd_delta<T><<<(unsigned)delta_blocks, 256, 0, a.stream>>>(
      dout, a.o, a.delta, n_rows, a.sq, a.hq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<D, T><<<(unsigned)kv_blocks, NT, C::DKDV_BYTES, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), n_kb, a.sq, a.sk, a.hq, a.hkv, a.causal,
      a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<D, T><<<(unsigned)q_blocks, NT, C::DQ_BYTES, a.stream>>>(
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
