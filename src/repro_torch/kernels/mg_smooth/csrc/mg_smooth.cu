// Red-black z-line Gauss-Seidel half-sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel rb_line_sweep_kernel (body _rb_line_kernel) in
// src/repro/kernels/mg_smooth/kernel.py: the multigrid smoother of every
// V-cycle level.  Per (y, x) column of an [L, NY, NX] grid (optionally
// batched [B, L, NY, NX]; fields and d_extra follow the batch):
//
//   rhs[l]  = b + gx_lf T_left + gx_rt T_right + gy_up T_up + gy_dn T_down
//   diag[l] = gx_lf + gx_rt + gy_up + gy_dn + gz_up + gz_dn + g_pkg + d_extra
//             (1 where that sum is not > 0: void cells)
//   solve   diag[l] u[l] - gz_up[l] u[l-1] - gz_dn[l] u[l+1] = rhs[l]
//
// exactly by the Thomas recursion, and write u where (y + x) % 2 == color
// (y the global row, the same parity in every case of a batch), T
// elsewhere.  Lateral neighbours past an edge are the cell itself.  The
// output is out of place, so every column reads the frozen iterate.
//
// The coefficients come split by colour (ops.thomas_coefficients, made
// once a multigrid level): S is [2, 7, B, L, NY, NXH], NXH = ceil(NX / 2),
// and S[c, k, b, l, y, i] is array k at the cell (y, 2i + ((y + c) & 1)),
// the i-th cell of row y that a half-sweep of colour c solves.  The arrays
// are gx_lf, gx_rt, gy_up, gy_dn (the lateral terms of rhs), then the
// parts of the Thomas recursion that depend on the coefficients alone:
// lo = -gz_up, the pivot denom[l] and the forward coefficient cp[l],
//
//   denom[0] = diag[0],  denom[l] = diag[l] - lo[l] cp[l-1]  (1 where 0)
//   cp[l] = up[l] / denom[l]                                 (up = -gz_dn)
//
// computed once a level by the same float32 operations, in the same
// order, as the plain version computes them every sweep.  A sweep then
// runs, per swept column,
//
//   dp[0] = rhs[0] / denom[0],  dp[l] = (rhs[l] - lo[l] dp[l-1]) / denom[l]
//   u[L-1] = dp[L-1],           u[l] = dp[l] - cp[l] u[l+1]
//
// What bounds it on the H100: bytes, and at the small multigrid levels
// latency.  Every cell reads T and writes one value (8 bytes); a cell of
// the swept colour also reads b, seven fields and d_extra (36 bytes more,
// against about 23 flops), while a cell of the other colour only copies T.
// At 6x7x36x36 the half-sweep moves about 1.4 MB, 0.42 us at 3.35 TB/s,
// less than the chain of a column's layers: L dependent steps, each an
// IEEE division.  The design:
//
//   - The coefficient arrays are read split by colour, so a half-sweep
//     reads only the half it solves: in the natural layout the two colours
//     share every 32-byte sector, and the sweep would read all of them.
//     b, T and the output keep the natural layout (b changes every call);
//     the sweep moves about 26 bytes a cell.
//   - The pivots and forward coefficients come precomputed, so the chain
//     of a column is one division a layer (the dp recursion), not two
//     chains of them, and seven arrays are read instead of eight.
//   - One thread owns a pair of neighbouring columns (y, 2i) and
//     (y, 2i + 1): exactly one of them has the swept colour, so every
//     thread solves one column and copies the other, and no lane idles
//     through the solve (an odd NX leaves the last pair of a row one
//     column).  The threads of a warp own 64 neighbouring columns, so the
//     loads of T and b cover whole sectors of both colours, and those of
//     the split coefficients are dense.
//   - The layer count is a template parameter (1-16 behind a switch):
//     the loops unroll completely.  A first loop issues every load of
//     both columns into registers, with no arithmetic between them, so
//     they all go out before the first result is waited for; then the
//     right-hand sides and the chain run on registers.
//   - The CTA size is the largest of 128, 64 and 32 threads that still
//     gives 132 CTAs, one an SM, where the grid has that many pairs; the
//     36^2 levels of the mg replay (3,888 pairs) take 122 CTAs of 32.
//   - Deeper columns (more than MAX_LAYERS layers: a 12-high DRAM stack on
//     its logic die has 17) take rb_line_sweep_deep, whose layer count is
//     a runtime argument.  It streams the column one layer at a time: it
//     forms rhs[l] and dp[l] in the same order as the register path,
//     writes dp[l] into the output column in place, then back-substitutes
//     by reading dp[l] back from the output.  The thread that writes a
//     cell is the one that reads it back, so that needs no scratch and no
//     layer cap; the column's loads are no longer all issued before the
//     first is used, so a layer costs a load latency on the chain.
//
// The sums and the guards follow the plain PyTorch version
// (ops.rb_line_sweep_plain, after the Pallas kernel's order) and the
// build uses -fmad=false with IEEE division, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

// the register path's deepest column; deeper ones stream
#define MAX_LAYERS 16

namespace {

constexpr int kSMs = 132;

template <int L>
__global__ void __launch_bounds__(128, 1)
    rb_line_sweep(const float* __restrict__ T, const float* __restrict__ b,
                  const float* __restrict__ S, float* __restrict__ out,
                  int n_pairs, int ny, int nx, int color) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int nxh = (nx + 1) >> 1;
  const int ip = t % nxh;
  const int rest = t / nxh;
  const int iy = rest % ny;
  const int bi = rest / ny;
  const int plane = ny * nx;
  const int base = bi * L * plane;
  const int n_half = n_pairs * L;      // cells of one colour-split array
  const int hb = bi * L * ny * nxh + iy * nxh + ip;
  const int x0 = 2 * ip;
  // the pair's swept column and the one that keeps T
  const int xs = ((iy + x0) & 1) == color ? x0 : x0 + 1;
  const int xc = xs == x0 ? x0 + 1 : x0;
  const int ys = iy * nx;

  if (xc < nx) {
    float keep[L];
#pragma unroll
    for (int l = 0; l < L; ++l) keep[l] = T[base + l * plane + ys + xc];
#pragma unroll
    for (int l = 0; l < L; ++l) out[base + l * plane + ys + xc] = keep[l];
  }
  if (xs >= nx) return;

  const int yx = ys + xs;
  const int o_lf = ys + (xs > 0 ? xs - 1 : xs);
  const int o_rt = ys + (xs < nx - 1 ? xs + 1 : xs);
  const int o_up = (iy > 0 ? ys - nx : ys) + xs;
  const int o_dn = (iy < ny - 1 ? ys + nx : ys) + xs;
  const float* gx_lf = S + color * 7 * n_half;
  const float* gx_rt = gx_lf + n_half;
  const float* gy_up = gx_lf + 2 * n_half;
  const float* gy_dn = gx_lf + 3 * n_half;
  const float* lo_s = gx_lf + 4 * n_half;
  const float* den_s = gx_lf + 5 * n_half;
  const float* cp_s = gx_lf + 6 * n_half;

  // every load of the column first, into registers, then the sums: no
  // arithmetic between the loads, so they all go out before the first
  // result is waited for
  float vb[L], vl[L], vr[L], vu[L], vd[L], g0[L], g1[L], g2[L], g3[L];
  float lo[L], den[L], cp[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int off = base + l * plane;
    const int h = hb + l * ny * nxh;
    vb[l] = b[off + yx];
    vl[l] = T[off + o_lf];
    vr[l] = T[off + o_rt];
    vu[l] = T[off + o_up];
    vd[l] = T[off + o_dn];
    g0[l] = gx_lf[h];
    g1[l] = gx_rt[h];
    g2[l] = gy_up[h];
    g3[l] = gy_dn[h];
    lo[l] = lo_s[h];
    den[l] = den_s[h];
    cp[l] = cp_s[h];
  }
  float rhs[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float r = vb[l] + g0[l] * vl[l];
    r = r + g1[l] * vr[l];
    r = r + g2[l] * vu[l];
    r = r + g3[l] * vd[l];
    rhs[l] = r;
  }
  // the Thomas recursion on registers: one division a layer
  float dp[L];
  dp[0] = rhs[0] / den[0];
#pragma unroll
  for (int l = 1; l < L; ++l) dp[l] = (rhs[l] - lo[l] * dp[l - 1]) / den[l];
  float u = dp[L - 1];
  out[base + (L - 1) * plane + yx] = u;
#pragma unroll
  for (int l = L - 2; l >= 0; --l) {
    u = dp[l] - cp[l] * u;
    out[base + l * plane + yx] = u;
  }
}

// Any layer count: the column streamed one layer at a time, dp kept in the
// output column until the back-substitution reads it back.  The same sums
// in the same order as rb_line_sweep<L>, so the two agree bit for bit.
__global__ void __launch_bounds__(128, 1)
    rb_line_sweep_deep(const float* __restrict__ T,
                       const float* __restrict__ b,
                       const float* __restrict__ S, float* out, int n_pairs,
                       int L, int ny, int nx, int color) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int nxh = (nx + 1) >> 1;
  const int ip = t % nxh;
  const int rest = t / nxh;
  const int iy = rest % ny;
  const int bi = rest / ny;
  const int plane = ny * nx;
  const int hplane = ny * nxh;
  const int base = bi * L * plane;
  const int n_half = n_pairs * L;
  const int hb = bi * L * hplane + iy * nxh + ip;
  const int x0 = 2 * ip;
  const int xs = ((iy + x0) & 1) == color ? x0 : x0 + 1;
  const int xc = xs == x0 ? x0 + 1 : x0;
  const int ys = iy * nx;

  if (xc < nx)
    for (int l = 0; l < L; ++l)
      out[base + l * plane + ys + xc] = T[base + l * plane + ys + xc];
  if (xs >= nx) return;

  const int yx = ys + xs;
  const int o_lf = ys + (xs > 0 ? xs - 1 : xs);
  const int o_rt = ys + (xs < nx - 1 ? xs + 1 : xs);
  const int o_up = (iy > 0 ? ys - nx : ys) + xs;
  const int o_dn = (iy < ny - 1 ? ys + nx : ys) + xs;
  const float* gx_lf = S + color * 7 * n_half;
  const float* gx_rt = gx_lf + n_half;
  const float* gy_up = gx_lf + 2 * n_half;
  const float* gy_dn = gx_lf + 3 * n_half;
  const float* lo_s = gx_lf + 4 * n_half;
  const float* den_s = gx_lf + 5 * n_half;
  const float* cp_s = gx_lf + 6 * n_half;

  float dp = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int off = base + l * plane;
    const int h = hb + l * hplane;
    float r = b[off + yx] + gx_lf[h] * T[off + o_lf];
    r = r + gx_rt[h] * T[off + o_rt];
    r = r + gy_up[h] * T[off + o_up];
    r = r + gy_dn[h] * T[off + o_dn];
    dp = l == 0 ? r / den_s[h] : (r - lo_s[h] * dp) / den_s[h];
    out[off + yx] = dp;
  }
  float u = dp;
  for (int l = L - 2; l >= 0; --l) {
    const int off = base + l * plane;
    u = out[off + yx] - cp_s[hb + l * hplane] * u;
    out[off + yx] = u;
  }
}

}  // namespace

// One half-sweep of colour `color` from T into out; S holds the
// coefficients split by colour.  Indices are 32-bit: the wrapper keeps the
// size of S below 2^31.
extern "C" int mg_rb_line_sweep(const void* T, const void* b, const void* S,
                                void* out, int n_batch, int n_layers, int ny,
                                int nx, int color, void* stream) {
  if (n_layers < 1) return (int)cudaErrorInvalidValue;
  const int n_pairs = n_batch * ny * ((nx + 1) / 2);
  int threads = 128;
  while (threads > 32 && (n_pairs + threads - 1) / threads < kSMs)
    threads /= 2;
  const unsigned blocks = (unsigned)((n_pairs + threads - 1) / threads);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)T;
  const float* bb = (const float*)b;
  const float* sp = (const float*)S;
  float* o = (float*)out;
#define MG_L(N)                                                             \
  case N:                                                                   \
    rb_line_sweep<N><<<blocks, threads, 0, s>>>(t, bb, sp, o, n_pairs, ny,  \
                                                nx, color);                 \
    break;
  switch (n_layers) {
    MG_L(1) MG_L(2) MG_L(3) MG_L(4) MG_L(5) MG_L(6) MG_L(7) MG_L(8)
    MG_L(9) MG_L(10) MG_L(11) MG_L(12) MG_L(13) MG_L(14) MG_L(15) MG_L(16)
    default:
      rb_line_sweep_deep<<<blocks, threads, 0, s>>>(t, bb, sp, o, n_pairs,
                                                    n_layers, ny, nx, color);
  }
#undef MG_L
  return (int)cudaGetLastError();
}
