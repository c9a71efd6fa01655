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
// What bounds it on the H100: bytes.  Every cell reads T and writes one
// value (8 bytes); a cell of the swept colour also reads b, seven fields
// and d_extra (36 bytes more, against about 23 flops), while a cell of the
// other colour only copies T.  Half the cells are swept, so the half-sweep
// needs about 26 bytes a cell.  The design moves nothing more: one thread
// owns one (b, y, x) column and walks its L <= MAX_LAYERS layers; the
// Thomas coefficients of the forward pass stay in registers (the loops
// unroll to the compile-time cap, so every index is a constant), and the
// four lateral neighbours are clamped loads that adjacent threads share
// through L1/L2.  Threads of a warp own adjacent x, so every load and the
// store are coalesced.
//
// The sums and the guards follow the plain PyTorch version
// (ops.rb_line_sweep_plain, after the Pallas kernel's order) and the
// build uses -fmad=false with IEEE division, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16

namespace {

__global__ void rb_line_sweep(const float* __restrict__ T,
                              const float* __restrict__ b,
                              const float* __restrict__ gx_lf,
                              const float* __restrict__ gx_rt,
                              const float* __restrict__ gy_up,
                              const float* __restrict__ gy_dn,
                              const float* __restrict__ gz_up,
                              const float* __restrict__ gz_dn,
                              const float* __restrict__ g_pkg,
                              const float* __restrict__ d_extra,
                              float* __restrict__ out, int n_batch,
                              int n_layers, int ny, int nx, int color) {
  const long long plane = (long long)ny * nx;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (long long)n_batch * plane) return;
  const long long bi = col / plane;
  const long long yx = col - bi * plane;
  const int iy = (int)(yx / nx);
  const int ix = (int)(yx - (long long)iy * nx);
  const long long base = bi * n_layers * plane;

  if (((iy + ix) & 1) != color) {      // the other colour keeps T
    for (int l = 0; l < n_layers; ++l) {
      const long long i = base + (long long)l * plane + yx;
      out[i] = T[i];
    }
    return;
  }

  const long long o_lf = (long long)iy * nx + (ix > 0 ? ix - 1 : ix);
  const long long o_rt = (long long)iy * nx + (ix < nx - 1 ? ix + 1 : ix);
  const long long o_up = (long long)(iy > 0 ? iy - 1 : iy) * nx + ix;
  const long long o_dn = (long long)(iy < ny - 1 ? iy + 1 : iy) * nx + ix;

  float cp[MAX_LAYERS], dp[MAX_LAYERS];
#pragma unroll
  for (int l = 0; l < MAX_LAYERS; ++l) {
    if (l < n_layers) {
      const long long off = base + (long long)l * plane;
      const long long i = off + yx;
      const float gxl = gx_lf[i], gxr = gx_rt[i];
      const float gyu = gy_up[i], gyd = gy_dn[i];
      const float gzu = gz_up[i], gzd = gz_dn[i];
      float rhs = b[i] + gxl * T[off + o_lf];
      rhs = rhs + gxr * T[off + o_rt];
      rhs = rhs + gyu * T[off + o_up];
      rhs = rhs + gyd * T[off + o_dn];
      float diag = gxl + gxr;
      diag = diag + gyu;
      diag = diag + gyd;
      diag = diag + gzu;
      diag = diag + gzd;
      diag = diag + g_pkg[i];
      diag = diag + d_extra[i];
      diag = diag > 0.0f ? diag : 1.0f;
      const float lo = -gzu;           // coupling to layer l-1 (0 at l = 0)
      const float up = -gzd;           // coupling to layer l+1 (0 at L-1)
      if (l == 0) {
        cp[0] = up / diag;
        dp[0] = rhs / diag;
      } else {
        float denom = diag - lo * cp[l - 1];
        denom = fabsf(denom) > 0.0f ? denom : 1.0f;
        cp[l] = up / denom;
        dp[l] = (rhs - lo * dp[l - 1]) / denom;
      }
    }
  }
  float u = 0.0f;
#pragma unroll
  for (int l = MAX_LAYERS - 1; l >= 0; --l) {
    if (l < n_layers) {
      u = (l == n_layers - 1) ? dp[l] : dp[l] - cp[l] * u;
      out[base + (long long)l * plane + yx] = u;
    }
  }
}

}  // namespace

extern "C" int mg_rb_line_sweep(const void* T, const void* b,
                                const void* gx_lf, const void* gx_rt,
                                const void* gy_up, const void* gy_dn,
                                const void* gz_up, const void* gz_dn,
                                const void* g_pkg, const void* d_extra,
                                void* out, int n_batch, int n_layers, int ny,
                                int nx, int color, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const long long n_cols = (long long)n_batch * ny * nx;
  const int threads = 256;
  const long long blocks = (n_cols + threads - 1) / threads;
  rb_line_sweep<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)b, (const float*)gx_lf,
      (const float*)gx_rt, (const float*)gy_up, (const float*)gy_dn,
      (const float*)gz_up, (const float*)gz_dn, (const float*)g_pkg,
      (const float*)d_extra, (float*)out, n_batch, n_layers, ny, nx, color);
  return (int)cudaGetLastError();
}
