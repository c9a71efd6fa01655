// Thermal stencils  y = G T  for Hopper (sm_90a): the face-conductance
// form and the legacy uniform-per-layer form.
//
// stencil_fields replaces the TPU kernel apply_operator_fields_kernel
// (body _field_kernel) in src/repro/kernels/thermal_stencil/kernel.py.
// Per cell of an [L, NY, NX] grid (optionally batched [B, L, NY, NX]):
//
//   y = gx_lf (T - T_left)  + gx_rt (T - T_right)
//     + gy_up (T - T_up)    + gy_dn (T - T_down)
//     + gz_up (T - T_above) + gz_dn (T - T_below) + g_pkg T
//
// stencil_uniform replaces the TPU kernel apply_operator_kernel (body
// _stencil_kernel) in the same file.  Per cell, with four per-layer
// vectors in place of the seven fields:
//
//   y = g_lat (4 T - T_up - T_down - T_left - T_right)
//     + gv_up (T - T_above) + gv_dn (T - T_below) + g_pkg T
//
// Neighbours past an edge are the cell itself (adiabatic: zero
// difference); a zero face conductance is a void face.
//
// What bounds them on the H100: bytes.  A fields cell reads T and seven
// fields and writes y, 36 bytes against 19 flops; a uniform cell reads T
// and writes y, 8 bytes against 12 flops (its four vectors are L floats
// each, read once per column from L1).  Both sit far below the card's
// flop/byte balance.  At the replay's shape (6 cases x 7 x 36 x 36, 54,432
// cells, 1.96 MB: 0.58 us of bytes) a launch is short enough that what
// also bounds it is how much independent work the card is given at once.
//
// stencil_fields gives one thread to each cell (b, l, y, x): 54,432
// threads at the replay's shape, where one thread a column gave 7,776
// threads over 132 SMs that each walked 7 layers one after the other.  A
// thread issues its fourteen loads (seven fields, T and its six
// neighbours) together and waits for memory once.  The neighbours are
// clamped-index loads of words that adjacent threads also read, so L1/L2
// serve them and device memory sees each input about once; a shared-memory
// halo tile would save no device traffic.  Threads of a warp own adjacent
// x, so every load and the store are coalesced.  The seven fields come as
// one contiguous pack [7, ...] (ops.FieldPack, built once per operator),
// so a launch passes one pointer for them.  stencil_uniform keeps one
// thread a column.  Fusing the PCG dot products into this pass is later
// work.
//
// The terms are summed in the reference's order and the build uses
// -fmad=false, so each result equals its plain PyTorch version
// (ops.apply_operator_fields_plain, ops.apply_operator_plain) bit for bit
// on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stencil_fields(const float* __restrict__ T,
                               const float* __restrict__ F,
                               float* __restrict__ y, int n_cells,
                               int n_layers, int ny, int nx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int plane = ny * nx;
  const int ix = i % nx;
  const int row = i / nx;            // (b * L + l) * ny + iy
  const int iy = row % ny;
  const int l = (row / ny) % n_layers;
  // neighbours past an edge are the cell itself (edge replication)
  const float t = T[i];
  const float t_lf = T[ix > 0 ? i - 1 : i];
  const float t_rt = T[ix < nx - 1 ? i + 1 : i];
  const float t_up = T[iy > 0 ? i - nx : i];
  const float t_dn = T[iy < ny - 1 ? i + nx : i];
  const float t_above = T[l > 0 ? i - plane : i];
  const float t_below = T[l < n_layers - 1 ? i + plane : i];
  const float* f = F + i;            // field k of cell i is f[k * n_cells]
  float acc = f[0] * (t - t_lf);
  acc = acc + f[n_cells] * (t - t_rt);
  acc = acc + f[2 * n_cells] * (t - t_up);
  acc = acc + f[3 * n_cells] * (t - t_dn);
  acc = acc + f[4 * n_cells] * (t - t_above);
  acc = acc + f[5 * n_cells] * (t - t_below);
  acc = acc + f[6 * n_cells] * t;
  y[i] = acc;
}

__global__ void stencil_uniform(const float* __restrict__ T,
                                const float* __restrict__ g_lat,
                                const float* __restrict__ gv_up,
                                const float* __restrict__ gv_dn,
                                const float* __restrict__ g_pkg,
                                float* __restrict__ y, int n_batch,
                                int n_layers, int ny, int nx) {
  const long long plane = (long long)ny * nx;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (long long)n_batch * plane) return;
  const long long b = col / plane;
  const long long yx = col - b * plane;
  const int iy = (int)(yx / nx);
  const int ix = (int)(yx - (long long)iy * nx);
  const long long o_lf = (long long)iy * nx + (ix > 0 ? ix - 1 : ix);
  const long long o_rt = (long long)iy * nx + (ix < nx - 1 ? ix + 1 : ix);
  const long long o_up = (long long)(iy > 0 ? iy - 1 : iy) * nx + ix;
  const long long o_dn = (long long)(iy < ny - 1 ? iy + 1 : iy) * nx + ix;

  const long long base = b * n_layers * plane;
  float t_above = T[base + yx];   // layer -1 replicates layer 0
  float t = t_above;
  for (int l = 0; l < n_layers; ++l) {
    const long long off = base + (long long)l * plane;
    const long long i = off + yx;
    const float t_below = (l + 1 < n_layers) ? T[i + plane] : t;
    float lap = 4.0f * t - T[off + o_up];
    lap = lap - T[off + o_dn];
    lap = lap - T[off + o_lf];
    lap = lap - T[off + o_rt];
    float acc = g_lat[l] * lap;
    acc = acc + gv_up[l] * (t - t_above);
    acc = acc + gv_dn[l] * (t - t_below);
    acc = acc + g_pkg[l] * t;
    y[i] = acc;
    t_above = t;
    t = t_below;
  }
}

}  // namespace

// y = G T for n_cells = B * L * NY * NX cells (7 * n_cells < 2^31); F is
// the [7, B, L, NY, NX] field pack in ops.FIELD_KEYS order.
extern "C" int thermal_stencil_fields(const void* T, const void* F, void* y,
                                      int n_cells, int n_layers, int ny,
                                      int nx, void* stream) {
  const int threads = 256;
  stencil_fields<<<(n_cells + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>((const float*)T, (const float*)F,
                                           (float*)y, n_cells, n_layers, ny,
                                           nx);
  return (int)cudaGetLastError();
}

extern "C" int thermal_stencil_uniform(const void* T, const void* g_lat,
                                       const void* gv_up, const void* gv_dn,
                                       const void* g_pkg, void* y,
                                       int n_batch, int n_layers, int ny,
                                       int nx, void* stream) {
  const long long n_cols = (long long)n_batch * ny * nx;
  const int threads = 256;
  const long long blocks = (n_cols + threads - 1) / threads;
  stencil_uniform<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)g_lat, (const float*)gv_up,
      (const float*)gv_dn, (const float*)g_pkg, (float*)y, n_batch,
      n_layers, ny, nx);
  return (int)cudaGetLastError();
}
