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
// each).  Both sit far below the card's flop/byte balance.  At the
// replay's shape (6 cases x 7 x 36 x 36, 54,432 cells, 1.96 MB: 0.58 us of
// bytes) a launch is short enough that what also bounds it is how much
// independent work the card is given at once.
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
// so a launch passes one pointer for them.  Fusing the PCG dot products
// into this pass is later work.
//
// stencil_uniform (5 x 384 x 384 on the legacy transient: 737,280 cells,
// 5.90 MB, 1.76 us of bytes) gives a CTA of 32 x 8 threads to a tile of
// one layer plane, the plane from the grid's z index (b * L + l), so no
// thread divides to find its cell, and every index is 32-bit (the wrapper
// refuses 2^31 cells or more).  A thread takes four x-adjacent cells: five
// 16-byte loads (the cells and their rows above, below, the layers above
// and below) and two scalar loads (the left and right neighbours), all
// issued before the arithmetic, then one 16-byte store; where NX is not a
// multiple of 4 (or a pointer is not 16-byte aligned) a thread takes one
// cell.  The layer's four coefficients come from one [4, L] pack
// (ops.LayerVectors, built once a solve), four loads the same for every
// thread of the CTA.  A thread a column, the layer count a template
// parameter so that every load of the column issued before the
// arithmetic, was measured too and was slower at 5 x 384 x 384 (the
// x-adjacent cells share their loads; a column's threads did not).
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

// Per-layer coefficients of layer l from the [4, L] pack (g_lat, gv_up,
// gv_dn, g_pkg), the same for every thread of a CTA.
struct LayerCoef {
  float lat, up, dn, pkg;
};

__device__ __forceinline__ LayerCoef layer_coef(const float* __restrict__ V,
                                                int n_layers, int l) {
  return LayerCoef{__ldg(V + l), __ldg(V + n_layers + l),
                   __ldg(V + 2 * n_layers + l), __ldg(V + 3 * n_layers + l)};
}

// One cell in the plain version's order of terms.
__device__ __forceinline__ float uniform_cell(const LayerCoef& g, float t,
                                              float t_up, float t_dn,
                                              float t_lf, float t_rt,
                                              float t_above, float t_below) {
  float lap = 4.0f * t - t_up;
  lap = lap - t_dn;
  lap = lap - t_lf;
  lap = lap - t_rt;
  float acc = g.lat * lap;
  acc = acc + g.up * (t - t_above);
  acc = acc + g.dn * (t - t_below);
  acc = acc + g.pkg * t;
  return acc;
}

template <int VEC>
__device__ __forceinline__ void load_cells(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
  }
}

// A CTA of 32 x 8 threads over one layer plane (blockIdx.z = b * L + l),
// a thread VEC x-adjacent cells of one row.
template <int VEC>
__global__ void __launch_bounds__(256)
    stencil_uniform(const float* __restrict__ T,
                          const float* __restrict__ V, float* __restrict__ y,
                          int n_layers, int ny, int nx) {
  const int ix = (blockIdx.x * 32 + threadIdx.x) * VEC;
  const int iy = blockIdx.y * 8 + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const int bl = blockIdx.z;
  const int l = bl % n_layers;
  const int plane = ny * nx;
  const int i = bl * plane + iy * nx + ix;
  const LayerCoef g = layer_coef(V, n_layers, l);
  float c[VEC], up[VEC], dn[VEC], ab[VEC], be[VEC];
  load_cells<VEC>(T + i, c);
  load_cells<VEC>(T + (iy > 0 ? i - nx : i), up);
  load_cells<VEC>(T + (iy < ny - 1 ? i + nx : i), dn);
  load_cells<VEC>(T + (l > 0 ? i - plane : i), ab);
  load_cells<VEC>(T + (l < n_layers - 1 ? i + plane : i), be);
  const float lf = T[ix > 0 ? i - 1 : i];
  const float rt = T[ix + VEC < nx ? i + VEC : i + VEC - 1];
  float out[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    out[k] = uniform_cell(g, c[k], up[k], dn[k], k == 0 ? lf : c[k - 1],
                          k == VEC - 1 ? rt : c[k + 1], ab[k], be[k]);
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(y + i) = make_float4(out[0], out[1], out[2],
                                                    out[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[i + k] = out[k];
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

// y = G T of the uniform stencil for T [B, L, NY, NX] (B * L * NY * NX <
// 2^31, B * L <= 65535, NY <= 8 * 65535); V is the [4, L] pack (g_lat,
// gv_up, gv_dn, g_pkg).  A thread takes 4 x-adjacent cells (16-byte loads
// and stores) where NX is a multiple of 4 and T and y are 16-byte
// aligned, else one.
extern "C" int thermal_stencil_uniform(const void* T, const void* V, void* y,
                                       int n_batch, int n_layers, int ny,
                                       int nx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)T;
  const float* v = (const float*)V;
  float* out = (float*)y;
  const bool vec = nx % 4 == 0 && ((uintptr_t)T | (uintptr_t)y) % 16 == 0;
  const int per_cta = vec ? 128 : 32;
  const dim3 grid((unsigned)((nx + per_cta - 1) / per_cta),
                  (unsigned)((ny + 7) / 8), (unsigned)(n_batch * n_layers));
  if (vec)
    stencil_uniform<4><<<grid, dim3(32, 8), 0, s>>>(t, v, out, n_layers, ny,
                                                    nx);
  else
    stencil_uniform<1><<<grid, dim3(32, 8), 0, s>>>(t, v, out, n_layers, ny,
                                                    nx);
  return (int)cudaGetLastError();
}
