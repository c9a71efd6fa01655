// AP pass schedule (compare + tagged write) over packed bit planes, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel run_schedule_kernel (body _pass_kernel) in
// src/repro/kernels/ap_match/kernel.py.  planes is [n_bits, n_lanes] of
// 32-bit words (32 AP words per lane, one bit column per row).  For each
// pass p, in order:
//
//   TAG        = AND_k ~(planes[cc[p,k]] ^ bcast(ck[p,k]))
//   matched[p] = popcount(TAG) summed over all lanes
//   for k in order: planes[wc[p,k]] = (planes[wc[p,k]] & ~TAG)
//                                     | (bcast(wk[p,k]) & TAG)
//
// bcast(key) = 0 - key, the reference's key * 0xFFFFFFFF.  The write is a
// sequential read-modify-write per k, as _pass_kernel does, so repeated
// (column, key) padding entries are harmless.
//
// What bounds it on the H100: bytes.  A pass moves Kc + 2 Kw words per
// lane for about 3 (Kc + Kw) integer operations.  Lanes never interact,
// so one thread owns one lane for the whole schedule: its columns stay in
// L1/L2 across the P passes instead of one device-memory round trip per
// pass, and threads of a warp own adjacent lanes, so every access is
// coalesced.  The schedule tables are read by all threads at the same
// address (broadcast, cached).  matched[p] is counted with __popc, a warp
// reduction (__reduce_add_sync), an integer atomic into a shared [P]
// array and one global atomic per block and pass; integer atomics are
// order-free, so the counts are exact.  Lanes past n_lanes take part in
// the warp reduction with an empty tag and touch no memory, so any
// n_lanes works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void run_schedule(uint32_t* __restrict__ planes, int n_lanes,
                             const int32_t* __restrict__ cc,
                             const int32_t* __restrict__ ck,
                             const int32_t* __restrict__ wc,
                             const int32_t* __restrict__ wk, int n_passes,
                             int kc, int kw, int32_t* __restrict__ matched) {
  extern __shared__ int32_t s_matched[];
  for (int p = threadIdx.x; p < n_passes; p += blockDim.x) s_matched[p] = 0;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  for (int p = 0; p < n_passes; ++p) {
    uint32_t tag = 0u;
    if (active) {
      tag = 0xFFFFFFFFu;
      for (int k = 0; k < kc; ++k) {
        const long long c = cc[(long long)p * kc + k];
        const uint32_t key = 0u - (uint32_t)ck[(long long)p * kc + k];
        tag &= ~(planes[c * n_lanes + lane] ^ key);
      }
    }
    const int cnt = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(tag));
    if ((threadIdx.x & 31) == 0 && cnt != 0) atomicAdd(&s_matched[p], cnt);
    if (tag != 0u) {  // an empty tag writes nothing
      for (int k = 0; k < kw; ++k) {
        const long long c = wc[(long long)p * kw + k];
        const uint32_t key = 0u - (uint32_t)wk[(long long)p * kw + k];
        uint32_t* cell = planes + c * n_lanes + lane;
        *cell = (*cell & ~tag) | (key & tag);
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_passes; p += blockDim.x)
    if (s_matched[p] != 0) atomicAdd(&matched[p], s_matched[p]);
}

}  // namespace

// Largest schedule one launch takes: its [P] counts live in shared memory.
extern "C" int ap_match_max_passes() { return 232448 / 4; }

// Runs the schedule in place on planes; matched must hold P zeros.
extern "C" int ap_match_run_schedule(void* planes, int n_bits, int n_lanes,
                                     const void* cc, const void* ck,
                                     const void* wc, const void* wk,
                                     int n_passes, int kc, int kw,
                                     void* matched, void* stream) {
  (void)n_bits;
  const size_t smem = (size_t)n_passes * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        run_schedule, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  run_schedule<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (uint32_t*)planes, n_lanes, (const int32_t*)cc, (const int32_t*)ck,
      (const int32_t*)wc, (const int32_t*)wk, n_passes, kc, kw,
      (int32_t*)matched);
  return (int)cudaGetLastError();
}
