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
// bcast(key) = 0 - key, the reference's key * 0xFFFFFFFF.  The output is
// written to a second buffer; the input planes are only read.
//
// What bounds it on the H100: latency, not bytes.  A pass reads what the
// pass before it wrote, so the P passes form one dependent chain per lane
// word, and a lane word holds a few dozen bytes in all.  The least time is
//
//   t >= P * (t_rmw + (1 + ceil(log2 Kc)) * t_alu) / f_sm
//        + bytes / 3.35 TB/s
//
// where t_rmw is one shared-memory load -> one ALU op -> store -> the next
// load of the same word (the write, and the next pass's compare of what it
// wrote), the extra ALU ops are the XOR and the OR tree of the Kc compare
// terms, f_sm is the SM clock and bytes = 2 * n_bits * n_lanes * 4 plus
// the tables.  ap_match_probe measures t_rmw, t_alu and f_sm on the card
// (chip_smoke.py phase 3 prints them and the bound).
//
// The design (run_schedule_smem) keeps the chain in shared memory, the
// reference's VMEM-resident loop interchange: each CTA copies its tile of
// planes, rows col_lo..col_hi of its 32 * warps lanes, into shared memory
// once (cp.async), runs every pass there and writes the tile back once;
// rows outside the tables' column range are copied straight through.  A
// thread owns one lane word, so passes need no barrier.
//
//   - The schedule tables are staged into shared memory by cp.async, in
//     chunks of up to kMaxChunk passes, and decoded once into one record a
//     pass: byte offsets of its rows in a thread's column and broadcast
//     keys, read as 16-byte vectors two passes ahead, so no table read and
//     no address arithmetic but one add sits on the chain.
//   - In a pass a thread loads every compare and write row, builds
//     x = OR_k (row_k ^ key_k) as a tree, then stores each write row as
//     (row & x) | (key & ~x) in k order: a column written twice in a pass
//     ends with its last key, as the sequential read-modify-write does,
//     since (row & x) is the same for every write of that row.
//   - TAG = ~x goes to a shared window of kTagWindow passes, off the
//     chain; after each window the CTA counts it (__popc over its lanes
//     below n_lanes) and adds one integer atomic a pass to matched, so
//     the counts are exact.
//   - Kc and Kw are template parameters (powers of two up to 16; a smaller
//     count repeats its last entry, which is harmless for compares and for
//     writes).
//
// run_schedule_global is the second path, chosen by shape where the first
// cannot run: a tile of one warp's lanes that does not fit in shared memory
// beside its TAG window and one pass of tables, Kc or Kw above 16, or a
// pass with no compare or no write column.  It runs the same passes on the
// output in device memory (L1/L2), one thread per lane word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemBytes = 232448;    // opt-in shared memory of one CTA
constexpr int kMaxWarps = 4;
constexpr int kMaxChunk = 1024;
constexpr int kTagWindow = 64;        // passes of TAGs held before counting
constexpr int kTagStride = kTagWindow + 1;   // odd: no bank conflicts
constexpr int kMaxK = 16;
constexpr int kGlobalThreads = 128;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Words of one pass's decoded record: KC compare offsets, KW write
// offsets, then their KC + KW keys, padded to whole 16-byte vectors.
__host__ __device__ constexpr int record_words(int KC, int KW) {
  return (2 * (KC + KW) + 3) / 4 * 4;
}

template <int KC, int KW>
struct Record {
  static constexpr int kWords = record_words(KC, KW);
  static constexpr int kVecs = kWords / 4;
};

template <int KC, int KW>
__global__ void __launch_bounds__(32 * kMaxWarps)
    run_schedule_smem(const uint32_t* __restrict__ planes,
                      uint32_t* __restrict__ out, int n_bits, int n_lanes,
                      int col_lo, int rows, const int32_t* __restrict__ cc,
                      const int32_t* __restrict__ ck,
                      const int32_t* __restrict__ wc,
                      const int32_t* __restrict__ wk, int n_passes, int kc,
                      int kw, int chunk, int32_t* __restrict__ matched) {
  using Rec = Record<KC, KW>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  uint4* rec = (uint4*)smem;                               // [chunk][kVecs]
  uint32_t* tile = smem + (size_t)chunk * Rec::kWords;     // [rows][W]
  uint32_t* tags = tile + (size_t)rows * W;        // [W][kTagStride]
  int32_t* t_cc = (int32_t*)(tags + (size_t)W * kTagStride);
  int32_t* t_ck = t_cc + chunk * kc;                       // [chunk][kc]
  int32_t* t_wc = t_ck + chunk * kc;                       // [chunk][kw]
  int32_t* t_wk = t_wc + chunk * kw;

  const int lane0 = blockIdx.x * W;
  const int lane = lane0 + tid;
  const bool active = lane < n_lanes;
  const int n_live = min(W, n_lanes - lane0);   // lanes of this CTA
  if (active) {
    for (int r = 0; r < rows; ++r)
      cp_async4(&tile[r * W + tid],
                &planes[(size_t)(col_lo + r) * n_lanes + lane]);
    for (int r = 0; r < col_lo; ++r)
      out[(size_t)r * n_lanes + lane] = planes[(size_t)r * n_lanes + lane];
    for (int r = col_lo + rows; r < n_bits; ++r)
      out[(size_t)r * n_lanes + lane] = planes[(size_t)r * n_lanes + lane];
  } else {
    for (int r = 0; r < rows; ++r) tile[r * W + tid] = 0u;
  }
  // this thread's column of the tile, addressed in bytes by the records,
  // and its row of TAGs
  char* my = (char*)(tile + tid);
  uint32_t* my_tags = tags + (size_t)tid * kTagStride;

  for (int c0 = 0; c0 < n_passes; c0 += chunk) {
    const int cn = min(chunk, n_passes - c0);
    __syncthreads();   // the previous chunk's records are read
    for (int i = tid; i < cn * kc; i += W) {
      cp_async4(&t_cc[i], &cc[(size_t)c0 * kc + i]);
      cp_async4(&t_ck[i], &ck[(size_t)c0 * kc + i]);
    }
    for (int i = tid; i < cn * kw; i += W) {
      cp_async4(&t_wc[i], &wc[(size_t)c0 * kw + i]);
      cp_async4(&t_wk[i], &wk[(size_t)c0 * kw + i]);
    }
    cp_async_wait_all();
    __syncthreads();
    // decode each pass once: byte offsets of its rows in a thread's
    // column and broadcast keys; entry k >= kc (kw) repeats the last one
    for (int p = tid; p < cn; p += W) {
      uint32_t* r = (uint32_t*)(rec + (size_t)p * Rec::kVecs);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int e = p * kc + min(k, kc - 1);
        r[k] = (uint32_t)(t_cc[e] - col_lo) * (uint32_t)W * 4u;
        r[KC + KW + k] = 0u - (uint32_t)t_ck[e];
      }
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const int e = p * kw + min(k, kw - 1);
        r[KC + k] = (uint32_t)(t_wc[e] - col_lo) * (uint32_t)W * 4u;
        r[2 * KC + KW + k] = 0u - (uint32_t)t_wk[e];
      }
    }
    __syncthreads();

    // records of the current pass and the two after it: a pass's record
    // is read two passes ahead, so no table read sits on the chain
    uint4 cur[Rec::kVecs], nx1[Rec::kVecs], nx2[Rec::kVecs];
#pragma unroll
    for (int v = 0; v < Rec::kVecs; ++v) {
      cur[v] = rec[v];
      nx1[v] = rec[min(1, cn - 1) * Rec::kVecs + v];
    }
    for (int w0 = 0; w0 < cn; w0 += kTagWindow) {
      const int wn = min(kTagWindow, cn - w0);
#pragma unroll 2
      for (int i = 0; i < wn; ++i) {
        const int p = w0 + i;
        const uint32_t* e = (const uint32_t*)cur;
        uint32_t cv[KC], wv[KW];
#pragma unroll
        for (int k = 0; k < KC; ++k) cv[k] = *(const uint32_t*)(my + e[k]);
#pragma unroll
        for (int k = 0; k < KW; ++k)
          wv[k] = *(const uint32_t*)(my + e[KC + k]);
        const int q = min(p + 2, cn - 1);
#pragma unroll
        for (int v = 0; v < Rec::kVecs; ++v) nx2[v] = rec[q * Rec::kVecs + v];
        // x = OR_k (row_k ^ key_k), a tree; TAG = ~x
        uint32_t x[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) x[k] = cv[k] ^ e[KC + KW + k];
#pragma unroll
        for (int s = 1; s < KC; s <<= 1)
#pragma unroll
          for (int k = 0; k + s < KC; k += 2 * s) x[k] |= x[k + s];
        // tagged words take the key: (row & x) | (key & ~x); the columns
        // of lanes past n_lanes are never written back nor counted
#pragma unroll
        for (int k = 0; k < KW; ++k)
          *(uint32_t*)(my + e[KC + k]) =
              (wv[k] & x[0]) | (e[2 * KC + KW + k] & ~x[0]);
        my_tags[i] = ~x[0];   // counted after the window
#pragma unroll
        for (int v = 0; v < Rec::kVecs; ++v) {
          cur[v] = nx1[v];
          nx1[v] = nx2[v];
        }
      }
      __syncthreads();
      // matched[p] += popcount of pass p's TAGs over the CTA's lanes
      for (int i = tid; i < wn; i += W) {
        int n = 0;
        for (int j = 0; j < n_live; ++j)
          n += __popc(tags[(size_t)j * kTagStride + i]);
        if (n != 0) atomicAdd(&matched[c0 + w0 + i], n);
      }
      __syncthreads();
    }
  }

  if (active)
    for (int r = 0; r < rows; ++r)
      out[(size_t)(col_lo + r) * n_lanes + lane] = tile[r * W + tid];
}

__global__ void run_schedule_global(const uint32_t* __restrict__ planes,
                                    uint32_t* __restrict__ out, int n_bits,
                                    int n_lanes,
                                    const int32_t* __restrict__ cc,
                                    const int32_t* __restrict__ ck,
                                    const int32_t* __restrict__ wc,
                                    const int32_t* __restrict__ wk,
                                    int n_passes, int kc, int kw,
                                    int32_t* __restrict__ matched) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  if (active)
    for (int r = 0; r < n_bits; ++r)
      out[(size_t)r * n_lanes + lane] = planes[(size_t)r * n_lanes + lane];
  for (int p = 0; p < n_passes; ++p) {
    uint32_t tag = 0u;
    if (active) {
      tag = 0xFFFFFFFFu;
      for (int k = 0; k < kc; ++k) {
        const size_t c = (size_t)cc[(size_t)p * kc + k];
        const uint32_t key = 0u - (uint32_t)ck[(size_t)p * kc + k];
        tag &= ~(out[c * n_lanes + lane] ^ key);
      }
    }
    const int cnt = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(tag));
    if ((threadIdx.x & 31) == 0 && cnt != 0) atomicAdd(&matched[p], cnt);
    if (tag != 0u) {  // an empty tag writes nothing
      for (int k = 0; k < kw; ++k) {
        const size_t c = (size_t)wc[(size_t)p * kw + k];
        const uint32_t key = 0u - (uint32_t)wk[(size_t)p * kw + k];
        uint32_t* cell = out + c * n_lanes + lane;
        *cell = (*cell & ~tag) | (key & tag);
      }
    }
  }
}

// ---------------------------------------------------------------------
// shared-memory latency probe: one thread, clock64 around dependent chains
// ---------------------------------------------------------------------

__global__ void latency_probe(long long* __restrict__ out, int iters) {
  __shared__ uint32_t ring[256];
  if (threadIdx.x != 0) return;
  const unsigned base = (unsigned)__cvta_generic_to_shared(ring);
  for (int i = 0; i < 256; ++i)   // a chase over every word, stride 97
    ring[i] = base + 4u * (unsigned)((i + 97) & 255);
  asm volatile("" ::: "memory");
  unsigned a = base;
  // (0) load-to-use: a = *a, sixteen to an iteration
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("ld.volatile.shared.u32 %0, [%0];" : "+r"(a));
  }
  long long t1 = clock64();
  // (1) dependent 32-bit logic ops (the LOP3 of XNOR, AND and the write)
  unsigned x = a, m1 = a | 0x9E3779B9u, m2 = a ^ 0x85EBCA6Bu;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                   : "+r"(x) : "r"(m1), "r"(m2));
  }
  long long t2 = clock64();
  // (2) read-modify-write of one word: load -> op -> store -> next load
  const unsigned cell = base + 4u * (x & 255u);
  unsigned v = 0u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "ld.volatile.shared.u32 %0, [%1];\n\t"
          "lop3.b32 %0, %0, %2, %3, 0x96;\n\t"
          "st.volatile.shared.u32 [%1], %0;"
          : "=&r"(v) : "r"(cell), "r"(m1), "r"(m2) : "memory");
  }
  long long t3 = clock64();
  // (3) the SM clock: cycles against the global nanosecond timer
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  unsigned y = v;
  for (int i = 0; i < 64 * iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                   : "+r"(y) : "r"(m1), "r"(m2));
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = t1 - t0;
  out[1] = t2 - t1;
  out[2] = t3 - t2;
  out[3] = c1 - c0;
  out[4] = (long long)(g1 - g0);
  out[5] = (long long)(a ^ x ^ y);   // keeps every chain live
}

int pow2_at_least(int k) {
  int b = 1;
  while (b < k) b <<= 1;
  return b;
}

// Shared-memory layout of the first path: one chunk of decoded records,
// the tile of `rows` x W words, a window of TAGs ([W][kTagStride]), then
// the chunk's raw tables.
size_t smem_bytes(int rows, int W, int chunk, int kc, int kw) {
  return 4 * ((size_t)rows * W + (size_t)W * kTagStride
              + (size_t)chunk * (record_words(pow2_at_least(kc),
                                              pow2_at_least(kw))
                                 + 2 * kc + 2 * kw));
}

// The first path's launch shape for a schedule: warps a CTA and passes a
// table chunk; false where only the second path can run it.
bool plan_smem(int n_lanes, int rows, int n_passes, int kc, int kw,
               int* warps, int* chunk) {
  if (kc < 1 || kw < 1 || kc > kMaxK || kw > kMaxK) return false;
  int w = (n_lanes + 31) / 32;
  if (w > kMaxWarps) w = kMaxWarps;
  if (w < 1) w = 1;
  for (; w >= 1; --w) {
    const size_t base = smem_bytes(rows, 32 * w, 0, kc, kw);
    const size_t per_pass = smem_bytes(0, 32 * w, 1, kc, kw)
                            - smem_bytes(0, 32 * w, 0, kc, kw);
    if (base + per_pass > (size_t)kSmemBytes) continue;
    size_t c = ((size_t)kSmemBytes - base) / per_pass;
    if (c > (size_t)kMaxChunk) c = kMaxChunk;
    if (c > (size_t)n_passes) c = n_passes;
    if (c < 1) c = 1;
    *warps = w;
    *chunk = (int)c;
    return true;
  }
  return false;
}

template <int KC, int KW>
cudaError_t launch_smem(const uint32_t* planes, uint32_t* out, int n_bits,
                        int n_lanes, int col_lo, int rows, const int32_t* cc,
                        const int32_t* ck, const int32_t* wc,
                        const int32_t* wk, int n_passes, int kc, int kw,
                        int warps, int chunk, int32_t* matched,
                        cudaStream_t stream) {
  static bool opted_in = false;   // the attribute is set once an instance
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        run_schedule_smem<KC, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int W = 32 * warps;
  const size_t smem = smem_bytes(rows, W, chunk, kc, kw);
  run_schedule_smem<KC, KW><<<(n_lanes + W - 1) / W, W, smem, stream>>>(
      planes, out, n_bits, n_lanes, col_lo, rows, cc, ck, wc, wk, n_passes,
      kc, kw, chunk, matched);
  return cudaGetLastError();
}

template <int KC>
cudaError_t dispatch_kw(int KW, const uint32_t* planes, uint32_t* out,
                        int n_bits, int n_lanes, int col_lo, int rows,
                        const int32_t* cc, const int32_t* ck,
                        const int32_t* wc, const int32_t* wk, int n_passes,
                        int kc, int kw, int warps, int chunk,
                        int32_t* matched, cudaStream_t stream) {
#define AP_KW(N)                                                            \
  case N:                                                                   \
    return launch_smem<KC, N>(planes, out, n_bits, n_lanes, col_lo, rows,   \
                              cc, ck, wc, wk, n_passes, kc, kw, warps,      \
                              chunk, matched, stream);
  switch (KW) {
    AP_KW(1) AP_KW(2) AP_KW(4) AP_KW(8) AP_KW(16)
  }
#undef AP_KW
  return cudaErrorInvalidValue;
}

}  // namespace

// Which path a schedule of this shape takes without a choice: 0 the
// shared-memory one, 1 the device-memory one.
extern "C" int ap_match_path(int n_lanes, int col_lo, int col_hi,
                             int n_passes, int kc, int kw) {
  int warps, chunk;
  return plan_smem(n_lanes, col_hi - col_lo + 1, n_passes, kc, kw, &warps,
                   &chunk)
             ? 0
             : 1;
}

// Runs the schedule from planes into out (both [n_bits, n_lanes]); matched
// must hold P zeros and [col_lo, col_hi] must hold every table column.
// path: -1 by shape, 0 the shared-memory path (cudaErrorInvalidValue where
// it cannot run), 1 the device-memory path.
extern "C" int ap_match_run_schedule(const void* planes, void* out,
                                     int n_bits, int n_lanes, int col_lo,
                                     int col_hi, const void* cc,
                                     const void* ck, const void* wc,
                                     const void* wk, int n_passes, int kc,
                                     int kw, void* matched, int path,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int warps = 0, chunk = 0;
  const int rows = col_hi - col_lo + 1;
  const bool smem_ok = plan_smem(n_lanes, rows, n_passes, kc, kw, &warps,
                                 &chunk);
  if (path == 0 && !smem_ok) return (int)cudaErrorInvalidValue;
  if (path == 1 || !smem_ok) {
    run_schedule_global<<<(n_lanes + kGlobalThreads - 1) / kGlobalThreads,
                          kGlobalThreads, 0, st>>>(
        (const uint32_t*)planes, (uint32_t*)out, n_bits, n_lanes,
        (const int32_t*)cc, (const int32_t*)ck, (const int32_t*)wc,
        (const int32_t*)wk, n_passes, kc, kw, (int32_t*)matched);
    return (int)cudaGetLastError();
  }
  const uint32_t* p = (const uint32_t*)planes;
  uint32_t* o = (uint32_t*)out;
  const int32_t *c1 = (const int32_t*)cc, *c2 = (const int32_t*)ck,
                *w1 = (const int32_t*)wc, *w2 = (const int32_t*)wk;
  int32_t* m = (int32_t*)matched;
  const int KW = pow2_at_least(kw);
#define AP_KC(N)                                                            \
  case N:                                                                   \
    return (int)dispatch_kw<N>(KW, p, o, n_bits, n_lanes, col_lo, rows, c1, \
                               c2, w1, w2, n_passes, kc, kw, warps, chunk,  \
                               m, st);
  switch (pow2_at_least(kc)) {
    AP_KC(1) AP_KC(2) AP_KC(4) AP_KC(8) AP_KC(16)
  }
#undef AP_KC
  return (int)cudaErrorInvalidValue;
}

// The probe's six numbers (see latency_probe) into out (int64[6]).
extern "C" int ap_match_probe(void* out, int iters, void* stream) {
  latency_probe<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, iters);
  return (int)cudaGetLastError();
}
