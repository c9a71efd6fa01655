// AP megakernel: one op group (PASS / CMP / CMP_TAG / WRITE ops over a
// persistent TAG, with enabled gating and response-counter conditions) in
// one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel run_group_kernel (body _group_kernel) in
// src/repro/kernels/ap_megakernel/kernel.py.  planes is [n_bits, n_lanes]
// of 32-bit words (32 AP words per lane), tag is [n_lanes].  For each op p,
// in order, with bcast(key) = 0 - key (the reference's key * 0xFFFFFFFF):
//
//   t        = AND_k ~(planes[cc[p,k]] ^ bcast(ck[p,k]))   (not for WRITE)
//   t       &= tag                                          (CMP_TAG only)
//   wtag     = op == WRITE ? tag : t
//   ex       = enabled[p] && (cond[p] == 0 || matched[p - cond[p]] > 0)
//   matched[p] = ex ? popcount(wtag) over all lanes : 0
//   if ex and op is PASS or WRITE: for k in order:
//       planes[wc[p,k]] = (planes[wc[p,k]] & ~wtag) | (bcast(wk[p,k]) & wtag)
//   if ex and op is CMP or CMP_TAG: tag = t
//
// The compare reads the planes before any write of the same op, and the
// writes go in k order, so a column listed twice ends with its last key.
//
// Two launches, as the reference has two lowerings:
//
// * Unconditional groups (cond == 0 everywhere: bucketed pass schedules,
//   probe batches).  Lanes never interact, so the lane axis is tiled over
//   CTAs and one thread owns one lane for the whole group; its tag lives
//   in a register.  matched[p] is counted with __popc, a warp reduction,
//   an integer atomic into a shared chunk of counts and one global atomic
//   per block and op (exact and order-free).  The shared chunk holds 1024
//   ops and is flushed between chunks, so P has no cap.
// * Conditional groups (the sort/knn rounds) branch on the global count
//   of an earlier op, so one CTA owns the whole lane axis (the reference's
//   grid=(1,)): a count local to one CTA would let one CTA take a branch
//   another skips.  Each thread owns lanes tid, tid + blockDim, ... .  An
//   executed op ends with a block reduction: warp sums go to a shared
//   array and, after one __syncthreads, every thread adds them up itself,
//   so all threads hold the same count and the same last MAX_COND counts
//   in registers, and every thread takes the same branch.  The warp-sum
//   array is double-buffered by executed op, which makes one barrier an
//   op enough.  Planes stay in global memory (1.25 MiB at 2^20 words and
//   10 columns, resident in the 50 MB L2).
//
// What bounds it on the H100: an op moves Kc + 2 Kw words per lane plus
// the tag for about 3 (Kc + Kw) integer operations, so bytes bound it; a
// conditional group runs on one SM and is latency-bound by its P serial
// block reductions long before that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPass = 0, kCmp = 1, kCmpTag = 2, kWrite = 3;
constexpr int kTileThreads = 128;
constexpr int kChunk = 1024;
constexpr int kSoloMaxThreads = 1024;

struct Group {
  const int32_t* op;
  const int32_t* cond;
  const int32_t* enabled;
  const int32_t* cc;
  const int32_t* ck;
  const int32_t* wc;
  const int32_t* wk;
  int n_ops, kc, kw;
};

__device__ __forceinline__ uint32_t compare_word(const uint32_t* planes,
                                                 int n_lanes, int lane,
                                                 const Group& g, int p) {
  uint32_t t = 0xFFFFFFFFu;
  for (int k = 0; k < g.kc; ++k) {
    const long long c = __ldg(&g.cc[(long long)p * g.kc + k]);
    const uint32_t key = 0u - (uint32_t)__ldg(&g.ck[(long long)p * g.kc + k]);
    t &= ~(planes[c * n_lanes + lane] ^ key);
  }
  return t;
}

__device__ __forceinline__ void write_word(uint32_t* planes, int n_lanes,
                                           int lane, const Group& g, int p,
                                           uint32_t wtag) {
  for (int k = 0; k < g.kw; ++k) {
    const long long c = __ldg(&g.wc[(long long)p * g.kw + k]);
    const uint32_t key = 0u - (uint32_t)__ldg(&g.wk[(long long)p * g.kw + k]);
    uint32_t* cell = planes + c * n_lanes + lane;
    *cell = (*cell & ~wtag) | (key & wtag);
  }
}

// One lane of one op: returns the popcount of the tag the op acted with.
__device__ __forceinline__ int run_lane(uint32_t* planes, int n_lanes,
                                        int lane, const Group& g, int p,
                                        int opc, uint32_t& tag) {
  uint32_t t = 0u;
  if (opc != kWrite) {
    t = compare_word(planes, n_lanes, lane, g, p);
    if (opc == kCmpTag) t &= tag;
  }
  const uint32_t wtag = opc == kWrite ? tag : t;
  if ((opc == kPass || opc == kWrite) && wtag != 0u)
    write_word(planes, n_lanes, lane, g, p, wtag);
  if (opc == kCmp || opc == kCmpTag) tag = t;
  return __popc(wtag);
}

__global__ void group_tiled(uint32_t* __restrict__ planes,
                            uint32_t* __restrict__ tag, int n_lanes, Group g,
                            int32_t* __restrict__ matched) {
  __shared__ int32_t s_matched[kChunk];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  uint32_t cur = active ? tag[lane] : 0u;
  for (int base = 0; base < g.n_ops; base += kChunk) {
    const int n = min(kChunk, g.n_ops - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_matched[i] = 0;
    __syncthreads();
    for (int p = base; p < base + n; ++p) {
      if (__ldg(&g.enabled[p]) == 0) continue;   // the same in every thread
      const int opc = __ldg(&g.op[p]);
      const int pc = active ? run_lane(planes, n_lanes, lane, g, p, opc, cur)
                            : 0;
      const int cnt = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)pc);
      if ((threadIdx.x & 31) == 0 && cnt != 0)
        atomicAdd(&s_matched[p - base], cnt);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (s_matched[i] != 0) atomicAdd(&matched[base + i], s_matched[i]);
    __syncthreads();  // the next chunk zeroes s_matched
  }
  if (active) tag[lane] = cur;
}

__global__ void group_solo(uint32_t* __restrict__ planes,
                           uint32_t* __restrict__ tag, int n_lanes, Group g,
                           int32_t* __restrict__ matched) {
  __shared__ int32_t s_warp[2][kSoloMaxThreads / 32];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  // counts of ops p-1 .. p-4 (0 before op 0, so a condition reaching
  // before the group never holds)
  int h1 = 0, h2 = 0, h3 = 0, h4 = 0;
  int buf = 0;
  for (int p = 0; p < g.n_ops; ++p) {
    const int cnd = __ldg(&g.cond[p]);
    int prev = 1;
    if (cnd > 0) prev = cnd == 1 ? h1 : cnd == 2 ? h2 : cnd == 3 ? h3 : h4;
    int total = 0;
    if (__ldg(&g.enabled[p]) != 0 && prev > 0) {
      const int opc = __ldg(&g.op[p]);
      unsigned cnt = 0u;
      for (int lane = threadIdx.x; lane < n_lanes; lane += blockDim.x) {
        uint32_t t = tag[lane];
        cnt += (unsigned)run_lane(planes, n_lanes, lane, g, p, opc, t);
        tag[lane] = t;
      }
      cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
      if ((threadIdx.x & 31) == 0) s_warp[buf][warp] = (int)cnt;
      __syncthreads();
      for (int w = 0; w < n_warps; ++w) total += s_warp[buf][w];
      buf ^= 1;
      if (threadIdx.x == 0) matched[p] = total;
    }
    h4 = h3;
    h3 = h2;
    h2 = h1;
    h1 = total;
  }
}

}  // namespace

// Runs the group in place on planes and tag; matched must hold P zeros.
extern "C" int ap_megakernel_run_group(void* planes, void* tag, int n_bits,
                                       int n_lanes, const void* op,
                                       const void* cond, const void* enabled,
                                       const void* cc, const void* ck,
                                       const void* wc, const void* wk,
                                       int n_ops, int kc, int kw,
                                       int conditional, void* matched,
                                       void* stream) {
  (void)n_bits;
  const Group g{(const int32_t*)op, (const int32_t*)cond,
                (const int32_t*)enabled, (const int32_t*)cc,
                (const int32_t*)ck, (const int32_t*)wc, (const int32_t*)wk,
                n_ops, kc, kw};
  cudaStream_t s = (cudaStream_t)stream;
  if (conditional) {
    int threads = ((n_lanes + 31) / 32) * 32;
    if (threads > kSoloMaxThreads) threads = kSoloMaxThreads;
    group_solo<<<1, threads, 0, s>>>((uint32_t*)planes, (uint32_t*)tag,
                                     n_lanes, g, (int32_t*)matched);
  } else {
    const int blocks = (n_lanes + kTileThreads - 1) / kTileThreads;
    group_tiled<<<blocks, kTileThreads, 0, s>>>(
        (uint32_t*)planes, (uint32_t*)tag, n_lanes, g, (int32_t*)matched);
  }
  return (int)cudaGetLastError();
}
