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
// Two kernels, as the reference has two lowerings:
//
// * group_tiled, unconditional groups (cond == 0 everywhere: bucketed
//   pass schedules, probe batches).  Lanes never interact, so the lane
//   axis is tiled over CTAs and one thread owns one lane for the whole
//   group; its tag lives in a register.  It runs in place on copies the
//   wrapper makes; matched[p] is counted with __popc, a warp reduction, an
//   integer atomic into a shared chunk of counts and one global atomic per
//   block and op (exact and order-free) into zeros.  The shared chunk holds
//   1024 ops and is flushed between chunks, so P has no cap.
//
// * group_cluster, conditional groups (the sort/knn rounds).  An op
//   branches on the count, over ALL lanes, of an op up to MAX_COND = 4
//   before it, so every CTA that holds lanes must see the same count.  One
//   thread block cluster of C <= 16 CTAs (cudaLaunchKernelEx with a
//   cluster dimension; above 8 with the non-portable attribute) owns the
//   lane axis, CTA r the contiguous slice [r * slice, (r + 1) * slice).
//   The counts cross between the CTAs through distributed shared memory:
//
//     - every executed op: each warp sums its lanes' popcounts
//       (__reduce_add_sync) and one lane stores the sum into the warp's
//       count of that op in shared memory, off the chain;
//     - an op that a later op branches on (some q in p+1..p+4 has
//       cond[q] == q - p; flagged in its record) also gives its count to
//       every thread at once: warp sums -> shared array -> __syncthreads
//       -> thread r < C adds them and stores (s, the CTA's count) as one
//       64-bit word into slot [rank] of CTA r (mapa +
//       st.relaxed.cluster.shared::cluster), s the number of such ops so
//       far -> every warp polls its own C slots until each holds s and
//       adds the counts (__reduce_add_sync).  So every thread of every CTA
//       holds the same last four counts in registers and takes the same
//       branch, and the exchange costs one store into a peer and one
//       barrier inside the CTA, not a cluster barrier.  The warp array and
//       the slots are double-buffered by s: a CTA writes a slot for s + 2
//       only after every CTA has published s + 1, which each does after it
//       read s.  With C = 1 the slots are left out, and with one warp the
//       warp sum is the count.  Ops that nothing branches on exchange
//       nothing: in a sort round 9 of up to 26 ops are branched on;
//     - after each chunk of ops, each CTA adds its warps' counts, and after
//       a cluster barrier CTA 0 adds the C CTAs' (ld.shared::cluster) and
//       writes matched[p] -- every p, 0 for an op that did not run, so the
//       wrapper zero-fills nothing -- and a second barrier frees the
//       counts and the records for the next chunk (and lets no CTA exit
//       while CTA 0 still reads it).  A first cluster barrier, before any
//       slot is written, makes sure every CTA of the cluster has started.
//
//   The op tables come decoded ahead, on the host (ops.device_group),
//   into one 16-byte-aligned record an op: a flags vector (opcode, cond,
//   branched on), then the compare and the write terms as rows counted
//   from col_lo and broadcast keys, in groups of GC (2 or 4) and GW (1 or
//   4) terms, one vector of rows and one of keys a group (a group is
//   padded by repeating the op's last term, harmless for a compare and
//   for a write).  A CTA stages a chunk of records (and the enabled mask,
//   where one is given) into shared memory by cp.async, 16 bytes at a
//   time.  In an op a thread loads every row of a group for all its lanes
//   before it stores any: the compare rows are read before the writes,
//   and a column written twice in a group is computed from the same old
//   word each time, so the last key wins, as in k order.  GC and GW are
//   template parameters, so the sort's two compare terms and one write
//   term cost two loads and one load and store a lane.
//
//   Two paths, chosen by shape on the host (ops.plan_conditional):
//     shared:  each CTA copies its tile -- the rows col_lo..col_hi the
//              tables touch, of its slice of lanes -- into shared memory
//              once (cp.async), runs every op there and stores the tile
//              into the output once; a thread owns lanes tid + k *
//              threads, k < LPT (1, 2 or 4, a template parameter, so the
//              loads of all its lanes issue together), and keeps their
//              tags in registers.  Lanes past n_lanes are zeros whose
//              counts are dropped.
//     global:  where C CTAs cannot hold the tile within the budget (or a
//              slice is above 4 * 1024 lanes), the same ops run on the
//              output planes and tag in device memory (L1/L2), one lane a
//              thread in turn, still over the C CTAs of the cluster.
//   Both read the input planes and tag and write separate outputs: rows
//   outside col_lo..col_hi are copied straight through in one pass, so the
//   wrapper clones nothing.
//
// What bounds it on the H100: latency.  The ops form one dependent chain,
// and a branched-on op crosses the cluster.  The least time is
//
//   t >= (E * t_op + B * t_dsm + N * t_bar) / f_sm + bytes / 3.35 TB/s
//
// with E the executed ops, B the executed ops that are branched on, N the
// cluster barriers (1 + 2 a chunk; B = N = 0 at C = 1), t_op one op's chain
// in shared memory (load -> logic -> popcount -> warp reduction -> store
// -> the next load), t_dsm the latency from a store into a peer's shared
// memory to the peer's load that sees it, t_bar the round trip of a
// cluster barrier, f_sm the SM clock, and bytes the tile and tag in and
// out once.  ap_megakernel_probe measures t_op, t_dsm, t_bar and f_sm
// (chip_smoke.py phase 13 prints them and the bound).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPass = 0, kCmp = 1, kCmpTag = 2, kWrite = 3;
constexpr int kTileThreads = 128;
constexpr int kChunk = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kSmemBytes = 232448;    // opt-in shared memory of one CTA
constexpr int kStaticSmem = 1024;     // group_cluster's static arrays, rounded up

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

// ---------------------------------------------------------------------
// conditional groups: one cluster
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives; what each wrote before
// (shared memory of any CTA, device memory) is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ unsigned peer_address(const void* local,
                                                 unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(local);
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(a), "r"(rank));
  return remote;
}

__device__ __forceinline__ int ld_peer(const void* local, unsigned rank) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v) : "r"(peer_address(local, rank)) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void st_peer64(const void* local, unsigned rank,
                                          unsigned long long v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;"
               :: "r"(peer_address(local, rank)), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_slot(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.shared::cta.u64 %0, [%1];"
               : "=l"(v) : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// polls of a slot before the kernel gives up with a trap: far beyond any
// wait a live cluster makes, so a fault ends the launch instead of hanging
constexpr long long kPollCap = 1LL << 28;

struct Cond {
  const uint32_t* planes;
  uint32_t* out;
  const uint32_t* tag;
  uint32_t* out_tag;
  int n_bits, n_lanes, lo, rows;
  const uint4* recs;        // [n_ops][rv] decoded records
  const int32_t* enabled;   // null: every op enabled
  int n_ops, n_cg, n_wg;
  int32_t* matched;
  int slice;                // lanes a CTA owns
  int chunk;                // ops whose records a CTA holds at once
};

// One op over a thread's lanes j0 + k * T, k < LPT, of a column block
// whose row 0 is at base, rows rs words apart; tg holds their tags.  ex:
// whether the op runs.  Returns the popcount over the lanes below n_live
// (0 where it does not run).  Branch-free in the opcode: every op
// compares (a WRITE's record carries a dummy compare term) and stores its
// write terms under a mask that is 0 for an op that writes nothing (a
// CMP's record carries a dummy write term), which stores each word back
// unchanged.
template <int LPT, int GC, int GW>
__device__ __forceinline__ unsigned op_lanes(uint32_t* base, int rs,
                                             uint32_t (&tg)[LPT], int j0,
                                             int T, int n_live,
                                             const uint4* rec, int n_cg,
                                             int n_wg, int opc, bool ex) {
  // one group of each where the template says so (GC = 2: Kc <= 2; GW =
  // 1: Kw = 1), else the record's count
  const int ncg = GC == 2 ? 1 : n_cg, nwg = GW == 1 ? 1 : n_wg;
  uint32_t t[LPT], w[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) t[k] = 0xFFFFFFFFu;
  for (int gi = 0; gi < ncg; ++gi) {
    const uint4 o = rec[1 + 2 * gi], m = rec[2 + 2 * gi];
    const uint32_t off[4] = {o.x * rs, o.y * rs, o.z * rs, o.w * rs};
    const uint32_t key[4] = {m.x, m.y, m.z, m.w};
    uint32_t x[LPT][GC];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
#pragma unroll
      for (int g = 0; g < GC; ++g) x[k][g] = base[j0 + k * T + off[g]];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
#pragma unroll
      for (int g = 0; g < GC; ++g) t[k] &= ~(x[k][g] ^ key[g]);
  }
  const bool writes = ex && (opc == kPass || opc == kWrite);
  const bool sets_tag = ex && (opc == kCmp || opc == kCmpTag);
  unsigned cnt = 0u;
  uint32_t wm[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    w[k] = opc == kWrite ? tg[k] : opc == kCmpTag ? t[k] & tg[k] : t[k];
    if (j0 + k * T < n_live) cnt += (unsigned)__popc(w[k]);
    wm[k] = writes ? w[k] : 0u;
  }
  const uint4* wrec = rec + 1 + 2 * n_cg;
  for (int gi = 0; gi < nwg; ++gi) {
    const uint4 o = wrec[2 * gi], m = wrec[2 * gi + 1];
    const uint32_t off[4] = {o.x * rs, o.y * rs, o.z * rs, o.w * rs};
    const uint32_t key[4] = {m.x, m.y, m.z, m.w};
    uint32_t x[LPT][GW];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
#pragma unroll
      for (int g = 0; g < GW; ++g) x[k][g] = base[j0 + k * T + off[g]];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
#pragma unroll
      for (int g = 0; g < GW; ++g)
        base[j0 + k * T + off[g]] = (x[k][g] & ~wm[k]) | (key[g] & wm[k]);
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) tg[k] = sets_tag ? w[k] : tg[k];
  return ex ? cnt : 0u;
}

// LPT > 0: the shared-memory path, LPT lanes a thread.  LPT == 0: the
// device-memory path, a thread's lanes one at a time.
template <int LPT, int GC, int GW>
__global__ void __launch_bounds__(kMaxThreads)
    group_cluster(const Cond a) {
  constexpr bool kShared = LPT > 0;
  constexpr int kRegs = kShared ? LPT : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_warp[2][32];
  __shared__ unsigned long long s_slot[2][kMaxCluster];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = T >> 5;
  const int C = (int)gridDim.x;             // the grid is one cluster
  const unsigned rank = C > 1 ? cluster_rank() : 0u;
  const int lane0 = (int)rank * a.slice;
  const int n_live = max(0, min(a.slice, a.n_lanes - lane0));
  const int rv = 1 + 2 * (a.n_cg + a.n_wg);     // uint4s a record
  const size_t nl = (size_t)a.n_lanes;
  const size_t tile_words = kShared ? (size_t)a.rows * a.slice : 0;
  uint4* recs = (uint4*)(smem + tile_words);
  int* s_en = (int*)(recs + (size_t)a.chunk * rv);
  int* s_part = s_en + a.chunk;
  int* s_wpart = s_part + a.chunk;                 // [n_warps][chunk]
  if (tid < 2 * kMaxCluster) (&s_slot[0][0])[tid] = 0ull;

  // planes in: the tile to shared memory (tags to registers), or the rows
  // and tags to the output
  uint32_t tg[kRegs];
  uint32_t* base;
  int rs;
  if constexpr (kShared) {
    // 16 bytes at a time where the rows allow it (the barrier after the
    // records makes every thread's copies seen by all)
    const int n_vec = (a.n_lanes & 3) == 0 ? n_live >> 2 : 0;
    for (int r = 0; r < a.rows; ++r) {
      uint32_t* row = smem + (size_t)r * a.slice;
      const uint32_t* src = a.planes + (size_t)(a.lo + r) * nl + lane0;
      for (int v = tid; v < n_vec; v += T) cp_async16(row + 4 * v, src + 4 * v);
      for (int j = 4 * n_vec + tid; j < a.slice; j += T) {
        if (j < n_live)
          cp_async4(row + j, src + j);
        else
          row[j] = 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      tg[k] = tid + k * T < n_live ? a.tag[lane0 + tid + k * T] : 0u;
    base = smem;
    rs = a.slice;
  } else {
    for (int r = a.lo; r < a.lo + a.rows; ++r)
      for (int j = tid; j < n_live; j += T)
        a.out[(size_t)r * nl + lane0 + j] = a.planes[(size_t)r * nl + lane0 + j];
    for (int j = tid; j < n_live; j += T)
      a.out_tag[lane0 + j] = a.tag[lane0 + j];
    base = a.out + (size_t)a.lo * nl + lane0;
    rs = a.n_lanes;
  }
  // rows no op touches: straight through
  for (int r = 0; r < a.n_bits; ++r) {
    if (r == a.lo) r += a.rows;
    if (r >= a.n_bits) break;
    for (int j = tid; j < n_live; j += T)
      a.out[(size_t)r * nl + lane0 + j] = a.planes[(size_t)r * nl + lane0 + j];
  }

  // counts of ops p-1 .. p-4 that a later op branches on (0 before op 0,
  // so a condition reaching before the group never holds)
  int h1 = 0, h2 = 0, h3 = 0, h4 = 0;
  int seq = 0;                    // branched-on ops run so far
  for (int c0 = 0; c0 < a.n_ops; c0 += a.chunk) {
    const int n = min(a.chunk, a.n_ops - c0);
    for (int i = tid; i < n * rv; i += T)
      cp_async16(&recs[i], &a.recs[(size_t)c0 * rv + i]);
    if (a.enabled != nullptr)
      for (int i = tid; i < n; i += T) cp_async4(&s_en[i], &a.enabled[c0 + i]);
    cp_async_wait_all();
    // every thread's records and tile words have landed; with C > 1 the
    // first also makes sure every CTA of the cluster has started (and
    // zeroed its slots) before any of them stores into another
    if (C > 1)
      cluster_sync();
    else
      __syncthreads();
    for (int i = 0; i < n; ++i) {
      const uint4* rec = recs + (size_t)i * rv;
      const uint32_t f = rec[0].x;
      const int opc = (int)(f & 3u), cnd = (int)((f >> 2) & 7u);
      int prev = 1;
      if (cnd > 0) prev = cnd == 1 ? h1 : cnd == 2 ? h2 : cnd == 3 ? h3 : h4;
      // whether the op runs: the same in every thread
      const bool ex = (a.enabled == nullptr || s_en[i] != 0) && prev > 0;
      unsigned cnt = 0u;
      if constexpr (kShared) {
        cnt = op_lanes<LPT, GC, GW>(base, rs, tg, tid, T, n_live, rec,
                                    a.n_cg, a.n_wg, opc, ex);
      } else {
        for (int j = tid; j < n_live; j += T) {
          uint32_t t1[1] = {a.out_tag[lane0 + j]};
          cnt += op_lanes<1, GC, GW>(base, rs, t1, j, T, n_live, rec,
                                     a.n_cg, a.n_wg, opc, ex);
          a.out_tag[lane0 + j] = t1[0];
        }
      }
      cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
      if (lane == 0) s_wpart[warp * a.chunk + i] = (int)cnt;
      int total = 0;
      if (ex) {
        if ((f >> 6) & 1u) {                  // a later op branches on it
          ++seq;
          const int sb = seq & 1;
          if (C == 1 && n_warps == 1) {
            total = (int)cnt;
          } else {
            if (lane == 0) s_warp[sb][warp] = (int)cnt;
            __syncthreads();
            if (C == 1) {
              for (int w = 0; w < n_warps; ++w) total += s_warp[sb][w];
            } else {
              if (tid < C) {
                unsigned s = 0u;
                for (int w = 0; w < n_warps; ++w) s += (unsigned)s_warp[sb][w];
                st_peer64(&s_slot[sb][rank], (unsigned)tid,
                          ((unsigned long long)seq << 32) | s);
              }
              unsigned v = 0u;
              if (lane < C) {
                unsigned long long x = ld_slot(&s_slot[sb][lane]);
                long long polls = 0;
                while ((unsigned)(x >> 32) != (unsigned)seq) {
                  if (++polls > kPollCap) asm volatile("trap;");
                  x = ld_slot(&s_slot[sb][lane]);
                }
                v = (unsigned)x;
              }
              total = (int)__reduce_add_sync(0xFFFFFFFFu, v);
            }
          }
        }
      }
      h4 = h3;
      h3 = h2;
      h2 = h1;
      h1 = total;
    }
    // the chunk's counts: each CTA adds its warps', CTA 0 every CTA's
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) s += s_wpart[w * a.chunk + i];
      s_part[i] = s;
    }
    if (C > 1)
      cluster_sync();
    else
      __syncthreads();
    if (rank == 0)
      for (int i = tid; i < n; i += T) {
        int s = 0;
        for (int r = 0; r < C; ++r)
          s += C > 1 ? ld_peer(&s_part[i], (unsigned)r) : s_part[i];
        a.matched[c0 + i] = s;
      }
    // frees the counts and records; no CTA exits while CTA 0 reads it
    if (C > 1)
      cluster_sync();
    else
      __syncthreads();
  }

  if constexpr (kShared) {        // the tile after the last barrier
    const int n_vec = (a.n_lanes & 3) == 0 ? n_live >> 2 : 0;
    for (int r = 0; r < a.rows; ++r) {
      const uint32_t* row = smem + (size_t)r * a.slice;
      uint32_t* dst = a.out + (size_t)(a.lo + r) * nl + lane0;
      for (int v = tid; v < n_vec; v += T)
        *(uint4*)(dst + 4 * v) = *(const uint4*)(row + 4 * v);
      for (int j = 4 * n_vec + tid; j < n_live; j += T) dst[j] = row[j];
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (tid + k * T < n_live) a.out_tag[lane0 + tid + k * T] = tg[k];
  }
}

template <int LPT, int GC, int GW>
cudaError_t launch_cluster(const Cond& a, int cluster, int threads,
                           size_t smem, cudaStream_t stream) {
  static size_t opted = 0;    // dynamic shared memory allowed so far
  auto kernel = group_cluster<LPT, GC, GW>;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int GC, int GW>
cudaError_t dispatch_lpt(int lpt, const Cond& a, int cluster, int threads,
                         size_t smem, cudaStream_t s) {
  switch (lpt) {
    case 0: return launch_cluster<0, GC, GW>(a, cluster, threads, smem, s);
    case 1: return launch_cluster<1, GC, GW>(a, cluster, threads, smem, s);
    case 2: return launch_cluster<2, GC, GW>(a, cluster, threads, smem, s);
    case 4: return launch_cluster<4, GC, GW>(a, cluster, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// probe: cluster barrier, store into a peer's shared memory, one op's chain
// ---------------------------------------------------------------------

constexpr long long kSpinCap = 1LL << 24;

__global__ void cluster_probe(long long* __restrict__ out, int iters) {
  __shared__ uint32_t slot[2];
  __shared__ uint32_t ring[32];
  const unsigned rank = cluster_rank();
  if (threadIdx.x == 0) slot[0] = slot[1] = 0u;
  if (threadIdx.x < 32) ring[threadIdx.x] = threadIdx.x;
  cluster_sync();                 // every CTA started, slots zero
  // (0) the round trip of a cluster barrier, every thread of every CTA
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cluster_sync();
  const long long t1 = clock64();
  // (1) ping-pong between CTAs 0 and 1: a store into the peer's shared
  //     memory, seen by the peer's load, and back
  long long t_pp = 0, spins = 0;
  if (threadIdx.x == 0 && rank < 2) {
    const unsigned mine = (unsigned)__cvta_generic_to_shared(&slot[0]);
    const unsigned theirs = peer_address(&slot[0], rank ^ 1u);
    const long long p0 = clock64();
    for (int i = 1; i <= iters && spins < kSpinCap; ++i) {
      if (rank == 0)
        asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;"
                     :: "r"(theirs), "r"(i) : "memory");
      unsigned v = 0u;
      do {
        asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];"
                     : "=r"(v) : "r"(mine) : "memory");
      } while (v != (unsigned)i && ++spins < kSpinCap);
      if (rank == 1)
        asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;"
                     :: "r"(theirs), "r"(i) : "memory");
    }
    t_pp = clock64() - p0;
  }
  // (2) one op's chain on one warp: load -> logic -> popcount -> warp
  //     reduction -> store -> the next load of the same word
  long long t_op = 0;
  unsigned v = 0u;
  if (rank == 0 && threadIdx.x < 32) {
    __syncwarp();
    const unsigned cell = (unsigned)__cvta_generic_to_shared(&ring[threadIdx.x]);
    const unsigned m1 = 0x9E3779B9u, m2 = 0x85EBCA6Bu;
    const long long q0 = clock64();
    for (int i = 0; i < iters; ++i) {
      asm volatile(
          "{\n\t.reg .u32 c;\n\t"
          "ld.volatile.shared.u32 %0, [%1];\n\t"
          "lop3.b32 %0, %0, %2, %3, 0x96;\n\t"
          "popc.b32 c, %0;\n\t"
          "redux.sync.add.u32 c, c, 0xffffffff;\n\t"
          "xor.b32 %0, %0, c;\n\t"
          "st.volatile.shared.u32 [%1], %0;\n\t}"
          : "=&r"(v) : "r"(cell), "r"(m1), "r"(m2) : "memory");
    }
    t_op = clock64() - q0;
  }
  // (3) the SM clock: cycles against the global nanosecond timer
  long long c_cycles = 0, c_ns = 0;
  if (rank == 0 && threadIdx.x == 0) {
    unsigned long long g0, g1;
    unsigned y = v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    const long long c0 = clock64();
    for (int i = 0; i < 64 * iters; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                     : "+r"(y) : "r"(0x9E3779B9u), "r"(0x85EBCA6Bu));
    }
    c_cycles = clock64() - c0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    c_ns = (long long)(g1 - g0);
    v ^= y;
  }
  cluster_sync();                 // no CTA exits while a peer stores to it
  if (rank == 0 && threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t_pp;
    out[2] = t_op;
    out[3] = c_cycles;
    out[4] = c_ns;
    out[5] = (long long)v;        // keeps the chains live
  }
  if (rank == 1 && threadIdx.x == 0) out[6] = spins >= kSpinCap ? 1 : 0;
}

// The group's tables from one packed int32 array (ops.device_group): op,
// cond, enabled (ones), then cc, ck [P, Kc] and wc, wk [P, Kw]; a
// non-null `enabled` replaces the packed mask.
Group unpack(const void* tables, const void* enabled, int n_ops, int kc,
             int kw) {
  const int32_t* t = (const int32_t*)tables;
  const int32_t* cc = t + 3 * (size_t)n_ops;
  const int32_t* ck = cc + (size_t)n_ops * kc;
  const int32_t* wc = ck + (size_t)n_ops * kc;
  const int32_t* wk = wc + (size_t)n_ops * kw;
  return Group{t, t + n_ops,
               enabled ? (const int32_t*)enabled : t + 2 * (size_t)n_ops,
               cc, ck, wc, wk, n_ops, kc, kw};
}

}  // namespace

// Runs an unconditional group in place on planes and tag; matched must
// hold P zeros.
extern "C" int ap_megakernel_run_group(void* planes, void* tag, int n_lanes,
                                       const void* tables,
                                       const void* enabled, int n_ops, int kc,
                                       int kw, void* matched, void* stream) {
  const Group g = unpack(tables, enabled, n_ops, kc, kw);
  const int blocks = (n_lanes + kTileThreads - 1) / kTileThreads;
  group_tiled<<<blocks, kTileThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (uint32_t*)tag, n_lanes, g, (int32_t*)matched);
  return (int)cudaGetLastError();
}

// Runs a conditional group from (planes, tag) into (out, out_tag) and
// writes every matched[p], as ops.plan_conditional planned it.  prm holds,
// on the host, n_bits, n_lanes, col_lo, rows (the table rows from col_lo
// on), n_ops, n_cg, n_wg, gc, gw (the records' groups of terms, as
// ops.device_group decoded them), then the plan: cluster (CTAs), threads,
// slice (lanes a CTA), lpt (lanes a thread on the shared-memory path, 0
// for the device-memory path) and chunk (op records at a time).  enabled
// may be null (every op enabled).  Returns cudaErrorInvalidValue for a
// plan it cannot run.
extern "C" int ap_megakernel_run_conditional(
    const void* planes, void* out, const void* tag, void* out_tag,
    const void* records, const void* enabled, void* matched, const int* prm,
    void* stream) {
  const int n_bits = prm[0], n_lanes = prm[1], col_lo = prm[2], rows = prm[3];
  const int n_ops = prm[4], n_cg = prm[5], n_wg = prm[6], gc = prm[7],
            gw = prm[8];
  const int cluster = prm[9], threads = prm[10], slice = prm[11],
            lpt = prm[12], chunk = prm[13];
  const size_t rec_bytes = 16 * (size_t)(1 + 2 * (n_cg + n_wg));
  const size_t tile = lpt > 0 ? 4 * (size_t)rows * slice : 0;
  const size_t smem =
      tile + (size_t)chunk * (rec_bytes + 4 * (size_t)(2 + threads / 32));
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || chunk < 1 ||
      n_cg < 1 || n_wg < 1 || n_ops < 1 || (gc == 2 && n_cg != 1) ||
      (gw == 1 && n_wg != 1) || (long long)cluster * slice < n_lanes ||
      (lpt > 0 && slice != lpt * threads) ||
      smem + kStaticSmem > (size_t)kSmemBytes)
    return (int)cudaErrorInvalidValue;
  const Cond a{(const uint32_t*)planes, (uint32_t*)out,
               (const uint32_t*)tag, (uint32_t*)out_tag, n_bits, n_lanes,
               col_lo, rows, (const uint4*)records, (const int32_t*)enabled,
               n_ops, n_cg, n_wg, (int32_t*)matched, slice, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (gc == 2 && gw == 1)
    return (int)dispatch_lpt<2, 1>(lpt, a, cluster, threads, smem, s);
  if (gc == 2 && gw == 4)
    return (int)dispatch_lpt<2, 4>(lpt, a, cluster, threads, smem, s);
  if (gc == 4 && gw == 1)
    return (int)dispatch_lpt<4, 1>(lpt, a, cluster, threads, smem, s);
  if (gc == 4 && gw == 4)
    return (int)dispatch_lpt<4, 4>(lpt, a, cluster, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The probe's numbers into out (int64[7]): cycles of `iters` cluster
// barriers, of `iters` store -> peer load -> store back -> load round
// trips between CTAs 0 and 1, of `iters` op chains on one warp; SM cycles
// and nanoseconds of a timed loop; a sink; 1 if a spin hit its cap.
extern "C" int ap_megakernel_probe(void* out, int iters, int cluster,
                                   int threads, void* stream) {
  if (cluster < 2 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cluster_probe, (long long*)out, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
