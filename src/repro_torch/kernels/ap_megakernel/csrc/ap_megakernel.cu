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
// One kernel, op_group, runs both kinds of group; the host plans its
// launch by shape (ops.plan_conditional, ops.plan_unconditional):
//
// * conditional groups (the sort/knn rounds).  An op branches on the
//   count, over ALL lanes, of an op up to MAX_COND = 4 before it, so every
//   CTA that holds lanes must see the same count.  One thread block
//   cluster of C <= 16 CTAs (cudaLaunchKernelEx with a cluster dimension;
//   above 8 with the non-portable attribute) owns the lane axis, CTA r the
//   contiguous slice [r * slice, (r + 1) * slice).  The counts cross
//   between the CTAs through distributed shared memory:
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
// * unconditional groups (cond == 0 everywhere: bucketed pass schedules,
//   probe batches).  Lanes never interact and no op branches on a count,
//   so the same body runs (kCond = false: no cluster code compiled in)
//   over a grid of independent CTAs across the whole card, CTA r again
//   the slice [r * slice, (r + 1) * slice); slices of 32-1024 lanes put a
//   CTA on every SM where the lanes allow.  No CTA waits for another.  A
//   thread stores its own count of an op as one byte into shared memory
//   (no warp reduction on the op's chain); each chunk's bytes are summed
//   (__dp4a) and added with one integer atomic a CTA and op into a [1 + P]
//   accumulator in device memory (exact and order-free); the last CTA to
//   finish (a ticket taken with an atomic in the accumulator's word 0,
//   after a fence) moves every count into matched[p] (0 for an op that did
//   not run) with atomicExch, which leaves the accumulator zero for the
//   next launch on the stream (the wrapper keeps one a stream, zeroed once
//   when it is made).  With one CTA the counts go straight to matched.
//
// An op that does not run (disabled, or its condition failed) is skipped
// whole: the decision is the same in every thread of the CTA.
//
//   The op tables come decoded ahead, on the host (ops.device_group),
//   into one 16-byte-aligned record an op: a head vector (the flags --
//   opcode, cond, branched on -- and three masks of the opcode), then the
//   compare and the write terms as rows counted from col_lo and broadcast
//   keys, in groups of 2 or 4 compare and 1, 2 or 4 write terms, one
//   vector of rows and one of keys a group (a group is padded by
//   repeating the op's last term, harmless for a compare and for a
//   write).  A CTA stages a chunk of records (and the enabled mask, where
//   one is given) into shared memory by cp.async, 16 bytes at a time, and
//   turns their rows into byte offsets once.  The op loop holds an op's
//   record in registers -- the head and the rows and keys of the first one
//   or two compare groups and of the first write group -- and loads op
//   i + 1's while op i runs, so an op's row loads
//   wait on nothing but the op before.  The op body does not branch on the
//   opcode (the masks select compare, tag and write), nor, for the common
//   shapes, on the number of terms: GC (2, 4 or 8 compare terms in
//   registers) and GW (1, 2 or 4 write terms) are template parameters, so
//   the sort's two compare terms and one write term cost two loads and one
//   load and store a lane; further groups (Kc > 8, Kw > 4) are read from
//   the record out of line.  A thread loads every row of a group for all
//   its lanes before it stores any: the compare rows are read before the
//   writes, and a column written twice in a group is computed from the
//   same old word each time, so the last key wins, as in k order.  The
//   loop reaches shared memory by 32-bit offsets in the CTA's window
//   (ld.shared / st.shared), computed once: a generic pointer would be
//   rebuilt from the CTA's cluster id at every access.
//
//   Two paths, chosen by shape on the host:
//     shared:  each CTA copies its tile -- the rows col_lo..col_hi the
//              tables touch, of its slice of lanes -- into shared memory
//              once (cp.async), runs every op there and stores the tile
//              into the output once; a thread owns LPT consecutive lanes
//              (1, 2 or 4, a template parameter: one 4-, 8- or 16-byte
//              load a row) and keeps their tags in registers.  Lanes past
//              n_lanes are zeros whose counts are dropped.
//     global:  where a CTA cannot hold its tile within the budget (or a
//              cluster's slice is above 4 * 1024 lanes), the same ops run
//              on the output planes and tag in device memory (L1/L2), one
//              lane a thread in turn.
//   Both read the input planes and tag and write separate outputs: rows
//   outside col_lo..col_hi are copied straight through by every thread of
//   the CTA, so the wrapper clones nothing.
//
// What bounds it on the H100: latency.  The ops form one dependent chain,
// and a branched-on op crosses the cluster.  The least time is
//
//   t >= (E * t_op + B * t_dsm + N * t_bar) / f_sm + bytes / 3.35 TB/s
//
// with E the executed ops, B the executed ops that are branched on, N the
// cluster barriers (1 + 2 a chunk; B = N = 0 at C = 1 and for every
// unconditional group), t_op one op's chain in shared memory (load ->
// logic -> popcount -> warp reduction -> store -> the next load), t_dsm
// the latency from a store into a peer's shared memory to the peer's load
// that sees it, t_bar the round trip of a
// cluster barrier, f_sm the SM clock, and bytes the tile and tag in and
// out once.  ap_megakernel_probe measures t_op, t_dsm, t_bar and f_sm
// (chip_smoke.py phase 13 prints them and the bound).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPass = 0, kCmp = 1, kCmpTag = 2, kWrite = 3;
constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxThreadsU = 256;     // an unconditional group's CTA
constexpr int kSmemBytes = 232448;    // opt-in shared memory of one CTA
constexpr int kStaticSmem = 1024;     // op_group's static arrays, rounded up

// ---------------------------------------------------------------------
// cluster and cp.async helpers
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

struct Args {
  const uint32_t* planes;
  uint32_t* out;
  const uint32_t* tag;
  uint32_t* out_tag;
  int n_bits, n_lanes, lo, rows;
  const uint4* recs;        // [n_ops][rv] decoded records
  const uint8_t* enabled;   // bool[n_ops]; null: every op enabled
  int n_ops, n_cg, n_wg;
  int32_t* matched;
  int32_t* acc;             // [1 + n_ops] zeros: independent CTAs' counts
  int cluster;              // CTAs of the cluster (1: independent CTAs)
  int slice;                // lanes a CTA owns
  int chunk;                // ops whose records a CTA holds at once
};

// The op loop addresses shared memory by 32-bit offsets in the CTA's
// shared window, computed once and kept in registers (a generic pointer
// into shared memory would be rebuilt from the CTA's cluster id on every
// access), and reads and writes it with explicit ld.shared / st.shared.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

// A column block's rows in shared memory: base is the thread's first lane
// of row 0, offsets are bytes; L consecutive words at a time.
struct SharedRows {
  uint32_t base;

  template <int L>
  __device__ __forceinline__ void ld(uint32_t off, uint32_t (&v)[L]) const {
    const uint32_t a = base + off;
    if constexpr (L == 4)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                   : "r"(a));
    else if constexpr (L == 2)
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                   : "=r"(v[0]), "=r"(v[1]) : "r"(a));
    else
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v[0]) : "r"(a));
  }

  template <int L>
  __device__ __forceinline__ void st(uint32_t off,
                                     const uint32_t (&v)[L]) const {
    const uint32_t a = base + off;
    if constexpr (L == 4)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "r"(a), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    else if constexpr (L == 2)
      asm volatile("st.shared.v2.u32 [%0], {%1, %2};"
                   :: "r"(a), "r"(v[0]), "r"(v[1]) : "memory");
    else
      asm volatile("st.shared.u32 [%0], %1;" :: "r"(a), "r"(v[0])
                   : "memory");
  }
};

// The same rows in device memory (the device-memory path): one lane.
struct GlobalRows {
  uint32_t* base;

  template <int L>
  __device__ __forceinline__ void ld(uint32_t off, uint32_t (&v)[L]) const {
    static_assert(L == 1, "one lane at a time in device memory");
    v[0] = *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const char*>(base) + off);
  }

  template <int L>
  __device__ __forceinline__ void st(uint32_t off,
                                     const uint32_t (&v)[L]) const {
    static_assert(L == 1, "one lane at a time in device memory");
    *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(base) + off) = v[0];
  }
};

// An op's record in registers: the flags word f, a (all ones where the op
// ignores the compare: WRITE), b (where it ignores the tag: PASS, CMP),
// wm (where it writes: PASS, WRITE; an op sets the tag where it does not
// write), the byte offsets of the rows and the broadcast keys of the first
// compare terms (co, ck: GC of them, as kCG groups of kG) and of the first
// group of write terms (wo, wk: GW).  GC is 2 (Kc <= 2), 4 (one group of
// four) or 8 (two groups of four: Kc > 4), GW 1, 2 or 4, so an op's common
// terms take no branch.
template <int GC, int GW>
struct Rec {
  static constexpr int kCG = GC == 8 ? 2 : 1;   // groups in registers
  static constexpr int kG = GC == 8 ? 4 : GC;   // terms a group
  uint32_t f, a, b, wm;
  uint32_t co[kCG][kG], ck[kCG][kG], wo[GW], wk[GW];
};

__device__ __forceinline__ void unpack4(const uint4& v, uint32_t (&out)[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// rec: the op's record in shared memory
template <int GC, int GW>
__device__ __forceinline__ Rec<GC, GW> load_rec(uint32_t rec, int n_cg) {
  Rec<GC, GW> r;
  const uint4 h = lds128(rec);
  r.f = h.x;
  r.a = h.y;
  r.b = h.z;
  r.wm = h.w;
  constexpr int kG = Rec<GC, GW>::kG;
  uint32_t v[4];
#pragma unroll
  for (int c = 0; c < Rec<GC, GW>::kCG; ++c) {
    unpack4(lds128(rec + 16 * (1 + 2 * c)), v);
#pragma unroll
    for (int g = 0; g < kG; ++g) r.co[c][g] = v[g];
    unpack4(lds128(rec + 16 * (2 + 2 * c)), v);
#pragma unroll
    for (int g = 0; g < kG; ++g) r.ck[c][g] = v[g];
  }
  unpack4(lds128(rec + 16 * (1 + 2 * n_cg)), v);
#pragma unroll
  for (int g = 0; g < GW; ++g) r.wo[g] = v[g];
  unpack4(lds128(rec + 16 * (2 + 2 * n_cg)), v);
#pragma unroll
  for (int g = 0; g < GW; ++g) r.wk[g] = v[g];
  return r;
}

// One op that runs, over a thread's L consecutive lanes of the rows m
// reaches; tg holds the lanes' tags and n_own how many of the L lanes are
// live.  Returns their popcount.  Every row of the registered compare
// groups and of the first write group is loaded before any store; further
// groups (Kc > 8, or Kw > 4) come from the record in shared memory (rec):
// compare groups before the writes, each write group loaded whole before
// it is stored.  No branch on the opcode: the compare, the tag and the
// writes are masked by the record's a, b and wm (an op that writes
// nothing stores each word back unchanged).
template <int L, int GC, int GW, class Rows>
__device__ __forceinline__ unsigned op_body(const Rows& m, uint32_t (&tg)[L],
                                            int n_own, const Rec<GC, GW>& r,
                                            uint32_t rec, int n_cg,
                                            int n_wg) {
  constexpr int kCG = Rec<GC, GW>::kCG, kG = Rec<GC, GW>::kG;
  uint32_t x[kCG][kG][L], y[GW][L], t[L], w[L], wm[L];
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int g = 0; g < kG; ++g) m.template ld<L>(r.co[c][g], x[c][g]);
#pragma unroll
  for (int g = 0; g < GW; ++g) m.template ld<L>(r.wo[g], y[g]);
  // one AND chain a group, the groups' chains side by side
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint32_t u[kCG];
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      u[c] = 0xFFFFFFFFu;
#pragma unroll
      for (int g = 0; g < kG; ++g)
        u[c] &= ~(x[c][g][k] ^ r.ck[c][g]);
    }
    t[k] = u[0];
#pragma unroll
    for (int c = 1; c < kCG; ++c) t[k] &= u[c];
  }
  if constexpr (GC == 8) {
    if (__builtin_expect(n_cg > kCG, 0)) {    // Kc > 8 only
      for (int gi = kCG; gi < n_cg; ++gi) {
        uint32_t o[4], k4[4], z[4][L];
        unpack4(lds128(rec + 16 * (1 + 2 * gi)), o);
        unpack4(lds128(rec + 16 * (2 + 2 * gi)), k4);
#pragma unroll
        for (int g = 0; g < 4; ++g) m.template ld<L>(o[g], z[g]);
#pragma unroll
        for (int k = 0; k < L; ++k)
#pragma unroll
          for (int g = 0; g < 4; ++g) t[k] &= ~(z[g][k] ^ k4[g]);
      }
    }
  }
  unsigned cnt = 0u;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    w[k] = (t[k] | r.a) & (tg[k] | r.b);
    wm[k] = w[k] & r.wm;
    if (k < n_own) cnt += (unsigned)__popc(w[k]);
  }
#pragma unroll
  for (int g = 0; g < GW; ++g) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      y[g][k] = (y[g][k] & ~wm[k]) | (r.wk[g] & wm[k]);
    m.template st<L>(r.wo[g], y[g]);
  }
  if constexpr (GW == 4) {
    if (__builtin_expect(n_wg > 1, 0)) {      // Kw > 4 only
      const uint32_t wrec = rec + 16 * (1 + 2 * n_cg);
      for (int gi = 1; gi < n_wg; ++gi) {
        uint32_t o[4], k4[4], z[4][L];
        unpack4(lds128(wrec + 32 * gi), o);
        unpack4(lds128(wrec + 32 * gi + 16), k4);
#pragma unroll
        for (int g = 0; g < 4; ++g) m.template ld<L>(o[g], z[g]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
#pragma unroll
          for (int k = 0; k < L; ++k)
            z[g][k] = (z[g][k] & ~wm[k]) | (k4[g] & wm[k]);
          m.template st<L>(o[g], z[g]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) tg[k] = (w[k] & ~r.wm) | (tg[k] & r.wm);
  return cnt;
}

// Rows [r0, r1) of a CTA's n_live lanes from in to out, by every thread of
// the CTA, 16 bytes at a time where the rows allow it, four copies in
// flight a thread.
__device__ __forceinline__ void copy_rows(uint32_t* __restrict__ out,
                                          const uint32_t* __restrict__ in,
                                          size_t nl, int lane0, int n_live,
                                          int r0, int r1, int tid, int T) {
  if (r1 <= r0 || n_live <= 0) return;
  const bool vec = (nl & 3) == 0 && (n_live & 3) == 0;  // lane0: 32 k
  const int w = vec ? n_live >> 2 : n_live;              // items a row
  const int total = (r1 - r0) * w;
#pragma unroll 4
  for (int e = tid; e < total; e += T) {
    const int r = r0 + e / w, c = e % w;
    const size_t at = (size_t)r * nl + lane0;
    if (vec)
      reinterpret_cast<uint4*>(out + at)[c] =
          reinterpret_cast<const uint4*>(in + at)[c];
    else
      out[at + c] = in[at + c];
  }
}

// LPT > 0: the shared-memory path, LPT consecutive lanes a thread.  LPT ==
// 0: the device-memory path, a thread's lanes one at a time.  kCond: a
// conditional group, whose grid is one cluster of a.cluster CTAs and whose
// counts are summed a warp at a time (__reduce_add_sync) as they run; else
// independent CTAs with no cluster code compiled in, each thread storing
// its own count of an op as one byte, summed a chunk at a time.
template <int LPT, int GC, int GW, bool kCond>
__global__ void __launch_bounds__(kCond ? kMaxThreads : kMaxThreadsU)
    op_group(const Args a) {
  constexpr bool kShared = LPT > 0;
  constexpr int kRegs = kShared ? LPT : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_warp[2][32];
  __shared__ unsigned long long s_slot[2][kMaxCluster];
  __shared__ int s_last;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = T >> 5;
  const int C = kCond ? a.cluster : 1;
  unsigned rank = 0u;
  if constexpr (kCond) rank = C > 1 ? cluster_rank() : 0u;
  // a CTA's lanes (in a cluster, blockIdx.x is the CTA's rank)
  const int lane0 = (int)blockIdx.x * a.slice;
  const int n_live = max(0, min(a.slice, a.n_lanes - lane0));
  const int rv = 1 + 2 * (a.n_cg + a.n_wg);     // uint4s a record
  const size_t nl = (size_t)a.n_lanes;
  const size_t tile_words = kShared ? (size_t)a.rows * a.slice : 0;
  uint4* recs = (uint4*)(smem + tile_words);
  // a chunk's records and enabled words, each with one more slot: op i + 1
  // is read ahead past the chunk's last op without a bound
  int* s_en = (int*)(recs + (size_t)(a.chunk + 1) * rv);
  int* s_part = s_en + a.chunk + 1;
  int* s_wpart = s_part + a.chunk;        // kCond: [n_warps][chunk] ints
  int* s_list = s_part + a.chunk;         // else: [chunk + 2] ops that run
  uint8_t* s_pc = (uint8_t*)(s_list + a.chunk + 2);   // and [chunk][T] bytes
  __shared__ int s_nrun;
  const uint32_t tile_addr = shared_addr(smem), rec_addr = shared_addr(recs),
                 en_addr = shared_addr(s_en), list_addr = shared_addr(s_list),
                 pc_addr = shared_addr(s_pc) + (uint32_t)tid;
  if constexpr (kCond)
    if (tid < 2 * kMaxCluster) (&s_slot[0][0])[tid] = 0ull;

  // planes in: the tile to shared memory (tags to registers), or the rows
  // and tags to the output
  const int j0 = kShared ? tid * LPT : 0;       // the thread's first lane
  const int n_own = kShared ? max(0, min(LPT, n_live - j0)) : 0;
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
      tg[k] = k < n_own ? a.tag[lane0 + j0 + k] : 0u;
    base = smem;
    rs = a.slice;
  } else {
    copy_rows(a.out, a.planes, nl, lane0, n_live, a.lo, a.lo + a.rows, tid, T);
    for (int j = tid; j < n_live; j += T)
      a.out_tag[lane0 + j] = a.tag[lane0 + j];
    base = a.out + (size_t)a.lo * nl + lane0;
    rs = a.n_lanes;
  }
  // rows no op touches: straight through
  copy_rows(a.out, a.planes, nl, lane0, n_live, 0, a.lo, tid, T);
  copy_rows(a.out, a.planes, nl, lane0, n_live, a.lo + a.rows, a.n_bits, tid,
            T);

  // counts of ops p-1 .. p-4 that a later op branches on (0 before op 0,
  // so a condition reaching before the group never holds)
  int h1 = 0, h2 = 0, h3 = 0, h4 = 0;
  int seq = 0;                    // branched-on ops run so far
  for (int c0 = 0; c0 < a.n_ops; c0 += a.chunk) {
    const int n = min(a.chunk, a.n_ops - c0);
    for (int i = tid; i < n * rv; i += T)
      cp_async16(&recs[i], &a.recs[(size_t)c0 * rv + i]);
    if (a.enabled != nullptr)     // (waits here, under the records' copies)
      for (int i = tid; i < n; i += T) s_en[i] = a.enabled[c0 + i];
    cp_async_wait_all();
    __syncthreads();
    // rows to byte offsets in the tile (or the output): the odd vectors of
    // a record
    const uint32_t rb = 4u * (uint32_t)rs;
    for (int i = tid; i < n; i += T)
      for (int v = 1; v < rv; v += 2) {
        uint4& o = recs[(size_t)i * rv + v];
        o = make_uint4(o.x * rb, o.y * rb, o.z * rb, o.w * rb);
      }
    // every thread's records and tile words have landed; with C > 1 the
    // first also makes sure every CTA of the cluster has started (and
    // zeroed its slots) before any of them stores into another
    if constexpr (kCond) {
      if (C > 1)
        cluster_sync();
      else
        __syncthreads();
    } else {
      __syncthreads();
    }
    // op i runs on its record in registers while op i + 1's loads are in
    // flight
    const uint32_t rstep = 16u * (uint32_t)rv;
    if constexpr (kCond) {
      const bool all_on = a.enabled == nullptr;
      uint32_t rec = rec_addr;
      Rec<GC, GW> cur = load_rec<GC, GW>(rec, a.n_cg);
      bool en_cur = all_on || lds32(en_addr) != 0u;
#pragma unroll 2
      for (int i = 0; i < n; ++i, rec += rstep) {
        const Rec<GC, GW> nxt = load_rec<GC, GW>(rec + rstep, a.n_cg);
        const bool en_nxt =
            all_on || lds32(en_addr + 4u * (uint32_t)(i + 1)) != 0u;
        const uint32_t f = cur.f;
        // whether the op runs: the same in every thread
        const int cnd = (int)((f >> 2) & 7u);
        int prev = 1;
        if (cnd > 0) prev = cnd == 1 ? h1 : cnd == 2 ? h2 : cnd == 3 ? h3 : h4;
        const bool ex = en_cur && prev > 0;
        unsigned cnt = 0u;
        if (__builtin_expect(ex, 1)) {
          if constexpr (kShared) {
            cnt = op_body<LPT, GC, GW>(
                SharedRows{tile_addr + 4u * (uint32_t)j0}, tg, n_own, cur,
                rec, a.n_cg, a.n_wg);
          } else {
            for (int j = tid; j < n_live; j += T) {
              uint32_t t1[1] = {a.out_tag[lane0 + j]};
              cnt += op_body<1, GC, GW>(GlobalRows{base + j}, t1, 1, cur,
                                        rec, a.n_cg, a.n_wg);
              a.out_tag[lane0 + j] = t1[0];
            }
          }
          cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
        }
        if (lane == 0) s_wpart[warp * a.chunk + i] = (int)cnt;
        int total = 0;
        if (__builtin_expect(ex && ((f >> 6) & 1u), 0)) {  // branched on
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
        h4 = h3;
        h3 = h2;
        h2 = h1;
        h1 = total;
        cur = nxt;
        en_cur = en_nxt;
      }
    } else {
      // only the ops that run: with a mask, warp 0 lists the enabled ops
      // of the chunk (a ballot a warp of them), with two guard slots the
      // loop reads ahead
      int n_run = n;
      const bool listed = a.enabled != nullptr;
      if (listed) {
        if (warp == 0) {
          int m = 0;
          for (int i0 = 0; i0 < n; i0 += 32) {
            const bool on = i0 + lane < n && s_en[i0 + lane] != 0;
            const unsigned bits = __ballot_sync(0xFFFFFFFFu, on);
            if (on) s_list[m + __popc(bits & ((1u << lane) - 1u))] = i0 + lane;
            m += __popc(bits);
          }
          if (lane < 2) s_list[m + lane] = m > 0 ? s_list[m - 1] : 0;
          if (lane == 0) s_nrun = m;
        }
        __syncthreads();
        n_run = s_nrun;
      }
      int i_cur = listed ? s_list[0] : 0, i_nxt = listed ? s_list[1] : 1;
      Rec<GC, GW> cur =
          load_rec<GC, GW>(rec_addr + rstep * (uint32_t)i_cur, a.n_cg);
#pragma unroll 2
      for (int r = 0; r < n_run; ++r) {
        const int i_after =
            listed ? (int)lds32(list_addr + 4u * (uint32_t)(r + 2)) : r + 2;
        const Rec<GC, GW> nxt =
            load_rec<GC, GW>(rec_addr + rstep * (uint32_t)i_nxt, a.n_cg);
        const uint32_t rec = rec_addr + rstep * (uint32_t)i_cur;
        unsigned cnt = 0u;
        if constexpr (kShared) {
          cnt = op_body<LPT, GC, GW>(SharedRows{tile_addr + 4u * (uint32_t)j0},
                                     tg, n_own, cur, rec, a.n_cg, a.n_wg);
        } else {
          for (int j = tid; j < n_live; j += T) {
            uint32_t t1[1] = {a.out_tag[lane0 + j]};
            cnt += op_body<1, GC, GW>(GlobalRows{base + j}, t1, 1, cur, rec,
                                      a.n_cg, a.n_wg);
            a.out_tag[lane0 + j] = t1[0];
          }
        }
        // at most 32 * 4 set bits
        asm volatile("st.shared.u8 [%0], %1;"
                     :: "r"(pc_addr + (uint32_t)(i_cur * T)), "r"(cnt)
                     : "memory");
        cur = nxt;
        i_cur = i_nxt;
        i_nxt = i_after;
      }
    }
    // the chunk's counts: each CTA adds its warps' (or threads'), then CTA
    // 0 every CTA's (a cluster), or each CTA into the accumulator
    // (independent CTAs)
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      int s = 0;
      if constexpr (kCond) {
        for (int w = 0; w < n_warps; ++w) s += s_wpart[w * a.chunk + i];
      } else if (a.enabled == nullptr || s_en[i] != 0) {   // it ran
        const unsigned* q = (const unsigned*)(s_pc + (size_t)i * T);
        unsigned u = 0u;
        for (int v = 0; v < T / 4; ++v) u = __dp4a(q[v], 0x01010101u, u);
        s = (int)u;
        if (a.acc != nullptr && s != 0) atomicAdd(&a.acc[1 + c0 + i], s);
      }
      s_part[i] = s;
    }
    if constexpr (kCond) {
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
    } else {
      if (a.acc == nullptr)
        for (int i = tid; i < n; i += T) a.matched[c0 + i] = s_part[i];
      __syncthreads();            // frees the counts and records
    }
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
      if (k < n_own) a.out_tag[lane0 + j0 + k] = tg[k];
  }

  // independent CTAs: the last one to finish moves the counts to matched
  // and leaves the accumulator zero
  if constexpr (!kCond) {
    if (a.acc != nullptr) {
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(&a.acc[0], 1) == (int)gridDim.x - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (int p = tid; p < a.n_ops; p += T)
          a.matched[p] = atomicExch(&a.acc[1 + p], 0);
        if (tid == 0) atomicExch(&a.acc[0], 0);
      }
    }
  }
}

template <int LPT, int GC, int GW, bool kCond>
cudaError_t launch(const Args& a, int ctas, int threads, size_t smem,
                   cudaStream_t stream) {
  static size_t opted = 0;    // dynamic shared memory allowed so far
  auto kernel = op_group<LPT, GC, GW, kCond>;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (kCond) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    opted = smem;
  }
  if (a.cluster == 1) {
    kernel<<<ctas, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int GC, int GW, bool kCond>
cudaError_t dispatch_lpt(int lpt, const Args& a, int ctas, int threads,
                         size_t smem, cudaStream_t s) {
  switch (lpt) {
    case 0: return launch<0, GC, GW, kCond>(a, ctas, threads, smem, s);
    case 1: return launch<1, GC, GW, kCond>(a, ctas, threads, smem, s);
    case 2: return launch<2, GC, GW, kCond>(a, ctas, threads, smem, s);
    case 4: return launch<4, GC, GW, kCond>(a, ctas, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

// gc: the records' compare group (2 or 4 terms); the kernel keeps one
// group of 2, one of 4, or (n_cg > 1) two of 4 in registers; gw: the
// write group (1, 2 or 4 terms)
template <bool kCond>
cudaError_t dispatch(int gc, int n_cg, int gw, int lpt, const Args& a,
                     int ctas, int threads, size_t smem, cudaStream_t s) {
  const int kc = gc == 2 ? 2 : n_cg == 1 ? 4 : 8;
#define OP_GROUP_CASE(C, W)                                          \
  if (kc == C && gw == W)                                            \
    return dispatch_lpt<C, W, kCond>(lpt, a, ctas, threads, smem, s);
  OP_GROUP_CASE(2, 1) OP_GROUP_CASE(2, 2) OP_GROUP_CASE(2, 4)
  OP_GROUP_CASE(4, 1) OP_GROUP_CASE(4, 2) OP_GROUP_CASE(4, 4)
  OP_GROUP_CASE(8, 1) OP_GROUP_CASE(8, 2) OP_GROUP_CASE(8, 4)
#undef OP_GROUP_CASE
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

}  // namespace

// Runs one op group from (planes, tag) into (out, out_tag) and writes
// every matched[p], as ops.plan_conditional or ops.plan_unconditional
// planned it.  prm holds, on the host, n_bits, n_lanes, col_lo, rows (the
// table rows from col_lo on), n_ops, n_cg, n_wg, gc, gw (the records'
// groups of terms, as ops.device_group decoded them), then the plan:
// cluster (CTAs a cluster; 1 for independent CTAs), threads, slice (lanes
// a CTA), lpt (lanes a thread on the shared-memory path, 0 for the
// device-memory path), chunk (op records at a time), ctas (the grid) and
// whether the group is conditional.  enabled is a bool[n_ops] mask, or
// null (every op enabled).  acc is [1 + n_ops] int32 zeros for an
// unconditional group of more than one CTA (left zero again), else null.  Returns
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int ap_megakernel_run_group(
    const void* planes, void* out, const void* tag, void* out_tag,
    const void* records, const void* enabled, void* matched, void* acc,
    const int* prm, void* stream) {
  const int n_bits = prm[0], n_lanes = prm[1], col_lo = prm[2], rows = prm[3];
  const int n_ops = prm[4], n_cg = prm[5], n_wg = prm[6], gc = prm[7],
            gw = prm[8];
  const int cluster = prm[9], threads = prm[10], slice = prm[11],
            lpt = prm[12], chunk = prm[13], ctas = prm[14];
  const bool conditional = prm[15] != 0;
  const size_t rec_bytes = 16 * (size_t)(1 + 2 * (n_cg + n_wg));
  const size_t tile = lpt > 0 ? 4 * (size_t)rows * slice : 0;
  // a chunk's records, enabled words and CTA counts, and the counts of
  // each warp (conditional) or thread (one byte, unconditional)
  // (and, unconditional, the list of the ops that run, two guard slots)
  const size_t per_op =
      rec_bytes + (conditional ? 4 * (size_t)(2 + threads / 32)
                               : 12 + (size_t)threads);
  const size_t smem =
      tile + (size_t)chunk * per_op + rec_bytes + 4 + (conditional ? 0 : 8);
  const bool independent = !conditional && ctas > 1;
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > (conditional ? kMaxThreads : kMaxThreadsU) ||
      threads % 32 != 0 || chunk < 1 || n_cg < 1 || n_wg < 1 || n_ops < 1 ||
      (gc == 2 && n_cg != 1) || (gw < 4 && n_wg != 1) || ctas < 1 ||
      (conditional ? ctas != cluster : cluster != 1) ||
      (long long)ctas * slice < n_lanes ||
      (lpt > 0 && slice != lpt * threads) ||
      (!conditional && lpt == 0 && slice > threads) ||
      (independent != (acc != nullptr)) ||
      smem + kStaticSmem > (size_t)kSmemBytes)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint32_t*)planes, (uint32_t*)out, (const uint32_t*)tag,
               (uint32_t*)out_tag, n_bits, n_lanes, col_lo, rows,
               (const uint4*)records, (const uint8_t*)enabled, n_ops, n_cg,
               n_wg, (int32_t*)matched, (int32_t*)acc, cluster, slice, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (conditional)
    return (int)dispatch<true>(gc, n_cg, gw, lpt, a, ctas, threads, smem, s);
  return (int)dispatch<false>(gc, n_cg, gw, lpt, a, ctas, threads, smem, s);
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
