// Per-access MMU step of the port's translation pipelines, run over a
// block of the trace: the CUDA kernel behind
// repro_torch.kernels.mmu_step.blocked_scan.
//
// Replaces the TPU kernel src/repro/kernels/mmu_step.py:105
// `_blocked_scan_impl` (its pl.pallas_call at :162, entered by
// `blocked_scan` at :177).  That kernel is generic because it traces any
// step to a jaxpr; this one writes out the compositions of
// repro.core.mmu.make_step that the port simulates, each a template
// instantiation (Comp below):
//   radix      l1_tlb, l2_tlb, ptw             fills: ptw, l2_tlb, l1_tlb
//   victima    l1_tlb, l2_tlb, victima, ptw    fills: l2_tlb, victima, l1_tlb
//   l3tlb      l1_tlb, l2_tlb, l3_tlb, ptw     fills: ptw, l2_tlb, l3_tlb, l1_tlb
//   pom        l1_tlb, l2_tlb, pom, ptw        fills: ptw, l2_tlb, pom, l1_tlb
//   np         l1_tlb, l2_tlb, ptw2d           fills: ptw2d, l2_tlb, l1_tlb
//   victima_np l1_tlb, l2_tlb, victima, ptw2d  fills: l2_tlb, victima, l1_tlb
//   pom_np     l1_tlb, l2_tlb, pom, ptw2d      fills: ptw2d, l2_tlb, pom, l1_tlb
//   radix_collect  the radix composition with the Table-2 feature stream
//              (stages.fold.collect_feats) after the Stats fold
//   utopia     l1_tlb, l2_tlb, restseg, ptw    fills: ptw, l2_tlb, restseg, l1_tlb
//   utopia_victima  l1_tlb, l2_tlb, victima, restseg, ptw
//                                 fills: l2_tlb, victima, restseg, l1_tlb
//   revelator  l1_tlb, l2_tlb, rev, ptw        fills: ptw, l2_tlb, rev, l1_tlb
//   revelator_victima  l1_tlb, l2_tlb, rev, victima, ptw
//                                 fills: l2_tlb, victima, rev, l1_tlb
//   ladder_native  l1_tlb, l2_tlb, rev, victima, l3_tlb, pom, restseg, ptw
//                  fills: l2_tlb, victima, restseg, rev, pom, l3_tlb, l1_tlb
//   ladder_np  l1_tlb, l2_tlb, victima, pom, ptw2d
//                                 fills: l2_tlb, victima, pom, l1_tlb
// (ideal shadow paging runs the radix instantiation: its nested TLB is
// allocated and given its room in shared memory, and never touched;
// utopia_rs8 and utopia_rs32 run utopia's, the RestSeg ways a parameter).
// The last two are the ladders' base compositions (sim.systems.LADDERS:
// the native family of 28 systems, the nested one of 3), built with DYN:
// each lane reads a row of parameters (stages.base.Dyn) at launch start,
// its L2 TLB's and L2 cache's set mask and live ways, the RestSegs' ways,
// the two latencies and the gates of the victima, restseg, l3_tlb, pom and
// rev stages.  A structure keeps its allocated row stride and is read
// through the lane's view (assoc.lookup_dyn: the set index masked, every
// ballot, argmin and SRRIP pick over the live ways); a gated-off stage
// neither charges cycles nor moves a line or a counter, as the reference's
// gated step, and a radix lane runs Victima's fill order with Victima's
// counter slot 1 redirected onto the demand page (stages.victima).
// It must equal the plain PyTorch step (repro_torch.core.mmu.make_step)
// bit for bit, so every operation follows that code's order; the
// comments name the reference function each block mirrors.
//
// Design.  One warp (a block of 32 threads) per lane; thread w owns way w
// of every row.  A system's launch has a block on each of its 11 lanes'
// SMs; a ladder's has hundreds of lanes, several blocks an SM, as many as
// their registers and shared memory allow.  The Pallas kernel kept the lane's
// state resident in VMEM across its grid; here it stays resident in the
// block's dynamic shared memory for the whole launch.  At launch start
// the warp copies the lane's structures in, packing the L2 cache's
// valid bit, block type and RRPV into one byte per way and its reuse
// count into an 8-bit saturating shadow (the count is only ever read as
// min(reuse, 21)); at launch end it unpacks them back into the state
// tensors, which keep their layout between launches.  The exact int32
// reuse stays in device memory, written by stores and by atomicAdds whose
// result is unused, and never read during a launch.  The scalars (`now`,
// the Stats, the hierarchy and live-block counts) live in registers for
// the whole launch.  Where the structures go is the placement, a pure
// function of the geometry (mmu_step.placement): the histograms and the
// small LRU arrays (L1 TLBs, PWCs, L1D, and the nested TLB of a
// virtualized configuration) always, then the L2 cache if it
// fits in the 232,448 bytes a block may have, then the L2 TLB if it
// still fits.  A structure that does not fit is used in device memory
// (the L2 cache's packed bytes in a scratch tensor); the step code is one
// template, instantiated per placement.  The L3 (288 KiB a lane at
// Table 3), the PTW-CP counters (4 MiB), the host-page counters (32 KiB)
// and the 64K-entry L3 TLB and POM-TLB shadow (576 KiB each, read one
// row at a time as a large L2 TLB is) always stay in device memory, and
// so do the structures of the compositions added last, whose
// instantiations run only with the rest of the lane in shared memory
// (which leaves them no room there): Utopia's RestSegs (8192 and 256
// sets of up to 32 ways, 1.2 MB a lane at 16 ways), Revelator's
// signature table and its enrolled-page shadow (4096 x 16, 832 KiB), the
// Table-2 feature table (2^20 entries of 13 bytes, 13 MiB a lane; one
// thread reads an access's entry at the start of the access and writes
// it at the end), and the RestSeg and verification-walk histograms (one
// thread's fire-and-forget atomicAdd a probe).
//
// Every row is read once into registers, one way a thread; a touch or an
// insert on the same row works on those registers and stores only the
// ways it changes, each by the thread that owns the way (the owner's
// stores are predicated, not branched around).  Way w of a row is owned
// by thread w, or by thread 16 + w while the row is the second of a pair
// (below), and a histogram bucket by one fixed thread; a __syncwarp
// separates the parts of an access whose owners differ (before the data
// access, before its background lines, and at the end of the access,
// after thread 0 wrote the PTW-CP counters that every thread reads).
// Warp-uniform values travel by ballot, shuffle and redux.
// argmin and argmax are one __reduce_{min,max}_sync, then
// __ballot_sync(v == m) and __ffs for the lowest index, the reference's
// tie rule.  Row loads have no branch around them (threads past a row's
// ways read its last way and are masked out), so loads that nothing
// upstream feeds are in flight together: the rows of the L1 TLBs, the L2
// TLB, the L1D, the PWCs, the Victima probe and the L3 TLB or POM shadow
// at the start of the access, the next trace row during this one, the PTW-CP counter entries
// right after the L2-TLB lookup (Victima: the vpn's and the L2-TLB
// victim's, whose way is fixed once the lookup has touched the row) or
// at the start of the access (radix), the background lines' L3 rows at
// the start of the data access, and each L3 row before the L2 insert
// that goes with it.  Where two operations on different sets commute
// (the two background lines; the data line's L2 insert and its
// prefetch's) and the rows have at most 16 ways, each half-warp does
// one, so both share their instructions.
//
// Bound.  Each access is still a chain of dependent steps: a row's tag
// compare decides the next row.  A step on a shared-memory row costs a
// shared load, a ballot or a redux and the arithmetic between them; a
// step on an L3 row or a counter adds an L2-cache hit of the card.  With
// one warp an SM there is nothing to hide either behind (a ladder's few
// warps an SM hide little of each other's), so the kernel
// is bound by the latency of that chain of loads and dependent
// instructions; the card's bytes and operations are far from their
// rates, and 121 of 132 SMs are idle at 11 lanes.  chip_smoke.py's
// latency_floor counts the chain's load rounds from a run's Stats and
// charges each the measured latency of the place that holds its row
// under the launch's placement (shared memory, L1 or L2;
// csrc/load_latency.cu); the instructions between them are not counted.
//
// Exactness.  int32 arithmetic that wraps in the reference (the
// background-line hash, hash_h, Revelator's signature) is done in
// uint32, and the uint16 feature counters wrap as uint16; float sums use __fadd_rn /
// __fmul_rn in float (never double), one access at a time, and the file
// is compiled with -fmad=false.  The pack step __trap()s on an RRPV or a
// block type outside 0..3 or a negative reuse count instead of
// truncating it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int BT_DATA = 0, BT_TLB4 = 1, BT_TLB2 = 2, BT_NTLB = 3;
constexpr int RRIP_MAX = 3;
constexpr int REUSE_BUCKETS = 22;
constexpr int WALK_HIST_BUCKETS = 64;
constexpr int PWC_LAT = 2;
constexpr int FREQ_MAX = 7, COST_MAX = 15;
constexpr int BOX_COST_LO = 1, BOX_COST_HI = 12;
constexpr int BOX_FREQ_LO = 1, BOX_FREQ_HI = 7;
// page-table lines: level l (0 = PML4 .. 3 = leaf) of a 4K vpn v is line
// LINE_B + (3 - l) * LINE_W + ((v >> 9 * (3 - l)) >> 3); the host page
// table's (nested paging, keyed by the guest-physical page) lies
// HOST_LINES above it, the POM-TLB's lines POM_LINES above LINE_B
constexpr int LINE_B = 1 << 29, LINE_W = 1 << 22;
constexpr int HOST_LINES = 4 * LINE_W, POM_LINES = 8 * LINE_W;
// stages.base.hash_h's multiplier, -1640531535 as uint32 (the int32
// product wraps in the reference; signed overflow is undefined here)
constexpr uint32_t HASH_MUL = 2654435761u;
// a composition: bit 0 Victima, 1 the L3 TLB, 2 the POM-TLB, 3 the
// nested (2-D) walk, 4 the Table-2 feature stream, 5 Utopia's RestSegs,
// 6 Revelator; mmu_step.COMPOSITIONS holds the same codes
constexpr int C_VICTIMA = 1, C_L3TLB = 2, C_POM = 4, C_NESTED = 8;
constexpr int C_COLLECT = 16, C_RESTSEG = 32, C_REV = 64;
// page_table.RESTSEG4_BASE and RESTSEG2_BASE, above LINE_B
constexpr int RESTSEG4_LINES = 9 * LINE_W, RESTSEG2_LINES = 10 * LINE_W;
constexpr uint32_t BG_MUL = static_cast<uint32_t>(-1640531527);
constexpr uint32_t BG_SALT0 = static_cast<uint32_t>(-1640531527);
constexpr uint32_t BG_SALT1 = static_cast<uint32_t>(-2048144789);
constexpr uint32_t BG_MASK = (1u << 26) - 1;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
// a ladder lane's parameters (stages.base.Dyn): the L2 TLB's set mask,
// ways and latency, the L3 TLB's latency, the L2 cache's set mask and
// ways, the RestSegs' ways, then the stage gates
enum {
  DYN_L2TLB_MASK, DYN_L2TLB_WAYS, DYN_L2TLB_LAT, DYN_L3TLB_LAT, DYN_L2_MASK,
  DYN_L2_WAYS, DYN_RS_WAYS, DYN_VICTIMA, DYN_UTOPIA, DYN_L3TLB, DYN_POM,
  DYN_REV, NDYN
};

}  // namespace

// ---------------------------------------------------------------- ABI
// Mirrored field for field by ctypes Structures in mmu_step.py; every
// array pointer is the lane-0 base of a [lanes, ...] contiguous tensor.
struct AssocP {
  int32_t* tags;
  uint8_t* valid;
  int32_t* meta;
  int32_t sets, ways;
};
struct L2P {
  int32_t* tags;
  uint8_t* valid;
  int32_t *rrpv, *btype, *reuse, *hist_data, *hist_tlb;
  int32_t *n_tlb4, *n_tlb2, *n_ntlb;
  int32_t sets, ways;
};
struct CountersP {
  uint8_t *freq, *cost;
  int32_t n, pad;
};
struct HierCountP {
  int32_t *n_l2_access, *n_l2_miss, *n_l3_access, *n_l3_trans;
};
struct StatsP {
  int32_t *n_access, *n_l1tlb_hit, *n_l2tlb_hit, *n_l2tlb_miss,
      *n_victima_hit, *n_l3tlb_hit, *n_pom_hit, *n_demand_ptw, *n_bg_ptw,
      *n_host_ptw, *n_ntlb_hit, *n_nvictima_hit;
  float *sum_trans_cyc, *sum_l2miss_cyc, *sum_data_cyc, *sum_walk_cyc;
  int32_t* hist_walk;
  float *sum_tlb4_live, *sum_tlb2_live;
  int32_t *n_restseg_hit, *n_restseg_miss, *n_restseg_mig,
      *n_restseg_conflict;
  float* sum_restseg_cyc;
  int32_t* hist_restseg;
  int32_t *n_rev_hit, *n_rev_mispred, *n_rev_enroll;
  float* sum_rev_verify_cyc;
  int32_t* hist_rev_verify;
};
struct FeatsP {  // the Table-2 feature table, [lanes, n] each
  uint16_t *n_access, *n_l1_miss, *n_l2_miss, *n_walk;
  float* walk_cyc;
  uint8_t* is2m;
  int32_t n, pad;
};
struct TraceP {
  int32_t* vpn;
  uint8_t* is2m;
  int32_t* line;
  float* ipa;
};
// Offsets in bytes into the block's dynamic shared memory: the int32
// arrays first (histograms, LRU tags and stamps, L2 tags), then the
// bytes (LRU valid, L2 packed and reuse shadow).  plan() below computes
// them from the geometry; mmu_step.placement computes the total in
// Python.
struct Plan {
  int hist, lru_i32[8], l2_tag, lru_u8[8], l2_pk, l2_r8, total;
};
struct Params {
  AssocP l1d4, l1d2, l2tlb, pml4, pdp, pd, l1d, l3;
  AssocP l3tlb, pom, ntlb;  // sized 1 where the configuration has none
  L2P l2;
  CountersP pc4, pc2, pch;
  HierCountP hier;
  StatsP stats;
  TraceP trace;
  int32_t* now;
  int32_t lanes, t0, t1;
  int32_t comp;  // the composition's code (C_* bits)
  int32_t virt;  // the plan gives the nested TLB room in shared memory
  int32_t tlb_aware, use_ptwcp;
  float pressure_mpki, bypass_l2mpki;
  int32_t l1tlb_lat, l2tlb_lat, l3tlb_lat;
  int32_t pom_mask;  // pom_sets * pom_ways - 1
  int32_t lat_l1d, lat_l2, lat_l3, lat_dram;
  int32_t pad0;
  int64_t* prof;     // [lanes, PROF_SLOTS] cycles, read only under MMU_PROFILE
  uint8_t* l2_pack;  // [lanes, 2, sets * ways]: the L2 cache's packed bytes
                     // and reuse shadow when it is not in shared memory
  int32_t l2_shared, l2tlb_shared;  // the placement (1 = shared memory)
  int32_t smem_bytes;               // its bytes, as mmu_step.placement says
  int32_t pad;
  // Utopia's RestSegs and Revelator's signature table with its
  // enrolled-page shadow (device memory; sized 1 where absent)
  AssocP restseg4, restseg2, rev;
  int32_t* rev_vpn;
  FeatsP feats;  // sized 1 unless the configuration collects
  int32_t rev_lat, rev_sig_bits;
  // a ladder launch's per-lane parameters, [lanes, NDYN] (the DYN_* order
  // below; mmu_step.DYN_PARAMS), or null for a launch of one system
  int32_t* dyn;
  // plan(*this), filled in by mmu_step_launch: the kernel reads its
  // offsets here, so a pointer it needs again costs one constant load
  // (the compiler rematerialises the pointers in the loop rather than
  // hold them in registers; from the geometry, that is a chain of
  // multiplies on every access)
  Plan plan;
};

namespace {

// per-access clock64() stamps, compiled in only under MMU_PROFILE: the
// cycles of each stage, summed over the launch's accesses (thread 0's
// clock), then the launch's loop cycles and its accesses
enum { ST_TLB, ST_PROBE, ST_WALK, ST_FILL, ST_DATA, ST_STATS, PROF_SLOTS = 8 };
#ifdef MMU_PROFILE
#define PROF_BEGIN() \
  long long prof_cyc[6] = {0, 0, 0, 0, 0, 0}; \
  const long long prof_t0 = clock64(); \
  long long prof_t = prof_t0
#define PROF_STAMP(k) do { \
    const long long c_ = clock64(); prof_cyc[k] += c_ - prof_t; prof_t = c_; \
  } while (0)
#define PROF_END(p, b, n) do { \
    if (threadIdx.x == 0) { \
      int64_t* o_ = (p).prof + static_cast<size_t>(b) * PROF_SLOTS; \
      for (int k_ = 0; k_ < 6; ++k_) o_[k_] += prof_cyc[k_]; \
      o_[6] += clock64() - prof_t0; \
      o_[7] += (n); \
    } \
  } while (0)
#else
#define PROF_BEGIN() do { } while (0)
#define PROF_STAMP(k) do { } while (0)
#define PROF_END(p, b, n) do { } while (0)
#endif

__device__ __forceinline__ int lane() { return threadIdx.x; }

// jnp.argmax of a bool row: the first set way, 0 when none is set
__device__ __forceinline__ int first_way(unsigned m) {
  return m ? __ffs(m) - 1 : 0;
}

// lowest-index argmin over the active ways: one redux, one ballot
__device__ __forceinline__ int argmin_way(int v, bool act) {
  const int m = __reduce_min_sync(kFull, act ? v : INT_MAX);
  return __ffs(__ballot_sync(kFull, act && v == m)) - 1;
}

// ------------------------------------------------------ LRU arrays
// The L1 TLBs, the L2 TLB, the PWCs and the L1D: tag, LRU stamp and valid
// per entry, in shared memory or (an L2 TLB too large for it) in the
// state tensors themselves.
// `sets` and `ways` are the live geometry, `stride` the allocated ways
// of a row: they differ only in a ladder instantiation (DYN), where a lane
// uses a view of its structure (assoc.lookup_dyn) and `sets` is its set
// mask plus one.
struct Lru {
  int32_t* tag;
  int32_t* stamp;
  uint8_t* valid;
  int sets, ways, stride;
};

// A row in registers: thread w holds way w.  Threads past the row's ways
// read the last way too (no branch around a load, so the loads of several
// rows are in flight together and nothing waits for them before their
// first use) and are masked out by `act` wherever the row is used.
__device__ __forceinline__ int row_index(int key, int sets, int ways,
                                         int stride) {
  return (key & (sets - 1)) * stride + min(lane(), ways - 1);
}

struct LruRow {
  int i;  // this thread's entry
  bool act;
  int tag, stamp;
  unsigned v;  // the valid byte as loaded
  __device__ __forceinline__ bool valid() const { return act && v != 0; }
};

__device__ __forceinline__ LruRow load_row(const Lru& a, int key) {
  LruRow r;
  r.act = lane() < a.ways;
  r.i = row_index(key, a.sets, a.ways, a.stride);
  r.tag = a.tag[r.i];
  r.stamp = a.stamp[r.i];
  r.v = a.valid[r.i];
  return r;
}

// assoc.lookup: the ways that hold `key`
__device__ __forceinline__ unsigned hits(const LruRow& r, int key) {
  return __ballot_sync(kFull, r.valid() & (r.tag == key));
}

// assoc.touch: stamp way `w`
__device__ __forceinline__ void touch(const Lru& a, LruRow& r, int w,
                                      int now) {
  if (lane() == w) {
    r.stamp = now;
    a.stamp[r.i] = now;
  }
}

// assoc.insert_lru's victim: the first way of least stamp (invalid = -1)
__device__ __forceinline__ int lru_victim(const LruRow& r) {
  return argmin_way(r.valid() ? r.stamp : -1, r.act);
}

__device__ __forceinline__ void fill(const Lru& a, LruRow& r, int w, int key,
                                     int now) {
  if (lane() == w) {
    r.tag = key;
    r.v = 1;
    r.stamp = now;
    a.tag[r.i] = key;
    a.valid[r.i] = 1;
    a.stamp[r.i] = now;
  }
}

// assoc.insert_lru
__device__ __forceinline__ void insert_lru(const Lru& a, LruRow& r, int key,
                                           int now, bool en) {
  if (en) fill(a, r, lru_victim(r), key, now);
}

// assoc.insert_lru, returning evicted_valid & en (a RestSeg conflict)
__device__ __forceinline__ bool insert_lru_evicts(const Lru& a, LruRow& r,
                                                  int key, int now, bool en) {
  if (!en) return false;
  const int w = lru_victim(r);
  const bool ev = (__ballot_sync(kFull, r.valid()) >> w) & 1u;
  fill(a, r, w, key, now);
  return ev;
}

// --------------------------------------------------------- L2 cache
// pk: valid (bit 0), btype (bits 1-2), rrpv (bits 3-4); r8: min(reuse,
// 255).  tag, pk and r8 in shared memory or (a large L2) in device memory;
// reuse, the exact count, always in device memory.
struct L2c {
  int32_t* tag;
  uint8_t* pk;
  uint8_t* r8;
  int32_t* reuse;
  int32_t* hist_data;  // shared memory; bucket b owned by thread b
  int32_t* hist_tlb;
  int sets, ways, stride;  // as an Lru's
};

struct L2Row {
  int i;
  bool act;
  int tag;
  unsigned pk, r8;
};

__device__ __forceinline__ unsigned pack(bool valid, int bt, int rrpv) {
  return static_cast<unsigned>(valid) | (bt << 1) | (rrpv << 3);
}

// A pair of rows, one a half-warp (ways <= 16): thread 16h + w holds way
// w of the row of keys[h].
__device__ __forceinline__ int half() { return lane() >> 4; }

__device__ __forceinline__ int pair_index(int key, int sets, int ways,
                                          int stride) {
  return (key & (sets - 1)) * stride + min(lane() & 15, ways - 1);
}

__device__ __forceinline__ L2Row load_row(const L2c& c, int key,
                                          bool paired = false) {
  L2Row r;
  r.act = (paired ? lane() & 15 : lane()) < c.ways;
  r.i = paired ? pair_index(key, c.sets, c.ways, c.stride)
               : row_index(key, c.sets, c.ways, c.stride);
  r.tag = c.tag[r.i];
  r.pk = c.pk[r.i];
  r.r8 = c.r8[r.i];
  return r;
}

// caches.l2_lookup: the ways that hold (`key`, `bt`)
__device__ __forceinline__ unsigned hits(const L2Row& r, int key, int bt) {
  return __ballot_sync(kFull, r.act & (r.tag == key) &
                                  ((r.pk & 7u) == pack(true, bt, 0)));
}

// caches.l2_touch of way `w`
__device__ __forceinline__ void l2_touch(const L2c& c, L2Row& r, int w,
                                         bool pressure, bool tlb_aware) {
  if (lane() == w) {
    const int bt = (r.pk >> 1) & 3;
    const int dec = (bt != BT_DATA && pressure && tlb_aware) ? 3 : 1;
    const int rr = max(static_cast<int>(r.pk >> 3) - dec, 0);
    r.pk = (r.pk & 7u) | (rr << 3);
    r.r8 = min(r.r8 + 1, 255u);
    c.pk[r.i] = r.pk;
    c.r8[r.i] = r.r8;
    atomicAdd(c.reuse + r.i, 1);  // result unused: a fire-and-forget RED
  }
}

struct Live {
  int n4, n2, nn;
  __device__ __forceinline__ void add(int bt, int d) {
    n4 += bt == BT_TLB4 ? d : 0;
    n2 += bt == BT_TLB2 ? d : 0;
    nn += bt == BT_NTLB ? d : 0;
  }
};

// caches.l2_insert (+ _account_evict on the row read before the insert),
// with assoc.srrip_age_and_pick and srrip_victim_tlb_aware (paper
// Listing 1).  The lowest way of largest (valid ? aged : RRIP_MAX + 1) is
// the victim; that largest value is max(mx, RRIP_MAX) for mx the largest
// (valid ? rrpv : RRIP_MAX + 1), so one redux finds both.
__device__ __forceinline__ void l2_insert(const L2c& c, L2Row& r, int key,
                                          int bt, bool pressure,
                                          bool tlb_aware, Live& live) {
  const bool v = r.act && (r.pk & 1u);
  const int btype = (r.pk >> 1) & 3;
  const int rr = r.pk >> 3;
  const int mx = __reduce_max_sync(kFull, r.act ? (v ? rr : RRIP_MAX + 1)
                                                : INT_MIN);
  const int aged = v ? rr + max(RRIP_MAX - mx, 0) : rr;
  int w = __ffs(__ballot_sync(kFull, r.act && (v ? aged : RRIP_MAX + 1) ==
                                         max(mx, RRIP_MAX))) - 1;
  if (tlb_aware) {
    // Listing 1: under pressure, a valid TLB victim gives way to the
    // first valid data block at RRIP_MAX
    const unsigned alt =
        __ballot_sync(kFull, v && btype == BT_DATA && aged >= RRIP_MAX);
    const unsigned vt = __ballot_sync(kFull, v && btype != BT_DATA);
    if (pressure && ((vt >> w) & 1u) && alt != 0) w = __ffs(alt) - 1;
  }
  // the evicted way's fields, for its histogram bucket (owned by thread
  // `bucket`) and the live counts; then the stores, each predicated on
  // the thread that owns the way
  const unsigned old = __shfl_sync(kFull, r.pk | (r.r8 << 8), w);
  const bool evict = old & 1u;
  const int obt = (old >> 1) & 3;
  const int bucket = min(static_cast<int>(old >> 8), REUSE_BUCKETS - 1);
  int32_t* const hist = obt == BT_DATA ? c.hist_data : c.hist_tlb;
  if (evict && lane() == bucket) hist[bucket] += 1;
  live.add(obt, evict ? -1 : 0);
  live.add(bt, 1);
  const int ins = (bt != BT_DATA && pressure && tlb_aware) ? 0 : RRIP_MAX - 1;
  const bool me = lane() == w;
  const unsigned pk = me ? pack(true, bt, ins) : (r.pk & 7u) | (aged << 3);
  if (me || (r.act && aged != rr)) c.pk[r.i] = pk;
  if (me) c.tag[r.i] = key;
  if (me) c.r8[r.i] = 0;
  if (me) c.reuse[r.i] = 0;
}

// ------------------------------------------------------------- L3
// SRRIP in device memory: tag, valid, meta = RRPV
struct L3c {
  int32_t* tag;
  uint8_t* valid;
  int32_t* meta;
  int sets, ways;
};

struct L3Row {
  int i;
  bool act;
  int tag, meta;
  unsigned v;  // the valid byte as loaded
  __device__ __forceinline__ bool valid() const { return act && v != 0; }
};

__device__ __forceinline__ L3Row load_row(const L3c& a, int key,
                                          bool paired = false) {
  L3Row r;
  r.act = (paired ? lane() & 15 : lane()) < a.ways;
  r.i = paired ? pair_index(key, a.sets, a.ways, a.ways)
               : row_index(key, a.sets, a.ways, a.ways);
  r.tag = a.tag[r.i];
  r.meta = a.meta[r.i];
  r.v = a.valid[r.i];
  return r;
}

// caches.l3_access, enabled: promote on a hit; on a miss age the row and
// insert (victim as in l2_insert)
__device__ __forceinline__ bool l3_access(const L3c& a, L3Row& r, int key) {
  const bool valid = r.valid();
  const unsigned m = __ballot_sync(kFull, valid & (r.tag == key));
  if (m != 0) {
    if (lane() == __ffs(m) - 1 && r.meta != 0) a.meta[r.i] = 0;
    return true;
  }
  const int mx = __reduce_max_sync(kFull, r.act ? (valid ? r.meta
                                                         : RRIP_MAX + 1)
                                                : INT_MIN);
  const int aged = valid ? r.meta + max(RRIP_MAX - mx, 0) : r.meta;
  const int w = __ffs(__ballot_sync(
      kFull, r.act && (valid ? aged : RRIP_MAX + 1) == max(mx, RRIP_MAX))) - 1;
  const bool me = lane() == w;
  if (me || (r.act && aged != r.meta))
    a.meta[r.i] = me ? RRIP_MAX - 1 : aged;
  if (me) a.tag[r.i] = key;
  if (me) a.valid[r.i] = 1;
  return false;
}

// ------------------------------------------------------ paired rows
// Two operations on rows of different sets commute: the two background
// lines of an access (an L3 access each, then an L2 insert where it
// missed), and the data line's L2 insert and its prefetch's.  With at
// most 16 ways a row, each half-warp does one, and the reductions of both
// rows share their instructions.  `key` is this half's line.

// caches.l3_access of both lines: bit h of the result is line h's hit
__device__ __forceinline__ unsigned l3_access_pair(const L3c& a, L3Row& r,
                                                   int key) {
  const int hs = 16 * half(), w = lane() & 15;
  const bool valid = r.valid();
  const unsigned m = __ballot_sync(kFull, valid & (r.tag == key));
  const unsigned mh = (m >> hs) & 0xffffu;
  const unsigned hit = ((m & 0xffffu) != 0) | (((m >> 16) != 0) << 1);
  if (mh != 0 && w == __ffs(mh) - 1 && r.meta != 0) a.meta[r.i] = 0;
  if (hit == 3) return hit;
  const int eff = r.act ? (valid ? r.meta : RRIP_MAX + 1) : INT_MIN;
  const int mx0 = __reduce_max_sync(kFull, hs == 0 ? eff : INT_MIN);
  const int mx1 = __reduce_max_sync(kFull, hs != 0 ? eff : INT_MIN);
  const int mx = hs ? mx1 : mx0;
  const int aged = valid ? r.meta + max(RRIP_MAX - mx, 0) : r.meta;
  const unsigned c = __ballot_sync(
      kFull, r.act & ((valid ? aged : RRIP_MAX + 1) == max(mx, RRIP_MAX)));
  const bool miss = mh == 0;
  const bool me = miss && w == __ffs((c >> hs) & 0xffffu) - 1;
  if (me || (miss && r.act && aged != r.meta))
    a.meta[r.i] = me ? RRIP_MAX - 1 : aged;
  if (me) a.tag[r.i] = key;
  if (me) a.valid[r.i] = 1;
  return hit;
}

// caches.l2_insert of a data block for line h, for each bit h in `en`.
// The packed RRPVs lie in 0..3, so one OR-reduction of one-hot bits (a
// byte a half) gives both rows' largest (valid ? rrpv : RRIP_MAX + 1).
__device__ __forceinline__ void l2_insert_pair(const L2c& c, L2Row& r,
                                               int key, unsigned en,
                                               bool pressure, bool tlb_aware,
                                               Live& live) {
  const int h = half(), hs = 16 * h;
  const bool v = r.act && (r.pk & 1u);
  const int btype = (r.pk >> 1) & 3;
  const int rr = r.pk >> 3;
  const unsigned bits = __reduce_or_sync(
      kFull, r.act ? (1u << (v ? rr : RRIP_MAX + 1)) << (8 * h) : 0u);
  const int mx = 31 - __clz((bits >> (8 * h)) & 0xffu);
  const int aged = v ? rr + max(RRIP_MAX - mx, 0) : rr;
  const unsigned cand = __ballot_sync(
      kFull, r.act & ((v ? aged : RRIP_MAX + 1) == max(mx, RRIP_MAX)));
  int w0 = __ffs(cand & 0xffffu) - 1, w1 = __ffs(cand >> 16) - 1;
  if (tlb_aware) {
    const unsigned alt =
        __ballot_sync(kFull, v && btype == BT_DATA && aged >= RRIP_MAX);
    const unsigned vt = __ballot_sync(kFull, v && btype != BT_DATA);
    if (pressure && ((vt >> w0) & 1u) && (alt & 0xffffu) != 0)
      w0 = __ffs(alt & 0xffffu) - 1;
    if (pressure && ((vt >> (16 + w1)) & 1u) && (alt >> 16) != 0)
      w1 = __ffs(alt >> 16) - 1;
  }
  const unsigned x = r.pk | (r.r8 << 8);
  const unsigned old[2] = {__shfl_sync(kFull, x, w0),
                           __shfl_sync(kFull, x, 16 + w1)};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool evict = ((en >> k) & 1u) && (old[k] & 1u);
    const int obt = (old[k] >> 1) & 3;
    const int bucket = min(static_cast<int>(old[k] >> 8), REUSE_BUCKETS - 1);
    int32_t* const hist = obt == BT_DATA ? c.hist_data : c.hist_tlb;
    if (evict && lane() == bucket) hist[bucket] += 1;
    live.add(obt, evict ? -1 : 0);
  }
  const bool mine = (en >> h) & 1u;
  const bool me = mine && (lane() & 15) == (h ? w1 : w0);
  const unsigned pk = me ? pack(true, BT_DATA, RRIP_MAX - 1)
                         : (r.pk & 7u) | (aged << 3);
  if (me || (mine && r.act && aged != rr)) c.pk[r.i] = pk;
  if (me) c.tag[r.i] = key;
  if (me) c.r8[r.i] = 0;
  if (me) c.reuse[r.i] = 0;
}

// ------------------------------------------------------------ lane
struct Lane {
  Lru l1d4, l1d2, l2tlb, pml4, pdp, pd, l1d;
  Lru l3tlb, pom;  // device memory
  Lru rs4, rs2, rev;  // device memory
  int32_t* rev_vpn;   // the signature table's enrolled page, per entry
  Lru ntlb;        // shared memory (when the configuration is virtualized)
  L2c l2;
  L3c l3;
  int32_t* hist_walk;  // shared memory; bucket b owned by thread b % 32
  uint8_t *f4, *c4, *f2, *c2, *fh, *ch;
  int n4, n2, nh;
  bool tlb_aware, use_ptwcp;
  int lat_l1d, lat_l2, lat_l3, lat_dram;
  // registers for the whole launch
  Live live;
  int n_l2_access, n_l2_miss, n_l3_access, n_l3_trans;
};

__device__ __forceinline__ int miss_cycles(const Lane& L, bool hit2,
                                           bool hit3) {
  return hit2 ? L.lat_l2 : hit3 ? L.lat_l3 : L.lat_l3 + L.lat_dram;
}

// caches.access_pte, enabled: the L3 row is loaded before the L2 insert,
// which does not need it; `bt` types the line (BT_TLB4 for POM-TLB lines)
__device__ __forceinline__ int access_pte(Lane& L, int line, bool pressure,
                                          bool* dram, int bt = BT_DATA) {
  L2Row r = load_row(L.l2, line);
  const unsigned m = hits(r, line, bt);
  if (m != 0) {
    l2_touch(L.l2, r, __ffs(m) - 1, pressure, L.tlb_aware);
    *dram = false;
    return L.lat_l2;
  }
  L3Row r3 = load_row(L.l3, line);
  l2_insert(L.l2, r, line, bt, pressure, L.tlb_aware, L.live);
  const bool hit3 = l3_access(L.l3, r3, line);
  L.n_l3_access += 1;
  L.n_l3_trans += 1;
  *dram = !hit3;
  return miss_cycles(L, false, hit3);
}

// the PWC rows of a walk of 4K vpn `vpn4k` (a 2M page's is its first 4K
// vpn): the keys are vpn4k >> 27, >> 18 and >> 9 at either size
struct PwcRows {
  LruRow r4, r3, r2;
};

__device__ __forceinline__ PwcRows pwc_rows(const Lane& L, int vpn4k) {
  return {load_row(L.pml4, vpn4k >> 27), load_row(L.pdp, vpn4k >> 18),
          load_row(L.pd, vpn4k >> 9)};
}

// page_table.walk, enabled: PWCs probed before the walk, `start` fixed
// before the fills
__device__ __forceinline__ int walk(Lane& L, PwcRows& w, int vpn4k,
                                    bool is2m, int now, bool pressure,
                                    int* n_dram) {
  const int k4 = vpn4k >> 27, k3 = vpn4k >> 18, k2 = vpn4k >> 9;
  const bool hit4 = hits(w.r4, k4) != 0;
  const bool hit3 = hits(w.r3, k3) != 0;
  const bool hit2 = hits(w.r2, k2) != 0 && !is2m;
  int start = hit2 ? 3 : hit3 ? 2 : hit4 ? 1 : 0;
  if (is2m) start = min(start, 2);
  const int n_levels = is2m ? 3 : 4;
  int cycles = PWC_LAT;
  *n_dram = 0;
#pragma unroll
  for (int lv = 0; lv < 4; ++lv) {
    if (lv >= start && lv < n_levels) {
      const int up = 3 - lv;
      bool d;
      cycles += access_pte(
          L, LINE_B + up * LINE_W + ((vpn4k >> 9 * up) >> 3), pressure, &d);
      *n_dram += d;
    }
  }
  insert_lru(L.pml4, w.r4, k4, now, start <= 0);
  insert_lru(L.pdp, w.r3, k3, now, start <= 1);
  insert_lru(L.pd, w.r2, k2, now, start <= 2 && !is2m);
  return cycles;
}

// caches.l2_retag_to_tlb, enabled
__device__ __forceinline__ void retag_to_tlb(Lane& L, int key, int bt,
                                             bool pressure) {
  L2Row r = load_row(L.l2, key);
  if (hits(r, key, bt) == 0)
    l2_insert(L.l2, r, key, bt, pressure, L.tlb_aware, L.live);
}

// caches.access_data; `r1` is the L1D row of `line`, loaded at the start
// of the access (nothing before this touches the L1D)
__device__ __forceinline__ int access_data(Lane& L, LruRow& r1, int line,
                                           int now, bool pressure) {
  // the two background lines (int32 wraparound of the reference as
  // uint32); when they can be paired (see l3_access_pair) their L3 rows
  // are loaded first, and again if the data line's L3 access changed one
  __syncwarp(kFull);  // rows below are owned by half-warps too
  const uint32_t h = static_cast<uint32_t>(now) * BG_MUL;
  const int bg0 = static_cast<int>((h ^ BG_SALT0) & BG_MASK);
  const int bg1 = static_cast<int>((h ^ BG_SALT1) & BG_MASK);
  const int smask = L.l3.sets - 1;
  const bool paired = L.l3.ways <= 16 && L.l2.ways <= 16 &&
                      ((bg0 ^ bg1) & smask) != 0 &&
                      ((bg0 ^ bg1) & (L.l2.sets - 1)) != 0;
  const int bgh = half() ? bg1 : bg0;  // this half-warp's line
  L3Row rb;
  if (paired) rb = load_row(L.l3, bgh, true);
  const unsigned m1 = hits(r1, line);
  const bool hit1 = m1 != 0;
  // the L1D is touched unconditionally: a miss stamps way 0
  touch(L.l1d, r1, first_way(m1), now);
  bool hit2 = false, hit3 = false;
  int l3_set = -1;  // the L3 set the data line's access changed
  const int nxt = line + 1;  // the next-line prefetch
  if (!hit1 && L.l2.ways <= 16 && L.l2.sets > 1) {
    // the line's row and the prefetch's (another set) as a pair: the
    // line's insert does not change the prefetch's row, so both inserts
    // share their instructions
    const int key = half() ? nxt : line;
    L2Row r2 = load_row(L.l2, key, true);
    const unsigned m2 = hits(r2, key, BT_DATA);
    hit2 = (m2 & 0xffffu) != 0;
    if (hit2) {
      l2_touch(L.l2, r2, __ffs(m2) - 1, pressure, L.tlb_aware);
    } else {
      L3Row r3 = load_row(L.l3, line);
      l2_insert_pair(L.l2, r2, key, 1u | ((m2 >> 16) == 0) << 1, pressure,
                     L.tlb_aware, L.live);
      hit3 = l3_access(L.l3, r3, line);
      l3_set = line & smask;
    }
  } else if (!hit1) {
    L2Row r2 = load_row(L.l2, line);
    const unsigned m2 = hits(r2, line, BT_DATA);
    hit2 = m2 != 0;
    if (hit2) {
      l2_touch(L.l2, r2, __ffs(m2) - 1, pressure, L.tlb_aware);
    } else {
      L3Row r3 = load_row(L.l3, line);
      l2_insert(L.l2, r2, line, BT_DATA, pressure, L.tlb_aware, L.live);
      hit3 = l3_access(L.l3, r3, line);
      l3_set = line & smask;
      L2Row rp = load_row(L.l2, nxt);
      if (hits(rp, nxt, BT_DATA) == 0)
        l2_insert(L.l2, rp, nxt, BT_DATA, pressure, L.tlb_aware, L.live);
    }
  }
  insert_lru(L.l1d, r1, line, now, !hit1);
  __syncwarp(kFull);  // the line's rows, by either half, are written
  if (paired) {
    if (l3_set == (bg0 & smask) || l3_set == (bg1 & smask))
      rb = load_row(L.l3, bgh, true);
    const unsigned hit = l3_access_pair(L.l3, rb, bgh);
    if (hit != 3) {
      L2Row r = load_row(L.l2, bgh, true);
      l2_insert_pair(L.l2, r, bgh, ~hit & 3u, pressure, L.tlb_aware, L.live);
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const int bg = k ? bg1 : bg0;
      L3Row r3 = load_row(L.l3, bg);
      if (!l3_access(L.l3, r3, bg)) {
        L2Row r = load_row(L.l2, bg);
        l2_insert(L.l2, r, bg, BT_DATA, pressure, L.tlb_aware, L.live);
      }
    }
  }
  L.n_l2_access += !hit1;
  L.n_l2_miss += !hit1 && !hit2;
  L.n_l3_access += !hit1 && !hit2;
  return hit1 ? L.lat_l1d : miss_cycles(L, hit2, hit3);
}

__device__ __forceinline__ bool predict(int f, int c) {
  return c >= BOX_COST_LO && c <= BOX_COST_HI && f >= BOX_FREQ_LO &&
         f <= BOX_FREQ_HI;
}

// ---------------------------------------------------- nested paging
// stages.base.hash_h: the host-page counter entry of guest page `x`
__device__ __forceinline__ int hash_h(int x, int n) {
  return static_cast<int>(static_cast<uint32_t>(x) * HASH_MUL) & (n - 1);
}

// page_table.host_walk, enabled: the host page table's four levels, no
// PWCs
__device__ __forceinline__ int host_walk(Lane& L, int gpn, bool pressure,
                                         int* n_dram) {
  int cycles = 0;
  *n_dram = 0;
#pragma unroll 1
  for (int up = 3; up >= 0; --up) {
    bool d;
    cycles += access_pte(
        L, LINE_B + HOST_LINES + up * LINE_W + ((gpn >> 9 * up) >> 3),
        pressure, &d);
    *n_dram += d;
  }
  return cycles;
}

struct Nested {
  int cycles;
  bool walked, nt_hit, nv_hit;
};

// stages.nested.nested_translate, enabled: guest-physical page `gpn` ->
// host-physical through the nested TLB, [Victima's nested-TLB block in
// the L2 cache,] the host walk; then the host-page counters, the retag,
// and the nested-TLB refill with its eviction's background host walk, in
// the reference's order.  Thread 0 writes the counters; every thread
// reads them (the __syncwarp at the end orders the next translation's
// reads after these writes).  When the eviction's entry meets the demand
// walk's, the second update starts from the first's result, as the
// reference's two sequential updates do.
template <bool VICTIMA>
__device__ __forceinline__ Nested nested_translate(Lane& L, int gpn, int now,
                                                   bool pressure,
                                                   bool bypass, bool ven) {
  LruRow rn = load_row(L.ntlb, gpn);
  const int hidx = hash_h(gpn, L.nh);
  int f = L.fh[hidx], c = L.ch[hidx];
  Nested o = {1, false, false, false};  // the 1-cycle nested TLB
  const unsigned m = hits(rn, gpn);
  if (m != 0) {  // a hit only stamps its entry
    touch(L.ntlb, rn, __ffs(m) - 1, now);
    o.nt_hit = true;
    return o;
  }
  if (VICTIMA && ven) {  // a gated-off lane probes no nested-TLB block
    const int vk = gpn >> 3;
    L2Row r = load_row(L.l2, vk);
    const unsigned mv = hits(r, vk, BT_NTLB);
    if (mv != 0) {
      l2_touch(L.l2, r, __ffs(mv) - 1, pressure, L.tlb_aware);
      o.cycles += L.lat_l2;
      o.nv_hit = true;
    }
  }
  o.walked = !o.nv_hit;
  if (o.walked) {
    int nd;
    o.cycles += host_walk(L, gpn, pressure, &nd);
    f = min(f + 1, FREQ_MAX);
    c = min(c + (nd >= 1), COST_MAX);
    if (lane() == 0) {
      L.fh[hidx] = static_cast<uint8_t>(f);
      L.ch[hidx] = static_cast<uint8_t>(c);
    }
    if (VICTIMA && ven && (!L.use_ptwcp || predict(f, c) || bypass))
      retag_to_tlb(L, gpn >> 3, BT_NTLB, pressure);
  }
  // refill the nested TLB (the row is as loaded: a miss stamps nothing)
  const int tv = lru_victim(rn);
  const int ev_tag = __shfl_sync(kFull, rn.tag, tv);
  const bool ev_valid = (__ballot_sync(kFull, rn.valid()) >> tv) & 1u;
  fill(L.ntlb, rn, tv, gpn, now);
  if (VICTIMA && ven && ev_valid) {
    const int eidx = hash_h(ev_tag, L.nh);
    const int fe = eidx == hidx ? f : L.fh[eidx];
    const int ce = eidx == hidx ? c : L.ch[eidx];
    if (!L.use_ptwcp || predict(fe, ce) || bypass) {
      int bd;
      host_walk(L, ev_tag, pressure, &bd);
      if (lane() == 0) {
        L.fh[eidx] = static_cast<uint8_t>(min(fe + 1, FREQ_MAX));
        L.ch[eidx] = static_cast<uint8_t>(min(ce + (bd >= 1), COST_MAX));
      }
      retag_to_tlb(L, ev_tag >> 3, BT_NTLB, pressure);
    }
  }
  __syncwarp(kFull);
  return o;
}

struct Walk2d {
  int cycles, n_dram, nhost, nt_hit, nv_hit;
};

// stages.nested.guest_walk_2d, enabled: the guest walk's levels, each
// translating its PT line's guest-physical page before the access, then
// the data page's own (identity map: gpn = vpn).  The PWCs are probed
// before the walk; their fills come after the last translation, not
// before it (nothing in a translation reads or writes a PWC), so one
// loop of five translations serves all.
template <bool VICTIMA>
__device__ __forceinline__ Walk2d walk2d(Lane& L, PwcRows& w, int vpn,
                                        bool is2m, int now, bool pressure,
                                        bool bypass, bool ven) {
  const int k4 = vpn >> 27, k3 = vpn >> 18, k2 = vpn >> 9;
  const bool hit4 = hits(w.r4, k4) != 0;
  const bool hit3 = hits(w.r3, k3) != 0;
  const bool hit2 = hits(w.r2, k2) != 0 && !is2m;
  int start = hit2 ? 3 : hit3 ? 2 : hit4 ? 1 : 0;
  if (is2m) start = min(start, 2);
  const int n_levels = is2m ? 3 : 4;
  Walk2d o = {PWC_LAT, 0, 0, 0, 0};
#pragma unroll 1
  for (int lv = start; lv <= 4; ++lv) {
    if (lv < 4 && lv >= n_levels) continue;
    const int up = 3 - min(lv, 3);
    const int line = LINE_B + up * LINE_W + ((vpn >> 9 * up) >> 3);
    const Nested n = nested_translate<VICTIMA>(L, lv < 4 ? line >> 6 : vpn,
                                               now, pressure, bypass, ven);
    o.cycles += n.cycles;
    o.nhost += n.walked;
    o.nt_hit += n.nt_hit;
    o.nv_hit += n.nv_hit;
    if (lv < 4) {
      bool d;
      o.cycles += access_pte(L, line, pressure, &d);
      o.n_dram += d;
    }
  }
  insert_lru(L.pml4, w.r4, k4, now, start <= 0);
  insert_lru(L.pdp, w.r3, k3, now, start <= 1);
  insert_lru(L.pd, w.r2, k2, now, start <= 2 && !is2m);
  return o;
}

// ------------------------------------------------ shared-memory plan
__host__ __device__ inline int entries(const AssocP& a) {
  return a.sets * a.ways;
}

// the eight LRU arrays in plan order: the six always in shared memory,
// the nested TLB (virtualized configurations), the L2 TLB (placement)
constexpr int LRU_NTLB = 6, LRU_L2TLB = 7;
__host__ __device__ inline const AssocP& lru_param(const Params& p, int k) {
  switch (k) {
    case 0: return p.l1d4;
    case 1: return p.l1d2;
    case 2: return p.pml4;
    case 3: return p.pdp;
    case 4: return p.pd;
    case 5: return p.l1d;
    case LRU_NTLB: return p.ntlb;
    default: return p.l2tlb;
  }
}

__host__ __device__ inline bool lru_shared(const Params& p, int k) {
  return k < LRU_NTLB || (k == LRU_NTLB ? p.virt != 0 : p.l2tlb_shared != 0);
}

__host__ __device__ inline Plan plan(const Params& p) {
  Plan s;
  int o = 0;
  s.hist = o;
  o += 4 * (WALK_HIST_BUCKETS + 2 * REUSE_BUCKETS);
  for (int k = 0; k < 8; ++k) {
    s.lru_i32[k] = o;
    if (lru_shared(p, k)) o += 8 * entries(lru_param(p, k));
  }
  const int n2 = p.l2.sets * p.l2.ways;
  s.l2_tag = o;
  if (p.l2_shared) o += 4 * n2;
  for (int k = 0; k < 8; ++k) {
    s.lru_u8[k] = o;
    if (lru_shared(p, k)) o += entries(lru_param(p, k));
  }
  s.l2_pk = o;
  s.l2_r8 = o + n2;
  if (p.l2_shared) o += 2 * n2;
  s.total = o;
  return s;
}

// ------------------------------------------------ load and write back
// The copies at launch start and end go in batches of COPY_U elements a
// thread, every load of a batch issued before its first store.
constexpr int COPY_U = 8;

// store(i, load(i)) for this thread's i < n (lane, lane + 32, ...), in
// batches of COPY_U: every load of a batch before its first store.
template <typename Load, typename Store>
__device__ __forceinline__ void batched(size_t n, Load load, Store store) {
  for (size_t i0 = lane(); i0 < n; i0 += 32 * COPY_U) {
    decltype(load(i0)) v[COPY_U];
#pragma unroll
    for (int u = 0; u < COPY_U; ++u)
      if (i0 + 32 * u < n) v[u] = load(i0 + 32 * u);
#pragma unroll
    for (int u = 0; u < COPY_U; ++u)
      if (i0 + 32 * u < n) store(i0 + 32 * u, v[u]);
  }
}

struct Entry {  // one entry of an LRU array, or of the L2 cache
  int32_t tag, meta, rrpv, btype, reuse;
  uint8_t valid, pk;
};

struct Quad {  // four consecutive L2-cache entries
  int4 tag, rrpv, btype, reuse;
  uchar4 valid;
};

__device__ __forceinline__ bool aligned(const void* q, size_t a) {
  return (reinterpret_cast<uintptr_t>(q) & (a - 1)) == 0;
}

// the pack step of one L2-cache entry: exact, or a trap
__device__ __forceinline__ uint8_t pack_checked(int valid, int bt, int rr,
                                                int reuse, uint8_t* r8) {
  if (rr < 0 || rr > RRIP_MAX || bt < 0 || bt > BT_NTLB || reuse < 0)
    __trap();
  *r8 = min(reuse, 255);
  return pack(valid != 0, bt, rr);
}

// A lane's LRU array as the kernel uses it: in shared memory (copied in
// here) or, for an L2 TLB placed in device memory, the state tensors.
__device__ Lru lru_in(const AssocP& a, int b, bool shared, char* smem,
                      int o32, int o8) {
  const size_t o = static_cast<size_t>(b) * a.sets * a.ways;
  Lru l = {a.tags + o, a.meta + o, a.valid + o, a.sets, a.ways, a.ways};
  if (!shared) return l;
  Lru s = {reinterpret_cast<int32_t*>(smem + o32),
           reinterpret_cast<int32_t*>(smem + o32) + entries(a),
           reinterpret_cast<uint8_t*>(smem + o8), a.sets, a.ways, a.ways};
  batched(
      entries(a),
      [&](size_t i) {
        return Entry{l.tag[i], l.stamp[i], 0, 0, 0, l.valid[i], 0};
      },
      [&](size_t i, const Entry& e) {
        s.tag[i] = e.tag;
        s.stamp[i] = e.meta;
        s.valid[i] = e.valid;
      });
  return s;
}

__device__ void lru_out(const AssocP& a, int b, const Lru& s) {
  const size_t o = static_cast<size_t>(b) * a.sets * a.ways;
  batched(
      entries(a),
      [&](size_t i) {
        return Entry{s.tag[i], s.stamp[i], 0, 0, 0, s.valid[i], 0};
      },
      [&](size_t i, const Entry& e) {
        a.tags[o + i] = e.tag;
        a.meta[o + i] = e.meta;
        a.valid[o + i] = e.valid;
      });
}

template <bool L2S, bool TS, int COMP, bool DYN>
__global__ void __launch_bounds__(32, 1) mmu_step_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool victima = (COMP & C_VICTIMA) != 0;
  constexpr bool l3tlb = (COMP & C_L3TLB) != 0;
  constexpr bool pom = (COMP & C_POM) != 0;
  constexpr bool nested = (COMP & C_NESTED) != 0;
  constexpr bool collect = (COMP & C_COLLECT) != 0;
  constexpr bool restseg = (COMP & C_RESTSEG) != 0;
  constexpr bool rev = (COMP & C_REV) != 0;
  const int b = blockIdx.x;
  const Plan& pl = p.plan;
  const size_t n2 = static_cast<size_t>(p.l2.sets) * p.l2.ways;
  const size_t o2 = b * n2;
  int32_t* const hist = reinterpret_cast<int32_t*>(smem + pl.hist);

  Lane L;
  L.l1d4 = lru_in(p.l1d4, b, true, smem, pl.lru_i32[0], pl.lru_u8[0]);
  L.l1d2 = lru_in(p.l1d2, b, true, smem, pl.lru_i32[1], pl.lru_u8[1]);
  L.pml4 = lru_in(p.pml4, b, true, smem, pl.lru_i32[2], pl.lru_u8[2]);
  L.pdp = lru_in(p.pdp, b, true, smem, pl.lru_i32[3], pl.lru_u8[3]);
  L.pd = lru_in(p.pd, b, true, smem, pl.lru_i32[4], pl.lru_u8[4]);
  L.l1d = lru_in(p.l1d, b, true, smem, pl.lru_i32[5], pl.lru_u8[5]);
  // the nested TLB: only the 2-D walk uses it (ideal shadow paging runs
  // the radix instantiation and leaves it as it is)
  if constexpr (nested)
    L.ntlb = lru_in(p.ntlb, b, true, smem, pl.lru_i32[LRU_NTLB],
                    pl.lru_u8[LRU_NTLB]);
  L.l2tlb = lru_in(p.l2tlb, b, TS, smem, pl.lru_i32[LRU_L2TLB],
                   pl.lru_u8[LRU_L2TLB]);
  if constexpr (l3tlb) L.l3tlb = lru_in(p.l3tlb, b, false, smem, 0, 0);
  if constexpr (pom) L.pom = lru_in(p.pom, b, false, smem, 0, 0);
  if constexpr (restseg) {
    L.rs4 = lru_in(p.restseg4, b, false, smem, 0, 0);
    L.rs2 = lru_in(p.restseg2, b, false, smem, 0, 0);
  }
  if constexpr (rev) {
    L.rev = lru_in(p.rev, b, false, smem, 0, 0);
    L.rev_vpn = p.rev_vpn + static_cast<size_t>(b) * entries(p.rev);
  }
  L.l2 = {L2S ? reinterpret_cast<int32_t*>(smem + pl.l2_tag)
              : p.l2.tags + o2,
          L2S ? reinterpret_cast<uint8_t*>(smem + pl.l2_pk)
              : p.l2_pack + 2 * o2,
          L2S ? reinterpret_cast<uint8_t*>(smem + pl.l2_r8)
              : p.l2_pack + 2 * o2 + n2,
          p.l2.reuse + o2, hist + WALK_HIST_BUCKETS,
          hist + WALK_HIST_BUCKETS + REUSE_BUCKETS, p.l2.sets, p.l2.ways,
          p.l2.ways};
  {
    const size_t o3 = static_cast<size_t>(b) * p.l3.sets * p.l3.ways;
    L.l3 = {p.l3.tags + o3, p.l3.valid + o3, p.l3.meta + o3, p.l3.sets,
            p.l3.ways};
  }
  L.hist_walk = hist;
  for (int i = lane(); i < WALK_HIST_BUCKETS; i += 32)
    hist[i] = p.stats.hist_walk[b * WALK_HIST_BUCKETS + i];
  for (int i = lane(); i < REUSE_BUCKETS; i += 32) {
    L.l2.hist_data[i] = p.l2.hist_data[b * REUSE_BUCKETS + i];
    L.l2.hist_tlb[i] = p.l2.hist_tlb[b * REUSE_BUCKETS + i];
  }
  // pack the L2 cache (into shared memory, or the scratch tensor): four
  // entries a load where the row count and the addresses allow
  const bool quads = n2 % 4 == 0 && aligned(p.l2.tags + o2, 16) &&
                     aligned(p.l2.rrpv + o2, 16) &&
                     aligned(p.l2.btype + o2, 16) &&
                     aligned(p.l2.reuse + o2, 16) &&
                     aligned(p.l2.valid + o2, 4) && aligned(L.l2.tag, 16) &&
                     aligned(L.l2.pk, 4) && aligned(L.l2.r8, 4);
  if (quads) {
    batched(
        n2 / 4,
        [&](size_t q) {
          const size_t g = o2 / 4 + q;
          return Quad{L2S ? reinterpret_cast<const int4*>(p.l2.tags)[g]
                          : int4{},
                      reinterpret_cast<const int4*>(p.l2.rrpv)[g],
                      reinterpret_cast<const int4*>(p.l2.btype)[g],
                      reinterpret_cast<const int4*>(p.l2.reuse)[g],
                      reinterpret_cast<const uchar4*>(p.l2.valid)[g]};
        },
        [&](size_t q, const Quad& e) {
          uchar4 pk, r8;
          pk.x = pack_checked(e.valid.x, e.btype.x, e.rrpv.x, e.reuse.x, &r8.x);
          pk.y = pack_checked(e.valid.y, e.btype.y, e.rrpv.y, e.reuse.y, &r8.y);
          pk.z = pack_checked(e.valid.z, e.btype.z, e.rrpv.z, e.reuse.z, &r8.z);
          pk.w = pack_checked(e.valid.w, e.btype.w, e.rrpv.w, e.reuse.w, &r8.w);
          if (L2S) reinterpret_cast<int4*>(L.l2.tag)[q] = e.tag;
          reinterpret_cast<uchar4*>(L.l2.pk)[q] = pk;
          reinterpret_cast<uchar4*>(L.l2.r8)[q] = r8;
        });
  } else {
    batched(
        n2,
        [&](size_t i) {
          const size_t g = o2 + i;
          return Entry{L2S ? p.l2.tags[g] : 0, 0, p.l2.rrpv[g], p.l2.btype[g],
                       p.l2.reuse[g], p.l2.valid[g], 0};
        },
        [&](size_t i, const Entry& e) {
          if (L2S) L.l2.tag[i] = e.tag;
          L.l2.pk[i] = pack_checked(e.valid, e.btype, e.rrpv, e.reuse,
                                    L.l2.r8 + i);
        });
  }
  {
    const size_t n4o = static_cast<size_t>(b) * p.pc4.n;
    const size_t n2o = static_cast<size_t>(b) * p.pc2.n;
    L.f4 = p.pc4.freq + n4o;
    L.c4 = p.pc4.cost + n4o;
    L.f2 = p.pc2.freq + n2o;
    L.c2 = p.pc2.cost + n2o;
  }
  L.n4 = p.pc4.n;
  L.n2 = p.pc2.n;
  L.tlb_aware = p.tlb_aware != 0;
  if constexpr (nested) {
    const size_t nho = static_cast<size_t>(b) * p.pch.n;
    L.fh = p.pch.freq + nho;
    L.ch = p.pch.cost + nho;
    L.nh = p.pch.n;
    L.use_ptwcp = p.use_ptwcp != 0;
  }
  L.lat_l1d = p.lat_l1d;
  L.lat_l2 = p.lat_l2;
  L.lat_l3 = p.lat_l3;
  L.lat_dram = p.lat_dram;
  L.live = {p.l2.n_tlb4[b], p.l2.n_tlb2[b], p.l2.n_ntlb[b]};
  L.n_l2_access = p.hier.n_l2_access[b];
  L.n_l2_miss = p.hier.n_l2_miss[b];
  L.n_l3_access = p.hier.n_l3_access[b];
  L.n_l3_trans = p.hier.n_l3_trans[b];
  // a ladder lane: its geometry views and latencies, and the gates of its
  // stages (stages.base.Dyn); a launch of one system has all gates on
  int dyn_l2tlb_lat = 0, dyn_l3tlb_lat = 0;
  bool ven = true, uen = true, l3en = true, pen = true, ren = true;
  if constexpr (DYN) {
    const int32_t* d = p.dyn + static_cast<size_t>(b) * NDYN;
    L.l2tlb.sets = d[DYN_L2TLB_MASK] + 1;
    L.l2tlb.ways = d[DYN_L2TLB_WAYS];
    L.l2.sets = d[DYN_L2_MASK] + 1;
    L.l2.ways = d[DYN_L2_WAYS];
    if constexpr (restseg) L.rs4.ways = L.rs2.ways = d[DYN_RS_WAYS];
    dyn_l2tlb_lat = d[DYN_L2TLB_LAT];
    dyn_l3tlb_lat = d[DYN_L3TLB_LAT];
    ven = d[DYN_VICTIMA] != 0;
    uen = d[DYN_UTOPIA] != 0;
    l3en = d[DYN_L3TLB] != 0;
    pen = d[DYN_POM] != 0;
    ren = d[DYN_REV] != 0;
  }

  const StatsP& S = p.stats;
  int now = p.now[b];
  int n_access = S.n_access[b], n_l1tlb_hit = S.n_l1tlb_hit[b];
  int n_l2tlb_hit = S.n_l2tlb_hit[b], n_l2tlb_miss = S.n_l2tlb_miss[b];
  int n_victima_hit = S.n_victima_hit[b], n_demand_ptw = S.n_demand_ptw[b];
  int n_bg_ptw = S.n_bg_ptw[b];
  // the counts of a stage the composition lacks stay 0 and are not
  // written back (no register holds them through the loop)
  int n_l3tlb_hit = l3tlb ? S.n_l3tlb_hit[b] : 0;
  int n_pom_hit = pom ? S.n_pom_hit[b] : 0;
  int n_host_ptw = nested ? S.n_host_ptw[b] : 0;
  int n_ntlb_hit = nested ? S.n_ntlb_hit[b] : 0;
  int n_nvictima_hit = nested ? S.n_nvictima_hit[b] : 0;
  float sum_trans = S.sum_trans_cyc[b], sum_l2miss = S.sum_l2miss_cyc[b];
  float sum_data = S.sum_data_cyc[b], sum_walk = S.sum_walk_cyc[b];
  float sum_tlb4 = S.sum_tlb4_live[b], sum_tlb2 = S.sum_tlb2_live[b];
  int n_rs_hit = restseg ? S.n_restseg_hit[b] : 0;
  int n_rs_miss = restseg ? S.n_restseg_miss[b] : 0;
  int n_rs_mig = restseg ? S.n_restseg_mig[b] : 0;
  int n_rs_conf = restseg ? S.n_restseg_conflict[b] : 0;
  float sum_rs = restseg ? S.sum_restseg_cyc[b] : 0.0f;
  int n_rv_hit = rev ? S.n_rev_hit[b] : 0;
  int n_rv_mispred = rev ? S.n_rev_mispred[b] : 0;
  int n_rv_enroll = rev ? S.n_rev_enroll[b] : 0;
  float sum_rv = rev ? S.sum_rev_verify_cyc[b] : 0.0f;
  // the RestSeg-probe and verification-walk histograms stay in device
  // memory (thread 0 adds to them; nothing reads them during the launch)
  int32_t* const hist_rs = S.hist_restseg + b * WALK_HIST_BUCKETS;
  int32_t* const hist_rv = S.hist_rev_verify + b * WALK_HIST_BUCKETS;
  const int rev_mask = static_cast<int>((1u << p.rev_sig_bits) - 1u);
  // the feature table of this lane
  const size_t fo = static_cast<size_t>(b) * p.feats.n;
  uint16_t* const ft_acc = p.feats.n_access + fo;
  uint16_t* const ft_l1 = p.feats.n_l1_miss + fo;
  uint16_t* const ft_l2 = p.feats.n_l2_miss + fo;
  uint16_t* const ft_walk = p.feats.n_walk + fo;
  float* const ft_cyc = p.feats.walk_cyc + fo;
  uint8_t* const ft_2m = p.feats.is2m + fo;
  const bool tlb_aware = L.tlb_aware;
  __syncwarp(kFull);  // the copies in are done: each word has one owner

  // the trace row of the next access is loaded during this one (the last
  // access loads its own row again: no branch around the loads)
  const int32_t* tr_vpn = p.trace.vpn + b;
  const uint8_t* tr_is2m = p.trace.is2m + b;
  const int32_t* tr_line = p.trace.line + b;
  const float* tr_ipa = p.trace.ipa + b;
  size_t ti = static_cast<size_t>(min(p.t0, max(p.t1 - 1, 0))) * p.lanes;
  int nx_vpn = tr_vpn[ti], nx_line = tr_line[ti];
  unsigned nx_is2m = tr_is2m[ti];
  float nx_ipa = tr_ipa[ti];
  PROF_BEGIN();

  for (int t = p.t0; t < p.t1; ++t) {
    const int vpn = nx_vpn, line = nx_line;
    const bool is2m = nx_is2m != 0;
    const float ipa = nx_ipa;
    ti = static_cast<size_t>(min(t + 1, p.t1 - 1)) * p.lanes;
    nx_vpn = tr_vpn[ti];
    nx_is2m = tr_is2m[ti];
    nx_line = tr_line[ti];
    nx_ipa = tr_ipa[ti];

    // mmu.make_step: the step's signals read the stats before the access
    now += 1;
    const float instrs =
        __fmul_rn(fmaxf(__int2float_rn(n_access), 1.0f), ipa);
    const bool pressure = __fmul_rn(__int2float_rn(n_l2tlb_miss), 1000.0f) >
                          __fmul_rn(p.pressure_mpki, instrs);
    const bool bypass = __fmul_rn(__int2float_rn(L.n_l2_miss), 1000.0f) >=
                        __fmul_rn(p.bypass_l2mpki, instrs);
    const int vpn2 = vpn >> 9;
    const int vpn_sz = is2m ? vpn2 : vpn;
    const int key2 = (vpn_sz << 1) | static_cast<int>(is2m);
    const int vkey = is2m ? vpn2 >> 3 : vpn >> 3;
    const int vbt = is2m ? BT_TLB2 : BT_TLB4;

    // every row that nothing before its use changes, in one round
    LruRow q4 = load_row(L.l1d4, vpn);
    LruRow q2 = load_row(L.l1d2, vpn2);
    LruRow qt = load_row(L.l2tlb, key2);
    LruRow r1 = load_row(L.l1d, line);
    PwcRows pw = pwc_rows(L, vpn);
    L2Row qv;
    if (victima) qv = load_row(L.l2, vkey);
    LruRow q3, qp;
    if (l3tlb) q3 = load_row(L.l3tlb, key2);
    if (pom) qp = load_row(L.pom, key2);
    // Utopia: both RestSeg rows; Revelator: the signature's row and its
    // enrolled pages (rev_sig: the int32 product wraps, as hash_h's)
    LruRow qr4, qr2, qrv;
    if (restseg) {
      qr4 = load_row(L.rs4, vpn);
      qr2 = load_row(L.rs2, vpn2);
    }
    const int sig = static_cast<int>(static_cast<uint32_t>(key2) * HASH_MUL) &
                    rev_mask;
    int rv_vpn = 0;
    if (rev) {
      qrv = load_row(L.rev, sig);
      rv_vpn = L.rev_vpn[qrv.i];
    }
    // the Table-2 feature entry of this access (thread 0)
    const int fi = collect ? hash_h(vpn_sz, p.feats.n) : 0;
    unsigned fe_acc = 0, fe_l1 = 0, fe_l2 = 0, fe_walk = 0;
    float fe_cyc = 0.0f;
    if (collect && lane() == 0) {
      fe_acc = ft_acc[fi];
      fe_l1 = ft_l1[fi];
      fe_l2 = ft_l2[fi];
      fe_walk = ft_walk[fi];
      fe_cyc = ft_cyc[fi];
    }
    // radix: the PTW-CP counter entry of this access
    const int ci = is2m ? vpn2 & (L.n2 - 1) : vpn & (L.n4 - 1);
    int cf = 0, cc = 0;
    if (!victima) {
      cf = (is2m ? L.f2 : L.f4)[ci];
      cc = (is2m ? L.c2 : L.c4)[ci];
    }

    // stages.l1_tlb lookup
    const unsigned m4 = hits(q4, vpn), m2 = hits(q2, vpn2);
    const bool hit1 = is2m ? m2 != 0 : m4 != 0;
    if (m4 != 0 && !is2m) touch(L.l1d4, q4, __ffs(m4) - 1, now);
    if (m2 != 0 && is2m) touch(L.l1d2, q2, __ffs(m2) - 1, now);
    const bool miss1 = !hit1;
    int trans = p.l1tlb_lat;

    // stages.l2_tlb lookup
    const unsigned mt = hits(qt, key2);
    const bool l2hit = miss1 && mt != 0;
    if (l2hit) touch(L.l2tlb, qt, __ffs(mt) - 1, now);
    trans += miss1 ? (DYN ? dyn_l2tlb_lat : p.l2tlb_lat) : 0;
    const bool miss2 = miss1 && !l2hit;
    bool need = miss2;
    int past = 0;

    // Victima: the L2-TLB victim is fixed now (nothing below touches the
    // L2 TLB before its fill), so both counter slots are known: they are
    // loaded here and used after the walk.  A lane whose Victima gate is
    // off points slot 1 at the demand page (stages.victima's redirect)
    int tv = 0, ev_tag = 0;
    bool ev_valid = false;
    int i4[2] = {0, 0}, i2[2] = {0, 0};
    int f4[2] = {0, 0}, c4[2] = {0, 0}, f2[2] = {0, 0}, c2[2] = {0, 0};
    if (victima) {
      tv = lru_victim(qt);
      ev_tag = __shfl_sync(kFull, qt.tag, tv);
      ev_valid = (__ballot_sync(kFull, qt.valid()) >> tv) & 1u;
      const int ev_vpn = ev_tag >> 1;
      const int bg_vpn4 = (ev_tag & 1) ? ev_vpn << 9 : ev_vpn;
      i4[0] = vpn & (L.n4 - 1);
      i4[1] = ven ? bg_vpn4 & (L.n4 - 1) : i4[0];
      i2[0] = vpn2 & (L.n2 - 1);
      i2[1] = ven ? ev_vpn & (L.n2 - 1) : i2[0];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        f4[k] = L.f4[i4[k]];
        c4[k] = L.c4[i4[k]];
        f2[k] = L.f2[i2[k]];
        c2[k] = L.c2[i2[k]];
      }
    }
    PROF_STAMP(ST_TLB);

    // stages.revelator lookup: the lowest way whose signature matches (way
    // 0 when none does); a hit stamps it and repairs its enrolled page,
    // and runs the verification walk, whose cycles are paid only on a
    // misprediction.  A hit resolves the access, so nothing below reads
    // the rows (L2 cache, PWCs) the walk changed.
    bool rvhit = false, rv_correct = false, rv_mispred = false;
    int vcyc = 0;
    if (rev) {
      const unsigned mr = hits(qrv, sig);
      const int w = first_way(mr);
      rvhit = ren && need && mr != 0;
      rv_correct = rvhit && __shfl_sync(kFull, rv_vpn, w) == key2;
      rv_mispred = rvhit && !rv_correct;
      if (rvhit) {
        touch(L.rev, qrv, w, now);
        if (lane() == w) L.rev_vpn[qrv.i] = key2;
        int vd;
        vcyc = walk(L, pw, vpn, is2m, now, pressure, &vd);
      }
      past += rvhit ? p.rev_lat + (rv_mispred ? vcyc : 0) : 0;
      need = need && !rvhit;
    }

    // stages.victima lookup
    bool vhit = false;
    if (victima) {
      const unsigned mv = hits(qv, vkey, vbt);
      vhit = ven && need && mv != 0;
      if (vhit) l2_touch(L.l2, qv, __ffs(mv) - 1, pressure, tlb_aware);
      past += vhit ? L.lat_l2 : 0;
      need = need && !vhit;
    }

    // stages.l3_tlb lookup: the probe latency is paid by every access
    // that reaches this level
    bool l3hit = false;
    if (l3tlb && need && l3en) {
      const unsigned m3 = hits(q3, key2);
      l3hit = m3 != 0;
      if (l3hit) touch(L.l3tlb, q3, __ffs(m3) - 1, now);
      past += DYN ? dyn_l3tlb_lat : p.l3tlb_lat;
      need = !l3hit;
    }

    // stages.pom lookup: the POM-TLB line through the caches (typed as a
    // TLB block), then the shadow structure
    bool pomhit = false;
    if (pom && need && pen) {
      bool d;
      past += access_pte(L, LINE_B + POM_LINES + ((key2 & p.pom_mask) >> 2),
                         pressure, &d, BT_TLB4);
      const unsigned mp = hits(qp, key2);
      pomhit = mp != 0;
      if (pomhit) touch(L.pom, qp, __ffs(mp) - 1, now);
      need = !pomhit;
    }

    // stages.utopia lookup: the set's tag line through the caches (typed
    // as a TLB block), then both RestSegs; the page size picks the hit
    const bool rprobed = restseg && need && uen;
    bool rshit = false;
    int rcyc = 0;
    if (rprobed) {
      bool d;
      rcyc = access_pte(
          L, LINE_B + (is2m ? RESTSEG2_LINES + (vpn2 & (L.rs2.sets - 1))
                            : RESTSEG4_LINES + (vpn & (L.rs4.sets - 1))),
          pressure, &d, BT_TLB4);
      const unsigned m4 = hits(qr4, vpn), m2 = hits(qr2, vpn2);
      const bool hit4 = !is2m && m4 != 0, hit2 = is2m && m2 != 0;
      if (hit4) touch(L.rs4, qr4, __ffs(m4) - 1, now);
      if (hit2) touch(L.rs2, qr2, __ffs(m2) - 1, now);
      rshit = hit4 || hit2;
      past += rcyc;
      need = !rshit;
    }
    PROF_STAMP(ST_PROBE);

    // stages.ptw / stages.nested lookup: the demand walk
    const bool walk_en = need;
    int ndram = 0, wcyc = 0, nhost = 0, nt_hit = 0, nv_hit = 0;
    if (walk_en) {
      if constexpr (nested) {
        const Walk2d w2 = walk2d<victima>(L, pw, vpn, is2m, now, pressure,
                                          bypass, ven);
        wcyc = w2.cycles;
        ndram = w2.n_dram;
        nhost = w2.nhost;
        nt_hit = w2.nt_hit;
        nv_hit = w2.nv_hit;
      } else {
        wcyc = walk(L, pw, vpn, is2m, now, pressure, &ndram);
      }
    }
    past += wcyc;
    PROF_STAMP(ST_WALK);

    bool bg = false;
    // stages.base.ptwcp_walk_verdict: Utopia's migration and Revelator's
    // enrollment, from the PTW-CP counters the walker's (or Victima's)
    // fill leaves
    bool promote = false;
    if (victima) {
      // stages.l2_tlb fill
      if (miss2) fill(L.l2tlb, qt, tv, key2, now);
      ev_valid = ev_valid && miss2;
      // stages.victima fill: the counters read once, before the walks
      const int ev_vpn = ev_tag >> 1;
      const bool ev2m = (ev_tag & 1) != 0;
      const int fpost = (is2m ? f2[0] : f4[0]) + walk_en;
      const int cpost = (is2m ? c2[0] : c4[0]) + (walk_en && ndram >= 1);
      const bool pred = !p.use_ptwcp ||
                        predict(min(fpost, FREQ_MAX), min(cpost, COST_MAX));
      const bool epred = !p.use_ptwcp ||
                         predict(ev2m ? f2[1] : f4[1], ev2m ? c2[1] : c4[1]);
      if (walk_en && (pred || bypass) && ven)
        retag_to_tlb(L, vkey, vbt, pressure);
      bg = miss2 && ev_valid && (epred || bypass) && ven;
      int bdram = 0;
      if (bg) {
        const int bg_vpn4 = ev2m ? ev_vpn << 9 : ev_vpn;
        PwcRows bw = pwc_rows(L, bg_vpn4);
        walk(L, bw, bg_vpn4, ev2m, now, pressure, &bdram);
        retag_to_tlb(L, ev_vpn >> 3, ev2m ? BT_TLB2 : BT_TLB4, pressure);
      }
      // fused counter writeback: slot 0 then slot 1 (slot 1 wins a tie);
      // with the gate off slot 1 is slot 0's entry and carries its update
      const bool en4[2] = {walk_en && !is2m, ven ? bg && !ev2m
                                                 : walk_en && !is2m};
      const bool en2[2] = {walk_en && is2m, ven ? bg && ev2m
                                                : walk_en && is2m};
      const bool dr[2] = {ndram >= 1, ven ? bdram >= 1 : ndram >= 1};
      if (restseg || rev) {
        // the demand page's counters as the writeback leaves them, for
        // the promotion verdict below
        const int k = is2m ? i2[1] == i2[0] : i4[1] == i4[0];
        const int f = is2m ? f2[k] + en2[k] : f4[k] + en4[k];
        const int c = (is2m ? c2[k] : c4[k]) +
                      ((is2m ? en2[k] : en4[k]) && dr[k]);
        promote = walk_en && (!p.use_ptwcp || bypass ||
                              predict(min(f, FREQ_MAX), min(c, COST_MAX)));
      }
      if (lane() == 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          L.f4[i4[k]] = static_cast<uint8_t>(min(f4[k] + en4[k], FREQ_MAX));
          L.c4[i4[k]] =
              static_cast<uint8_t>(min(c4[k] + (en4[k] && dr[k]), COST_MAX));
          L.f2[i2[k]] = static_cast<uint8_t>(min(f2[k] + en2[k], FREQ_MAX));
          L.c2[i2[k]] =
              static_cast<uint8_t>(min(c2[k] + (en2[k] && dr[k]), COST_MAX));
        }
      }
    } else {
      // stages.ptw / stages.nested fill (fill_walk_counters), then
      // stages.l2_tlb fill
      if (walk_en && lane() == 0) {
        (is2m ? L.f2 : L.f4)[ci] = static_cast<uint8_t>(min(cf + 1, FREQ_MAX));
        (is2m ? L.c2 : L.c4)[ci] =
            static_cast<uint8_t>(min(cc + (ndram >= 1), COST_MAX));
      }
      if (restseg || rev)
        promote = walk_en && (!p.use_ptwcp || bypass ||
                              predict(min(cf + 1, FREQ_MAX),
                                      min(cc + (ndram >= 1), COST_MAX)));
      if (pom) {
        // the L2 TLB's evicted entry (the row as the lookup left it: a
        // miss stamped nothing), then stages.pom fill: the walked entry
        // and then that evicted one
        tv = lru_victim(qt);
        ev_tag = __shfl_sync(kFull, qt.tag, tv);
        ev_valid = miss2 && ((__ballot_sync(kFull, qt.valid()) >> tv) & 1u);
        if (miss2) fill(L.l2tlb, qt, tv, key2, now);
        insert_lru(L.pom, qp, key2, now, walk_en);
        if (ev_valid) {
          const int smask = L.pom.sets - 1;
          LruRow qe = qp;  // the same set: the row as the first fill left it
          if (((ev_tag ^ key2) & smask) != 0) qe = load_row(L.pom, ev_tag);
          insert_lru(L.pom, qe, ev_tag, now, true);
        }
      } else {
        insert_lru(L.l2tlb, qt, key2, now, miss2);
      }
      // stages.l3_tlb fill
      if (l3tlb) insert_lru(L.l3tlb, q3, key2, now, walk_en);
    }
    // stages.utopia fill (the migration engine; a set conflict demotes
    // the LRU resident), then stages.revelator fill (enrollment: the
    // signature in the LRU way, with its page), each under its gate
    if (restseg) {
      const bool mig = promote && uen;
      const bool c4 = insert_lru_evicts(L.rs4, qr4, vpn, now, mig && !is2m);
      const bool c2 = insert_lru_evicts(L.rs2, qr2, vpn2, now, mig && is2m);
      n_rs_mig += mig;
      n_rs_conf += c4 || c2;
    }
    if (rev && promote && ren) {
      const int w = lru_victim(qrv);
      fill(L.rev, qrv, w, sig, now);
      if (lane() == w) L.rev_vpn[qrv.i] = key2;
    }
    n_rv_enroll += rev && promote && ren;
    // the POM-TLB's and the L3 TLB's fills after Victima's (the ladder
    // compositions; without Victima they come after the walker's above):
    // the walked entry, then the L2 TLB's evicted one, each under its gate
    if (victima && pom && pen) {
      insert_lru(L.pom, qp, key2, now, walk_en);
      if (ev_valid) {
        LruRow qe = qp;  // the same set: the row as the first fill left it
        if (((ev_tag ^ key2) & (L.pom.sets - 1)) != 0)
          qe = load_row(L.pom, ev_tag);
        insert_lru(L.pom, qe, ev_tag, now, true);
      }
    }
    if (victima && l3tlb) insert_lru(L.l3tlb, q3, key2, now, walk_en && l3en);
    PROF_STAMP(ST_FILL);
    // stages.l1_tlb fill
    insert_lru(L.l1d4, q4, vpn, now, miss1 && !is2m);
    insert_lru(L.l1d2, q2, vpn2, now, miss1 && is2m);
    trans += past;
    PROF_STAMP(ST_TLB);

    const int dcyc = access_data(L, r1, line, now, pressure);
    PROF_STAMP(ST_DATA);

    // stages.fold.accum_stats, in the reference's order
    n_access += 1;
    n_l1tlb_hit += hit1;
    n_l2tlb_hit += l2hit;
    n_l2tlb_miss += miss2;
    n_victima_hit += vhit;
    n_l3tlb_hit += l3hit;
    n_pom_hit += pomhit;
    n_demand_ptw += walk_en;
    n_bg_ptw += bg;
    n_host_ptw += nhost;
    n_ntlb_hit += nt_hit;
    n_nvictima_hit += nv_hit;
    sum_trans = __fadd_rn(sum_trans, __int2float_rn(trans));
    sum_l2miss = __fadd_rn(sum_l2miss, __int2float_rn(miss2 ? past : 0));
    sum_data = __fadd_rn(sum_data, __int2float_rn(dcyc));
    sum_walk = __fadd_rn(sum_walk, __int2float_rn(walk_en ? wcyc : 0));
    if (walk_en) {
      const int hb = min(wcyc / 10, WALK_HIST_BUCKETS - 1);
      if (lane() == (hb & 31)) L.hist_walk[hb] += 1;
    }
    sum_tlb4 = __fadd_rn(sum_tlb4, __int2float_rn(L.live.n4));
    sum_tlb2 = __fadd_rn(sum_tlb2, __int2float_rn(L.live.n2));
    if (restseg) {
      n_rs_hit += rshit;
      n_rs_miss += rprobed && !rshit;
      sum_rs = __fadd_rn(sum_rs, __int2float_rn(rcyc));
      if (rprobed && lane() == 0)
        atomicAdd(hist_rs + min(rcyc / 10, WALK_HIST_BUCKETS - 1), 1);
    }
    if (rev) {
      n_rv_hit += rv_correct;
      n_rv_mispred += rv_mispred;
      sum_rv = __fadd_rn(sum_rv, __int2float_rn(vcyc));
      if (rvhit && lane() == 0)
        atomicAdd(hist_rv + min(vcyc / 10, WALK_HIST_BUCKETS - 1), 1);
    }
    // stages.fold.collect_feats: four uint16 counters that wrap, the f32
    // walk-cycle sum, and is2m set
    if (collect && lane() == 0) {
      ft_acc[fi] = static_cast<uint16_t>(fe_acc + 1);
      ft_l1[fi] = static_cast<uint16_t>(fe_l1 + miss1);
      ft_l2[fi] = static_cast<uint16_t>(fe_l2 + miss2);
      ft_walk[fi] = static_cast<uint16_t>(fe_walk + walk_en);
      ft_cyc[fi] = __fadd_rn(fe_cyc, __int2float_rn(walk_en ? wcyc : 0));
      ft_2m[fi] = is2m;
    }
    // the counters thread 0 wrote are read by every thread next access,
    // and a row half 1 of a pair wrote may be thread w's next access
    __syncwarp(kFull);
    PROF_STAMP(ST_STATS);
  }
  PROF_END(p, b, p.t1 - p.t0);

  // write back: the scalars, then every copied or packed array
  __syncwarp(kFull);
  if (lane() == 0) {
    p.now[b] = now;
    S.n_access[b] = n_access;
    S.n_l1tlb_hit[b] = n_l1tlb_hit;
    S.n_l2tlb_hit[b] = n_l2tlb_hit;
    S.n_l2tlb_miss[b] = n_l2tlb_miss;
    S.n_victima_hit[b] = n_victima_hit;
    S.n_demand_ptw[b] = n_demand_ptw;
    S.n_bg_ptw[b] = n_bg_ptw;
    if (l3tlb) S.n_l3tlb_hit[b] = n_l3tlb_hit;
    if (pom) S.n_pom_hit[b] = n_pom_hit;
    if (nested) {
      S.n_host_ptw[b] = n_host_ptw;
      S.n_ntlb_hit[b] = n_ntlb_hit;
      S.n_nvictima_hit[b] = n_nvictima_hit;
    }
    if (restseg) {
      S.n_restseg_hit[b] = n_rs_hit;
      S.n_restseg_miss[b] = n_rs_miss;
      S.n_restseg_mig[b] = n_rs_mig;
      S.n_restseg_conflict[b] = n_rs_conf;
      S.sum_restseg_cyc[b] = sum_rs;
    }
    if (rev) {
      S.n_rev_hit[b] = n_rv_hit;
      S.n_rev_mispred[b] = n_rv_mispred;
      S.n_rev_enroll[b] = n_rv_enroll;
      S.sum_rev_verify_cyc[b] = sum_rv;
    }
    S.sum_trans_cyc[b] = sum_trans;
    S.sum_l2miss_cyc[b] = sum_l2miss;
    S.sum_data_cyc[b] = sum_data;
    S.sum_walk_cyc[b] = sum_walk;
    S.sum_tlb4_live[b] = sum_tlb4;
    S.sum_tlb2_live[b] = sum_tlb2;
    p.l2.n_tlb4[b] = L.live.n4;
    p.l2.n_tlb2[b] = L.live.n2;
    p.l2.n_ntlb[b] = L.live.nn;
    p.hier.n_l2_access[b] = L.n_l2_access;
    p.hier.n_l2_miss[b] = L.n_l2_miss;
    p.hier.n_l3_access[b] = L.n_l3_access;
    p.hier.n_l3_trans[b] = L.n_l3_trans;
  }
  for (int i = lane(); i < WALK_HIST_BUCKETS; i += 32)
    p.stats.hist_walk[b * WALK_HIST_BUCKETS + i] = hist[i];
  for (int i = lane(); i < REUSE_BUCKETS; i += 32) {
    p.l2.hist_data[b * REUSE_BUCKETS + i] = L.l2.hist_data[i];
    p.l2.hist_tlb[b * REUSE_BUCKETS + i] = L.l2.hist_tlb[i];
  }
  lru_out(p.l1d4, b, L.l1d4);
  lru_out(p.l1d2, b, L.l1d2);
  lru_out(p.pml4, b, L.pml4);
  lru_out(p.pdp, b, L.pdp);
  lru_out(p.pd, b, L.pd);
  lru_out(p.l1d, b, L.l1d);
  if constexpr (nested) lru_out(p.ntlb, b, L.ntlb);
  if (TS) lru_out(p.l2tlb, b, L.l2tlb);
  if (quads) {
    batched(
        n2 / 4,
        [&](size_t q) {
          const uchar4 pk = reinterpret_cast<const uchar4*>(L.l2.pk)[q];
          return Quad{L2S ? reinterpret_cast<const int4*>(L.l2.tag)[q]
                          : int4{},
                      {}, {}, {}, pk};
        },
        [&](size_t q, const Quad& e) {
          const size_t g = o2 / 4 + q;
          const uchar4 k = e.valid;  // the packed bytes
          if (L2S) reinterpret_cast<int4*>(p.l2.tags)[g] = e.tag;
          reinterpret_cast<uchar4*>(p.l2.valid)[g] =
              make_uchar4(k.x & 1, k.y & 1, k.z & 1, k.w & 1);
          reinterpret_cast<int4*>(p.l2.btype)[g] =
              make_int4((k.x >> 1) & 3, (k.y >> 1) & 3, (k.z >> 1) & 3,
                        (k.w >> 1) & 3);
          reinterpret_cast<int4*>(p.l2.rrpv)[g] =
              make_int4(k.x >> 3, k.y >> 3, k.z >> 3, k.w >> 3);
        });
  } else {
    batched(
        n2,
        [&](size_t i) {
          return Entry{L2S ? L.l2.tag[i] : 0, 0, 0, 0, 0, 0, L.l2.pk[i]};
        },
        [&](size_t i, const Entry& e) {
          const size_t g = o2 + i;
          if (L2S) p.l2.tags[g] = e.tag;
          p.l2.valid[g] = e.pk & 1u;
          p.l2.btype[g] = (e.pk >> 1) & 3;
          p.l2.rrpv[g] = e.pk >> 3;
        });
  }
}

using KernelFn = void (*)(const Params);

// Every instantiation: its composition, its placement (L2 cache, L2 TLB
// in shared memory) and its entry.  The radix and Victima compositions
// are built in every placement, the others with the whole lane in shared
// memory (the placement of every system the port registers with them).
struct Instantiation {
  int comp;
  bool l2_shared, l2tlb_shared;
  bool dyn;  // a ladder's: per-lane parameters (Params::dyn)
  KernelFn fn;
};

template <int C>
constexpr Instantiation shared_only() {
  return {C, true, true, false, mmu_step_kernel<true, true, C, false>};
}

template <int C>
constexpr Instantiation placed(bool l2s, bool ts) {
  return {C, l2s, ts, false,
          l2s ? (ts ? mmu_step_kernel<true, true, C, false>
                    : mmu_step_kernel<true, false, C, false>)
              : (ts ? mmu_step_kernel<false, true, C, false>
                    : mmu_step_kernel<false, false, C, false>)};
}

// a ladder's base composition, in the one placement its geometry takes
template <int C, bool L2S, bool TS>
constexpr Instantiation ladder() {
  return {C, L2S, TS, true, mmu_step_kernel<L2S, TS, C, true>};
}

// the ladders' base compositions (sim.systems.ladder_base_config): the
// native family's union of every gated stage, at the ladder maximum (an
// 8192 x 16 L2 cache and L2 TLB: placement `device`), and the nested
// family's, at Table 3 (placement `shared`)
constexpr int C_LADDER_NATIVE = C_VICTIMA | C_L3TLB | C_POM | C_RESTSEG | C_REV;
constexpr int C_LADDER_NP = C_NESTED | C_VICTIMA | C_POM;

const Instantiation kInstantiations[] = {
    placed<0>(true, true), placed<0>(true, false), placed<0>(false, true),
    placed<0>(false, false), placed<C_VICTIMA>(true, true),
    placed<C_VICTIMA>(true, false), placed<C_VICTIMA>(false, true),
    placed<C_VICTIMA>(false, false), shared_only<C_L3TLB>(),
    shared_only<C_POM>(), shared_only<C_NESTED>(),
    shared_only<C_NESTED | C_VICTIMA>(), shared_only<C_NESTED | C_POM>(),
    shared_only<C_COLLECT>(), shared_only<C_RESTSEG>(),
    shared_only<C_RESTSEG | C_VICTIMA>(), shared_only<C_REV>(),
    shared_only<C_REV | C_VICTIMA>(),
    ladder<C_LADDER_NATIVE, false, false>(), ladder<C_LADDER_NP, true, true>(),
};
constexpr int kNumInstantiations =
    sizeof(kInstantiations) / sizeof(kInstantiations[0]);

// the dense number of a launch's instantiation, from its composition and
// placement; -1 for a pair that is not built
int instantiation_of(const Params& p) {
  for (int i = 0; i < kNumInstantiations; ++i) {
    const Instantiation& k = kInstantiations[i];
    if (k.comp == p.comp && k.l2_shared == (p.l2_shared != 0) &&
        k.l2tlb_shared == (p.l2tlb_shared != 0) &&
        k.dyn == (p.dyn != nullptr))
      return i;
  }
  return -1;
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

int mmu_step_params_size(void) { return static_cast<int>(sizeof(Params)); }

// the number of instantiations, and the composition code, placement
// (bit 1: L2 cache, bit 0: L2 TLB in shared memory) and ladder flag of
// instantiation i
int mmu_step_instantiations(void) { return kNumInstantiations; }
int mmu_step_instantiation(int i, int* comp, int* placement, int* dyn) {
  if (i < 0 || i >= kNumInstantiations) return -1;
  *comp = kInstantiations[i].comp;
  *placement = 2 * kInstantiations[i].l2_shared +
               kInstantiations[i].l2tlb_shared;
  *dyn = kInstantiations[i].dyn;
  return 0;
}

// Launch one block of 32 threads per lane over trace rows [t0, t1) on
// `stream`, on the calling thread's current device (the wrapper sets it
// to the state's); returns cudaGetLastError() (0 = launched), or -1 when
// p.smem_bytes disagrees with the plan or exceeds a block's limit.
int mmu_step_launch(Params p, void* stream) {
  p.plan = plan(p);
  const int bytes = p.plan.total;
  if (bytes != p.smem_bytes || bytes > SMEM_LIMIT) return -1;
  const int inst = instantiation_of(p);
  if (inst < 0) return -2;
  const KernelFn k = kInstantiations[inst].fn;
  // each instantiation's limit is raised to a block's most, once a device
  static bool raised[kNumInstantiations][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  bool& done = raised[inst][dev];
  if (!done) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  k<<<p.lanes, 32, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mmu_step_error_string(int err) {
  if (err == -1)
    return "shared-memory bytes of the launch disagree with the kernel's "
           "plan, or exceed a block's 232,448";
  if (err == -2)
    return "no instantiation of the kernel for this composition, placement "
           "and ladder flag";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
