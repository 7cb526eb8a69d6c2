// Per-access MMU step of the radix and Victima translation pipelines,
// run over a block of the trace: the CUDA kernel behind
// repro_torch.kernels.mmu_step.blocked_scan.
//
// Replaces the TPU kernel src/repro/kernels/mmu_step.py:105
// `_blocked_scan_impl` (its pl.pallas_call at :162, entered by
// `blocked_scan` at :177).  That kernel is generic because it traces any
// step to a jaxpr; this one writes out the two compositions of
// repro.core.mmu.make_step that the port simulates:
//   radix   l1_tlb, l2_tlb, ptw            fills: ptw, l2_tlb, l1_tlb
//   victima l1_tlb, l2_tlb, victima, ptw   fills: l2_tlb, victima, l1_tlb
// It must equal the plain PyTorch step (repro_torch.core.mmu.make_step)
// bit for bit, so every operation follows that code's order; the
// comments name the reference function each block mirrors.
//
// Design.  One warp (a block of 32 threads) per lane; thread w owns way w
// of every row, so a 16-way row is one coalesced load, the first hit of
// a row is a ballot (`__ffs`, 0 when no bit is set, like jnp.argmax of an
// all-false mask) and argmin/argmax are shuffle reductions that keep the
// lowest index on ties.  Scalars are computed redundantly by every
// thread (all control flow is warp-uniform) and written by thread 0;
// `__syncwarp` separates every write from the reads before and after
// it.  An insert, touch or walk whose enable is false writes nothing in
// the reference (every store is a `where(en, new, old)`), so it returns
// early here.
// The whole MMUState stays in device memory, in the tensors the wrapper
// allocated (bools as bytes), and persists between launches; each launch
// loops over trace rows [t0, t1).
//
// Bound.  Each access is a chain of dependent loads: the L1-TLB rows, the
// L2-TLB row, then for every walk level an L2-cache row, an L3 row and
// the inserts they trigger, then the data access with its prefetch and
// two background lines.  The next load's address depends on the last
// one's tag compare, so a lane runs at the latency of that chain, not at
// the card's memory or arithmetic rate: the kernel is latency-bound.
// Lanes are independent, so the card is mostly idle at a few lanes.
// chip_smoke.py's latency_floor counts the rounds of that chain from a
// run's Stats and charges each the L1- or L2-hit latency it measures
// (csrc/load_latency.cu).
// Keeping the TLBs and PWCs in shared memory is later work.
//
// Exactness.  int32 arithmetic that wraps in the reference (the
// background-line hash) is done in uint32; float sums use __fadd_rn /
// __fmul_rn in float (never double), one access at a time, and the file
// is compiled with -fmad=false.

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
constexpr int LINE_B = 1 << 29, LINE_W = 1 << 22;
constexpr int LEAF4_BASE = LINE_B + 0 * LINE_W;
constexpr int PD_BASE = LINE_B + 1 * LINE_W;
constexpr int PDP_BASE = LINE_B + 2 * LINE_W;
constexpr int PML4_BASE = LINE_B + 3 * LINE_W;
constexpr uint32_t BG_MUL = static_cast<uint32_t>(-1640531527);
constexpr uint32_t BG_SALT0 = static_cast<uint32_t>(-1640531527);
constexpr uint32_t BG_SALT1 = static_cast<uint32_t>(-2048144789);
constexpr uint32_t BG_MASK = (1u << 26) - 1;

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
      *n_victima_hit, *n_demand_ptw, *n_bg_ptw;
  float *sum_trans_cyc, *sum_l2miss_cyc, *sum_data_cyc, *sum_walk_cyc;
  int32_t* hist_walk;
  float *sum_tlb4_live, *sum_tlb2_live;
};
struct TraceP {
  int32_t* vpn;
  uint8_t* is2m;
  int32_t* line;
  float* ipa;
};
struct Params {
  AssocP l1d4, l1d2, l2tlb, pml4, pdp, pd, l1d, l3;
  L2P l2;
  CountersP pc4, pc2;
  HierCountP hier;
  StatsP stats;
  TraceP trace;
  int32_t* now;
  int32_t lanes, t0, t1;
  int32_t victima, tlb_aware, use_ptwcp;
  float pressure_mpki, bypass_l2mpki;
  int32_t l1tlb_lat, l2tlb_lat;
  int32_t lat_l1d, lat_l2, lat_l3, lat_dram;
};

namespace {

// ------------------------------------------------------- lane views
struct Assoc {
  int32_t* tags;
  uint8_t* valid;
  int32_t* meta;
  int sets, ways;
};
struct L2 {
  int32_t* tags;
  uint8_t* valid;
  int32_t *rrpv, *btype, *reuse, *hist_data, *hist_tlb;
  int32_t *n_tlb4, *n_tlb2, *n_ntlb;
  int sets, ways;
};
struct Lane {
  Assoc l1d4, l1d2, l2tlb, pml4, pdp, pd, l1d, l3;
  L2 l2;
  uint8_t *f4, *c4, *f2, *c2;
  int n4, n2;
  int32_t *n_l2_access, *n_l2_miss, *n_l3_access, *n_l3_trans;
  bool tlb_aware;
  int lat_l1d, lat_l2, lat_l3, lat_dram;
};

__device__ Assoc view(const AssocP& a, int b) {
  const size_t o = static_cast<size_t>(b) * a.sets * a.ways;
  return {a.tags + o, a.valid + o, a.meta + o, a.sets, a.ways};
}

__device__ L2 view(const L2P& c, int b) {
  const size_t o = static_cast<size_t>(b) * c.sets * c.ways;
  const size_t h = static_cast<size_t>(b) * REUSE_BUCKETS;
  return {c.tags + o, c.valid + o, c.rrpv + o, c.btype + o, c.reuse + o,
          c.hist_data + h, c.hist_tlb + h, c.n_tlb4 + b, c.n_tlb2 + b,
          c.n_ntlb + b, c.sets, c.ways};
}

__device__ __forceinline__ int tid() { return threadIdx.x; }
__device__ __forceinline__ void sync() { __syncwarp(kFull); }

// jnp.argmax of a bool row: the first set way, 0 when none is set
__device__ __forceinline__ int first_way(unsigned m) {
  return m ? __ffs(m) - 1 : 0;
}

// lowest-index argmax / argmin and max over the row's ways
__device__ int argmax_way(int v, int ways) {
  int best = tid() < ways ? v : INT_MIN;
  int idx = tid() < ways ? tid() : 32;
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov > best || (ov == best && oi < idx)) {
      best = ov;
      idx = oi;
    }
  }
  return idx;
}

__device__ int argmin_way(int v, int ways) {
  int best = tid() < ways ? v : INT_MAX;
  int idx = tid() < ways ? tid() : 32;
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < best || (ov == best && oi < idx)) {
      best = ov;
      idx = oi;
    }
  }
  return idx;
}

__device__ int max_way(int v, int ways) {
  int best = tid() < ways ? v : INT_MIN;
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, off));
  return best;
}

struct Probe {
  bool hit;
  int set, way;
};

// assoc.lookup
__device__ Probe lookup(const Assoc& a, int key) {
  const int s = key & (a.sets - 1);
  bool h = false;
  if (tid() < a.ways) {
    const int i = s * a.ways + tid();
    h = a.valid[i] && a.tags[i] == key;
  }
  const unsigned m = __ballot_sync(kFull, h);
  return {m != 0, s, first_way(m)};
}

// assoc.insert_lru; the evicted tag is reported even when disabled
// (Victima's counter slot 1 is indexed by it either way)
__device__ void insert_lru(const Assoc& a, int key, int now, bool en,
                           int* ev_tag = nullptr, bool* ev_valid = nullptr) {
  const int s = key & (a.sets - 1);
  int stamp = 0;
  if (tid() < a.ways) {
    const int i = s * a.ways + tid();
    stamp = a.valid[i] ? a.meta[i] : -1;
  }
  const int i = s * a.ways + argmin_way(stamp, a.ways);
  if (ev_tag != nullptr) {
    *ev_tag = a.tags[i];
    *ev_valid = a.valid[i] && en;
  }
  sync();
  if (en && tid() == 0) {
    a.tags[i] = key;
    a.valid[i] = 1;
    a.meta[i] = now;
  }
  sync();
}

struct Srrip {
  int aged;    // this thread's way, aged
  int victim;  // the way to replace
};

// assoc.srrip_age_and_pick
__device__ Srrip srrip_age_and_pick(int rrpv, bool valid, int ways) {
  const int eff = valid ? rrpv : RRIP_MAX + 1;
  const int bump = max(RRIP_MAX - max_way(eff, ways), 0);
  const int aged = valid ? rrpv + bump : rrpv;
  return {aged, argmax_way(valid ? aged : RRIP_MAX + 1, ways)};
}

// assoc.srrip_victim_tlb_aware (paper Listing 1)
__device__ Srrip srrip_victim_tlb_aware(int rrpv, bool valid, bool is_tlb,
                                        bool pressure, int ways) {
  Srrip r = srrip_age_and_pick(rrpv, valid, ways);
  const bool alt = tid() < ways && valid && !is_tlb && r.aged >= RRIP_MAX;
  const unsigned m = __ballot_sync(kFull, alt);
  const bool v0_valid = __shfl_sync(kFull, static_cast<int>(valid), r.victim);
  const bool v0_tlb = __shfl_sync(kFull, static_cast<int>(is_tlb), r.victim);
  if (pressure && v0_valid && v0_tlb && m != 0) r.victim = first_way(m);
  return r;
}

// caches.l2_lookup
__device__ Probe l2_lookup(const L2& c, int key, int bt) {
  const int s = key & (c.sets - 1);
  bool h = false;
  if (tid() < c.ways) {
    const int i = s * c.ways + tid();
    h = c.valid[i] && c.tags[i] == key && c.btype[i] == bt;
  }
  const unsigned m = __ballot_sync(kFull, h);
  return {m != 0, s, first_way(m)};
}

// caches.l2_touch
__device__ void l2_touch(const L2& c, const Probe& p, bool pressure,
                         bool tlb_aware, bool en) {
  if (!en) return;
  sync();
  if (tid() == 0) {
    const int i = p.set * c.ways + p.way;
    const int dec = (c.btype[i] != BT_DATA && pressure && tlb_aware) ? 3 : 1;
    c.rrpv[i] = max(c.rrpv[i] - dec, 0);
    c.reuse[i] += 1;
  }
  sync();
}

__device__ void live_add(const L2& c, int bt, int d) {
  if (bt == BT_TLB4) *c.n_tlb4 += d;
  else if (bt == BT_TLB2) *c.n_tlb2 += d;
  else if (bt == BT_NTLB) *c.n_ntlb += d;
}

// caches.l2_insert (+ _account_evict on the row read before the insert)
__device__ void l2_insert(const L2& c, int key, int bt, bool pressure,
                          bool tlb_aware, bool en) {
  if (!en) return;
  const int s = key & (c.sets - 1);
  const bool act = tid() < c.ways;
  const int i = s * c.ways + tid();
  const int rr = act ? c.rrpv[i] : 0;
  const bool v = act && c.valid[i];
  const bool is_tlb = act && c.btype[i] != BT_DATA;
  const Srrip r = tlb_aware
      ? srrip_victim_tlb_aware(rr, v, is_tlb, pressure, c.ways)
      : srrip_age_and_pick(rr, v, c.ways);
  sync();
  const int ins_rrpv =
      (bt != BT_DATA && pressure && tlb_aware) ? 0 : RRIP_MAX - 1;
  if (act) c.rrpv[i] = tid() == r.victim ? ins_rrpv : r.aged;
  if (tid() == 0) {
    const int iw = s * c.ways + r.victim;
    if (c.valid[iw]) {
      const int bucket = min(c.reuse[iw], REUSE_BUCKETS - 1);
      if (c.btype[iw] == BT_DATA) c.hist_data[bucket] += 1;
      else c.hist_tlb[bucket] += 1;
      live_add(c, c.btype[iw], -1);
    }
    c.tags[iw] = key;
    c.valid[iw] = 1;
    c.btype[iw] = bt;
    c.reuse[iw] = 0;
    live_add(c, bt, 1);
  }
  sync();
}

// caches.l2_retag_to_tlb
__device__ void l2_retag_to_tlb(const L2& c, int key, int bt, bool pressure,
                                bool tlb_aware, bool en) {
  if (!en) return;
  const bool exists = l2_lookup(c, key, bt).hit;
  l2_insert(c, key, bt, pressure, tlb_aware, !exists);
}

// caches.l3_access: promote on a hit; on a miss age the row and insert
__device__ bool l3_access(const Assoc& a, int key, bool en) {
  const Probe p = lookup(a, key);
  if (!en) return p.hit;
  if (p.hit) {
    sync();
    if (tid() == 0) a.meta[p.set * a.ways + p.way] = 0;
    sync();
    return true;
  }
  const bool act = tid() < a.ways;
  const int i = p.set * a.ways + tid();
  const int m = act ? a.meta[i] : 0;
  const bool v = act && a.valid[i];
  const Srrip r = srrip_age_and_pick(m, v, a.ways);
  sync();
  if (act) a.meta[i] = tid() == r.victim ? RRIP_MAX - 1 : r.aged;
  if (tid() == 0) {
    const int iv = p.set * a.ways + r.victim;
    a.tags[iv] = key;
    a.valid[iv] = 1;
  }
  sync();
  return false;
}

__device__ int miss_cycles(const Lane& L, bool hit2, bool hit3) {
  return hit2 ? L.lat_l2 : hit3 ? L.lat_l3 : L.lat_l3 + L.lat_dram;
}

// caches.access_pte
__device__ int access_pte(const Lane& L, int line, bool pressure, bool en,
                          bool* dram) {
  *dram = false;
  if (!en) return 0;
  const Probe p2 = l2_lookup(L.l2, line, BT_DATA);
  l2_touch(L.l2, p2, pressure, L.tlb_aware, p2.hit);
  const bool go_l3 = !p2.hit;
  const bool hit3 = l3_access(L.l3, line, go_l3);
  l2_insert(L.l2, line, BT_DATA, pressure, L.tlb_aware, go_l3);
  *dram = go_l3 && !hit3;
  if (go_l3 && tid() == 0) {
    *L.n_l3_access += 1;
    *L.n_l3_trans += 1;
  }
  sync();
  return miss_cycles(L, p2.hit, hit3);
}

// page_table.walk: PWCs probed before the walk, `start` fixed before fills
__device__ int walk(const Lane& L, int vpn4k, bool is2m, int now,
                    bool pressure, bool en, int* n_dram) {
  *n_dram = 0;
  if (!en) return 0;
  const int vpn2 = vpn4k >> 9;
  const int lines[4] = {
      is2m ? PML4_BASE + ((vpn2 >> 18) >> 3) : PML4_BASE + ((vpn4k >> 27) >> 3),
      is2m ? PDP_BASE + ((vpn2 >> 9) >> 3) : PDP_BASE + ((vpn4k >> 18) >> 3),
      is2m ? PD_BASE + (vpn2 >> 3) : PD_BASE + ((vpn4k >> 9) >> 3),
      LEAF4_BASE + (vpn4k >> 3)};
  const int n_levels = is2m ? 3 : 4;
  const int k_pml4 = is2m ? vpn2 >> 18 : vpn4k >> 27;
  const int k_pdp = is2m ? vpn2 >> 9 : vpn4k >> 18;
  const int k_pd = vpn4k >> 9;
  const bool hit4 = lookup(L.pml4, k_pml4).hit;
  const bool hit3 = lookup(L.pdp, k_pdp).hit;
  const bool hit2 = lookup(L.pd, k_pd).hit && !is2m;
  int start = hit2 ? 3 : hit3 ? 2 : hit4 ? 1 : 0;
  if (is2m) start = min(start, 2);
  int cycles = PWC_LAT;
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    bool d;
    cycles += access_pte(L, lines[slot], pressure,
                         slot >= start && slot < n_levels, &d);
    *n_dram += d;
  }
  insert_lru(L.pml4, k_pml4, now, start <= 0);
  insert_lru(L.pdp, k_pdp, now, start <= 1);
  insert_lru(L.pd, k_pd, now, start <= 2 && !is2m);
  return cycles;
}

// caches.access_data
__device__ int access_data(const Lane& L, int line, int now, bool pressure) {
  const Probe p1 = lookup(L.l1d, line);
  // the L1D is touched unconditionally: a miss stamps way 0
  sync();
  if (tid() == 0) L.l1d.meta[p1.set * L.l1d.ways + p1.way] = now;
  sync();
  const Probe p2 = l2_lookup(L.l2, line, BT_DATA);
  const bool go_l2 = !p1.hit;
  l2_touch(L.l2, p2, pressure, L.tlb_aware, go_l2 && p2.hit);
  const bool go_l3 = go_l2 && !p2.hit;
  const bool hit3 = l3_access(L.l3, line, go_l3);
  l2_insert(L.l2, line, BT_DATA, pressure, L.tlb_aware, go_l3);
  const int nxt = line + 1;
  const bool pf_hit = l2_lookup(L.l2, nxt, BT_DATA).hit;
  l2_insert(L.l2, nxt, BT_DATA, pressure, L.tlb_aware, go_l3 && !pf_hit);
  insert_lru(L.l1d, line, now, go_l2);
  // two background lines; int32 wraparound of the reference as uint32
  const uint32_t h = static_cast<uint32_t>(now) * BG_MUL;
  for (const uint32_t salt : {BG_SALT0, BG_SALT1}) {
    const int bg = static_cast<int>((h ^ salt) & BG_MASK);
    const bool bg_hit3 = l3_access(L.l3, bg, true);
    l2_insert(L.l2, bg, BT_DATA, pressure, L.tlb_aware, !bg_hit3);
  }
  if (tid() == 0) {
    *L.n_l2_access += go_l2;
    *L.n_l2_miss += go_l3;
    *L.n_l3_access += go_l3;
  }
  sync();
  return p1.hit ? L.lat_l1d : miss_cycles(L, p2.hit, hit3);
}

__device__ __forceinline__ bool predict(int f, int c) {
  return c >= BOX_COST_LO && c <= BOX_COST_HI && f >= BOX_FREQ_LO &&
         f <= BOX_FREQ_HI;
}

__global__ void __launch_bounds__(32) mmu_step_kernel(const Params p) {
  const int b = blockIdx.x;
  const size_t n4o = static_cast<size_t>(b) * p.pc4.n;
  const size_t n2o = static_cast<size_t>(b) * p.pc2.n;
  const Lane L = {view(p.l1d4, b), view(p.l1d2, b), view(p.l2tlb, b),
                  view(p.pml4, b), view(p.pdp, b), view(p.pd, b),
                  view(p.l1d, b), view(p.l3, b), view(p.l2, b),
                  p.pc4.freq + n4o, p.pc4.cost + n4o,
                  p.pc2.freq + n2o, p.pc2.cost + n2o, p.pc4.n, p.pc2.n,
                  p.hier.n_l2_access + b, p.hier.n_l2_miss + b,
                  p.hier.n_l3_access + b, p.hier.n_l3_trans + b,
                  p.tlb_aware != 0, p.lat_l1d, p.lat_l2, p.lat_l3,
                  p.lat_dram};
  const StatsP& S = p.stats;
  int32_t* const now_p = p.now + b;
  const bool victima = p.victima != 0;
  const bool tlb_aware = L.tlb_aware;

  for (int t = p.t0; t < p.t1; ++t) {
    const size_t ti = static_cast<size_t>(t) * p.lanes + b;
    const int vpn = p.trace.vpn[ti];
    const bool is2m = p.trace.is2m[ti] != 0;
    const int line = p.trace.line[ti];
    const float ipa = p.trace.ipa[ti];

    // mmu.make_step: the step's signals read the stats before the access
    const int now = *now_p + 1;
    const float instrs =
        __fmul_rn(fmaxf(__int2float_rn(S.n_access[b]), 1.0f), ipa);
    const bool pressure =
        __fmul_rn(__int2float_rn(S.n_l2tlb_miss[b]), 1000.0f) >
        __fmul_rn(p.pressure_mpki, instrs);
    const bool bypass = __fmul_rn(__int2float_rn(*L.n_l2_miss), 1000.0f) >=
                        __fmul_rn(p.bypass_l2mpki, instrs);
    sync();
    if (tid() == 0) *now_p = now;
    sync();
    const int vpn2 = vpn >> 9;
    const int vpn_sz = is2m ? vpn2 : vpn;
    const int key2 = (vpn_sz << 1) | static_cast<int>(is2m);

    // stages.l1_tlb lookup
    const Probe q4 = lookup(L.l1d4, vpn);
    const Probe q2 = lookup(L.l1d2, vpn2);
    const bool hit1 = is2m ? q2.hit : q4.hit;
    sync();
    if (tid() == 0) {
      if (q4.hit && !is2m) L.l1d4.meta[q4.set * L.l1d4.ways + q4.way] = now;
      if (q2.hit && is2m) L.l1d2.meta[q2.set * L.l1d2.ways + q2.way] = now;
    }
    sync();
    const bool miss1 = !hit1;
    int trans = p.l1tlb_lat;

    // stages.l2_tlb lookup
    const Probe qt = lookup(L.l2tlb, key2);
    const bool l2hit = miss1 && qt.hit;
    sync();
    if (l2hit && tid() == 0) L.l2tlb.meta[qt.set * L.l2tlb.ways + qt.way] = now;
    sync();
    trans += miss1 ? p.l2tlb_lat : 0;
    const bool miss2 = miss1 && !l2hit;
    bool need = miss2;
    int past = 0;

    // stages.victima lookup
    bool vhit = false;
    int vkey = 0, vbt = BT_TLB4;
    if (victima) {
      vkey = is2m ? vpn2 >> 3 : vpn >> 3;
      vbt = is2m ? BT_TLB2 : BT_TLB4;
      const Probe qv = l2_lookup(L.l2, vkey, vbt);
      vhit = need && qv.hit;
      l2_touch(L.l2, qv, pressure, tlb_aware, vhit);
      past += vhit ? L.lat_l2 : 0;
      need = need && !vhit;
    }

    // stages.ptw lookup: the demand walk
    const bool walk_en = need;
    int ndram;
    const int wcyc = walk(L, vpn, is2m, now, pressure, walk_en, &ndram);
    past += wcyc;

    bool bg = false;
    if (victima) {
      // stages.l2_tlb fill
      int ev_tag;
      bool ev_valid;
      insert_lru(L.l2tlb, key2, now, miss2, &ev_tag, &ev_valid);
      // stages.victima fill: counters read once, before the walks
      const int ev_vpn = ev_tag >> 1;
      const bool ev2m = (ev_tag & 1) != 0;
      const int bg_vpn4 = ev2m ? ev_vpn << 9 : ev_vpn;
      const int i4[2] = {vpn & (L.n4 - 1), bg_vpn4 & (L.n4 - 1)};
      const int i2[2] = {vpn2 & (L.n2 - 1), ev_vpn & (L.n2 - 1)};
      const int f4[2] = {L.f4[i4[0]], L.f4[i4[1]]};
      const int c4[2] = {L.c4[i4[0]], L.c4[i4[1]]};
      const int f2[2] = {L.f2[i2[0]], L.f2[i2[1]]};
      const int c2[2] = {L.c2[i2[0]], L.c2[i2[1]]};
      const int fpost = (is2m ? f2[0] : f4[0]) + walk_en;
      const int cpost = (is2m ? c2[0] : c4[0]) + (walk_en && ndram >= 1);
      const bool pred = !p.use_ptwcp ||
                        predict(min(fpost, FREQ_MAX), min(cpost, COST_MAX));
      l2_retag_to_tlb(L.l2, vkey, vbt, pressure, tlb_aware,
                      walk_en && (pred || bypass));
      const bool epred = !p.use_ptwcp ||
                         predict(ev2m ? f2[1] : f4[1], ev2m ? c2[1] : c4[1]);
      bg = miss2 && ev_valid && (epred || bypass);
      int bdram;
      walk(L, bg_vpn4, ev2m, now, pressure, bg, &bdram);
      l2_retag_to_tlb(L.l2, ev_vpn >> 3, ev2m ? BT_TLB2 : BT_TLB4, pressure,
                      tlb_aware, bg);
      // fused counter writeback: slot 0 then slot 1 (slot 1 wins a tie)
      sync();
      if (tid() == 0) {
        const bool en4[2] = {walk_en && !is2m, bg && !ev2m};
        const bool en2[2] = {walk_en && is2m, bg && ev2m};
        const bool dr[2] = {ndram >= 1, bdram >= 1};
        for (int k = 0; k < 2; ++k) {
          L.f4[i4[k]] = static_cast<uint8_t>(min(f4[k] + en4[k], FREQ_MAX));
          L.c4[i4[k]] =
              static_cast<uint8_t>(min(c4[k] + (en4[k] && dr[k]), COST_MAX));
          L.f2[i2[k]] = static_cast<uint8_t>(min(f2[k] + en2[k], FREQ_MAX));
          L.c2[i2[k]] =
              static_cast<uint8_t>(min(c2[k] + (en2[k] && dr[k]), COST_MAX));
        }
      }
      sync();
    } else {
      // stages.ptw fill (fill_walk_counters), then stages.l2_tlb fill
      if (walk_en && tid() == 0) {
        uint8_t* f = is2m ? L.f2 : L.f4;
        uint8_t* c = is2m ? L.c2 : L.c4;
        const int i = is2m ? vpn2 & (L.n2 - 1) : vpn & (L.n4 - 1);
        f[i] = static_cast<uint8_t>(min(f[i] + 1, FREQ_MAX));
        c[i] = static_cast<uint8_t>(min(c[i] + (ndram >= 1), COST_MAX));
      }
      sync();
      insert_lru(L.l2tlb, key2, now, miss2);
    }
    // stages.l1_tlb fill
    insert_lru(L.l1d4, vpn, now, miss1 && !is2m);
    insert_lru(L.l1d2, vpn2, now, miss1 && is2m);
    trans += past;

    const int dcyc = access_data(L, line, now, pressure);

    // stages.fold.accum_stats, in the reference's order
    sync();
    if (tid() == 0) {
      S.n_access[b] += 1;
      S.n_l1tlb_hit[b] += hit1;
      S.n_l2tlb_hit[b] += l2hit;
      S.n_l2tlb_miss[b] += miss2;
      S.n_victima_hit[b] += vhit;
      S.n_demand_ptw[b] += walk_en;
      S.n_bg_ptw[b] += bg;
      S.sum_trans_cyc[b] = __fadd_rn(S.sum_trans_cyc[b], __int2float_rn(trans));
      S.sum_l2miss_cyc[b] =
          __fadd_rn(S.sum_l2miss_cyc[b], __int2float_rn(miss2 ? past : 0));
      S.sum_data_cyc[b] = __fadd_rn(S.sum_data_cyc[b], __int2float_rn(dcyc));
      S.sum_walk_cyc[b] =
          __fadd_rn(S.sum_walk_cyc[b], __int2float_rn(walk_en ? wcyc : 0));
      S.hist_walk[b * WALK_HIST_BUCKETS +
                  min(wcyc / 10, WALK_HIST_BUCKETS - 1)] += walk_en;
      S.sum_tlb4_live[b] =
          __fadd_rn(S.sum_tlb4_live[b], __int2float_rn(*L.l2.n_tlb4));
      S.sum_tlb2_live[b] =
          __fadd_rn(S.sum_tlb2_live[b], __int2float_rn(*L.l2.n_tlb2));
    }
    sync();
  }
}

}  // namespace

extern "C" {

int mmu_step_params_size(void) { return static_cast<int>(sizeof(Params)); }

// Launch one block of 32 threads per lane over trace rows [t0, t1) on
// `stream`, on the calling thread's current device (the wrapper sets it
// to the state's); returns cudaGetLastError() (0 = launched).
int mmu_step_launch(Params p, void* stream) {
  mmu_step_kernel<<<p.lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mmu_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
