// GQA decode attention over a paged KV pool: the CUDA kernel behind
// repro_torch.kernels.paged_attention.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:73
// `paged_attention` (body `_kernel` at :28, pl.pallas_call at :104).
// That kernel prefetches the block table and the context lengths into
// scalar memory, walks a grid (B, K, nb) whose last dimension runs in
// order, and lets the BlockSpec index maps gather physical page
// tables[b, i] for each step, with the online-softmax state in VMEM
// scratch.  It takes any head width and any group G = H / K.
//
// Bound.  Decode reads every K and V row up to lens[b] once and does 4*G
// float32 operations per K/V element (q.k and p.v), at most 4*G / 2 per
// byte of bf16: G <= 16 here, so bytes bound it on this card (3.35 TB/s
// against 67 TFLOP/s of float32 FMA).
//
// Design.  One (request b, kv head) is split over `splits` CTAs, the
// grid (splits, K, B).  Each CTA (rank r of S) reads lens[b] itself and
// takes its balanced share of the live context in whole CHUNK-token
// chunks: chunks [r*C/S, (r+1)*C/S) of the C = ceil(len / CHUNK) live
// ones, and produces a partial online softmax (m, l, acc[G, hd]) in its
// own shared memory.  The launch planner (paged_attention_plan; the
// wrapper's `plan` is its mirror), a function of the shapes alone, picks
// the split count and one of two forms of the merge:
//  - the cluster form: the S CTAs are a thread-block cluster (cluster
//    dims (S, 1, 1)); after cluster.sync() each CTA merges its slice of
//    the G*hd outputs from all S partials through distributed shared
//    memory (map_shared_rank), every remote read issued before any is
//    used: one launch, no scratch in device memory.  Its split count
//    keeps every cluster of a launch on the card at once (an H100 holds
//    only 124 clusters of 4 CTAs, 62 of 8 and 28 of 16 at four CTAs an
//    SM: cluster_slots);
//  - the two-pass form: no cluster, the partials go to a float32 scratch
//    the wrapper allocates, and merge_kernel merges them in a second
//    launch, one thread an output element.
// The cluster form where it fills the card (a CTA an SM or more) with
// short shares (at most TWO_PASS_TOKENS of capacity a CTA), or where a
// pair is one CTA; the two-pass form, at the uncapped split count,
// elsewhere.  Measured on an H100 (PERF.md): granite-3-2b's decode ran
// faster in the cluster form, qwen3-32b's at 4096 tokens (clusters of 4
// would leave a CTA 1024 tokens) and recurrentgemma-2b's (8 clusters of
// 16, under a CTA an SM) in the two-pass form.
//
// Within a CTA (4 warps): K and V rows are staged in their storage type
// through a 3-stage shared-memory ring with 16-byte cp.async, each
// address from tables[b, tok / page] (pages are gathered where they lie,
// never copied), 16-byte chunks XOR-swizzled by row so that eight rows
// read at one column hit distinct banks.  G rows are split over WG warp
// row groups of at most GB rows, tokens over the WT = 4 / WG warps of a
// row group.  For p.v a row is spread over LPT lanes of a warp, EPL
// consecutive elements each, widened to float32 in registers, so a warp
// takes TPS = 32 / LPT tokens a step and each V row read feeds all of the
// warp's query rows.  q.k runs one of two ways:
//  - bf16 q and K/V at hd 64 and 128 (the decode path's type and the
//    widths of the dense configs): on the tensor cores, mma.sync
//    m16n8k16 with the warp's q rows as A fragments and K tiles by
//    ldmatrix.  A bf16 product is exact in float32 and the sums are
//    float32, so the scores are float32 scores; the warp's softmax is
//    kept by the lanes that hold the C fragments, and the weights reach
//    the p.v lanes through shared memory.
//  - every other (dtype, width): on the CUDA cores, the row layout of
//    p.v, each lane's partial dot products reduce-scattered over the
//    LPT lanes of a token so each lane keeps a few whole sums and takes
//    their exps once; each lane group runs its own online softmax.
// Scores are base 2, 1/sqrt(hd) * log2(e) folded in.
//
// Numerics follow the Pallas body: float32 scores, softmax and PV, p kept
// in float32 (paged_attention.py:62), the output acc / max(l, 1e-30) in
// q's type.  Tokens at or past lens[b] get weight 0 (the Pallas body
// scores them -1e30, which gives the same 0 wherever a live token sets
// the max); a stream that saw no live token keeps m = -1e30, l = 0,
// acc = 0, which every merge weighs by 0 -- or, when no token of the
// context is live (lens[b] = 0), by 1, giving zeros as the parent kernel
// and the Pallas body do.  -1e30, never -inf: no merge forms inf - inf.

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Outside the unnamed namespace: the exported launch function takes it by
// value, and a parameter type with internal linkage would keep that
// function out of the library's symbols.
struct PagedArgs {
  const void* q;        // [B, H, hd] contiguous
  const void* k_pages;  // [P, page, K, hd] contiguous, 16-byte aligned
  const void* v_pages;  // [P, page, K, hd] contiguous, 16-byte aligned
  const int* tables;    // [B, nb] physical page ids
  const int* lens;      // [B] context lengths
  void* o;              // [B, H, hd] contiguous, q's type
  int B, H, K, page, nb;
  float scale;          // 1/sqrt(hd)
};

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GB = 4;                  // query rows a warp holds at most
constexpr int GMAX = WARPS * GB;       // query rows per kv head
constexpr int CHUNK = 64;              // tokens: the unit of a CTA's share
constexpr int MAX_SPLITS = 16;         // CTAs of a cluster (> 8: non-portable)
constexpr int SMS = 132;               // H100 SXM: the planner's target
constexpr int STAGES = 3;              // depth of the K/V ring
constexpr int STAGE_BYTES = 16384;     // K and V rows of one ring stage
constexpr int MMA_TOKENS = 16;         // tokens of a tensor-core step, at most
// the tail of shared memory: (m, l) of the warps' and the CTA's partials,
// then each warp's weights [GB][MMA_TOKENS] and corrections [GB]
constexpr int WARP_TAIL = GB * MMA_TOKENS + GB;
constexpr int TAIL_FLOATS = 4 * GMAX + WARPS * WARP_TAIL;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_UNPLACEABLE = 100000;  // no cluster of the plan fits
// a CTA's share of the capacity, at most, in the cluster form (plan_form)
constexpr int TWO_PASS_TOKENS = 512;

constexpr int cmin(int x, int y) { return x < y ? x : y; }
constexpr int cmax(int x, int y) { return x > y ? x : y; }

// Clusters of s CTAs an H100 holds at once at four CTAs an SM (shared
// memory 13-51 KB, 128 registers a thread; cudaOccupancyMaxActiveClusters
// on the card): from 4 CTAs a cluster is placed within a GPC, and the SMs
// a GPC has beyond a multiple of its span go unused.
constexpr int cluster_slots(int s) {
  return s <= 2 ? 4 * SMS / s : (s == 4 ? 124 : (s == 8 ? 62 : 28));
}

// The shape of the work for one (q dtype, kv dtype, head width); all
// powers of 2.
template <typename TQ, typename TKV, int HD>
struct Geom {
  static constexpr int ES = sizeof(TKV);
  static constexpr int VEC = 16 / ES;               // elements per cp.async
  static constexpr int VPR = HD / VEC;              // cp.asyncs per row
  static constexpr int EPL = cmax(HD / 32, VEC);    // row elements a lane
  static constexpr int LPT = HD / EPL;              // lanes per token
  static constexpr int TPS = 32 / LPT;              // tokens per warp step
  static constexpr int ST =
      cmin(CHUNK, STAGE_BYTES / (2 * HD * ES));     // tokens per stage
  // tokens a lane group takes together: the fewest it has in a stage
  // (4 warps on the tokens), at most 4
  static constexpr int UB = cmin(4, ST / (WARPS * TPS));
  // q.k on the tensor cores: NT n8 tiles make a step's UB * TPS tokens
  static constexpr bool MMA = std::is_same<TQ, __nv_bfloat16>::value &&
                              std::is_same<TKV, __nv_bfloat16>::value &&
                              (HD == 64 || HD == 128);
  static constexpr int NT = UB * TPS / 8;
  // On the CUDA cores, a step's N partial dot products (g * UB + u) are
  // reduce-scattered over the LPT lanes of a token: lane c keeps the NF
  // sums from (c / DUP) * NF, DUP lanes keeping the same ones; they cover
  // RPL rows of VPRL tokens each, and a row's sums lie in LR consecutive
  // lanes.
  static constexpr int N = UB * GB;
  static constexpr int NF = cmax(1, N / LPT);
  static constexpr int DUP = cmax(1, LPT / N);
  static constexpr int VPRL = cmin(NF, UB);
  static constexpr int RPL = NF / VPRL;
  static constexpr int LR = NF < UB ? UB / NF * DUP : DUP;
  static constexpr int RING = STAGES * 2 * ST * HD * ES;  // K, V stages
  static constexpr int SMEM = RING + TAIL_FLOATS * 4;
  static_assert(UB >= 1 && CHUNK % ST == 0, "a chunk is whole stages");
  static_assert(ST * VPR % THREADS == 0, "a stage is whole copy rounds");
  static_assert(RING >= GMAX * HD * 4, "the partials fit in the ring");
  static_assert(!MMA || (UB == 4 && UB * TPS <= MMA_TOKENS &&
                         UB * TPS % 8 == 0),
                "a tensor-core step is whole n8 tiles of the tail's size");
};

// The 16-byte chunk of stage row t that holds logical chunk k: rows of 8
// chunks or more XOR k with t % 8, so 8 rows read at one chunk (ldmatrix,
// and a lane group's 16-byte loads) fall in 8 distinct bank groups.
template <int HD, int ES>
__device__ __forceinline__ int swz(int t, int k) {
  return HD * ES / 16 >= 8 ? k ^ (t & 7) : k;
}

// Sums of v[i] over the lanes of a token, scattered: the round of lane
// bit O halves the n values a lane holds, the lanes with bit O keeping
// the upper half, so after the rounds O = LPT / 2 ... 1 lane c (of a
// token's LPT) holds the NF sums from (c / DUP) * NF in v[0, NF); rounds
// after a lane is down to one value add it whole.
template <int O, int n, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int c) {
  if constexpr (O > 0) {
    if constexpr (n > 1) {
      const bool up = c & O;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? v[i] : v[i + n / 2];
        const float keep = up ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<O / 2, n / 2>(v, c);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<O / 2, 1>(v, c);
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// c += a . b, m16n8k16, bf16 in, float32 accumulate; A's rows 8-15
// (a1, a3) are zero
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void widen(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

// lane column c's EPL elements of stage row t, widened to float32
template <int HD, int EPL, typename TKV>
__device__ __forceinline__ void load_row(const TKV* stage, int t, int c,
                                         float (&x)[EPL]) {
  constexpr int VEC = 16 / sizeof(TKV), P16 = EPL / VEC;
#pragma unroll
  for (int k = 0; k < P16; ++k)
    widen(stage + t * HD + swz<HD, sizeof(TKV)>(t, c * P16 + k) * VEC,
          x + k * VEC);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One output element from S <= MAX_SPLITS partials (m, l, acc), read
// through the three accessors: every read is issued before any is used,
// so the S reads cost one latency.  A partial with no live token (m =
// -1e30, l = acc = 0) weighs 0, or 1 when none has any: the result is 0.
template <typename FM, typename FL, typename FA>
__device__ __forceinline__ float merge_partials(int S, FM fm, FL fl,
                                                FA fa) {
  float mr[MAX_SPLITS], lr[MAX_SPLITS], ar[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    if (r < S) {
      mr[r] = fm(r);
      lr[r] = fl(r);
      ar[r] = fa(r);
    }
  }
  float M = NEG_INF;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r)
    if (r < S) M = fmaxf(M, mr[r]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    if (r < S) {
      const float f = exp2f(mr[r] - M);
      L += lr[r] * f;
      A += ar[r] * f;
    }
  }
  return A / fmaxf(L, 1e-30f);
}

// TWO_PASS: the CTA's partial goes to `scratch` (merge_kernel merges),
// and the launch has no cluster; else `scratch` is unused
template <typename TQ, typename TKV, int HD, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS, 4)
    paged_kernel(PagedArgs a, float* scratch) {
  using Gm = Geom<TQ, TKV, HD>;
  constexpr int EPL = Gm::EPL, LPT = Gm::LPT, TPS = Gm::TPS, ST = Gm::ST;
  constexpr int UB = Gm::UB, VEC = Gm::VEC, VPR = Gm::VPR, ES = Gm::ES;
  constexpr int N = Gm::N, NF = Gm::NF, DUP = Gm::DUP, VPRL = Gm::VPRL;
  constexpr int RPL = Gm::RPL, LR = Gm::LR, NT = Gm::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* part = reinterpret_cast<float*>(smem);  // after the ring is done
  float* m_w = reinterpret_cast<float*>(smem + Gm::RING);
  float* l_w = m_w + GMAX;
  float* m_c = l_w + GMAX;
  float* l_c = m_c + GMAX;

  // the CTAs of one (request, kv head): a cluster of gridDim.x
  const int S = gridDim.x, rank = blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* w_p = l_c + GMAX + warp * WARP_TAIL;  // this warp's weights
  float* w_corr = w_p + GB * MMA_TOKENS;       // ... and corrections

  // this warp's query rows [g0, g0 + gn) and its share of each stage
  const int WG = G <= GB ? 1 : (G <= 2 * GB ? 2 : 4);
  const int WT = WARPS / WG;
  const int wg = warp % WG, wt = warp / WG;
  const int R = (G + WG - 1) / WG;
  const int g0 = wg * R;
  const int gn = max(0, min(R, G - g0));
  const int j = lane / LPT, c = lane % LPT;  // lane group, column group
  const int per = ST / WT;                   // a warp's tokens per stage
  const int i0 = c / DUP * NF;               // the sums this lane keeps
  int rowk[RPL];                             // ... and their rows
#pragma unroll
  for (int k = 0; k < RPL; ++k) rowk[k] = (i0 + k * VPRL) / UB;

  // this CTA's tokens [t0, t1)
  const int len = max(0, min(a.lens[b], a.nb * a.page));
  const int live = (len + CHUNK - 1) / CHUNK;
  const int t0 = rank * live / S * CHUNK;
  const int t1 = min((rank + 1) * live / S * CHUNK, len);
  const int nst = t1 > t0 ? (t1 - t0 + ST - 1) / ST : 0;

  const TKV* kpool = static_cast<const TKV*>(a.k_pages);
  const TKV* vpool = static_cast<const TKV*>(a.v_pages);
  const int* table = a.tables + static_cast<long long>(b) * a.nb;
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // stage s of this CTA into ring buffer s % STAGES: each thread copies
  // 16 bytes of K and of V from ST * VPR / THREADS rows; rows at or past
  // t1 are zero-filled and never read from the pool
  auto load_stage = [&](int s) {
    if (s < nst) {
      const int base = t0 + s * ST;
      const uint32_t kd = ring_s + (s % STAGES) * 2 * ST * HD * ES;
      const uint32_t vd = kd + ST * HD * ES;
#pragma unroll
      for (int i = 0; i < ST * VPR / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / VPR, col = idx % VPR;
        const int tok = base + r;
        const bool ok = tok < t1;
        long long off = 0;
        if (ok) {
          const long long phys = __ldg(table + tok / a.page);
          off = ((phys * a.page + tok % a.page) * a.K + kh) * HD + col * VEC;
        }
        const uint32_t at = (r * HD + swz<HD, ES>(r, col) * VEC) * ES;
        cp_async16(kd + at, kpool + off, ok);
        cp_async16(vd + at, vpool + off, ok);
      }
    }
    cp_async_commit();  // an empty group past the last stage
  };
#pragma unroll
  for (int st = 0; st < STAGES; ++st) load_stage(st);

  // q rows: as float32 in the row layout (CUDA cores), or as bf16 A
  // fragments, row lane / 4 of the warp's (tensor cores); rows past gn
  // are 0 and unused.  On the CUDA cores each lane group keeps its own m
  // and each lane its share of l (lk, for the rows of its sums); on the
  // tensor cores the lanes of the C fragments keep the warp's (mh, lh)
  const long long qoff = (static_cast<long long>(b) * a.H + kh * G) * HD;
  const TQ* qp = static_cast<const TQ*>(a.q) + qoff;
  float q[GB][EPL], acc[GB][EPL], m[GB], l[GB], lk[RPL];
  uint32_t qa[HD / 16][2];
  float mh = NEG_INF, lh = 0.f;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      if constexpr (!Gm::MMA)
        q[g][e] = g < gn ? to_f(qp[(g0 + g) * HD + c * EPL + e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }
  if constexpr (Gm::MMA) {
    const uint32_t* qrow =
        reinterpret_cast<const uint32_t*>(qp + (g0 + lane / 4) * HD);
    const bool have = lane / 4 < gn;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      qa[kc][0] = have ? qrow[kc * 8 + lane % 4] : 0u;
      qa[kc][1] = have ? qrow[kc * 8 + 4 + lane % 4] : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) lk[k] = 0.f;
  const float scale2 = a.scale * LOG2E;
  const int src0 = j * LPT;  // this lane group's first lane

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 1>();  // stage s has landed
    __syncthreads();
    const TKV* kb = ring + (s % STAGES) * 2 * ST * HD;
    const TKV* vb = kb + ST * HD;
    const int base = t0 + s * ST;
    for (int i = wt * per; i < (wt + 1) * per; i += UB * TPS) {
      if (base + i >= t1) break;  // the rest of this warp's rows is past t1
      if constexpr (Gm::MMA) {
        // scores of stage rows i + n, n < UB * TPS: lane l holds rows
        // lane / 4 and tokens n = 8 tt + 2 (lane % 4) + x in sc[tt][x]
        float sc[NT][4];
        const uint32_t kbs = ring_s + (s % STAGES) * 2 * ST * HD * ES;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
          sc[tt][0] = sc[tt][1] = sc[tt][2] = sc[tt][3] = 0.f;
          const int t = i + tt * 8 + lane % 8;
#pragma unroll
          for (int kp = 0; kp < HD / 32; ++kp) {
            uint32_t bk[4];
            ldsm_x4(bk, kbs + (t * HD + swz<HD, ES>(t, 4 * kp + lane / 8) *
                                            VEC) * ES);
            mma(sc[tt], qa[2 * kp][0], qa[2 * kp][1], bk[0], bk[1]);
            mma(sc[tt], qa[2 * kp + 1][0], qa[2 * kp + 1][1], bk[2], bk[3]);
          }
        }
        bool ok[NT][2];
        float mx = NEG_INF;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            ok[tt][x] = base + i + tt * 8 + 2 * (lane % 4) + x < t1;
            sc[tt][x] = ok[tt][x] ? sc[tt][x] * scale2 : NEG_INF;
            mx = fmaxf(mx, sc[tt][x]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(mh, mx);
        const float corr = exp2f(mh - mn);
        mh = mn;
        float psum = 0.f;
        const int hr = lane / 4;  // the row this lane keeps (< GB: a row)
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float p = ok[tt][x] ? exp2f(sc[tt][x] - mn) : 0.f;
            psum += p;
            const int n = tt * 8 + 2 * (lane % 4) + x;
            if (hr < GB) w_p[(hr * TPS + n % TPS) * UB + n / TPS] = p;
          }
        }
        lh = lh * corr + psum;
        if (hr < GB && lane % 4 == 0) w_corr[hr] = corr;
        __syncwarp();
        const float4 cv = *reinterpret_cast<const float4*>(w_corr);
        const float corrs[GB] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < gn && corrs[g] != 1.f) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] *= corrs[g];
          }
        }
        // p.v: lane group j takes tokens u * TPS + j, their weights from
        // the warp's row of them
        float pw[GB][UB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(w_p + (g * TPS + j) * UB);
          pw[g][0] = w4.x;
          pw[g][1] = w4.y;
          pw[g][2] = w4.z;
          pw[g][3] = w4.w;
        }
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          float vf[EPL];
          load_row<HD>(vb, i + u * TPS + j, c, vf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < gn) {
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                acc[g][e] = fmaf(pw[g][u], vf[e], acc[g][e]);
            }
          }
        }
        __syncwarp();  // the weights are read before the next step's
      } else {
        // partial dot products of tokens i + u * TPS + j, rows g
        float v[N];
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          float kf[EPL];
          load_row<HD>(kb, i + u * TPS + j, c, kf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            float d = 0.f;
            if (g < gn) {
#pragma unroll
              for (int e = 0; e < EPL; ++e) d = fmaf(q[g][e], kf[e], d);
            }
            v[g * UB + u] = d;
          }
        }
        reduce_scatter<LPT / 2, N>(v, c);
        // the kept sums as base-2 scores, masked past t1; their rows' max
        bool ok[NF];
        float sc[NF], mx[RPL];
#pragma unroll
        for (int t = 0; t < NF; ++t) {
          ok[t] = base + i + (i0 + t) % UB * TPS + j < t1;
          sc[t] = ok[t] ? v[t] * scale2 : NEG_INF;
        }
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          mx[k] = sc[k * VPRL];
#pragma unroll
          for (int t = 1; t < VPRL; ++t)
            mx[k] = fmaxf(mx[k], sc[k * VPRL + t]);
#pragma unroll
          for (int o = DUP; o < LR; o *= 2)
            mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
        }
        // every lane: each row's new max and the correction of the old
        float corr[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float rm = __shfl_sync(0xffffffffu, mx[g * UB % NF / VPRL],
                                       src0 + g * UB / NF * DUP);
          const float mn = fmaxf(m[g], rm);
          corr[g] = exp2f(m[g] - mn);
          m[g] = mn;
        }
        // the kept sums' weights, and this lane's share of l
        float p[NF];
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          float mk = 0.f, ck = 0.f;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            mk = rowk[k] == g ? m[g] : mk;
            ck = rowk[k] == g ? corr[g] : ck;
          }
          float sum = 0.f;
#pragma unroll
          for (int t = k * VPRL; t < (k + 1) * VPRL; ++t) {
            p[t] = ok[t] ? exp2f(sc[t] - mk) : 0.f;
            sum += p[t];
          }
          lk[k] = lk[k] * ck + sum;
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < gn && __any_sync(0xffffffffu, corr[g] != 1.f)) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] *= corr[g];
          }
        }
        // every lane: each weight from the lane that keeps it, times V
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          float vf[EPL];
          load_row<HD>(vb, i + u * TPS + j, c, vf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < gn) {
              const int x = g * UB + u;
              const float w = __shfl_sync(0xffffffffu, p[x % NF],
                                          src0 + x / NF * DUP);
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                acc[g][e] = fmaf(w, vf[e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // buffer s % STAGES is consumed
    load_stage(s + STAGES);
  }

  if constexpr (Gm::MMA) {
    // the lane groups shared the warp's max: their acc add up; l over the
    // 4 lanes of a row, then (m, l) of row g from lane 4 g
#pragma unroll
    for (int off = LPT; off < 32; off *= 2) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    }
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = __shfl_sync(0xffffffffu, mh, 4 * g);
      l[g] = __shfl_sync(0xffffffffu, lh, 4 * g);
    }
  } else {
    // each row's l over the lane group (DUP lanes kept each share)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float lg = 0.f;
#pragma unroll
      for (int k = 0; k < RPL; ++k) lg += rowk[k] == g ? lk[k] : 0.f;
#pragma unroll
      for (int o = 1; o < LPT; o *= 2)
        lg += __shfl_xor_sync(0xffffffffu, lg, o);
      l[g] = lg * (1.f / DUP);
    }
    // merge the warp's lane groups (lanes j * LPT + c for each j)
#pragma unroll
    for (int off = LPT; off < 32; off *= 2) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float c1 = exp2f(m[g] - mn), c2 = exp2f(mo - mn);
        m[g] = mn;
        l[g] = l[g] * c1 + lo * c2;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = acc[g][e] * c1 +
                      __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c2;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: partials go there
  // the warp's partial into slot wt * G + g (WT * G <= GMAX slots)
  if (j == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gn) {
        const int slot = wt * G + g0 + g;
#pragma unroll
        for (int e = 0; e < EPL; e += 4)
          *reinterpret_cast<float4*>(part + slot * HD + c * EPL + e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                          acc[g][e + 3]);
        if (c == 0) {
          m_w[slot] = m[g];
          l_w[slot] = l[g];
        }
      }
    }
  }
  __syncthreads();
  // the CTA's partial: the WT warps' merged into slot 0 (element (g, d)
  // of slot 0 is read and written by its own thread only)
  float* dst = TWO_PASS ? scratch + (static_cast<long long>(b * a.K + kh) *
                                         S + rank) * (G * HD + 2 * G)
                        : nullptr;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD;
    float M = NEG_INF;
    for (int w = 0; w < WT; ++w) M = fmaxf(M, m_w[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WT; ++w) {
      const float f = exp2f(m_w[w * G + g] - M);
      L += l_w[w * G + g] * f;
      A += part[w * G * HD + e] * f;
    }
    part[e] = A;
    if (e % HD == 0) {
      m_c[g] = M;
      l_c[g] = L;
    }
    if (TWO_PASS) {
      dst[e] = A;
      if (e % HD == 0) {
        dst[G * HD + g] = M;
        dst[G * HD + G + g] = L;
      }
    }
  }
  if (TWO_PASS) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's partial is complete and visible

  // this CTA's slice of the G * HD outputs, merged over the S partials
  const int E = G * HD;
  TQ* op = static_cast<TQ*>(a.o) + qoff;
  for (int e = rank * E / S + tid; e < (rank + 1) * E / S; e += THREADS) {
    op[e] = from_f<TQ>(merge_partials(
        S, [&](int r) { return *cluster.map_shared_rank(m_c + e / HD, r); },
        [&](int r) { return *cluster.map_shared_rank(l_c + e / HD, r); },
        [&](int r) { return *cluster.map_shared_rank(part + e, r); }));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// the two-pass form's second pass: one thread per output element of a
// (request, kv head), grid (ceil(G * hd / THREADS), K, B), merges the S
// partials paged_kernel<..., true> wrote, as the cluster's merge does
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
    merge_kernel(PagedArgs a, const float* scratch, int S, int hd) {
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K, E = G * hd;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const float* src =
      scratch + static_cast<long long>(b * a.K + kh) * S * (E + 2 * G);
  TQ* op = static_cast<TQ*>(a.o) +
           (static_cast<long long>(b) * a.H + kh * G) * hd;
  const int g = e / hd;
  op[e] = from_f<TQ>(merge_partials(
      S, [&](int r) { return src[r * (E + 2 * G) + E + g]; },
      [&](int r) { return src[r * (E + 2 * G) + E + G + g]; },
      [&](int r) { return src[r * (E + 2 * G) + e]; }));
}

// CTAs per (request, kv head): the smallest power of 2 that gives two
// CTAs an SM over B * K pairs, at most MAX_SPLITS and at most the
// table's CHUNK-token chunks (its capacity nb * page, never lens: the
// plan needs nothing from the card); with `clustered`, also no larger
// than keeps all B * K clusters of the launch on the card at once
int split_count(int B, int K, int nb, int page, bool clustered) {
  const long long cap = static_cast<long long>(nb) * page;
  const long long chunks = cap > CHUNK ? (cap + CHUNK - 1) / CHUNK : 1;
  const long long pairs = static_cast<long long>(B) * K > 1
                              ? static_cast<long long>(B) * K
                              : 1;
  const long long want = (2LL * SMS + pairs - 1) / pairs;
  int s = 1;
  while (s < want && 2 * s <= MAX_SPLITS && 2 * s <= chunks &&
         (!clustered || pairs <= cluster_slots(2 * s)))
    s *= 2;
  return s;
}

// The form and split count for these shapes: the cluster form at the
// capped split count where its CTAs fill the card (one an SM or more)
// and each takes at most TWO_PASS_TOKENS of the capacity, or where that
// count is 1; else the two-pass form at the uncapped count
void plan_form(int B, int K, int nb, int page, int* splits,
               bool* clustered) {
  const int free = split_count(B, K, nb, page, false);
  const int capped = split_count(B, K, nb, page, true);
  const long long ctas = static_cast<long long>(B) * K * capped;
  *clustered = capped == 1 ||
               (ctas >= SMS && static_cast<long long>(nb) * page <=
                                   static_cast<long long>(TWO_PASS_TOKENS) *
                                       capped);
  *splits = *clustered ? capped : free;
}

constexpr int kMaxDevices = 64;

template <typename TQ, typename TKV, int HD>
cudaError_t launch_cluster(const PagedArgs& a, int splits,
                           cudaStream_t stream) {
  using Gm = Geom<TQ, TKV, HD>;
  auto kern = paged_kernel<TQ, TKV, HD, false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.K, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Gm::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per device and cluster size: the attributes, and whether one
  // cluster of the plan fits on the device at all (refused if not)
  static std::atomic<int> placed[kMaxDevices];  // bit log2(splits)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int bit = splits;  // a power of 2
  if (!(placed[dev].load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Gm::SMEM);
    if (err != cudaSuccess) return err;
    if (splits > 8) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return static_cast<cudaError_t>(ERR_UNPLACEABLE);
    placed[dev].fetch_or(bit, std::memory_order_acq_rel);
  }
  err = cudaLaunchKernelEx(&cfg, kern, a, static_cast<float*>(nullptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch_two_pass(const PagedArgs& a, int splits, float* scratch,
                            cudaStream_t stream) {
  using Gm = Geom<TQ, TKV, HD>;
  auto kern = paged_kernel<TQ, TKV, HD, true>;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (err != cudaSuccess) return err;
    allowed[dev].store(true, std::memory_order_release);
  }
  kern<<<dim3(splits, a.K, a.B), THREADS, Gm::SMEM, stream>>>(a, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (a.H / a.K * HD + THREADS - 1) / THREADS;
  merge_kernel<TQ><<<dim3(tiles, a.K, a.B), THREADS, 0, stream>>>(
      a, scratch, splits, HD);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch_hd(const PagedArgs& a, int splits, float* scratch,
                      cudaStream_t s) {
  return scratch ? launch_two_pass<TQ, TKV, HD>(a, splits, scratch, s)
                 : launch_cluster<TQ, TKV, HD>(a, splits, s);
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const PagedArgs& a, int hd, int splits,
                         float* scratch, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<TQ, TKV, 16>(a, splits, scratch, s);
    case 32: return launch_hd<TQ, TKV, 32>(a, splits, scratch, s);
    case 64: return launch_hd<TQ, TKV, 64>(a, splits, scratch, s);
    case 128: return launch_hd<TQ, TKV, 128>(a, splits, scratch, s);
    case 256: return launch_hd<TQ, TKV, 256>(a, splits, scratch, s);
    default: return cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters for clusters of `splits` CTAs of the
// bf16 kernel at width HD, or a negative CUDA error
template <int HD>
int clusters_on_card(int splits) {
  using Gm = Geom<__nv_bfloat16, __nv_bfloat16, HD>;
  auto kern = paged_kernel<__nv_bfloat16, __nv_bfloat16, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Gm::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// the tail is the same for every instantiation: the ring decides
template <typename TKV>
int smem_bytes(int hd) {
  switch (hd) {
    case 16: return Geom<float, TKV, 16>::SMEM;
    case 32: return Geom<float, TKV, 32>::SMEM;
    case 64: return Geom<float, TKV, 64>::SMEM;
    case 128: return Geom<float, TKV, 128>::SMEM;
    case 256: return Geom<float, TKV, 256>::SMEM;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int paged_attention_args_size(void) {
  return static_cast<int>(sizeof(PagedArgs));
}

int paged_attention_max_group(void) { return GMAX; }

// The planner's clusters of `splits` CTAs held at once (cluster_slots),
// and what the current device reports for the bf16 kernel at width hd
// (64 or 128; a negative CUDA error, or -1 for another width).
int paged_attention_cluster_slots(int splits) {
  return cluster_slots(splits);
}

int paged_attention_clusters_on_card(int hd, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  if (hd == 64) return clusters_on_card<64>(splits);
  if (hd == 128) return clusters_on_card<128>(splits);
  return -1;
}

// The launch plan for these shapes: CTAs per (request, kv head), bytes
// of dynamic shared memory a CTA, and the form (1 cluster, 0 two-pass).
// kv_dtype: 0 float32, 1 bfloat16.  `free_splits` is the split count
// without the cluster cap.  Returns 0, or cudaErrorInvalidValue for a
// head width or group the kernel does not take.
int paged_attention_plan(int B, int K, int nb, int page, int hd, int G,
                         int kv_dtype, int* splits, int* smem,
                         int* clustered, int* free_splits) {
  const int bytes = kv_dtype == 0   ? smem_bytes<float>(hd)
                    : kv_dtype == 1 ? smem_bytes<__nv_bfloat16>(hd)
                                    : -1;
  if (bytes < 0 || G < 1 || G > GMAX) return cudaErrorInvalidValue;
  bool cl = false;
  plan_form(B, K, nb, page, splits, &cl);
  *smem = bytes;
  *clustered = cl;
  *free_splits = split_count(B, K, nb, page, false);
  return 0;
}

// q_dtype, kv_dtype: 0 float32, 1 bfloat16; hd in {16, 32, 64, 128,
// 256}; H / K at most paged_attention_max_group(); splits as
// paged_attention_plan gives it.  With `scratch` null the cluster form;
// else the two-pass form, scratch holding B * K * splits * (G * hd + 2 *
// G) floats.  Launches on `stream` on the current device; returns 0 when
// launched, else a CUDA error or ERR_UNPLACEABLE.
int paged_attention_launch(PagedArgs a, int q_dtype, int kv_dtype, int hd,
                           int splits, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
      a.K < 1 || a.H % a.K || a.H / a.K > GMAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_typed<float, float>(a, hd, splits, sc, s);
  if (q_dtype == 0 && kv_dtype == 1)
    err = launch_typed<float, __nv_bfloat16>(a, hd, splits, sc, s);
  if (q_dtype == 1 && kv_dtype == 0)
    err = launch_typed<__nv_bfloat16, float>(a, hd, splits, sc, s);
  if (q_dtype == 1 && kv_dtype == 1)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(a, hd, splits, sc, s);
  return static_cast<int>(err);
}

const char* paged_attention_error_string(int err) {
  if (err == ERR_UNPLACEABLE)
    return "no cluster of the plan's size fits on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
