// Forward flash attention with GQA, causal and sliding-window masks: the
// CUDA kernels behind repro_torch.kernels.flash_attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:85
// `flash_attention` (body `_kernel` at :26, pl.pallas_call at :104).
// That kernel walks a grid (B, H, q-tile, k-tile) whose last dimension
// runs in order, carrying the running max, denominator and output tile
// in VMEM scratch from one k-tile to the next.  Blocks of a CUDA grid
// run in no order, so here one block owns one (b, h, 64-row q tile) and
// loops over the k-tiles itself; K and V tiles of kv head h / G stream
// through shared memory, and the running state stays in registers.
// Both kernels compute what the Pallas body computes: the scale
// 1/sqrt(hd) applied to q.k in float32, NEG_INF = -1e30 on masked scores
// (never -INFINITY: a row masked in its first tile gets exp(0), wiped
// later by corr = 0, as in Pallas), the result divided by max(l, 1e-30),
// ragged S and Sk masked.  A row that sees no key at all (a window that
// ends before the keys do, S > Sk - 1 + window) is written as 0, what
// Pallas gives when it skips every k-block of the row; its running max
// is still NEG_INF at the end.  Tiles wholly above the causal diagonal
// or wholly outside the window are never loaded.  hd contiguous, other
// strides in whole 16-byte units.  The wrapper's `kernel_for` picks the
// kernel by dtype.
//
// bf16: `flash_mma`, on the tensor cores (hd 16, 32, 64, 128, 256).
//  - Four warps a block, each owning an m16 tile of query rows.  Q is
//    copied once with cp.async; up to hd 128 it is held as mma A
//    fragments (ldmatrix) for the whole block, at hd 256 it stays in
//    shared memory and each k-step of Q.K^T reads its fragment there
//    (see "hd 256" below).
//  - K and V tiles of 64 keys (32 at hd 256) stream through a 2-stage
//    ring in dynamic shared memory, cp.async.cg 16 bytes a thread, each
//    thread's addresses worked out once; rows past Sk are zero-filled
//    (src-size 0).  Tile t + 1 is in flight while tile t is computed.
//  - Rows are XOR-swizzled in 16-byte chunks, so that the eight rows an
//    ldmatrix reads sit in distinct banks (at hd 64 a row is 128 bytes,
//    and unswizzled every ldmatrix would be an 8-way conflict).
//  - S = Q.K^T is mma.sync.m16n8k16 bf16 -> float32, hd/16 k-steps x 8
//    n-tiles a tile.  The online softmax works in the m16n8 C layout,
//    where a row's scores sit in the 4 lanes of a quad (shfl_xor 1, 2),
//    in base 2: scores are scaled by scale*log2(e) in float32 (inside
//    the tiles, in the exponent's FFMA) and 2^x is the SFU's
//    ex2.approx.ftz, which moves p by a few float32 ulps and flushes p
//    below 2^-126 to 0.
//  - l sums the unrounded p.  p is rounded to bf16 (nearest even, as
//    torch casts and as the model's attention does with
//    `w.astype(v.dtype)`, src/repro/models/layers.py:144) and repacked
//    from the C fragments of two n8 tiles straight into an A fragment.
//    V enters as the B operand through ldmatrix.trans; O stays in
//    float32 registers.
//  - A tile step is compiled twice: interior tiles run without a branch;
//    tiles that meet the diagonal, the window or the end of Sk mask each
//    score and skip the n-tile pairs no row of the warp sees.
//  - Blocks are numbered so that the q tiles with the most k-tiles start
//    first, which shortens the causal tail of the last wave.
//  - The epilogue stages the bf16 tile through shared memory, so that
//    each thread stores 16 bytes to the strided [B,S,H,hd] output.
//  - It needs 16-byte aligned pointers and b/h/s strides that are
//    multiples of 8 elements; the wrapper raises on anything else.
//
// Why mma.sync and not wgmma: at granite-3-2b's prefill (B=8, S=512,
// H=32, K=8, hd=64, causal) the two products are 9.7 GFLOP with the
// diagonal tiles' waste, about 15 us at two thirds of the 989 TFLOP/s
// bf16 rate, against the 12.5 us the 42 MB of q, k, v and o take at
// 3.35 TB/s.  What stands between the kernel and that bound is latency
// between the softmax and the two products, and the causal tail, not
// the instruction; a 64-row warpgroup product would also leave fewer
// blocks in flight.  Tuning on an H100 (tools/flash_variants.py, numbers
// in PERF.md) kept 64-key tiles, 16 rows a warp and 4 blocks an SM: two
// m16 tiles a warp, 8 warps a block, 128-key tiles, a 3-stage ring and
// 3 blocks an SM were each slower at that shape.
//
// hd 256 (recurrentgemma-2b's local attention, 10 query heads on one kv
// head) is laid out for its width, not as hd 128 with one more case:
//  - Registers.  The float32 output alone is hd/8 x 4 = 128 registers a
//    thread; Q held as A fragments would add hd/16 x 4 = 64 and a 64-key
//    S tile 32, past the 255 a thread may have.  So Q's fragments are
//    read from shared memory at each of the 16 k-steps (one ldmatrix.x4
//    beside the K fragments it meets), and the key tile is 32 wide, so
//    that S is 16 registers.
//  - Shared memory.  Q is 32 KiB and a 32-key K or V tile 16 KiB, so the
//    2-stage ring and Q take 96 KiB: two blocks an SM (a 64-key ring
//    would take 160 KiB and leave one).  With 128 threads and two blocks
//    an SM, __launch_bounds__ leaves each thread 255 registers.
//  - A 32-key row of 512 bytes is 32 chunks; the loader's 128 threads
//    cover 4 rows a pass, not a multiple of the 8-row swizzle period, so
//    its addresses are worked out per row (at compile time, the loop is
//    unrolled).
//
// float32: `flash_tf32x3`, on the tensor cores in 3xTF32 (hd 16, 32, 64,
// 128, 256), flash_mma's skeleton in float32:
//  - Products.  S = Q.K^T and O += P.V are mma.sync m16n8k8 TF32 ->
//    float32, three a product: each operand x is split into TF32 halves,
//    hi = rna(x) and lo = rna(x - hi), rna the rounding of
//    cvt.rna.tf32.f32 (x = hi + lo to about 2^-22 |x|), and hi.lo +
//    lo.hi + hi.hi is accumulated in float32 (only lo.lo, about 2^-22 of
//    the product, is dropped).  One TF32 pass keeps about 2^-11 and
//    misses the float32 tolerance of the JAX kernel tests (1e-5) by
//    40-70x; three keep float32's order of error (a CPU emulation of this
//    arithmetic in tests/test_torch_attention.py holds it within 1e-5 of
//    float64 at hd 64-256, and shows one pass outside).
//  - The splits.  Q's A fragment of a k-step and K's and V's B fragments
//    are split in registers as they are read, P as it leaves the
//    softmax; rna is two integer operations (see tf32 below).  Measured
//    on an H100 (tools/flash_f32_timing.py, PERF.md), other choices were
//    slower: the cvt.rna.tf32.f32 instruction (a conversion, on a slower
//    pipe) by 1.3-1.45x; splitting each K and V tile once as it lands, a
//    hi and a lo plane a slot (a quarter of the splits, twice the ring),
//    at hd 64 and 256 by 6% and 22% (one block an SM fewer; 4% faster at
//    hd 128); Q split once into shared memory, lo rounded by float
//    operations (Veltkamp's split).  The two small products and the lo
//    splits take 38-45% of the time, one TF32 pass the rest.
//  - Four warps a block, each owning an m16 tile of query rows.  Q is
//    copied once with cp.async into shared memory and each k-step of
//    Q.K^T reads its fragment there (ldmatrix works on 32-bit data: an
//    8x8 b16 matrix is 8 rows of 4 floats), as flash_mma<256> does:
//    Q's hi and lo fragments held in registers would take HD
//    registers a thread beside the output's HD / 2.
//  - K and V tiles (TK keys: 64 up to hd 64, 32 at hd 128, 16 at hd 256)
//    stream through a ring of NS = 2 slots in dynamic shared memory, each
//    slot one K or one V tile: V of tile t lands while Q.K^T of t runs,
//    K of t + 1 while P.V of t runs, so a 64-row Q tile and the ring fit
//    2 blocks an SM at hd 256 (Q 65 KiB, a 16-key tile 16 KiB; 245
//    registers, no spills; 3 blocks an SM at hd 64 and 128, the
//    occupancy calculator's counts printed by chip_smoke.py).  Rows are
//    padded by 16 bytes instead of swizzled: a row is an odd number of
//    16-byte chunks, so the 8 rows an ldmatrix reads and the 4 rows 2t of
//    a V fragment fall on distinct banks.  Rows past Sk are zero-filled.
//  - The online softmax works in the m16n8 C layout (a row's scores in a
//    quad), in base 2 with ex2.approx.ftz, as flash_mma's; Q.K^T goes
//    into 8 independent accumulator chains a warp (n-tiles, and at
//    TK = 16 hi.hi apart from the small products and even k-steps apart
//    from odd ones).
//  - P.V without a shuffle: the k index of P.V is permuted (logical k = t
//    is key 2t, k = t + 4 key 2t + 1, in P and in V alike), so P's C
//    fragment is its A fragment.  ldmatrix.trans does not transpose
//    32-bit elements, so V's B fragments are plain shared loads; the
//    output columns are permuted too (column c of n-tile n is dim
//    (n / 4) * 32 + 4c + n % 4, by 2 at hd 16), so that one 16-byte load
//    reads the fragments of 4 n-tiles and the epilogue stores 16 bytes.
//  - Interior and edge tiles are compiled apart; the longest q tiles are
//    launched first; it needs 16-byte aligned pointers and b/h/s strides
//    that are multiples of 4 elements (the wrapper raises on anything
//    else).
//  - Why mma.sync and not wgmma: wgmma takes TF32 operands K-major only,
//    so P.V would need V transposed in shared memory; left for later.
//  - Bound (qwen3-32b's prefill, B 2, S 256, H 64, K 8, hd 128, causal):
//    3 x 2.16 GFLOP at 495 TFLOP/s, 13.1 us, against 11.3 us of bytes;
//    the time measured is in PERF.md and printed by chip_smoke.py.
//
// Bound and build.  At granite-3-2b's prefill the least time is set by
// the bytes (12.5 us; the 8.6 GFLOP the causal mask keeps take 8.7 us
// at 989 TFLOP/s).  ptxas (-Xptxas -v, sm_90a): flash_mma<64> 128
// registers with a few bytes of spills, 40 KB of dynamic shared memory
// a block; its measured time is in PERF.md and printed by chip_smoke.py
// (phase 8), with the registers and shared memory of this build.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Outside the unnamed namespace: the exported launch function takes it by
// value, and a parameter type with internal linkage would keep that
// function out of the library's symbols.
struct FlashArgs {
  const void* q;   // [B, H, S, hd], hd contiguous, other strides free
  const void* k;   // [B, K, Sk, hd]
  const void* v;   // [B, K, Sk, hd]
  void* o;         // [B, H, S, hd]
  long long q_sb, q_sh, q_ss;  // strides in elements
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, K, S, Sk;
  int causal;
  int window;      // <= 0: no window
  float scale;     // 1/sqrt(hd)
};

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TQ = 16 * WARPS;  // query rows per block: an m16 tile a warp
constexpr int STAGES = 2;       // K/V tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

// Shapes of the kernel for one head width.  An [R][HD] bf16 tile in
// shared memory has NCH 16-byte chunks a row; chunk c of row r is stored
// at chunk c ^ ((r >> RSH) & (SW - 1)), so that any 8 consecutive rows of
// one logical chunk fall on 8 distinct 16-byte bank groups (SW chunks
// span 128 bytes; 8 / SW rows share a 128-byte line).  TK keys a K/V
// tile (NT n-tiles of 8); QREG: Q's A fragments live in registers (else
// they are read from shared memory at each k-step).
template <int HD>
struct Tile {
  static constexpr int TK = HD <= 128 ? 64 : 32;
  static constexpr int NT = TK / 8;
  static constexpr bool QREG = HD <= 128;
  static constexpr int KS = HD / 16;  // k-steps of Q.K^T
  static constexpr int NCH = HD / 8;
  static constexpr int SW = NCH < 8 ? NCH : 8;
  static constexpr int RSH = SW == 8 ? 0 : (SW == 4 ? 1 : 2);
  static constexpr int Q_BYTES = TQ * HD * 2;
  static constexpr int KV_BYTES = TK * HD * 2;
  // Q (then the output tile), then K and V of each stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES;
};

template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using L = Tile<HD>;
  return static_cast<uint32_t>(r * HD * 2 +
                               ((c ^ ((r >> L::RSH) & (L::SW - 1))) << 4));
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// c += a . b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126
// flush to 0).  exp2f without fast math wraps the same instruction in
// three more for subnormal results, which no p that matters has.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// copy rows [0, min(rows, R)) of an [R][HD] tile whose row 0 is at src
// (row stride ss elements) into the swizzled tile at dst; rows past
// `rows` are zero-filled
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ss, int rows, int tid) {
  constexpr int NCH = Tile<HD>::NCH;
  static_assert(R * NCH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * NCH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / NCH, c = i % NCH;
    const bool ok = r < rows;
    cp_async16(dst + swz<HD>(r, c), src + (ok ? r * ss : 0) + c * 8, ok);
  }
}

// What a warp carries from one K/V tile to the next: its 16 rows of Q
// as A fragments (where QREG holds them there), the float32 output, and
// for its two rows (C elements 0, 1: row g; 2, 3: row g + 8) the running
// max in base 2 and this lane's part of the row sum.
template <int HD>
struct Warp {
  uint32_t qa[Tile<HD>::QREG ? Tile<HD>::KS : 1][4];
  float o[HD / 8][4];
  float m[2], l[2];
};

// One K/V tile for one warp.  EDGE: the tile meets the causal diagonal,
// the window or the end of Sk for some row of this warp, so the scores
// are masked one by one, and the pairs of n-tiles that none of its rows
// sees are skipped (they stay masked: their p, 0, or 1 in a row that has
// seen no key yet, is wiped by corr = 0 at the row's first key, as in
// Pallas).  Interior tiles take the branch-free path.  sq: the Q tile
// in shared memory, whose rows qr .. qr + 15 are this warp's, read for
// its fragments where QREG does not hold them.
template <int HD, bool EDGE>
__device__ __forceinline__ void tile_step(Warp<HD>& w, uint32_t sq,
                                          uint32_t sk, uint32_t sv, int k0,
                                          int qw, int qr, int lane,
                                          const FlashArgs& a, float sl) {
  using L = Tile<HD>;
  constexpr int TK = L::TK, NT = L::NT;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row

  // the n-tiles [lo, hi) that hold a key some row qw .. qw + 15 sees
  int lo = 0, hi = NT;
  if (EDGE) {
    int last = min(k0 + TK, a.Sk) - 1;
    if (a.causal) last = min(last, qw + 15);
    hi = last < k0 ? 0 : (last - k0) / 8 + 1;
    const int first = qw - a.window + 1;
    if (a.window > 0 && first > k0) lo = min(NT, (first - k0) / 8);
  }
  auto live = [&](int j) {  // n-tiles j, j + 1 hold a key that matters
    return !EDGE || (j + 1 >= lo && j < hi);
  };

  // S = Q K^T
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < L::KS; ++kk) {
    uint32_t qf[4];  // Q's A fragment of this k-step
    if constexpr (L::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[e] = w.qa[kk][e];
    } else {
      ldsm_x4(qf, sq + swz<HD>(qr + (lane & 15), 2 * kk + (lane >> 4)));
    }
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (!live(2 * jj)) continue;
      uint32_t bk[4];
      ldsm_x4(bk, sk + swz<HD>(16 * jj + (mi >> 1) * 8 + mr,
                               2 * kk + (mi & 1)));
      mma(s[2 * jj], qf, bk[0], bk[1]);
      mma(s[2 * jj + 1], qf, bk[2], bk[3]);
    }
  }

  // at an edge: scale (base 2), then the masks
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qw + g + (e >> 1) * 8;
        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && (qp - kp < a.window);
        s[j][e] = ok ? s[j][e] * sl : NEG_INF;
      }
    }
  }

  // online softmax: the row max over the quad, then p and the rescale.
  // Inside, the max is taken on the unscaled scores (scaling by sl > 0
  // rounds monotonically, so max(s) * sl == max(s * sl)) and the scale
  // goes into the exponent's FFMA.
  float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  if (!EDGE) {
    mx0 *= sl;
    mx1 *= sl;
  }
  mx0 = fmaxf(w.m[0], mx0);
  mx1 = fmaxf(w.m[1], mx1);
  const float c0 = ex2(w.m[0] - mx0), c1 = ex2(w.m[1] - mx1);
  w.m[0] = mx0;
  w.m[1] = mx1;
  auto p = [&](float x, float mx) {
    return EDGE ? ex2(x - mx) : ex2(fmaf(x, sl, -mx));
  };
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = p(s[j][0], mx0);
    s[j][1] = p(s[j][1], mx0);
    s[j][2] = p(s[j][2], mx1);
    s[j][3] = p(s[j][3], mx1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  w.l[0] = w.l[0] * c0 + ps0;
  w.l[1] = w.l[1] * c1 + ps1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    w.o[n][0] *= c0;
    w.o[n][1] *= c0;
    w.o[n][2] *= c1;
    w.o[n][3] *= c1;
  }

  // O += P V: P (bf16) from the C fragments of n-tiles 2kk, 2kk + 1
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (!live(2 * kk)) continue;
    const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                            pack(s[2 * kk][2], s[2 * kk][3]),
                            pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int p2 = 0; p2 < HD / 16; ++p2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, sv + swz<HD>(16 * kk + (mi & 1) * 8 + mr,
                                 2 * p2 + (mi >> 1)));
      mma(w.o[2 * p2], pa, bv[0], bv[1]);
      mma(w.o[2 * p2 + 1], pa, bv[2], bv[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : 2)
    flash_mma(FlashArgs a) {
  using L = Tile<HD>;
  constexpr int TK = L::TK;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // block -> (q tile, b, h), the q tiles with the most k-tiles first
  const int nq = (a.S + TQ - 1) / TQ;
  const int BH = a.B * a.H;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * TQ;
  const int h = static_cast<int>(blockIdx.x % BH) % a.H;
  const int b = static_cast<int>(blockIdx.x % BH) / a.H;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                   static_cast<long long>(q0) * a.q_ss;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // the k-tiles any row of this block can see
  const int nk = (a.Sk + TK - 1) / TK;
  const int qlast = min(q0 + TQ, a.S) - 1;
  int t_lo = 0, t_hi = nk;
  if (a.causal) t_hi = min(nk, qlast / TK + 1);
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;  // first key the first row sees
    if (lo > 0) t_lo = lo / TK;
  }

  auto k_stage = [&](int st) {
    return s_q + L::Q_BYTES + 2 * st * L::KV_BYTES;
  };
  auto v_stage = [&](int st) { return k_stage(st) + L::KV_BYTES; };
  // this thread's share of a K or V tile: chunk lc of rows lr + i * RS,
  // its addresses worked out once (a step of RS rows, where RS is a
  // multiple of 8, leaves the swizzle as it is; at hd 256, RS = 4, each
  // row's own), each K copy issued beside its V copy (one loader run for
  // all of K, then for all of V, was slower on an H100)
  constexpr int RS = THREADS / L::NCH, NLD = TK / RS;
  static_assert(THREADS % L::NCH == 0 && TK % RS == 0,
                "whole rows per pass");
  const int lr = tid / L::NCH, lc = tid % L::NCH;
  const uint32_t l_dst = swz<HD>(lr, lc);
  const bf16* k_src = kb + lr * a.k_ss + lc * 8;
  const bf16* v_src = vb + lr * a.v_ss + lc * 8;
  auto load_kv = [&](int t, int st) {
    const int rows = a.Sk - t * TK;  // rows of the tile that exist
    const bf16* kt = k_src + t * TK * a.k_ss;
    const bf16* vt = v_src + t * TK * a.v_ss;
    const uint32_t kd = k_stage(st) + l_dst, vd = v_stage(st) + l_dst;
#pragma unroll
    for (int i = 0; i < NLD; ++i) {
      const bool ok = lr + i * RS < rows;  // else zero-fill, read nothing
      const uint32_t off = RS % 8 == 0
                               ? i * RS * HD * 2
                               : swz<HD>(lr + i * RS, lc) - l_dst;
      cp_async16(kd + off, ok ? kt + i * RS * a.k_ss : kb, ok);
      cp_async16(vd + off, ok ? vt + i * RS * a.v_ss : vb, ok);
    }
  };

  // group i holds tile t_lo + i (group 0 also Q); one group is committed
  // per stage and per iteration, empty or not, so that tile t_lo + i is
  // complete once at most STAGES - 2 groups are in flight at iteration i
  load_tile<HD, TQ>(s_q, qb, a.q_ss, a.S - q0, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_lo + i < t_hi) load_kv(t_lo + i, i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  Warp<HD> w;
  const int qw = q0 + warp * 16;  // this warp's first row
  if constexpr (L::QREG) {
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk)
      ldsm_x4(w.qa[kk], s_q + swz<HD>(warp * 16 + (lane & 15),
                                      2 * kk + (lane >> 4)));
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.f;
  const float sl = a.scale * LOG2E;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % STAGES;
    if (t > t_lo) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile t has landed; the last tile's stage is free
    }
    const int tn = t + STAGES - 1;  // into the stage tile t - 1 held
    if (tn < t_hi) load_kv(tn, (tn - t_lo) % STAGES);
    cp_async_commit();

    const int k0 = t * TK;
    // a tile that no row of this warp sees is skipped whole
    if (a.causal && k0 > qw + 15) continue;
    if (a.window > 0 && qw - (k0 + TK - 1) >= a.window) continue;
    const bool edge = (a.causal && k0 + TK - 1 > qw) ||
                      (a.window > 0 && qw + 15 - k0 >= a.window) ||
                      k0 + TK > a.Sk;
    if (edge)
      tile_step<HD, true>(w, s_q, k_stage(st), v_stage(st), k0, qw,
                          warp * 16, lane, a, sl);
    else
      tile_step<HD, false>(w, s_q, k_stage(st), v_stage(st), k0, qw,
                           warp * 16, lane, a, sl);
  }

  // epilogue: this warp's rows through its own rows of the Q tile (only
  // this warp read them), 16 bytes a thread to the output
  const int g = lane >> 2, t4 = lane & 3;
  float l0 = w.l[0], l1 = w.l[1];
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  // a row that saw no key (its max still NEG_INF, its o the p = 1 of
  // masked keys) is divided by infinity, to 0
  const float d0 = w.m[0] == NEG_INF ? INFINITY : fmaxf(l0, 1e-30f);
  const float d1 = w.m[1] == NEG_INF ? INFINITY : fmaxf(l1, 1e-30f);
  const int rw = warp * 16 + g;
  __syncwarp();  // the warp's ldmatrix reads of Q come before these stores
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + swz<HD>(rw, n) + 4 * t4) =
        pack(w.o[n][0] / d0, w.o[n][1] / d0);
    *reinterpret_cast<uint32_t*>(smem + swz<HD>(rw + 8, n) + 4 * t4) =
        pack(w.o[n][2] / d1, w.o[n][3] / d1);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int it = 0; it < 16 * L::NCH / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / L::NCH, c = i % L::NCH;
    const int qp = qw + r;
    if (qp < a.S)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(qp) * a.o_ss +
                                c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<HD>(warp * 16 + r, c));
  }
}

// ------------------------------------------------------------ float32

// The kernel's choices, each a macro so that a build can set it with -D
// (tools/flash_f32_timing.py times the alternatives; PERF.md keeps the
// numbers): keys a K or V tile at hd <= 64, 128 and 256; slots in the
// ring; blocks an SM asked of __launch_bounds__ at each width.  The
// defaults are the fastest measured on an H100.
#ifndef F32_TK_64
#define F32_TK_64 64
#endif
#ifndef F32_TK_128
#define F32_TK_128 32
#endif
#ifndef F32_TK_256
#define F32_TK_256 16
#endif
#ifndef F32_SLOTS
#define F32_SLOTS 2
#endif
#ifndef F32_MINB_64
#define F32_MINB_64 3
#endif
#ifndef F32_MINB_128
#define F32_MINB_128 3
#endif
#ifndef F32_MINB_256
#define F32_MINB_256 2
#endif

// Shapes of flash_tf32x3 for one head width.  A row of HD floats takes RB
// bytes in shared memory, 4 floats of padding included (RB / 16 is odd,
// so the 8 rows an ldmatrix reads and the rows 2t of a V fragment fall on
// distinct banks).  TK keys a K or V tile (NT n-tiles of 8); NS slots in
// the ring, each holding one K or one V tile; NPT: output n-tiles whose
// columns a thread reads from one V row at once (see P.V below); NACC:
// accumulator sets of Q.K^T, enough for 8 independent mma chains a warp.
template <int HD>
struct F32Tile {
  static constexpr int TK = HD <= 64 ? F32_TK_64
                            : HD == 128 ? F32_TK_128 : F32_TK_256;
  static constexpr int NT = TK / 8;
  static constexpr int KS = HD / 8;  // k-steps of Q.K^T
  static constexpr int NCH = HD / 4;
  static constexpr int RB = (HD + 4) * 4;
  static constexpr int NPT = HD >= 32 ? 4 : 2;
  static constexpr int NS = F32_SLOTS;
  static constexpr int NACC = NT >= 8 ? 1 : 8 / NT;
  static constexpr int MINB = HD <= 32 ? 4
                              : HD == 64 ? F32_MINB_64
                              : HD == 128 ? F32_MINB_128 : F32_MINB_256;
  static constexpr int Q_BYTES = TQ * RB;
  static constexpr int KV_BYTES = TK * RB;
  static constexpr int SMEM = Q_BYTES + NS * KV_BYTES;
  static_assert(NT % 2 == 0 && NACC <= 4 && NS >= 2, "tile shapes");
  static_assert(THREADS % NCH == 0 && TK % (THREADS / NCH) == 0 &&
                    TQ % (THREADS / NCH) == 0,
                "whole rows a loader pass");
};

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// its low 13 bits 0: cvt.rna.tf32.f32's rounding, here in two integer
// operations (half a TF32 step added to the magnitude's bits, a carry
// moving the exponent, the low 13 bits cleared), which ran the kernel
// 1.3-1.45x faster on an H100 than the instruction (a conversion, on the
// SM's slower pipe); they differ only on NaNs whose payload lies in the
// low 13 bits
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): both halves TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a . b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the two small products first, then hi . hi, into
// cs and cb (the same registers or two accumulator sets)
__device__ __forceinline__ void mma3(float (&cs)[4], float (&cb)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(cs, ah, bl0, bl1);
  mma_tf32(cs, al, bh0, bh1);
  mma_tf32(cb, ah, bh0, bh1);
}

// copy rows [0, min(rows, R)) of an [R][HD] float tile whose row 0 is at
// src (row stride ss) into the padded tile at dst; rows past `rows` are
// zero-filled, reading `safe` (a valid address) instead
template <int HD, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          long long ss, int rows,
                                          const float* safe, int tid) {
  using L = F32Tile<HD>;
  constexpr int RS = THREADS / L::NCH;
  const int lr = tid / L::NCH, lc = tid % L::NCH;
#pragma unroll
  for (int i = 0; i < R / RS; ++i) {
    const int r = lr + i * RS;
    const bool ok = r < rows;
    cp_async16(dst + r * L::RB + lc * 16, ok ? src + r * ss + lc * 4 : safe,
               ok);
  }
}

// What a warp carries from one K/V tile to the next: the float32 output
// (n-tile n's columns are permuted, see P.V), and for its two rows (C
// elements 0, 1: row g; 2, 3: row g + 8) the running max in base 2 and
// this lane's part of the row sum.
template <int HD>
struct F32Warp {
  float o[HD / 8][4];
  float m[2], l[2];
};

// S = Q.K^T of one K tile for one warp, then the online softmax: s ends
// as p (the C layout of n-tile j: keys 8j + 2t, 8j + 2t + 1), w.o and
// w.l rescaled.  EDGE: the tile meets the causal diagonal, the window or
// the end of Sk for some row of this warp, so scores are masked one by
// one, and n-tile pairs outside [lo, hi) (no row of the warp sees them)
// are skipped; they stay masked.  Q's A fragment of each k-step is read
// from the Q tile (ldmatrix on 32-bit data: an 8x8 b16 matrix is 8 rows
// of 4 floats) and split; K's B fragments the same way.
template <int HD, bool EDGE>
__device__ __forceinline__ void f32_qk(F32Warp<HD>& w,
                                       float (&s)[F32Tile<HD>::NT][4],
                                       uint32_t sq, uint32_t sk, int k0,
                                       int qw, int qr, int lane, int lo,
                                       int hi, const FlashArgs& a, float sl) {
  using L = F32Tile<HD>;
  constexpr int NT = L::NT, NACC = L::NACC;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row

  float acc[NACC][NT][4];
#pragma unroll
  for (int c = 0; c < NACC; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
  const uint32_t q_row = sq + (qr + (lane & 15)) * L::RB + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < L::KS; ++kk) {
    // sets: hi.hi into cb, the small products into cs (with 4 sets, the
    // k-step's parity picks the pair)
    const int cb = NACC == 4 ? 2 * (kk & 1) : 0;
    const int cs = NACC == 1 ? cb : cb + 1;
    uint32_t qf[4], ah[4], al[4];
    ldsm_x4(qf, q_row + kk * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(qf[e]), ah[e], al[e]);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (EDGE && !(2 * jj + 1 >= lo && 2 * jj < hi)) continue;
      const uint32_t kaddr = sk + (16 * jj + (mi >> 1) * 8 + mr) * L::RB +
                             (2 * kk + (mi & 1)) * 16;
      uint32_t kf[4], bh[4], bl[4];
      ldsm_x4(kf, kaddr);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(kf[e]), bh[e], bl[e]);
      mma3(acc[cs][2 * jj], acc[cb][2 * jj], ah, al, bh[0], bh[1], bl[0],
           bl[1]);
      mma3(acc[cs][2 * jj + 1], acc[cb][2 * jj + 1], ah, al, bh[2], bh[3],
           bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = acc[NACC - 1][j][e];
#pragma unroll
      for (int c = NACC - 2; c >= 0; --c) x += acc[c][j][e];
      s[j][e] = x;
    }

  // at an edge: scale (base 2), then the masks
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qw + g + (e >> 1) * 8;
        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && (qp - kp < a.window);
        s[j][e] = ok ? s[j][e] * sl : NEG_INF;
      }
    }
  }

  // online softmax, as flash_mma's: the row max over the quad, then p and
  // the rescale; inside, the scale goes into the exponent's FFMA
  float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  if (!EDGE) {
    mx0 *= sl;
    mx1 *= sl;
  }
  mx0 = fmaxf(w.m[0], mx0);
  mx1 = fmaxf(w.m[1], mx1);
  const float c0 = ex2(w.m[0] - mx0), c1 = ex2(w.m[1] - mx1);
  w.m[0] = mx0;
  w.m[1] = mx1;
  auto p = [&](float x, float mx) {
    return EDGE ? ex2(x - mx) : ex2(fmaf(x, sl, -mx));
  };
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = p(s[j][0], mx0);
    s[j][1] = p(s[j][1], mx0);
    s[j][2] = p(s[j][2], mx1);
    s[j][3] = p(s[j][3], mx1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  w.l[0] = w.l[0] * c0 + ps0;
  w.l[1] = w.l[1] * c1 + ps1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    w.o[n][0] *= c0;
    w.o[n][1] *= c0;
    w.o[n][2] *= c1;
    w.o[n][3] *= c1;
  }
}

// O += P.V of one V tile for one warp, k-steps (n-tiles of S) in [lo, hi).
// P's C fragment is an A fragment once the k index is permuted: logical
// k = t reads key 2t and k = t + 4 key 2t + 1, in P and in V alike, so
// a0..a3 = s[j][0], s[j][2], s[j][1], s[j][3] and no shuffle is needed.
// The output columns are permuted too: column c of n-tile n is dim
// (n / NPT) * 8 * NPT + c * NPT + n % NPT, so that the B fragments of NPT
// n-tiles are NPT neighbouring floats of one V row (one 16-byte load,
// rows 2t on distinct banks under the padding) and a thread's C
// fragments of NPT n-tiles are 2 * NPT neighbouring dims of its rows.
template <int HD>
__device__ __forceinline__ void f32_pv(F32Warp<HD>& w,
                                       const float (&s)[F32Tile<HD>::NT][4],
                                       const unsigned char* sv, int lane,
                                       int lo, int hi) {
  using L = F32Tile<HD>;
  constexpr int NPT = L::NPT;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < L::NT; ++kk) {
    if (kk < lo || kk >= hi) continue;
    const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(pa[e], ph[e], pl[e]);
    const unsigned char* r0 = sv + (8 * kk + 2 * t4) * L::RB + g * NPT * 4;
#pragma unroll
    for (int G = 0; G < HD / (8 * NPT); ++G) {
      float x0[NPT], x1[NPT];
      const unsigned char* p0 = r0 + G * 8 * NPT * 4;
      if constexpr (NPT == 4) {
        *reinterpret_cast<float4*>(x0) = *reinterpret_cast<const float4*>(p0);
        *reinterpret_cast<float4*>(x1) =
            *reinterpret_cast<const float4*>(p0 + L::RB);
      } else {
        *reinterpret_cast<float2*>(x0) = *reinterpret_cast<const float2*>(p0);
        *reinterpret_cast<float2*>(x1) =
            *reinterpret_cast<const float2*>(p0 + L::RB);
      }
#pragma unroll
      for (int x = 0; x < NPT; ++x) {
        uint32_t bh0, bh1, bl0, bl1;
        split(x0[x], bh0, bl0);
        split(x1[x], bh1, bl1);
        float(&o)[4] = w.o[G * NPT + x];
        mma3(o, o, ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, F32Tile<HD>::MINB)
    flash_tf32x3(FlashArgs a) {
  using L = F32Tile<HD>;
  constexpr int TK = L::TK, NT = L::NT, NS = L::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // block -> (q tile, b, h), the q tiles with the most k-tiles first
  const int nq = (a.S + TQ - 1) / TQ;
  const int BH = a.B * a.H;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * TQ;
  const int h = static_cast<int>(blockIdx.x % BH) % a.H;
  const int b = static_cast<int>(blockIdx.x % BH) / a.H;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb +
                    h * a.q_sh + static_cast<long long>(q0) * a.q_ss;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // the k-tiles any row of this block can see
  const int nk = (a.Sk + TK - 1) / TK;
  const int qlast = min(q0 + TQ, a.S) - 1;
  int t_lo = 0, t_hi = nk;
  if (a.causal) t_hi = min(nk, qlast / TK + 1);
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;  // first key the first row sees
    if (lo > 0) t_lo = lo / TK;
  }

  // load i (K of tile t_lo + i / 2 for even i, its V for odd i) goes to
  // slot i % NS; one group is committed per load, empty or not, so that
  // load i is complete once at most NS - 2 groups are in flight before
  // phase i (group 0 also holds Q)
  auto slot = [&](int i) {
    return s_q + L::Q_BYTES + (i % NS) * L::KV_BYTES;
  };
  const int nload = 2 * max(t_hi - t_lo, 0);
  auto issue = [&](int i) {
    if (i >= nload) return;
    const int t = t_lo + (i >> 1);
    const float* base = (i & 1) ? vb : kb;
    const long long ss = (i & 1) ? a.v_ss : a.k_ss;
    load_rows<HD, TK>(slot(i), base + t * TK * ss, ss, a.Sk - t * TK, base,
                      tid);
  };
  auto landed = [&]() {  // the load before a phase complete and visible
    cp_async_wait<NS - 2>();
    __syncthreads();
  };
  load_rows<HD, TQ>(s_q, qb, a.q_ss, a.S - q0, qb, tid);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    issue(i);
    cp_async_commit();
  }

  F32Warp<HD> w;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.f;
  const float sl = a.scale * LOG2E;
  const int qw = q0 + warp * 16;  // this warp's first row

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = 2 * (t - t_lo);
    const int k0 = t * TK;
    // a tile that no row of this warp sees is skipped whole; at an edge,
    // the n-tiles [lo, hi) hold every key some row qw .. qw + 15 sees
    const bool skip = qw >= a.S || (a.causal && k0 > qw + 15) ||
                      (a.window > 0 && qw - (k0 + TK - 1) >= a.window);
    const bool edge = (a.causal && k0 + TK - 1 > qw) ||
                      (a.window > 0 && qw + 15 - k0 >= a.window) ||
                      k0 + TK > a.Sk;
    int lo = 0, hi = NT;
    if (edge) {
      int last = min(k0 + TK, a.Sk) - 1;
      if (a.causal) last = min(last, qw + 15);
      hi = last < k0 ? 0 : (last - k0) / 8 + 1;
      const int first = qw - a.window + 1;
      if (a.window > 0 && first > k0) lo = min(NT, (first - k0) / 8);
    }
    float s[NT][4];

    landed();
    issue(i + NS - 1);  // into the slot load i - 1 held
    cp_async_commit();
    if (!skip) {
      if (edge)
        f32_qk<HD, true>(w, s, s_q, slot(i), k0, qw, warp * 16, lane, lo, hi,
                         a, sl);
      else
        f32_qk<HD, false>(w, s, s_q, slot(i), k0, qw, warp * 16, lane, lo,
                          hi, a, sl);
    }

    landed();
    issue(i + NS);  // into the slot load i held
    cp_async_commit();
    if (!skip) f32_pv<HD>(w, s, smem + (slot(i + 1) - s_q), lane, lo, hi);
  }
  cp_async_wait<0>();  // Q's group, where no tile was loaded

  // epilogue: 2 * NPT neighbouring dims of each of this thread's two rows
  // a group of NPT n-tiles, straight to the output in 16-byte stores
  const int g = lane >> 2, t4 = lane & 3;
  float l0 = w.l[0], l1 = w.l[1];
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  // a row that saw no key (its max still NEG_INF, its o the p = 1 of
  // masked keys) is divided by infinity, to 0
  const float d[2] = {w.m[0] == NEG_INF ? INFINITY : fmaxf(l0, 1e-30f),
                      w.m[1] == NEG_INF ? INFINITY : fmaxf(l1, 1e-30f)};
  float* ob = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  constexpr int NPT = L::NPT;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = qw + g + 8 * half;
    if (qp >= a.S) continue;
    float* orow = ob + static_cast<long long>(qp) * a.o_ss + t4 * 2 * NPT;
    const float dd = d[half];
#pragma unroll
    for (int G = 0; G < HD / (8 * NPT); ++G) {
      const float(*og)[4] = w.o + G * NPT;
      float* dst = orow + G * 8 * NPT;
      if constexpr (NPT == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(og[0][2 * half] / dd, og[1][2 * half] / dd,
                        og[2][2 * half] / dd, og[3][2 * half] / dd);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(og[0][2 * half + 1] / dd, og[1][2 * half + 1] / dd,
                        og[2][2 * half + 1] / dd, og[3][2 * half + 1] / dd);
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(og[0][2 * half] / dd, og[1][2 * half] / dd,
                        og[0][2 * half + 1] / dd, og[1][2 * half + 1] / dd);
      }
    }
  }
}

// what cp.async's 16-byte copies need: aligned pointers, b/h/s strides
// in whole 16-byte chunks (`per16` elements)
bool aligned16(const FlashArgs& a, int per16) {
  const void* ptrs[] = {a.q, a.k, a.v, a.o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh,
                               a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.o_sb,
                               a.o_sh, a.o_ss};
  for (long long s : strides)
    if (s % per16) return false;
  return true;
}

constexpr int kMaxDevices = 64;

// `kernel` allowed `smem_bytes` of dynamic shared memory on the current
// device: past 48 KB the attribute is set, once per device (it holds for
// this function on this device, not for one launch)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool>* allowed,
                       int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    allowed[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// `kernel` launched over the (q tile, b, h) blocks with `smem_bytes` of
// dynamic shared memory; or, where `blocks_per_sm` is given, the blocks
// an SM the occupancy calculator gives for it instead of a launch
template <typename Kernel>
cudaError_t launch_blocks(Kernel kernel, std::atomic<bool>* allowed,
                          int smem_bytes, const FlashArgs& a,
                          cudaStream_t stream, int* blocks_per_sm) {
  cudaError_t err = allow_smem(kernel, allowed, smem_bytes);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, THREADS, smem_bytes);
  const long long blocks =
      static_cast<long long>((a.S + TQ - 1) / TQ) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const FlashArgs& a, int dtype, cudaStream_t stream,
                      int* blocks_per_sm = nullptr) {
  if (dtype == 1) {
    static std::atomic<bool> allowed[kMaxDevices];
    return launch_blocks(flash_mma<HD>, allowed, Tile<HD>::SMEM, a, stream,
                         blocks_per_sm);
  }
  static std::atomic<bool> allowed[kMaxDevices];
  return launch_blocks(flash_tf32x3<HD>, allowed, F32Tile<HD>::SMEM, a,
                       stream, blocks_per_sm);
}

int smem_hd(int dtype, int hd) {
  switch (hd) {
    case 16: return dtype ? Tile<16>::SMEM : F32Tile<16>::SMEM;
    case 32: return dtype ? Tile<32>::SMEM : F32Tile<32>::SMEM;
    case 64: return dtype ? Tile<64>::SMEM : F32Tile<64>::SMEM;
    case 128: return dtype ? Tile<128>::SMEM : F32Tile<128>::SMEM;
    case 256: return dtype ? Tile<256>::SMEM : F32Tile<256>::SMEM;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int flash_attention_args_size(void) {
  return static_cast<int>(sizeof(FlashArgs));
}

// dtype: 0 float32 (flash_tf32x3; 16-byte aligned pointers, b/h/s
// strides multiples of 4), 1 bfloat16 (flash_mma; 16-byte aligned
// pointers, b/h/s strides multiples of 8); q, k, v and o alike; hd in
// {16, 32, 64, 128, 256}.  Launches on `stream` on the current device;
// returns cudaGetLastError() (0 = launched).
int flash_attention_launch(FlashArgs a, int dtype, int hd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(a, dtype ? 8 : 4)) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16: err = launch_hd<16>(a, dtype, s); break;
    case 32: err = launch_hd<32>(a, dtype, s); break;
    case 64: err = launch_hd<64>(a, dtype, s); break;
    case 128: err = launch_hd<128>(a, dtype, s); break;
    case 256: err = launch_hd<256>(a, dtype, s); break;
  }
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory a launch of the kernel for (dtype, hd)
// uses: the Q tile and the K/V ring, flash_tf32x3's or flash_mma's.
int flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype != 0 && dtype != 1) return -1;
  return smem_hd(dtype, hd);
}

// Blocks of the kernel for (dtype, hd) an SM of the current device holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers,
// shared memory and threads); -1 for no such kernel, or on an error.
int flash_attention_blocks_per_sm(int dtype, int hd) {
  if (dtype != 0 && dtype != 1) return -1;
  int n = -1;
  const FlashArgs none{};
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16: err = launch_hd<16>(none, dtype, nullptr, &n); break;
    case 32: err = launch_hd<32>(none, dtype, nullptr, &n); break;
    case 64: err = launch_hd<64>(none, dtype, nullptr, &n); break;
    case 128: err = launch_hd<128>(none, dtype, nullptr, &n); break;
    case 256: err = launch_hd<256>(none, dtype, nullptr, &n); break;
  }
  return err == cudaSuccess ? n : -1;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
