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
// or wholly outside the window are never loaded.  Any strides, hd
// contiguous.  The wrapper's `kernel_for` picks the kernel by dtype.
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
// float32: `flash_fma`, on the CUDA cores (hd 16, 32, 64), the kernel of
// the first port: one thread per query row (64 a block), q and the
// output accumulator in registers, K and V tiles in shared memory read
// as broadcasts, keys folded into the online softmax 16 at a time, plain
// float32 FMAs.  It stays because the float32 tolerance of the JAX
// kernel tests is 1e-5, which TF32 tensor cores (about 1e-3) cannot
// meet, and float32 is not the serving dtype.
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

// ------------------------------------------------------------ float32

constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per K/V tile in shared memory
constexpr int CH = 16;   // keys per online-softmax update

template <int HD>
__global__ void __launch_bounds__(BQ) flash_fma(FlashArgs a) {
  __shared__ __align__(16) float ks[BK * HD];
  __shared__ __align__(16) float vs[BK * HD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x;
  const int qpos = q0 + tid;
  const bool qvalid = qpos < a.S;

  float q[HD];
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb +
                    h * a.q_sh + static_cast<long long>(qpos) * a.q_ss;
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = qvalid ? qp[d] : 0.f;

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // the k-tiles any row of this block can see
  const int nk = (a.Sk + BK - 1) / BK;
  const int qlast = min(q0 + BQ, a.S) - 1;
  int t_lo = 0, t_hi = nk;
  if (a.causal) t_hi = min(nk, qlast / BK + 1);
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;  // first key the first row sees
    if (lo > 0) t_lo = lo / BK;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every thread is done with the last tile
    for (int i = tid; i < BK * HD; i += BQ) {
      const int r = i / HD, d = i % HD;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < a.Sk) {
        kx = kb[static_cast<long long>(kp) * a.k_ss + d];
        vx = vb[static_cast<long long>(kp) * a.v_ss + d];
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += CH) {
      float s[CH];
      float mc = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (j0 + jj) * HD);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kk = kr[d4];
          dot += q[4 * d4] * kk.x;
          dot += q[4 * d4 + 1] * kk.y;
          dot += q[4 * d4 + 2] * kk.z;
          dot += q[4 * d4 + 3] * kk.w;
        }
        const int kp = k0 + j0 + jj;
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && qpos >= kp;
        if (a.window > 0) ok = ok && (qpos - kp < a.window);
        s[jj] = ok ? dot * a.scale : NEG_INF;
        mc = fmaxf(mc, s[jj]);
      }
      const float mn = fmaxf(m, mc);
      const float corr = expf(m - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        s[jj] = expf(s[jj] - mn);
        ps += s[jj];
      }
      l = l * corr + ps;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float pj = s[jj];
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (j0 + jj) * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += pj * vv.x;
          acc[4 * d4 + 1] += pj * vv.y;
          acc[4 * d4 + 2] += pj * vv.z;
          acc[4 * d4 + 3] += pj * vv.w;
        }
      }
      m = mn;
    }
  }

  if (!qvalid) return;
  // a row that saw no key (m still NEG_INF) is divided by infinity, to 0
  const float den = m == NEG_INF ? INFINITY : fmaxf(l, 1e-30f);
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
              static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = acc[d] / den;
}

cudaError_t launch_fma(const FlashArgs& a, int hd, cudaStream_t stream) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  switch (hd) {
    case 16: flash_fma<16><<<grid, BQ, 0, stream>>>(a); break;
    case 32: flash_fma<32><<<grid, BQ, 0, stream>>>(a); break;
    case 64: flash_fma<64><<<grid, BQ, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

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

// what cp.async's 16-byte copies need: aligned pointers, b/h/s strides
// in whole 16-byte chunks
bool aligned16(const FlashArgs& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh,
                               a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.o_sb,
                               a.o_sh, a.o_ss};
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

constexpr int kMaxDevices = 64;

template <int HD>
cudaError_t launch_mma_hd(const FlashArgs& a, cudaStream_t stream) {
  using L = Tile<HD>;
  if (L::SMEM > 48 * 1024) {
    // the attribute holds for this function on this device: set it once
    // per device, not on every launch
    static std::atomic<bool> allowed[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!allowed[dev].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(flash_mma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::SMEM);
      if (err != cudaSuccess) return err;
      allowed[dev].store(true, std::memory_order_release);
    }
  }
  const long long blocks =
      static_cast<long long>((a.S + TQ - 1) / TQ) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_mma<HD><<<static_cast<unsigned>(blocks), THREADS, L::SMEM, stream>>>(
      a);
  return cudaGetLastError();
}

cudaError_t launch_mma(const FlashArgs& a, int hd, cudaStream_t stream) {
  if (!aligned16(a)) return cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return launch_mma_hd<16>(a, stream);
    case 32: return launch_mma_hd<32>(a, stream);
    case 64: return launch_mma_hd<64>(a, stream);
    case 128: return launch_mma_hd<128>(a, stream);
    case 256: return launch_mma_hd<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int mma_smem_bytes(int hd) {
  switch (hd) {
    case 16: return Tile<16>::SMEM;
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 128: return Tile<128>::SMEM;
    case 256: return Tile<256>::SMEM;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int flash_attention_args_size(void) {
  return static_cast<int>(sizeof(FlashArgs));
}

// dtype: 0 float32 (flash_fma, hd in {16, 32, 64}), 1 bfloat16
// (flash_mma, hd in {16, 32, 64, 128, 256}; 16-byte aligned pointers, b/h/s
// strides multiples of 8); q, k, v and o alike.  Launches on `stream` on
// the current device; returns cudaGetLastError() (0 = launched).
int flash_attention_launch(FlashArgs a, int dtype, int hd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_fma(a, hd, s);
  if (dtype == 1) err = launch_mma(a, hd, s);
  return static_cast<int>(err);
}

// Bytes of shared memory a launch of the kernel for (dtype, hd) uses:
// flash_fma's static tiles, flash_mma's dynamic Q tile and K/V ring.
int flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype == 0 && (hd == 16 || hd == 32 || hd == 64))
    return 2 * BK * hd * 4;
  if (dtype == 1) return mma_smem_bytes(hd);
  return -1;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
