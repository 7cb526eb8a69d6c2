// The Mamba-2 SSD intra-chunk block: the CUDA kernels behind
// repro_torch.kernels.ssd_scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:49 `ssd_intra`
// (body `_kernel` at :21, pl.pallas_call at :56).  For every chunk t of q
// tokens and every head h it computes, with cs = cumsum(dA) over the
// chunk (float32),
//   y[i]  = sum_{j <= i} CB[i,j] * exp(clip(cs_i - cs_j, -60, 0)) * dt_j * x[j]
//   S     = sum_j (B[j] * exp(clip(cs_end - cs_j, -60, 0)) * dt_j) (x) x[j]
// with CB = C . B^T.  The Pallas grid is (chunk, head) and recomputes
// C . B^T for every head; here head h reads B and C of its group
// h / (R / G), so one block owns (chunk t, group g, a tile of HT heads of
// g): it computes CB once and loops over its heads.  With mamba2-2.7b's
// one group that halves the operations of a launch (CB is a quarter of
// the work per head).  Two kernels, picked by the wrapper's `kernel_for`:
// `mma_bf16` (bf16 in `model` rounding, the mamba2 prefill's call) on the
// tensor cores, and `fma_f32` (every other call) on the CUDA cores.
//
// Layouts.  Every operand comes with its strides (the last dimension
// contiguous), so the model's views need no copy: x is a slice of the
// convolution output (token stride conv_dim), B and C are [T, q, G, n]
// per group.  The ops layout (B and C per head) is the case G = R.
//
// Rounding (`mode`):
//   0 `pallas`: the Pallas body: W = CB * L * dt and B * (decay_end * dt)
//     in float32, y and S written in x's dtype;
//   1 `model`: what src/repro/models/ssm.py does around its einsums: CB, L
//     and dt each rounded to x's dtype and the product rounded after each
//     multiply (ssm.py:76-77), decay_end * dt rounded (:83); y and S
//     written in float32 (:79, :84).
// In float32 the two modes are the same computation.
//
// Bound.  At mamba2-2.7b's prefill (T = 32 chunks, R = 80 heads, q = n =
// 128, p = 64, bf16) the launch reads 47 MB (x, B and C once per group,
// dt, dA) and writes 84 MB (pallas) or 168 MB (model): 0.039 or 0.064 ms
// at 3.35 TB/s, against 8.1 GFLOP of causal work, 8 us at the bf16
// tensor-core rate.  Bytes bound it.
//
// `fma_f32` (the kernel of the first port; x's dtype float32 or bf16,
// either mode).  256 threads.  Shared memory, float32:
//   Bt, Ct  [n8][q8 + 4]   B and C transposed (k-major), 16-byte rows
//   CB      [q8][q8 + 1]   C . B^T, lower triangle (odd row stride: the
//                          threads of a warp read 8 different rows)
//   X       [q8][p16]      the head's x tile (shares Ct's space: Ct is
//                          dead once CB is built)
//   cs, dt, w  [q8]        per head
// 202,752 bytes at q = n = 128, p = 64 (dynamic shared memory, above the
// 48 KB default).  CB: one thread per 8x8 tile on or below the diagonal,
// float4 loads of Ct and Bt.  y: one thread per (row pair i, q-1-i; 16
// columns), so that every thread does q + 1 steps of the causal sum
// (the upper triangle is skipped); the weight of (i, j) is made in
// registers from CB, cs and dt.  S: one thread per (8 state rows; 4
// columns).  The cumsum is a sequential sum in one thread.  All products
// are float32 FMAs on the CUDA cores, so at the prefill's shape it is
// bound by its operations far above the bytes' floor.  It stays for
// float32, whose 1e-4 tolerance the bf16 tensor cores cannot meet, and
// for the `pallas` rounding, whose float32 weights no bf16 operand holds.
//
// `mma_bf16` (bf16, `model` rounding; q <= 128, n <= 128 and p <= 64,
// n and p multiples of 8).  Every product is mma.sync.m16n8k16 bf16 with
// float32 accumulation on tiles of 128 tokens x 128 states x 64 columns,
// zero-filled beyond q, n and p (the row tiles past q are skipped).
//  - Four warps a block, 2 blocks an SM (111.5 KB of dynamic shared memory
//    at 10 heads a block, which makes mamba2-2.7b's prefill one wave).  Warp w owns the row tiles w and 7 - w of y and
//    CB, and the row tiles w and 7 - w of S: the causal row tile i does
//    i + 1 of the 16-token k-tiles, so each warp does 9.
//  - B, C and each head's x are copied with cp.async 16 bytes a thread
//    into XOR-swizzled tiles (the 8 rows an ldmatrix reads sit in 8 bank
//    groups); the next head's x is in flight while a head computes.
//    16-byte copies need 16-byte aligned pointers and strides in whole
//    16-byte chunks; the launch refuses anything else.
//  - CB = C . B^T once a block, only the 16 x 16 blocks on or below the
//    diagonal (C through ldmatrix as the A operand, B rows as the B
//    operand), rounded to bf16 (RNE, as torch casts) and held in
//    registers in the C-fragment layout for all the block's heads: 36
//    registers a thread.  Its products are exact; only the order of the
//    float32 sums differs from the plain version.
//  - The cumsum runs once for all the block's heads, one thread a head,
//    in order (cs_i - cs_j cancels when the decays are large, so cs must
//    round as the plain version's torch.cumsum does: a warp scan differed
//    by 3e-3).  w_j = rnd(decay(cs_end - cs_j) * dt_j) and rnd(dt_j) are
//    made beside it.
//  - y = W . x: W[i,j] = rnd(rnd(rnd(CB) * rnd(L)) * rnd(dt_j)), L =
//    exp(clip(cs_i - cs_j, -60, 0)) (expf, as torch.exp) on i >= j, is
//    made in registers from the CB fragments, two entries at a time: L
//    rounded into a bf16 pair, then two mul.rn.bf16x2 (a product of two
//    bf16 is exact in float32, so each rounds as the plain version's
//    float32 multiply and cast).  W lands in A fragments as it is made;
//    it is exactly a bf16, so the operand loses nothing.  x
//    enters as the B operand through ldmatrix.trans, loaded before W is
//    made so that its latency hides there; k-tiles above the diagonal are
//    never touched.
//  - S = (B * w)^T . x: B^T enters as the A operand through
//    ldmatrix.trans, scaled by w per k index.  B * w, a product of two
//    bf16, has at most 16 significant bits: exact in float32 but no bf16.
//    It is split as hi = bf16(B * w) and lo = bf16(B * w - hi), which
//    holds the rest exactly (a mul.rn.bf16x2 and an fma.rn.bf16x2 a
//    pair), and hi^T . x + lo^T . x go into one float32
//    accumulator: two mmas, no rounding the plain version lacks.  Both of
//    the warp's S row tiles run together, sharing x's fragments, and all
//    hi products of a k-tile issue before the lo products, so that no
//    mma waits on the one before it.
//  - y and S leave in float32 through the warp's own rows of a staging
//    tile (C's space once CB is made), 16 bytes a thread, two 256-byte
//    rows a warp store.

#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Outside the unnamed namespace: the exported launch function takes it by
// value, and a parameter type with internal linkage would keep that
// function out of the library's symbols.
struct SsdArgs {
  const void* x;    // [T, q, R, p], x's dtype
  const float* dt;  // [T, q, R]
  const float* dA;  // [T, q, R]
  const void* B;    // [T, q, G, n], x's dtype
  const void* C;    // [T, q, G, n]
  void* y;          // [T, q, R, p]: x's dtype (pallas) or float32 (model)
  void* S;          // [T, R, n, p]: the same dtype as y
  long long x_st, x_sq, x_sh;  // strides in elements
  long long dt_st, dt_sq, dt_sh;
  long long dA_st, dA_sq, dA_sh;
  long long B_st, B_sq, B_sg;
  long long C_st, C_sq, C_sg;
  long long y_st, y_sq, y_sh;
  long long S_st, S_sh, S_sn;
  int T, q, R, G, p, n;
  int heads_per_block;
  int mode;  // 0 pallas, 1 model
};

namespace {

constexpr int NT = 256;  // threads per block
constexpr int YC = 16;   // y columns per thread
constexpr int SR = 8;    // S rows per thread
constexpr int SC = 4;    // S columns per thread

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
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// a float32 value as x's dtype holds it
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float decay(float d) {
  return expf(fminf(fmaxf(d, -60.f), 0.f));
}

template <typename T>
__device__ __forceinline__ void store(void* base, long long off, float v,
                                      bool f32) {
  if (f32)
    static_cast<float*>(base)[off] = v;
  else
    static_cast<T*>(base)[off] = from_f<T>(v);
}

__host__ __device__ __forceinline__ int up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Layout {  // offsets (floats) into the dynamic shared memory
  int q8, n8, p16, ldt, ldcb;
  int bt, ct, xs, cb, cs, dt, w, total;
  __host__ __device__ Layout(int q, int n, int p) {
    q8 = up(q, 8);
    n8 = up(n, 8);
    p16 = up(p, YC);
    ldt = q8 + 4;
    ldcb = q8 + 1;
    bt = 0;
    ct = bt + n8 * ldt;
    xs = ct;  // X reuses Ct's space
    const int u = n8 * ldt > q8 * p16 ? n8 * ldt : q8 * p16;
    cb = ct + u;
    cs = cb + q8 * ldcb;
    dt = cs + q8;
    w = dt + q8;
    total = w + q8;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const Layout lay(a.q, a.n, a.p);
  float* Bt = sm + lay.bt;
  float* Ct = sm + lay.ct;
  float* X = sm + lay.xs;
  float* CB = sm + lay.cb;
  float* cs = sm + lay.cs;
  float* dts = sm + lay.dt;
  float* ws = sm + lay.w;

  const int t = blockIdx.x, g = blockIdx.y;
  const int r = a.R / a.G;
  const int h0 = blockIdx.z * a.heads_per_block;
  const int tid = threadIdx.x;
  const int q = a.q, n = a.n, p = a.p;
  const int q8 = lay.q8, ldt = lay.ldt, ldcb = lay.ldcb, p16 = lay.p16;
  const bool model = a.mode == 1;

  // B and C of (t, g), transposed, zero beyond q and n
  const T* Bg = static_cast<const T*>(a.B) + t * a.B_st + g * a.B_sg;
  const T* Cg = static_cast<const T*>(a.C) + t * a.C_st + g * a.C_sg;
  for (int idx = tid; idx < q8 * lay.n8; idx += NT) {
    const int j = idx / lay.n8, k = idx % lay.n8;
    float bv = 0.f, cv = 0.f;
    if (j < q && k < n) {
      bv = to_f(Bg[j * a.B_sq + k]);
      cv = to_f(Cg[j * a.C_sq + k]);
    }
    Bt[k * ldt + j] = bv;
    Ct[k * ldt + j] = cv;
  }
  __syncthreads();

  // CB = C . B^T on and below the diagonal, one 8x8 tile per thread
  const int nti = q8 / 8;
  for (int tile = tid; tile < nti * nti; tile += NT) {
    const int ti = tile / nti, tj = tile % nti;
    if (tj > ti) continue;
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    for (int k = 0; k < n; ++k) {
      const float4* cr = reinterpret_cast<const float4*>(Ct + k * ldt + ti * 8);
      const float4* br = reinterpret_cast<const float4*>(Bt + k * ldt + tj * 8);
      const float4 c0 = cr[0], c1 = cr[1], b0 = br[0], b1 = br[1];
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        CB[(ti * 8 + u) * ldcb + tj * 8 + v] = acc[u][v];
  }
  __syncthreads();  // Ct is dead from here: X takes its space

  const int lane = tid & 31;
  for (int hh = 0; hh < a.heads_per_block; ++hh) {
    const int h = h0 + hh;
    if (h >= r) break;
    const int R = g * r + h;

    // dt, dA and the cumsum (warp 0).  The cumsum runs in one thread, in
    // order: cs_i - cs_j cancels when the decays are large (|cs| in the
    // thousands), so cs must round as the plain version's torch.cumsum
    // does (a sequential sum along a dimension that is not the innermost)
    if (tid < 32) {
      for (int i = lane; i < q8; i += 32) {
        float d = 0.f, s = 0.f;
        if (i < q) {
          d = a.dA[t * a.dA_st + i * a.dA_sq + R * a.dA_sh];
          s = a.dt[t * a.dt_st + i * a.dt_sq + R * a.dt_sh];
        }
        cs[i] = d;
        dts[i] = s;
      }
      __syncwarp();
      if (lane == 0) {
        float run = 0.f;
        for (int i = 0; i < q8; ++i) {
          run += cs[i];
          cs[i] = run;
        }
      }
      __syncwarp();
      const float cs_end = cs[q - 1];
      for (int i = lane; i < q8; i += 32) {
        const float wv = decay(cs_end - cs[i]) * dts[i];
        ws[i] = model ? rnd<T>(wv) : wv;
      }
    }
    // the head's x tile, zero beyond q and p
    const T* xh = static_cast<const T*>(a.x) + t * a.x_st + R * a.x_sh;
    for (int idx = tid; idx < q8 * p16; idx += NT) {
      const int i = idx / p16, c = idx % p16;
      X[idx] = (i < q && c < p) ? to_f(xh[i * a.x_sq + c]) : 0.f;
    }
    __syncthreads();

    // y: rows i1 = pr and i2 = q-1-pr, YC columns
    const int ncg = p16 / YC, npair = (q + 1) / 2;
    for (int task = tid; task < npair * ncg; task += NT) {
      const int pr = task / ncg, c0 = (task % ncg) * YC;
      const int i1 = pr, i2 = q - 1 - pr;
      const float cs1 = cs[i1], cs2 = cs[i2];
      float acc1[YC], acc2[YC];
#pragma unroll
      for (int c = 0; c < YC; ++c) acc1[c] = acc2[c] = 0.f;
      for (int j = 0; j <= i2; ++j) {
        const float4* xr = reinterpret_cast<const float4*>(X + j * p16 + c0);
        float xv[YC];
#pragma unroll
        for (int c4 = 0; c4 < YC / 4; ++c4) {
          const float4 f = xr[c4];
          xv[4 * c4] = f.x;
          xv[4 * c4 + 1] = f.y;
          xv[4 * c4 + 2] = f.z;
          xv[4 * c4 + 3] = f.w;
        }
        const float dj = dts[j], csj = cs[j];
        float w2;
        if (model)
          w2 = rnd<T>(rnd<T>(rnd<T>(CB[i2 * ldcb + j]) *
                             rnd<T>(decay(cs2 - csj))) * rnd<T>(dj));
        else
          w2 = CB[i2 * ldcb + j] * decay(cs2 - csj) * dj;
#pragma unroll
        for (int c = 0; c < YC; ++c) acc2[c] = fmaf(w2, xv[c], acc2[c]);
        if (j <= i1) {
          float w1;
          if (model)
            w1 = rnd<T>(rnd<T>(rnd<T>(CB[i1 * ldcb + j]) *
                               rnd<T>(decay(cs1 - csj))) * rnd<T>(dj));
          else
            w1 = CB[i1 * ldcb + j] * decay(cs1 - csj) * dj;
#pragma unroll
          for (int c = 0; c < YC; ++c) acc1[c] = fmaf(w1, xv[c], acc1[c]);
        }
      }
      const long long yb = t * a.y_st + R * a.y_sh;
#pragma unroll
      for (int c = 0; c < YC; ++c) {
        if (c0 + c >= p) break;
        store<T>(a.y, yb + i2 * a.y_sq + c0 + c, acc2[c], model);
        if (i1 != i2) store<T>(a.y, yb + i1 * a.y_sq + c0 + c, acc1[c], model);
      }
    }

    // S: state rows k0..k0+SR, columns c0..c0+SC
    const int scg = (p + SC - 1) / SC, srg = lay.n8 / SR;
    for (int task = tid; task < srg * scg; task += NT) {
      const int k0 = (task / scg) * SR, c0 = (task % scg) * SC;
      float acc[SR][SC];
#pragma unroll
      for (int u = 0; u < SR; ++u)
#pragma unroll
        for (int c = 0; c < SC; ++c) acc[u][c] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float wj = ws[j];
        const float4 f = *reinterpret_cast<const float4*>(X + j * p16 + c0);
        const float xv[SC] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int u = 0; u < SR; ++u) {
          const float bw = Bt[(k0 + u) * ldt + j] * wj;
#pragma unroll
          for (int c = 0; c < SC; ++c) acc[u][c] = fmaf(bw, xv[c], acc[u][c]);
        }
      }
      const long long sb = t * a.S_st + R * a.S_sh;
#pragma unroll
      for (int u = 0; u < SR; ++u) {
        if (k0 + u >= n) break;
#pragma unroll
        for (int c = 0; c < SC; ++c)
          if (c0 + c < p)
            store<T>(a.S, sb + (k0 + u) * a.S_sn + c0 + c, acc[u][c], model);
      }
    }
    __syncthreads();  // X, cs, dt and w are rewritten for the next head
  }
}

template <typename T>
cudaError_t launch_typed(const SsdArgs& a, cudaStream_t stream) {
  const Layout lay(a.q, a.n, a.p);
  const size_t bytes = sizeof(float) * lay.total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int r = a.R / a.G;
  const dim3 grid(a.T, a.G, (r + a.heads_per_block - 1) / a.heads_per_block);
  ssd_kernel<T><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------------------------ mma_bf16

using bf16 = __nv_bfloat16;

constexpr int MW = 4;          // warps a block
constexpr int MT = 32 * MW;    // threads a block
constexpr int TQ = 128;        // tokens of the tiles (q <= TQ): 8 row tiles
constexpr int TN = 128;        // states (n <= TN)
constexpr int TP = 64;         // head width (p <= TP)
constexpr int NRT = TQ / 16;   // row tiles
constexpr int CSTR = TQ + 4;   // floats a head's row of cs, rdt and w takes
static_assert(NRT == 2 * MW, "warp w owns the row tiles w and NRT-1-w");

// dynamic shared memory, bytes: B [TQ][TN] bf16; C [TQ][TN] bf16, whose
// space is the float32 staging tile [TQ][TP] once CB is made; x of two
// heads, [TQ][TP] bf16 each; then cs, rdt and w, [HT][CSTR] float each
constexpr int SM_B = 0;
constexpr int SM_ST = SM_B + TQ * TN * 2;
constexpr int SM_X = SM_ST + TQ * TN * 2;
constexpr int X_BYTES = TQ * TP * 2;
constexpr int SM_SC = SM_X + 2 * X_BYTES;
static_assert(TQ * TP * 4 == TQ * TN * 2, "staging tile fills C's space");

__host__ __device__ constexpr int mma_smem(int heads) {
  return SM_SC + 3 * heads * CSTR * 4;
}

// A tile of 256-byte rows (128 bf16; the staging tile's 64 float32):
// 16-byte chunk c of row r is stored at chunk c ^ (r & 7), so that the 8
// rows an ldmatrix reads fall on 8 distinct 16-byte bank groups.
__device__ __forceinline__ uint32_t sw256(int r, int c) {
  return static_cast<uint32_t>(r * 256 + ((c ^ (r & 7)) << 4));
}
// The staging tile: chunk c ^ ((r & 7) << 1), so that a warp's 8-byte
// C-fragment stores (8 rows, 2 chunks a row) and its 16-byte row reads
// each take the least number of shared-memory wavefronts.
__device__ __forceinline__ uint32_t sws(int r, int c) {
  return static_cast<uint32_t>(r * 256 + ((c ^ ((r & 7) << 1)) << 4));
}
// A tile of 128-byte rows (x: 64 bf16): chunk c ^ (r & 7).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// The helpers below are csrc/flash_attention.cu's (each library is built
// from one source).
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

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// rows [0, rows) and 16-byte chunks [0, chunks) of an [R][NCH chunks]
// tile whose row r is at src + r * ss (elements), into the swizzled tile
// at dst; the rest is zero-filled (src-size 0, nothing read)
template <int R, int NCH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ss, int rows, int chunks,
                                          int tid) {
  static_assert(R * NCH % MT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * NCH / MT; ++it) {
    const int i = tid + it * MT;
    const int r = i / NCH, c = i % NCH;
    const bool ok = r < rows && c < chunks;
    cp_async16(dst + (NCH == 16 ? sw256(r, c) : sw128(r, c)),
               ok ? src + r * ss + c * 8 : src, ok);
  }
}

// a * b and a * b + c on bf16 pairs, each rounded once to bf16 (nearest
// even).  The product of two bf16 is exact in float32, so mul is what
// the plain version's float32 multiply and cast give.
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// W[i, j], W[i, j + 1] as a bf16 pair from rnd(CB) and rnd(dt) (bf16
// pairs): rnd(rnd(rnd(CB) * rnd(L)) * rnd(dt)), L = exp(clip(cs_i - cs_j,
// -60, 0)) where i >= j, else 0 (the plain version's tril).  DIAG: the
// 16 x 16 block on the diagonal, the only one where i < j occurs.
template <bool DIAG>
__device__ __forceinline__ uint32_t w_pair(uint32_t cb, float csi,
                                           float2 csj, uint32_t rdt, int i,
                                           int j) {
  const float l0 = !DIAG || i >= j ? decay(csi - csj.x) : 0.f;
  const float l1 = !DIAG || i >= j + 1 ? decay(csi - csj.y) : 0.f;
  return mul2(mul2(cb, pack(l0, l1)), rdt);
}

// B * w for a pair of bf16 B (k indices j, j + 1) and their w (a bf16
// pair), split into hi = bf16(B * w) and lo = bf16(B * w - hi), the
// latter one fused multiply-add: B * w has at most 16 significant bits,
// so lo holds the rest exactly and hi + lo == B * w
__device__ __forceinline__ void split(uint32_t b, uint32_t w, uint32_t& hi,
                                      uint32_t& lo) {
  hi = mul2(b, w);
  lo = fma2(b, w, hi ^ 0x80008000u);  // B * w + (-hi)
}

// A warp's m16 x 64 float32 tile (C fragments) to rows [0, rows) and
// columns [0, cols) of `out` (row stride ld), through rows row0 .. row0
// + 15 of the staging tile, which only this warp uses: 16 bytes a thread.
__device__ __forceinline__ void flush(const float (&acc)[TP / 8][4],
                                      unsigned char* stg, int row0,
                                      float* out, long long ld, int rows,
                                      int cols, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  __syncwarp();  // the warp's last reads of these rows are done
#pragma unroll
  for (int nn = 0; nn < TP / 8; ++nn) {
    const int c = 2 * nn + (t4 >> 1), off = (t4 & 1) * 8;
    *reinterpret_cast<float2*>(stg + sws(row0 + g, c) + off) =
        make_float2(acc[nn][0], acc[nn][1]);
    *reinterpret_cast<float2*>(stg + sws(row0 + g + 8, c) + off) =
        make_float2(acc[nn][2], acc[nn][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * TP / 4 / 32; ++it) {
    const int rr = 2 * it + (lane >> 4), c = lane & 15;
    if (rr < rows && 4 * c < cols)
      *reinterpret_cast<float4*>(out + rr * ld + 4 * c) =
          *reinterpret_cast<const float4*>(stg + sws(row0 + rr, c));
  }
}

__global__ void __launch_bounds__(MT, 2) ssd_mma(SsdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sB = s0 + SM_B, sC = s0 + SM_ST, sX = s0 + SM_X;
  unsigned char* stg = smem + SM_ST;
  const int HT = a.heads_per_block;
  float* cs = reinterpret_cast<float*>(smem + SM_SC);  // [HT][CSTR]
  float* rdt = cs + HT * CSTR;
  float* wv = rdt + HT * CSTR;

  const int t = blockIdx.x, g = blockIdx.y;
  const int r = a.R / a.G;
  const int h0 = blockIdx.z * HT;
  const int nh = min(HT, r - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = a.q, n = a.n, p = a.p;
  const int nrt = (q + 15) / 16;  // row tiles that hold tokens

  const bf16* Bg = static_cast<const bf16*>(a.B) + t * a.B_st + g * a.B_sg;
  const bf16* Cg = static_cast<const bf16*>(a.C) + t * a.C_st + g * a.C_sg;
  const bf16* xg = static_cast<const bf16*>(a.x) + t * a.x_st +
                   static_cast<long long>(g * r + h0) * a.x_sh;

  // group 0: B and C; group 1: the first head's x
  load_tile<TQ, TN / 8>(sB, Bg, a.B_sq, q, n / 8, tid);
  load_tile<TQ, TN / 8>(sC, Cg, a.C_sq, q, n / 8, tid);
  cp_async_commit();
  load_tile<TQ, TP / 8>(sX, xg, a.x_sq, q, p / 8, tid);
  cp_async_commit();

  // dA and dt of the block's heads, zero beyond q and nh
  for (int idx = tid; idx < HT * TQ; idx += MT) {
    const int hh = idx % HT, i = idx / HT;
    float d = 0.f, s = 0.f;
    if (hh < nh && i < q) {
      const long long R = g * r + h0 + hh;
      d = a.dA[t * a.dA_st + i * a.dA_sq + R * a.dA_sh];
      s = a.dt[t * a.dt_st + i * a.dt_sq + R * a.dt_sh];
    }
    cs[hh * CSTR + i] = d;
    rdt[hh * CSTR + i] = s;
  }
  __syncthreads();
  // the cumsum, in order, one thread a head (zeros past q add nothing)
  if (tid < nh) {
    float* c = cs + tid * CSTR;
    float run = 0.f;
    for (int i = 0; i < TQ; ++i) {
      run += c[i];
      c[i] = run;
    }
  }
  __syncthreads();
  // w = rnd(decay(cs_end - cs) * dt) from the raw dt, then dt rounded
  for (int idx = tid; idx < nh * TQ; idx += MT) {
    const int hh = idx / TQ, i = idx % TQ;
    const float* c = cs + hh * CSTR;
    const float d = rdt[hh * CSTR + i];
    wv[hh * CSTR + i] = rnd<bf16>(decay(c[q - 1] - c[i]) * d);
    rdt[hh * CSTR + i] = rnd<bf16>(d);
  }
  cp_async_wait<1>();  // B and C have landed (this thread's copies)
  __syncthreads();

  const int g4 = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  // the warp's 9 units (row tile, k-tile): u <= warp: (warp, u); else
  // (NRT - 1 - warp, u - warp - 1)
  auto unit_rt = [&](int u) { return u <= warp ? warp : NRT - 1 - warp; };
  auto unit_kt = [&](int u) { return u <= warp ? u : u - warp - 1; };

  // CB = C . B^T on the warp's units, rounded to bf16, as A fragments:
  // [0] rows i, columns j, j + 1; [1] rows i + 8; [2] columns j + 8,
  // j + 9; [3] both (i = 16 rt + g4, j = 16 kt + 2 t4)
  uint32_t cb[NRT + 1][4];
#pragma unroll
  for (int u = 0; u <= NRT; ++u) {
    const int rt = unit_rt(u), kt = unit_kt(u);
    float acc[2][4] = {};
    if (rt < nrt) {
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk) {
        if (16 * kk >= n) break;
        uint32_t ca[4], bk[4];
        ldsm_x4(ca, sC + sw256(16 * rt + (lane & 15), 2 * kk + (lane >> 4)));
        ldsm_x4(bk, sB + sw256(16 * kt + (mi >> 1) * 8 + mr, 2 * kk + (mi & 1)));
        mma(acc[0], ca, bk[0], bk[1]);
        mma(acc[1], ca, bk[2], bk[3]);
      }
    }
    cb[u][0] = pack(acc[0][0], acc[0][1]);
    cb[u][1] = pack(acc[0][2], acc[0][3]);
    cb[u][2] = pack(acc[1][0], acc[1][1]);
    cb[u][3] = pack(acc[1][2], acc[1][3]);
  }

  float* yb = static_cast<float*>(a.y) + t * a.y_st;
  float* Sb = static_cast<float*>(a.S) + t * a.S_st;
  for (int hh = 0; hh < nh; ++hh) {
    const uint32_t xs = sX + (hh & 1) * X_BYTES;
    __syncthreads();  // every warp is done with head hh - 1 and its x
    if (hh + 1 < nh)
      load_tile<TQ, TP / 8>(sX + ((hh + 1) & 1) * X_BYTES,
                            xg + (hh + 1) * a.x_sh, a.x_sq, q, p / 8, tid);
    cp_async_commit();   // one group an iteration, empty or not
    cp_async_wait<1>();  // head hh's x has landed
    __syncthreads();
    const float* hcs = cs + hh * CSTR;
    const float* hdt = rdt + hh * CSTR;
    const float* hw = wv + hh * CSTR;
    const long long R = g * r + h0 + hh;

    // y = W . x over the warp's units; acc[0] row tile warp, acc[1] row
    // tile NRT - 1 - warp
    float acc[2][TP / 8][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nn = 0; nn < TP / 8; ++nn)
        acc[s][nn][0] = acc[s][nn][1] = acc[s][nn][2] = acc[s][nn][3] = 0.f;
#pragma unroll
    for (int u = 0; u <= NRT; ++u) {
      const int rt = unit_rt(u), kt = unit_kt(u);
      if (rt >= nrt) continue;
      const int i0 = 16 * rt + g4, j0 = 16 * kt + 2 * t4;
      const float ci0 = hcs[i0], ci1 = hcs[i0 + 8];
      const float2 cj0 = *reinterpret_cast<const float2*>(hcs + j0);
      const float2 cj1 = *reinterpret_cast<const float2*>(hcs + j0 + 8);
      const float2 dj0 = *reinterpret_cast<const float2*>(hdt + j0);
      const float2 dj1 = *reinterpret_cast<const float2*>(hdt + j0 + 8);
      const uint32_t dp0 = pack(dj0.x, dj0.y), dp1 = pack(dj1.x, dj1.y);
      // x's B fragments first: their ldmatrix latency hides under W
      uint32_t bx[TP / 16][4];
#pragma unroll
      for (int np = 0; np < TP / 16; ++np)
        ldsm_x4_t(bx[np], xs + sw128(16 * kt + (mi & 1) * 8 + mr,
                                     2 * np + (mi >> 1)));
      // the mask is compiled only into the diagonal block's branch
      uint32_t wa[4];
      if (rt == kt) {
        wa[0] = w_pair<true>(cb[u][0], ci0, cj0, dp0, i0, j0);
        wa[1] = w_pair<true>(cb[u][1], ci1, cj0, dp0, i0 + 8, j0);
        wa[2] = w_pair<true>(cb[u][2], ci0, cj1, dp1, i0, j0 + 8);
        wa[3] = w_pair<true>(cb[u][3], ci1, cj1, dp1, i0 + 8, j0 + 8);
      } else {
        wa[0] = w_pair<false>(cb[u][0], ci0, cj0, dp0, i0, j0);
        wa[1] = w_pair<false>(cb[u][1], ci1, cj0, dp0, i0 + 8, j0);
        wa[2] = w_pair<false>(cb[u][2], ci0, cj1, dp1, i0, j0 + 8);
        wa[3] = w_pair<false>(cb[u][3], ci1, cj1, dp1, i0 + 8, j0 + 8);
      }
      // (a branch, not an index: the accumulators stay in registers)
      if (u <= warp) {
#pragma unroll
        for (int np = 0; np < TP / 16; ++np) {
          mma(acc[0][2 * np], wa, bx[np][0], bx[np][1]);
          mma(acc[0][2 * np + 1], wa, bx[np][2], bx[np][3]);
        }
      } else {
#pragma unroll
        for (int np = 0; np < TP / 16; ++np) {
          mma(acc[1][2 * np], wa, bx[np][0], bx[np][1]);
          mma(acc[1][2 * np + 1], wa, bx[np][2], bx[np][3]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int rt = s ? NRT - 1 - warp : warp;
      if (rt < nrt)
        flush(acc[s], stg, 16 * rt, yb + R * a.y_sh + 16 * rt * a.y_sq,
              a.y_sq, q - 16 * rt, p, lane);
    }

    // S = (B * w)^T . x on state rows 16 m .. 16 m + 15 for both of the
    // warp's m = warp, NRT - 1 - warp at once: B^T through ldmatrix.trans,
    // scaled by w per k index and split into hi and lo; all hi products
    // are issued before the lo products into the same accumulators
    float sacc[2][TP / 8][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nn = 0; nn < TP / 8; ++nn)
        sacc[s][nn][0] = sacc[s][nn][1] = sacc[s][nn][2] = sacc[s][nn][3] =
            0.f;
#pragma unroll
    for (int kt = 0; kt < NRT; ++kt) {
      if (kt >= nrt) break;
      uint32_t bx[TP / 16][4], hi[2][4], lo[2][4];
#pragma unroll
      for (int np = 0; np < TP / 16; ++np)
        ldsm_x4_t(bx[np], xs + sw128(16 * kt + (mi & 1) * 8 + mr,
                                     2 * np + (mi >> 1)));
      const int j0 = 16 * kt + 2 * t4;
      const float2 wf0 = *reinterpret_cast<const float2*>(hw + j0);
      const float2 wf1 = *reinterpret_cast<const float2*>(hw + j0 + 8);
      const uint32_t w0 = pack(wf0.x, wf0.y), w1 = pack(wf1.x, wf1.y);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int m = s ? NRT - 1 - warp : warp;
        uint32_t bt[4];
        ldsm_x4_t(bt, sB + sw256(16 * kt + (mi >> 1) * 8 + mr,
                                 2 * m + (mi & 1)));
        split(bt[0], w0, hi[s][0], lo[s][0]);
        split(bt[1], w0, hi[s][1], lo[s][1]);
        split(bt[2], w1, hi[s][2], lo[s][2]);
        split(bt[3], w1, hi[s][3], lo[s][3]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int np = 0; np < TP / 16; ++np) {
          mma(sacc[s][2 * np], hi[s], bx[np][0], bx[np][1]);
          mma(sacc[s][2 * np + 1], hi[s], bx[np][2], bx[np][3]);
        }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int np = 0; np < TP / 16; ++np) {
          mma(sacc[s][2 * np], lo[s], bx[np][0], bx[np][1]);
          mma(sacc[s][2 * np + 1], lo[s], bx[np][2], bx[np][3]);
        }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int m = s ? NRT - 1 - warp : warp;
      if (16 * m < n)
        flush(sacc[s], stg, 16 * m, Sb + R * a.S_sh + 16 * m * a.S_sn,
              a.S_sn, n - 16 * m, p, lane);
    }
  }
}

// what the mma kernel takes, and what its 16-byte copies and stores need:
// aligned pointers; bf16 strides in whole 8-element chunks, float32 ones
// in whole 4-element chunks
bool mma_takes(const SsdArgs& a) {
  return a.mode == 1 && a.q >= 1 && a.q <= TQ && a.n >= 8 && a.n <= TN &&
         a.n % 8 == 0 && a.p >= 8 && a.p <= TP && a.p % 8 == 0 &&
         a.heads_per_block >= 1 && mma_smem(a.heads_per_block) <= 232448;
}

bool mma_aligned(const SsdArgs& a) {
  const void* ptrs[] = {a.x, a.B, a.C, a.y, a.S};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long in[] = {a.x_st, a.x_sq, a.x_sh, a.B_st, a.B_sq,
                          a.B_sg, a.C_st, a.C_sq, a.C_sg};
  for (long long s : in)
    if (s % 8) return false;
  const long long out[] = {a.y_st, a.y_sq, a.y_sh, a.S_st, a.S_sh, a.S_sn};
  for (long long s : out)
    if (s % 4) return false;
  return true;
}

constexpr int kMaxDevices = 64;

cudaError_t launch_mma(const SsdArgs& a, cudaStream_t stream) {
  if (!mma_takes(a)) return cudaErrorInvalidValue;
  if (!mma_aligned(a)) return cudaErrorMisalignedAddress;
  const int bytes = mma_smem(a.heads_per_block);
  // the attribute holds for this function on this device: raise it only
  // when a launch needs more than was allowed before
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load(std::memory_order_acquire) < bytes) {
    err = cudaFuncSetAttribute(
        ssd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[dev].store(bytes, std::memory_order_release);
  }
  const int r = a.R / a.G;
  const int tiles = (r + a.heads_per_block - 1) / a.heads_per_block;
  if (a.G > 65535 || tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(a.T, a.G, tiles);
  ssd_mma<<<grid, MT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_intra_args_size(void) { return static_cast<int>(sizeof(SsdArgs)); }

// kernel: 0 fma_f32, 1 mma_bf16.  dtype: 0 float32, 1 bfloat16 (x, B, C;
// and y, S in `pallas` mode).  mma_bf16 takes bf16 in `model` mode only,
// with 16-byte aligned pointers and strides (cudaErrorMisalignedAddress
// otherwise).  Launches on `stream` on the current device; returns the
// CUDA error (0 = launched).
int ssd_intra_launch(SsdArgs a, int dtype, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0 && dtype == 0) err = launch_typed<float>(a, s);
  if (kernel == 0 && dtype == 1) err = launch_typed<__nv_bfloat16>(a, s);
  if (kernel == 1 && dtype == 1) err = launch_mma(a, s);
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory a block of `kernel` takes.
int ssd_intra_smem_bytes(int kernel, int q, int n, int p, int heads) {
  if (kernel == 0) return static_cast<int>(sizeof(float) * Layout(q, n, p).total);
  if (kernel == 1) return mma_smem(heads);
  return -1;
}

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
