// The Mamba-2 SSD intra-chunk block: the CUDA kernel behind
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
// g): it computes CB once, keeps it in shared memory, and loops over its
// heads.  With mamba2-2.7b's one group that halves the operations of a
// launch (CB is a quarter of the work per head).
//
// Layouts.  Every operand comes with its strides (the last dimension
// contiguous), so the model's views need no copy: x is a slice of the
// convolution output (token stride conv_dim), B and C are [T, q, G, n]
// per group.  The ops layout (B and C per head) is the case G = R.
//
// Design (simple and right first).  256 threads.  Shared memory, float32:
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
// are float32 FMAs on the CUDA cores; mma/wgmma and TMA-staged tiles are
// later work.
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
// at 3.35 TB/s, against 10.9 GFLOP, 11 us at the bf16 tensor-core rate.
// Bytes bound it; this kernel, on the float32 CUDA cores (67 TFLOP/s at
// best), is bound by its operations far above that floor.

#include <cstdint>

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

}  // namespace

extern "C" {

int ssd_intra_args_size(void) { return static_cast<int>(sizeof(SsdArgs)); }

// dtype: 0 float32, 1 bfloat16 (x, B, C; and y, S in `pallas` mode).
// Launches on `stream` on the current device; returns the CUDA error
// (0 = launched).
int ssd_intra_launch(SsdArgs a, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_typed<float>(a, s);
  if (dtype == 1) err = launch_typed<__nv_bfloat16>(a, s);
  return static_cast<int>(err);
}

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
