// Forward flash attention with GQA, causal and sliding-window masks: the
// CUDA kernel behind repro_torch.kernels.flash_attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:85
// `flash_attention` (body `_kernel` at :26, pl.pallas_call at :104).
// That kernel walks a grid (B, H, q-tile, k-tile) whose last dimension
// runs in order, carrying the running max, denominator and output tile
// in VMEM scratch from one k-tile to the next.  Blocks of a CUDA grid
// run in no order, so here one block owns one (b, h, q-tile) and loops
// over the k-tiles itself; K and V tiles of kv head h / G stream
// through shared memory, and the running state stays in registers.
//
// Design.  One thread per query row (BQ = 64 rows, 64 threads a block);
// the thread keeps its row of q and its float32 output accumulator in
// registers.  Every thread of the block reads the same K or V row of the
// shared tile at once, so each shared load is a broadcast (no bank
// conflicts), four floats wide.  Keys are folded into the online softmax
// CH = 16 at a time: 16 scores, their max, one rescale of the
// accumulator, then the 16 PV updates.  Tiles wholly above the causal
// diagonal or wholly outside the window are never loaded; inside a tile
// the masks (and the ragged edges S % BQ, Sk % BK) are applied per score
// with NEG_INF = -1e30, as the Pallas kernel does, and the result is
// divided by max(l, 1e-30).
//
// Numerics follow the Pallas body: scores, softmax and accumulation in
// float32 (plain FMAs, never TF32 or a tensor core), the scale
// 1/sqrt(hd) applied to q.k in float32.  For bf16 inputs the weight p is
// rounded to bf16 before the PV product, as the model's attention does
// with `w.astype(v.dtype)` (src/repro/models/layers.py:144); the
// denominator sums the unrounded p.
//
// Bound.  At granite-3-2b's prefill (B=8, H=32, K=8, S=512, hd=64, bf16,
// causal) the work is 2*B*H*S^2*hd = 8.6 GFLOP and the bytes of q, k, v
// and o are 42 MB: 12.5 us at 3.35 TB/s against 8.7 us at the 989
// TFLOP/s bf16 tensor-core rate, so the least time is set by the bytes.
// This kernel runs on the CUDA cores (67 TFLOP/s float32 at best, and
// one shared load per four FMAs), so it is bound by operations, far
// above that floor; moving the two products to mma/wgmma with tiles
// staged by TMA is later work.

#include <cstdint>

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

constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per K/V tile in shared memory
constexpr int CH = 16;   // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

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

// the weight p as the PV product sees it: in the inputs' type
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(BQ) flash_kernel(FlashArgs a) {
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
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                static_cast<long long>(qpos) * a.q_ss;
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = qvalid ? to_f(qp[d]) : 0.f;

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;

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
        kx = to_f(kb[static_cast<long long>(kp) * a.k_ss + d]);
        vx = to_f(vb[static_cast<long long>(kp) * a.v_ss + d]);
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
        const float pj = round_p<T>(s[jj]);
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
  const float den = fmaxf(l, 1e-30f);
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh +
          static_cast<long long>(qpos) * a.o_ss;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = from_f<T>(acc[d] / den);
}

template <typename T>
cudaError_t launch_typed(const FlashArgs& a, int hd, cudaStream_t stream) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  switch (hd) {
    case 16: flash_kernel<T, 16><<<grid, BQ, 0, stream>>>(a); break;
    case 32: flash_kernel<T, 32><<<grid, BQ, 0, stream>>>(a); break;
    case 64: flash_kernel<T, 64><<<grid, BQ, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_args_size(void) {
  return static_cast<int>(sizeof(FlashArgs));
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike); hd in {16, 32, 64}.
// Launches on `stream` on the current device; returns cudaGetLastError()
// (0 = launched).
int flash_attention_launch(FlashArgs a, int dtype, int hd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_typed<float>(a, hd, s);
  if (dtype == 1) err = launch_typed<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
