// GQA decode attention over a paged KV pool: the CUDA kernel behind
// repro_torch.kernels.paged_attention.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:73
// `paged_attention` (body `_kernel` at :28, pl.pallas_call at :104).
// That kernel prefetches the block table and the context lengths into
// scalar memory, walks a grid (B, K, nb) whose last dimension runs in
// order, and lets the BlockSpec index maps gather physical page
// tables[b, i] for each step, with the online-softmax state in VMEM
// scratch.  Here one block of 128 threads owns one (b, kv head) and its
// G = H / K query rows, loads tables[b, i] and lens[b] itself, and loops
// over the logical tokens [0, lens[b]) in chunks of 64: blocks past the
// context are never read, and pages are gathered where they lie, never
// copied into a contiguous buffer.  Offsets into the pool are 64-bit.
//
// Per chunk: the K and V rows of the chunk are loaded 16 bytes a thread
// (all of a thread's loads issued before any is used) and staged in
// shared memory as float32 (K rows padded by one float, so the score
// loop's threads, on consecutive tokens, hit distinct banks); each thread computes
// scores (g, token); one warp per query row takes the chunk's max, the
// weights p = exp(s - m_new), their sum and the rescale factor; then
// each thread updates its share of the [G, hd] float32 accumulator
// (thread t holds elements t, t + 128, ...).  Tokens at or past lens[b]
// score NEG_INF = -1e30, as in the Pallas body, and the result is
// divided by max(l, 1e-30).
//
// Numerics follow the Pallas body, which keeps p in float32 for the PV
// product (paged_attention.py:62).  The JAX model's decode attention
// rounds its weights to the cache's type first (models/layers.py:285);
// this kernel does not, and the model-level tests state the tolerance
// that covers the difference.
//
// Bound.  Decode reads every K and V row up to lens[b] once: at
// granite-3-2b's decode (B=8, K=8, hd=64, bf16, ~512-576 tokens) that is
// about 8-9.5 MB a layer, 2.5-2.8 us at 3.35 TB/s, with 4 FLOPs per byte
// of arithmetic, so bytes bound it.  B*K = 64 blocks leave half the SMs
// idle and each block walks its context alone; splitting the context
// over blocks (a second reduction pass) is later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr int CHUNK = 64;   // tokens staged per pass (two per lane)
constexpr int GMAX = 8;     // query rows per kv head the kernel holds
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
  return __float2bfloat16(x);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(THREADS) paged_kernel(PagedArgs a) {
  constexpr int NACC = (GMAX * HD + THREADS - 1) / THREADS;
  constexpr int VEC = 16 / sizeof(TKV);        // elements per 16-byte load
  constexpr int VPR = HD / VEC;                // loads per K or V row
  constexpr int RPP = THREADS / VPR;           // rows per pass of the block
  constexpr int PASSES = CHUNK / RPP;
  static_assert(HD % VEC == 0 && THREADS % VPR == 0 && CHUNK % RPP == 0,
                "a chunk must split into whole 16-byte loads");
  __shared__ float qs[GMAX * HD];
  __shared__ float ks[CHUNK][HD + 1];
  __shared__ float vs[CHUNK][HD];
  __shared__ float ps[GMAX][CHUNK];
  __shared__ float m_s[GMAX], l_s[GMAX], corr_s[GMAX];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.K;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c = tid % VPR, r0 = tid / VPR;  // this thread's loads

  const long long qoff = (static_cast<long long>(b) * a.H + kh * G) * HD;
  const TQ* qp = static_cast<const TQ*>(a.q) + qoff;
  for (int e = tid; e < G * HD; e += THREADS) qs[e] = to_f(qp[e]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const TKV* kpool = static_cast<const TKV*>(a.k_pages);
  const TKV* vpool = static_cast<const TKV*>(a.v_pages);
  const int* table = a.tables + static_cast<long long>(b) * a.nb;
  // the reference masks tokens >= lens[b] over nb * page tokens
  const int len = min(a.lens[b], a.nb * a.page);

  for (int base = 0; base < len; base += CHUNK) {
    const int n = min(CHUNK, len - base);
    __syncthreads();  // the last chunk's K, V and p are consumed
    // each thread loads 16-byte vectors: column c of rows r0, r0 + RPP,
    // ...; the PASSES loads of a chunk are independent, so they are in
    // flight together
    uint4 kv[PASSES], vv[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = r0 + p * RPP;
      kv[p] = vv[p] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        const int tok = base + r;
        const long long phys = table[tok / a.page];
        const long long off =
            ((phys * a.page + tok % a.page) * a.K + kh) * HD + c * VEC;
        kv[p] = *reinterpret_cast<const uint4*>(kpool + off);
        vv[p] = *reinterpret_cast<const uint4*>(vpool + off);
      }
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = r0 + p * RPP;
      const TKV* ke = reinterpret_cast<const TKV*>(&kv[p]);
      const TKV* ve = reinterpret_cast<const TKV*>(&vv[p]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r][c * VEC + e] = to_f(ke[e]);
        vs[r][c * VEC + e] = to_f(ve[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * CHUNK; i += THREADS) {
      const int g = i / CHUNK, r = i % CHUNK;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qs[g * HD + d] * ks[r][d];
      ps[g][r] = r < n ? dot * a.scale : NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      const float x0 = ps[g][lane], x1 = ps[g][lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mp = m_s[g];
      const float mn = fmaxf(mp, mx);
      const float p0 = expf(x0 - mn), p1 = expf(x1 - mn);
      ps[g][lane] = p0;
      ps[g][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(mp - mn);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mn;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * THREADS;
      const int g = e / HD, d = e % HD;
      if (g < G) {
        float pv = 0.f;
        for (int r = 0; r < n; ++r) pv += ps[g][r] * vs[r][d];
        acc[i] = acc[i] * corr_s[g] + pv;
      }
    }
  }

  __syncthreads();  // l_s is final
  TQ* op = static_cast<TQ*>(a.o) + qoff;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * THREADS;
    const int g = e / HD;
    if (g < G) op[e] = from_f<TQ>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const PagedArgs& a, int hd, cudaStream_t stream) {
  const dim3 grid(a.K, a.B);
  switch (hd) {
    case 16: paged_kernel<TQ, TKV, 16><<<grid, THREADS, 0, stream>>>(a); break;
    case 32: paged_kernel<TQ, TKV, 32><<<grid, THREADS, 0, stream>>>(a); break;
    case 64: paged_kernel<TQ, TKV, 64><<<grid, THREADS, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_attention_args_size(void) {
  return static_cast<int>(sizeof(PagedArgs));
}

int paged_attention_max_group(void) { return GMAX; }

// q_dtype, kv_dtype: 0 float32, 1 bfloat16; hd in {16, 32, 64}; H / K at
// most paged_attention_max_group().  Launches on `stream` on the current
// device; returns cudaGetLastError() (0 = launched).
int paged_attention_launch(PagedArgs a, int q_dtype, int kv_dtype, int hd,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) err = launch_typed<float, float>(a, hd, s);
  if (q_dtype == 0 && kv_dtype == 1)
    err = launch_typed<float, __nv_bfloat16>(a, hd, s);
  if (q_dtype == 1 && kv_dtype == 0)
    err = launch_typed<__nv_bfloat16, float>(a, hd, s);
  if (q_dtype == 1 && kv_dtype == 1)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(a, hd, s);
  return static_cast<int>(err);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
