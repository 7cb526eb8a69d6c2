// Latency of one dependent load, measured by a pointer chase: one thread
// follows `next` for `steps` loads, each address the value of the last
// load.  With the chain's lines spread over a footprint that fits the
// SM's L1, the time per load is the L1-hit latency; over one that fits
// the L2 but not the L1, it is the L2-hit latency; with `next` copied
// into shared memory first (chase_shared_launch), it is the shared-memory
// latency.  chip_smoke.py uses the three to put a latency floor under
// the mmu_step kernel, whose accesses are chains of such loads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int32_t* next, int32_t start,
                             int64_t steps, int32_t* out) {
  int32_t i = start;
  for (int64_t s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

// the same chase through shared memory: the warp copies next[0, n) in,
// then thread 0 chases
__global__ void chase_shared_kernel(const int32_t* next, int32_t n,
                                    int32_t start, int64_t steps,
                                    int32_t* out) {
  extern __shared__ int32_t snext[];
  for (int32_t k = threadIdx.x; k < n; k += blockDim.x) snext[k] = next[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t i = start;
  for (int64_t s = 0; s < steps; ++s) i = snext[i];
  *out = i;
}

}  // namespace

extern "C" {

// One thread chases `steps` loads from `start` on `stream`; the last
// index lands in *out.  Returns cudaGetLastError() (0 = launched).
int chase_launch(const void* next, int start, long long steps, void* out,
                 void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), start, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The chase through shared memory: `n` int32 (at most 48 KiB) copied in,
// then `steps` loads from `start`.  Returns cudaGetLastError().
int chase_shared_launch(const void* next, int n, int start, long long steps,
                        void* out, void* stream) {
  chase_shared_kernel<<<1, 32, n * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), n, start, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
