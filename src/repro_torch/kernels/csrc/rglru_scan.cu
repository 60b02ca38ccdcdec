// RG-LRU gated linear recurrence h_t = a_t h_{t-1} + x_t (Griffin /
// RecurrentGemma) on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan_pallas,
// pallas_call at :97) and computes what it computes: over x, a (B, S, R),
// h_0 = 0, a reset at step t sets a_t = 0 (h_t = x_t: no history crosses
// it), h is float32 inside and comes out in x's type.
//
// Design.  The TPU kernel cut S into chunks carried in VMEM and ran a
// log2(chunk) doubling scan inside each, to keep the vector unit's lanes
// busy.  Here one thread owns one (batch row, channel) with h in a register
// and walks S in order: one FMA a step, no padding, any S.  Neighbouring
// threads take neighbouring channels, so every load and store is coalesced
// along R.  The loop runs kUnroll steps at a time and issues all their
// loads first: they do not depend on h, so they are in flight while the
// serial FMA chain runs.  float32 or bf16 inputs, float32 arithmetic.
//
// Bound.  Three values of 4 bytes a step (x and a in, h out) and one FMA:
// the bytes bound it (31.5 MB at B 2, S 512, R 2560 in float32).  With
// B x R threads (2,560-5,120 at recurrentgemma's width) the card holds too
// few loads in flight to reach its memory rate, so it is latency-bound; a
// two-pass chunked scan across blocks is the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const uint8_t* __restrict__ reset, T* __restrict__ out,
             int s_len, int width) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (r >= width) return;
  const size_t base = static_cast<size_t>(bb) * s_len * width + r;
  const uint8_t* rs = reset == nullptr ? nullptr : reset + static_cast<size_t>(bb) * s_len;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= s_len; t += kUnroll) {
    float xv[kUnroll], av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + static_cast<size_t>(t + u) * width;
      xv[u] = load1(x + off);
      av[u] = load1(a + off);
      if (rs != nullptr && rs[t + u]) av[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, xv[u]);
      store1(out + base + static_cast<size_t>(t + u) * width, h);
    }
  }
  for (; t < s_len; ++t) {
    const size_t off = base + static_cast<size_t>(t) * width;
    const float at = (rs != nullptr && rs[t]) ? 0.f : load1(a + off);
    h = fmaf(at, h, load1(x + off));
    store1(out + off, h);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* reset, void* out,
                   int batch, int s_len, int width, cudaStream_t stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const uint8_t*>(reset), static_cast<T*>(out), s_len, width);
  return cudaGetLastError();
}

}  // namespace

// x, a and out (B, S, R) of one type (dtype 0: float32, 1: bfloat16), reset
// (B, S) bool or null; all contiguous.  Returns the launch's CUDA error.
extern "C" int rglru_scan_launch(const void* x, const void* a,
                                 const void* reset, void* out, int batch,
                                 int s_len, int width, int dtype, int device,
                                 void* stream) {
  if (batch <= 0 || s_len <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, reset, out, batch, s_len, width, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, a, reset, out, batch, s_len, width, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
