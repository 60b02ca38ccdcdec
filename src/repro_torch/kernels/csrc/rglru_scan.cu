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
// busy.  Here a block owns a tile of `channels` contiguous channels (16 or
// 32: a warp's loads along R stay coalesced) of one batch row and splits S
// over `segments` groups of those threads: thread (segment w, channel c)
// takes kSteps consecutive steps of each tile of segments x kSteps steps.
// Per tile, one kernel at any S:
//   1. the thread's kSteps values of x, a and the reset were loaded in one
//      round (all loads issued before any FMA); it reduces them to the
//      segment's composite pair, A = prod a_t and X = the segment's scan
//      from h = 0 (a reset's a_t = 0 makes A = 0: nothing crosses it);
//   2. the pairs go to shared memory; after one barrier every thread runs
//      the serial scan over the segments of its channel, h <- X + A h, from
//      the h the last tile left, keeping the h entering its own segment
//      and the h leaving the tile (the carry, in a register);
//   3. the next tile's loads are issued into a second set of registers,
//      then the thread replays its steps from its entering h and stores
//      them, so the loads of tile k + 1 are in flight during tile k's scan,
//      replay and stores.
// The pairs are double-buffered by tile parity, so one barrier a tile is
// enough.  make_plan (mirrored by rglru_scan.py plan) picks the shape:
// 160 blocks of 16 x 8 threads at a recurrentgemma solo prefill (B1 S32
// R2560, one tile of 8 x 4 steps), 320 blocks of 16 x 16 at B2 S512 (four
// tiles of 128 steps).  float32 or bf16 inputs, float32 arithmetic.  The
// scan over segments reassociates the recurrence, as the reference's own
// kernel and plain version (both log-doubling) do.
//
// Bound.  Three values a step (x and a in, h out) and one FMA: the bytes
// bound it (31.5 MB at B 2, S 512, R 2560 in float32, 0.0094 ms at 3.35
// TB/s; 1 MB and 0.00029 ms at B1 S32).  Measured on an NVIDIA H100 80GB
// HBM3 at a 700 W limit (torch.profiler, in turns with the one-thread-a-
// channel kernel this replaces; PERF.md, section 6): B1 S32 with a left
// pad of 3, 0.0017 ms (was 0.0061), one load round trip and the launch,
// 6x the byte bound; B2 S512, 0.0104 ms (was 0.0484) with the inputs in
// L2 and 0.0165 (was 0.0726) with the L2 flushed before each call, about
// 5 MB of loads in flight across the card (16 a thread, 82k threads).
//
// Backward (rglru_scan_backward_launch; no Pallas kernel has one: it
// stands in for the reference's differentiated non-Pallas arm,
// src/repro/kernels/ops.py:136-143).  The adjoint g_t = dh_t + a_{t+1}
// g_{t+1}, with no carry into t where a reset fires at t + 1, is the same
// recurrence run from the end of the sequence over (dh, a shifted by one
// step), so the kernel above runs it with the time axis reversed (kRev):
// the same plan, composites, block scan over segments and replay, and the
// replay stores dx_t = g_t and, fused, da_t = g_t h_{t-1} (0 at a reset
// and at t = 0), h being the forward's saved output.  Five values a step
// (dh, a, h in, dx, da out) and two FMAs: the bytes bound it too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSMs = 132;

struct Plan {
  int channels, segments, steps;
};

// Mirrored by kernels/rglru_scan.py plan(); keep the two in step.
Plan make_plan(int batch, int s_len, int width) {
  Plan p;
  p.channels = batch * ((width + 31) / 32) >= 2 * kSMs ? 32 : 16;
  p.steps = s_len <= 4 * (kMaxThreads / p.channels) ? 4 : 8;
  const int need = (s_len + p.steps - 1) / p.steps;
  p.segments = need < kMaxThreads / p.channels ? need : kMaxThreads / p.channels;
  return p;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One thread's kSteps steps from t0: x and a (a = 0 at a reset); past S or
// past R, x = 0 and a = 1, which leave h as it is.  kRev walks the
// sequence from its end (step t0 + u is time S - 1 - t0 - u) for the
// backward: x is dh_t, a is a_{t+1} (0 where a reset fires at t + 1, and
// at t = S - 1), and hp is what da_t multiplies, h_{t-1} (0 at a reset and
// at t = 0).
template <typename T, int kSteps, bool kRev>
__device__ __forceinline__ void load_steps(const T* __restrict__ x,
                                           const T* __restrict__ a,
                                           const T* __restrict__ h,
                                           const uint8_t* __restrict__ rs,
                                           size_t base, int t0, int s_len,
                                           int width, bool live,
                                           float (&xv)[kSteps],
                                           float (&av)[kSteps],
                                           float (&hp)[kSteps]) {
  bool cut[kSteps], cut_h[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int t = kRev ? s_len - 1 - (t0 + u) : t0 + u;
    const bool in = live && t0 + u < s_len;
    const size_t off = base + static_cast<size_t>(t) * width;
    xv[u] = in ? load1(x + off) : 0.f;
    if (kRev) {
      const bool next = in && t + 1 < s_len;
      av[u] = next ? load1(a + off + width) : (in ? 0.f : 1.f);
      hp[u] = in && t > 0 ? load1(h + off - width) : 0.f;
      cut[u] = rs != nullptr && next && rs[t + 1] != 0;
      cut_h[u] = rs != nullptr && in && rs[t] != 0;
    } else {
      av[u] = in ? load1(a + off) : 1.f;
      hp[u] = 0.f;
      cut[u] = rs != nullptr && t < s_len && rs[t] != 0;
    }
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (cut[u]) av[u] = 0.f;
    if (kRev && cut_h[u]) hp[u] = 0.f;
  }
}

// kRev: the backward, the same scan run from the end of the sequence over
// (dh, a shifted by one), storing dx_t = g_t to out and da_t = g_t h_{t-1}
// to out_da.
template <typename T, int kSteps, bool kRev>
__global__ void __launch_bounds__(kMaxThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
             const T* __restrict__ hin, const uint8_t* __restrict__ reset,
             T* __restrict__ out, T* __restrict__ out_da, int s_len, int width,
             int channels, int segments) {
  // [tile parity][A, X][segment * channels + channel]
  __shared__ float pairs[2][2][kMaxThreads];
  const int c = threadIdx.x % channels;
  const int w = threadIdx.x / channels;
  const int r = blockIdx.x * channels + c;
  const int bb = blockIdx.y;
  const bool live = r < width;
  const size_t base = static_cast<size_t>(bb) * s_len * width + (live ? r : 0);
  const uint8_t* rs = reset == nullptr ? nullptr : reset + static_cast<size_t>(bb) * s_len;
  const int tile = segments * kSteps;
  const int n_tiles = (s_len + tile - 1) / tile;

  float xv[kSteps], av[kSteps], hv[kSteps], xn[kSteps], an[kSteps], hn[kSteps];
  load_steps<T, kSteps, kRev>(x, a, hin, rs, base, w * kSteps, s_len, width,
                              live, xv, av, hv);
  float carry = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * tile + w * kSteps;
    // 1. the segment's composite pair
    float pa = 1.f, px = 0.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      px = fmaf(av[u], px, xv[u]);
      pa *= av[u];
    }
    float* sa = pairs[k & 1][0];
    float* sx = pairs[k & 1][1];
    sa[threadIdx.x] = pa;
    sx[threadIdx.x] = px;
    __syncthreads();
    // 3 (issued early). the next tile's loads
    if (k + 1 < n_tiles) {
      load_steps<T, kSteps, kRev>(x, a, hin, rs, base, t0 + tile, s_len, width,
                                  live, xn, an, hn);
    } else {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) { xn[u] = 0.f; an[u] = 1.f; hn[u] = 0.f; }
    }
    // 2. the h entering this segment, and the carry out of the tile
    float h = carry, h_in = 0.f;
#pragma unroll 4
    for (int j = 0; j < segments; ++j) {
      h_in = j == w ? h : h_in;
      h = fmaf(sa[j * channels + c], h, sx[j * channels + c]);
    }
    carry = h;
    // 3. the replay (kRev: with da fused)
    h = h_in;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      h = fmaf(av[u], h, xv[u]);
      if (live && t0 + u < s_len) {
        const int t = kRev ? s_len - 1 - (t0 + u) : t0 + u;
        const size_t off = base + static_cast<size_t>(t) * width;
        store1(out + off, h);
        if (kRev) store1(out_da + off, h * hv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) { xv[u] = xn[u]; av[u] = an[u]; hv[u] = hn[u]; }
  }
}

template <typename T, bool kRev>
cudaError_t launch(const void* x, const void* a, const void* h,
                   const void* reset, void* out, void* out_da, int batch,
                   int s_len, int width, cudaStream_t stream) {
  const Plan p = make_plan(batch, s_len, width);
  const dim3 grid((width + p.channels - 1) / p.channels, batch);
  const int threads = p.channels * p.segments;
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(a);
  const T* hp = static_cast<const T*>(h);
  const uint8_t* rp = static_cast<const uint8_t*>(reset);
  T* op = static_cast<T*>(out);
  T* dp = static_cast<T*>(out_da);
  if (p.steps == 4) {
    rglru_kernel<T, 4, kRev><<<grid, threads, 0, stream>>>(
        xp, ap, hp, rp, op, dp, s_len, width, p.channels, p.segments);
  } else {
    rglru_kernel<T, 8, kRev><<<grid, threads, 0, stream>>>(
        xp, ap, hp, rp, op, dp, s_len, width, p.channels, p.segments);
  }
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
  if (dtype == 0)
    return launch<float, false>(x, a, nullptr, reset, out, nullptr, batch, s_len, width, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, a, nullptr, reset, out, nullptr, batch, s_len,
                                        width, s);
  return cudaErrorInvalidValue;
}

// The backward of rglru_scan_launch: dh, a and h (the forward's output), dx
// and da (B, S, R) of one type, reset (B, S) bool or null; all contiguous.
// One kernel, the forward's plan, run from the end of the sequence.
extern "C" int rglru_scan_backward_launch(const void* dh, const void* a,
                                          const void* h, const void* reset,
                                          void* dx, void* da, int batch,
                                          int s_len, int width, int dtype,
                                          int device, void* stream) {
  if (batch <= 0 || s_len <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(dh, a, h, reset, dx, da, batch, s_len, width, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(dh, a, h, reset, dx, da, batch, s_len, width, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
