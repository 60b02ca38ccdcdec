// Decode attention: one query token's GQA attention against a KV cache under
// a per-key validity mask, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, pallas_call at :84) and computes what it
// computes:
//   out[b, 0, h] = sum_j p_j v[b, j, h / G],  p = softmax_j(s_j),
//   s_j = q[b, 0, h] . k[b, j, h / G] / sqrt(hd) where mask[b, j], else -1e30.
// A masked key is scored -1e30 and not zeroed afterwards, so a row with no
// valid key gets the uniform average of its S values, as the TPU kernel
// and the plain version give.  Keys past S do not exist: nothing is padded.
// Softmax and accumulation are float32; the output has the input type.
//
// Design.  One block of 4 warps per (kv head, group of query heads, batch
// row).  The TPU kernel walked S in blocks on its sequential last grid
// axis; here the block's 4 warps take 32-key tiles in turn (warp w takes
// tiles w, w + 4, ...), each warp keeps an online softmax of its NR query
// heads in registers, and the warps' states merge through shared memory at
// the end.  Lane j scores key j of a tile, reading its K row straight from
// device memory, so the row max and sum are warp shuffles; for P.V each
// lane owns hd / 32 output columns and takes p_j from lane j by shuffle,
// with V read along a row by consecutive lanes.
//
// Bound.  Each K and V element is read once and used for G query heads
// (G = 2 at qwen3-0.6b), about one operation per byte: the kernel is
// bounded by the bytes of K and V.  Splitting S over more blocks (one
// block per kv head leaves most SMs idle at small batch) and reading the
// paged pool through the block table, in place of the gather in front of
// it, are the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 32;       // keys of a tile, one per lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD, int NR>
constexpr int smem_bytes() {
  // the query rows, then each warp's (m, l, acc) for the merge
  return (NR * HD + kWarps * NR * (2 + HD)) * 4;
}

template <typename T, int HD, int NR>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ out, int s_len, int heads, int kv_heads,
              float scale) {
  constexpr int kCols = HD / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);         // NR x HD
  float* red_m = qs + NR * HD;                          // kWarps x NR
  float* red_l = red_m + kWarps * NR;                   // kWarps x NR
  float* red_acc = red_l + kWarps * NR;                 // kWarps x NR x HD

  const int group = heads / kv_heads;
  const int kvh = blockIdx.x;
  const int g0 = blockIdx.y * NR;                       // first head of the group
  const int b = blockIdx.z;
  const int rows = min(NR, group - g0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < NR * HD; idx += kWarps * 32) {
    const int i = idx / HD, d = idx % HD;
    qs[idx] = i < rows
        ? load1(q + (static_cast<size_t>(b) * heads + kvh * group + g0 + i) * HD + d)
        : 0.f;
  }
  __syncthreads();

  float m[NR], l[NR], acc[NR][kCols];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(kv_heads) * HD;
  const T* kb = k + static_cast<size_t>(b) * s_len * row_stride + kvh * HD;
  const T* vb = v + static_cast<size_t>(b) * s_len * row_stride + kvh * HD;
  const uint8_t* mb = mask + static_cast<size_t>(b) * s_len;

  for (int k0 = warp * kKeys; k0 < s_len; k0 += kWarps * kKeys) {
    const int j = k0 + lane;
    const bool in = j < s_len;
    float sc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) sc[i] = 0.f;
    if (in) {
      const T* krow = kb + j * row_stride;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = load4(krow + d);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + i * HD + d);
          sc[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        }
      }
    }
    const bool valid = in && mb[j] != 0;
    float p[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float si = valid ? sc[i] * scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(si));
      // masked keys keep exp(-1e30 - m): 1 while the row has no valid key
      p[i] = in ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    const int n = min(kKeys, s_len - k0);
    for (int jj = 0; jj < n; ++jj) {
      const T* vrow = vb + (k0 + jj) * row_stride;
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = load1(vrow + lane + 32 * c);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float pj = __shfl_sync(kFull, p[i], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] += pj * vv[c];
      }
    }
  }

  // merge the warps' online-softmax states
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (lane == 0) {
      red_m[warp * NR + i] = m[i];
      red_l[warp * NR + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red_acc[(warp * NR + i) * HD + lane + 32 * c] = acc[i][c];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * HD; idx += kWarps * 32) {
    const int i = idx / HD, d = idx % HD;
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * NR + i]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(red_m[w * NR + i] - mx);
      lsum += e * red_l[w * NR + i];
      a += e * red_acc[(w * NR + i) * HD + d];
    }
    store1(out + (static_cast<size_t>(b) * heads + kvh * group + g0 + i) * HD + d,
           a / fmaxf(lsum, 1e-20f));
  }
}

template <typename T, int HD, int NR>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int batch, int s_len,
                   int heads, int kv_heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, NR>();   // at most 41 KB (hd 256, NR 8)
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int group = heads / kv_heads;
  const dim3 grid(kv_heads, (group + NR - 1) / NR, batch);
  decode_kernel<T, HD, NR><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), s_len, heads, kv_heads, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int batch, int s_len,
                          int heads, int kv_heads, float scale,
                          cudaStream_t stream) {
  const int group = heads / kv_heads;
  if (group <= 1) return launch<T, HD, 1>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
  if (group <= 2) return launch<T, HD, 2>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
  if (group <= 4) return launch<T, HD, 4>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
  return launch<T, HD, 8>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* mask, void* out, int batch, int s_len,
                        int heads, int kv_heads, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_rows<T, 32>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
    case 64: return dispatch_rows<T, 64>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
    case 128: return dispatch_rows<T, 128>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
    case 256: return dispatch_rows<T, 256>(q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, H, hd), k and v (B, S, KV, hd), out like q, all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); mask (B, S) bool, one byte a key.
// Returns the launch's CUDA error code.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, int batch, int s_len,
                                       int heads, int kv_heads, int hd,
                                       int dtype, float scale, int device,
                                       void* stream) {
  if (heads % kv_heads != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, out, batch, s_len, heads, kv_heads, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
