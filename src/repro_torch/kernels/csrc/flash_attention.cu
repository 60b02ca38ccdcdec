// Flash attention for prefill: GQA, causal / local (sliding window) / full,
// with a per-row left pad, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :163) and computes what it
// computes:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the keys j that row i may see: j <= i (causal), i - window < j <= i
// (local) or all (full); j >= pad[b] (the row's left pad); j < Sk.  A row
// that may see no key comes out as zeros.  Softmax and accumulation are
// float32 whatever the input type; the output has the input type.
//
// Design.  One block per (query tile, kv head, batch row).  The G = H / KV
// query heads of a kv head fold into the tile's 64 rows (row r is head
// r / QB of the group at position q0 + r % QB), so a K/V tile loaded once
// serves every head that reads it, as on the TPU.  The TPU walked the key
// tiles as the last, sequential grid axis with m, l and acc in VMEM
// scratch; here a loop inside the block walks them and each warp keeps the
// online-softmax state of its 8 rows in registers:
//   * the Q tile and one 32-key K/V tile sit in shared memory as float32;
//   * lane j of a warp scores key j against the warp's 8 rows, so the row
//     max and row sum are warp shuffles and p never leaves registers;
//   * for P.V each lane owns hd / 32 output columns of the 8 rows and
//     takes p[r][j] from lane j by shuffle.
// Key tiles that no row of the block can see (above the causal diagonal,
// before the window, wholly inside the left pad, past Sk) are never
// loaded: the loop's bounds skip them, the rule of the TPU kernel's
// @pl.when.  K and V are bounds-checked against Sk; nothing is padded.
//
// Bound.  Prefill at qwen3-0.6b widths does 4 * hd flops per live (query
// head, key) pair against 2 bytes per element moved, so it is bounded by
// operations.  This first kernel multiplies in float32 on the CUDA cores
// (no tensor cores: float32 inputs must not drop to TF32, and one code path
// serves both types), so it cannot reach the bf16 tensor-core bound; wgmma
// tiles are the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows of a block
constexpr int kKeys = 32;                      // keys of a tile, one per lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kCausal = 0, kLocal = 1, kAll = 2 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

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

template <int HD>
constexpr int smem_bytes() {
  // Q tile and K tile padded by 4 floats a row (float4 reads without bank
  // conflicts), V tile unpadded (read along a row by consecutive lanes).
  return (kRows * (HD + 4) + kKeys * (HD + 4) + kKeys * HD) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ pad,
             T* __restrict__ out, int sq, int sk, int heads, int kv_heads,
             int qb, int kind, int window, float scale) {
  constexpr int kCols = HD / 32;     // output columns of a lane
  constexpr int kLd = HD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * kLd;
  float* vs = ks + kKeys * kLd;

  const int group = heads / kv_heads;
  const int rows_used = group * qb;
  const int q0 = blockIdx.x * qb;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pad_b = pad ? pad[b] : 0;

  // Q tile: row r = (head g of the group, position q0 + r % qb)
  for (int idx = tid * 4; idx < kRows * HD; idx += kWarps * 32 * 4) {
    const int r = idx / HD, d = idx % HD;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    const int pos = q0 + r % qb;
    if (r < rows_used && pos < sq) {
      const int h = kvh * group + r / qb;
      x = load4(q + ((static_cast<size_t>(b) * sq + pos) * heads + h) * HD + d);
    }
    *reinterpret_cast<float4*>(qs + r * kLd + d) = x;
  }

  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (warp * kRowsPerWarp + i) % qb;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this tile can see
  const int q_last = min(q0 + qb, sq) - 1;
  int k_begin = pad_b;
  if (kind == kLocal) k_begin = max(k_begin, q0 - window + 1);
  k_begin = max(k_begin, 0);
  int k_end = sk;
  if (kind != kAll) k_end = min(k_end, q_last + 1);

  for (int k0 = k_begin - k_begin % kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (and Q is stored)
    for (int idx = tid * 4; idx < kKeys * HD; idx += kWarps * 32 * 4) {
      const int j = idx / HD, d = idx % HD;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + k0 + j) * kv_heads + kvh) * HD + d;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      *reinterpret_cast<float4*>(ks + j * kLd + d) = kx;
      *reinterpret_cast<float4*>(vs + j * HD + d) = vx;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = ks + lane * kLd;
    const float* qrow = qs + warp * kRowsPerWarp * kLd;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + i * kLd + d);
        s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int kp = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool valid = kp < sk && kp >= pad_b;
      if (kind != kAll) valid = valid && kp <= qpos[i];
      if (kind == kLocal) valid = valid && kp > qpos[i] - window;
      const float sc = valid ? s[i] * scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(sc));
      // a masked key weighs zero even where the whole row is masked so far
      p[i] = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * HD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= rows_used || qpos[i] >= sq) continue;
    const int h = kvh * group + r / qb;
    // a row that saw no key has l == 0 and acc == 0: it comes out as zeros
    const float denom = fmaxf(l[i], 1e-20f);
    T* o = out + ((static_cast<size_t>(b) * sq + qpos[i]) * heads + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(o + lane + 32 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad,
                   void* out, int batch, int sq, int sk, int heads,
                   int kv_heads, int kind, int window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();   // above the 48 KB default
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int group = heads / kv_heads;
  const int qb = kRows / group;
  const dim3 grid((sq + qb - 1) / qb, kv_heads, batch);
  flash_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pad),
      static_cast<T*>(out), sq, sk, heads, kv_heads, qb, kind, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* pad, void* out, int batch, int sq, int sk,
                        int heads, int kv_heads, int kind, int window,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out like q, all contiguous and
// of one type (dtype 0: float32, 1: bfloat16); pad (B,) int32 or null.
// kind 0: causal, 1: local, 2: full.  Returns the launch's CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pad,
                                      void* out, int batch, int sq, int sk,
                                      int heads, int kv_heads, int hd,
                                      int dtype, int kind, int window,
                                      float scale, int device, void* stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > kRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, pad, out, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
