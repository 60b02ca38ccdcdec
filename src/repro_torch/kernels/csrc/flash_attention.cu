// Flash attention for prefill: GQA, causal / local (sliding window) / full,
// with a per-row left pad, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :163) and computes what it
// computes:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the keys j that row i may see: j <= i (causal), i - window < j <= i
// (local) or all (full); j >= pad[b] (the row's left pad); j < Sk.  Causal
// compares absolute indices from 0, as the TPU kernel does, so Sq and Sk
// may differ.  A masked key weighs exactly 0, and a row that may see no key
// comes out as zeros.  Softmax and accumulation are float32 whatever the
// input type; the output has the input type.
//
// Both bodies fold the G = H / KV query heads of a kv head into a block's
// 64 rows (row r is head r / QB of the group at position q0 + r % QB), so a
// K/V tile loaded once serves every head that reads it, as on the TPU.  The
// TPU walked the key tiles on its last, sequential grid axis with m, l and
// acc in VMEM scratch; here a loop inside the block walks them and the
// online-softmax state stays in registers.  Key tiles that no row of the
// block can see (above the causal diagonal, before the window, wholly
// inside the left pad, past Sk) are never loaded: the loop's bounds skip
// them, the rule of the TPU kernel's @pl.when.  Nothing is padded.
//
// Bound.  Prefill does 4 * hd flops per live (query head, key) pair against
// 2 bytes per element moved: at qwen3-0.6b's B 2, S 512 it is 2.2 GFLOP
// against 6.3 MB, so the bf16 tensor cores (989 TFLOP/s) and the bytes
// (3.35 TB/s) bound it about equally, and the CUDA cores (67 TFLOP/s
// float32) would bound it at 15x that.  Hence two bodies:
//
// * bf16 (every served model): tensor cores.  Each of 4 warps owns 16 rows.
//   S = Q K^T runs as mma.sync.m16n8k16 (bf16 in, float32 accumulate) with
//   Q and K fragments taken from shared memory by ldmatrix.  The online
//   softmax runs on the accumulator fragments in registers (a row's scores
//   of a tile sit in the 4 lanes of a quad: two shuffles reduce them).  P is
//   split in registers into two bf16 parts, hi = bf16(p) and lo =
//   bf16(p - hi), and both become A operands of P V directly (V's B
//   fragments from ldmatrix.trans), so P never touches shared memory and
//   P V carries p to about 16 bits, near the reference's float32 p.  With
//   p rounded to one bf16, qwen3-0.6b's two-layer bf16 prefill logits on
//   the card left the 2e-2 band around the CPU's (1.21 of it, against 0.92
//   with float32 arithmetic); lo costs a second mma per P V fragment.
//   K/V tiles of 32 keys stay bf16 in shared memory, double-buffered with
//   cp.async (zero-filled past Sk), so the next tile's load overlaps this
//   tile's math.  At 32 keys a block takes 52 KB of shared memory and 128
//   registers a thread at hd 128 (254 at hd 256, where the 16 x 256
//   float32 output fragment alone takes 128), so several blocks share an
//   SM; 64-key tiles, or Q's fragments held in registers, measured no
//   faster.  Rows are padded by 16
//   bytes so the 8 rows an ldmatrix phase reads fall in 8 bank groups.
//   Interior tiles (no row masks a key) skip the per-element mask.
// * float32: the CUDA cores.  The reference multiplies in float32 and the
//   2e-5 tolerance rules out TF32, so this body keeps full float32 FMAs:
//   8 rows a warp, lane j scores key j of a 32-key tile out of shared
//   memory, and for P V each lane owns hd / 32 output columns.  It serves
//   the token-identity and band checks only; no served model runs it.
//
// The backward (flash_attention_backward_launch) has no TPU counterpart: it
// gives the gradients of the same function from the forward's output and
// its rows' log-sum-exp.  bf16 takes two pipelined mma.sync passes, dQ then
// dK / dV (design below, at "bf16 backward"); float32 three CUDA-core
// kernels.  Bound: at qwen3-0.6b's training shape (B4 S512 H16/8 hd128
// causal) the bytes bound it at 0.0151 ms on an H100 and the 8.6 GFLOP of
// the function at 0.0087 ms, but the passes execute 7 products (15.1
// GFLOP on the live pairs) at about 150 TFLOP/s, 15 % of the bf16 peak:
// the time goes to the products' fragment loads from shared memory, the
// copies into the ring, the softmax and the two barriers a step
// (scripts/flash_backward_turns.py times each part by ablation).  Not wgmma: its descriptors and TMA could not be tried
// between chip calls without a card here, and the mma.sync passes reach the
// time asked of them.  No atomics: each output element has one writer
// (below), so a run is bit-reproducible.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;                      // query rows of a block

enum Kind { kCausal = 0, kLocal = 1, kAll = 2 };

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

// The keys [k_begin, k_end) that some row of the tile at q0 may see.
__device__ __forceinline__ void key_range(int q0, int qb, int sq, int sk,
                                          int pad_b, int kind, int window,
                                          int& k_begin, int& k_end) {
  const int q_last = min(q0 + qb, sq) - 1;
  k_begin = max(pad_b, 0);
  if (kind == kLocal) k_begin = max(k_begin, q0 - window + 1);
  k_end = sk;
  if (kind != kAll) k_end = min(k_end, q_last + 1);
}

// The queries [q_begin, q_end) that may see some key of the tile [k0, k0 +
// kb): the rule key_range applies from the other side.
__device__ __forceinline__ void query_range(int k0, int kb, int sq, int sk,
                                            int pad_b, int kind, int window,
                                            int& q_begin, int& q_end) {
  const int k_last = min(k0 + kb, sk) - 1;
  q_begin = 0;
  q_end = sq;
  if (k_last < max(k0, pad_b)) {             // every key is pad or past Sk
    q_end = 0;
    return;
  }
  if (kind != kAll) q_begin = max(k0, pad_b);
  if (kind == kLocal) q_end = min(sq, k_last + window);
  q_begin = min(q_begin, q_end);
}

// -- float32: CUDA cores ------------------------------------------------------

namespace f32 {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kKeys = 32;                      // keys of a tile, one per lane

template <int HD>
constexpr int smem_bytes() {
  // Q tile and K tile padded by 4 floats a row (float4 reads without bank
  // conflicts), V tile unpadded (read along a row by consecutive lanes).
  return (kRows * (HD + 4) + kKeys * (HD + 4) + kKeys * HD) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ pad,
             float* __restrict__ out, float* __restrict__ lse, int sq, int sk,
             int heads, int kv_heads, int qb, int kind, int window,
             float scale) {
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
      x = *reinterpret_cast<const float4*>(
          q + ((static_cast<size_t>(b) * sq + pos) * heads + h) * HD + d);
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

  int k_begin, k_end;
  key_range(q0, qb, sq, sk, pad_b, kind, window, k_begin, k_end);

  for (int k0 = k_begin - k_begin % kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (and Q is stored)
    for (int idx = tid * 4; idx < kKeys * HD; idx += kWarps * 32 * 4) {
      const int j = idx / HD, d = idx % HD;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + k0 + j) * kv_heads + kvh) * HD + d;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
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
    float* o = out + ((static_cast<size_t>(b) * sq + qpos[i]) * heads + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[lane + 32 * c] = acc[i][c] / denom;
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * heads + h) * sq + qpos[i]] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad,
                   void* out, float* lse, int batch, int sq, int sk, int heads,
                   int kv_heads, int kind, int window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();   // above the 48 KB default
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int qb = kRows / (heads / kv_heads);
  const dim3 grid((sq + qb - 1) / qb, kv_heads, batch);
  flash_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pad),
      static_cast<float*>(out), lse, sq, sk, heads, kv_heads, qb, kind,
      window, scale);
  return cudaGetLastError();
}

}  // namespace f32

// -- bf16: tensor cores (mma.sync m16n8k16) -----------------------------------

namespace tc {

constexpr int kWarps = 4;                      // 16 rows each
constexpr int kPad = 8;                        // bf16 of padding a smem row

constexpr int kKeys = 32;                      // keys of a K/V tile

template <int HD>
constexpr int smem_bytes() {
  // Q tile, then two stages of K and two of V, rows of HD + kPad bf16
  return (kRows + 4 * kKeys) * (HD + kPad) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled where !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));  // registers only
}

// (x0, x1) as two bf16 pairs: big = bf16(x), small = bf16(x - big)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& big,
                                           uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 r = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(x0 - r.x, x1 - r.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&s);
}

// Fragment layout of mma.m16n8k16 (PTX ISA): lane l holds, of the 16 x 8
// accumulator tile, rows l / 4 (elements 0, 1) and l / 4 + 8 (elements 2,
// 3) at columns 2 (l % 4) and 2 (l % 4) + 1.  Two adjacent score tiles of
// a row are therefore exactly the A fragment of the 16 keys they cover.
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
             int sk, int heads, int kv_heads, int qb, int kind, int window,
             float scale_log2) {
  constexpr int kLd = HD + kPad;               // a smem row, in bf16
  constexpr int kChunks = HD / 8;              // 16-byte pieces of a row
  constexpr int kSt = kKeys / 8;               // score tiles of a warp
  constexpr int kOt = HD / 8;                  // output tiles of a warp
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* ks = qs + kRows * kLd;        // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kKeys * kLd;    // [2][kKeys][kLd]

  const int group = heads / kv_heads;
  const int rows_used = group * qb;
  const int q0 = blockIdx.x * qb;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pad_b = pad ? pad[b] : 0;
  const size_t key_stride = static_cast<size_t>(kv_heads) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * sk * kv_heads + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * sk * kv_heads + kvh) * HD;

  // Q tile: row r = (head r / qb of the group, position q0 + r % qb)
  for (int idx = tid; idx < kRows * kChunks; idx += kWarps * 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int pos = q0 + r % qb;
    const bool live = r < rows_used && pos < sq;
    const __nv_bfloat16* src = live
        ? q + ((static_cast<size_t>(b) * sq + pos) * heads + kvh * group + r / qb) * HD + c * 8
        : q;
    cp_async16(qs + r * kLd + c * 8, src, live);
  }
  cp_async_commit();

  auto load_tile = [&](int t, int stage) {
    const int k0 = t * kKeys;
    for (int idx = tid; idx < kKeys * kChunks; idx += kWarps * 32) {
      const int j = idx / kChunks, c = idx % kChunks;
      const bool live = k0 + j < sk;
      const size_t off = live ? (k0 + j) * key_stride + c * 8 : 0;
      cp_async16(ks + (stage * kKeys + j) * kLd + c * 8, kb + off, live);
      cp_async16(vs + (stage * kKeys + j) * kLd + c * 8, vb + off, live);
    }
  };

  int k_begin, k_end;
  key_range(q0, qb, sq, sk, pad_b, kind, window, k_begin, k_end);
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;

  // this lane's two rows of the warp's 16, and their positions
  const int r_lo = warp * 16 + (lane >> 2);
  const int pos_lo = q0 + r_lo % qb;
  const int pos_hi = q0 + (r_lo + 8) % qb;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_key = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  float o[kOt][4];
#pragma unroll
  for (int d = 0; d < kOt; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;

  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kKeys * kLd;
    const __nv_bfloat16* vt = vs + stage * kKeys * kLd;

    // S = Q K^T for the warp's 16 rows and the tile's keys
    float s[kSt][4];
#pragma unroll
    for (int n = 0; n < kSt; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD; kd += 16) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(qs + a_row * kLd + kd + a_col, a0, a1, a2, a3);
#pragma unroll
      for (int n = 0; n < kSt; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(kt + (n * 8 + b_key) * kLd + kd + b_col, b0, b1, b2, b3);
        mma(s[n], a0, a1, a2, a3, b0, b1);
        mma(s[n + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // mask (edge tiles only), then the online softmax on the fragments;
    // masked keys score -inf: they weigh exactly 0 even while the row has
    // no valid key (m is then -1e30, never -inf, so no NaN arises)
    const int k0 = t * kKeys;
    const bool edge = k0 < pad_b || k0 + kKeys > sk
        || (kind != kAll && k0 + kKeys - 1 > q0)
        || (kind == kLocal && k0 <= q0 + qb - 1 - window);
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int j = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int pos = e < 2 ? pos_lo : pos_hi;
          bool ok = j < sk && j >= pad_b;
          if (kind != kAll) ok = ok && j <= pos;
          if (kind == kLocal) ok = ok && j > pos - window;
          x = ok ? x : -INFINITY;
        }
        s[n][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, o2));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t pa[kSt][2], pb[kSt][2];           // P = pa + pb: (row lo, row hi)
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      const float p0 = exp2f(s[n][0] - mn_lo), p1 = exp2f(s[n][1] - mn_lo);
      const float p2 = exp2f(s[n][2] - mn_hi), p3 = exp2f(s[n][3] - mn_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      split_bf16(p0, p1, pa[n][0], pb[n][0]);
      split_bf16(p2, p3, pa[n][1], pb[n][1]);
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      sum_lo += __shfl_xor_sync(kFull, sum_lo, o2);
      sum_hi += __shfl_xor_sync(kFull, sum_hi, o2);
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int d = 0; d < kOt; ++d) {
      o[d][0] *= al_lo;
      o[d][1] *= al_lo;
      o[d][2] *= al_hi;
      o[d][3] *= al_hi;
    }

    // O += P V: V's fragments by ldmatrix.trans, each serving both parts
    // of P (the mmas on one accumulator two apart)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a0 = pa[2 * kk][0], a1 = pa[2 * kk][1];
      const uint32_t a2 = pa[2 * kk + 1][0], a3 = pa[2 * kk + 1][1];
      const uint32_t c0 = pb[2 * kk][0], c1 = pb[2 * kk][1];
      const uint32_t c2 = pb[2 * kk + 1][0], c3 = pb[2 * kk + 1][1];
#pragma unroll
      for (int d = 0; d < kOt; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(vt + (kk * 16 + v_key) * kLd + d * 8 + v_col,
                          b0, b1, b2, b3);
        mma(o[d], a0, a1, a2, a3, b0, b1);
        mma(o[d + 1], a0, a1, a2, a3, b2, b3);
        mma(o[d], c0, c1, c2, c3, b0, b1);
        mma(o[d + 1], c0, c1, c2, c3, b2, b3);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // Q's copy, where no tile was loaded
  __syncthreads();

  // a row that saw no key has l == 0 and o == 0: it comes out as zeros.
  // The warp stages its 16 output rows in its own 16 rows of the Q tile
  // (no other warp reads them), then stores them 16 bytes a lane.
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  // the rows' log-sum-exp of the scaled scores, natural log: m and l are
  // in base 2; +inf where the row saw no key (its P is then exactly 0)
  if (lse != nullptr && (lane & 3) == 0) {
    const int r_hi = r_lo + 8;
    if (r_lo < rows_used && pos_lo < sq)
      lse[(static_cast<size_t>(b) * heads + kvh * group + r_lo / qb) * sq + pos_lo] =
          l_lo > 0.f ? (m_lo + log2f(l_lo)) * kLn2 : INFINITY;
    if (r_hi < rows_used && pos_hi < sq)
      lse[(static_cast<size_t>(b) * heads + kvh * group + r_hi / qb) * sq + pos_hi] =
          l_hi > 0.f ? (m_hi + log2f(l_hi)) * kLn2 : INFINITY;
  }
  __nv_bfloat16* stage_rows = qs + warp * 16 * kLd;
#pragma unroll
  for (int d = 0; d < kOt; ++d) {
    const int col = d * 8 + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(stage_rows + (lane >> 2) * kLd + col) =
        __floats2bfloat162_rn(o[d][0] * inv_lo, o[d][1] * inv_lo);
    *reinterpret_cast<__nv_bfloat162*>(stage_rows + ((lane >> 2) + 8) * kLd + col) =
        __floats2bfloat162_rn(o[d][2] * inv_hi, o[d][3] * inv_hi);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int rr = idx / kChunks, c = idx % kChunks;
    const int r = warp * 16 + rr;
    const int pos = q0 + r % qb;
    if (r >= rows_used || pos >= sq) continue;
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * sq + pos) * heads + kvh * group + r / qb) * HD + c * 8) =
        *reinterpret_cast<const uint4*>(stage_rows + rr * kLd + c * 8);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad,
                   void* out, float* lse, int batch, int sq, int sk, int heads,
                   int kv_heads, int kind, int window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();   // above the 48 KB default
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int qb = kRows / (heads / kv_heads);
  const dim3 grid((sq + qb - 1) / qb, kv_heads, batch);
  flash_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pad),
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, heads, kv_heads, qb, kind,
      window, scale * kLog2e);   // softmax in base 2
  return cudaGetLastError();
}

// -- bf16 backward: tensor cores, two pipelined passes ----------------------
//
// Two launches, in this order:
//   dq_kernel:  D = rowsum(dO o O) of the block's rows (written to delta for
//               the second pass), then dQ, walking the key tiles the
//               forward walks;
//   dkv_kernel: dK and dV, walking the (head, query tile) steps that see
//               the block's keys.
// Each block has 8 warps and streams its tiles through a cp.async ring (two
// stages in dq, three in dkv up to hd 128): the copy of a later step is in
// flight while the current one is multiplied.  A step runs in two phases
// split by one barrier.  Phase 1: each warp computes S and dP for a 16-row
// slab times half the step's columns, forms P and dS = P (dP - D) on the
// fragments and stores dS (and P^T in dkv) to shared memory as bf16.
// Phase 2: each warp accumulates its share of the outputs over the whole
// step, its A operand read back from shared memory (dq: 16 rows x hd / 2;
// dkv: one product, dV or dK, for 32 keys x hd / 2).  So S and dP are
// computed once a tile pair in each pass: 7 products where the function
// needs 5, the least two passes take without atomics, and at hd 256 one
// block owns every column of its outputs.  dkv keeps its K and V rows as A
// fragments in registers up to hd 128; dq runs two blocks an SM there.
//
// Blocks go heaviest first: the tile index is the grid's slowest
// axis, and causal or local dq tiles run from the last query tile down
// (each sees more keys than the one before), dkv tiles from the first key
// tile up (each is seen by more queries than the one after).  Where one
// block a work item would leave most SMs idle (one kv head, short
// sequences: gemma3's local layers give 18 dkv items), a cluster of up to 8
// blocks splits an item's steps and sums its partial outputs through
// distributed shared memory, in rank order.
//
// No two blocks write one element: dK and dV sum the group's heads in
// registers, dQ has its own pass, and a cluster's partials are summed by one
// block each in a fixed order.  No atomics, and the result does not depend
// on the order blocks run in (a resumed training run equals an uninterrupted
// one bit for bit through this).

constexpr int kBwdWarps = 8;                   // 256 threads a block
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kKeysKV = 64;                    // keys of a dK/dV block
constexpr int kQueries = 64;                   // queries of a dK/dV step
constexpr int kKeysQ = 64;                     // keys of a dQ step
constexpr int kSLd = 64 + kPad;                // a row of P^T / dS tiles

// stages of the dK/dV ring: three where they fit beside one block's K, V,
// P^T and dS^T (at hd 256 two take 222 KB)
template <int HD>
__host__ __device__ constexpr int dkv_stages() { return HD <= 128 ? 3 : 2; }

template <int HD>
constexpr int dkv_smem_bytes() {
  // K and V tiles; the stages of (Q, dO) tiles and of the steps' lse and D;
  // P^T and dS^T
  return (2 * kKeysKV + 2 * dkv_stages<HD>() * kQueries) * (HD + kPad) * 2
         + 2 * dkv_stages<HD>() * kQueries * 4 + 2 * kKeysKV * kSLd * 2;
}

template <int HD>
constexpr int dq_smem_bytes() {
  // Q and dO tiles of the block's rows; two stages of (K, V) tiles (O takes
  // the second K stage until D is formed); dS; the rows' lse and D
  return (2 * kRows + 2 * 2 * kKeysQ) * (HD + kPad) * 2 + kRows * kSLd * 2
         + 2 * kRows * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x in one MUFU op (subnormal results flush to 0: a weight under 2^-126
// against a row sum of at least 1); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes global -> shared, asynchronous; zero-filled where !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 4 : 0));
}

// dQ (and D) of one block of the forward's rows: row r = head r / qb of the
// group at position q0 + r % qb.  Per 64-key step, warp w computes S = Q K^T
// and dP = dO V^T for rows 16 (w % 4) .. + 16 and keys 32 (w / 4) .. + 32,
// stores dS = P (dP - D) to shared memory, and after the barrier adds dS K
// to its rows' columns HD / 2 (w / 4) .. + HD / 2 of dQ (times scale last).
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, HD <= 128 ? 2 : 1)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          const int* __restrict__ pad, __nv_bfloat16* __restrict__ dq,
          int batch, int sq, int sk, int heads, int kv_heads, int qb, int kind,
          int window, float scale, float scale_log2, int csize) {
  constexpr int kLd = HD + kPad;
  constexpr int kChunks = HD / 8;
  constexpr int kHalf = HD / 2;                // dQ columns of a warp
  constexpr int kN = kKeysQ / 2 / 8;           // score tiles of a warp
  constexpr int kOt = kHalf / 8;               // dQ tiles of a warp
  constexpr int kKd = HD / 16;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* dos = qs + kRows * kLd;
  __nv_bfloat16* ks = dos + kRows * kLd;       // [2][kKeysQ][kLd]
  __nv_bfloat16* vs = ks + 2 * kKeysQ * kLd;   // [2][kKeysQ][kLd]
  __nv_bfloat16* dss = vs + 2 * kKeysQ * kLd;  // [kRows][kSLd]
  float* lse_s = reinterpret_cast<float*>(dss + kRows * kSLd);
  float* d_s = lse_s + kRows;

  const int group = heads / kv_heads;
  const int rows_used = group * qb;
  const int blk = blockIdx.x / csize;          // the cluster's work item
  const int crank = blockIdx.x % csize;        // this block's rank in it
  const int lanes = kv_heads * batch;          // work items of one tile index
  const int kvh = blk % kv_heads;
  const int b = (blk % lanes) / kv_heads;
  const int rank = blk / lanes;
  const int tile = kind == kAll
      ? rank : static_cast<int>(gridDim.x) / csize / lanes - 1 - rank;
  const int q0 = tile * qb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slab = warp & 3;                   // rows 16 slab .. + 16
  const int half = warp >> 2;                  // keys (phase 1), columns (2)
  const int pad_b = pad ? pad[b] : 0;
  const size_t key_stride = static_cast<size_t>(kv_heads) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * sk * kv_heads + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * sk * kv_heads + kvh) * HD;

  auto row_offset = [&](int r) {
    return ((static_cast<size_t>(b) * sq + q0 + r % qb) * heads + kvh * group + r / qb) * HD;
  };
  // Q and dO of the rows; O into the second K stage until D is formed; the
  // rows' lse (zero past the live rows)
  __nv_bfloat16* os = ks + kKeysQ * kLd;
  for (int idx = tid; idx < kRows * kChunks; idx += kBwdThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool live = r < rows_used && q0 + r % qb < sq;
    const size_t off = live ? row_offset(r) + c * 8 : 0;
    cp_async16(qs + r * kLd + c * 8, q + off, live);
    cp_async16(dos + r * kLd + c * 8, dout + off, live);
    cp_async16(os + r * kLd + c * 8, o + off, live);
  }
  auto lse_row = [&](int r) {
    return (static_cast<size_t>(b) * heads + kvh * group + r / qb) * sq + q0 + r % qb;
  };
  if (tid < kRows) {
    const bool live = tid < rows_used && q0 + tid % qb < sq;
    cp_async4(lse_s + tid, lse + (live ? lse_row(tid) : 0), live);
  }
  cp_async_commit();

  // this thread's 16-byte pieces of a (K, V) tile: keys my_key + kPass p,
  // elements my_col ..
  constexpr int kPass = kBwdThreads / kChunks;
  const int my_key = tid / kChunks, my_col = tid % kChunks * 8;
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * kKeysQ + my_key;
    const int at = (stage * kKeysQ + my_key) * kLd + my_col;
#pragma unroll
    for (int p = 0; p < kKeysQ / kPass; ++p) {
      const bool live = k0 + p * kPass < sk;
      const size_t off = live ? (k0 + p * kPass) * key_stride + my_col : 0;
      cp_async16(ks + at + p * kPass * kLd, kb + off, live);
      cp_async16(vs + at + p * kPass * kLd, vb + off, live);
    }
  };

  // the key tiles the rows see; the block takes every csize-th of them from
  // its rank on
  int k_begin, k_end;
  key_range(q0, qb, sq, sk, pad_b, kind, window, k_begin, k_end);
  const int t_begin = k_begin / kKeysQ;
  const int t_all = k_end > k_begin ? (k_end + kKeysQ - 1) / kKeysQ - t_begin : 0;
  const int n_mine = t_all > crank ? (t_all - crank + csize - 1) / csize : 0;
  auto tile_of = [&](int i) { return t_begin + crank + i * csize; };
  if (n_mine > 0) load_tile(tile_of(0), 0);
  cp_async_commit();

  // this lane's rows (fragment rows lane / 4 and + 8 of the slab)
  const int r_lo = slab * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int pos_lo = q0 + r_lo % qb;
  const int pos_hi = q0 + r_hi % qb;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int t_col = (lane >> 4) * 8;
  const int col0 = half * kHalf;

  cp_async_wait<0>();
  __syncthreads();
  // D = rowsum(dO o O) of the rows from shared memory, four threads a row;
  // into delta for the dK/dV pass.  lse in base 2, +inf past the live rows.
  {
    constexpr int kPer = HD / 32;              // 16-byte pieces a thread
    const int r = tid >> 2, quarter = tid & 3;
    const bool live = r < rows_used && q0 + r % qb < sq;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int at = r * kLd + (quarter * kPer + c) * 8;
      const uint4 av = *reinterpret_cast<const uint4*>(os + at);
      const uint4 gv = *reinterpret_cast<const uint4*>(dos + at);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&av);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 xf = __bfloat1622float2(x[w]), yf = __bfloat1622float2(y[w]);
        sum += xf.x * yf.x + xf.y * yf.y;
      }
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (quarter == 0) {
      d_s[r] = sum;
      lse_s[r] = live ? lse_s[r] * kLog2e : INFINITY;
      if (live && crank == 0) delta[lse_row(r)] = sum;
    }
  }
  __syncthreads();   // D and lse are stored; O's stage is free for the ring
  const float lse_lo = lse_s[r_lo], lse_hi = lse_s[r_hi];
  const float d_lo = d_s[r_lo], d_hi = d_s[r_hi];

  float acc[kOt][4];
#pragma unroll
  for (int d = 0; d < kOt; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int stage = i & 1;
    if (i > 0) {
      cp_async_wait<0>();
      __syncthreads();   // step i landed; step i - 1 is done with the other stage and dS
    }
    if (i + 1 < n_mine) load_tile(tile_of(i + 1), stage ^ 1);
    cp_async_commit();
    const __nv_bfloat16* kt = ks + stage * kKeysQ * kLd;
    const __nv_bfloat16* vt = vs + stage * kKeysQ * kLd;
    const int k0 = tile_of(i) * kKeysQ;

    // phase 1: S and dP of the slab's rows against keys 32 half .. + 32
    float s[kN][4], dp[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kKd; ++kd) {
      uint32_t a0, a1, a2, a3, e0, e1, e2, e3;
      const int at = (slab * 16 + a_row) * kLd + kd * 16 + a_col;
      ldmatrix_x4(qs + at, a0, a1, a2, a3);
      ldmatrix_x4(dos + at, e0, e1, e2, e3);
#pragma unroll
      for (int n = 0; n < kN; n += 2) {
        const int bt = (half * (kKeysQ / 2) + n * 8 + b_row) * kLd + kd * 16 + b_col;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(kt + bt, b0, b1, b2, b3);
        mma(s[n], a0, a1, a2, a3, b0, b1);
        mma(s[n + 1], a0, a1, a2, a3, b2, b3);
        ldmatrix_x4(vt + bt, b0, b1, b2, b3);
        mma(dp[n], e0, e1, e2, e3, b0, b1);
        mma(dp[n + 1], e0, e1, e2, e3, b2, b3);
      }
    }
    const bool edge = k0 < pad_b || k0 + kKeysQ > sk
        || (kind != kAll && k0 + kKeysQ - 1 > q0)
        || (kind == kLocal && k0 <= q0 + qb - 1 - window);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int jl = half * (kKeysQ / 2) + n * 8 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = e < 2 ? pos_lo : pos_hi;
        bool ok = true;
        if (edge) {
          const int j = k0 + jl + (e & 1);
          ok = j < sk && j >= pad_b;
          if (kind != kAll) ok = ok && j <= pos;
          if (kind == kLocal) ok = ok && j > pos - window;
        }
        const float p = ok ? fast_exp2(s[n][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? d_lo : d_hi));
      }
      *reinterpret_cast<uint32_t*>(dss + r_lo * kSLd + jl) = pack_bf16(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(dss + r_hi * kSLd + jl) = pack_bf16(s[n][2], s[n][3]);
    }
    __syncthreads();   // dS of the whole step is stored

    // phase 2: dQ[slab rows, col0 ..] += dS K over the step's 64 keys
#pragma unroll
    for (int kk = 0; kk < kKeysQ / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(dss + (slab * 16 + a_row) * kSLd + kk * 16 + a_col, a0, a1, a2, a3);
#pragma unroll
      for (int d = 0; d < kOt; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(kt + (kk * 16 + t_row) * kLd + col0 + d * 8 + t_col,
                          b0, b1, b2, b3);
        mma(acc[d], a0, a1, a2, a3, b0, b1);
        mma(acc[d + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
  cp_async_wait<0>();

  if (csize == 1) {
#pragma unroll
    for (int d = 0; d < kOt; ++d) {
      const int col = col0 + d * 8 + 2 * (lane & 3);
      if (r_lo < rows_used && pos_lo < sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + row_offset(r_lo) + col) =
            __floats2bfloat162_rn(acc[d][0] * scale, acc[d][1] * scale);
      if (r_hi < rows_used && pos_hi < sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + row_offset(r_hi) + col) =
            __floats2bfloat162_rn(acc[d][2] * scale, acc[d][3] * scale);
    }
    return;
  }
  // a cluster: each block leaves its partial dQ (float32, [kRows][HD]) in
  // the K/V stages, then block c sums rows kRows c / csize .. in rank order
  __syncthreads();
  float* part = reinterpret_cast<float*>(ks);
#pragma unroll
  for (int d = 0; d < kOt; ++d) {
    const int col = col0 + d * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(part + r_lo * HD + col) = make_float2(acc[d][0], acc[d][1]);
    *reinterpret_cast<float2*>(part + r_hi * HD + col) = make_float2(acc[d][2], acc[d][3]);
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rows_per = kRows / csize;
  for (int idx = tid; idx < rows_per * (HD / 2); idx += kBwdThreads) {
    const int r = crank * rows_per + idx / (HD / 2);
    const int c = 2 * (idx % (HD / 2));
    if (r >= rows_used || q0 + r % qb >= sq) continue;
    float2 sum = make_float2(0.f, 0.f);
    for (int c_rank = 0; c_rank < csize; ++c_rank) {
      const float2 x = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(part, c_rank) + r * HD + c);
      sum.x += x.x;
      sum.y += x.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dq + row_offset(r) + c) =
        __floats2bfloat162_rn(sum.x * scale, sum.y * scale);
  }
  cluster.sync();    // no block leaves while another reads its partial
}

// dK and dV of one (batch row, kv head, 64-key tile).  The block walks the
// steps (head g of the group, 64-query tile t) that see a key of the tile,
// with the tile's keys as rows (the transposed products).  Per step, warp w
// computes S^T = K Q^T and dP^T = V dO^T for keys 16 (w % 4) .. + 16 and
// queries 32 (w / 4) .. + 32, P^T = exp2(S^T scale_log2 - lse2) and dS^T =
// P^T (dP^T - D), and stores both to shared memory; after the barrier
// warps 0-3 add P^T dO to dV and warps 4-7 dS^T Q to dK (times scale last),
// each for keys 32 (w / 2 % 2) .. + 32 and columns HD / 2 (w % 2) .. + HD /
// 2 (one product a warp: its A fragments serve twice the mmas).
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ pad, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int batch, int sq, int sk,
           int heads, int kv_heads, int kind, int window, float scale,
           float scale_log2, int csize) {
  constexpr int kLd = HD + kPad;
  constexpr int kChunks = HD / 8;
  constexpr int kHalf = HD / 2;
  constexpr int kN = kQueries / 2 / 8;         // score tiles of a warp
  constexpr int kOt = kHalf / 8;               // dK / dV tiles of a warp
  constexpr int kKd = HD / 16;
  constexpr bool kRegs = HD <= 128;      // A fragments kept in registers
  constexpr int kStages = dkv_stages<HD>();
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* vs = ks + kKeysKV * kLd;
  __nv_bfloat16* qs = vs + kKeysKV * kLd;      // [kStages][kQueries][kLd]
  __nv_bfloat16* dos = qs + kStages * kQueries * kLd;
  __nv_bfloat16* ps = dos + kStages * kQueries * kLd;  // [kKeysKV][kSLd]
  __nv_bfloat16* dss = ps + kKeysKV * kSLd;
  float* lse_s = reinterpret_cast<float*>(dss + kKeysKV * kSLd);  // [kStages][kQueries]
  float* d_s = lse_s + kStages * kQueries;

  const int group = heads / kv_heads;
  const int blk = blockIdx.x / csize;          // the cluster's work item
  const int crank = blockIdx.x % csize;        // this block's rank in it
  const int lanes = kv_heads * batch;          // work items of one tile index
  const int kvh = blk % kv_heads;
  const int b = (blk % lanes) / kv_heads;
  const int k0 = (blk / lanes) * kKeysKV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slab = warp & 3;                   // keys 16 slab .. + 16
  const int half = warp >> 2;                  // queries (phase 1), columns (2)
  const int pad_b = pad ? pad[b] : 0;

  for (int idx = tid; idx < kKeysKV * kChunks; idx += kBwdThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const bool live = k0 + j < sk;
    const size_t off = live
        ? ((static_cast<size_t>(b) * sk + k0 + j) * kv_heads + kvh) * HD + c * 8 : 0;
    cp_async16(ks + j * kLd + c * 8, k + off, live);
    cp_async16(vs + j * kLd + c * 8, v + off, live);
  }
  cp_async_commit();

  int q_begin, q_end;
  query_range(k0, kKeysKV, sq, sk, pad_b, kind, window, q_begin, q_end);
  const int t_begin = q_begin / kQueries;
  const int n_t = q_end > q_begin ? (q_end + kQueries - 1) / kQueries - t_begin : 0;
  const int n_steps = group * n_t;
  // the block takes every csize-th step from its rank on
  const int n_mine = n_steps > crank ? (n_steps - crank + csize - 1) / csize : 0;

  // step s: head kvh * group + s / n_t, queries from (t_begin + s % n_t) * 64
  // this thread's 16-byte pieces of a (Q, dO) tile: rows my_row + kPass p,
  // elements my_col ..
  constexpr int kPass = kBwdThreads / kChunks;
  const int my_row = tid / kChunks, my_col = tid % kChunks * 8;
  const size_t row_stride = static_cast<size_t>(heads) * HD;
  auto load_step = [&](int step, int stage) {
    const int h = kvh * group + step / n_t;
    const int q0 = (t_begin + step % n_t) * kQueries;
    const size_t base = ((static_cast<size_t>(b) * sq + q0 + my_row) * heads + h) * HD + my_col;
    const int at = (stage * kQueries + my_row) * kLd + my_col;
#pragma unroll
    for (int p = 0; p < kQueries / kPass; ++p) {
      const bool live = q0 + my_row + p * kPass < sq;
      const size_t off = live ? base + p * kPass * row_stride : 0;
      cp_async16(qs + at + p * kPass * kLd, q + off, live);
      cp_async16(dos + at + p * kPass * kLd, dout + off, live);
    }
    if (tid < 2 * kQueries) {
      const int i = tid % kQueries;
      const bool live = q0 + i < sq;
      const size_t row = live ? (static_cast<size_t>(b) * heads + h) * sq + q0 + i : 0;
      if (tid < kQueries) cp_async4(lse_s + stage * kQueries + i, lse + row, live);
      else cp_async4(d_s + stage * kQueries + i, delta + row, live);
    }
  };
  // the ring's first kStages - 1 steps, a commit group each
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) load_step(crank + i * csize, i);
    cp_async_commit();
  }

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int t_col = (lane >> 4) * 8;
  const int jr_lo = slab * 16 + (lane >> 2);   // this lane's keys in phase 1
  const int jr_hi = jr_lo + 8;
  const int j_lo = k0 + jr_lo;
  const int j_hi = k0 + jr_hi;

  cp_async_wait<kStages - 2>();                // K, V and step 0 landed
  __syncthreads();
  uint32_t kf[kRegs ? kKd : 1][4], vf[kRegs ? kKd : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kd = 0; kd < kKd; ++kd) {
      const int at = (slab * 16 + a_row) * kLd + kd * 16 + a_col;
      ldmatrix_x4(ks + at, kf[kd][0], kf[kd][1], kf[kd][2], kf[kd][3]);
      ldmatrix_x4(vs + at, vf[kd][0], vf[kd][1], vf[kd][2], vf[kd][3]);
    }
  }

  // phase 2's share: product prod (0: dV, 1: dK) for keys krow0 .. + 32
  // and columns col0 .. + HD / 2
  const int prod = warp >> 2;
  const int krow0 = ((warp >> 1) & 1) * 32;
  const int col0 = (warp & 1) * kHalf;
  float acc[2][kOt][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int d = 0; d < kOt; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][d][e] = 0.f;

  int stage = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int step = crank + i * csize;
    if (i > 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // step i landed; step i - 1 is done with its stage, P^T, dS^T
    }
    // refill the stage step i - 1 used with step i + kStages - 1
    const int refill = stage == 0 ? kStages - 1 : stage - 1;
    if (i + kStages - 1 < n_mine) load_step(step + (kStages - 1) * csize, refill);
    cp_async_commit();
    const __nv_bfloat16* qt = qs + stage * kQueries * kLd;
    const __nv_bfloat16* gt = dos + stage * kQueries * kLd;
    const float* lse_t = lse_s + stage * kQueries;
    const float* d_t = d_s + stage * kQueries;
    const int q0 = (t_begin + step % n_t) * kQueries;

    // phase 1: S^T and dP^T of the slab's keys against queries 32 half .. + 32
    float st[kN][4], dpt[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kKd; ++kd) {
      uint32_t a0, a1, a2, a3, e0, e1, e2, e3;
      if constexpr (kRegs) {
        a0 = kf[kd][0]; a1 = kf[kd][1]; a2 = kf[kd][2]; a3 = kf[kd][3];
        e0 = vf[kd][0]; e1 = vf[kd][1]; e2 = vf[kd][2]; e3 = vf[kd][3];
      } else {
        const int at = (slab * 16 + a_row) * kLd + kd * 16 + a_col;
        ldmatrix_x4(ks + at, a0, a1, a2, a3);
        ldmatrix_x4(vs + at, e0, e1, e2, e3);
      }
#pragma unroll
      for (int n = 0; n < kN; n += 2) {
        const int bt = (half * (kQueries / 2) + n * 8 + b_row) * kLd + kd * 16 + b_col;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(qt + bt, b0, b1, b2, b3);
        mma(st[n], a0, a1, a2, a3, b0, b1);
        mma(st[n + 1], a0, a1, a2, a3, b2, b3);
        ldmatrix_x4(gt + bt, b0, b1, b2, b3);
        mma(dpt[n], e0, e1, e2, e3, b0, b1);
        mma(dpt[n + 1], e0, e1, e2, e3, b2, b3);
      }
    }

    // P^T and dS^T; element e of tile n: key e < 2 ? j_lo : j_hi, query q0
    // + 32 half + 8 n + 2 (lane % 4) + e % 2.  A masked pair weighs exactly 0.
    const bool edge = q0 + kQueries > sq || k0 + kKeysKV > sk || k0 < pad_b
        || (kind != kAll && k0 + kKeysKV - 1 > q0)
        || (kind == kLocal && k0 <= q0 + kQueries - 1 - window);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int il = half * (kQueries / 2) + n * 8 + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + il);
      const float2 dd = *reinterpret_cast<const float2*>(d_t + il);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = il + (e & 1);
        bool ok = true;
        if (edge) {
          const int i = q0 + li;
          const int j = e < 2 ? j_lo : j_hi;
          ok = i < sq && j < sk && j >= pad_b;
          if (kind != kAll) ok = ok && j <= i;
          if (kind == kLocal) ok = ok && j > i - window;
        }
        const float p = ok ? fast_exp2(st[n][e] * scale_log2 - (e & 1 ? l2.y : l2.x) * kLog2e) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - (e & 1 ? dd.y : dd.x));
      }
      *reinterpret_cast<uint32_t*>(ps + jr_lo * kSLd + il) = pack_bf16(st[n][0], st[n][1]);
      *reinterpret_cast<uint32_t*>(ps + jr_hi * kSLd + il) = pack_bf16(st[n][2], st[n][3]);
      *reinterpret_cast<uint32_t*>(dss + jr_lo * kSLd + il) = pack_bf16(dpt[n][0], dpt[n][1]);
      *reinterpret_cast<uint32_t*>(dss + jr_hi * kSLd + il) = pack_bf16(dpt[n][2], dpt[n][3]);
    }
    __syncthreads();   // P^T and dS^T of the whole step are stored

    // phase 2: this warp's product (dV += P^T dO or dK += dS^T Q) for its
    // 32 keys and HD / 2 columns, over the step's 64 queries
    const __nv_bfloat16* a_src = prod ? dss : ps;
    const __nv_bfloat16* b_src = prod ? qt : gt;
#pragma unroll
    for (int kk = 0; kk < kQueries / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        ldmatrix_x4(a_src + (krow0 + rt * 16 + a_row) * kSLd + kk * 16 + a_col,
                    a[rt][0], a[rt][1], a[rt][2], a[rt][3]);
#pragma unroll
      for (int d = 0; d < kOt; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b_src + (kk * 16 + t_row) * kLd + col0 + d * 8 + t_col,
                          b0, b1, b2, b3);
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          mma(acc[rt][d], a[rt][0], a[rt][1], a[rt][2], a[rt][3], b0, b1);
          mma(acc[rt][d + 1], a[rt][0], a[rt][1], a[rt][2], a[rt][3], b2, b3);
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  auto key_offset = [&](int j) {
    return ((static_cast<size_t>(b) * sk + j) * kv_heads + kvh) * HD;
  };
  // fragment (rt, d, e) of acc: key krow0 + 16 rt + lane / 4 (+ 8 for e >=
  // 2), columns col0 + 8 d + 2 (lane % 4) and + 1
  __nv_bfloat16* out = prod ? dk : dv;
  const float mul = prod ? scale : 1.f;
  if (csize == 1) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int d = 0; d < kOt; ++d) {
        const int col = col0 + d * 8 + 2 * (lane & 3);
        const int j = k0 + krow0 + rt * 16 + (lane >> 2);
        if (j < sk)
          *reinterpret_cast<__nv_bfloat162*>(out + key_offset(j) + col) =
              __floats2bfloat162_rn(acc[rt][d][0] * mul, acc[rt][d][1] * mul);
        if (j + 8 < sk)
          *reinterpret_cast<__nv_bfloat162*>(out + key_offset(j + 8) + col) =
              __floats2bfloat162_rn(acc[rt][d][2] * mul, acc[rt][d][3] * mul);
      }
    return;
  }
  // a cluster: each block leaves its partial dK | dV (float32, [kKeysKV][2
  // HD]) in the Q/dO stages, then block c sums keys kKeysKV c / csize .. in
  // rank order
  __syncthreads();
  float* part = reinterpret_cast<float*>(qs);
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int d = 0; d < kOt; ++d) {
      const int jr = krow0 + rt * 16 + (lane >> 2);
      float* at = part + jr * 2 * HD + (prod ? 0 : HD) + col0 + d * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(at) = make_float2(acc[rt][d][0], acc[rt][d][1]);
      *reinterpret_cast<float2*>(at + 8 * 2 * HD) = make_float2(acc[rt][d][2], acc[rt][d][3]);
    }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rows_per = kKeysKV / csize;
  for (int idx = tid; idx < rows_per * HD; idx += kBwdThreads) {
    const int jr = crank * rows_per + idx / HD;
    const int c = 2 * (idx % HD);              // of dK's HD, then dV's
    if (k0 + jr >= sk) continue;
    float2 sum = make_float2(0.f, 0.f);
    for (int c_rank = 0; c_rank < csize; ++c_rank) {
      const float2 x = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(part, c_rank) + jr * 2 * HD + c);
      sum.x += x.x;
      sum.y += x.y;
    }
    if (c < HD)
      *reinterpret_cast<__nv_bfloat162*>(dk + key_offset(k0 + jr) + c) =
          __floats2bfloat162_rn(sum.x * scale, sum.y * scale);
    else
      *reinterpret_cast<__nv_bfloat162*>(dv + key_offset(k0 + jr) + c - HD) =
          __floats2bfloat162_rn(sum.x, sum.y);
  }
  cluster.sync();    // no block leaves while another reads its partial
}

// The blocks of a cluster that split one block's work (its key tiles in
// dq, its steps in dkv) where one block a work item would leave most SMs
// idle: the largest power of 2 up to 8 with 2 x that many clusters still
// under one block an SM and at least 2 x that many steps a work item.
inline int cluster_size(int items, int max_steps) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 1;
  int c = 1;
  while (c < 8 && items * c * 2 <= sms && c * 2 <= max_steps) c *= 2;
  return c;
}

// <<<blocks, kBwdThreads, bytes, stream>>>, in clusters of csize blocks
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, int blocks, int bytes, int csize,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kBwdThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = csize > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <int HD>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const float* lse, float* delta, const void* pad,
                            void* dq, void* dk, void* dv, int batch, int sq,
                            int sk, int heads, int kv_heads, int kind,
                            int window, float scale, cudaStream_t stream) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* oo = static_cast<const __nv_bfloat16*>(out);
  const auto* gg = static_cast<const __nv_bfloat16*>(dout);
  const int* pp = static_cast<const int*>(pad);
  auto* gq = static_cast<__nv_bfloat16*>(dq);
  auto* gk = static_cast<__nv_bfloat16*>(dk);
  auto* gv = static_cast<__nv_bfloat16*>(dv);
  const float scale_log2 = scale * kLog2e;
  constexpr int q_bytes = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  // one axis, the tile index slowest: every (kv head, batch row) of the
  // heaviest tile starts first
  const int qb = kRows / (heads / kv_heads);
  const int q_items = (sq + qb - 1) / qb * kv_heads * batch;
  const int q_csize = cluster_size(q_items, (sk + kKeysQ - 1) / kKeysQ);
  err = launch_clustered(dq_kernel<HD>, q_items * q_csize, q_bytes, q_csize,
                         stream, qq, kk, vv, oo, gg, lse, delta, pp, gq, batch,
                         sq, sk, heads, kv_heads, qb, kind, window, scale,
                         scale_log2, q_csize);
  if (err != cudaSuccess) return err;
  constexpr int kv_bytes = dkv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(
      dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const int kv_items = (sk + kKeysKV - 1) / kKeysKV * kv_heads * batch;
  const int kv_csize = cluster_size(
      kv_items, heads / kv_heads * ((sq + kQueries - 1) / kQueries));
  return launch_clustered(dkv_kernel<HD>, kv_items * kv_csize, kv_bytes,
                          kv_csize, stream, qq, kk, vv, gg,
                          static_cast<const float*>(lse),
                          static_cast<const float*>(delta), pp, gk, gv, batch,
                          sq, sk, heads, kv_heads, kind, window, scale,
                          scale_log2, kv_csize);
}

}  // namespace tc

// -- float32 backward: CUDA cores ----------------------------------------------

namespace f32 {

template <int HD>
constexpr int dkv_smem_bytes() {
  // K, V, Q and dO tiles padded as in the forward, P and dS of a 32 x 32
  // tile (rows of 33: no bank conflicts), the tile's lse and D
  return (4 * kKeys * (HD + 4) + 2 * kKeys * 33 + 2 * kKeys) * 4;
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * kRows * (HD + 4) + 2 * kKeys * (HD + 4)) * 4;
}

// dK and dV of one (batch row, kv head, 32-key tile) in full float32.
// Per 32-query tile of each head of the group: lane j scores key j against
// the warp's 4 queries (S and dP), P and dS go to shared memory, then each
// thread accumulates dV and dK for the warp's 4 keys at its hd / 32
// columns.
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ pad, float* __restrict__ dk,
           float* __restrict__ dv, int sq, int sk, int heads, int kv_heads,
           int kind, int window, float scale) {
  constexpr int kCols = HD / 32;
  constexpr int kLd = HD + 4;
  constexpr int kPer = kKeys / kWarps;         // queries (phase 1), keys (2)
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kKeys * kLd;
  float* qs = vs + kKeys * kLd;
  float* dos = qs + kKeys * kLd;
  float* ps = dos + kKeys * kLd;               // [query][key]
  float* dss = ps + kKeys * 33;
  float* lse_s = dss + kKeys * 33;
  float* d_s = lse_s + kKeys;

  const int group = heads / kv_heads;
  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pad_b = pad ? pad[b] : 0;

  for (int idx = tid * 4; idx < kKeys * HD; idx += kWarps * 32 * 4) {
    const int j = idx / HD, d = idx % HD;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (k0 + j < sk) {
      const size_t off = ((static_cast<size_t>(b) * sk + k0 + j) * kv_heads + kvh) * HD + d;
      kx = *reinterpret_cast<const float4*>(k + off);
      vx = *reinterpret_cast<const float4*>(v + off);
    }
    *reinterpret_cast<float4*>(ks + j * kLd + d) = kx;
    *reinterpret_cast<float4*>(vs + j * kLd + d) = vx;
  }

  int q_begin, q_end;
  query_range(k0, kKeys, sq, sk, pad_b, kind, window, q_begin, q_end);
  const int t_begin = q_begin / kKeys;
  const int t_end = q_end > q_begin ? (q_end + kKeys - 1) / kKeys : t_begin;
  const int kp = k0 + lane;

  float gk[kPer][kCols], gv[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kKeys;
      __syncthreads();   // the previous tile is consumed (and K / V stored)
      for (int idx = tid * 4; idx < kKeys * HD; idx += kWarps * 32 * 4) {
        const int i = idx / HD, d = idx % HD;
        float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), gx = qx;
        if (q0 + i < sq) {
          const size_t off = ((static_cast<size_t>(b) * sq + q0 + i) * heads + h) * HD + d;
          qx = *reinterpret_cast<const float4*>(q + off);
          gx = *reinterpret_cast<const float4*>(dout + off);
        }
        *reinterpret_cast<float4*>(qs + i * kLd + d) = qx;
        *reinterpret_cast<float4*>(dos + i * kLd + d) = gx;
      }
      if (tid < kKeys) {
        const int i = q0 + tid;
        const size_t row = (static_cast<size_t>(b) * heads + h) * sq + i;
        lse_s[tid] = i < sq ? lse[row] : INFINITY;
        d_s[tid] = i < sq ? delta[row] : 0.f;
      }
      __syncthreads();

      float s[kPer], dp[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
      const float* krow = ks + lane * kLd;
      const float* vrow = vs + lane * kLd;
      const float* qrow = qs + warp * kPer * kLd;
      const float* grow = dos + warp * kPer * kLd;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
        const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(qrow + i * kLd + d);
          const float4 gg = *reinterpret_cast<const float4*>(grow + i * kLd + d);
          s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          dp[i] += gg.x * vv.x + gg.y * vv.y + gg.z * vv.z + gg.w * vv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int li = warp * kPer + i;
        const int qi = q0 + li;
        bool ok = qi < sq && kp < sk && kp >= pad_b;
        if (kind != kAll) ok = ok && kp <= qi;
        if (kind == kLocal) ok = ok && kp > qi - window;
        const float p = ok ? expf(s[i] * scale - lse_s[li]) : 0.f;
        ps[li * 33 + lane] = p;
        dss[li * 33 + lane] = p * (dp[i] - d_s[li]);
      }
      __syncthreads();

      for (int i = 0; i < kKeys; ++i) {
        float gx[kCols], qx[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          gx[c] = dos[i * kLd + lane + 32 * c];
          qx[c] = qs[i * kLd + lane + 32 * c];
        }
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj) {
          const float p = ps[i * 33 + warp * kPer + jj];
          const float ds = dss[i * 33 + warp * kPer + jj];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            gv[jj][c] += p * gx[c];
            gk[jj][c] += ds * qx[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kPer; ++jj) {
    const int j = k0 + warp * kPer + jj;
    if (j >= sk) continue;
    const size_t off = ((static_cast<size_t>(b) * sk + j) * kv_heads + kvh) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[off + lane + 32 * c] = gk[jj][c] * scale;
      dv[off + lane + 32 * c] = gv[jj][c];
    }
  }
}

// dQ of one block of the forward's 64 folded rows in full float32: the
// forward's walk over 32-key tiles, lane j scoring key j, with dS in place
// of P and K in place of V.
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ pad, float* __restrict__ dq, int sq, int sk,
          int heads, int kv_heads, int qb, int kind, int window, float scale) {
  constexpr int kCols = HD / 32;
  constexpr int kLd = HD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kRows * kLd;
  float* ks = dos + kRows * kLd;
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

  for (int idx = tid * 4; idx < kRows * HD; idx += kWarps * 32 * 4) {
    const int r = idx / HD, d = idx % HD;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    const int pos = q0 + r % qb;
    if (r < rows_used && pos < sq) {
      const size_t off = ((static_cast<size_t>(b) * sq + pos) * heads + kvh * group + r / qb) * HD + d;
      x = *reinterpret_cast<const float4*>(q + off);
      y = *reinterpret_cast<const float4*>(dout + off);
    }
    *reinterpret_cast<float4*>(qs + r * kLd + d) = x;
    *reinterpret_cast<float4*>(dos + r * kLd + d) = y;
  }

  int qpos[kRowsPerWarp];
  float lse_r[kRowsPerWarp], d_r[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    qpos[i] = q0 + r % qb;
    const bool live = r < rows_used && qpos[i] < sq;
    const size_t row = (static_cast<size_t>(b) * heads + kvh * group + r / qb) * sq + qpos[i];
    lse_r[i] = live ? lse[row] : INFINITY;
    d_r[i] = live ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, qb, sq, sk, pad_b, kind, window, k_begin, k_end);

  for (int k0 = k_begin - k_begin % kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (and Q, dO stored)
    for (int idx = tid * 4; idx < kKeys * HD; idx += kWarps * 32 * 4) {
      const int j = idx / HD, d = idx % HD;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + k0 + j) * kv_heads + kvh) * HD + d;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + j * kLd + d) = kx;
      *reinterpret_cast<float4*>(vs + j * kLd + d) = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* krow = ks + lane * kLd;
    const float* vrow = vs + lane * kLd;
    const float* qrow = qs + warp * kRowsPerWarp * kLd;
    const float* grow = dos + warp * kRowsPerWarp * kLd;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + i * kLd + d);
        const float4 gg = *reinterpret_cast<const float4*>(grow + i * kLd + d);
        s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        dp[i] += gg.x * vv.x + gg.y * vv.y + gg.z * vv.z + gg.w * vv.w;
      }
    }

    const int kp = k0 + lane;
    float ds[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = kp < sk && kp >= pad_b;
      if (kind != kAll) ok = ok && kp <= qpos[i];
      if (kind == kLocal) ok = ok && kp > qpos[i] - window;
      const float p = ok ? expf(s[i] * scale - lse_r[i]) : 0.f;
      ds[i] = p * (dp[i] - d_r[i]);
    }

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float kx[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kx[c] = ks[j * kLd + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dsj = __shfl_sync(kFull, ds[i], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] += dsj * kx[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= rows_used || qpos[i] >= sq) continue;
    float* o = dq + ((static_cast<size_t>(b) * sq + qpos[i]) * heads + kvh * group + r / qb) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[lane + 32 * c] = acc[i][c] * scale;
  }
}

template <int HD>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const void* pad, void* dq,
                            void* dk, void* dv, int batch, int sq, int sk,
                            int heads, int kv_heads, int kind, int window,
                            float scale, cudaStream_t stream) {
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* gg = static_cast<const float*>(dout);
  const int* pp = static_cast<const int*>(pad);
  constexpr int kv_bytes = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((sk + kKeys - 1) / kKeys, kv_heads, batch);
  dkv_kernel<HD><<<kv_grid, kWarps * 32, kv_bytes, stream>>>(
      qq, kk, vv, gg, lse, delta, pp, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, heads, kv_heads, kind, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int q_bytes = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(
      dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const int qb = kRows / (heads / kv_heads);
  const dim3 q_grid((sq + qb - 1) / qb, kv_heads, batch);
  dq_kernel<HD><<<q_grid, kWarps * 32, q_bytes, stream>>>(
      qq, kk, vv, gg, lse, delta, pp, static_cast<float*>(dq), sq, sk, heads,
      kv_heads, qb, kind, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

// float32: D = rowsum(dO * O) of every (b, i, h) row, into (B, H, Sq); a
// warp a row (the bf16 backward forms D in its dQ pass)
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int heads, int hd) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = o + static_cast<size_t>(row) * hd;
  const float* g = dout + static_cast<size_t>(row) * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) sum += a[d] * g[d];
  sum = warp_sum(sum);
  if (lane == 0) {
    const int h = row % heads, i = (row / heads) % sq, b = row / (heads * sq);
    delta[(static_cast<size_t>(b) * heads + h) * sq + i] = sum;
  }
}

// bf16 takes the tensor-core bodies, float32 the CUDA-core ones
template <int HD>
cudaError_t launch_type(bool bf16, const void* q, const void* k, const void* v,
                        const void* pad, void* out, float* lse, int batch,
                        int sq, int sk, int heads, int kv_heads, int kind,
                        int window, float scale, cudaStream_t stream) {
  return bf16 ? tc::launch<HD>(q, k, v, pad, out, lse, batch, sq, sk, heads,
                               kv_heads, kind, window, scale, stream)
              : f32::launch<HD>(q, k, v, pad, out, lse, batch, sq, sk, heads,
                                kv_heads, kind, window, scale, stream);
}

template <int HD>
cudaError_t backward_type(bool bf16, const void* q, const void* k,
                          const void* v, const void* out, const void* dout,
                          const float* lse, float* delta, const void* pad,
                          void* dq, void* dk, void* dv, int batch, int sq,
                          int sk, int heads, int kv_heads, int kind,
                          int window, float scale, cudaStream_t stream) {
  if (bf16)
    return tc::launch_backward<HD>(q, k, v, out, dout, lse, delta, pad, dq,
                                   dk, dv, batch, sq, sk, heads, kv_heads,
                                   kind, window, scale, stream);
  const int rows = batch * sq * heads;
  delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), delta,
      rows, sq, heads, HD);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return f32::launch_backward<HD>(q, k, v, dout, lse, delta, pad, dq, dk, dv,
                                  batch, sq, sk, heads, kv_heads, kind,
                                  window, scale, stream);
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out like q, all contiguous and
// of one type (dtype 0: float32, 1: bfloat16); pad (B,) int32 or null; lse
// (B, H, Sq) float32 or null: where given, the rows' log-sum-exp of the
// scaled scores (+inf for a row that sees no key).  kind 0: causal, 1:
// local, 2: full.  Returns the launch's CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pad,
                                      void* out, void* lse, int batch, int sq,
                                      int sk, int heads, int kv_heads, int hd,
                                      int dtype, int kind, int window,
                                      float scale, int device, void* stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > kRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32: return launch_type<32>(bf16, q, k, v, pad, out, l, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 64: return launch_type<64>(bf16, q, k, v, pad, out, l, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 128: return launch_type<128>(bf16, q, k, v, pad, out, l, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 256: return launch_type<256>(bf16, q, k, v, pad, out, l, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of flash_attention_launch: dq, dk, dv (shaped and typed as
// q, k, v) from q, k, v, the forward's out and lse, and dout (like q).
// delta is (B, H, Sq) float32 scratch for D = rowsum(dout * out).  bf16:
// two device kernels, dQ (which also forms D) then dK / dV; float32: three,
// D, then dK / dV, then dQ.  Returns the CUDA error code.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* pad, void* delta, void* dq,
    void* dk, void* dv, int batch, int sq, int sk, int heads, int kv_heads,
    int hd, int dtype, int kind, int window, float scale, int device,
    void* stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > kRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  float* d = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  switch (hd) {
    case 32: return backward_type<32>(bf16, q, k, v, out, dout, l, d, pad, dq, dk, dv, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 64: return backward_type<64>(bf16, q, k, v, out, dout, l, d, pad, dq, dk, dv, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 128: return backward_type<128>(bf16, q, k, v, out, dout, l, d, pad, dq, dk, dv, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    case 256: return backward_type<256>(bf16, q, k, v, out, dout, l, d, pad, dq, dk, dv, batch, sq, sk, heads, kv_heads, kind, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
