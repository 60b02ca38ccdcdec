// Decode attention: one query token's GQA attention against a KV cache, on
// an NVIDIA Hopper card (sm_90a), in two entries that share one body:
//   dense: k, v (B, S, KV, hd) under a (B, S) validity mask;
//   paged: k, v a pool (n_blocks, bs, KV, hd) read through a (B, M) block
//          table, key j of row b valid iff j <= seq_lens[b] (S = M * bs).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, pallas_call at :84) and computes what it
// computes:
//   out[b, 0, h] = sum_j p_j v[b, j, h / G],  p = softmax_j(s_j),
//   s_j = q[b, 0, h] . k[b, j, h / G] / sqrt(hd) where valid, else -1e30.
// A masked key is scored -1e30 and not zeroed afterwards, so a row with no
// valid key gets the uniform average of its S values, as the TPU kernel
// and the plain version give.  The paged entry gives what gathering
// k[block_table] into (B, M * bs, KV, hd) and calling the dense entry with
// mask j <= seq_lens[b] gives: key 0 is always valid there, so the keys
// past min(seq_lens[b] + 1, M * bs) weigh exp(-1e30 - m) = 0 and are never
// read.  Softmax and accumulation are float32; the output has the input
// type.
//
// Bound.  Each K and V element is read once and used for G query heads
// (2 at qwen3-0.6b, 10 at recurrentgemma-2b), a few operations per byte:
// the kernel is bounded by the bytes of K and V, and the CUDA cores are
// enough for its arithmetic, so one design serves float32 and bf16.  To
// reach the bytes it needs every SM streaming, and coalesced loads.
//
// Design (flash-decoding).  The grid is (kv head x head group, batch row,
// split): the wrapper cuts S into splits of a multiple of 64 keys, enough
// of them for about 2 x 132 blocks (decode_splits in decode_attention.py).
// A block of 128 threads walks its split in tiles of TK keys (about 16 KB
// of K: 64 at bf16 hd 128, 32 at hd 256), brought into shared memory by
// cp.async, 16 bytes a lane, consecutive lanes on consecutive addresses,
// double-buffered so the next tile's load overlaps this tile's math.  Per
// tile:
//   A. scores: thread (key j, head slice) takes K row j from shared memory
//      16 bytes at a time (rows padded by 16 bytes, so the 8 rows a load
//      phase touches fall in 8 bank groups) against the query rows of its
//      head slice (float32 in shared memory, broadcast across the warp);
//   B. online softmax: a warp per head row updates m and l and turns the
//      tile's scores into weights in shared memory;
//   C. P V: thread (2 output columns, run of keys) reads V rows 4 or 8
//      bytes a lane, coalesced, and each head's weights 4 keys at a time,
//      into float32 accumulators for all the block's heads.
// The block's (m, l, acc) go to float32 scratch, and a second, small merge
// kernel combines the splits: weight exp(m_s - max m), keeping the -1e30
// convention (a wholly masked split has m = -1e30 and l = its key count:
// it vanishes next to any real score, and where every split is masked the
// merge gives the uniform average over all S).  An empty split (paged,
// past seq_lens[b] + 1) writes m = -1e30, l = 0 and acc = 0, which add
// nothing.  With one split the block writes the output itself and no merge
// runs.
//
// The partial entry (ml non-null) also writes each (row, head)'s softmax
// max m and sum l = sum_j exp(s_j - m), float32, beside its normalised
// output: what a caller needs to merge attention over several blocks of
// one sequence held apart (the KV cache's sequence split over ranks),
// with this kernel's merge rule.  A wholly masked block gives m = -1e30
// and l = its key count, so it weighs zero beside any block with a valid
// key, and where no block has one the merge is the uniform average.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
constexpr int tile_keys() {
  // about 16 KB of K (and of V) a stage, 16 to 64 keys (8 KB stages
  // measured slower on the paged tick and the ring, faster only on the
  // dense tick)
  return 16384 / (HD * static_cast<int>(sizeof(T))) > 64 ? 64
       : 16384 / (HD * static_cast<int>(sizeof(T))) < 16 ? 16
       : 16384 / (HD * static_cast<int>(sizeof(T)));
}

template <typename T, int HD, int NR>
struct Layout {
  static constexpr int kTk = tile_keys<T, HD>();
  static constexpr int kEpc = 16 / sizeof(T);           // elements of 16 bytes
  static constexpr int kLdk = HD + kEpc;                 // K row, padded 16 bytes
  static constexpr int kQ = NR * HD * 4;                 // float32 query rows
  static constexpr int kKv = 2 * kTk * (kLdk + HD) * static_cast<int>(sizeof(T));
  static constexpr int kS = NR * kTk * 4;                // scores, then weights
  static constexpr int kRow = 3 * NR * 4;                // m, l, alpha
  static constexpr int kBytes = kQ + kKv + kS + kRow;
  // the end-of-block reduction over key groups reuses the K/V stages
  static_assert((256 / HD) * NR * HD * 4 <= kKv, "reduction buffer");
};

// One (kv head x head group, batch row, split) block.  Rows are the NR
// query heads g0 .. g0 + NR - 1 of kv head kvh (rows <= NR of them exist).
template <typename T, int HD, int NR>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    const int* __restrict__ table,
                    const int* __restrict__ seq_lens, int table_width,
                    int block_size, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    float* __restrict__ ml, int s_len, int heads,
                    int kv_heads, int groups, int chunk, float scale) {
  using L = Layout<T, HD, NR>;
  constexpr int kTk = L::kTk, kEpc = L::kEpc, kLdk = L::kLdk;
  constexpr int kChunks = HD / kEpc;           // 16-byte pieces of a row
  constexpr int kSlices = kThreads / kTk;      // phase A: head slices
  constexpr int kRpt = (NR + kSlices - 1) / kSlices;
  constexpr int kRpw = (NR + 3) / 4;           // phase B: rows of a warp
  constexpr int kTpr = HD / 2;                 // phase C: threads over a row
  constexpr int kGroups = kThreads / kTpr;     //          key groups
  constexpr int kSpan = kTk / kGroups;         //          keys of a group
  static_assert(kTk <= 64 && kThreads % kTk == 0 && kGroups >= 1
                && kSpan % 4 == 0, "tile");

  extern __shared__ uint4 smem16[];
  float* qs = reinterpret_cast<float*>(smem16);                  // [NR][HD]
  T* ks = reinterpret_cast<T*>(reinterpret_cast<char*>(smem16) + L::kQ);  // [2][kTk][kLdk]
  T* vs = ks + 2 * kTk * kLdk;                                   // [2][kTk][HD]
  float* ss = reinterpret_cast<float*>(vs + 2 * kTk * HD);       // [NR][kTk]
  float* m_s = ss + NR * kTk;
  float* l_s = m_s + NR;
  float* alpha_s = l_s + NR;

  const int group = heads / kv_heads;
  const int kvh = blockIdx.x / groups;
  const int g0 = (blockIdx.x % groups) * NR;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int rows = min(NR, group - g0);
  const int h0 = kvh * group + g0;             // the block's first head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this split's keys [kb, ke)
  int end = s_len;
  if (table) end = min(seq_lens[b] + 1, s_len);
  const int kb = split * chunk;
  const int ke = min(kb + chunk, end);
  const size_t part = (static_cast<size_t>(b) * heads + h0) * splits + split;
  if (kb >= ke) {                              // empty (paged, past the row)
    for (int idx = tid; idx < rows * HD; idx += kThreads) {
      const size_t pr = part + static_cast<size_t>(idx / HD) * splits;
      part_acc[pr * HD + idx % HD] = 0.f;
      if (idx % HD == 0) {
        part_ml[pr * 2] = kNeg;
        part_ml[pr * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const size_t key_stride = static_cast<size_t>(kv_heads) * HD;
  auto key_offset = [&](int key) -> size_t {   // elements to key's row
    if (table) {
      const int blk = table[static_cast<size_t>(b) * table_width + key / block_size];
      return (static_cast<size_t>(blk) * block_size + key % block_size) * key_stride + kvh * HD;
    }
    return (static_cast<size_t>(b) * s_len + key) * key_stride + kvh * HD;
  };
  auto load_tile = [&](int t, int stage) {
    const int k0 = kb + t * kTk;
    for (int idx = tid; idx < kTk * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks;
      const bool live = k0 + j < ke;
      const size_t off = key_offset(live ? k0 + j : kb) + c * kEpc;
      cp_async16(ks + (stage * kTk + j) * kLdk + c * kEpc, k + off, live);
      cp_async16(vs + (stage * kTk + j) * HD + c * kEpc, v + off, live);
    }
  };

  const int n_tiles = (ke - kb + kTk - 1) / kTk;
  load_tile(0, 0);
  cp_async_commit();
  for (int idx = tid; idx < NR * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    qs[idx] = r < rows ? load1(q + (static_cast<size_t>(b) * heads + h0 + r) * HD + d) : 0.f;
  }
  if (tid < NR) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  // phase A's thread: key j of the tile, rows hs, hs + kSlices, ...
  const int aj = tid % kTk, hs = tid / kTk;
  // phase C's thread: columns 2 cp, 2 cp + 1 of keys kg * kSpan ..
  // (kg + 1) * kSpan - 1
  const int cp = tid % kTpr, kg = tid / kTpr;
  float acc[NR][2];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r][0] = acc[r][1] = 0.f;
  const uint8_t* mrow = mask ? mask + static_cast<size_t>(b) * s_len : nullptr;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + stage * kTk * kLdk;
    const T* vt = vs + stage * kTk * HD;
    const int k0 = kb + t * kTk;

    // A. scores; past ke: -inf (weight exactly 0); masked: -1e30.  Four
    // partial sums a row keep four FMA chains in flight.
    {
      float sc[kRpt][4];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      const T* krow = kt + aj * kLdk;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        float kf[kEpc];
        unpack(*reinterpret_cast<const uint4*>(krow + c * kEpc), kf);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
          const int r = hs + i * kSlices;
          if (r < rows) {
            const float* qr = qs + r * HD + c * kEpc;
#pragma unroll
            for (int e = 0; e < kEpc; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
              sc[i][0] += qq.x * kf[e];
              sc[i][1] += qq.y * kf[e + 1];
              sc[i][2] += qq.z * kf[e + 2];
              sc[i][3] += qq.w * kf[e + 3];
            }
          }
        }
      }
      const int key = k0 + aj;
      const bool in = key < ke;
      const bool valid = in && (mrow == nullptr || mrow[key] != 0);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int r = hs + i * kSlices;
        const float dot = (sc[i][0] + sc[i][1]) + (sc[i][2] + sc[i][3]);
        if (r < rows) ss[r * kTk + aj] = !in ? -INFINITY : valid ? dot * scale : kNeg;
      }
    }
    __syncthreads();

    // B. online softmax, a warp per row
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      const int r = warp + 4 * i;
      if (r >= rows) continue;
      float* sr = ss + r * kTk;
      const float x0 = lane < kTk ? sr[lane] : -INFINITY;
      const float x1 = lane + 32 < kTk ? sr[lane + 32] : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      // masked keys keep exp(-1e30 - m): 1 while the row has no valid key
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      if (lane < kTk) sr[lane] = p0;
      if (lane + 32 < kTk) sr[lane + 32] = p1;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // C. acc = alpha acc + P V
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < rows) {
        const float a = alpha_s[r];
        acc[r][0] *= a;
        acc[r][1] *= a;
      }
    }
    for (int j = kg * kSpan; j < (kg + 1) * kSpan; j += 4) {
      float2 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = load2(vt + (j + u) * HD + 2 * cp);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < rows) {                        // 4 weights in one load
          const float4 p = *reinterpret_cast<const float4*>(ss + r * kTk + j);
          acc[r][0] += p.x * vv[0].x + p.y * vv[1].x + p.z * vv[2].x + p.w * vv[3].x;
          acc[r][1] += p.x * vv[0].y + p.y * vv[1].y + p.z * vv[2].y + p.w * vv[3].y;
        }
      }
    }
    __syncthreads();   // this stage and the weights are consumed
  }

  // sum the key groups' accumulators (in the freed K/V stages), then write
  // the output (one split) or this split's (m, l, acc) for the merge
  float* red = reinterpret_cast<float*>(ks);   // [kGroups][NR][HD]
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < rows) {
      red[(kg * NR + r) * HD + 2 * cp] = acc[r][0];
      red[(kg * NR + r) * HD + 2 * cp + 1] = acc[r][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) a += red[(g * NR + r) * HD + d];
    if (splits == 1) {
      const size_t row = static_cast<size_t>(b) * heads + h0 + r;
      store1(out + row * HD + d, a / fmaxf(l_s[r], 1e-20f));
      if (ml != nullptr && d == 0) {           // m, then l, each (B, H)
        ml[row] = m_s[r];
        ml[static_cast<size_t>(gridDim.y) * heads + row] = l_s[r];
      }
    } else {
      const size_t pr = part + static_cast<size_t>(r) * splits;
      part_acc[pr * HD + d] = a;
      if (d == 0) {
        part_ml[pr * 2] = m_s[r];
        part_ml[pr * 2 + 1] = l_s[r];
      }
    }
  }
}

// One block per (batch row, head), a thread per output column.  The
// splits' (m, l) come into shared memory in one parallel load, so the pass
// over the accumulators has no branch; an empty split (m = -1e30, l = 0,
// acc = 0) adds nothing whatever its weight.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out,
                                    float* __restrict__ ml, int splits,
                                    int hd) {
  extern __shared__ float ml_s[];              // [splits][2]: (m, l)
  const size_t row = blockIdx.x;               // b * heads + h
  const int d = threadIdx.x;
  for (int i = d; i < 2 * splits; i += hd) ml_s[i] = part_ml[row * splits * 2 + i];
  __syncthreads();
  float mx = kNeg;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml_s[2 * s]);
  float lsum = 0.f, a = 0.f;
  const float* acc = part_acc + row * splits * hd + d;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ml_s[2 * s] - mx);
    lsum += w * ml_s[2 * s + 1];
    a += w * acc[static_cast<size_t>(s) * hd];
  }
  store1(out + row * hd + d, a / fmaxf(lsum, 1e-20f));
  if (ml != nullptr && d == 0) {
    ml[row] = mx;
    ml[gridDim.x + row] = lsum;
  }
}

struct Args {
  const void *q, *k, *v, *mask, *table, *seq_lens;
  void *out, *part_acc, *part_ml, *ml;
  int batch, s_len, heads, kv_heads, table_width, block_size, chunk, splits;
  float scale;
};

template <typename T, int HD, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Layout<T, HD, NR>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, HD, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int group = a.heads / a.kv_heads;
  const int groups = (group + NR - 1) / NR;
  const dim3 grid(a.kv_heads * groups, a.batch, a.splits);
  decode_split_kernel<T, HD, NR><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const int*>(a.table), static_cast<const int*>(a.seq_lens),
      a.table_width, a.block_size, static_cast<T*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<float*>(a.ml), a.s_len, a.heads, a.kv_heads, groups,
      a.chunk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_merge_kernel<T><<<a.batch * a.heads, HD, a.splits * 8, stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<T*>(a.out), static_cast<float*>(a.ml), a.splits, HD);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_rows(const Args& a, cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  if (group <= 1) return launch<T, HD, 1>(a, stream);
  if (group <= 2) return launch<T, HD, 2>(a, stream);
  if (group <= 4) return launch<T, HD, 4>(a, stream);
  if (group <= 8) return launch<T, HD, 8>(a, stream);
  return launch<T, HD, 16>(a, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_rows<T, 32>(a, stream);
    case 64: return dispatch_rows<T, 64>(a, stream);
    case 128: return dispatch_rows<T, 128>(a, stream);
    case 256: return dispatch_rows<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, H, hd) and out like it; dtype 0: float32, 1: bfloat16, k and v
// of the same type; all contiguous.
//   dense (table null): k, v (B, s_len, KV, hd), mask (B, s_len) bool;
//   paged (mask null): k, v (n_blocks, block_size, KV, hd), table
//     (B, table_width) int32, seq_lens (B,) int32, s_len = table_width *
//     block_size.
// chunk: keys of a split (a multiple of 64); splits: ceil(s_len / chunk).
// With splits > 1, part_acc (B * H * splits * hd) and part_ml
// (B * H * splits * 2) are float32 scratch.  ml, where not null, gets the
// float32 softmax max (its first B * H entries) and sum (the next B * H)
// of each (row, head).  Returns the CUDA error code.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* mask,
    const void* table, const void* seq_lens, void* out, void* part_acc,
    void* part_ml, void* ml, int batch, int s_len, int heads, int kv_heads, int hd,
    int dtype, int table_width, int block_size, int chunk, int splits,
    float scale, int device, void* stream) {
  if (heads % kv_heads != 0 || chunk % 64 != 0 || splits < 1
      || (table == nullptr) == (mask == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, mask, table, seq_lens, out, part_acc, part_ml, ml,
               batch, s_len, heads, kv_heads, table_width, block_size, chunk,
               splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, a, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
