// Mamba2 SSD (state-space dual) chunked scan on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_pallas,
// pallas_call at :135) and computes what it computes, per head h with state
// M (N x P), A = -exp(a_log[h]):
//   M_t = [reset_t ? 0 : exp(A dt_t) M_{t-1}] + dt_t b_t x_t^T
//   y_t = c_t M_t + D_h x_t
// returning y (B, S, H, P) in x's type and the final M (B, H, N, P) float32.
//
// Design.  The TPU kernel carried M across a sequential grid axis in VMEM.
// Hopper blocks run in no order, so one block of 256 threads owns one
// (head, batch row) and walks the sequence in order, kTile steps at a time,
// with M in shared memory.  Per tile, in the chunked (dual) form:
//   W[q][r] = (c_q . b_r) exp(cum_q - cum_r) dt_r   for r <= q, same segment
//   y[q]    = sum_r W[q][r] x_r + [no reset yet] exp(cum_q) c_q M + D x_q
//   M       = [no reset in tile] exp(total) M + sum_r [no later reset]
//             exp(total - cum_r) dt_r b_r x_r^T
// where cum is the in-tile prefix sum of A dt and the segment id of a step
// counts the in-tile resets up to it.  Resets stay in the linear domain, as
// in the TPU kernel: a log-domain -inf would be absorbed by the prefix sum.
// The mask is applied before the exp, so no positive exponent is formed.
// cum and its differences are float64: at mamba2's decays (A dt down to
// about -13 a step) cum reaches -800 within a tile, where a float32
// difference would lose 6e-5 of a decay factor; the plain version does the
// same, and the tile length then barely moves the result.
// The tile length is a tiling choice, not part of the result: a chunk of
// 256 steps in float32 would need 320 KB of shared memory; a tile of 64
// needs 135 KB at N 128, P 64.  Head h reads B/C group h / (H / G) in place
// (the TPU wrapper materialised the repeat).  Any S: the last tile is
// shorter, and its missing rows are zeros.  Arithmetic is float32 on the
// CUDA cores: the TPU kernel computes in float32, and TF32 would not hold
// the reference's 1e-4.  Each product is a 4 x 4 register tile fed by
// float4 shared-memory reads; B and C rows are padded by 4 floats so that
// eight rows read at once fall in eight different bank groups.
//
// Bound.  At mamba2's H 64, P 64, N 128 the chunked form does about
// 3.8 GFLOP at B 2, S 512 (tile 64) against 21.8 MB of bf16 inputs and
// outputs: over the bf16 peak the bytes bound it; over the float32
// CUDA-core peak the operations would.  B x H blocks (64 for a solo prefill,
// 128 at B 2) are one wave or less on 132 SMs: splitting the sequence over
// blocks (a second pass for the carried states) is the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // steps per tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bmat,
           const T* __restrict__ cmat, const float* __restrict__ d_skip,
           const uint8_t* __restrict__ reset, T* __restrict__ y,
           float* __restrict__ state, int s_len, int heads, int groups,
           int n, int p) {
  extern __shared__ float4 smem4[];
  const int ns = n + 4;          // padded B/C row
  const int ws = kTile + 4;      // padded W row
  float* m = reinterpret_cast<float*>(smem4);   // n x p
  float* xs = m + n * p;                        // kTile x p
  float* bs = xs + kTile * p;                   // kTile x ns
  float* cs = bs + kTile * ns;                  // kTile x ns
  float* w = cs + kTile * ns;                   // kTile x ws
  double* cum = reinterpret_cast<double*>(w + kTile * ws);   // 8-byte aligned
  float* dts = reinterpret_cast<float*>(cum + kTile);
  float* inter = dts + kTile;
  float* coef = inter + kTile;
  int* seg = reinterpret_cast<int*>(coef + kTile);

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = h / (heads / groups);
  const float a = -expf(a_log[h]);
  const float dskip = d_skip[h];
  const int pt = p / 4;

  for (int i = tid; i < n * p; i += kThreads) m[i] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += kTile) {
    const int len = min(kTile, s_len - t0);
    const size_t row0 = static_cast<size_t>(bb) * s_len + t0;

    // 1. the tile's x, B, C, dt and resets; rows past len are zeros
    for (int i = tid; i < kTile * p; i += kThreads) {
      const int q = i / p;
      xs[i] = q < len ? load1(x + ((row0 + q) * heads + h) * p + (i - q * p)) : 0.f;
    }
    for (int i = tid; i < kTile * n; i += kThreads) {
      const int q = i / n, c = i - q * n;
      float bv = 0.f, cv = 0.f;
      if (q < len) {
        const size_t off = ((row0 + q) * groups + g) * n + c;
        bv = load1(bmat + off);
        cv = load1(cmat + off);
      }
      bs[q * ns + c] = bv;
      cs[q * ns + c] = cv;
    }
    if (tid < kTile) {
      dts[tid] = tid < len ? dt[(row0 + tid) * heads + h] : 0.f;
      seg[tid] = (reset != nullptr && tid < len) ? (reset[row0 + tid] != 0) : 0;
    }
    __syncthreads();

    // 2. in-tile prefix sums of A dt (float64) and of the resets (one warp,
    //    2 steps a lane)
    if (tid < 32) {
      const int i0 = 2 * tid, i1 = i0 + 1;
      const double v0 = a * dts[i0], v1 = a * dts[i1];
      const int r0 = seg[i0], r1 = seg[i1];
      double sv = v0 + v1;
      int sr = r0 + r1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double tv = __shfl_up_sync(kFull, sv, o);
        const int tr = __shfl_up_sync(kFull, sr, o);
        if (tid >= o) { sv += tv; sr += tr; }
      }
      double ev = __shfl_up_sync(kFull, sv, 1);
      int er = __shfl_up_sync(kFull, sr, 1);
      if (tid == 0) { ev = 0.0; er = 0; }
      cum[i0] = ev + v0;
      cum[i1] = (ev + v0) + v1;
      seg[i0] = er + r0;
      seg[i1] = er + r0 + r1;
    }
    __syncthreads();

    const double total = cum[len - 1];
    const int seg_end = seg[len - 1];
    if (tid < kTile) {
      const bool live = tid < len;
      inter[tid] = (live && seg[tid] == 0) ? expf(static_cast<float>(cum[tid])) : 0.f;
      coef[tid] = (live && seg[tid] == seg_end)
                      ? expf(static_cast<float>(total - cum[tid])) * dts[tid] : 0.f;
    }

    // 3. W: thread (qi, rj) takes rows 4 qi + i and columns rj + 16 j
    for (int tile = tid; tile < (kTile / 4) * 16; tile += kThreads) {
      const int q0 = (tile / 16) * 4, rj = tile % 16;
      float acc[4][4] = {};
      if (rj <= q0 + 3 && q0 < len) {
        for (int c = 0; c < n; c += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (q0 + i) * ns + c);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = ld4(bs + (rj + 16 * j) * ns + c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y +
                           cv[i].z * bv[j].z + cv[i].w * bv[j].w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rj + 16 * j;
          float wv = 0.f;
          if (r <= q && q < len && seg[q] == seg[r])
            wv = acc[i][j] * expf(static_cast<float>(cum[q] - cum[r])) * dts[r];
          w[q * ws + r] = wv;
        }
      }
    }
    __syncthreads();

    // 4. y = W x + inter (C M) + D x, from the state entering the tile
    for (int tile = tid; tile < (kTile / 4) * pt; tile += kThreads) {
      const int q0 = (tile / pt) * 4, p0 = (tile % pt) * 4;
      if (q0 >= len) continue;
      float acc[4][4] = {}, acc2[4][4] = {};
      const int rmax = min(q0 + 4, len);
      for (int r = 0; r < rmax; ++r) {
        const float4 xv = ld4(xs + r * p + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = w[(q0 + i) * ws + r];
          acc[i][0] += wv * xv.x;
          acc[i][1] += wv * xv.y;
          acc[i][2] += wv * xv.z;
          acc[i][3] += wv * xv.w;
        }
      }
      for (int c = 0; c < n; c += 4) {
        float4 cv[4], mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (q0 + i) * ns + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k] = ld4(m + (c + k) * p + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float cik = at(cv[i], k);
            acc2[i][0] += cik * mv[k].x;
            acc2[i][1] += cik * mv[k].y;
            acc2[i][2] += cik * mv[k].z;
            acc2[i][3] += cik * mv[k].w;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
        if (q >= len) break;
        const float f = inter[q];
        T* out = y + ((row0 + q) * heads + h) * p + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store1(out + j, acc[i][j] + f * acc2[i][j] + dskip * xs[q * p + p0 + j]);
      }
    }
    __syncthreads();

    // 5. M = carry M + sum_r coef_r b_r x_r^T
    const float carry = seg_end == 0 ? expf(static_cast<float>(total)) : 0.f;
    for (int tile = tid; tile < (n / 4) * pt; tile += kThreads) {
      const int n0 = (tile / pt) * 4, p0 = (tile % pt) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 mv = ld4(m + (n0 + i) * p + p0);
        acc[i][0] = carry * mv.x;
        acc[i][1] = carry * mv.y;
        acc[i][2] = carry * mv.z;
        acc[i][3] = carry * mv.w;
      }
      for (int r = 0; r < len; ++r) {
        const float cf = coef[r];
        const float4 bv = ld4(bs + r * ns + n0);
        const float4 xv = ld4(xs + r * p + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bi = at(bv, i) * cf;
          acc[i][0] += bi * xv.x;
          acc[i][1] += bi * xv.y;
          acc[i][2] += bi * xv.z;
          acc[i][3] += bi * xv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(m + (n0 + i) * p + p0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
  }

  float* out = state + (static_cast<size_t>(bb) * heads + h) * n * p;
  for (int i = tid; i < n * p; i += kThreads) out[i] = m[i];
}

size_t smem_bytes(int n, int p) {
  return sizeof(float) * (static_cast<size_t>(n) * p + kTile * p +
                          2 * kTile * (n + 4) + kTile * (kTile + 4) + 6 * kTile);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* b, const void* c, const void* d_skip,
                   const void* reset, void* y, void* state, int batch,
                   int s_len, int heads, int groups, int n, int p,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(n, p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<const uint8_t*>(reset), static_cast<T*>(y),
      static_cast<float*>(state), s_len, heads, groups, n, p);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), b and c (B, S, G, N) and y (B, S, H, P) of one type
// (dtype 0: float32, 1: bfloat16); dt (B, S, H), a_log and d_skip (H,) and
// state (B, H, N, P) float32; reset (B, S) bool or null.  All contiguous;
// N and P multiples of 4, G dividing H.  Returns the launch's CUDA error.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* b,
                               const void* c, const void* d_skip,
                               const void* reset, void* y, void* state,
                               int batch, int s_len, int heads, int groups,
                               int n, int p, int dtype, int device,
                               void* stream) {
  if (groups <= 0 || heads % groups != 0 || n % 4 != 0 || p % 4 != 0 ||
      s_len <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, b, c, d_skip, reset, y, state, batch, s_len, heads, groups, n, p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, reset, y, state, batch, s_len, heads, groups, n, p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
