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
// Hopper blocks run in no order, so the sequence is cut into chunks of kT
// steps and split over blocks with the SSD "dual" decomposition of Mamba2
// (arXiv:2405.21060, section 6).  Per chunk, with cum the in-chunk prefix
// sum of A dt and seg the in-chunk count of resets up to a step:
//   W[q][r]  = (c_q . b_r) exp(cum_q - cum_r) dt_r   for r <= q, same seg
//   S_c      = sum_r [seg_r = seg_end] exp(total - cum_r) dt_r b_r x_r^T
//   carry_c  = [no reset in the chunk] exp(total)
//   inter_q  = [seg_q = 0] exp(cum_q)
// and across chunks M_c = carry_c M_{c-1} + S_c, y_q = sum_r W[q][r] x_r +
// inter_q c_q M_{c-1} + D x_q.  A call issues:
//   * one kernel where S <= kT (every solo prefill and first chunk of the
//     served model): chunk_kernel<kOne> computes y and writes S_0 as the
//     final state, one block per (column group of P, head, batch row);
//   * three kernels otherwise: (a) chunk_kernel<kState> writes S_c and
//     carry_c to float32 scratch, one block per (chunk, column group,
//     head, batch row); (b) state_pass walks the chunks of each (head,
//     batch row) in order, four state elements a thread, writes the state
//     entering chunk c (for bf16 x as the hi and lo bf16 parts the tensor
//     cores take) and the final state; (c) chunk_kernel<kScan> computes y
//     with the entering state.  The output
//     pass is fused with the chunk's own term, as Mamba2's chunk_scan is,
//     so y is written once, in its own type: a separate output pass would
//     move y twice more in float32, while (c) only recomputes the prefix
//     sums and C.B^T, which are cheap.
// Resets stay in the linear domain, as in the TPU kernel: a log-domain -inf
// would be absorbed by the prefix sum.  The mask is applied before the exp,
// so no positive exponent is formed.  cum and its differences are float64:
// at mamba2's decays (A dt down to about -13 a step) cum reaches -800
// within a chunk, where a float32 difference would lose 6e-5 of a decay
// factor; the plain version does the same.  Head h reads B/C group
// h / (H / G) in place.  Any S: the last chunk is shorter and its missing
// rows are zeros.  Inputs may start at any element offset: a tile is
// copied 16 bytes a thread where its rows are 16-byte aligned, else element
// by element.
//
// Arithmetic.  bf16 inputs run the four products on the tensor cores
// (mma.sync.m16n8k16, bf16 in, float32 accumulate, ldmatrix operands), 16
// rows a warp: C.B^T (both operands bf16: exact products), W.x (W is
// float32), C.M (M is float32) and B^T.(coef x) (coef x is float32).  A
// float32 operand goes in as two bf16 parts, hi = bf16(v) and lo =
// bf16(v - hi), which carry about 16 bits; one bf16 would not hold the
// float32 state to 1e-4.  float32 inputs keep the CUDA cores (4 x 4
// register tiles): TF32 would not hold the reference's 1e-4.
//
// Bound.  At mamba2's H 64, P 64, N 128, B 2, S 512 the function moves
// 21.8 MB of bf16 inputs and outputs; over the bf16 tensor-core rate its
// 3 GFLOP take a quarter of that time, so the bytes bound it (0.0065 ms).
// The chunk states' round trip through scratch (16.8 MB of float32 states
// written and read, the entering states written and read as hi + lo) is
// the design's own cost.  On an H100 the three kernels take 0.028, 0.020
// and 0.052 ms there (PERF.md, section 6): a block is a short chain of
// dependent phases (loads, prefix sums, products, stores), the blocks of a
// wave run them in step, and every block of a chunk reads its group's B
// and C tiles again from L2, so latency and L2 traffic, not the device
// memory's bytes, bound the passes.  At a solo prefill (B 1, S 32) the
// 2.1 MB final state is most of the bytes (0.0008 ms): the one-chunk path
// spreads it over 4 column groups of P (256 blocks), and each lane stores
// its accumulator pairs straight from the fragments, a quad filling one
// 32-byte sector (a build that staged them for 16-byte stores measured the
// same there and held 35 KB more shared memory a block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;           // steps per chunk
constexpr int kThreads = 128;    // 4 warps; a warp owns 16 rows of a product
constexpr unsigned kFull = 0xffffffffu;
// kAdjoint is the backward's U_c = C^T (inter dY) of chunks 1..
// (chunk_adjoint): the kState pass with (C, inter, dY) in place of (B, coef,
// x)
enum Mode { kOne = 0, kState = 1, kScan = 2, kAdjoint = 3 };

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d_skip;
  const uint8_t* reset;
  void* y;
  float* state;          // (B, H, N, P) final
  float* chunk_states;   // (B, H, chunks, N, P) scratch, or null
  bf16* entering;        // (B, H, chunks, 2, N, P) hi / lo scratch (bf16 x)
  float* carry;          // (B, H, chunks) scratch, or null
  int s_len, heads, groups, n, p, chunks, col_groups;
};

// Byte offsets of a block's shared memory, by type and mode, for a column
// group of pw columns (kernels/ssd_scan.py::shared_bytes mirrors it).
struct Layout {
  int ldx, ldb;          // row strides of the x and B/C tiles
  size_t cum, dts, inter, coef, seg, xs, bs, cs, xh, xl, mh, ml, w, m, bytes;
};

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t start = at;
  at = (at + bytes + 15) & ~static_cast<size_t>(15);
  return start;
}

template <typename T>
__host__ __device__ inline Layout layout(int mode, int n, int pw) {
  Layout L{};
  size_t o = 0;
  L.cum = take(o, kT * 8);
  L.dts = take(o, kT * 4);
  L.inter = take(o, kT * 4);
  L.coef = take(o, kT * 4);
  L.seg = take(o, kT * 4);
  if (sizeof(T) == 2) {           // bf16: tiles padded to 16, rows by 8
    const int np = up16(n), pp = up16(pw);
    L.ldx = pp + 8;
    L.ldb = np + 8;
    L.xs = take(o, kT * L.ldx * 2);
    if (mode == kScan) {   // the entering state replaces B's tile after C.B^T
      const size_t m_bytes = static_cast<size_t>(np) * L.ldx * 2;
      const size_t b_bytes = static_cast<size_t>(kT) * L.ldb * 2;
      L.bs = take(o, b_bytes > 2 * m_bytes ? b_bytes : 2 * m_bytes);
      L.mh = L.bs;
      L.ml = L.bs + m_bytes;
    } else {
      L.bs = take(o, kT * L.ldb * 2);
    }
    if (mode != kState) L.cs = take(o, kT * L.ldb * 2);
    if (mode != kScan) {
      L.xh = take(o, kT * L.ldx * 2);
      L.xl = take(o, kT * L.ldx * 2);
    }
  } else {                        // float32: rows of B/C padded by 4
    L.ldx = pw;
    L.ldb = n + 4;
    L.xs = take(o, kT * pw * 4);
    L.bs = take(o, kT * L.ldb * 4);
    if (mode != kState) {
      L.cs = take(o, kT * L.ldb * 4);
      L.w = take(o, kT * (kT + 4) * 4);
    }
    if (mode == kScan) L.m = take(o, static_cast<size_t>(n) * pw * 4);
  }
  L.bytes = o;
  return L;
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// dst[r][j] = src[r * stride + j] for r < rows, j < width; zeros elsewhere
// up to rows_pad rows and width_pad columns, by the kBlock threads of the
// block.  Where the source rows are 16-byte aligned, by cp.async, 16 bytes a
// thread, every copy of the tile in flight at once (the caller waits with
// cp_async_wait<0> before its barrier); else element by element.
template <typename T, int kBlock = kThreads>
__device__ void load_tile(T* dst, int ld, int rows_pad, int width_pad,
                          const T* src, size_t stride, int rows, int width) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   stride % kVec == 0 && width % kVec == 0 &&
                   width_pad % kVec == 0;
  if (vec) {
    const int per_row = width_pad / kVec;
    for (int i = threadIdx.x; i < rows_pad * per_row; i += kBlock) {
      const int r = i / per_row, j = (i - r * per_row) * kVec;
      const bool live = r < rows && j < width;
      cp_async16(dst + r * ld + j, live ? src + r * stride + j : src, live);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < rows_pad * width_pad; i += kBlock) {
      const int r = i / width_pad, j = i - r * width_pad;
      dst[r * ld + j] = (r < rows && j < width) ? src[r * stride + j] : zero<T>();
    }
  }
}

// -- bf16: tensor cores (mma.sync m16n8k16) -----------------------------------

namespace tc {

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

// one B fragment (16 x 8) of a tile stored [k][n]: lanes 0-15 address rows
// k 0-15 (the others' addresses are ignored)
__device__ __forceinline__ void ldmatrix_x2_trans(const void* p, uint32_t& r0,
                                                  uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 r = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(x0 - r.x, x1 - r.y);
  hi = *reinterpret_cast<const uint32_t*>(&b);
  lo = *reinterpret_cast<const uint32_t*>(&s);
}

// Fragment layout of mma.m16n8k16 (PTX ISA): lane l holds, of the 16 x 8
// accumulator tile, rows l / 4 (elements 0, 1) and l / 4 + 8 (elements 2,
// 3) at columns 2 (l % 4) and 2 (l % 4) + 1; two adjacent accumulator
// tiles of a row are the A fragment of the 16 columns they cover.  The
// ldmatrix lanes below feed row (lane % 8) of matrix lane / 8:
//   a_*: an A tile stored [m][k]  (and a B tile stored [k][n], .trans)
//   b_*: a B tile stored [n][k]   (and an A tile stored [k][m], .trans)
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8) {}
};

// S (np x pp) = B^T (coef x), B^T from bs by ldmatrix.trans, coef x as hi +
// lo parts; warp w takes the 16-row tiles w, w + 4, ...  Each lane stores
// its accumulator pairs straight to out (row stride p): a quad's four
// float2 fill one 32-byte sector.
__device__ __forceinline__ void state_product(const Layout& L, const bf16* bs,
                                              const bf16* xh, const bf16* xl,
                                              int n, int pw, int len,
                                              float* out, int p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Lanes ln(lane);
  const int np = up16(n), pp = up16(pw);
  const int ksteps = (len + 15) / 16;
  for (int mt = warp; mt < np / 16; mt += kThreads / 32) {
    for (int pc = 0; pc < pp; pc += 64) {
      const int nt = min(8, (pp - pc) / 8);
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4_trans(bs + (ks * 16 + ln.b_row) * L.ldb + mt * 16 + ln.b_col,
                          a0, a1, a2, a3);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (j >= nt) break;
          const int off = (ks * 16 + ln.a_row) * L.ldx + pc + j * 8 + ln.a_col;
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(xh + off, b0, b1, b2, b3);
          mma(acc[j], a0, a1, a2, a3, b0, b1);
          mma(acc[j + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4_trans(xl + off, b0, b1, b2, b3);
          mma(acc[j], a0, a1, a2, a3, b0, b1);
          mma(acc[j + 1], a0, a1, a2, a3, b2, b3);
        }
      }
      const int r0 = mt * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nt) break;
        const int col = pc + j * 8 + 2 * (lane & 3);
        if (col >= pw) continue;
        if (r0 < n)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r0) * p + col) =
              make_float2(acc[j][0], acc[j][1]);
        if (r0 + 8 < n)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r0 + 8) * p + col) =
              make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// The warp's rows q0 .. q0 + 15 of C B^T, key tiles 0 .. 2 (w + 1) - 1
// (keys past the warp's last row are never needed), in sc.
__device__ __forceinline__ void cb_product(const Layout& L, const bf16* cs,
                                           const bf16* bs, float (&sc)[8][4],
                                           int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Lanes ln(lane);
  const int q0 = warp * 16, npair = warp + 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  for (int kd = 0; kd < up16(n); kd += 16) {
    uint32_t a0, a1, a2, a3;
    ldmatrix_x4(cs + (q0 + ln.a_row) * L.ldb + kd + ln.a_col, a0, a1, a2, a3);
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) {
      if (pr >= npair) break;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(bs + (pr * 16 + ln.b_row) * L.ldb + kd + ln.b_col, b0, b1, b2, b3);
      mma(sc[2 * pr], a0, a1, a2, a3, b0, b1);
      mma(sc[2 * pr + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// W = (C B^T) exp(cum_q - cum_r) dt_r on r <= q < len, same segment
__device__ __forceinline__ void decay_mask(float (&sc)[8][4], const double* cum,
                                           const float* dts, const int* seg,
                                           int len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = warp * 16, npair = warp + 1;
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= 2 * npair) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + g + (e >= 2 ? 8 : 0);
      const int r = j * 8 + 2 * cq + (e & 1);
      const bool keep = r <= q && q < len && seg[q] == seg[r];
      sc[j][e] = keep ? sc[j][e] * expf(static_cast<float>(cum[q] - cum[r])) * dts[r] : 0.f;
    }
  }
}

// y rows of the warp for the block's pw columns: y = inter (C M) + W x +
// D x, with W in sc, stored straight from the fragments, two bf16 a lane.
__device__ __forceinline__ void y_out(const Layout& L, const bf16* xs,
                                      const bf16* cs, const bf16* mh,
                                      const bf16* ml, const float (&sc)[8][4],
                                      const float* inter, bool has_prev,
                                      float dskip, int n, int pw, int len,
                                      bf16* y, size_t y_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Lanes ln(lane);
  const int q0 = warp * 16, npair = warp + 1;
  const int np = up16(n), pp = up16(pw);
  const int g = lane >> 2, cq = lane & 3;
  const float in_lo = inter[q0 + g], in_hi = inter[q0 + g + 8];

  for (int pc = 0; pc < pp; pc += 64) {
    const int nt = min(8, (pp - pc) / 8);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (has_prev) {
      // inter_q c_q M: C from cs, M as hi + lo parts
      for (int kd = 0; kd < np; kd += 16) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(cs + (q0 + ln.a_row) * L.ldb + kd + ln.a_col, a0, a1, a2, a3);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (j >= nt) break;
          const int off = (kd + ln.a_row) * L.ldx + pc + j * 8 + ln.a_col;
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(mh + off, b0, b1, b2, b3);
          mma(acc[j], a0, a1, a2, a3, b0, b1);
          mma(acc[j + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4_trans(ml + off, b0, b1, b2, b3);
          mma(acc[j], a0, a1, a2, a3, b0, b1);
          mma(acc[j + 1], a0, a1, a2, a3, b2, b3);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= in_lo;
        acc[j][1] *= in_lo;
        acc[j][2] *= in_hi;
        acc[j][3] *= in_hi;
      }
    }
    // W x: W's A fragments from the score registers, as hi + lo parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= npair) break;
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], h0, l0);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], h1, l1);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], h2, l2);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], h3, l3);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j >= nt) break;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(xs + (kk * 16 + ln.a_row) * L.ldx + pc + j * 8 + ln.a_col,
                          b0, b1, b2, b3);
        mma(acc[j], h0, h1, h2, h3, b0, b1);
        mma(acc[j + 1], h0, h1, h2, h3, b2, b3);
        mma(acc[j], l0, l1, l2, l3, b0, b1);
        mma(acc[j + 1], l0, l1, l2, l3, b2, b3);
      }
    }
    // + D x, stored straight from the fragments, two bf16 a lane
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt) break;
      const int col = pc + j * 8 + 2 * cq;
      if (col >= pw) continue;
      const int lo_r = q0 + g, hi_r = q0 + g + 8;
      const float2 xlo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + lo_r * L.ldx + col));
      const float2 xhi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + hi_r * L.ldx + col));
      if (lo_r < len)
        *reinterpret_cast<__nv_bfloat162*>(y + lo_r * y_stride + col) =
            __floats2bfloat162_rn(acc[j][0] + dskip * xlo.x, acc[j][1] + dskip * xlo.y);
      if (hi_r < len)
        *reinterpret_cast<__nv_bfloat162*>(y + hi_r * y_stride + col) =
            __floats2bfloat162_rn(acc[j][2] + dskip * xhi.x, acc[j][3] + dskip * xhi.y);
    }
  }
}

}  // namespace tc

// -- float32: CUDA cores ------------------------------------------------------

namespace f32 {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// S (n x pw) = sum_r coef_r b_r x_r^T into out (row stride p), 4 x 4
// register tiles
__device__ void state_product(const Layout& L, const float* xs, const float* bs,
                              const float* coef, int n, int pw, int len,
                              float* out, int p) {
  const int pt = pw / 4;
  for (int tile = threadIdx.x; tile < (n / 4) * pt; tile += kThreads) {
    const int n0 = (tile / pt) * 4, c0 = (tile % pt) * 4;
    float acc[4][4] = {};
    for (int r = 0; r < len; ++r) {
      const float cf = coef[r];
      const float4 bv = ld4(bs + r * L.ldb + n0);
      const float4 xv = ld4(xs + r * pw + c0);
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
      *reinterpret_cast<float4*>(out + static_cast<size_t>(n0 + i) * p + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// W into shared memory: thread (qi, rj) takes rows 4 qi + i and columns
// rj + 16 j
__device__ void w_product(const Layout& L, const float* bs, const float* cs,
                          float* w, const double* cum, const float* dts,
                          const int* seg, int n, int len) {
  constexpr int ws = kT + 4;
  for (int tile = threadIdx.x; tile < (kT / 4) * 16; tile += kThreads) {
    const int q0 = (tile / 16) * 4, rj = tile % 16;
    float acc[4][4] = {};
    if (rj <= q0 + 3 && q0 < len) {
      for (int c = 0; c < n; c += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (q0 + i) * L.ldb + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(bs + (rj + 16 * j) * L.ldb + c);
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
}

// y = W x + inter (C M) + D x for the block's pw columns
__device__ void y_product(const Layout& L, const float* xs, const float* cs,
                          const float* w, const float* m, const float* inter,
                          bool has_prev, float dskip, int n, int pw, int len,
                          float* y, size_t y_stride) {
  constexpr int ws = kT + 4;
  const int pt = pw / 4;
  for (int tile = threadIdx.x; tile < (kT / 4) * pt; tile += kThreads) {
    const int q0 = (tile / pt) * 4, c0 = (tile % pt) * 4;
    if (q0 >= len) continue;
    float acc[4][4] = {}, acc2[4][4] = {};
    const int rmax = min(q0 + 4, len);
    for (int r = 0; r < rmax; ++r) {
      const float4 xv = ld4(xs + r * pw + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv = w[(q0 + i) * ws + r];
        acc[i][0] += wv * xv.x;
        acc[i][1] += wv * xv.y;
        acc[i][2] += wv * xv.z;
        acc[i][3] += wv * xv.w;
      }
    }
    if (has_prev) {
      for (int c = 0; c < n; c += 4) {
        float4 cv[4], mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (q0 + i) * L.ldb + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k] = ld4(m + (c + k) * pw + c0);
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
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + i;
      if (q >= len) break;
      const float f = inter[q];
      const float4 xv = ld4(xs + q * pw + c0);
      *reinterpret_cast<float4*>(y + q * y_stride + c0) = make_float4(
          acc[i][0] + f * acc2[i][0] + dskip * xv.x,
          acc[i][1] + f * acc2[i][1] + dskip * xv.y,
          acc[i][2] + f * acc2[i][2] + dskip * xv.z,
          acc[i][3] + f * acc2[i][3] + dskip * xv.w);
    }
  }
}

}  // namespace f32

// What a chunk's prefix sums end on: the sum of A dt over the chunk and the
// segment id of its last step.
struct ChunkEnd {
  double total;
  int seg_end;
  // [no reset in the chunk] exp(total): what carries a state across it
  __device__ float carry() const {
    return seg_end == 0 ? expf(static_cast<float>(total)) : 0.f;
  }
};

// Called by every lane of one warp, 2 steps a lane: the in-chunk prefix sums
// of A dt (float64) and of the resets (seg holds each step's reset flag on
// entry and its segment id on return), then the per-step factors inter (of
// the entering state) and coef (of the chunk's own state), both 0 past len.
__device__ __forceinline__ ChunkEnd chunk_rows(float av, int len,
                                               const float* dts, double* cum,
                                               int* seg, float* inter,
                                               float* coef) {
  const int lane = threadIdx.x & 31;
  const int i0 = 2 * lane, i1 = i0 + 1;
  const float dt0 = dts[i0], dt1 = dts[i1];
  const double v0 = av * dt0, v1 = av * dt1;
  const int r0 = seg[i0], r1 = seg[i1];
  double sv = v0 + v1;
  int sr = r0 + r1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double tv = __shfl_up_sync(kFull, sv, o);
    const int tr = __shfl_up_sync(kFull, sr, o);
    if (lane >= o) { sv += tv; sr += tr; }
  }
  double ev = __shfl_up_sync(kFull, sv, 1);
  int er = __shfl_up_sync(kFull, sr, 1);
  if (lane == 0) { ev = 0.0; er = 0; }
  const double c0 = ev + v0, c1 = (ev + v0) + v1;
  const int s0 = er + r0, s1 = er + r0 + r1;
  const int last = len - 1;
  const double total = __shfl_sync(kFull, (last & 1) ? c1 : c0, last >> 1);
  const int seg_end = __shfl_sync(kFull, (last & 1) ? s1 : s0, last >> 1);
  cum[i0] = c0;
  cum[i1] = c1;
  seg[i0] = s0;
  seg[i1] = s1;
  inter[i0] = (i0 < len && s0 == 0) ? expf(static_cast<float>(c0)) : 0.f;
  inter[i1] = (i1 < len && s1 == 0) ? expf(static_cast<float>(c1)) : 0.f;
  coef[i0] = (i0 < len && s0 == seg_end)
                 ? expf(static_cast<float>(total - c0)) * dt0 : 0.f;
  coef[i1] = (i1 < len && s1 == seg_end)
                 ? expf(static_cast<float>(total - c1)) * dt1 : 0.f;
  return ChunkEnd{total, seg_end};
}

// One block per (chunk x column group, head, batch row).  kOne: y and the
// final state of a one-chunk sequence; kState: the chunk's state and carry;
// kScan: y from the state entering the chunk; kAdjoint: U of chunks 1..
// (chunk_adjoint).  Every global load is issued before the first barrier:
// the scalars, the per-step dt and resets, and the tiles (cp.async), so
// their latencies overlap.
template <typename T, int kMode>
__device__ __forceinline__ void chunk_body(const Params& a) {
  extern __shared__ uint4 smem16[];
  char* base = reinterpret_cast<char*>(smem16);
  constexpr int kLay = kMode == kAdjoint ? kState : kMode;   // its layout
  const int cgs = a.col_groups;
  const int ch = blockIdx.x / cgs + (kMode == kAdjoint), cg = blockIdx.x % cgs;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int n = a.n, p = a.p, heads = a.heads;
  const int pw = p / cgs, p0 = cg * pw;
  const int t0 = ch * kT, len = min(kT, a.s_len - t0);
  const int grp = h / (heads / a.groups);
  const size_t row0 = static_cast<size_t>(bb) * a.s_len + t0;
  const size_t bh = static_cast<size_t>(bb) * heads + h;
  const Layout L = layout<T>(kLay, n, pw);
  constexpr bool kTensor = sizeof(T) == 2;
  double* cum = reinterpret_cast<double*>(base + L.cum);
  float* dts = reinterpret_cast<float*>(base + L.dts);
  float* inter = reinterpret_cast<float*>(base + L.inter);
  float* coef = reinterpret_cast<float*>(base + L.coef);
  int* seg = reinterpret_cast<int*>(base + L.seg);
  T* xs = reinterpret_cast<T*>(base + L.xs);
  T* bs = reinterpret_cast<T*>(base + L.bs);
  T* cs = reinterpret_cast<T*>(base + L.cs);

  // 1. the head's scalars, the chunk's dt and resets, and its x, B, C
  //    tiles (and, for float32 kScan, the entering state); rows past len
  //    and padding columns are zeros
  const float av = -expf(a.a_log[h]);
  const float dskip = a.d_skip[h];
  if (tid < kT) {
    const bool live = tid < len;
    dts[tid] = live ? a.dt[(row0 + tid) * heads + h] : 0.f;
    seg[tid] = (a.reset != nullptr && live) ? (a.reset[row0 + tid] != 0) : 0;
  }
  const int xpad = kTensor ? up16(pw) : pw;
  const int npad = kTensor ? up16(n) : n;
  load_tile<T>(xs, L.ldx, kT, xpad,
               static_cast<const T*>(a.x) + (row0 * heads + h) * p + p0,
               static_cast<size_t>(heads) * p, len, pw);
  const size_t bc_off = (row0 * a.groups + grp) * n;
  const size_t bc_stride = static_cast<size_t>(a.groups) * n;
  load_tile<T>(bs, L.ldb, kT, npad, static_cast<const T*>(a.b) + bc_off,
               bc_stride, len, n);
  if (kLay != kState)
    load_tile<T>(cs, L.ldb, kT, npad, static_cast<const T*>(a.c) + bc_off,
                 bc_stride, len, n);
  const bool has_prev = kMode == kScan && ch > 0;
  const size_t slot = (bh * a.chunks + ch) * n * p;   // of the entering state
  if (!kTensor && has_prev)
    load_tile<float>(reinterpret_cast<float*>(base + L.m), pw, n, pw,
                     a.chunk_states + slot + p0, p, n, pw);
  cp_async_wait<0>();
  __syncthreads();

  // 2. one warp: the in-chunk prefix sums and per-step factors, and the
  //    chunk's carry
  if (tid < 32) {
    if constexpr (kMode == kAdjoint) {    // inter is U's factor: in coef's place
      chunk_rows(av, len, dts, cum, seg, coef, inter);
    } else {
      const ChunkEnd e = chunk_rows(av, len, dts, cum, seg, inter, coef);
      if (kMode == kState && tid == 0 && cg == 0)
        a.carry[bh * a.chunks + ch] = e.carry();
    }
  }
  __syncthreads();

  // 3. the chunk's state (kOne: the final state; kState: scratch; kAdjoint:
  //    U into the scratch slot of the chunk, inter in coef's place)
  if (kMode != kScan) {
    float* out = kMode == kOne ? a.state + bh * n * p + p0
                               : a.chunk_states + (bh * a.chunks + ch) * n * p + p0;
    if constexpr (kTensor) {
      bf16* xh = reinterpret_cast<bf16*>(base + L.xh);
      bf16* xl = reinterpret_cast<bf16*>(base + L.xl);
      const bf16* xb = reinterpret_cast<const bf16*>(xs);
      const int pp = up16(pw);
      for (int i = tid; i < kT * (pp / 2); i += kThreads) {
        const int r = i / (pp / 2), j = (i % (pp / 2)) * 2;
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xb + r * L.ldx + j));
        uint32_t hi, lo;
        tc::split_bf16(coef[r] * v.x, coef[r] * v.y, hi, lo);
        *reinterpret_cast<uint32_t*>(xh + r * L.ldx + j) = hi;
        *reinterpret_cast<uint32_t*>(xl + r * L.ldx + j) = lo;
      }
      __syncthreads();
      tc::state_product(L, reinterpret_cast<const bf16*>(bs), xh, xl, n, pw,
                        len, out, p);
    } else {
      f32::state_product(L, reinterpret_cast<const float*>(xs),
                         reinterpret_cast<const float*>(bs), coef, n, pw, len,
                         out, p);
    }
  }

  // 4. y
  if (kLay != kState) {
    const size_t y_stride = static_cast<size_t>(heads) * p;
    T* yb = static_cast<T*>(a.y) + (row0 * heads + h) * p + p0;
    if constexpr (kTensor) {
      // C.B^T, then (kScan) the entering state's hi and lo parts are copied
      // over B's tile while the decay mask is applied, then y
      const bool rows = (tid >> 5) * 16 < len;   // the warp has live rows
      bf16* mh = reinterpret_cast<bf16*>(base + L.mh);
      bf16* ml = reinterpret_cast<bf16*>(base + L.ml);
      float sc[8][4];
      if (rows)
        tc::cb_product(L, reinterpret_cast<const bf16*>(cs),
                       reinterpret_cast<const bf16*>(bs), sc, n);
      if (kMode == kScan) {
        __syncthreads();   // every warp is done with B's tile
        if (has_prev) {
          load_tile<bf16>(mh, L.ldx, npad, xpad, a.entering + 2 * slot + p0,
                          p, n, pw);
          load_tile<bf16>(ml, L.ldx, npad, xpad,
                          a.entering + 2 * slot + static_cast<size_t>(n) * p + p0,
                          p, n, pw);
        }
      }
      if (rows) tc::decay_mask(sc, cum, dts, seg, len);
      if (kMode == kScan) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (rows)
        tc::y_out(L, reinterpret_cast<const bf16*>(xs),
                  reinterpret_cast<const bf16*>(cs), mh, ml, sc, inter,
                  has_prev, dskip, n, pw, len, reinterpret_cast<bf16*>(yb),
                  y_stride);
    } else {
      float* w = reinterpret_cast<float*>(base + L.w);
      f32::w_product(L, reinterpret_cast<const float*>(bs),
                     reinterpret_cast<const float*>(cs), w, cum, dts, seg, n,
                     len);
      __syncthreads();
      f32::y_product(L, reinterpret_cast<const float*>(xs),
                     reinterpret_cast<const float*>(cs), w,
                     reinterpret_cast<const float*>(base + L.m), inter,
                     has_prev, dskip, n, pw, len, reinterpret_cast<float*>(yb),
                     y_stride);
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const Params a) {
  chunk_body<T, kMode>(a);
}

// The backward's U pass.  The bound of two blocks an SM (they fit in
// registers and shared memory) keeps ptxas from spilling the output
// pointer, which it does at this mode under chunk_kernel's bound.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_adjoint(const Params a) {
  chunk_body<T, kAdjoint>(a);
}

// The state pass: per (head, batch row), M_c = carry_c M_{c-1} + S_c over
// the chunks in order, four elements a thread; the last M is the final
// state.  The state entering chunk c >= 1 goes where the output pass reads
// it: for bf16 x, split into hi and lo bf16 parts (slot c of entering,
// the layout the tensor cores take, so the output pass copies it with
// cp.async); for float32 x, and for the backward, which reads float32
// states, in place of S_c.  Loads run 8 chunks ahead of the chain.  A null
// state skips the final state (the backward has no use for it).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
state_pass(const float* __restrict__ carry, float* chunk_states,
           bf16* __restrict__ entering, float* __restrict__ state, int chunks,
           int np4) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= np4) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const size_t np = static_cast<size_t>(np4) * 4;
  const float* cr = carry + bh * chunks;
  float4* s = reinterpret_cast<float4*>(chunk_states) + bh * chunks * np4 + e;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < chunks; c0 += 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < chunks) v[i] = s[static_cast<size_t>(c0 + i) * np4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      if (c >= chunks) break;
      if (c > 0) {
        if constexpr (kSplit) {
          uint32_t h0, l0, h1, l1;
          tc::split_bf16(m.x, m.y, h0, l0);
          tc::split_bf16(m.z, m.w, h1, l1);
          bf16* slot = entering + (bh * chunks + c) * 2 * np + 4 * static_cast<size_t>(e);
          *reinterpret_cast<uint2*>(slot) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(slot + np) = make_uint2(l0, l1);
        } else {
          s[static_cast<size_t>(c) * np4] = m;
        }
      }
      const float k = cr[c];
      m = make_float4(k * m.x + v[i].x, k * m.y + v[i].y, k * m.z + v[i].z,
                      k * m.w + v[i].w);
    }
  }
  if (state != nullptr) reinterpret_cast<float4*>(state)[bh * np4 + e] = m;
}

template <typename T, int kMode>
cudaError_t launch_chunk(const Params& a, int batch, cudaStream_t stream) {
  const int pw = a.p / a.col_groups;
  const size_t bytes = layout<T>(kMode == kAdjoint ? kState : kMode, a.n, pw).bytes;
  void (*kernel)(Params);
  if constexpr (kMode == kAdjoint)
    kernel = chunk_adjoint<T>;
  else
    kernel = chunk_kernel<T, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = kMode == kAdjoint ? a.chunks - 1 : a.chunks;
  const dim3 grid(blocks * a.col_groups, a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& a, int batch, cudaStream_t stream) {
  if (a.chunks == 1) return launch_chunk<T, kOne>(a, batch, stream);
  cudaError_t err = launch_chunk<T, kState>(a, batch, stream);
  if (err != cudaSuccess) return err;
  const int np4 = a.n * a.p / 4;
  const dim3 grid((np4 + kThreads - 1) / kThreads, a.heads, batch);
  state_pass<sizeof(T) == 2><<<grid, kThreads, 0, stream>>>(
      a.carry, a.chunk_states, a.entering, a.state, a.chunks, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_chunk<T, kScan>(a, batch, stream);
}

// -- the backward ----------------------------------------------------------------
//
// ssd_scan_backward_launch gives the gradients of (y, final state).  Where
// S > kT it recomputes the states entering each chunk (chunk_kernel<kState>
// and state_pass, float32 in place), forms each chunk's U = C^T (inter dY)
// (chunk_adjoint: the kState pass with (C, inter, dY) in place of (B, coef,
// x), so for bf16 on the tensor cores) and walks the chunks
// backward for D, the adjoint leaving each chunk (adjoint_pass); then one
// block per (chunk, head, batch row) forms the chunk's dx, ddt and its
// head's shares of db and dc (chunk_backward_tc for bf16, chunk_backward_f32
// for float32, whose FMA loops hold 1e-4 where TF32 would not), and
// grad_reduce sums db and dc over each group's heads and dA and dD over
// (batch row, chunk) in a fixed order.  No atomics: two calls give the same
// bits.
//
// Bound.  At mamba2's training microbatch (B4 S512 H64 P64 G1 N128 bf16, y's
// cotangent only) the function moves 53.5 MB (0.016 ms at 3.35 TB/s) and
// does 14.0 GFLOP (0.014 ms at the bf16 tensor-core rate).  The design adds
// float32 scratch, each 67 MB there: the entering states and the adjoints
// (B, H, chunks, N, P) and each head's shares of db and dc (B, S, H, N),
// written once and read once or twice, about 0.23 ms at 3.35 TB/s before L2
// hits.  That traffic and the latency of each block's chain of phases, not
// the arithmetic, bound the call now: on an H100 it takes 0.48-0.49 ms, of
// which chunk_backward_tc is 0.245 and its products (ablated one group at a
// time) about 0.1 (PERF.md, section 6, row 7).  What the bf16 design does
// about it: every product runs on the tensor cores (mma.sync m16n8k16, the
// float32 operands W, dCB, D, M and inter dY as hi + lo bf16 parts, as in
// the forward); the tiles are bf16, copied by cp.async; the per-step sums
// are quad shuffles on the accumulator fragments and one partial per
// (tile or warp, step), summed in a fixed order, not 16 lanes' arrays; D and
// M go from the scratch straight into B fragments, each element loaded by
// one warp of a phase, never staged, so a block takes 97,616 B of shared
// memory and two blocks of 8 warps share an SM, one block's loads under the
// other's products; the adjoint pass loads 8 chunks ahead of its chain.

constexpr int kBThreads = 256;   // 8 warps
constexpr int kWarps = kBThreads / 32;
constexpr int kLanes = 16;       // float32: column lanes, each row's partial sums
constexpr int kLd = kT + 4;      // float32: row stride of the W and dCB tiles
constexpr int kTiles = 10;       // bf16: the causal 16 x 16 tiles of a chunk

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

struct BwdParams {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d_skip;
  const uint8_t* reset;
  const void* dy;          // (B, S, H, P), x's type
  const float* dstate;     // (B, H, N, P), or null: no final-state gradient
  void* dx;                // (B, S, H, P), x's type
  float* ddt;              // (B, S, H)
  float* da_log;           // (H,)
  void* db;                // (B, S, G, N), x's type
  void* dc;
  float* dd_skip;          // (H,)
  float* chunk_states;     // (B, H, chunks, N, P): the states entering chunks
  float* carry;            // (B, H, chunks)
  float* adj;              // (B, H, chunks, N, P): the adjoints leaving chunks
  float* db_part;          // (B, S, H, N): each head's share of db
  float* dc_part;
  float* head_part;        // (2, B, chunks, H): dA and dD of each block
  int batch, s_len, heads, groups, n, p, chunks;
};

// the sum over the warp, the same on every lane, in a fixed order
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The end both chunk_backward kernels share, one warp, 2 steps a lane: from
// each step's sums -- rs of G's row off the diagonal times dt_r, cs of its
// column, co = dcoef and it = dinter -- and the carry's gradient <D, M>,
// dcum, its reverse cumulative sum dl (float64, the gradient of A dt_q),
// ddt, and the block's shares of dA and dD.
__device__ void chunk_tail(const BwdParams& a, const ChunkEnd e, double dcarry,
                           int ch, int len, size_t row0, float av,
                           const double* cum, const float* dts,
                           const float* inter, const float* coef,
                           const int* seg, const float* diag,
                           const float* sdiag, const double (&rs)[2],
                           const double (&cs)[2], const double (&co)[2],
                           const double (&it)[2]) {
  const int lane = threadIdx.x & 31, h = blockIdx.y, bb = blockIdx.z;
  const int heads = a.heads;
  double d[2];
  double ksum = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = 2 * lane + k;
    const double kq = co[k] * coef[q];
    d[k] = q < len ? rs[k] - dts[q] * cs[k] + inter[q] * it[k] - kq : 0.0;
    ksum += q < len ? kq : 0.0;
  }
  ksum = warp_sum(ksum);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (2 * lane + k == len - 1) d[k] += ksum + e.carry() * dcarry;
  double sv = d[0] + d[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_down_sync(kFull, sv, o);
    if (lane + o < 32) sv += t;
  }
  double ex = __shfl_down_sync(kFull, sv, 1);
  if (lane == 31) ex = 0.0;
  const double dl[2] = {ex + d[1] + d[0], ex + d[1]};
  double da_part = 0.0, dd_part = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = 2 * lane + k;
    if (q >= len) continue;
    const float to_end = seg[q] == e.seg_end
                             ? expf(static_cast<float>(e.total - cum[q])) : 0.f;
    a.ddt[(row0 + q) * heads + h] = static_cast<float>(
        cs[k] + diag[q] + co[k] * to_end + av * dl[k]);
    da_part += dts[q] * dl[k];
    dd_part += sdiag[q];
  }
  da_part = warp_sum(da_part);
  dd_part = warp_sum(dd_part);
  if (lane == 0) {
    const size_t slot = (static_cast<size_t>(bb) * a.chunks + ch) * heads + h;
    const size_t half = static_cast<size_t>(a.batch) * a.chunks * heads;
    a.head_part[slot] = static_cast<float>(da_part);
    a.head_part[half + slot] = static_cast<float>(dd_part);
  }
}

// The adjoint pass, the state pass run backward: per (head, batch row),
// from the final state's gradient (or 0), slot c of adj becomes D_c, the
// gradient reaching the state that leaves chunk c from later steps, and
// D_{c-1} = carry_c D_c + U_c; four elements a thread.  Loads run 8 chunks
// ahead of the chain, as in the state pass.
__global__ void __launch_bounds__(kThreads)
adjoint_pass(const float* __restrict__ carry, float* adj,
             const float* __restrict__ dstate, int chunks, int np4) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= np4) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const float* cr = carry + bh * chunks;
  float4* s = reinterpret_cast<float4*>(adj) + bh * chunks * np4 + e;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 m = dstate != nullptr
                 ? reinterpret_cast<const float4*>(dstate)[bh * np4 + e]
                 : zero4;
  for (int c0 = chunks - 1; c0 >= 0; c0 -= 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = c0 - i > 0 ? s[static_cast<size_t>(c0 - i) * np4] : zero4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 - i;
      if (c < 0) break;
      s[static_cast<size_t>(c) * np4] = m;
      const float k = cr[c];
      m = make_float4(k * m.x + v[i].x, k * m.y + v[i].y, k * m.z + v[i].z,
                      k * m.w + v[i].w);
    }
  }
}

// -- float32: CUDA cores --

// Byte offsets of a float32 backward block's shared memory (kernels/
// ssd_scan.py::backward_shared_bytes mirrors it): the per-step rows, the 16
// column lanes' partial sums of four per-step dot products, then the
// float32 tiles: C, dY, X, B, the entering state, the leaving adjoint, W
// and dCB.
struct BwdLayout {
  int ldx, ldn;          // row strides of the (kT x P) and (kT x N) tiles
  size_t cum, dts, inter, coef, seg, sdiag, diag, rowp, colp, coefp,
      interp, red, cs, dys, xs, bs, mp, dm, w, dcb, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int n, int p) {
  BwdLayout L{};
  L.ldx = p + 4;
  L.ldn = n + 4;
  size_t o = 0;
  L.cum = take(o, kT * 8);
  L.dts = take(o, kT * 4);
  L.inter = take(o, kT * 4);
  L.coef = take(o, kT * 4);
  L.seg = take(o, kT * 4);
  L.sdiag = take(o, kT * 4);
  L.diag = take(o, kT * 4);
  L.rowp = take(o, kT * kLanes * 4);
  L.colp = take(o, kT * kLanes * 4);
  L.coefp = take(o, kT * kLanes * 4);
  L.interp = take(o, kT * kLanes * 4);
  L.red = take(o, 32 * 8);
  L.cs = take(o, static_cast<size_t>(kT) * L.ldn * 4);
  L.dys = take(o, static_cast<size_t>(kT) * L.ldx * 4);
  L.xs = take(o, static_cast<size_t>(kT) * L.ldx * 4);
  L.bs = take(o, static_cast<size_t>(kT) * L.ldn * 4);
  L.mp = take(o, static_cast<size_t>(n) * p * 4);
  L.dm = take(o, static_cast<size_t>(n) * p * 4);
  L.w = take(o, kT * kLd * 4);
  L.dcb = take(o, kT * kLd * 4);
  L.bytes = o;
  return L;
}

// dst[r][j] (row stride ld) = src[r * stride + j] for r < rows, zeros for
// rows .. rows_pad - 1; j < width
__device__ void load_rows(float* dst, int ld, int rows_pad, int width,
                          const float* src, size_t stride, int rows) {
  for (int i = threadIdx.x; i < rows_pad * width; i += blockDim.x) {
    const int r = i / width, j = i - r * width;
    dst[r * ld + j] = r < rows ? src[r * stride + j] : 0.f;
  }
}

using f32::at;
using f32::ld4;

// The chunk's gradients for float32 x; one block per (chunk, head, batch
// row), thread (row tile rt, lane cl) takes steps 4 rt .. 4 rt + 3 and the
// column tiles cl, cl + 16, ... of each product, and keeps its per-row
// partial sums in lane cl's column, so that every sum is taken in one fixed
// order.  With S = C.B^T and dS = dY.X^T over the causal triangle, E the
// masked decay, V = dS E: W = S E dt_r, dCB = V dt_r, G = V S dt_r; then
//   dX_r  = sum_q W_qr dY_q + coef_r (B_r D) + D_h dY_r
//   dB_r  = sum_q dCB_qr C_q + coef_r (D X_r)     (this head's share)
//   dC_q  = sum_r dCB_qr B_r + inter_q (M dY_q)   (this head's share)
// and the gradient of the prefix sums, dcum_q = sum_{r<q} G_qr -
// sum_{r>q} G_rq + inter_q dinter_q - coef_q dcoef_q, plus at the last
// step sum_r coef_r dcoef_r + carry <D, M>, whose reverse cumulative sum
// (float64) is the gradient of each step's A dt (chunk_tail).
__global__ void __launch_bounds__(kBThreads)
chunk_backward_f32(const BwdParams a) {
  extern __shared__ uint4 smem16[];
  char* base = reinterpret_cast<char*>(smem16);
  __shared__ ChunkEnd end;
  __shared__ double dcarry;
  const int h = blockIdx.y, bb = blockIdx.z, tid = threadIdx.x;
  const int n = a.n, p = a.p, heads = a.heads, ch = blockIdx.x;
  const BwdLayout L = bwd_layout(n, p);
  const size_t bh = static_cast<size_t>(bb) * heads + h;
  const float av = -expf(a.a_log[h]);
  const float dskip = a.d_skip[h];
  const bool has_prev = ch > 0;
  const float* dm_src = a.chunks > 1 ? a.adj + (bh * a.chunks + ch) * n * p
                        : (a.dstate != nullptr ? a.dstate + bh * n * p : nullptr);
  const bool has_dm = dm_src != nullptr;
  const int t0 = ch * kT, len = min(kT, a.s_len - t0);
  const size_t row0 = static_cast<size_t>(bb) * a.s_len + t0;
  const int grp = h / (heads / a.groups);
  double* cum = reinterpret_cast<double*>(base + L.cum);
  float* dts = reinterpret_cast<float*>(base + L.dts);
  float* inter = reinterpret_cast<float*>(base + L.inter);
  float* coef = reinterpret_cast<float*>(base + L.coef);
  int* seg = reinterpret_cast<int*>(base + L.seg);
  float* cs = reinterpret_cast<float*>(base + L.cs);
  float* dys = reinterpret_cast<float*>(base + L.dys);
  float* xs = reinterpret_cast<float*>(base + L.xs);
  float* bs = reinterpret_cast<float*>(base + L.bs);
  float* mp = reinterpret_cast<float*>(base + L.mp);
  float* dm = reinterpret_cast<float*>(base + L.dm);
  float* sdiag = reinterpret_cast<float*>(base + L.sdiag);
  float* diag = reinterpret_cast<float*>(base + L.diag);
  float* rowp = reinterpret_cast<float*>(base + L.rowp);
  float* colp = reinterpret_cast<float*>(base + L.colp);
  float* coefp = reinterpret_cast<float*>(base + L.coefp);
  float* interp = reinterpret_cast<float*>(base + L.interp);
  double* red = reinterpret_cast<double*>(base + L.red);
  float* w = reinterpret_cast<float*>(base + L.w);
  float* dcb = reinterpret_cast<float*>(base + L.dcb);

  // 0. the chunk's dt and resets, its C, dY, X and B rows (zero past len),
  //    the entering state and the leaving adjoint; then one warp: the
  //    prefix sums and factors
  if (tid < kT) {
    const bool live = tid < len;
    dts[tid] = live ? a.dt[(row0 + tid) * heads + h] : 0.f;
    seg[tid] = (a.reset != nullptr && live) ? (a.reset[row0 + tid] != 0) : 0;
  }
  const float* bc = static_cast<const float*>(a.c) + (row0 * a.groups + grp) * n;
  const size_t bc_stride = static_cast<size_t>(a.groups) * n;
  const size_t xo = (row0 * heads + h) * p, x_stride = static_cast<size_t>(heads) * p;
  load_rows(cs, L.ldn, kT, n, bc, bc_stride, len);
  load_rows(dys, L.ldx, kT, p, static_cast<const float*>(a.dy) + xo, x_stride, len);
  load_rows(xs, L.ldx, kT, p, static_cast<const float*>(a.x) + xo, x_stride, len);
  load_rows(bs, L.ldn, kT, n,
            static_cast<const float*>(a.b) + (row0 * a.groups + grp) * n,
            bc_stride, len);
  if (has_prev)
    load_rows(mp, p, n, p, a.chunk_states + (bh * a.chunks + ch) * n * p, p, n);
  if (has_dm) load_rows(dm, p, n, p, dm_src, p, n);
  __syncthreads();
  if (tid < 32) {
    const ChunkEnd e = chunk_rows(av, len, dts, cum, seg, inter, coef);
    if (tid == 0) end = e;
  }
  __syncthreads();
  const int rt = tid / kLanes, cl = tid % kLanes;
  const int r0 = rt * 4;        // this thread's four rows of every product

  // 1. C.B^T and dY.X^T on the tile (rows r0.., columns 4 cl..), W, dCB,
  //    and G's row and column sums off the diagonal
  {
    const int q0 = r0, k0 = cl * 4;
    const bool tri = k0 <= q0 + 3 && q0 < len;
    float sc[4][4] = {}, ds[4][4] = {};
    if (tri) {
      for (int k = 0; k < n; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (q0 + i) * L.ldn + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(bs + (k0 + j) * L.ldn + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sc[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y +
                        cv[i].z * bv[j].z + cv[i].w * bv[j].w;
      }
      for (int k = 0; k < p; k += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = ld4(dys + (q0 + i) * L.ldx + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = ld4(xs + (k0 + j) * L.ldx + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ds[i][j] += dv[i].x * xv[j].x + dv[i].y * xv[j].y +
                        dv[i].z * xv[j].z + dv[i].w * xv[j].w;
      }
    }
    float rowacc[4] = {}, colacc[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = k0 + j;
        const bool keep = tri && r <= q && q < len && seg[q] == seg[r];
        float wv = 0.f, dv = 0.f, gt = 0.f;
        if (keep) {
          const float e = expf(static_cast<float>(cum[q] - cum[r]));
          const float v = ds[i][j] * e;
          wv = sc[i][j] * e * dts[r];
          dv = v * dts[r];
          gt = v * sc[i][j];
          if (r < q) {
            rowacc[i] += gt * dts[r];
            colacc[j] += gt;
          }
        }
        if (q == r) {
          diag[q] = gt;
          sdiag[q] = keep ? ds[i][j] : 0.f;
        }
        w[q * kLd + r] = wv;
        dcb[q * kLd + r] = dv;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rowp[(q0 + i) * kLanes + cl] = rowacc[i];
      colp[(k0 + i) * kLanes + rt] = colacc[i];
    }
  }
  __syncthreads();

  // 2. dX = W^T dY + coef (B D) + D_h dY, and dcoef_r = (B_r D) . X_r
  {
    float* dx = static_cast<float*>(a.dx) + (row0 * heads + h) * p;
    float part[4] = {};
    for (int ct = cl; ct < p / 4; ct += kLanes) {
      const int p0 = ct * 4;
      float acc[4][4] = {}, bd[4][4] = {};
      if (r0 < len) {
        for (int q = r0; q < len; ++q) {
          const float4 dv = ld4(dys + q * L.ldx + p0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = w[q * kLd + r0 + i];
            acc[i][0] += wv * dv.x;
            acc[i][1] += wv * dv.y;
            acc[i][2] += wv * dv.z;
            acc[i][3] += wv * dv.w;
          }
        }
        if (has_dm) {
          for (int k = 0; k < n; k += 4) {
            float4 bv[4], mv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) bv[i] = ld4(bs + (r0 + i) * L.ldn + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) mv[kk] = ld4(dm + (k + kk) * p + p0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float bik = at(bv[i], kk);
                bd[i][0] += bik * mv[kk].x;
                bd[i][1] += bik * mv[kk].y;
                bd[i][2] += bik * mv[kk].z;
                bd[i][3] += bik * mv[kk].w;
              }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
        if (r >= len) break;
        const float4 xv = ld4(xs + r * L.ldx + p0);
        const float4 dv = ld4(dys + r * L.ldx + p0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          put(dx + static_cast<size_t>(r) * heads * p + p0 + j,
              acc[i][j] + coef[r] * bd[i][j] + dskip * at(dv, j));
          part[i] += bd[i][j] * at(xv, j);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) coefp[(r0 + i) * kLanes + cl] = part[i];
  }

  // 3. this head's dB = dCB^T C + coef (D X), and dC = dCB B + inter (M dY)
  //    with dinter_q = C_q . (M dY_q)
  {
    float* dbp = a.db_part + (row0 * heads + h) * n;
    float* dcp = a.dc_part + (row0 * heads + h) * n;
    const size_t stride = static_cast<size_t>(heads) * n;
    float part[4] = {};
    for (int ct = cl; ct < n / 4; ct += kLanes) {
      const int n0 = ct * 4;
      float acc[4][4] = {}, dxm[4][4] = {};
      if (r0 < len) {
        for (int q = r0; q < len; ++q) {
          const float4 cv = ld4(cs + q * L.ldn + n0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float g = dcb[q * kLd + r0 + i];
            acc[i][0] += g * cv.x;
            acc[i][1] += g * cv.y;
            acc[i][2] += g * cv.z;
            acc[i][3] += g * cv.w;
          }
        }
        if (has_dm) {
          for (int k = 0; k < p; k += 4) {
            float4 xv[4], mv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = ld4(xs + (r0 + i) * L.ldx + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) mv[j] = ld4(dm + (n0 + j) * p + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                dxm[i][j] += xv[i].x * mv[j].x + xv[i].y * mv[j].y +
                             xv[i].z * mv[j].z + xv[i].w * mv[j].w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= len) break;
          *reinterpret_cast<float4*>(dbp + r * stride + n0) = make_float4(
              acc[i][0] + coef[r] * dxm[i][0], acc[i][1] + coef[r] * dxm[i][1],
              acc[i][2] + coef[r] * dxm[i][2], acc[i][3] + coef[r] * dxm[i][3]);
        }
      }
      float acc2[4][4] = {}, mdy[4][4] = {};
      if (r0 < len) {
        const int rmax = min(r0 + 4, len);
        for (int r = 0; r < rmax; ++r) {
          const float4 bv = ld4(bs + r * L.ldn + n0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float g = dcb[(r0 + i) * kLd + r];
            acc2[i][0] += g * bv.x;
            acc2[i][1] += g * bv.y;
            acc2[i][2] += g * bv.z;
            acc2[i][3] += g * bv.w;
          }
        }
        if (has_prev) {
          for (int k = 0; k < p; k += 4) {
            float4 dv[4], mv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) dv[i] = ld4(dys + (r0 + i) * L.ldx + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) mv[j] = ld4(mp + (n0 + j) * p + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mdy[i][j] += dv[i].x * mv[j].x + dv[i].y * mv[j].y +
                             dv[i].z * mv[j].z + dv[i].w * mv[j].w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = r0 + i;
          if (q >= len) break;
          const float4 cv = ld4(cs + q * L.ldn + n0);
          *reinterpret_cast<float4*>(dcp + q * stride + n0) = make_float4(
              acc2[i][0] + inter[q] * mdy[i][0], acc2[i][1] + inter[q] * mdy[i][1],
              acc2[i][2] + inter[q] * mdy[i][2], acc2[i][3] + inter[q] * mdy[i][3]);
          part[i] += cv.x * mdy[i][0] + cv.y * mdy[i][1] + cv.z * mdy[i][2] +
                     cv.w * mdy[i][3];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) interp[(r0 + i) * kLanes + cl] = part[i];
  }

  // 4. <D, M>, the carry's gradient: per thread, then per warp, then in
  //    warp order
  {
    double v = 0.0;
    if (has_prev && has_dm)
      for (int e = tid; e < n * p; e += kBThreads) v += dm[e] * mp[e];
    v = warp_sum(v);
    if ((tid & 31) == 0) red[tid >> 5] = v;
  }
  __syncthreads();
  if (tid == 0) {
    double v = 0.0;
    for (int i = 0; i < kBThreads / 32; ++i) v += red[i];
    dcarry = v;
  }
  __syncthreads();

  // 5. one warp: each step's sums over the 16 lanes, then chunk_tail
  if (tid < 32) {
    double rs[2], cs_[2], co[2], it[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = 2 * tid + k;
      rs[k] = cs_[k] = co[k] = it[k] = 0.0;
      for (int l = 0; l < kLanes; ++l) {
        rs[k] += rowp[q * kLanes + l];
        cs_[k] += colp[q * kLanes + l];
        co[k] += coefp[q * kLanes + l];
        it[k] += interp[q * kLanes + l];
      }
    }
    chunk_tail(a, end, dcarry, ch, len, row0, av, cum, dts, inter, coef, seg,
               diag, sdiag, rs, cs_, co, it);
  }
}

// -- bf16: tensor cores --

// The causal tile t = qt (qt + 1) / 2 + rt of a chunk: rows q of the 16-row
// tile qt, columns r of the tile rt <= qt
__host__ __device__ constexpr int tile_of(int qt, int rt) {
  return qt * (qt + 1) / 2 + rt;
}

__device__ __forceinline__ int tile_row(int t) {
  return t < 1 ? 0 : (t < 3 ? 1 : (t < 6 ? 2 : 3));
}

// Byte offsets of a bf16 backward block's shared memory (kernels/
// ssd_scan.py::backward_shared_bytes mirrors it): the per-step rows, one
// partial sum of G's rows and columns per (tile, row), of dcoef and dinter
// per (warp, step), <D, M> per warp and the chunk's end; then the bf16
// tiles, N and P padded to 16 and rows by 8 (ldmatrix without bank
// conflicts): C, B, X, dY, and W and dCB as hi + lo parts.
struct BwdTcLayout {
  int ldn, ldx, ldw;     // row strides of the (kT x N), (kT x P), (kT x kT) tiles
  size_t cum, dts, inter, coef, seg, sdiag, diag, rowp, colp, coefp, interp,
      red, end, cs, bs, xs, dys, wh, wl, gh, gl, bytes;
};

__host__ __device__ inline BwdTcLayout bwd_tc_layout(int n, int p) {
  BwdTcLayout L{};
  L.ldn = up16(n) + 8;
  L.ldx = up16(p) + 8;
  L.ldw = kT + 8;
  size_t o = 0;
  L.cum = take(o, kT * 8);
  L.dts = take(o, kT * 4);
  L.inter = take(o, kT * 4);
  L.coef = take(o, kT * 4);
  L.seg = take(o, kT * 4);
  L.sdiag = take(o, kT * 4);
  L.diag = take(o, kT * 4);
  L.rowp = take(o, kTiles * 16 * 4);
  L.colp = take(o, kTiles * 16 * 4);
  L.coefp = take(o, kWarps * kT * 4);
  L.interp = take(o, kWarps * kT * 4);
  L.red = take(o, kWarps * 8);
  L.end = take(o, sizeof(ChunkEnd));
  L.cs = take(o, static_cast<size_t>(kT) * L.ldn * 2);
  L.bs = take(o, static_cast<size_t>(kT) * L.ldn * 2);
  L.xs = take(o, static_cast<size_t>(kT) * L.ldx * 2);
  L.dys = take(o, static_cast<size_t>(kT) * L.ldx * 2);
  L.wh = take(o, kT * L.ldw * 2);
  L.wl = take(o, kT * L.ldw * 2);
  L.gh = take(o, kT * L.ldw * 2);
  L.gl = take(o, kT * L.ldw * 2);
  L.bytes = o;
  return L;
}

// For the four 16-row tiles mt of the (kT x P) bf16 tiles X and dY (row
// stride ld): adb[mt] += X_mt D_row^T and adc[mt] += dY_mt M_row^T, where
// D's and M's row `row` (float32, row stride p, zero past n rows and p
// columns; a null state is zero) is a B fragment (k = column, n = row of
// the lane's group) as hi + lo parts, and dot += sum D_row M_row (float64)
// where both are there.  Each lane loads D's and M's elements once, two
// float2 each a k-step, four k-steps in flight at once.
__device__ __forceinline__ void state_row_products(
    float (&adb)[4][4], float (&adc)[4][4], const bf16* xs, const bf16* dys,
    int ld, const float* dm, const float* mp, double& dot, int row, int n,
    int p) {
  const int lane = threadIdx.x & 31, cq = lane & 3;
  const tc::Lanes ln(lane);
  const float2 zero2 = make_float2(0.f, 0.f);
  for (int k0 = 0; k0 < up16(p); k0 += 64) {
    float2 d[4][2], m[4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = k0 + s * 16 + 2 * cq + i * 8;
        const size_t at = static_cast<size_t>(row) * p + c;
        const bool live = row < n && c < p;
        d[s][i] = live && dm != nullptr
                      ? *reinterpret_cast<const float2*>(dm + at) : zero2;
        m[s][i] = live && mp != nullptr
                      ? *reinterpret_cast<const float2*>(mp + at) : zero2;
      }
    if (dm != nullptr && mp != nullptr)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          dot += static_cast<double>(d[s][i].x) * m[s][i].x +
                 static_cast<double>(d[s][i].y) * m[s][i].y;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int kd = k0 + s * 16;
      if (kd >= up16(p)) break;
      uint32_t h0, l0, h1, l1, a0, a1, a2, a3;
      if (dm != nullptr) {
        tc::split_bf16(d[s][0].x, d[s][0].y, h0, l0);
        tc::split_bf16(d[s][1].x, d[s][1].y, h1, l1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          tc::ldmatrix_x4(xs + (mt * 16 + ln.a_row) * ld + kd + ln.a_col, a0, a1, a2, a3);
          tc::mma(adb[mt], a0, a1, a2, a3, h0, h1);
          tc::mma(adb[mt], a0, a1, a2, a3, l0, l1);
        }
      }
      if (mp != nullptr) {
        tc::split_bf16(m[s][0].x, m[s][0].y, h0, l0);
        tc::split_bf16(m[s][1].x, m[s][1].y, h1, l1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          tc::ldmatrix_x4(dys + (mt * 16 + ln.a_row) * ld + kd + ln.a_col, a0, a1, a2, a3);
          tc::mma(adc[mt], a0, a1, a2, a3, h0, h1);
          tc::mma(adc[mt], a0, a1, a2, a3, l0, l1);
        }
      }
    }
  }
}

// The chunk's gradients for bf16 x, the float32 kernel's algebra on the
// tensor cores: one block of 8 warps per (chunk, head, batch row), two
// blocks an SM.  (1) The bf16 tiles arrive by cp.async; (2) warp 0
// takes the prefix sums while every warp forms S = C B^T and dS = dY X^T on
// its causal 16 x 16 tiles (t = warp, warp + 8; bf16 products, exact); (3)
// it masks them, stores W and dCB as hi + lo parts and sums G off the
// diagonal by quad shuffles (rows) and over the 8 lanes of a column, one
// partial per (tile, row); (4) warp w forms dX on the 8-column tiles w, w +
// 8, ... of P, all rows: coef (B D), with the leaving adjoint D read from
// the scratch straight into B fragments (hi + lo), then W^T dY over the
// causal tiles, then D_h dY; (5) and dB and dC on the 8-column tiles of N:
// coef (X D^T) + dCB^T C and inter (dY M^T) + dCB B, M and D again read
// into fragments, each element by one warp, which also sums <D, M> from
// them in float64 (the carry's gradient); (6) warp 0 sums the partials
// over tiles and warps in a fixed order and ends in chunk_tail.  No
// atomics: two calls give the same bits.
__global__ void __launch_bounds__(kBThreads, 2)
chunk_backward_tc(const BwdParams a) {
  extern __shared__ uint4 smem16[];
  char* base = reinterpret_cast<char*>(smem16);
  const int h = blockIdx.y, bb = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, cq = lane & 3;
  const int n = a.n, p = a.p, heads = a.heads, ch = blockIdx.x;
  const int np = up16(n), pp = up16(p);
  const BwdTcLayout L = bwd_tc_layout(n, p);
  const tc::Lanes ln(lane);
  const size_t bh = static_cast<size_t>(bb) * heads + h;
  const float av = -expf(a.a_log[h]);
  const float dskip = a.d_skip[h];
  // the state entering the chunk and the adjoint leaving it, or null: zero
  const float* mp = ch > 0 ? a.chunk_states + (bh * a.chunks + ch) * n * p : nullptr;
  const float* dm = a.chunks > 1 ? a.adj + (bh * a.chunks + ch) * n * p
                    : (a.dstate != nullptr ? a.dstate + bh * n * p : nullptr);
  const int t0 = ch * kT, len = min(kT, a.s_len - t0);
  const size_t row0 = static_cast<size_t>(bb) * a.s_len + t0;
  const int grp = h / (heads / a.groups);
  double* cum = reinterpret_cast<double*>(base + L.cum);
  float* dts = reinterpret_cast<float*>(base + L.dts);
  float* inter = reinterpret_cast<float*>(base + L.inter);
  float* coef = reinterpret_cast<float*>(base + L.coef);
  int* seg = reinterpret_cast<int*>(base + L.seg);
  float* sdiag = reinterpret_cast<float*>(base + L.sdiag);
  float* diag = reinterpret_cast<float*>(base + L.diag);
  float* rowp = reinterpret_cast<float*>(base + L.rowp);
  float* colp = reinterpret_cast<float*>(base + L.colp);
  float* coefp = reinterpret_cast<float*>(base + L.coefp);
  float* interp = reinterpret_cast<float*>(base + L.interp);
  double* red = reinterpret_cast<double*>(base + L.red);
  ChunkEnd* end = reinterpret_cast<ChunkEnd*>(base + L.end);
  bf16* cs = reinterpret_cast<bf16*>(base + L.cs);
  bf16* bs = reinterpret_cast<bf16*>(base + L.bs);
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);
  bf16* dys = reinterpret_cast<bf16*>(base + L.dys);
  bf16* wh = reinterpret_cast<bf16*>(base + L.wh);
  bf16* wl = reinterpret_cast<bf16*>(base + L.wl);
  bf16* gh = reinterpret_cast<bf16*>(base + L.gh);
  bf16* gl = reinterpret_cast<bf16*>(base + L.gl);

  // 1. the chunk's dt and resets; C, B, X, dY (cp.async; zeros past len and
  //    in the padding)
  if (tid < kT) {
    const bool live = tid < len;
    dts[tid] = live ? a.dt[(row0 + tid) * heads + h] : 0.f;
    seg[tid] = (a.reset != nullptr && live) ? (a.reset[row0 + tid] != 0) : 0;
  }
  const size_t bc_off = (row0 * a.groups + grp) * n;
  const size_t bc_stride = static_cast<size_t>(a.groups) * n;
  const size_t xo = (row0 * heads + h) * p, x_stride = static_cast<size_t>(heads) * p;
  load_tile<bf16, kBThreads>(cs, L.ldn, kT, np, static_cast<const bf16*>(a.c) + bc_off,
                             bc_stride, len, n);
  load_tile<bf16, kBThreads>(bs, L.ldn, kT, np, static_cast<const bf16*>(a.b) + bc_off,
                             bc_stride, len, n);
  load_tile<bf16, kBThreads>(xs, L.ldx, kT, pp, static_cast<const bf16*>(a.x) + xo,
                             x_stride, len, p);
  load_tile<bf16, kBThreads>(dys, L.ldx, kT, pp, static_cast<const bf16*>(a.dy) + xo,
                             x_stride, len, p);
  cp_async_wait<0>();
  __syncthreads();

  // 2. warp 0: the prefix sums and factors; every warp: S and dS on its
  //    tiles, two n8 halves each
  if (warp == 0) {
    const ChunkEnd e = chunk_rows(av, len, dts, cum, seg, inter, coef);
    if (lane == 0) *end = e;
  }
  float sc[2][2][4], ds[2][2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[k][j][e] = ds[k][j][e] = 0.f;
    const int t = warp + k * kWarps;
    if (t >= kTiles) continue;
    const int qt = tile_row(t), rt = t - tile_of(qt, 0);
    for (int kd = 0; kd < np; kd += 16) {
      uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
      tc::ldmatrix_x4(cs + (qt * 16 + ln.a_row) * L.ldn + kd + ln.a_col, a0, a1, a2, a3);
      tc::ldmatrix_x4(bs + (rt * 16 + ln.b_row) * L.ldn + kd + ln.b_col, b0, b1, b2, b3);
      tc::mma(sc[k][0], a0, a1, a2, a3, b0, b1);
      tc::mma(sc[k][1], a0, a1, a2, a3, b2, b3);
    }
    for (int kd = 0; kd < pp; kd += 16) {
      uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
      tc::ldmatrix_x4(dys + (qt * 16 + ln.a_row) * L.ldx + kd + ln.a_col, a0, a1, a2, a3);
      tc::ldmatrix_x4(xs + (rt * 16 + ln.b_row) * L.ldx + kd + ln.b_col, b0, b1, b2, b3);
      tc::mma(ds[k][0], a0, a1, a2, a3, b0, b1);
      tc::mma(ds[k][1], a0, a1, a2, a3, b2, b3);
    }
  }
  __syncthreads();

  // 3. the decay mask (linear domain, before the exp); W = S E dt_r and
  //    dCB = dS E dt_r stored as hi + lo parts; G = dS E S summed off the
  //    diagonal, times dt_r along rows (quad shuffles) and along columns
  //    (the 8 lanes of a column), one partial per (tile, row); the diagonal
  //    of G and of dS (the skip's gradient)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = warp + k * kWarps;
    if (t >= kTiles) continue;
    const int qt = tile_row(t), rt = t - tile_of(qt, 0);
    float rsum[2] = {0.f, 0.f}, csum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qt * 16 + g + (e >> 1) * 8;
        const int r = rt * 16 + j * 8 + 2 * cq + (e & 1);
        const bool keep = r <= q && q < len && seg[q] == seg[r];
        float wv = 0.f, dv = 0.f, gt = 0.f;
        if (keep) {
          const float ex = expf(static_cast<float>(cum[q] - cum[r]));
          const float v = ds[k][j][e] * ex;
          wv = sc[k][j][e] * ex * dts[r];
          dv = v * dts[r];
          gt = v * sc[k][j][e];
          if (r < q) {
            rsum[e >> 1] += gt * dts[r];
            csum[j][e & 1] += gt;
          }
        }
        if (q == r) {
          diag[q] = gt;
          sdiag[q] = keep ? ds[k][j][e] : 0.f;
        }
        sc[k][j][e] = wv;
        ds[k][j][e] = dv;
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int off = (qt * 16 + g + hf * 8) * L.ldw + rt * 16 + j * 8 + 2 * cq;
        uint32_t hi, lo;
        tc::split_bf16(sc[k][j][2 * hf], sc[k][j][2 * hf + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(wh + off) = hi;
        *reinterpret_cast<uint32_t*>(wl + off) = lo;
        tc::split_bf16(ds[k][j][2 * hf], ds[k][j][2 * hf + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(gh + off) = hi;
        *reinterpret_cast<uint32_t*>(gl + off) = lo;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(kFull, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(kFull, rsum[i], 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          csum[j][i] += __shfl_xor_sync(kFull, csum[j][i], o);
    if (cq == 0) {
      rowp[t * 16 + g] = rsum[0];
      rowp[t * 16 + g + 8] = rsum[1];
    }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) colp[t * 16 + j * 8 + 2 * cq + i] = csum[j][i];
  }
  __syncthreads();

  // 4. dX = coef (B D) + W^T dY + D_h dY on the 8-column tiles of P, and
  //    dcoef_r = (B_r D) . X_r, one partial per (warp, row)
  {
    bf16* dx = static_cast<bf16*>(a.dx) + xo;
    float cpart[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int jt = warp; jt < pp / 8; jt += kWarps) {
      const int p0 = jt * 8, col = p0 + g;   // col: the B fragment's column
      float acc[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
      if (dm != nullptr) {
        // B D: D's column col over N as B fragments (k = state row), hi + lo
        for (int k0 = 0; k0 < np; k0 += 128) {
          float v[8][4];
#pragma unroll
          for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = k0 + s * 16 + 2 * cq + (i & 1) + (i >> 1) * 8;
              v[s][i] = row < n && col < p ? dm[static_cast<size_t>(row) * p + col] : 0.f;
            }
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int kd = k0 + s * 16;
            if (kd >= np) break;
            uint32_t h0, l0, h1, l1;
            tc::split_bf16(v[s][0], v[s][1], h0, l0);
            tc::split_bf16(v[s][2], v[s][3], h1, l1);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              uint32_t a0, a1, a2, a3;
              tc::ldmatrix_x4(bs + (mt * 16 + ln.a_row) * L.ldn + kd + ln.a_col, a0, a1, a2, a3);
              tc::mma(acc[mt], a0, a1, a2, a3, h0, h1);
              tc::mma(acc[mt], a0, a1, a2, a3, l0, l1);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = mt * 16 + g + hf * 8;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + r * L.ldx + p0 + 2 * cq));
            cpart[mt][hf] += acc[mt][2 * hf] * xv.x + acc[mt][2 * hf + 1] * xv.y;
            acc[mt][2 * hf] *= coef[r];
            acc[mt][2 * hf + 1] *= coef[r];
          }
      }
      // W^T dY: rows r of tile mt, keys q of the tiles qt >= mt; W^T's A
      // fragments from W's tile by ldmatrix.trans
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        for (int qt = mt; qt < 4; ++qt) {
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3, b0, b1;
          const int off = (qt * 16 + ln.b_row) * L.ldw + mt * 16 + ln.b_col;
          tc::ldmatrix_x4_trans(wh + off, h0, h1, h2, h3);
          tc::ldmatrix_x4_trans(wl + off, l0, l1, l2, l3);
          tc::ldmatrix_x2_trans(dys + (qt * 16 + (lane & 15)) * L.ldx + p0, b0, b1);
          tc::mma(acc[mt], h0, h1, h2, h3, b0, b1);
          tc::mma(acc[mt], l0, l1, l2, l3, b0, b1);
        }
      // + D_h dY, two bf16 a lane
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * 16 + g + hf * 8, c = p0 + 2 * cq;
          if (r >= len || c >= p) continue;
          const float2 dv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + r * L.ldx + c));
          *reinterpret_cast<__nv_bfloat162*>(dx + r * x_stride + c) =
              __floats2bfloat162_rn(acc[mt][2 * hf] + dskip * dv.x,
                                    acc[mt][2 * hf + 1] + dskip * dv.y);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        cpart[mt][hf] += __shfl_xor_sync(kFull, cpart[mt][hf], 1);
        cpart[mt][hf] += __shfl_xor_sync(kFull, cpart[mt][hf], 2);
        if (cq == 0) coefp[warp * kT + mt * 16 + g + hf * 8] = cpart[mt][hf];
      }
  }

  // 5. this head's dB = coef (X D^T) + dCB^T C and dC = inter (dY M^T) +
  //    dCB B on the 8-column tiles of N, with dinter_q = C_q . (M dY_q),
  //    one partial per (warp, step), and <D, M>, the carry's gradient, from
  //    the elements of D and M the warp loads, per lane then per warp
  {
    float* dbp = a.db_part + (row0 * heads + h) * n;
    float* dcp = a.dc_part + (row0 * heads + h) * n;
    const size_t stride = static_cast<size_t>(heads) * n;
    float ipart[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    double dmdot = 0.0;
    for (int jn = warp; jn < np / 8; jn += kWarps) {
      const int n0 = jn * 8, c = n0 + 2 * cq;
      float adb[4][4], adc[4][4];     // dB's rows r, dC's rows q
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) adb[mt][e] = adc[mt][e] = 0.f;
      state_row_products(adb, adc, xs, dys, L.ldx, dm, mp, dmdot, n0 + g, n, p);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * 16 + g + hf * 8;
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cs + r * L.ldn + c));
          ipart[mt][hf] += cv.x * adc[mt][2 * hf] + cv.y * adc[mt][2 * hf + 1];
          adb[mt][2 * hf] *= coef[r];
          adb[mt][2 * hf + 1] *= coef[r];
          adc[mt][2 * hf] *= inter[r];
          adc[mt][2 * hf + 1] *= inter[r];
        }
      // dCB^T C (rows r of tile mt, keys q of the tiles qt >= mt) and dCB B
      // (rows q of tile mt, keys r of the tiles rt <= mt)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        for (int qt = mt; qt < 4; ++qt) {
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3, b0, b1;
          const int off = (qt * 16 + ln.b_row) * L.ldw + mt * 16 + ln.b_col;
          tc::ldmatrix_x4_trans(gh + off, h0, h1, h2, h3);
          tc::ldmatrix_x4_trans(gl + off, l0, l1, l2, l3);
          tc::ldmatrix_x2_trans(cs + (qt * 16 + (lane & 15)) * L.ldn + n0, b0, b1);
          tc::mma(adb[mt], h0, h1, h2, h3, b0, b1);
          tc::mma(adb[mt], l0, l1, l2, l3, b0, b1);
        }
        for (int rt = 0; rt <= mt; ++rt) {
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3, b0, b1;
          const int off = (mt * 16 + ln.a_row) * L.ldw + rt * 16 + ln.a_col;
          tc::ldmatrix_x4(gh + off, h0, h1, h2, h3);
          tc::ldmatrix_x4(gl + off, l0, l1, l2, l3);
          tc::ldmatrix_x2_trans(bs + (rt * 16 + (lane & 15)) * L.ldn + n0, b0, b1);
          tc::mma(adc[mt], h0, h1, h2, h3, b0, b1);
          tc::mma(adc[mt], l0, l1, l2, l3, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * 16 + g + hf * 8;
          if (r >= len || c >= n) continue;
          *reinterpret_cast<float2*>(dbp + r * stride + c) =
              make_float2(adb[mt][2 * hf], adb[mt][2 * hf + 1]);
          *reinterpret_cast<float2*>(dcp + r * stride + c) =
              make_float2(adc[mt][2 * hf], adc[mt][2 * hf + 1]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ipart[mt][hf] += __shfl_xor_sync(kFull, ipart[mt][hf], 1);
        ipart[mt][hf] += __shfl_xor_sync(kFull, ipart[mt][hf], 2);
        if (cq == 0) interp[warp * kT + mt * 16 + g + hf * 8] = ipart[mt][hf];
      }
    dmdot = warp_sum(dmdot);
    if (lane == 0) red[warp] = dmdot;
  }
  __syncthreads();

  // 6. one warp: each step's partials over tiles and warps in a fixed
  //    order, then chunk_tail
  if (warp == 0) {
    double dcarry = 0.0;
    for (int i = 0; i < kWarps; ++i) dcarry += red[i];
    double rs[2], cs_[2], co[2], it[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = 2 * lane + k, qt = q >> 4, qi = q & 15;
      rs[k] = cs_[k] = co[k] = it[k] = 0.0;
      for (int rt = 0; rt <= qt; ++rt) rs[k] += rowp[tile_of(qt, rt) * 16 + qi];
      for (int t = qt; t < 4; ++t) cs_[k] += colp[tile_of(t, qt) * 16 + qi];
      for (int w = 0; w < kWarps; ++w) {
        co[k] += coefp[w * kT + q];
        it[k] += interp[w * kT + q];
      }
    }
    chunk_tail(a, *end, dcarry, ch, len, row0, av, cum, dts, inter, coef, seg,
               diag, sdiag, rs, cs_, co, it);
  }
}

// The fixed-order sums: y 0 and 1, db and dc of each (row, group, n) over
// the group's heads; y 2, dA and dD of each head over (batch row, chunk),
// in float64, da_log = A dA.
template <typename T>
__global__ void __launch_bounds__(kBThreads)
grad_reduce(const BwdParams a) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kBThreads + threadIdx.x;
  const int n = a.n, heads = a.heads, reps = a.heads / a.groups;
  if (blockIdx.y < 2) {
    const size_t total = static_cast<size_t>(a.batch) * a.s_len * a.groups * n;
    if (e >= total) return;
    const int nn = static_cast<int>(e % n);
    const size_t gr = e / n;
    const int g = static_cast<int>(gr % a.groups);
    const size_t row = gr / a.groups;
    const float* part = blockIdx.y == 0 ? a.db_part : a.dc_part;
    const float* src = part + (row * heads + static_cast<size_t>(g) * reps) * n + nn;
    float v = 0.f;
    for (int k = 0; k < reps; ++k) v += src[static_cast<size_t>(k) * n];
    put(static_cast<T*>(blockIdx.y == 0 ? a.db : a.dc) + e, v);
  } else if (e < static_cast<size_t>(heads)) {
    const size_t blocks = static_cast<size_t>(a.batch) * a.chunks;
    double da = 0.0, dd = 0.0;
    for (size_t j = 0; j < blocks; ++j) {
      da += a.head_part[j * heads + e];
      dd += a.head_part[(blocks + j) * heads + e];
    }
    a.da_log[e] = static_cast<float>(-exp(static_cast<double>(a.a_log[e])) * da);
    a.dd_skip[e] = static_cast<float>(dd);
  }
}

template <typename K>
cudaError_t launch_smem(K kernel, dim3 grid, size_t bytes, cudaStream_t stream,
                        const BwdParams& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Where S > kT: the forward's state and serial passes recompute the states
// entering each chunk (float32, in place), then U of each chunk
// (chunk_adjoint, into adj) and the adjoint pass;
// then the chunk gradients and the sums.
template <typename T>
cudaError_t launch_backward(const Params& f, const BwdParams& a,
                            cudaStream_t stream) {
  cudaError_t err;
  const int np4 = a.n * a.p / 4;
  const dim3 pass_grid((np4 + kThreads - 1) / kThreads, a.heads, a.batch);
  if (a.chunks > 1) {
    err = launch_chunk<T, kState>(f, a.batch, stream);
    if (err != cudaSuccess) return err;
    state_pass<false><<<pass_grid, kThreads, 0, stream>>>(
        a.carry, a.chunk_states, nullptr, nullptr, a.chunks, np4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    Params u = f;                  // U = C^T (inter dY) in place of B^T (coef x)
    u.x = a.dy;
    u.b = a.c;
    u.chunk_states = a.adj;
    err = launch_chunk<T, kAdjoint>(u, a.batch, stream);
    if (err != cudaSuccess) return err;
    adjoint_pass<<<pass_grid, kThreads, 0, stream>>>(a.carry, a.adj, a.dstate,
                                                     a.chunks, np4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.chunks, a.heads, a.batch);
  if constexpr (sizeof(T) == 2)
    err = launch_smem(chunk_backward_tc, grid, bwd_tc_layout(a.n, a.p).bytes,
                      stream, a);
  else
    err = launch_smem(chunk_backward_f32, grid, bwd_layout(a.n, a.p).bytes,
                      stream, a);
  if (err != cudaSuccess) return err;
  const size_t elems = static_cast<size_t>(a.batch) * a.s_len * a.groups * a.n;
  const size_t most = elems > static_cast<size_t>(a.heads) ? elems : a.heads;
  const size_t blocks = (most + kBThreads - 1) / kBThreads;
  grad_reduce<T><<<dim3(static_cast<unsigned>(blocks), 3), kBThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename K>
int blocks_per_sm(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBThreads,
                                                        bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// x (B, S, H, P), b and c (B, S, G, N) and y (B, S, H, P) of one type
// (dtype 0: float32, 1: bfloat16); dt (B, S, H), a_log and d_skip (H,) and
// state (B, H, N, P) float32; reset (B, S) bool or null.  Where chunks =
// ceil(S / 64) > 1: chunk_states (B, H, chunks, N, P) and carry (B, H,
// chunks) float32 scratch, and for bf16 entering (B, H, chunks, 2, N, P)
// bf16 scratch; null otherwise.  P is split into col_groups groups of
// columns (each a multiple of 16 where there is more than one).  All
// contiguous; N and P multiples of 4, G dividing H.  Returns the first
// CUDA error of the call's launches.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* b,
                               const void* c, const void* d_skip,
                               const void* reset, void* y, void* state,
                               void* chunk_states, void* entering,
                               void* carry, int batch, int s_len, int heads,
                               int groups, int n, int p, int col_groups,
                               int dtype, int device, void* stream) {
  const int chunks = (s_len + kT - 1) / kT;
  if (groups <= 0 || heads % groups != 0 || n % 4 != 0 || p % 4 != 0 ||
      s_len <= 0 || col_groups <= 0 || p % col_groups != 0 ||
      (col_groups > 1 && (p / col_groups) % 16 != 0) || dtype < 0 ||
      dtype > 1 ||
      (chunks > 1 && (chunk_states == nullptr || carry == nullptr ||
                      (dtype == 1 && entering == nullptr))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Params a{x, static_cast<const float*>(dt),
                 static_cast<const float*>(a_log), b, c,
                 static_cast<const float*>(d_skip),
                 static_cast<const uint8_t*>(reset), y,
                 static_cast<float*>(state), static_cast<float*>(chunk_states),
                 static_cast<bf16*>(entering), static_cast<float*>(carry),
                 s_len, heads, groups, n, p, chunks, col_groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, batch, s) : launch<bf16>(a, batch, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The gradients of ssd_scan_launch's (y, final state): x, dt, a_log, b, c,
// d_skip and reset as the forward takes them, dy of y's shape and type, and
// dstate (B, H, N, P) float32 or null.  Out: dx, db, dc in x's type, ddt
// (B, S, H), da_log and dd_skip (H,) float32.  Scratch, float32: db_part
// and dc_part (B, S, H, N), head_part (2, B, chunks, H), and where chunks >
// 1 chunk_states and adj (B, H, chunks, N, P) and carry (B, H, chunks);
// null otherwise.  col_groups is the forward's plan for the recompute.  All
// contiguous, dstate 16-byte aligned.  Returns the first CUDA error of the
// call's launches.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* reset, const void* dy,
    const void* dstate, void* dx, void* ddt, void* da_log, void* db, void* dc,
    void* dd_skip, void* chunk_states, void* carry, void* adj, void* db_part,
    void* dc_part, void* head_part, int batch, int s_len, int heads,
    int groups, int n, int p, int col_groups, int dtype, int device,
    void* stream) {
  const int chunks = (s_len + kT - 1) / kT;
  if (batch <= 0 || groups <= 0 || heads % groups != 0 || n % 4 != 0 ||
      p % 4 != 0 || s_len <= 0 || col_groups <= 0 || p % col_groups != 0 ||
      dtype < 0 || dtype > 1 || db_part == nullptr || dc_part == nullptr ||
      head_part == nullptr ||
      (chunks > 1 && (chunk_states == nullptr || carry == nullptr ||
                      adj == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Params f{x, static_cast<const float*>(dt),
                 static_cast<const float*>(a_log), b, c,
                 static_cast<const float*>(d_skip),
                 static_cast<const uint8_t*>(reset), nullptr, nullptr,
                 static_cast<float*>(chunk_states), nullptr,
                 static_cast<float*>(carry), s_len, heads, groups, n, p,
                 chunks, col_groups};
  const BwdParams a{x, static_cast<const float*>(dt),
                    static_cast<const float*>(a_log), b, c,
                    static_cast<const float*>(d_skip),
                    static_cast<const uint8_t*>(reset), dy,
                    static_cast<const float*>(dstate), dx,
                    static_cast<float*>(ddt), static_cast<float*>(da_log), db,
                    dc, static_cast<float*>(dd_skip),
                    static_cast<float*>(chunk_states),
                    static_cast<float*>(carry), static_cast<float*>(adj),
                    static_cast<float*>(db_part), static_cast<float*>(dc_part),
                    static_cast<float*>(head_part), batch, s_len, heads,
                    groups, n, p, chunks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_backward<float>(f, a, s)
                    : launch_backward<bf16>(f, a, s);
}

// Blocks of the chunk-gradient kernel (dtype 0: float32, 1: bf16) one SM of
// the device holds at N x P, from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// minus the CUDA error where a call fails.
extern "C" int ssd_scan_backward_blocks_per_sm(int n, int p, int dtype,
                                               int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dtype == 1 ? blocks_per_sm(chunk_backward_tc, bwd_tc_layout(n, p).bytes)
                    : blocks_per_sm(chunk_backward_f32, bwd_layout(n, p).bytes);
}
