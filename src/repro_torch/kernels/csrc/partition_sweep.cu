// Partition sweep for Hopper (sm_90a): the drift-plus-penalty objective of
// paper eq. 11 for every (UE row, cut) pair, infeasible pairs = 1e30.
//
// Replaces the TPU kernel repro/kernels/partition_sweep.py::_kernel (the
// pl.pallas_call in partition_sweep_pallas, batched by
// partition_sweep_batched).  The plain version it is held to is
// repro_torch/kernels/ref.py::partition_sweep_ref.
//
// Design.  A row of C cuts takes kLanes lanes, the least power of two >= C
// (capped at 32): 16 lanes a row at C = 11 (two rows a warp), 8 at C <= 8,
// 1 at C = 1, so at small C no warp runs the search for idle lanes.  Past
// 32 cuts (the LM fleet's C = 103) a row keeps a whole warp and its lanes
// stride over the cuts in chunks of 32.  Eight warps a block; a row count
// that is not a multiple of a block's rows leaves the last warps' dead
// lanes computing on the last row and writing nothing.
//   * Prefix sums of MACs and parameter bytes: shuffle scans of width
//     kLanes (the TPU kernel used a triangular ones matmul), chunk by chunk
//     with a carry.
//   * Prefix / suffix running maxima of the masked activations: shuffle
//     max-scans of the same width (the TPU kernel used log2(C) doubling
//     passes).  The suffix pass runs first, right to left, and parks each
//     lane's exclusive suffix maximum in its own output element; the
//     forward pass reads it back from the same address in the same thread,
//     then overwrites it.
//   * The suffix sums need the row total first, so a short forward pass of
//     the same scan code computes it, and the totals equal the prefix the
//     main pass sees at column C-1 bit for bit.
//   * Each lane runs the 40-step Fibonacci search (P3) for its cuts in
//     registers, then the even-split delays, energy and memory terms.
//   * A cut that is infeasible (past L, or a local demand the UE cannot
//     serve) writes 1e30 and skips the search.
// The 11 MEC constants, compile-time constants on the TPU, are one row of
// 11 floats per cell here, so cells with different constants share one
// launch; rows [g * cell_rows, (g + 1) * cell_rows) belong to cell g.
// n_total, the UE count of the even split, is an int argument of its own:
// a rank that holds cell_rows = N / M of a cell's N UEs (the grid's "model"
// axis) still splits the cell's bandwidth and edge CPU N ways.
//
// What bounds it.  A feasible (row, cut) takes 1,188 float32 operations
// (kernels/partition_sweep.py counts them, a division or a log2 as one)
// against about 24 bytes moved, so the card's float32 rate bounds it:
// about 0.4 GFLOP at 4096 cells x 8 UEs x 11 cuts, a few microseconds at
// 67 TFLOP/s.  On an H100 its time follows the rows (a quarter, half and
// all of that grid: 0.096, 0.185, 0.359 ms with one row a warp), so it is
// bound by the instructions it issues, not by one wave's latency: a warp
// issues each instruction once for all of its lanes, busy or not, and
// every search step was two objective evaluations of two multi-instruction
// IEEE divisions each.  Packing two rows a warp at C = 11 halved the time
// (0.182 ms); one approximate division an evaluation took it to 0.045 ms
// (PERF.md, section 6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
// No fast-math flag: approximate log2f breaks the tolerance against the
// plain version; the search's division is the one approximate operation,
// chosen where it is written (p3_obj).  -fmad=false keeps every a*b+c
// rounded twice, as PyTorch's elementwise ops round it, so kernel and
// plain differ only in summation order, libm, the order of the products
// hoisted out of the search and the point the search settles on.

#include <cuda_runtime.h>
#include <stdint.h>

struct SweepScalars {
  float rho, kappa, p_tx, w_hz, n0, f_max_ue, f_max_es, v, gamma_ue,
      gamma_es, stability_margin;
};

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFibIters = 40;
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-12f;

// float32 Fibonacci ratios F_{n-k}/F_{n-k+2} and F_{n-k+1}/F_{n-k+2}
// (repro/kernels/partition_sweep.py::_fib_ratios; a CPU test checks them).
__constant__ float kRatioLo[kFibIters] = {
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f,
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f,
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f,
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f,
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f,
    0.3819660246372223f, 0.3819660246372223f, 0.3819660246372223f, 0.3819659948348999f,
    0.3819660246372223f, 0.3819659352302551f, 0.38196617364883423f, 0.3819655478000641f,
    0.3819672167301178f, 0.3819628655910492f, 0.3819742500782013f, 0.3819444477558136f,
    0.3820224702358246f, 0.38181817531585693f, 0.38235294818878174f, 0.380952388048172f,
    0.38461539149284363f, 0.375f, 0.4000000059604645f, 0.3333333432674408f};
__constant__ float kRatioHi[kFibIters] = {
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f, 0.6180340051651001f,
    0.6180339455604553f, 0.6180340647697449f, 0.6180338263511658f, 0.6180344223976135f,
    0.6180328130722046f, 0.6180371642112732f, 0.6180257797241211f, 0.6180555820465088f,
    0.617977499961853f, 0.6181818246841431f, 0.6176470518112183f, 0.6190476417541504f,
    0.6153846383094788f, 0.625f, 0.6000000238418579f, 0.6666666865348816f};

// Inclusive scans over the kLanes lanes of a row (shuffles of width
// kLanes); sub is the lane's index within its row.
template <int kLanes>
__device__ __forceinline__ float row_scan_sum(float x, int sub) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d, kLanes);
    if (sub >= d) x += y;
  }
  return x;
}

template <int kLanes>
__device__ __forceinline__ float row_scan_max(float x, int sub) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d, kLanes);
    if (sub >= d) x = fmaxf(x, y);
  }
  return x;
}

template <int kLanes>
__device__ __forceinline__ float row_rscan_max(float x, int sub) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const float y = __shfl_down_sync(kFull, x, d, kLanes);
    if (sub + d < kLanes) x = fmaxf(x, y);
  }
  return x;
}

// Eq. (19), the P3 objective, Q*kappa*f^2*d*lam + V*(d/f + d^2 lam /
// (2 (f^2 - f d lam))), with the cut's invariants hoisted: e_coef =
// Q*kappa*d*lam, dl = d*lam, q_coef = d^2 lam / 2.  The plain version takes
// 11 operations with two divisions, d/f and q_coef/denom; here the two
// fractions share one, (d denom + q_coef f) / (f denom), 13 operations,
// and that division is the approximate one (__fdividef: a reciprocal and
// a product, 2 ulp).  An IEEE division is a multi-instruction sequence (a
// reciprocal, its refinement and a range check with a slow-path call), and
// the search evaluates this 80 times a cut.  The search only compares
// values of this function; the f_ue it settles on enters the table through
// IEEE arithmetic below.  On an H100 at 4096 x 8 x 11, one IEEE division
// in place of two took the kernel from 0.182 to 0.111 ms and the
// approximate one to 0.045 ms, each holding the plain table to phase 2's
// checks (PERF.md, section 6).  __fdividef returns 0 for a divisor above
// 2^126; f denom <= f_max_ue^3 stays below it (about 2^119.6 at most)
// because the host refuses rows with f_max_ue above 10^12 Hz
// (partition_sweep.py F_MAX_UE_LIMIT, checked where a grid or a run builds
// its rows; f >= 1 is the search's lower bound).
__device__ __forceinline__ float p3_obj(float f, float e_coef, float d_ue,
                                        float dl, float q_coef, float v) {
  f = fmaxf(f, kEps);
  const float ff = f * f;
  const float energy = e_coef * ff;
  const float denom = fmaxf(ff - f * dl, kEps);
  return energy + v * __fdividef(d_ue * denom + q_coef * f, f * denom);
}

template <int kLanes>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
partition_sweep_kernel(const float* __restrict__ macs,
                       const float* __restrict__ params,
                       const float* __restrict__ acts,
                       const float* __restrict__ psi,
                       const int64_t* __restrict__ L,
                       const float* __restrict__ lam_v,
                       const float* __restrict__ gain_v,
                       const float* __restrict__ qe_v,
                       const float* __restrict__ qm_v,
                       const SweepScalars* __restrict__ scalars,
                       float* __restrict__ out, int rows, int C, int cell_rows,
                       int n_total) {
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kRowsPerWarp;
  if (first >= rows) return;  // the whole warp leaves together
  // a dead lane (past the last row) computes on the last row, writes nothing
  const bool live = first + lane / kLanes < rows;
  const long long row = live ? first + lane / kLanes : rows - 1;

  const SweepScalars s = scalars[row / cell_rows];
  const long long base = row * (long long)C;
  const float* m_row = macs + base;
  const float* p_row = params + base;
  const float* a_row = acts + base;
  const float* psi_row = psi + base;
  float* o_row = out + base;
  const long long l_n = L[row];
  const float lam = lam_v[row];
  const float gain = gain_v[row];
  const float qe = qe_v[row];
  const float qm = qm_v[row];
  const int chunks = (C + kLanes - 1) / kLanes;

  // Pass 1, right to left: exclusive suffix max of the masked activations
  // (layers c+1 .. L), parked in out[c].
  float after = 0.0f;
  for (int k = chunks - 1; k >= 0; --k) {
    const int c = k * kLanes + sub;
    const float a = (c < C && c >= 1 && c <= l_n) ? a_row[c] : 0.0f;
    const float incl = fmaxf(row_rscan_max<kLanes>(a, sub), after);
    float excl = __shfl_down_sync(kFull, incl, 1, kLanes);
    if (sub == kLanes - 1) excl = after;
    if (c < C && live) o_row[c] = excl;
    after = __shfl_sync(kFull, incl, 0, kLanes);
  }

  // Pass 2: row totals, as the prefix at column C-1 of the pass-3 scan.
  float tot_m = 0.0f, tot_p = 0.0f;
  {
    float carry_m = 0.0f, carry_p = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      const int c = k * kLanes + sub;
      const float pm = row_scan_sum<kLanes>(c < C ? m_row[c] : 0.0f, sub) + carry_m;
      const float pp = row_scan_sum<kLanes>(c < C ? p_row[c] : 0.0f, sub) + carry_p;
      carry_m = __shfl_sync(kFull, pm, kLanes - 1, kLanes);
      carry_p = __shfl_sync(kFull, pp, kLanes - 1, kLanes);
      if (k == chunks - 1) {
        tot_m = __shfl_sync(kFull, pm, (C - 1) % kLanes, kLanes);
        tot_p = __shfl_sync(kFull, pp, (C - 1) % kLanes, kLanes);
      }
    }
  }

  // Terms shared by every cut of the row (13 operations): the even split's
  // uplink rate and edge share, and the search's row constants.
  const float alpha = 1.0f / (float)n_total;
  const float aw = alpha * s.w_hz;
  const float snr = s.p_tx * gain / (aw * s.n0);
  const float rate = fmaxf(aw * log2f(1.0f + snr), kEps);
  const float f_es = s.f_max_es / (float)n_total;
  const float margin = 1.0f + s.stability_margin;
  const float qe_kappa = qe * s.kappa;
  const float p_tx_lam = s.p_tx * lam;

  // Pass 3, left to right: prefix scans, then each lane's cut.  Every cut
  // takes 9 operations (4 scan steps, d_ue and the feasibility test); a
  // feasible one 1,188 more.
  float carry_m = 0.0f, carry_p = 0.0f, carry_a = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    const int c = k * kLanes + sub;
    const bool valid = c < C;
    const float pm = row_scan_sum<kLanes>(valid ? m_row[c] : 0.0f, sub) + carry_m;
    const float pp = row_scan_sum<kLanes>(valid ? p_row[c] : 0.0f, sub) + carry_p;
    const float xa = (valid && c >= 1 && c <= l_n) ? a_row[c] : 0.0f;
    const float pmax = fmaxf(row_scan_max<kLanes>(xa, sub), carry_a);
    carry_m = __shfl_sync(kFull, pm, kLanes - 1, kLanes);
    carry_p = __shfl_sync(kFull, pp, kLanes - 1, kLanes);
    carry_a = __shfl_sync(kFull, pmax, kLanes - 1, kLanes);
    if (!valid || !live) continue;

    const float d_ue = s.rho * pm;
    const float dl = d_ue * lam;
    const float demand = dl * margin;
    if (!(c <= l_n && demand < s.f_max_ue)) {
      o_row[c] = kBig;
      continue;
    }
    const float smax = o_row[c];
    const float d_es = s.rho * (tot_m - pm);

    // P3: Fibonacci search for f_ue on [lo, f_max_ue]; 28 operations a step.
    const float hi = s.f_max_ue;
    const float lo = fminf(demand + 1.0f, hi);
    const float e_coef = qe_kappa * dl;
    const float q_coef = 0.5f * ((d_ue * d_ue) * lam);
    float a = lo, b = hi;
    for (int it = 0; it < kFibIters; ++it) {
      const float span = b - a;
      const float x1 = a + kRatioLo[it] * span;
      const float x2 = a + kRatioHi[it] * span;
      if (p3_obj(x1, e_coef, d_ue, dl, q_coef, s.v) <
          p3_obj(x2, e_coef, d_ue, dl, q_coef, s.v)) {
        b = x2;
      } else {
        a = x1;
      }
    }
    float f_ue = 0.5f * (a + b);
    if (p3_obj(hi, e_coef, d_ue, dl, q_coef, s.v) <
        p3_obj(f_ue, e_coef, d_ue, dl, q_coef, s.v)) {
      f_ue = hi;
    }
    const bool local = d_ue > 0.0f;
    if (!local) f_ue = 0.0f;

    // Delays: M/D/1 local queue, even-split uplink, even-split edge.
    float t_ue = 0.0f;
    if (local) {
      const float mu = f_ue / fmaxf(d_ue, kEps);
      const float wait = lam / (2.0f * mu * fmaxf(mu - lam, kEps));
      t_ue = 1.0f / fmaxf(mu, kEps) + wait;
    }
    const float ps = psi_row[c];
    const float t_tx = ps > 0.0f ? 8.0f * ps / rate : 0.0f;
    const float t_es = d_es > 0.0f ? d_es / f_es : 0.0f;

    const float energy = s.kappa * (f_ue * f_ue) * dl + p_tx_lam * t_tx;
    const float mem = ((s.gamma_ue * pp + pmax) +
                       (s.gamma_es * (tot_p - pp) + smax)) / 1e9f;
    o_row[c] = qe * energy + qm * mem + s.v * (t_ue + t_tx + t_es);
  }
}

template <int kLanes>
cudaError_t launch_rows(const float* macs, const float* params,
                        const float* acts, const float* psi, const int64_t* L,
                        const float* lam, const float* gain,
                        const float* q_energy, const float* q_memory,
                        const SweepScalars* scalars, float* out, int rows,
                        int C, int cell_rows, int n_total,
                        cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * (32 / kLanes);
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  partition_sweep_kernel<kLanes><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      macs, params, acts, psi, L, lam, gain, q_energy, q_memory, scalars, out,
      rows, C, cell_rows, n_total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int partition_sweep_launch(
    const float* macs, const float* params, const float* acts,
    const float* psi, const int64_t* L, const float* lam, const float* gain,
    const float* q_energy, const float* q_memory, const float* scalars,
    float* out, int rows, int C, int cell_rows, int n_total, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || C == 0) return 0;
  if (cell_rows <= 0 || rows % cell_rows != 0 || n_total <= 0)
    return (int)cudaErrorInvalidValue;
  const SweepScalars* sc = reinterpret_cast<const SweepScalars*>(scalars);
  const cudaStream_t s = (cudaStream_t)stream;
  // lanes a row: the least power of two >= C, at most 32
  const auto run = C <= 1 ? launch_rows<1> : C <= 2 ? launch_rows<2>
                 : C <= 4 ? launch_rows<4> : C <= 8 ? launch_rows<8>
                 : C <= 16 ? launch_rows<16> : launch_rows<32>;
  return (int)run(macs, params, acts, psi, L, lam, gain, q_energy, q_memory,
                  sc, out, rows, C, cell_rows, n_total, s);
}

extern "C" const char* partition_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
