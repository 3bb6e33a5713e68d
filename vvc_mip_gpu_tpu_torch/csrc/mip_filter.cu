// Hand-written Hopper (sm_90a) kernel: the 8 low-pass filter variants of the
// alternative-samples regime (ops/filters.py), one launch per [N, H, W] batch.
//
// Replaces no pl.pallas_call: the JAX package's filter
// (vvc_mip_gpu_tpu/ops/filters.py) is jnp code that XLA fuses.  It was added
// because the port's plain version, some twenty whole-tensor torch passes
// (a pad, a multiply and an add per tap, the rounding and the division), ran
// at 3 % of its bound on this card.
//
// Semantics (those of ops/filters.py `_plan`, reference intra.cl:1175-3824):
//   2d:  acc = sum of c[i][j] * x[y+i-r][x+j-r] over the K x K taps, in raster
//        order, zero outside the frame; the divisor is the sum of the
//        in-frame coefficients.
//   1d:  h = sum_j c[j] * x[y][x+j-r] (zero outside), then
//        acc = sum_i c[i] * h[y+i-r] (zero outside); the divisor is the
//        reference's closed-form 3x3 scale or the 5x5 sub-window sum.
//   int:   (acc + scale / 2) floor-divided by scale, int32 arithmetic that
//          wraps as torch's does.
//   float: floor(acc / scale + 0.5) in float32, each product, sum and the
//          quotient correctly rounded (__fmul_rn, __fadd_rn, __fdiv_rn), in
//          the plain version's order, so the result is that of torch's
//          float32 passes for any input (for 10-bit samples every sum is an
//          exact integer below 2^24 and only the quotient rounds).
// The divisor depends only on how many taps of each side fall inside the
// frame: up = min(r, y), down = min(r, h-1-y), left = min(r, x),
// right = min(r, w-1-x).  The wrapper hands the (r+1)^4 values of that table
// (taken from `_plan`'s plane) in the kernel's parameters, so no divisor
// plane is read from device memory.
//
// Bound on this card: bytes.  A 3840x2160 batch of 16 is 132.7 M samples,
// read once as int32 and written once as int32: 1.06 GB, 0.317 ms at
// 3.35 TB/s; its 2.65 G integer operations need 0.079 ms.  Design: each warp
// streams one strip of rows of one 128-column group of one frame down its
// rows.  A lane owns 4 columns: one 16-byte load per input row, the r halo
// columns from its neighbours by warp shuffles (lanes 0 and 31 read theirs),
// and one 16-byte store per output row.  A row's contributions go into K
// rolling accumulators (the output rows it touches), so each input row
// crosses device memory once per strip, plus 2r halo rows per strip (most of
// them L2 hits); nothing intermediate is written.  Two rows are loaded
// ahead of the one being summed.  Interior samples divide by the constant
// interior divisor as a multiply-high by its exact reciprocal
// (Granlund-Montgomery, round-up); edge samples look their divisor up.  No
// shared memory and no block barrier.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // warps a block, each on its own strip
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;              // output columns a lane
constexpr int kCols = 32 * kVec;     // columns a warp
constexpr int kMaxTaps = 25;         // 5 x 5
constexpr int kMaxScales = 81;       // (2 + 1)^4 edge classes at radius 2
constexpr int kStripRows = 64;       // the longest strip
constexpr int kMinStripRows = 8;
constexpr long long kTargetWarps = 4096;  // about one wave on 132 SMs
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* in;
  int32_t* out;
  int h, w;
  int strip_rows, strips, col_groups;
  long long units;  // warps with work: frames x strips x column groups
  int vec;          // rows start aligned: vector loads and stores
  int taps[kMaxTaps];     // 2d: K x K raster; 1d: K
  float ftaps[kMaxTaps];  // the same, as float32
  int scales[kMaxScales];  // [up][down][left][right], each in 0..r
  int inner_scale;         // scales[r][r][r][r]
  unsigned inner_magic;    // ceil(2^(31+l) / inner_scale)
  int inner_shift;         // 31 + l, l = ceil(log2(inner_scale))
};

template <int R>
struct Row {
  int v[kVec];   // this lane's 4 columns
  int left[R];   // lane 0: the r columns before the warp's
  int right[R];  // lane 31: the r columns after the warp's
};

__device__ __forceinline__ void load4(const int32_t* p, int v[kVec]) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Row y of the frame (zeros where y is outside it, or y < 0 asks for none).
template <int R>
__device__ __forceinline__ void load_row(const Params& p,
                                         const int32_t* frame,
                                         int y, int x0, int lane,
                                         Row<R>& row) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) row.v[e] = 0;
#pragma unroll
  for (int t = 0; t < R; ++t) row.left[t] = row.right[t] = 0;
  if (y < 0 || y >= p.h) return;  // the same for the whole warp
  const int32_t* src = frame + (size_t)y * p.w;
  if (p.vec && x0 + kVec <= p.w) {
    load4(src + x0, row.v);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (x0 + e < p.w) row.v[e] = __ldg(src + x0 + e);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int x = x0 - R + t;
      if (x >= 0 && x < p.w) row.left[t] = __ldg(src + x);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int x = x0 + kVec + t;
      if (x < p.w) row.right[t] = __ldg(src + x);
    }
  }
}

template <bool FLOAT> struct Arith;

template <> struct Arith<false> {  // int32 that wraps, as torch's
  using T = uint32_t;
  __device__ __forceinline__ static T from(int v) { return (uint32_t)v; }
  __device__ __forceinline__ static T tap(const Params& p, int i) {
    return (uint32_t)p.taps[i];
  }
  __device__ __forceinline__ static T mul(T c, T x) { return c * x; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
};

template <> struct Arith<true> {  // float32, every step rounded once
  using T = float;
  __device__ __forceinline__ static T from(int v) { return __int2float_rn(v); }
  __device__ __forceinline__ static T tap(const Params& p, int i) {
    return p.ftaps[i];
  }
  __device__ __forceinline__ static T mul(T c, T x) { return __fmul_rn(c, x); }
  __device__ __forceinline__ static T add(T a, T b) { return __fadd_rn(a, b); }
};

// floor((acc + scale / 2) / scale) for scale > 0, in int32 that wraps.
__device__ __forceinline__ int round_div(uint32_t acc, int scale) {
  const int n = (int)(acc + (uint32_t)(scale >> 1));
  const int q = n / scale;  // truncates toward zero
  return q - (q * scale > n);
}

__device__ __forceinline__ int round_div(float acc, int scale) {
  return (int)floorf(__fadd_rn(__fdiv_rn(acc, __int2float_rn(scale)), 0.5f));
}

// The same with the interior divisor, by its reciprocal where n >= 0.
__device__ __forceinline__ int round_div_inner(uint32_t acc,
                                               const Params& p) {
  const int n = (int)(acc + (uint32_t)(p.inner_scale >> 1));
  if (n < 0) return round_div(acc, p.inner_scale);
  return (int)(((unsigned long long)(unsigned)n * p.inner_magic) >>
               p.inner_shift);
}

__device__ __forceinline__ int round_div_inner(float acc, const Params& p) {
  return round_div(acc, p.inner_scale);
}

template <int R>
__device__ __forceinline__ int scale_at(const Params& p, int y, int x) {
  const int up = min(R, y), down = min(R, p.h - 1 - y);
  const int left = min(R, x), right = max(0, min(R, p.w - 1 - x));
  return p.scales[((up * (R + 1) + down) * (R + 1) + left) * (R + 1) + right];
}

template <int K, bool SEP, bool FLOAT>
__global__ void __launch_bounds__(kThreads)
mip_filter_kernel(const __grid_constant__ Params p) {
  constexpr int R = K / 2;
  constexpr int W = kVec + 2 * R;  // the window a lane sums over
  using A = Arith<FLOAT>;
  using T = typename A::T;

  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= p.units) return;  // whole warps
  const int cg = (int)(unit % p.col_groups);
  const long long fs = unit / p.col_groups;
  const int strip = (int)(fs % p.strips);
  const long long f = fs / p.strips;
  const int x0 = cg * kCols + lane * kVec;
  const int y0 = strip * p.strip_rows;
  const int y1 = min(y0 + p.strip_rows, p.h);
  const int32_t* frame = p.in + (size_t)f * p.h * p.w;
  int32_t* out = p.out + (size_t)f * p.h * p.w;
  const bool inner_cols = x0 >= R && x0 + kVec + R <= p.w;

  // acc[s]: output row rho - R + s, the rows the input row rho reaches
  T acc[K][kVec];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[s][e] = T(0);

  const int end = y1 + R;  // input rows y0 - R .. end - 1
  int rho = y0 - R;
  Row<R> r0, r1, r2;
  load_row<R>(p, frame, rho, x0, lane, r0);
  load_row<R>(p, frame, rho + 1 < end ? rho + 1 : -1, x0, lane, r1);
#pragma unroll 1
  for (; rho < end; ++rho) {
    load_row<R>(p, frame, rho + 2 < end ? rho + 2 : -1, x0, lane, r2);

    T x[W];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int from = __shfl_up_sync(kFull, r0.v[kVec - R + t], 1);
      x[t] = A::from(lane == 0 ? r0.left[t] : from);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[R + e] = A::from(r0.v[e]);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int from = __shfl_down_sync(kFull, r0.v[t], 1);
      x[R + kVec + t] = A::from(lane == 31 ? r0.right[t] : from);
    }

    if constexpr (SEP) {
      T hs[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        hs[e] = A::mul(A::tap(p, 0), x[e]);
#pragma unroll
        for (int j = 1; j < K; ++j)
          hs[e] = A::add(hs[e], A::mul(A::tap(p, j), x[e + j]));
      }
#pragma unroll
      for (int s = 0; s < K; ++s)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[s][e] = A::add(acc[s][e], A::mul(A::tap(p, K - 1 - s), hs[e]));
    } else {
#pragma unroll
      for (int s = 0; s < K; ++s)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc[s][e] = A::add(acc[s][e],
                               A::mul(A::tap(p, (K - 1 - s) * K + j),
                                      x[e + j]));
    }

    const int y = rho - R;  // complete in acc[0]
    if (y >= y0) {
      int q[kVec];
      if (inner_cols && y >= R && y + R < p.h) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) q[e] = round_div_inner(acc[0][e], p);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          q[e] = round_div(acc[0][e], scale_at<R>(p, y, x0 + e));
      }
      int32_t* dst = out + (size_t)y * p.w + x0;
      if (p.vec && x0 + kVec <= p.w) {
        *reinterpret_cast<int4*>(dst) = make_int4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (x0 + e < p.w) dst[e] = q[e];
      }
    }

#pragma unroll
    for (int s = 0; s + 1 < K; ++s)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[s][e] = acc[s + 1][e];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[K - 1][e] = T(0);
    r0 = r1;
    r1 = r2;
  }
}

template <int K, bool SEP, bool FLOAT>
int launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.units + kWarps - 1) / kWarps;
  mip_filter_kernel<K, SEP, FLOAT>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const Params& p, int separable, int as_float,
             cudaStream_t stream) {
  if (separable)
    return as_float ? launch<K, true, true>(p, stream)
                    : launch<K, true, false>(p, stream);
  return as_float ? launch<K, false, true>(p, stream)
                  : launch<K, false, false>(p, stream);
}

}  // namespace

// One launch filters the whole batch.  in: [n, h, w] int32, contiguous;
// k: 3 or 5; separable: the 1d variants; as_float: the float variants;
// taps: k*k raster coefficients (2d) or k (1d); scales: the (k/2+1)^4
// divisors by [up][down][left][right] in-frame taps; out: [n, h, w] int32.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int mip_filter(const int32_t* in, int n, int h, int w,
                          int k, int separable, int as_float,
                          const int* taps, const int* scales, int32_t* out,
                          void* stream) {
  if ((k != 3 && k != 5) || n <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const int r = k / 2;
  const int n_taps = separable ? k : k * k;
  const int n_scales = (r + 1) * (r + 1) * (r + 1) * (r + 1);
  Params p = {};
  p.in = in;
  p.out = out;
  p.h = h;
  p.w = w;
  for (int i = 0; i < n_taps; ++i) {
    p.taps[i] = taps[i];
    p.ftaps[i] = (float)taps[i];
  }
  for (int i = 0; i < n_scales; ++i) {
    if (scales[i] <= 0) return (int)cudaErrorInvalidValue;
    p.scales[i] = scales[i];
  }
  const unsigned d = (unsigned)scales[n_scales - 1];
  int l = 0;
  while ((1u << l) < d) ++l;
  p.inner_scale = (int)d;
  p.inner_shift = 31 + l;
  p.inner_magic = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
  p.vec = w % kVec == 0 &&
          reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  p.col_groups = (w + kCols - 1) / kCols;
  p.strip_rows = kStripRows;
  auto units = [&](int rows) {
    return (long long)n * ((h + rows - 1) / rows) * p.col_groups;
  };
  while (p.strip_rows > kMinStripRows && units(p.strip_rows) < kTargetWarps)
    p.strip_rows /= 2;
  p.strips = (h + p.strip_rows - 1) / p.strip_rows;
  p.units = units(p.strip_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k == 3 ? launch_k<3>(p, separable, as_float, s)
                : launch_k<5>(p, separable, as_float, s);
}
