// Hand-written Hopper (sm_90a) kernels for the VVC MIP mode-search costs.
//
// For every CU of one shape class in every frame of a batch, and for every
// MIP mode m in [0, 2M) (modes 0..M-1 the normal wing, M..2M-1 the
// transposed wing), each kernel computes the reference's
// MIP_ReducedPred + upsampleDistortion chain (intra.cl:443-539, 545-1171):
//
//   1. load: the CU's top and left boundaries and its original samples,
//      read straight from the int16 frames with coordinates clamped to the
//      frame (the same values as edge-replication padding), with the VVC
//      frame-top / frame-left / corner rules (intra.cl:96-107, 232-243);
//   2. boundary reduce: (sum + ds/2) >> log2(ds) down to BS samples a side;
//   3. prediction: exact int32 MIP matrix product on the CUDA cores,
//      pred = clip(((W . off + 32 - 32 * sum(off)) >> 6) + first, 0, 1023);
//   4. upsampling (SizeId 1/2): horizontal first, anchored on the left
//      boundary at rows (k+1)*up_v-1, then vertical against the top row;
//   5. costs: SAD and the VTM 4x4 Hadamard SATD, written straight into the
//      reference strided layout [B, nCTU * 97840] at the CU table's offset
//      (min(2*SAD, SATD) alone in the max-performance regime).
//
// The TPU kernels these replace (vvc_mip_gpu_tpu/ops/pallas/):
//   mip_cost_sid0_kernel  distortion.py:210 _kernel_sid0 (the 4x4 class)
//   mip_cost_sid1_kernel  distortion.py:275 _kernel_mode_minor (SizeId1),
//                         and the load role of rowband.py:251
//                         _kernel_rowband_mm (8x8, 8x4)
//   mip_cost_sid2_kernel  distortion.py:400 _kernel (SizeId2), and the load
//                         role of rowband.py:90 _kernel_rowband (16x8, 8x16,
//                         16x16, 16x32)
// All three serve the role of gather.py:64 (fetch_rows, the left-boundary
// relayout): each thread reads its CU's left column from the frame itself.
// The TPU's bf16 limb split of the prediction and its %4-grouped sample
// orders were Mosaic/MXU devices and have no counterpart here.
//
// Bound on this card: integer operations.  A 1080p frame needs ~13.8 G
// int32 operations and moves well under 1 GB, so the kernels sit far above
// the H100's ops-per-byte line.  Design: one thread per (CU, mode), the
// mode index fastest, so a warp covers one to three CUs and its loads of
// the original window are near-broadcasts served from L1; each thread
// keeps its reduced prediction in shared memory (one column per thread,
// bank-conflict free) and makes upsampled samples on demand per 4x4 block,
// so no prediction, upsampled block or difference ever reaches device
// memory.  No floats anywhere; all shifts are arithmetic shifts of signed
// int32 values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValueDC = 512;    // 1 << (bitdepth - 1)
constexpr int kSampleMax = 1023;
constexpr int kShift = 6;        // MIP_SHIFT_MATRIX
constexpr int kOffset = 32;      // MIP_OFFSET_MATRIX

template <int SID> struct SizeId;
template <> struct SizeId<0> { static constexpr int R = 4, BS = 2, M = 16; };
template <> struct SizeId<1> { static constexpr int R = 4, BS = 4, M = 8; };
template <> struct SizeId<2> { static constexpr int R = 8, BS = 4, M = 6; };

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v >> 1) : 0; }

struct Args {
  const int16_t* orig;     // [B, height, width] distortion targets
  const int16_t* ref;      // [B, height, width] boundary sources
  const int16_t* halo;     // [B, width] rows above the slabs
  const int32_t* table;    // [n_cu, 3] (y0, x0, offset in a frame's slab)
  const int32_t* weights;  // [M, S, C] int32 MIP matrices
  int32_t* out0;           // msh, or sad when out1 is set
  int32_t* out1;           // satd, or null (max-performance regime)
  long long frame_stride;  // height * width
  long long out_stride;    // nCTU * 97840
  int n_cu, height, width, is_top;
};

// One frame's samples, with the frame-edge rules.
struct Slab {
  const int16_t* __restrict__ orig;
  const int16_t* __restrict__ ref;
  const int16_t* __restrict__ halo;
  int height, width;
  bool is_top;

  __device__ __forceinline__ int orig_at(int y, int x) const {
    return __ldg(orig + (size_t)min(y, height - 1) * width + min(x, width - 1));
  }
  __device__ __forceinline__ int ref_at(int y, int x) const {
    return __ldg(ref + (size_t)min(y, height - 1) * width + min(x, width - 1));
  }
  // Sample i of the row above the CU at (y0, x0).  At the frame's top row
  // every sample is the frame sample left of the CU (DC at the corner).
  __device__ __forceinline__ int top(int y0, int x0, int i) const {
    if (y0 == 0) {
      if (is_top) return x0 == 0 ? kValueDC : ref_at(0, x0 - 1);
      return __ldg(halo + min(x0 + i, width - 1));
    }
    return ref_at(y0 - 1, x0 + i);
  }
  // Sample j of the column left of the CU.  At the frame's left column
  // every sample is the one above the CU (the halo row at y0 == 0), or DC
  // at the frame's top-left corner.
  __device__ __forceinline__ int left(int y0, int x0, int j) const {
    if (x0 == 0) {
      if (y0 == 0) return is_top ? kValueDC : __ldg(halo);
      return ref_at(y0 - 1, 0);
    }
    return ref_at(y0 + j, x0 - 1);
  }
};

// VVC linear interpolation at phase o in 1..UP between two anchors
// (intra.cl:815-895); UP == 1 returns the anchor.
template <int UP>
__device__ __forceinline__ int interp(int before, int after, int o) {
  return ((UP - o) * before + o * after + (UP >> 1)) >> ilog2(UP);
}

__device__ __forceinline__ void hadamard4(int& a, int& b, int& c, int& d) {
  const int s0 = a + b, s1 = c + d, d0 = a - b, d1 = c - d;
  a = s0 + s1;
  b = s0 - s1;
  c = d0 - d1;
  d = d0 + d1;
}

// VTM mean-scaled SATD of one 4x4 difference block, raster d[4*y + x]
// (kernel_aux_functions.cl:142-249).  Overwrites d.
__device__ __forceinline__ int satd4x4(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) hadamard4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) hadamard4(d[j], d[4 + j], d[8 + j], d[12 + j]);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc += abs(d[i]);
  const int dc = abs(d[0]);
  return (acc - dc + (dc >> 2) + 1) >> 1;
}

template <int W, int H, int SID>
__device__ __forceinline__ void mip_cost_body(const Args& a) {
  using P = SizeId<SID>;
  constexpr int R = P::R, BS = P::BS, M = P::M;
  constexpr int TWO_M = 2 * M, S = R * R, C = 2 * BS;
  constexpr int UP_H = W / R, UP_V = H / R;
  constexpr int DS_T = W / BS, DS_L = H / BS;
  // Per-mode stride of the weights in shared memory: one word of padding
  // puts the different modes of a warp on different banks.
  constexpr int WSTRIDE = S * C + 1;
  static_assert(W % R == 0 && H % R == 0 && W % 4 == 0 && H % 4 == 0, "CU shape");
  static_assert(W % BS == 0 && H % BS == 0, "boundary size");

  __shared__ int32_t w_s[M * WSTRIDE];
  __shared__ int16_t pred_s[S * kThreads];

  for (int i = threadIdx.x; i < M * S * C; i += kThreads) {
    w_s[(i / (S * C)) * WSTRIDE + i % (S * C)] = __ldg(a.weights + i);
  }
  __syncthreads();

  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= a.n_cu * TWO_M) return;
  const int cu = item / TWO_M;
  const int m = item - cu * TWO_M;
  const int y0 = __ldg(a.table + 3 * cu);
  const int x0 = __ldg(a.table + 3 * cu + 1);
  const int off = __ldg(a.table + 3 * cu + 2);
  const int b = blockIdx.y;
  const Slab slab{a.orig + b * a.frame_stride, a.ref + b * a.frame_stride,
                  a.halo + (long long)b * a.width, a.height, a.width, a.is_top != 0};

  // ---- 1-2. boundaries, reduced to BS samples a side
  int red_t[BS], red_l[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    int st = 0, sl = 0;
#pragma unroll
    for (int k = 0; k < DS_T; ++k) st += slab.top(y0, x0, i * DS_T + k);
#pragma unroll
    for (int k = 0; k < DS_L; ++k) sl += slab.left(y0, x0, i * DS_L + k);
    red_t[i] = DS_T > 1 ? (st + (DS_T >> 1)) >> ilog2(DS_T) : st;
    red_l[i] = DS_L > 1 ? (sl + (DS_L >> 1)) >> ilog2(DS_L) : sl;
  }

  // ---- 3. reduced prediction of this thread's mode: (top, left) inputs
  // for the normal wing, (left, top) and transposed output for the other.
  const bool transposed = m >= M;
  const int mode = transposed ? m - M : m;
  int offs[C];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    offs[i] = transposed ? red_l[i] : red_t[i];
    offs[BS + i] = transposed ? red_t[i] : red_l[i];
  }
  const int first = offs[0];
  offs[0] = SID < 2 ? kValueDC - first : 0;
  int sum = offs[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    offs[c] -= first;
    sum += offs[c];
  }
  const int bias = (1 << (kShift - 1)) - kOffset * sum;
  const int32_t* wm = w_s + mode * WSTRIDE;
  int16_t* pred = pred_s + threadIdx.x;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const int sp = transposed ? (s % R) * R + s / R : s;  // r x r transposition
    int acc = bias;
#pragma unroll
    for (int c = 0; c < C; ++c) acc += wm[sp * C + c] * offs[c];
    const int p = (acc >> kShift) + first;
    pred[s * kThreads] = (int16_t)min(max(p, 0), kSampleMax);
  }

  // ---- 4. upsampled prediction sample (y, x), made on demand
  auto anchor = [&](int k, int j) -> int { return pred[(k * R + j) * kThreads]; };
  auto hor = [&](int k, int x) -> int {  // anchor row k, upsampled along x
    if (UP_H == 1) return anchor(k, x);
    const int j = x / UP_H, o = x % UP_H + 1;
    const int after = anchor(k, j);
    if (o == UP_H) return after;
    const int before = j ? anchor(k, j - 1) : slab.left(y0, x0, (k + 1) * UP_V - 1);
    return interp<UP_H>(before, after, o);
  };
  auto upsampled = [&](int y, int x) -> int {
    if (UP_V == 1) return hor(y, x);
    const int k = y / UP_V, o = y % UP_V + 1;
    const int after = hor(k, x);
    if (o == UP_V) return after;
    const int before = k ? hor(k - 1, x) : slab.top(y0, x0, x);
    return interp<UP_V>(before, after, o);
  };

  // ---- 5. SAD and SATD over the CU's 4x4 blocks
  int sad = 0, satd = 0;
#pragma unroll 1
  for (int by = 0; by < H / 4; ++by) {
#pragma unroll 1
    for (int bx = 0; bx < W / 4; ++bx) {
      int d[16];
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          const int y = 4 * by + dy, x = 4 * bx + dx;
          d[4 * dy + dx] = slab.orig_at(y0 + y, x0 + x) - upsampled(y, x);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) sad += abs(d[i]);
      satd += satd4x4(d);
    }
  }

  const long long at = (long long)b * a.out_stride + off + m;
  if (a.out1 != nullptr) {
    a.out0[at] = sad;
    a.out1[at] = satd;
  } else {
    a.out0[at] = min(2 * sad, satd);
  }
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid0_kernel(Args a) {
  mip_cost_body<W, H, 0>(a);
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid1_kernel(Args a) {
  mip_cost_body<W, H, 1>(a);
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid2_kernel(Args a) {
  mip_cost_body<W, H, 2>(a);
}

template <int W, int H, int SID>
int launch(const int16_t* orig, const int16_t* ref, const int16_t* halo,
           const int32_t* table, int n_cu, const int32_t* weights, int batch,
           int height, int width, int is_top, int32_t* out0, int32_t* out1,
           long long out_stride, void* stream) {
  const Args a{orig, ref, halo, table, weights, out0, out1,
               (long long)height * width, out_stride, n_cu, height, width, is_top};
  const long long items = (long long)n_cu * 2 * SizeId<SID>::M;
  const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (SID == 0) {
    mip_cost_sid0_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
  } else if constexpr (SID == 1) {
    mip_cost_sid1_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
  } else {
    mip_cost_sid2_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One C launcher per class: mip_cost_sid<SizeId>_<W>x<H>.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously
// on `stream`.
#define MIP_COST_LAUNCHER(SID, W, H)                                             \
  extern "C" int mip_cost_sid##SID##_##W##x##H(                                  \
      const int16_t* orig, const int16_t* ref, const int16_t* halo,              \
      const int32_t* table, int n_cu, const int32_t* weights, int batch,         \
      int height, int width, int is_top, int32_t* out0, int32_t* out1,           \
      long long out_stride, void* stream) {                                      \
    return launch<W, H, SID>(orig, ref, halo, table, n_cu, weights, batch,       \
                             height, width, is_top, out0, out1, out_stride,      \
                             stream);                                            \
  }

MIP_COST_LAUNCHER(0, 4, 4)
MIP_COST_LAUNCHER(1, 32, 4)
MIP_COST_LAUNCHER(1, 4, 32)
MIP_COST_LAUNCHER(1, 16, 4)
MIP_COST_LAUNCHER(1, 4, 16)
MIP_COST_LAUNCHER(1, 8, 8)
MIP_COST_LAUNCHER(1, 8, 4)
MIP_COST_LAUNCHER(1, 4, 8)
MIP_COST_LAUNCHER(2, 64, 64)
MIP_COST_LAUNCHER(2, 32, 32)
MIP_COST_LAUNCHER(2, 32, 16)
MIP_COST_LAUNCHER(2, 16, 32)
MIP_COST_LAUNCHER(2, 32, 8)
MIP_COST_LAUNCHER(2, 8, 32)
MIP_COST_LAUNCHER(2, 16, 16)
MIP_COST_LAUNCHER(2, 16, 8)
MIP_COST_LAUNCHER(2, 8, 16)
