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
// the H100's ops-per-byte line.  An SM issues at most 128 integer results
// a clock, 64 on each of two pipes: IMAD on the FMA pipe; add, logic,
// shift, abs and min/max on the integer pipe.  No prediction, upsampled
// block or difference ever reaches device memory.  No floats anywhere; all
// shifts are arithmetic shifts of signed int32 values.  Three thread
// mappings:
//
// * mip_cost_body (15 classes: SizeId 1 and SizeId 2 up to 32x32): one
//   thread per (CU, mode), the mode index fastest, so a warp covers one to
//   three CUs and its loads of the original window are near-broadcasts
//   served from L1; each thread keeps its reduced prediction in shared
//   memory (one column per thread, bank-conflict free) and makes upsampled
//   samples on demand per 4x4 block.
// * mip_cost_4x4 (mip_cost_sid0_kernel<4,4>, distortion.py:210
//   _kernel_sid0): one thread per CU, all 32 modes in its loop.  With one
//   thread per (CU, mode) the per-CU work (16 window and 8 boundary loads
//   with their clamping and edge rules, the reduced boundaries) was
//   repeated 32 times and the prediction went through shared memory, so
//   the load/store pipe, not the integer pipe, set the pace.  Here the
//   window and boundaries are loaded once (8-byte row loads, neighbouring
//   lanes on neighbouring CUs), each mode's 16x4 weights are read once for
//   both wings as warp-uniform 16-byte shared loads, the prediction stays
//   in registers (the transposed wing's r x r transposition is a
//   compile-time register permutation), and each thread writes its 2x16
//   costs as 16-byte stores.  What is left is the integer pipe: per
//   (CU, mode) the 64 multiply-adds go to the FMA pipe, but ~165 adds,
//   shifts, abs and min/max (clip is one DPX instruction) share the other.
// * mip_cost_64x64 (mip_cost_sid2_kernel<64,64>, distortion.py:400
//   _kernel): one block per CU, 8 threads per (CU, mode), one per anchor
//   band of 8 rows.  With one thread per (CU, mode) this class had only
//   ~104 k threads per 1080p batch of 16, each a 4096-sample serial loop
//   that made every upsampled sample from scratch (two horizontal
//   interpolations and ~4 shared loads per sample).  Here the block stages
//   the CU's window (clamped once, coalesced, int32, bank-swizzled) and
//   boundaries in shared memory and computes the 12 x 64 reduced
//   prediction there once; each thread upsamples separably, making the
//   horizontal values of its two anchor rows once per 4-column chunk and
//   reusing them for all 8 vertical phases (an IMAD and a shift per
//   sample), reads 4 window samples per 16-byte shared load, and the 8
//   partial SADs and SATDs are summed with warp shuffles.

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
  int rows8;               // orig rows may be read 8 bytes at a time
};

// One frame's samples, with the frame-edge rules.
struct Slab {
  const int16_t* __restrict__ orig;
  const int16_t* __restrict__ ref;
  const int16_t* __restrict__ halo;
  int height, width;
  bool is_top, rows8;

  __device__ __forceinline__ int orig_at(int y, int x) const {
    return __ldg(orig + (size_t)min(y, height - 1) * width + min(x, width - 1));
  }
  // Original samples (y, x..x+3): one 8-byte load where the four lie in
  // the frame's row and the row is 8-byte aligned, else four clamped loads.
  __device__ __forceinline__ void orig4(int y, int x, int* v) const {
    if (rows8 && (x & 3) == 0 && x + 3 < width) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(
          orig + (size_t)min(y, height - 1) * width + x));
      v[0] = (int)(u.x << 16) >> 16;
      v[1] = (int)u.x >> 16;
      v[2] = (int)(u.y << 16) >> 16;
      v[3] = (int)u.y >> 16;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = orig_at(y, x + i);
    }
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

__device__ __forceinline__ Slab frame_slab(const Args& a, int b) {
  return Slab{a.orig + b * a.frame_stride, a.ref + b * a.frame_stride,
              a.halo + (long long)b * a.width, a.height, a.width,
              a.is_top != 0, a.rows8 != 0};
}

// clip(p, 0, 1023) in one instruction: max(min(p, 1023), 0) (sm_90 DPX)
__device__ __forceinline__ int clip_sample(int p) { return __vimin_s32_relu(p, kSampleMax); }

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
  const Slab slab = frame_slab(a, b);

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

// One wing's reduced-prediction inputs: the C offsets against the first
// boundary sample, and the bias with that sample folded in, so that
// ((acc + 32 - 32 * sum) >> 6) + first == (acc + bias) >> 6 exactly.
template <int SID, int C>
struct Wing {
  int off[C];
  int bias;

  __device__ __forceinline__ explicit Wing(const int (&bnd)[C]) {
    const int first = bnd[0];
    off[0] = SID < 2 ? kValueDC - first : 0;
    int sum = off[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      off[c] = bnd[c] - first;
      sum += off[c];
    }
    bias = (1 << (kShift - 1)) - kOffset * sum + first * (1 << kShift);
  }
  // The clipped prediction sample of one weight row w[0..C) (16-byte
  // aligned in shared memory).  SizeId 2's first offset is 0: skipped.
  __device__ __forceinline__ int predict(const int32_t* w) const {
    int acc = bias;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(w)[q];
      const int wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (SID < 2 || 4 * q + c > 0) acc += wv[c] * off[4 * q + c];
      }
    }
    return clip_sample(acc >> kShift);
  }
};

// SAD and SATD of one 4x4 prediction against the window, both raster.
__device__ __forceinline__ void block_costs(const int (&org)[16], const int (&pred)[16],
                                            int& sad, int& satd) {
  int d[16];
  sad = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[i] = org[i] - pred[i];
    sad += abs(d[i]);
  }
  satd = satd4x4(d);
}

__device__ __forceinline__ void store4(int32_t* out, long long at, bool vec,
                                       const int (&v)[4]) {
  if (vec) {
    *reinterpret_cast<int4*>(out + at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[at + i] = v[i];
  }
}

// The 4x4 class: one thread per CU, its 2M = 32 modes in a loop.
__device__ __forceinline__ void mip_cost_4x4(const Args& a) {
  constexpr int M = SizeId<0>::M, R = SizeId<0>::R, S = R * R, C = 2 * SizeId<0>::BS;
  static_assert(M % 4 == 0 && C == 4, "SizeId 0 tables");
  __shared__ __align__(16) int32_t w_s[M * S * C];
  for (int i = threadIdx.x; i < M * S * C; i += kThreads) w_s[i] = __ldg(a.weights + i);
  __syncthreads();

  const int cu = blockIdx.x * kThreads + threadIdx.x;
  if (cu >= a.n_cu) return;
  const int y0 = __ldg(a.table + 3 * cu);
  const int x0 = __ldg(a.table + 3 * cu + 1);
  const int off = __ldg(a.table + 3 * cu + 2);
  const int b = blockIdx.y;
  const Slab slab = frame_slab(a, b);

  // ---- 1-2. the window (raster), the boundaries reduced to 2 a side
  int org[16];
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) slab.orig4(y0 + dy, x0, org + 4 * dy);
  int top[4], left[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    top[i] = slab.top(y0, x0, i);
    left[i] = slab.left(y0, x0, i);
  }
  const int rt0 = (top[0] + top[1] + 1) >> 1, rt1 = (top[2] + top[3] + 1) >> 1;
  const int rl0 = (left[0] + left[1] + 1) >> 1, rl1 = (left[2] + left[3] + 1) >> 1;
  const int bnd_n[C] = {rt0, rt1, rl0, rl1}, bnd_t[C] = {rl0, rl1, rt0, rt1};
  const Wing<0, C> wn(bnd_n), wt(bnd_t);

  // ---- 3-5. per mode, both wings from one read of its weights; the
  // transposed wing's sample s lands at its r x r transposition
  const long long at = (long long)b * a.out_stride + off;
  const bool two = a.out1 != nullptr;
  const bool vec = (reinterpret_cast<uintptr_t>(a.out0 + at) & 15) == 0 &&
                   (!two || (reinterpret_cast<uintptr_t>(a.out1 + at) & 15) == 0);
#pragma unroll 1
  for (int m0 = 0; m0 < M; m0 += 4) {
    int c0[2][4], c1[2][4];  // [wing][mode - m0]: msh or SAD, and SATD
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int32_t* wm = w_s + (m0 + i) * S * C;
      int pn[S], pt[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        pn[s] = wn.predict(wm + s * C);
        pt[(s % R) * R + s / R] = wt.predict(wm + s * C);
      }
      int sad, satd;
      block_costs(org, pn, sad, satd);
      c0[0][i] = two ? sad : min(2 * sad, satd);
      c1[0][i] = satd;
      block_costs(org, pt, sad, satd);
      c0[1][i] = two ? sad : min(2 * sad, satd);
      c1[1][i] = satd;
    }
#pragma unroll
    for (int wing = 0; wing < 2; ++wing) {
      store4(a.out0, at + wing * M + m0, vec, c0[wing]);
      if (two) store4(a.out1, at + wing * M + m0, vec, c1[wing]);
    }
  }
}

// The 64x64 class: one block per CU, kBands threads per (CU, mode).
constexpr int kBands = 8;                                // one per anchor band of 8 rows
constexpr int kThreads64 = 2 * SizeId<2>::M * kBands;    // 96

__device__ __forceinline__ void mip_cost_64x64(const Args& a) {
  constexpr int N = 64, R = SizeId<2>::R, M = SizeId<2>::M, S = R * R;
  constexpr int BS = SizeId<2>::BS, C = 2 * BS, UP = N / R, DS = N / BS;
  constexpr int ROW = R + 1;  // padded anchor-row stride: the bands of a warp on distinct banks
  static_assert(UP == kBands && C == 8, "64x64 geometry");
  // The original window, int32, row-major; the 16-byte chunk q of row y
  // sits at chunk position q ^ (y / 8), so the 8 bands of a warp, which
  // read the same chunk of 8 rows 8 apart, hit 8 distinct groups of banks.
  __shared__ __align__(16) int32_t win_s[N * N];
  __shared__ __align__(16) int32_t w_s[M * S * C];
  __shared__ __align__(16) int32_t bnd_s[2 * N];  // the top row, then the left column
  __shared__ int32_t red_s[C];                     // reduced top, then reduced left
  __shared__ int32_t anc_s[2 * M * R * ROW];       // reduced prediction [mode][row][col]

  const int tid = threadIdx.x, cu = blockIdx.x, b = blockIdx.y;
  const int y0 = __ldg(a.table + 3 * cu);
  const int x0 = __ldg(a.table + 3 * cu + 1);
  const int off = __ldg(a.table + 3 * cu + 2);
  const Slab slab = frame_slab(a, b);

  // ---- 1-2. the window, weights and boundaries into shared memory, the
  // clamping and edge rules applied once; the reduced boundaries
  for (int i = tid; i < N * N / 4; i += kThreads64) {
    const int y = i / (N / 4), q = i % (N / 4);
    int v[4];
    slab.orig4(y0 + y, x0 + 4 * q, v);
    *reinterpret_cast<int4*>(win_s + y * N + 4 * (q ^ (y / UP))) = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < M * S * C; i += kThreads64) w_s[i] = __ldg(a.weights + i);
  for (int i = tid; i < 2 * N; i += kThreads64) {
    bnd_s[i] = i < N ? slab.top(y0, x0, i) : slab.left(y0, x0, i - N);
  }
  __syncthreads();
  if (tid < C) {
    const int32_t* src = bnd_s + (tid / BS) * N + (tid % BS) * DS;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < DS; ++i) sum += src[i];
    red_s[tid] = (sum + (DS >> 1)) >> ilog2(DS);
  }
  __syncthreads();

  // ---- 3. thread (m, k) makes anchor row k of mode m; the transposed
  // wing's sample (k, j) is the weights' row (j, k) on (left, top) inputs
  const int m = tid / kBands, k = tid % kBands;
  const bool transposed = m >= M;
  const int mode = transposed ? m - M : m;
  int bnd[C];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    bnd[i] = red_s[transposed ? BS + i : i];
    bnd[BS + i] = red_s[transposed ? i : BS + i];
  }
  const Wing<2, C> wing(bnd);
  int* anc = anc_s + m * R * ROW;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    anc[k * ROW + j] = wing.predict(w_s + (mode * S + (transposed ? j * R + k : k * R + j)) * C);
  }
  __syncthreads();

  // ---- 4-5. band k: rows UP*k .. UP*k+7, upsampled between anchor rows
  // k-1 (the top row for band 0) and k, one 4-column chunk at a time
  const int32_t* left = bnd_s + N;
  const int kp = k > 0 ? k - 1 : 0;
  int cur_b = left[UP * k + UP - 1];            // left of anchor row k
  int prev_b = left[k > 0 ? UP * k - 1 : 0];     // left of anchor row k-1
  const int32_t* band = win_s + UP * k * N;  // the band's first row
  int sad = 0, satd = 0;
#pragma unroll 1
  for (int j = 0; j < R; ++j) {
    const int cur_a = anc[k * ROW + j], prev_a = anc[kp * ROW + j];
#pragma unroll
    for (int h = 0; h < UP / 4; ++h) {
      const int xc = UP * j + 4 * h;
      const int32_t* chunk = band + 4 * ((xc / 4) ^ k);
      const int4 t4 = *reinterpret_cast<const int4*>(bnd_s + xc);
      const int tv[4] = {t4.x, t4.y, t4.z, t4.w};
      // the chunk's horizontal values on both anchor rows, as the
      // vertical pass's (UP * before + UP/2, after - before)
      int base[4], dlt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = 4 * h + i + 1;
        const int ch = (UP * cur_b + (UP >> 1) + o * (cur_a - cur_b)) >> ilog2(UP);
        const int ph = k > 0 ? (UP * prev_b + (UP >> 1) + o * (prev_a - prev_b)) >> ilog2(UP)
                             : tv[i];
        base[i] = UP * ph + (UP >> 1);
        dlt[i] = ch - ph;
      }
#pragma unroll
      for (int blk = 0; blk < UP / 4; ++blk) {
        int d[16];
#pragma unroll
        for (int dy = 0; dy < 4; ++dy) {
          const int row = 4 * blk + dy;
          const int4 o4 = *reinterpret_cast<const int4*>(chunk + row * N);
          const int org[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[4 * dy + i] = org[i] - ((base[i] + (row + 1) * dlt[i]) >> ilog2(UP));
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) sad += abs(d[i]);
        satd += satd4x4(d);
      }
    }
    cur_b = cur_a;
    prev_b = prev_a;
  }
  // the 8 bands of a (CU, mode) are 8 neighbouring lanes of one warp
#pragma unroll
  for (int s = 1; s < kBands; s <<= 1) {
    sad += __shfl_xor_sync(0xffffffffu, sad, s);
    satd += __shfl_xor_sync(0xffffffffu, satd, s);
  }
  if (k == 0) {
    const long long at = (long long)b * a.out_stride + off + m;
    if (a.out1 != nullptr) {
      a.out0[at] = sad;
      a.out1[at] = satd;
    } else {
      a.out0[at] = min(2 * sad, satd);
    }
  }
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid0_kernel(Args a) {
  static_assert(W == 4 && H == 4, "SizeId 0 is the 4x4 class");
  mip_cost_4x4(a);
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid1_kernel(Args a) {
  mip_cost_body<W, H, 1>(a);
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid2_kernel(Args a) {
  if constexpr (W == 64 && H == 64) {
    mip_cost_64x64(a);
  } else {
    mip_cost_body<W, H, 2>(a);
  }
}

template <int W, int H, int SID>
int launch(const int16_t* orig, const int16_t* ref, const int16_t* halo,
           const int32_t* table, int n_cu, const int32_t* weights, int batch,
           int height, int width, int is_top, int32_t* out0, int32_t* out1,
           long long out_stride, void* stream) {
  const int rows8 = width % 4 == 0 && (reinterpret_cast<uintptr_t>(orig) & 7) == 0;
  const Args a{orig, ref, halo, table, weights, out0, out1,
               (long long)height * width, out_stride, n_cu, height, width, is_top, rows8};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (SID == 0) {
    const dim3 grid((unsigned)((n_cu + kThreads - 1) / kThreads), (unsigned)batch);
    mip_cost_sid0_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
  } else if constexpr (SID == 2 && W == 64 && H == 64) {
    mip_cost_sid2_kernel<W, H><<<dim3((unsigned)n_cu, (unsigned)batch), kThreads64, 0, s>>>(a);
  } else {
    const long long items = (long long)n_cu * 2 * SizeId<SID>::M;
    const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), (unsigned)batch);
    if constexpr (SID == 1) {
      mip_cost_sid1_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
    } else {
      mip_cost_sid2_kernel<W, H><<<grid, kThreads, 0, s>>>(a);
    }
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
