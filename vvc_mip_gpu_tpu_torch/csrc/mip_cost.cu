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
// relayout): each block reads its CUs' left columns from the frame itself.
// The TPU's bf16 limb split of the prediction and its %4-grouped sample
// orders were Mosaic/MXU devices and have no counterpart here.
//
// Bound on this card: integer operations.  A 1080p frame needs ~13.8 G
// int32 operations and moves well under 1 GB, so the kernels sit far above
// the H100's ops-per-byte line.  An SM issues at most 128 integer results
// a clock, 64 on each of two pipes: IMAD on the FMA pipe; add, logic,
// shift, abs and min/max on the integer pipe.  Per sample the costs need
// ~7 integer-pipe operations (difference, SAD's abs and add, the two
// butterfly passes, SATD's abs and add) and the upsampling a multiply-add
// and a shift, so the integer pipe sets the pace wherever the per-CU and
// per-mode work is done once and not once per sample.  No prediction,
// upsampled block or difference ever reaches device memory.  No floats
// anywhere; all shifts are arithmetic shifts of signed int32 values.
// Three thread mappings:
//
// * mip_cost_tile (mip_cost_sid1_kernel, all 7 classes; mip_cost_sid2_kernel
//   below 64x64, 8 classes): a block of G = 16 / NS CUs, NS = W / 4
//   four-column strips a CU, one thread per (CU, normal-wing mode m,
//   strip), which takes both wings (modes m and M + m): 128 threads a
//   block for SizeId 1, 96 for SizeId 2.  One thread per (CU, mode), as
//   before, repeated the per-CU work 2M times (clamped boundary loads with
//   their edge branches, the boundary reduction, one clamped global load
//   per original sample), remade both horizontal interpolations of every
//   upsampled sample for each vertical phase, and gave 32x32 only ~415 k
//   threads per 1080p batch of 16, each a 1024-sample serial loop.  Here
//   the block stages its CUs' windows (clamped once, 8-byte row loads,
//   int32; the per-CU stride padded by NS 16-byte chunks so that the CUs a
//   warp spans fall on distinct banks), their raw top rows and left
//   columns (the edge rules applied once per element) and the weights, as
//   int8 (they are 0..127), in shared memory; reduces each CU's boundaries
//   once; and computes the R x R prediction of every (CU, mode) once, into
//   shared memory as int16.  A prediction item is (weight row, CU): the G
//   lanes of one row share its 8-byte load, the item makes both wings from
//   it (the transposed wing is a transposed store), and DP2A makes two of
//   the C = 8 products an instruction, the offsets packed as int16 pairs.
//   Each thread then walks its strip top to bottom, one wing after the
//   other: per anchor row it makes the 4 horizontal values once (from 1-3
//   anchors, or the raw left sample at row (k+1)*UP_V-1) and reuses them
//   for all UP_V vertical phases as (UP_V*before + UP_V/2 + o*(after -
//   before)) >> log2(UP_V), one multiply-add and a shift a sample; the
//   unused pass of UP_H == 1 or UP_V == 1 drops out at compile time.  It
//   reads 4 window samples per 16-byte shared load; the NS partial SADs
//   and SATDs are summed with warp shuffles, and the block's G x 2M costs
//   go out from shared memory as 16-byte stores where the output is
//   aligned (a scalar fallback where not).  What bounds it is the issue
//   rate of integer instructions: ~9-10 a sample for the costs and the
//   upsampling, and, on the small classes, the staging, 4 barriers and the
//   prediction (64 rows a (CU, mode) for SizeId 2) over few samples a
//   thread.  Taking both wings in a thread halves the per-thread setup,
//   staging and shuffles a sample; the wing loop is not unrolled (two
//   unrolled strips scheduled together need twice the registers), and
//   the 4-wide classes walk their strip as a loop over groups of anchor
//   rows (unrolled, ptxas hoists all their window loads: up to 231
//   registers).
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
//   band of 8 rows.  The block stages the CU's window (clamped once,
//   coalesced, int32, bank-swizzled) and boundaries in shared memory and
//   computes the 12 x 64 reduced prediction there once; each thread
//   upsamples separably as mip_cost_tile does, reads 4 window samples per
//   16-byte shared load, and the 8 partial SADs and SATDs are summed with
//   warp shuffles.  Its bands of 8 rows read the same chunk of rows 8
//   apart, hence the XOR swizzle of its window.

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
  // The same from one row of int8 weights (C == 8, 8 bytes): 2 products a
  // DP2A instruction, the offsets packed as int16 pairs (|off| <= 1023).
  // SizeId 2's first offset is 0, so its unused weight adds nothing.
  __device__ __forceinline__ int predict8(const uint2 w, const int (&packed)[4]) const {
    int acc = bias;
    acc = __dp2a_lo(packed[0], (int)w.x, acc);
    acc = __dp2a_hi(packed[1], (int)w.x, acc);
    acc = __dp2a_lo(packed[2], (int)w.y, acc);
    acc = __dp2a_hi(packed[3], (int)w.y, acc);
    return clip_sample(acc >> kShift);
  }
  __device__ __forceinline__ void pack(int (&packed)[4]) const {
    static_assert(C == 8, "int8 rows of 8 weights");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      packed[k] = (int)(((unsigned)off[2 * k] & 0xffffu) | ((unsigned)off[2 * k + 1] << 16));
    }
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

__device__ __forceinline__ bool aligned16(const int32_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  const bool vec = aligned16(a.out0 + at) && (!two || aligned16(a.out1 + at));
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

// The geometry of one mip_cost_tile class.
template <int W, int H, int SID>
struct Tile {
  using P = SizeId<SID>;
  static constexpr int R = P::R, BS = P::BS, M = P::M;
  static constexpr int TWO_M = 2 * M, S = R * R, C = 2 * BS;
  static constexpr int UP_H = W / R, UP_V = H / R;  // upsampling factors
  static constexpr int DS_T = W / BS, DS_L = H / BS;  // boundary downsampling
  static constexpr int NS = W / 4;                  // 4-column strips a CU
  static constexpr int G = 16 / NS;                 // CUs a block
  static constexpr int NT = G * M * NS;             // threads a block: 128 or 96
  static constexpr int WS = W * H + 4 * NS;         // window stride a CU (padded)
  static constexpr int PS = S + 4;                  // prediction stride a (CU, mode)
  static constexpr int CS = TWO_M * PS + 8;         // prediction stride a CU (padded)
  static constexpr int BND = W + H;                 // raw top row, then left column
  static constexpr int SMEM =
      M * S * C + 4 * (G * WS + G * BND + G * C + 2 * G * TWO_M) + 2 * G * CS;
  static_assert(W % R == 0 && H % R == 0 && W % BS == 0 && H % BS == 0, "CU shape");
  static_assert(NS >= 1 && NS <= 8 && 16 % NS == 0 && NT % 32 == 0, "strip mapping");
  static_assert(TWO_M % 4 == 0 && S % NS == 0 && G * TWO_M / 4 <= NT && C == 8,
                "items, stores, int8 weight rows");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

// Horizontal values of one anchor row at columns 4s..4s+3 (VVC linear
// interpolation, intra.cl:815-895, as (UP*before + UP/2 + o*(after -
// before)) >> log2(UP), the same integer as ((UP - o)*before + o*after +
// UP/2) >> log2(UP)).  `row` holds the anchors as int16 (0..1023); `lb`
// is the raw left sample of the row: the "before" of the first anchor
// column.
template <int UP_H>
__device__ __forceinline__ void hor4(const int16_t* row, int lb, int s, int (&v)[4]) {
  if constexpr (UP_H == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 4 * s);
    v[0] = (int)(u.x & 0xffffu);
    v[1] = (int)(u.x >> 16);
    v[2] = (int)(u.y & 0xffffu);
    v[3] = (int)(u.y >> 16);
  } else if constexpr (UP_H == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(row + 2 * s);
    const int a0 = (int)(u & 0xffffu), a1 = (int)(u >> 16);
    const int before = s ? row[2 * s - 1] : lb;
    v[0] = (before + a0 + 1) >> 1;
    v[1] = a0;
    v[2] = (a0 + a1 + 1) >> 1;
    v[3] = a1;
  } else {  // the 4 columns lie in one anchor interval j, phases o0+1..o0+4
    constexpr int SH = ilog2(UP_H);
    const int j = (4 * s) >> SH, o0 = (4 * s) & (UP_H - 1);
    const int after = row[j], before = j ? row[j - 1] : lb;
    const int base = UP_H * before + (UP_H >> 1), dlt = after - before;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (base + (o0 + i + 1) * dlt) >> SH;
  }
}

// SAD and SATD of strip s (columns 4s..4s+3) of one (CU, mode), top to
// bottom: per anchor row k its horizontal values, then the UP_V rows
// between anchor rows k-1 (the raw top row for k = 0) and k.
template <int W, int H, int SID>
__device__ __forceinline__ void strip_costs(const int16_t* anc, const int32_t* top,
                                            const int32_t* left, const int32_t* win, int s,
                                            int& sad, int& satd) {
  using T = Tile<W, H, SID>;
  constexpr int R = T::R, UP_H = T::UP_H, UP_V = T::UP_V;
  // Anchor rows go in groups of KG that cover whole rows of 4x4 blocks.
  // A 4-wide class's strip is its whole CU: fully unrolled, ptxas hoists
  // every window row's load to the top (up to 231 registers), so its
  // groups run as a loop.
  constexpr int KG = UP_V >= 4 ? 1 : 4 / UP_V;
  constexpr int GROUPS = T::NS == 1 ? 1 : R / KG;  // groups unrolled
  static_assert(KG * UP_V % 4 == 0 && R % KG == 0, "anchor groups");
  int prev[4];
  if constexpr (UP_V > 1) {
    const int4 t4 = *reinterpret_cast<const int4*>(top + 4 * s);
    prev[0] = t4.x;
    prev[1] = t4.y;
    prev[2] = t4.z;
    prev[3] = t4.w;
  }
  sad = 0;
  satd = 0;
  int d[16];
#pragma unroll (GROUPS)
  for (int g = 0; g < R / KG; ++g) {
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      const int k = g * KG + kk;
      int cur[4];
      hor4<UP_H>(anc + k * R, left[(k + 1) * UP_V - 1], s, cur);
      int base[4], dlt[4];
      if constexpr (UP_V > 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          base[i] = UP_V * prev[i] + (UP_V >> 1);
          dlt[i] = cur[i] - prev[i];
          prev[i] = cur[i];
        }
      }
#pragma unroll
      for (int o = 1; o <= UP_V; ++o) {
        const int yb = (kk * UP_V + o - 1) % 4;  // row in its 4x4 block
        const int4 o4 = *reinterpret_cast<const int4*>(win + (k * UP_V + o - 1) * W);
        const int org[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = o == UP_V ? cur[i] : (base[i] + o * dlt[i]) >> ilog2(UP_V);
          d[4 * yb + i] = org[i] - p;
        }
        if (yb == 3) {
#pragma unroll
          for (int i = 0; i < 16; ++i) sad += abs(d[i]);
          satd += satd4x4(d);
        }
      }
    }
  }
}

// SizeId 1, and SizeId 2 below 64x64: a block of G CUs, one thread per
// (CU, mode of the normal wing, 4-column strip), both wings.
template <int W, int H, int SID>
__device__ __forceinline__ void mip_cost_tile(const Args& a) {
  using T = Tile<W, H, SID>;
  constexpr int R = T::R, BS = T::BS, M = T::M, TWO_M = T::TWO_M, S = T::S, C = T::C;
  constexpr int DS_T = T::DS_T, DS_L = T::DS_L, NS = T::NS, G = T::G, NT = T::NT;
  constexpr int WS = T::WS, PS = T::PS, CS = T::CS, BND = T::BND;
  constexpr int Q = W / 4;  // 4-sample chunks a window row
  __shared__ __align__(16) uint32_t w8_s[M * S * C / 4];  // int8 weights, 4 a word
  __shared__ __align__(16) int32_t win_s[G * WS];   // [cu][y][x], int32
  __shared__ __align__(16) int16_t anc_s[G * CS];   // [cu][mode][k][j]
  __shared__ __align__(16) int32_t bnd_s[G * BND];  // [cu][top W, left H]
  __shared__ int32_t red_s[G * C];                  // [cu][reduced top, left]
  __shared__ __align__(16) int32_t res_s[2 * G * TWO_M];  // [out][cu][mode]

  const int tid = threadIdx.x, b = blockIdx.y, cu0 = blockIdx.x * G;
  const Slab slab = frame_slab(a, b);

  // ---- 1. weights, windows and raw boundaries into shared memory, the
  // clamping and edge rules applied once per element.  A tail block
  // repeats the last CU in its unused places and stores nothing for them.
  const bool w16 = (reinterpret_cast<uintptr_t>(a.weights) & 15) == 0;
  for (int i = tid; i < M * S * C / 4; i += NT) {  // the weights are 0..127
    const int4 v = w16 ? __ldg(reinterpret_cast<const int4*>(a.weights) + i)
                       : make_int4(__ldg(a.weights + 4 * i), __ldg(a.weights + 4 * i + 1),
                                   __ldg(a.weights + 4 * i + 2), __ldg(a.weights + 4 * i + 3));
    w8_s[i] = (unsigned)v.x | (unsigned)v.y << 8 | (unsigned)v.z << 16 | (unsigned)v.w << 24;
  }
  for (int i = tid; i < H * G * Q; i += NT) {  // row-major over (y, cu, chunk)
    const int q = i % Q, c = (i / Q) % G, y = i / (Q * G);
    const int cu = min(cu0 + c, a.n_cu - 1);
    int v[4];
    slab.orig4(__ldg(a.table + 3 * cu) + y, __ldg(a.table + 3 * cu + 1) + 4 * q, v);
    *reinterpret_cast<int4*>(win_s + c * WS + y * W + 4 * q) = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < G * BND; i += NT) {
    const int c = i / BND, e = i % BND;
    const int cu = min(cu0 + c, a.n_cu - 1);
    const int y0 = __ldg(a.table + 3 * cu), x0 = __ldg(a.table + 3 * cu + 1);
    bnd_s[i] = e < W ? slab.top(y0, x0, e) : slab.left(y0, x0, e - W);
  }
  __syncthreads();

  // ---- 2. each CU's boundaries reduced to BS samples a side, once
  if (tid < G * C) {
    const int c = tid / C, i = tid % C;
    const int32_t* src = bnd_s + c * BND;
    int sum = 0;
    if (i < BS) {
#pragma unroll
      for (int k = 0; k < DS_T; ++k) sum += src[i * DS_T + k];
      red_s[tid] = (sum + (DS_T >> 1)) >> ilog2(DS_T);
    } else {
#pragma unroll
      for (int k = 0; k < DS_L; ++k) sum += src[W + (i - BS) * DS_L + k];
      red_s[tid] = (sum + (DS_L >> 1)) >> ilog2(DS_L);
    }
  }
  __syncthreads();

  // ---- 3. the R x R prediction of every (CU, mode), once.  Item
  // (mode * S + row) * G + cu: the G lanes of one weight row share its
  // 16-byte loads, and each item makes both wings from them; the
  // transposed wing's sample of row (j, k) is (k, j).
  {
    const int c = tid % G, ms0 = tid / G;
    int bnd_n[C], bnd_t[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      bnd_n[i] = red_s[c * C + i];
      bnd_t[i] = red_s[c * C + (i + BS) % C];
    }
    const Wing<SID, C> wn(bnd_n), wt(bnd_t);
    int pn[4], pt[4];
    wn.pack(pn);
    wt.pack(pt);
    int16_t* anc = anc_s + c * CS;
#pragma unroll 4
    for (int n = 0; n < S / NS; ++n) {
      const int ms = ms0 + n * (M * NS);
      const int mode = ms / S, w = ms % S;
      const uint2 wr = reinterpret_cast<const uint2*>(w8_s)[ms];
      anc[mode * PS + w] = (int16_t)wn.predict8(wr, pn);
      anc[(M + mode) * PS + (w % R) * R + w / R] = (int16_t)wt.predict8(wr, pt);
    }
  }
  __syncthreads();

  // ---- 4-5. strip s of (CU c, mode m) in both wings; the NS strips of a
  // (CU, mode) are NS neighbouring lanes
  // (a loop, not unrolled: the two wings' unrolled strips would be
  // scheduled together at twice the registers)
  const int s = tid % NS, m = (tid / NS) % M, c = tid / (NS * M);
  const int32_t* top = bnd_s + c * BND;
  const int32_t* win = win_s + c * WS + 4 * s;
  const bool two = a.out1 != nullptr;
#pragma unroll 1
  for (int wing = 0; wing < 2; ++wing) {
    int sad, satd;
    strip_costs<W, H, SID>(anc_s + c * CS + (wing * M + m) * PS, top, top + W, win, s, sad,
                           satd);
#pragma unroll
    for (int sh = 1; sh < NS; sh <<= 1) {
      sad += __shfl_xor_sync(0xffffffffu, sad, sh);
      satd += __shfl_xor_sync(0xffffffffu, satd, sh);
    }
    if (s == 0) {
      const int j = c * TWO_M + wing * M + m;
      res_s[j] = two ? sad : min(2 * sad, satd);
      res_s[G * TWO_M + j] = satd;
    }
  }
  __syncthreads();

  // ---- the block's G x 2M costs (or SADs and SATDs), 4 modes a store
  if (tid < G * TWO_M / 4 && cu0 + tid / (TWO_M / 4) < a.n_cu) {
    const int cu = cu0 + tid / (TWO_M / 4);
    const long long at = (long long)b * a.out_stride + __ldg(a.table + 3 * cu + 2) +
                         4 * (tid % (TWO_M / 4));
    const bool vec = aligned16(a.out0 + at) && (!two || aligned16(a.out1 + at));
    const int4 r0 = reinterpret_cast<const int4*>(res_s)[tid];
    store4(a.out0, at, vec, {r0.x, r0.y, r0.z, r0.w});
    if (two) {
      const int4 r1 = reinterpret_cast<const int4*>(res_s + G * TWO_M)[tid];
      store4(a.out1, at, vec, {r1.x, r1.y, r1.z, r1.w});
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
  mip_cost_tile<W, H, 1>(a);
}

template <int W, int H>
__global__ void __launch_bounds__(kThreads) mip_cost_sid2_kernel(Args a) {
  if constexpr (W == 64 && H == 64) {
    mip_cost_64x64(a);
  } else {
    mip_cost_tile<W, H, 2>(a);
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
    using T = Tile<W, H, SID>;
    static_assert(T::NT == 16 * SizeId<SID>::M && T::NT <= kThreads, "launch bounds");
    const dim3 grid((unsigned)((n_cu + T::G - 1) / T::G), (unsigned)batch);
    if constexpr (SID == 1) {
      mip_cost_sid1_kernel<W, H><<<grid, T::NT, 0, s>>>(a);
    } else {
      mip_cost_sid2_kernel<W, H><<<grid, T::NT, 0, s>>>(a);
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
