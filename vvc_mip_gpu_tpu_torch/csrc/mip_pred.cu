// Hand-written Hopper (sm_90a) kernel: the all-mode MIP reduced prediction.
//
// For every CU of one SizeId and every MIP mode m in [0, 2M) (modes 0..M-1
// the normal wing, M..2M-1 the transposed wing), the reference's
// MIP_ReducedPred (intra.cl:443-539):
//
//   bnd   = [red_t, red_l] (normal wing) or [red_l, red_t] (transposed)
//   first = bnd[0]
//   off   = [row0, bnd[1:] - first]   (row0 = 512 - first for SizeId < 2,
//                                       0 for SizeId 2)
//   pred  = clip(((sum_c W[s, c] * off[c] + 32 - 32 * sum(off)) >> 6)
//                + first, 0, 1023)
//
// where the transposed wing reads the weights' samples r x r transposed.
// Output: int16 [2M, S, nCU], S = R*R raster, no padding.
//
// Replaces vvc_mip_gpu_tpu/ops/pallas/pred.py:123 _kernel (launched by
// reduced_prediction, :132).  The TPU kernel folds the algebra into one
// bf16 MXU product on a two-limb augmented matrix; here all arithmetic is
// exact int32 on the CUDA cores, so the limb split, its augmented inputs
// and the Mosaic-only sample_perm / mode_minor layouts have no counterpart.
//
// Bound on this card: balanced.  A 1080p frame's CUs need ~2.1 G
// multiply-adds (~0.2 ms at the int32 rate) and write 0.60 GB of int16
// predictions (~0.18 ms at 3.35 TB/s).  Design: one block per (tile of
// kThreads CUs, mode); the mode's S x C weights, transposed for the
// transposed wing, sit in shared memory and every read of them is a
// broadcast; each thread keeps its CU's C offsets in registers and writes
// its S samples with the CU index fastest, so every store of a warp is one
// contiguous 64-byte run.

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

template <int SID>
__global__ void __launch_bounds__(kThreads)
mip_reduced_pred_kernel(const int32_t* __restrict__ red_t,
                        const int32_t* __restrict__ red_l,
                        const int32_t* __restrict__ weights, int n_cu,
                        int16_t* __restrict__ out) {
  using P = SizeId<SID>;
  constexpr int R = P::R, BS = P::BS, M = P::M, S = R * R, C = 2 * BS;

  const int m = blockIdx.y;
  const bool transposed = m >= M;
  const int mode = transposed ? m - M : m;

  // This mode's weights, output sample s reading row sp(s) of the table.
  __shared__ int32_t w_s[S * C];
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    const int s = i / C, c = i % C;
    const int sp = transposed ? (s % R) * R + s / R : s;  // r x r transposition
    w_s[i] = __ldg(weights + (mode * S + sp) * C + c);
  }
  __syncthreads();

  const int cu = blockIdx.x * kThreads + threadIdx.x;
  if (cu >= n_cu) return;

  int offs[C];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const int t = __ldg(red_t + (size_t)i * n_cu + cu);
    const int l = __ldg(red_l + (size_t)i * n_cu + cu);
    offs[i] = transposed ? l : t;
    offs[BS + i] = transposed ? t : l;
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

  int16_t* o = out + (size_t)m * S * n_cu + cu;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    int acc = bias;
#pragma unroll
    for (int c = 0; c < C; ++c) acc += w_s[s * C + c] * offs[c];
    const int p = (acc >> kShift) + first;
    o[(size_t)s * n_cu] = (int16_t)min(max(p, 0), kSampleMax);
  }
}

template <int SID>
int launch(const int32_t* red_t, const int32_t* red_l, const int32_t* weights,
           int n_cu, int16_t* out, void* stream) {
  const dim3 grid((unsigned)((n_cu + kThreads - 1) / kThreads),
                  (unsigned)(2 * SizeId<SID>::M));
  mip_reduced_pred_kernel<SID><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      red_t, red_l, weights, n_cu, out);
  return (int)cudaGetLastError();
}

}  // namespace

// One C launcher per SizeId: mip_reduced_pred_sid<SizeId>.  red_t / red_l:
// int32 [BS, n_cu]; weights: int32 [M, S, C]; out: int16 [2M, S, n_cu].
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
#define MIP_PRED_LAUNCHER(SID)                                                  \
  extern "C" int mip_reduced_pred_sid##SID(const int32_t* red_t,                \
                                           const int32_t* red_l,                \
                                           const int32_t* weights, int n_cu,    \
                                           int16_t* out, void* stream) {        \
    return launch<SID>(red_t, red_l, weights, n_cu, out, stream);               \
  }

MIP_PRED_LAUNCHER(0)
MIP_PRED_LAUNCHER(1)
MIP_PRED_LAUNCHER(2)
