// Modulated 3x3 stride-1 deformable convolution (DCNv2) forward, fp32.
//
// Replaces the TPU kernels _dcn_shift_kernel
// (centerfusiondetect3d_tpu/ops/pallas_dcn.py:117, via deform_conv2d_pallas
// :179, K1) and _dcn_static_kernel (:240, via deform_conv2d_pallas_static
// :303, K2). Those sum hat-weighted integer-shift windows because the TPU
// has no fast gather; a GPU gathers cheaply, so this kernel computes the
// exact op of centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d: bilinear
// sampling at p + t_k + d_k(p), a corner contributing only inside the image,
// weighted by the bilinear weight folded with the mask, contracted with the
// weight in full fp32 (no TF32: the 1e-4 limit and TF32-off serving rule it
// out), plus the bias. max_offset >= 0 clamps dy and dx to +-max_offset
// first (the Pallas kernels' semantics, 8 for K1 and 1 for K2); max_offset
// < 0 means no clamp.
//
// What bounds it: the contraction is 2*B*H*W*9*C*O flops against about
// 4*B*H*W*(C + 27 + O) bytes, over 100 flops per byte at every node shape
// of the model, while the card's fp32 balance is 67 TFLOP/s / 3.35 TB/s = 20
// flops per byte: on the CUDA cores it is bound by operations. In practice
// the corner gathers through L1 (one wavefront per distinct 128-byte line a
// warp's load touches: 36 * C / group a pixel) cost about as much as the
// FFMAs, and the two overlap only across the two blocks of an SM.
//
// Design: the front end of dcn_fwd_common.cuh (channels-last x, 16-byte
// corner loads of 4 channels, pixel tiles of B*H*W covering all O <= 256 so
// each pixel is sampled once per call, a split of the 9*C rows where tiles
// are few, a three-stage weight ring fed by cp.async). The engine is an
// fp32 FFMA outer product with an 8 x 8 register tile per thread; the
// block's 256 threads are two halves of 128 that take alternate halves of
// each step's rows over the same P x NO tile (8,192 outputs), and the
// halves' sums meet in shared memory at the end, the first plus the
// second: a fixed order. Tiles by output tile NO:
//   NO  pixels  group  rows a step  blocks/SM
//   64   128     16        16           2
//   128   64     16        24           2
//   256   32     32        16           2
// Thread (half, tp, to) owns pixels tp + (P/8) i and outputs to + (NO/8) j.
// Both tiles keep a row's values contiguous in an odd number of 16-byte
// units, so a quarter-warp's float4 reads of 8 rows are free of bank
// conflicts and the lanes reading one weight row broadcast; per 4 rows a
// thread reads 8 + 8 float4 and does 256 FFMAs. Two blocks per SM hold a
// thread to 128 registers, and ptxas spills a few (its log). The in-block
// overlap variant (dcn_fwd::Overlapped: one block per SM, 168 registers,
// no spills) is slower at every node shape (PERF.md).
//
// Shared memory per block: corner tables 180 bytes a pixel + one tap tile
// + 3 weight stages: 114,176 (NO 64), 92,416 (NO 128), 104,576 bytes (NO
// 256).
//
// Layouts: x (B, H, W, C) (channels-last; dcn_fwd_nhwc makes it from NCHW);
// offset (B, 18, H, W) with offset[2k] = dy_k and offset[2k+1] = dx_k, taps
// k = 3i + j in row-major order; mask (B, 9, H, W) already sigmoided;
// weight (O, C, 3, 3); bias (O,) or null; out (B, O, H, W); partial
// (splits, O, B*H*W) scratch when splits > 1. Every tensor is dense fp32 on
// one device.

#include "dcn_fwd_common.cuh"

namespace {

template <int NO>
struct Fp32Engine {
  using T = float;
  using TA = float;
  static constexpr int kNO = NO;
  static constexpr int kP = 8192 / NO;  // 128, 64 or 32 pixels
  static constexpr int kGC = NO == 256 ? 32 : 16;  // channels a group
  static constexpr int kKB = NO == 128 ? 24 : 16;  // weight rows a step
  static constexpr int kStages = 3;                // weight stages
  static constexpr int kMinBlocks = 2;
  static constexpr bool kOverlap = false;  // dcn_fwd::Overlapped
  static constexpr int kBatch = 3;  // gather items a thread in flight
  static constexpr int kSteps = 9 * kGC / kKB;
  static constexpr int kLdA = 9 * kGC + 4;
  static constexpr int kLdB = kKB + 4;
  static constexpr int kLdC = kP + 4;  // epilogue tile [o][pixel]
  static constexpr int kABytes = kP * kLdA * 4;
  static constexpr int kBBytes = kNO * kLdB * 4;
  static constexpr int kSmem = 9 * kP * 20 + kABytes + kStages * kBBytes;
  static constexpr int kTP = kP / 8;  // threads of a half along the pixels
  static constexpr int kTO = NO / 8;  // threads of a half along the outputs
  static_assert(2 * kTP * kTO == dcn_fwd::kThreads, "8 x 8 a thread");
  static_assert((kLdA / 4) % 2 == 1 && (kLdB / 4) % 2 == 1,
                "float4 rows: odd 16-byte units");
  static_assert(kKB % 8 == 0, "each half takes whole float4 rows");
  static_assert(kNO * kLdC * 4 <= kSmem, "the epilogue tile fits");
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "blocks per SM");

  float acc[8][8];

  __device__ Fp32Engine() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // thread (half, tp, to): half the step's rows, pixels tp + kTP i and
  // outputs to + kTO j
  __device__ __forceinline__ static int half() { return threadIdx.x / 128; }
  __device__ __forceinline__ static int tp() {
    return (threadIdx.x % 128) % kTP;
  }
  __device__ __forceinline__ static int to() {
    return (threadIdx.x % 128) / kTP;
  }

  // acc += A[:, col0 + r] B[:, r]^T over this half's rows r of the stage
  __device__ __forceinline__ void contract(const float* a, int col0,
                                           const float* b) {
    const int r0 = half() * (kKB / 2);
    const float* a_row = a + tp() * kLdA + col0;
    const float* b_row = b + to() * kLdB;
#pragma unroll 1
    for (int r = r0; r < r0 + kKB / 2; r += 4) {
      float4 bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b_row + kTO * j * kLdB + r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av =
            *reinterpret_cast<const float4*>(a_row + kTP * i * kLdA + r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
  }

  // the two halves' sums, the first plus the second, through shared
  // memory, then written out coalesced along the pixels
  __device__ __forceinline__ void epilogue(const dcn_fwd::Params<T>& prm,
                                           unsigned char* smem, int p0,
                                           int o0) const {
    float* s_c = reinterpret_cast<float*>(smem);
    float* mine = s_c + to() * kLdC + tp();
    if (half() == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mine[kTO * j * kLdC + kTP * i] = acc[i][j];
    }
    __syncthreads();
    if (half() == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& v = mine[kTO * j * kLdC + kTP * i];
          v = acc[i][j] + v;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kNO * kP; i += dcn_fwd::kThreads) {
      const int ol = i / kP;
      const int pl = i - ol * kP;
      if (o0 + ol < prm.O && p0 + pl < prm.npix)
        dcn_fwd::write_out(prm, o0 + ol, p0 + pl, s_c[ol * kLdC + pl]);
    }
  }
};

}  // namespace

// Launches the forward on `stream`: where xh is given, the channels-last
// copy of the NCHW x into it first (else x is channels-last); then the
// kernel and, when splits > 1, the reduction of the splits' partials.
// tile_p, tile_o and group are the caller's plan (dcn_fwd_plan), held
// against the engine's tiles. overlap = 1 runs the engine's in-block
// overlap variant (dcn_fwd::Overlapped), for comparison. Returns the CUDA
// error of the launches (0 on success). vec = 1 when C is
// a multiple of 4 and the channels-last x and the weight are 16-byte
// aligned. Ho and row0: the output rows [row0, row0 + Ho) of an x of H
// rows (dcn_fwd_common.cuh; Ho = H and row0 = 0 for the whole op).
extern "C" int cfd_dcn_fwd(const float* x, float* xh, const float* offset,
                           const float* mask, const float* weight,
                           const float* bias, float* out, float* partial,
                           int B, int C, int H, int W, int Ho, int row0,
                           int O, int tile_p, int tile_o, int group,
                           int splits, int vec, int overlap,
                           float max_offset, void* stream) {
  using dcn_fwd::Overlapped;
  const auto run =
      O <= 64    ? overlap ? dcn_fwd::run<Overlapped<Fp32Engine<64>>, float>
                           : dcn_fwd::run<Fp32Engine<64>, float>
      : O <= 128 ? overlap ? dcn_fwd::run<Overlapped<Fp32Engine<128>>, float>
                           : dcn_fwd::run<Fp32Engine<128>, float>
      : overlap  ? dcn_fwd::run<Overlapped<Fp32Engine<256>>, float>
                 : dcn_fwd::run<Fp32Engine<256>, float>;
  return run(x, xh, offset, mask, weight, bias, out, partial, B, C, H, W, Ho,
             row0, O, tile_p, tile_o, group, splits, vec, max_offset, stream);
}

// The channels-last copy of an NCHW fp32 x: (B, C, H*W) -> (B, H*W, C).
extern "C" int cfd_dcn_fwd_nhwc(const float* x, float* xh, int B, int C,
                                int hw, void* stream) {
  return dcn_fwd::launch_nhwc<float>(x, xh, B, C, hw, stream);
}
