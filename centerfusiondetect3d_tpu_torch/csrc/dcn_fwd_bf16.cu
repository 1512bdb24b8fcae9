// Modulated 3x3 stride-1 deformable convolution (DCNv2) forward in bf16 on
// the tensor cores: bf16 x and weight, f32 sampling, f32 accumulation.
//
// Replaces the bf16 contraction of the TPU kernels _dcn_shift_kernel
// (centerfusiondetect3d_tpu/ops/pallas_dcn.py:117, via deform_conv2d_pallas
// :179, K1) and _dcn_static_kernel (:240, via deform_conv2d_pallas_static
// :303, K2), and of the probe kernels _kernel_value_acc and _kernel_select
// of scripts/probe_dcn_select.py:48, 83 (P4, the same function with offsets
// clamped to +-1). It computes what they compute, with exact bilinear
// gathers instead of their hat-weighted integer-shift windows: for every tap
// the 4 corners of x (zero outside the image) are widened to f32, weighted
// by the bilinear weights folded with the f32 mask, summed in f32 and
// rounded to bf16 (the rounding K1 makes before its MXU dot); the bf16 taps
// contract with the bf16 weight on the tensor cores with f32 accumulation
// over the 9 taps and C; the bias is added to the f32 accumulator and the
// sum is rounded once to bf16. max_offset >= 0 clamps dy and dx to
// +-max_offset first (8 for K1, 1 for K2 and P4); max_offset < 0 means no
// clamp.
//
// Design: the front end of dcn_fwd_common.cuh (channels-last x, 16-byte
// corner loads, pixel tiles of B*H*W covering all O <= 256 so each pixel is
// sampled once per call, a split of the 9*C rows where tiles are few, a
// three-stage weight ring fed by cp.async). The engine here is
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from padded
// tiles (rows of an odd number of 16-byte units, so ldmatrix is free of
// bank conflicts). Why mma.sync and not wgmma: the contraction is not what
// bounds it. At the widest node calls (B=6: (64 -> 64) at 112x200, (512 ->
// 256) at 14x25) the product is 9.9 GFLOP, 10 us at the dense 989 TFLOP/s,
// a small share of each call's time (PERF.md); the gather and the weight
// stream bound it, and the tap tile is written by the same warps that
// contract it, which wgmma's warpgroup shape and shared-memory descriptors
// would constrain for no gain. Tiles by output tile NO:
//   NO  pixels  group  rows a step  warps (P x O)  warp tile  blocks/SM
//   64   128     32        32          4 x 2         32 x 32      2
//   128   64     32        48          2 x 4         32 x 32      2
//   256   64     64        64          2 x 4         32 x 64      1
// A warp holds 32 or 64 f32 accumulators. At NO 64 and 128 the gather and
// the contraction overlap across the two blocks of an SM; at NO 256 one
// block fills an SM and the two run in series. The in-block overlap
// variant (dcn_fwd::Overlapped, NO <= 128 only) is slower (PERF.md). The
// f32 tile goes through shared memory once ([o][pixel], padded), so the
// bias add, the bf16 store or the split's partial are coalesced along the
// pixels.
//
// What bounds it: 2*B*H*W*9*C*O flops against B*H*W*(2C + 108 + 2O) bytes
// of its own, 200 to 1400 flops per byte at the model's node shapes, so at
// the tensor-core rate (989 TFLOP/s bf16, 3.35 TB/s: 295 flops per byte) the
// (64 -> 64) nodes are bound by bytes and the wider ones by operations. In
// practice three things bound it, none of them the tensor cores: the 36
// corner reads per (pixel, channel) through L1 (one L1 wavefront per
// distinct 128-byte line a warp's load touches: 36 * C / group wavefronts a
// pixel), the weight streamed from L2 once per pixel tile (9 * C * O * 2
// bytes a tile), and the latency of both at one or two blocks per SM.
//
// Shared memory per block: corner tables 180 bytes a pixel + one tap tile
// + 3 weight stages: 114,176 (NO 64), 92,416 (NO 128), 196,864 bytes (NO
// 256). Registers: ptxas -v in chip_smoke.py's build log (no spills).
//
// Layouts: x (B, H, W, C) bf16 (channels-last; dcn_fwd_bf16_nhwc makes it
// from NCHW); offset (B, 18, H, W) f32 with offset[2k] = dy_k and
// offset[2k+1] = dx_k, taps k = 3i + j in row-major order; mask (B, 9, H, W)
// f32, already sigmoided; weight (O, C, 3, 3) bf16; bias (O,) bf16 or null;
// out (B, O, H, W) bf16; partial (splits, O, B*H*W) f32 scratch when
// splits > 1. Every tensor is dense, on one device.

#include "dcn_fwd_common.cuh"

namespace {

using dcn_fwd::kThreads;
using dcn_fwd::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) * b (16 x 8, col-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NO>
struct Bf16Engine {
  using T = __nv_bfloat16;
  using TA = __nv_bfloat16;
  static constexpr int kNO = NO;
  static constexpr int kP = NO == 64 ? 128 : 64;   // pixels a tile
  static constexpr int kGC = NO == 256 ? 64 : 32;  // channels a group
  static constexpr int kKB = NO == 128 ? 48 : NO == 256 ? 64 : 32;  // rows
  static constexpr int kStages = 3;                 // weight stages
  static constexpr int kMinBlocks = NO == 256 ? 1 : 2;
  static constexpr bool kOverlap = false;  // dcn_fwd::Overlapped
  static constexpr int kBatch = 3;  // gather items a thread in flight
  static constexpr int kSteps = 9 * kGC / kKB;
  static constexpr int kLdA = 9 * kGC + 8;
  static constexpr int kLdB = kKB + 8;
  static constexpr int kLdC = kP + 4;  // f32 epilogue tile [o][pixel]
  static constexpr int kABytes = kP * kLdA * 2;
  static constexpr int kBBytes = kNO * kLdB * 2;
  static constexpr int kSmem = 9 * kP * 20 + kABytes + kStages * kBBytes;
  static constexpr int kWarpsP = NO >= 128 ? 2 : 4;
  static constexpr int kWarpsO = 8 / kWarpsP;
  static constexpr int kWarpP = kP / kWarpsP;  // warp tile, pixels
  static constexpr int kWarpO = NO / kWarpsO;  // warp tile, outputs
  static constexpr int kMT = kWarpP / 16;
  static constexpr int kNT = kWarpO / 8;
  static_assert(kKB % 16 == 0 && kNT % 2 == 0, "mma tiles");
  static_assert((kLdA * 2) % 32 == 16 && (kLdB * 2) % 32 == 16,
                "ldmatrix rows: odd 16-byte units");
  static_assert(kABytes % 128 == 0 && kBBytes % 128 == 0, "alignment");
  static_assert(kNO * kLdC * 4 <= kSmem, "the epilogue tile fits");
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "blocks per SM");

  float acc[kMT][kNT][4];

  __device__ Bf16Engine() {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
  }

  __device__ __forceinline__ int warp_p() const {
    return ((threadIdx.x >> 5) % kWarpsP) * kWarpP;
  }
  __device__ __forceinline__ int warp_o() const {
    return ((threadIdx.x >> 5) / kWarpsP) * kWarpO;
  }

  // acc += A[:, col0 .. col0 + kKB) . B^T, B the stage's kKB rows
  __device__ __forceinline__ void contract(const TA* a, int col0,
                                           const T* b) {
    const int lane = threadIdx.x & 31;
    const TA* a_row =
        a + (warp_p() + (lane & 15)) * kLdA + col0 + (lane >> 4) * 8;
    const T* b_row = b + (warp_o() + (lane & 7) + ((lane >> 4) << 3)) * kLdB +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kKB / 16; ++ks) {
      unsigned fa[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        ldmatrix_x4(fa[m], a_row + m * 16 * kLdA + ks * 16);
#pragma unroll
      for (int nb = 0; nb < kNT / 2; ++nb) {
        unsigned fb[4];
        ldmatrix_x4(fb, b_row + nb * 16 * kLdB + ks * 16);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          mma_bf16(acc[m][2 * nb], fa[m], fb[0], fb[1]);
          mma_bf16(acc[m][2 * nb + 1], fa[m], fb[2], fb[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void epilogue(const dcn_fwd::Params<T>& prm,
                                           unsigned char* smem, int p0,
                                           int o0) const {
    float* s_c = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int pr = warp_p() + m * 16 + g;
        const int oc = warp_o() + n * 8 + 2 * t;
        s_c[oc * kLdC + pr] = acc[m][n][0];
        s_c[(oc + 1) * kLdC + pr] = acc[m][n][1];
        s_c[oc * kLdC + pr + 8] = acc[m][n][2];
        s_c[(oc + 1) * kLdC + pr + 8] = acc[m][n][3];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kNO * kP; i += kThreads) {
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
// overlap variant (dcn_fwd::Overlapped; O <= 128 only), for comparison.
// Returns the CUDA error of the launches (0 on success). vec = 1 when C is
// a multiple of 8 and the channels-last x and the weight are 16-byte
// aligned.
extern "C" int cfd_dcn_fwd_bf16(const void* x, void* xh,
                                const float* offset, const float* mask,
                                const void* weight, const void* bias,
                                void* out, float* partial, int B, int C,
                                int H, int W, int O, int tile_p,
                                int tile_o, int group, int splits, int vec,
                                int overlap, float max_offset,
                                void* stream) {
  using dcn_fwd::Overlapped;
  using U = unsigned short;
  if (overlap && O > 128) return (int)cudaErrorInvalidValue;
  const auto run =
      O <= 64    ? overlap ? dcn_fwd::run<Overlapped<Bf16Engine<64>>, U>
                           : dcn_fwd::run<Bf16Engine<64>, U>
      : O <= 128 ? overlap ? dcn_fwd::run<Overlapped<Bf16Engine<128>>, U>
                           : dcn_fwd::run<Bf16Engine<128>, U>
                 : dcn_fwd::run<Bf16Engine<256>, U>;
  return run(x, xh, offset, mask, weight, bias, out, partial, B, C, H, W, O,
             tile_p, tile_o, group, splits, vec, max_offset, stream);
}

// The channels-last copy of an NCHW bf16 x: (B, C, H*W) -> (B, H*W, C).
extern "C" int cfd_dcn_fwd_bf16_nhwc(const void* x, void* xh, int B, int C,
                                     int hw, void* stream) {
  return dcn_fwd::launch_nhwc<unsigned short>(x, xh, B, C, hw, stream);
}
