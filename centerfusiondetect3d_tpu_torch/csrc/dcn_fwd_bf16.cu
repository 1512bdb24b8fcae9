// Modulated 3x3 stride-1 deformable convolution (DCNv2) forward in bf16 on
// the tensor cores: bf16 x and weight, f32 sampling, f32 accumulation.
//
// Replaces the bf16 contraction of the TPU kernels _dcn_shift_kernel
// (deform_conv2d_pallas, K1) and _dcn_static_kernel
// (deform_conv2d_pallas_static, K2) of
// centerfusiondetect3d_tpu/ops/pallas_dcn.py, and of the probe kernels
// _kernel_value_acc and _kernel_select of scripts/probe_dcn_select.py (P4,
// the same function with offsets clamped to +-1). It computes what they
// compute, with exact bilinear gathers instead of their hat-weighted
// integer-shift windows: for every tap the 4 corners of x (zero outside the
// image) are widened to f32, weighted by the bilinear weights times the f32
// mask, summed in f32 and rounded to bf16 (the rounding K1 makes before its
// MXU dot); the bf16 taps contract with the bf16 weight on the tensor cores
// with f32 accumulation over the 9 taps and C; the bias is added to the f32
// accumulator and the sum is rounded once to bf16 (the JAX package's
// ops/dcn.py order; K1 rounds before the bias). max_offset >= 0 clamps dy and
// dx to +-max_offset first (8 for K1, 1 for K2 and P4); max_offset < 0 means
// no clamp.
//
// What bounds it: 2*B*H*W*9*C*O flops against about B*H*W*(2C + 108 + 2O)
// bytes, 200 to 1400 flops per byte at the model's node shapes, so on the
// tensor cores (989 TFLOP/s bf16, 3.35 TB/s: 295 flops per byte) the
// (64 -> 64) nodes are bound by bytes and the wider ones by operations. In
// practice the corner gathers bound it: 36 scattered 2-byte loads per
// (pixel, channel) column of 9 taps. The
// design keeps the fp32 kernel's tiling: a block owns 64 output pixels x 64
// output channels of one image, computes each pixel's 9 taps x 4 corner
// indices and mask-folded bilinear weights once into shared memory, then
// walks the input channels 16 at a time. Per chunk it samples the bf16
// 64 x 144 tap tile (pixel x (tap, channel)) and stages the matching
// 144 x 64 bf16 weight tile in shared memory; each of the 8 warps then runs
// 9 WMMA bf16 16x16x16 steps (one per tap) on a 16 pixel x 32 channel slice
// of the output. The f32 accumulators go through shared memory once, so the
// bias add and the bf16 store are coalesced along the pixels. wgmma, TMA,
// channels_last and overlapping the gathers with the MMAs are later work.
//
// Layouts: x (B, C, H, W) bf16; offset (B, 18, H, W) f32 with offset[2k] =
// dy_k and offset[2k+1] = dx_k, taps k = 3i + j in row-major order; mask
// (B, 9, H, W) f32, already sigmoided; wt (C, 3, 3, O) bf16, the (O, C, 3, 3)
// weight permuted so that a (channel, tap) row is contiguous; bias (O,) bf16
// or null; out (B, O, H, W) bf16. Every tensor is contiguous, on one device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTileP = 64;             // output pixels per block
constexpr int kTileO = 64;             // output channels per block
constexpr int kChunkC = 16;            // input channels per chunk: one MMA k-step per tap
constexpr int kRows = 9 * kChunkC;     // contraction rows per chunk, row = tap * 16 + channel
constexpr int kThreads = 256;          // 8 warps: 4 pixel slices x 2 channel slices
constexpr int kLdA = kRows + 8;        // bf16 tap tile [pixel][row], padded
constexpr int kLdB = kTileO + 8;       // bf16 weight tile [row][channel], padded
constexpr int kLdC = kTileP + 4;       // f32 output tile [channel][pixel], padded

constexpr int kIdxBytes = 4 * 9 * kTileP * 4;  // corner indices
constexpr int kWgtBytes = 4 * 9 * kTileP * 4;  // mask-folded corner weights
constexpr int kABytes = kTileP * kLdA * 2;
constexpr int kBBytes = kRows * kLdB * 2;
constexpr int kSmemBytes = kIdxBytes + kWgtBytes + kABytes + kBBytes;
static_assert(kTileO * kLdC * 4 <= kABytes, "the output tile reuses the tap tile");
static_assert(kIdxBytes % 32 == 0 && kWgtBytes % 32 == 0 && kABytes % 32 == 0,
              "WMMA tiles need 32-byte aligned bases");

__global__ void __launch_bounds__(kThreads)
dcn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ offset,
                    const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ wt,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int C, int H, int W,
                    int O, float max_offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);                   // [4][9 * kTileP]
  float* s_wgt = reinterpret_cast<float*>(smem + kIdxBytes);   // [4][9 * kTileP]
  __nv_bfloat16* s_a =
      reinterpret_cast<__nv_bfloat16*>(smem + kIdxBytes + kWgtBytes);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(
      smem + kIdxBytes + kWgtBytes + kABytes);
  float* s_c = reinterpret_cast<float*>(s_a);  // after the last MMA only

  const int tid = threadIdx.x;
  const int hw = H * W;
  const int p0 = blockIdx.x * kTileP;
  const int o0 = blockIdx.y * kTileO;
  const int b = blockIdx.z;
  constexpr int kItems = 9 * kTileP;

  // 1. corner indices and mask-folded bilinear weights of every (tap, pixel)
  for (int t = tid; t < kItems; t += kThreads) {
    const int k = t / kTileP;
    const int p = p0 + t % kTileP;
    int idx[4] = {0, 0, 0, 0};
    float wgt[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < hw) {
      const int h = p / W;
      const int w = p - h * W;
      float dy = offset[((size_t)b * 18 + 2 * k) * hw + p];
      float dx = offset[((size_t)b * 18 + 2 * k + 1) * hw + p];
      if (max_offset >= 0.f) {
        dy = fminf(fmaxf(dy, -max_offset), max_offset);
        dx = fminf(fmaxf(dx, -max_offset), max_offset);
      }
      const float m = mask[((size_t)b * 9 + k) * hw + p];
      const float py = (float)(h + k / 3 - 1) + dy;
      const float px = (float)(w + k % 3 - 1) + dx;
      const float fy = floorf(py);
      const float fx = floorf(px);
      const float ly = py - fy;
      const float lx = px - fx;
      const int y0 = (int)fy;
      const int x0 = (int)fx;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int cy = corner >> 1;
        const int cx = corner & 1;
        const int yy = y0 + cy;
        const int xx = x0 + cx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          idx[corner] = yy * W + xx;
          wgt[corner] = m * (cy ? ly : 1.f - ly) * (cx ? lx : 1.f - lx);
        }
      }
    }
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      s_idx[corner * kItems + t] = idx[corner];
      s_wgt[corner * kItems + t] = wgt[corner];
    }
  }

  const int warp = tid / 32;
  const int warp_p = warp % 4;  // pixels 16 * warp_p .. +15 of the tile
  const int warp_o = warp / 4;  // output channels 32 * warp_o .. +31
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const bool vec_w = (O % 8 == 0) && (o0 + kTileO <= O);

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    __syncthreads();  // tables ready; the previous chunk's MMAs are done
    // 2. sample the bf16 tap tile: row tap * 16 + c of pixel pl
    for (int t = tid; t < kItems; t += kThreads) {
      const int k = t / kTileP;
      const int pl = t % kTileP;
      const int i0 = s_idx[t], i1 = s_idx[kItems + t];
      const int i2 = s_idx[2 * kItems + t], i3 = s_idx[3 * kItems + t];
      const float w0 = s_wgt[t], w1 = s_wgt[kItems + t];
      const float w2 = s_wgt[2 * kItems + t], w3 = s_wgt[3 * kItems + t];
      unsigned packed[kChunkC / 2];  // bf16 pairs, the lower channel low
#pragma unroll
      for (int c = 0; c < kChunkC; ++c) {
        float s = 0.f;
        if (c0 + c < C) {
          const __nv_bfloat16* xc = x + ((size_t)b * C + c0 + c) * hw;
          s = w0 * __bfloat162float(xc[i0]) + w1 * __bfloat162float(xc[i1]) +
              w2 * __bfloat162float(xc[i2]) + w3 * __bfloat162float(xc[i3]);
        }
        const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(s));
        packed[c / 2] = (c % 2) ? (packed[c / 2] | (bits << 16)) : bits;
      }
      uint4* dst = reinterpret_cast<uint4*>(s_a + pl * kLdA + k * kChunkC);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    // 3. the matching weight rows: s_b[k * 16 + c][ol] = wt[c0 + c][k][o0 + ol]
    if (vec_w) {
      constexpr int kSegs = kTileO / 8;  // 16-byte segments per row
      for (int t = tid; t < kRows * kSegs; t += kThreads) {
        const int r = t / kSegs;
        const int seg = t % kSegs;
        const int k = r / kChunkC;
        const int c = r % kChunkC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + c < C)
          val = *reinterpret_cast<const uint4*>(
              wt + ((size_t)(c0 + c) * 9 + k) * O + o0 + seg * 8);
        *reinterpret_cast<uint4*>(s_b + r * kLdB + seg * 8) = val;
      }
    } else {
      for (int t = tid; t < kRows * kTileO; t += kThreads) {
        const int r = t / kTileO;
        const int ol = t % kTileO;
        const int k = r / kChunkC;
        const int c = r % kChunkC;
        __nv_bfloat16 val = __float2bfloat16_rn(0.f);
        if (c0 + c < C && o0 + ol < O)
          val = wt[((size_t)(c0 + c) * 9 + k) * O + o0 + ol];
        s_b[r * kLdB + ol] = val;
      }
    }
    __syncthreads();
    // 4. 9 tensor-core k-steps of 16 rows, one per tap
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, s_a + warp_p * 16 * kLdA + k * kChunkC, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(
            fb, s_b + k * kChunkC * kLdB + warp_o * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }

  // 5. f32 tile through shared memory, + bias, one rounding to bf16
  __syncthreads();  // every warp is done reading the tap tile
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(s_c + (warp_o * 32 + j * 16) * kLdC + warp_p * 16,
                            acc[j], kLdC, wmma::mem_col_major);
  __syncthreads();
  for (int t = tid; t < kTileO * kTileP; t += kThreads) {
    const int ol = t / kTileP;
    const int pl = t % kTileP;
    const int o = o0 + ol;
    const int p = p0 + pl;
    if (o < O && p < hw) {
      float v = s_c[ol * kLdC + pl];
      if (bias) v += __bfloat162float(bias[o]);
      out[((size_t)b * O + o) * hw + p] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int cfd_dcn_fwd_bf16(const void* x, const float* offset,
                                const float* mask, const void* wt,
                                const void* bias, void* out, int B, int C,
                                int H, int W, int O, float max_offset,
                                void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + kTileP - 1) / kTileP, (O + kTileO - 1) / kTileO, B);
  dcn_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), offset, mask,
      static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), C, H, W, O, max_offset);
  return (int)cudaGetLastError();
}
