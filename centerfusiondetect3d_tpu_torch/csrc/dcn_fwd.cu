// Modulated 3x3 stride-1 deformable convolution (DCNv2) forward, NCHW fp32.
//
// Replaces the TPU kernels _dcn_shift_kernel (deform_conv2d_pallas) and
// _dcn_static_kernel (deform_conv2d_pallas_static) of
// centerfusiondetect3d_tpu/ops/pallas_dcn.py. Those sum hat-weighted
// integer-shift windows because the TPU has no fast gather; a GPU gathers
// cheaply, so this kernel computes the exact op of
// centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d: bilinear sampling at
// p + t_k + d_k(p), a corner contributing only inside the image, times the
// mask, contracted with the weight, plus the bias. max_offset >= 0 clamps
// dy and dx to +-max_offset first (the Pallas kernels' semantics, 8 for K1
// and 1 for K2); max_offset < 0 means no clamp.
//
// What bounds it: the contraction is 2*B*H*W*9*C*O flops against about
// 4*B*H*W*(C + 27 + O) bytes, over 100 flops per byte at every node shape
// of the model, while the card's fp32 balance is 67 TFLOP/s / 3.35 TB/s = 20
// flops per byte; on the CUDA cores in fp32 it is bound by operations. The design keeps the FMA units fed from
// registers and shared memory: a block owns 64 output pixels x 64 output
// channels of one image, computes each pixel's 9 taps x 4 corner indices and
// mask-folded bilinear weights once into shared memory, then walks the input
// channels 4 at a time, sampling a 36 x 64 column tile and staging the
// matching 36 x 64 weight slice in shared memory, and each thread
// accumulates a 4 x 4 register tile with float4 shared-memory reads. The
// gathers hit L1/L2 and are paid once per 64 output channels. Tensor cores
// (bf16/TF32 wgmma) are the next step and are not used here.
//
// Layouts: x (B, C, H, W); offset (B, 18, H, W) with offset[2k] = dy_k and
// offset[2k+1] = dx_k, taps k = 3i + j in row-major order; mask (B, 9, H, W)
// already sigmoided; wt (C, 3, 3, O), the (O, C, 3, 3) weight permuted so
// that a chunk's rows are contiguous; bias (O,) or null; out (B, O, H, W).
// Every tensor is contiguous fp32 on one device.

#include <cuda_runtime.h>

namespace {

constexpr int kTileP = 64;            // output pixels per block
constexpr int kTileO = 64;            // output channels per block
constexpr int kChunkC = 4;            // input channels per shared-memory chunk
constexpr int kRows = kChunkC * 9;    // contraction rows per chunk
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ out,
               int C, int H, int W, int O, float max_offset) {
  __shared__ int s_idx[4][9 * kTileP];
  __shared__ float s_wgt[4][9 * kTileP];
  __shared__ __align__(16) float s_col[kRows][kTileP];
  __shared__ __align__(16) float s_w[kRows][kTileO];

  const int tid = threadIdx.x;
  const int hw = H * W;
  const int p0 = blockIdx.x * kTileP;
  const int o0 = blockIdx.y * kTileO;
  const int b = blockIdx.z;

  // 1. corner indices and mask-folded bilinear weights of every (tap, pixel)
  for (int t = tid; t < 9 * kTileP; t += kThreads) {
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
      s_idx[corner][t] = idx[corner];
      s_wgt[corner][t] = wgt[corner];
    }
  }

  const int tx = tid % 16;  // pixels 4*tx .. 4*tx+3 of the tile
  const int ty = tid / 16;  // output channels 4*ty .. 4*ty+3 of the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    __syncthreads();  // tables ready; the previous chunk's FMAs are done
    // 2. sample the (kChunkC x 9 taps) x kTileP column tile
    for (int t = tid; t < 9 * kTileP; t += kThreads) {
      const int k = t / kTileP;
      const int pl = t % kTileP;
      const int i0 = s_idx[0][t], i1 = s_idx[1][t];
      const int i2 = s_idx[2][t], i3 = s_idx[3][t];
      const float w0 = s_wgt[0][t], w1 = s_wgt[1][t];
      const float w2 = s_wgt[2][t], w3 = s_wgt[3][t];
#pragma unroll
      for (int c = 0; c < kChunkC; ++c) {
        float v = 0.f;
        if (c0 + c < C) {
          const float* xc = x + ((size_t)b * C + c0 + c) * hw;
          v = w0 * __ldg(xc + i0) + w1 * __ldg(xc + i1) +
              w2 * __ldg(xc + i2) + w3 * __ldg(xc + i3);
        }
        s_col[c * 9 + k][pl] = v;
      }
    }
    // 3. the matching weight rows (c0..c0+kChunkC) x 9 taps
    for (int t = tid; t < kRows * kTileO; t += kThreads) {
      const int r = t / kTileO;
      const int ol = t % kTileO;
      const int row = c0 * 9 + r;
      s_w[r][ol] = (row < C * 9 && o0 + ol < O)
                       ? wt[(size_t)row * O + o0 + ol] : 0.f;
    }
    __syncthreads();
    // 4. rank-kRows update of the 4 x 4 register tile
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&s_col[r][tx * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&s_w[r][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + ty * 4 + j;
    if (o >= O) continue;
    const float bv = bias ? bias[o] : 0.f;
    float* dst = out + ((size_t)b * O + o) * hw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tx * 4 + i;
      if (p < hw) dst[p] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cfd_dcn_fwd(const float* x, const float* offset,
                           const float* mask, const float* wt,
                           const float* bias, float* out, int B, int C, int H,
                           int W, int O, float max_offset, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + kTileP - 1) / kTileP, (O + kTileO - 1) / kTileO, B);
  dcn_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, offset, mask, wt, bias, out, C, H, W, O, max_offset);
  return (int)cudaGetLastError();
}
