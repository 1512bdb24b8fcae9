// Bilinear affine warp of uint8 BGR frames on the card, for serving.
//
// Replaces no TPU kernel: the JAX package warps each camera frame to the
// network input on the host with cv2.warpAffine
// (centerfusiondetect3d_tpu/runtime/detector.py:_warp_or_crop), and on the
// CPU the port warps with numpy (data/transforms.py:warp_image), which
// takes hundreds of milliseconds of host time for six 1600x900 frames
// (PERF.md). On the card the decoded frames stay there and this kernel
// writes the input batch.
//
// The arithmetic is warp_image's, which is that of cv2's own warp: each
// destination pixel (x, y) reads the source at
//   sx = fma(m0, x, m1 * y + m2),  sy = fma(m3, x, m4 * y + m5)
// in float32, m the inverse affine rounded to float32 by the caller; the
// bilinear weights are the fractions of sx and sy; the two lerps along x
// and the one along y are fmaf; the result rounds half to even and clamps
// to 0-255. A neighbour outside the image reads 0. The products m1 * y and
// the sums that warp_image rounds on their own are __fmul_rn / __fadd_rn /
// __fsub_rn here, so that nvcc does not contract them into an fma.
// ops/warp.py:warp_affine_plain is the plain version (it emulates fmaf in
// float64, which can round twice where fmaf rounds once: a tie would show
// as a difference of one level, which the checks count).
//
// One thread a destination pixel, its three channels; one launch covers up
// to kMaxImages images of one output size, each with its own source
// pointer, size and matrix passed by value (no device copy of the
// matrices, no stacking of the sources). The work is bound by bytes: each
// source pixel is read about once (4 neighbours a destination pixel, shared
// through L1/L2) and each destination byte written once.
//
// Status: 0, or a cudaError_t; 2002 for arguments the kernel does not take.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxImages = 64;
constexpr int kBadArgument = 2002;

struct Image {
  const uint8_t* src;
  uint8_t* dst;
  int height;
  int width;
  float m[6];
};

struct Batch {
  Image image[kMaxImages];
};

__device__ __forceinline__ float texel(const uint8_t* src, int width, bool ok,
                                       int y, int x, int c) {
  return ok ? (float)src[((size_t)y * width + x) * 3 + c] : 0.0f;
}

__global__ void warp_affine_kernel(const __grid_constant__ Batch batch,
                                   int out_h, int out_w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= out_w || y >= out_h) return;
  const Image& im = batch.image[blockIdx.z];
  const float fx = (float)x, fy = (float)y;
  const float sx = fmaf(im.m[0], fx, __fadd_rn(__fmul_rn(im.m[1], fy), im.m[2]));
  const float sy = fmaf(im.m[3], fx, __fadd_rn(__fmul_rn(im.m[4], fy), im.m[5]));
  const float flx = floorf(sx), fly = floorf(sy);
  const float ax = __fsub_rn(sx, flx), ay = __fsub_rn(sy, fly);
  // clamped so that the conversion is defined: a point left of -1 or right
  // of the image has both neighbours outside either way
  const int ix = (int)fminf(fmaxf(flx, -2.0f), (float)im.width);
  const int iy = (int)fminf(fmaxf(fly, -2.0f), (float)im.height);
  const bool x0 = ix >= 0 && ix < im.width;
  const bool x1 = ix + 1 >= 0 && ix + 1 < im.width;
  const bool y0 = iy >= 0 && iy < im.height;
  const bool y1 = iy + 1 >= 0 && iy + 1 < im.height;
  uint8_t* out = im.dst + ((size_t)y * out_w + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p00 = texel(im.src, im.width, y0 && x0, iy, ix, c);
    const float p01 = texel(im.src, im.width, y0 && x1, iy, ix + 1, c);
    const float p10 = texel(im.src, im.width, y1 && x0, iy + 1, ix, c);
    const float p11 = texel(im.src, im.width, y1 && x1, iy + 1, ix + 1, c);
    const float top = fmaf(ax, __fsub_rn(p01, p00), p00);
    const float bottom = fmaf(ax, __fsub_rn(p11, p10), p10);
    const int v = __float2int_rn(fmaf(ay, __fsub_rn(bottom, top), top));
    out[c] = (uint8_t)min(max(v, 0), 255);
  }
}

}  // namespace

// Warps n images (n <= 64) to out_h x out_w on stream: srcs[i] an
// heights[i] x widths[i] x 3 uint8 image, dsts[i] an out_h x out_w x 3 one,
// both contiguous on the card; mats the n inverse affines, 6 floats each,
// read here on the host.
extern "C" int cfd_warp_affine(const void* const* srcs, void* const* dsts,
                               const int* heights, const int* widths, int n,
                               int out_h, int out_w, const float* mats,
                               void* stream) {
  if (n < 1 || n > kMaxImages || out_h < 1 || out_w < 1 || out_h > 65535 * 8)
    return kBadArgument;
  Batch batch;
  std::memset(&batch, 0, sizeof(batch));
  for (int i = 0; i < n; ++i) {
    if (srcs[i] == nullptr || dsts[i] == nullptr || heights[i] < 1 ||
        widths[i] < 1)
      return kBadArgument;
    batch.image[i].src = static_cast<const uint8_t*>(srcs[i]);
    batch.image[i].dst = static_cast<uint8_t*>(dsts[i]);
    batch.image[i].height = heights[i];
    batch.image[i].width = widths[i];
    std::memcpy(batch.image[i].m, mats + 6 * i, 6 * sizeof(float));
  }
  const dim3 block(32, 8);
  const dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, n);
  warp_affine_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      batch, out_h, out_w);
  return (int)cudaGetLastError();
}
