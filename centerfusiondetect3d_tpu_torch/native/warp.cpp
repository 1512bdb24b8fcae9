// Host kernel of the data loader: the affine warp of a uint8 image with
// bilinear interpolation and a zero border, as data/transforms.py:warp_image
// computes it in numpy (cv2.warpAffine(..., INTER_LINEAR) in the arithmetic
// of cv2's warp kernels), bitwise. The JAX package warps each item with
// cv2, whose C++ runs without the interpreter lock; this kernel does the
// same for the port, whose card machine has no opencv.
//
// warp_image's operations, in its order and types:
//   row terms   m1 * y + m2, m4 * y + m5        float32 products and sums
//   source      sx = (double) m0 * x + row      rounded once to float32
//   weights     ax = sx - floor(sx)             float32
//   lerps       top = (double) ax * (p01 - p00) + p00, bottom likewise,
//               out = (double) ay * (bottom - top) + top, each to float32
//   store       rint (half to even), clipped to [0, 255]
// Each "(double) a * b + c" is numpy's _fma: the product of two float32
// values is exact in double, the sum is rounded in double and then to
// float32. Built with -ffp-contract=off, so that no product and sum is
// fused into one rounding. A neighbour outside the image reads 0.

#include <cmath>
#include <cstdint>

extern "C" {

// src: (H, W, C) uint8; inv: the float32 inverse affine (6 values, row
// major 2x3: a destination pixel (x, y) reads the source at inv (x, y, 1));
// dst: (OH, OW, C) uint8.
void warp_bilinear_u8(const uint8_t* src, int H, int W, int C,
                      const float* inv, uint8_t* dst, int OH, int OW) {
  for (int y = 0; y < OH; ++y) {
    const float fy = static_cast<float>(y);
    const float row_x = inv[1] * fy + inv[2];
    const float row_y = inv[4] * fy + inv[5];
    for (int x = 0; x < OW; ++x) {
      const double fx = static_cast<double>(static_cast<float>(x));
      const float sx = static_cast<float>(
          static_cast<double>(inv[0]) * fx + static_cast<double>(row_x));
      const float sy = static_cast<float>(
          static_cast<double>(inv[3]) * fx + static_cast<double>(row_y));
      const float flx = std::floor(sx), fly = std::floor(sy);
      const double ax = static_cast<double>(sx - flx);
      const double ay = static_cast<double>(sy - fly);
      const int64_t ix = static_cast<int64_t>(flx);
      const int64_t iy = static_cast<int64_t>(fly);
      const bool x0 = ix >= 0 && ix < W, x1 = ix + 1 >= 0 && ix + 1 < W;
      const bool y0 = iy >= 0 && iy < H, y1 = iy + 1 >= 0 && iy + 1 < H;
      const uint8_t* r0 = src + (y0 ? iy * W * C : 0);
      const uint8_t* r1 = src + (y1 ? (iy + 1) * W * C : 0);
      uint8_t* out = dst + (static_cast<int64_t>(y) * OW + x) * C;
      for (int c = 0; c < C; ++c) {
        const float p00 = (y0 && x0) ? r0[ix * C + c] : 0.0f;
        const float p01 = (y0 && x1) ? r0[(ix + 1) * C + c] : 0.0f;
        const float p10 = (y1 && x0) ? r1[ix * C + c] : 0.0f;
        const float p11 = (y1 && x1) ? r1[(ix + 1) * C + c] : 0.0f;
        const float top = static_cast<float>(
            ax * static_cast<double>(p01 - p00) + static_cast<double>(p00));
        const float bottom = static_cast<float>(
            ax * static_cast<double>(p11 - p10) + static_cast<double>(p10));
        float v = std::nearbyint(static_cast<float>(
            ay * static_cast<double>(bottom - top) + static_cast<double>(top)));
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        out[c] = static_cast<uint8_t>(v);
      }
    }
  }
}

}  // extern "C"
