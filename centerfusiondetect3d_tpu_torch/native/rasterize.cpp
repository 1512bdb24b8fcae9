// Host kernels of the data loader: the overwrite-ordered radar rectangle
// paint (reference src/lib/dataset/datasets/nuscenes.py:234-263), its
// one-hot form, and a max-splat of gaussian peaks (utils/image.py:220-256).
//
// The port's own copy of centerfusiondetect3d_tpu/native/rasterize.cpp,
// unchanged but for this comment. A plain C ABI, called through ctypes
// (native/__init__.py builds it with g++ at first use); the numpy versions
// in native/__init__.py are the plain versions the tests hold it to.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// Paint N axis-aligned rectangles into an (H, W, C) float map, in order
// (later boxes overwrite earlier ones). boxes: int32 (N, 4) [y1, y2, x1, x2)
// exclusive-stop; values: float (N, C) written to every covered pixel.
void paint_rects(float* map, int H, int W, int C,
                 const int32_t* boxes, const float* values, int N) {
  for (int n = 0; n < N; ++n) {
    int y1 = std::max(boxes[4 * n + 0], 0);
    int y2 = std::min(boxes[4 * n + 1], H);
    int x1 = std::max(boxes[4 * n + 2], 0);
    int x2 = std::min(boxes[4 * n + 3], W);
    const float* v = values + n * C;
    for (int y = y1; y < y2; ++y) {
      float* row = map + (static_cast<int64_t>(y) * W + x1) * C;
      for (int x = x1; x < x2; ++x) {
        float* px = row + static_cast<int64_t>(x - x1) * C;
        for (int c = 0; c < C; ++c) px[c] = v[c];
      }
    }
  }
}

// Same as paint_rects but writes each value into a caller-chosen channel
// (one-hot radar layout): channels: int32 (N, C) destination channel per
// value column, n_vals values per box.
void paint_rects_channels(float* map, int H, int W, int C,
                          const int32_t* boxes, const float* values,
                          const int32_t* channels, int n_vals, int N) {
  for (int n = 0; n < N; ++n) {
    int y1 = std::max(boxes[4 * n + 0], 0);
    int y2 = std::min(boxes[4 * n + 1], H);
    int x1 = std::max(boxes[4 * n + 2], 0);
    int x2 = std::min(boxes[4 * n + 3], W);
    const float* v = values + n * n_vals;
    const int32_t* ch = channels + n * n_vals;
    for (int y = y1; y < y2; ++y) {
      for (int x = x1; x < x2; ++x) {
        float* px = map + (static_cast<int64_t>(y) * W + x) * C;
        for (int k = 0; k < n_vals; ++k) px[ch[k]] = v[k];
      }
    }
  }
}

// Max-splat N gaussian peaks onto an (H, W) plane.
// centers: float (N, 2) [x, y]; radii: int32 (N, 2) [rx, ry]; peak value 1.
void splat_gaussians(float* heat, int H, int W,
                     const float* centers, const int32_t* radii, int N) {
  for (int n = 0; n < N; ++n) {
    int cx = static_cast<int>(centers[2 * n + 0]);
    int cy = static_cast<int>(centers[2 * n + 1]);
    int rx = radii[2 * n + 0];
    int ry = radii[2 * n + 1];
    int dx_dia = 2 * rx + 1, dy_dia = 2 * ry + 1;
    double sx = dx_dia / 6.0, sy = dy_dia / 6.0;
    int left = std::min(cx, rx), right = std::min(W - cx, rx + 1);
    int top = std::min(cy, ry), bottom = std::min(H - cy, ry + 1);
    if (left + right <= 0 || top + bottom <= 0) continue;
    for (int dy = -top; dy < bottom; ++dy) {
      float* row = heat + static_cast<int64_t>(cy + dy) * W;
      for (int dx = -left; dx < right; ++dx) {
        double g = std::exp(-(dx * dx) / (2 * sx * sx) - (dy * dy) / (2 * sy * sy));
        float& px = row[cx + dx];
        if (g > px) px = static_cast<float>(g);
      }
    }
  }
}

}  // extern "C"
