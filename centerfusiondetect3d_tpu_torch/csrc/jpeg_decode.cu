// JPEG decoding on the card: nvJPEG, the CUDA toolkit's decoder, for the
// entropy decoding and the inverse DCT, then libjpeg's own chroma
// upsampling and colour conversion in a kernel of our own.
//
// The counterpart of cv2.imread in the JAX package's dataset
// (centerfusiondetect3d_tpu/data/dataset.py:73) for the port on a CUDA
// device (data/image_io.py). cv2 decodes with libjpeg(-turbo), which
// upsamples subsampled chroma with its "fancy" triangle filter and converts
// YCbCr to RGB in 16-bit fixed point; nvJPEG's own BGR output upsamples
// otherwise and lands tens of levels from cv2 at colour edges. So nvJPEG
// hands back the planes as the file holds them (Y, and Cb and Cr at their
// sampling), and ycc_to_bgr_kernel applies jdsample.c's h2v1/h2v2 fancy
// upsampling and jdcolor.c's ycc_rgb_convert into interleaved BGR uint8,
// cv2's channel order. What is left between the two decoders is the inverse
// DCT's rounding. data/image_io.py:ycc_to_bgr_plain is the kernel's plain
// version.
//
// One nvJPEG handle and decoder state serve every call; a mutex serializes
// the calls, since a decoder state takes one image at a time: its pinned
// and device buffers serve the decode's copies and kernels on the caller's
// stream, so a decode waits for that stream before it lets the next one
// in, whichever stream the next one is on. Built by ops/cuda_build.py with
// -lnvjpeg at first use.
//
// Status codes: 0 ok; 1-9 nvjpegStatus_t as nvJPEG returns it; 1000 + a
// CUDA error; 2000 when the image is not the size the caller allocated for;
// 2001 when its components or chroma sampling are not grey, 4:4:4, 4:2:2
// or 4:2:0.

#include <cstring>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;

constexpr int kUnsupported = 2001;

// the handle and the decoder state, created at the first call
int ensure_decoder() {
  if (g_state != nullptr) return 0;
  if (g_handle == nullptr) {
    const nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return (int)s;
    }
  }
  const nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &g_state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    g_state = nullptr;
    return (int)s;
  }
  return 0;
}

// width and height of the image and of its chroma planes (0 for grey)
int image_info(const unsigned char* data, size_t len, int* width, int* height,
               int* components, int* subsampling, int* chroma_width,
               int* chroma_height) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t sub = NVJPEG_CSS_UNKNOWN;
  const nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, len, components,
                                              &sub, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  *width = widths[0];
  *height = heights[0];
  *subsampling = (int)sub;
  *chroma_width = *components == 3 ? widths[1] : 0;
  *chroma_height = *components == 3 ? heights[1] : 0;
  if (*components == 1) return 0;
  if (*components != 3 || widths[2] != widths[1] || heights[2] != heights[1])
    return kUnsupported;
  return 0;
}

// 1 where a chroma plane of size c is the image's size n halved (rounded
// up), 0 where it is n itself, -1 otherwise
int halving(int c, int n) {
  if (c == n) return 0;
  return c == (n + 1) / 2 ? 1 : -1;
}

// libjpeg's fancy upsampling (jdsample.c) of a chroma plane (cw x ch, a
// row every cw bytes) at output pixel (x, y): h2v1 a 3:1 blend along the
// row; h2v2 the 3:1 blend of the nearer and the farther row, then a 3:1
// blend of those column sums along the row, rounded with jdsample.c's
// biases 8 and 7. Edge samples stand in for the missing neighbours.
__device__ __forceinline__ int fancy_chroma(const unsigned char* c, int cw,
                                            int ch, int x, int y, int hs,
                                            int vs) {
  if (hs == 0) return c[y * cw + x];
  const int j = x >> 1;
  const int jn = (x & 1) ? min(j + 1, cw - 1) : max(j - 1, 0);
  if (vs == 0) {
    const unsigned char* row = c + (size_t)y * cw;
    return (3 * row[j] + row[jn] + ((x & 1) ? 2 : 1)) >> 2;
  }
  const int i = y >> 1;
  const unsigned char* nearer = c + (size_t)i * cw;
  const unsigned char* farther =
      c + (size_t)((y & 1) ? min(i + 1, ch - 1) : max(i - 1, 0)) * cw;
  const int here = 3 * nearer[j] + farther[j];
  const int there = 3 * nearer[jn] + farther[jn];
  return (3 * here + there + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ unsigned char clamp_u8(int v) {
  return (unsigned char)min(max(v, 0), 255);
}

// One thread a pixel: fancy-upsampled Cb and Cr, then jdcolor.c's
// ycc_rgb_convert (16-bit fixed point: FIX(1.40200) = 91881, FIX(1.77200)
// = 116130, FIX(0.34414) = 22554, FIX(0.71414) = 46802, ONE_HALF =
// 32768), written as B, G, R. Grey (cb null) repeats Y.
__global__ void ycc_to_bgr_kernel(const unsigned char* __restrict__ yp,
                                  const unsigned char* __restrict__ cb,
                                  const unsigned char* __restrict__ cr,
                                  unsigned char* __restrict__ out, int width,
                                  int height, int cw, int ch, int hs, int vs) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t p = (size_t)y * width + x;
  const int luma = yp[p];
  unsigned char* o = out + 3 * p;
  if (cb == nullptr) {
    o[0] = o[1] = o[2] = (unsigned char)luma;
    return;
  }
  const int b = fancy_chroma(cb, cw, ch, x, y, hs, vs) - 128;
  const int r = fancy_chroma(cr, cw, ch, x, y, hs, vs) - 128;
  o[0] = clamp_u8(luma + ((116130 * b + 32768) >> 16));
  o[1] = clamp_u8(luma + ((-22554 * b - 46802 * r + 32768) >> 16));
  o[2] = clamp_u8(luma + ((91881 * r + 32768) >> 16));
}

}  // namespace

// The size of the JPEG in data (len bytes): width, height, number of
// components, nvJPEG's chroma subsampling code, and the size of its chroma
// planes (0 for grey)
extern "C" int cfd_jpeg_info(const unsigned char* data, size_t len,
                             int* width, int* height, int* components,
                             int* subsampling, int* chroma_width,
                             int* chroma_height) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const int s = ensure_decoder();
  if (s != 0) return s;
  return image_info(data, len, width, height, components, subsampling,
                    chroma_width, chroma_height);
}

// Decodes the JPEG in data into its planes, device buffers of width x height
// (y) and chroma_width x chroma_height bytes (cb, cr; null for grey), on
// stream, and waits for stream: the decoder state and data are free again
// when this returns
extern "C" int cfd_jpeg_decode_planes(const unsigned char* data, size_t len,
                                      unsigned char* y, unsigned char* cb,
                                      unsigned char* cr, int width,
                                      int height, int chroma_width,
                                      int chroma_height,
                                      cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int s = ensure_decoder();
  if (s != 0) return s;
  int w = 0, h = 0, components = 0, subsampling = 0, cw = 0, ch = 0;
  s = image_info(data, len, &w, &h, &components, &subsampling, &cw, &ch);
  if (s != 0) return s;
  if (w != width || h != height || cw != chroma_width ||
      ch != chroma_height || (components == 3) != (cb != nullptr))
    return 2000;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = y;
  image.pitch[0] = (size_t)width;
  if (cb != nullptr) {
    image.channel[1] = cb;
    image.channel[2] = cr;
    image.pitch[1] = image.pitch[2] = (size_t)chroma_width;
  }
  const nvjpegStatus_t st = nvjpegDecode(
      g_handle, g_state, data, len,
      cb != nullptr ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &image, stream);
  if (st != NVJPEG_STATUS_SUCCESS) return (int)st;
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return e == cudaSuccess ? 0 : 1000 + (int)e;
}

// Interleaved BGR (height x width x 3 bytes at out) from the planes: Y at
// width x height, Cb and Cr at chroma_width x chroma_height, each the image's
// size or its half (rounded up) across, and down only where halved across
// (4:4:4, 4:2:2, 4:2:0); cb and cr null for grey. Launches on stream.
extern "C" int cfd_ycc_to_bgr(const unsigned char* y, const unsigned char* cb,
                              const unsigned char* cr, unsigned char* out,
                              int width, int height, int chroma_width,
                              int chroma_height, cudaStream_t stream) {
  int hs = 0, vs = 0;
  if (cb != nullptr) {
    hs = halving(chroma_width, width);
    vs = halving(chroma_height, height);
    if (hs < 0 || vs < 0 || (vs == 1 && hs == 0)) return kUnsupported;
  }
  const dim3 block(32, 8);
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  ycc_to_bgr_kernel<<<grid, block, 0, stream>>>(
      y, cb, cr, out, width, height, chroma_width, chroma_height, hs, vs);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + (int)e;
}
