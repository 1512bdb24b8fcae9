// Modulated 3x3 stride-1 deformable convolution (DCNv2) backward, NCHW, in
// fp32 and in bf16 (the mixed-precision model).
//
// Replaces the backward of the TPU kernel deform_conv2d_fast
// (centerfusiondetect3d_tpu/ops/pallas_dcn.py:409, _fast_bwd), which is the
// VJP of the exact gather formulation centerfusiondetect3d_tpu/ops/dcn.py:29
// with the offset clamp inside the differentiated function, in the dtype of
// the activations. The backward of a node is, with cols the modulated
// sampled columns of the forward,
//
//   cols[b, c*9+k, p] = mask[b,k,p] * bilinear(x[b,c], p + t_k + off_k(p))
//   dweight = sum_b g_b . cols_b^T      (O, 9C), one plain GEMM over B*HW
//   dcols   = W^T . g                   (9C, B*HW), one plain GEMM
//   dx      = scatter of dcols * mask * corner weight     (dcn_col2im)
//   doffset, dmask = reductions over C of dcols           (dcn_col2im_coord)
//
// and this file holds the three kernels around the two GEMMs, each
// templated on the storage type T of x, cols and dcols (float or
// __nv_bfloat16); every sum and product is f32 in both:
//
// dcn_im2col: cols from the saved x, offset and mask (the forward stays fused
//   and never writes them). One thread per (b, k, pixel) and 16 channels:
//   the tap's corner indices and mask-folded weights are computed once and
//   reused for the 16 gathers; the writes are coalesced along the pixel. In
//   bf16 each f32 column value is rounded once, as dcn_fwd_bf16.cu rounds the
//   taps it contracts (the same products in the same order).
// dcn_col2im: dx. Same decomposition; each (c, k, p) adds dcols * mask *
//   w_corner into the in-image corners of an f32 dx with f32 atomicAdd, so the
//   summation order (and the last bits of dx) changes from run to run. An
//   element of dx gathers up to 36 contributions per channel, which bf16
//   atomics would mostly lose: the bf16 entry point scatters into an f32
//   scratch and a second kernel rounds it once to the bf16 dx (run-to-run
//   bits still vary, as in fp32).
// dcn_col2im_coord: doffset (18 per pixel) and dmask (9 per pixel), f32 in
//   both dtypes (offset and mask are f32). A block owns 32 pixels of one
//   (b, k) and splits C over 8 lanes of 32 threads; each thread sums dcols
//   times the unmasked sampled value (dmask) and times the derivatives of the
//   bilinear weights (doffset, which carries the mask), then the lanes are
//   reduced in shared memory: no atomics.
//
// Gradient conventions are those of autograd on the plain version
// (ops/dcn.py:deform_conv2d_plain), of jax.grad of the JAX formulation and of
// torchvision: the corner pair comes from floor(), so at an integer
// coordinate the derivative is one-sided (x[y0+1] - x[y0]); a corner outside
// the image has value zero, but the in-image corners of the same sample
// still give offset gradients; max_offset >= 0 clamps dy and dx to
// +-max_offset before sampling and zeroes the offset gradient where the
// offset lay outside [-max_offset, max_offset] (torch.clamp's backward);
// max_offset < 0 means no clamp.
//
// What bounds it: all three kernels do a few flops per element they move
// (im2col ~8 per column written, col2im ~9 per column read, coord ~14 per
// column read) against the card's fp32 balance of 20 flops per byte, so they
// are bound by bytes: the 9C x HW columns written once by im2col and read
// once by each of col2im and coord dominate (half the bytes in bf16), with
// the gathers of x served from L1/L2. The design keeps every access to the
// columns coalesced and pays the tap geometry once per 16 channels (im2col,
// col2im) or per pixel (coord). The GEMMs go through torch.matmul (fp32 with
// TF32 off, or bf16 on the tensor cores); fusing them with these kernels so
// that the columns never reach device memory, wgmma and TMA are the next
// steps.
//
// Layouts: x (B, C, H, W); offset (B, 18, H, W) f32 with offset[2k] = dy_k
// and offset[2k+1] = dx_k, taps k = 3i + j in row-major order; mask
// (B, 9, H, W) f32, already sigmoided; cols and dcols hold row c*9 + k (the
// row order of weight.reshape(O, 9C)) of image b at pixel p at
// b * stride_b + row * stride_row + p: the entry points take the two strides,
// the pixels are contiguous. The wrappers (ops/dcn.py) write the columns
// (9C, B, HW), so that each GEMM is one product over the B*HW axis; dx
// (B, C, H, W) (fp32: zeroed by the caller; bf16: its f32 scratch is);
// doffset (B, 18, H, W) f32; dmask (B, 9, H, W) f32. Every other tensor is
// contiguous in that layout, all on one device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 128;         // pixels per block (im2col, col2im)
constexpr int kChanPerThread = 16;  // channels per thread (im2col, col2im)
constexpr int kCoordPix = 32;     // pixels per block (coord)
constexpr int kCoordLanes = 8;    // channel lanes per block (coord)
constexpr int kRoundThreads = 256;  // threads per block (the dx rounding)

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Where row c*9 + k of image b starts in cols or dcols (see Layouts).
struct Columns {
  size_t stride_b;
  size_t stride_row;
  __device__ __forceinline__ size_t at(int b, int row, int p) const {
    return (size_t)b * stride_b + (size_t)row * stride_row + p;
  }
};

// The geometry of one tap at one output pixel.
struct Tap {
  int idx[4];      // flat index of each corner in the H*W plane, 0 outside
  float valid[4];  // 1 for a corner inside the image, 0 outside
  float ly, lx;    // fractional parts of the sampling position
  bool pass_y;     // dy inside the clamp range: its gradient passes
  bool pass_x;
};

__device__ __forceinline__ Tap make_tap(const float* __restrict__ offset,
                                        int b, int k, int p, int H, int W,
                                        float max_offset) {
  const int hw = H * W;
  const int h = p / W;
  const int w = p - h * W;
  float dy = offset[((size_t)b * 18 + 2 * k) * hw + p];
  float dx = offset[((size_t)b * 18 + 2 * k + 1) * hw + p];
  Tap t;
  t.pass_y = true;
  t.pass_x = true;
  if (max_offset >= 0.f) {
    t.pass_y = dy >= -max_offset && dy <= max_offset;
    t.pass_x = dx >= -max_offset && dx <= max_offset;
    dy = fminf(fmaxf(dy, -max_offset), max_offset);
    dx = fminf(fmaxf(dx, -max_offset), max_offset);
  }
  const float py = (float)(h + k / 3 - 1) + dy;
  const float px = (float)(w + k % 3 - 1) + dx;
  const float fy = floorf(py);
  const float fx = floorf(px);
  t.ly = py - fy;
  t.lx = px - fx;
  // a floor below -2 or above H (W) leaves both corners outside either way;
  // clamping it first keeps the int conversion in range for wild offsets
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H);
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W);
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const int yy = y0 + (corner >> 1);
    const int xx = x0 + (corner & 1);
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    t.idx[corner] = inside ? yy * W + xx : 0;
    t.valid[corner] = inside ? 1.f : 0.f;
  }
  return t;
}

// Bilinear weight of each corner, times `scale`, zero outside the image.
__device__ __forceinline__ void corner_weights(const Tap& t, float scale,
                                               float wgt[4]) {
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const float wy = (corner >> 1) ? t.ly : 1.f - t.ly;
    const float wx = (corner & 1) ? t.lx : 1.f - t.lx;
    wgt[corner] = scale * wy * wx * t.valid[corner];
  }
}

template <typename T>
__global__ void __launch_bounds__(kPix)
dcn_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, T* __restrict__ cols,
                  Columns layout, int C, int H, int W, float max_offset) {
  const int hw = H * W;
  const int p = blockIdx.x * kPix + threadIdx.x;
  const int k = blockIdx.y % 9;
  const int c0 = (blockIdx.y / 9) * kChanPerThread;
  const int b = blockIdx.z;
  if (p >= hw) return;
  const Tap t = make_tap(offset, b, k, p, H, W, max_offset);
  float wgt[4];
  corner_weights(t, mask[((size_t)b * 9 + k) * hw + p], wgt);
  const int c1 = min(c0 + kChanPerThread, C);
  for (int c = c0; c < c1; ++c) {
    const T* xc = x + ((size_t)b * C + c) * hw;
    const float v = wgt[0] * load_f32(xc + t.idx[0]) +
                    wgt[1] * load_f32(xc + t.idx[1]) +
                    wgt[2] * load_f32(xc + t.idx[2]) +
                    wgt[3] * load_f32(xc + t.idx[3]);
    store_f32(cols + layout.at(b, c * 9 + k, p), v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kPix)
dcn_col2im_kernel(const T* __restrict__ dcols,
                  const float* __restrict__ offset,
                  const float* __restrict__ mask, float* __restrict__ dx,
                  Columns layout, int C, int H, int W, float max_offset) {
  const int hw = H * W;
  const int p = blockIdx.x * kPix + threadIdx.x;
  const int k = blockIdx.y % 9;
  const int c0 = (blockIdx.y / 9) * kChanPerThread;
  const int b = blockIdx.z;
  if (p >= hw) return;
  const Tap t = make_tap(offset, b, k, p, H, W, max_offset);
  float wgt[4];
  corner_weights(t, mask[((size_t)b * 9 + k) * hw + p], wgt);
  const int c1 = min(c0 + kChanPerThread, C);
  for (int c = c0; c < c1; ++c) {
    const float g = load_f32(dcols + layout.at(b, c * 9 + k, p));
    if (g == 0.f) continue;
    float* dxc = dx + ((size_t)b * C + c) * hw;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner)
      if (wgt[corner] != 0.f) atomicAdd(dxc + t.idx[corner], g * wgt[corner]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCoordPix * kCoordLanes)
dcn_col2im_coord_kernel(const T* __restrict__ dcols, const T* __restrict__ x,
                        const float* __restrict__ offset,
                        const float* __restrict__ mask,
                        float* __restrict__ doffset,
                        float* __restrict__ dmask, Columns layout, int C,
                        int H, int W, float max_offset) {
  __shared__ float s_red[3][kCoordLanes][kCoordPix];
  const int hw = H * W;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int p = blockIdx.x * kCoordPix + tx;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  float acc_m = 0.f, acc_y = 0.f, acc_x = 0.f;
  Tap t = {};
  if (p < hw) {
    t = make_tap(offset, b, k, p, H, W, max_offset);
    const float ly = t.ly, lx = t.lx;
    for (int c = ty; c < C; c += kCoordLanes) {
      const float g = load_f32(dcols + layout.at(b, c * 9 + k, p));
      const T* xc = x + ((size_t)b * C + c) * hw;
      const float v00 = t.valid[0] * load_f32(xc + t.idx[0]);
      const float v01 = t.valid[1] * load_f32(xc + t.idx[1]);
      const float v10 = t.valid[2] * load_f32(xc + t.idx[2]);
      const float v11 = t.valid[3] * load_f32(xc + t.idx[3]);
      const float val = (1.f - ly) * ((1.f - lx) * v00 + lx * v01) +
                        ly * ((1.f - lx) * v10 + lx * v11);
      const float d_y = (1.f - lx) * (v10 - v00) + lx * (v11 - v01);
      const float d_x = (1.f - ly) * (v01 - v00) + ly * (v11 - v10);
      acc_m = fmaf(g, val, acc_m);
      acc_y = fmaf(g, d_y, acc_y);
      acc_x = fmaf(g, d_x, acc_x);
    }
  }
  s_red[0][ty][tx] = acc_m;
  s_red[1][ty][tx] = acc_y;
  s_red[2][ty][tx] = acc_x;
  __syncthreads();
  if (ty != 0 || p >= hw) return;
  float sm = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
  for (int lane = 0; lane < kCoordLanes; ++lane) {
    sm += s_red[0][lane][tx];
    sy += s_red[1][lane][tx];
    sx += s_red[2][lane][tx];
  }
  const float m = mask[((size_t)b * 9 + k) * hw + p];
  dmask[((size_t)b * 9 + k) * hw + p] = sm;
  doffset[((size_t)b * 18 + 2 * k) * hw + p] = t.pass_y ? m * sy : 0.f;
  doffset[((size_t)b * 18 + 2 * k + 1) * hw + p] = t.pass_x ? m * sx : 0.f;
}

// dst[i] = src[i] rounded to bf16 (the bf16 dx from its f32 scratch).
__global__ void __launch_bounds__(kRoundThreads)
round_to_bf16_kernel(const float* __restrict__ src,
                     __nv_bfloat16* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * kRoundThreads + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

bool bad_shape(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535;
}

dim3 column_grid(int B, int C, int H, int W) {
  return dim3((H * W + kPix - 1) / kPix,
              9 * ((C + kChanPerThread - 1) / kChanPerThread), B);
}

template <typename T>
int im2col(const T* x, const float* offset, const float* mask, T* cols,
           Columns layout, int B, int C, int H, int W, float max_offset,
           void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  dcn_im2col_kernel<T><<<column_grid(B, C, H, W), kPix, 0,
                         (cudaStream_t)stream>>>(
      x, offset, mask, cols, layout, C, H, W, max_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int col2im(const T* dcols, const float* offset, const float* mask, float* dx,
           Columns layout, int B, int C, int H, int W, float max_offset,
           void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  dcn_col2im_kernel<T><<<column_grid(B, C, H, W), kPix, 0,
                         (cudaStream_t)stream>>>(
      dcols, offset, mask, dx, layout, C, H, W, max_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int col2im_coord(const T* dcols, const T* x, const float* offset,
                 const float* mask, float* doffset, float* dmask,
                 Columns layout, int B, int C, int H, int W,
                 float max_offset, void* stream) {
  if (bad_shape(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + kCoordPix - 1) / kCoordPix, 9, B);
  const dim3 block(kCoordPix, kCoordLanes);
  dcn_col2im_coord_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      dcols, x, offset, mask, doffset, dmask, layout, C, H, W, max_offset);
  return (int)cudaGetLastError();
}

const __nv_bfloat16* bf16(const void* p) {
  return static_cast<const __nv_bfloat16*>(p);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success). The bf16 ones take bf16 x, cols and dcols as void pointers.
// stride_b and stride_row place the rows of cols or dcols (see Layouts).

extern "C" int cfd_dcn_im2col(const float* x, const float* offset,
                              const float* mask, float* cols, int B, int C,
                              int H, int W, long long stride_b,
                              long long stride_row, float max_offset,
                              void* stream) {
  return im2col(x, offset, mask, cols, {(size_t)stride_b, (size_t)stride_row},
                B, C, H, W, max_offset, stream);
}

extern "C" int cfd_dcn_col2im(const float* dcols, const float* offset,
                              const float* mask, float* dx, int B, int C,
                              int H, int W, long long stride_b,
                              long long stride_row, float max_offset,
                              void* stream) {
  return col2im(dcols, offset, mask, dx,
                {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                max_offset, stream);
}

extern "C" int cfd_dcn_col2im_coord(const float* dcols, const float* x,
                                    const float* offset, const float* mask,
                                    float* doffset, float* dmask, int B,
                                    int C, int H, int W, long long stride_b,
                                    long long stride_row, float max_offset,
                                    void* stream) {
  return col2im_coord(dcols, x, offset, mask, doffset, dmask,
                      {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                      max_offset, stream);
}

extern "C" int cfd_dcn_im2col_bf16(const void* x, const float* offset,
                                   const float* mask, void* cols, int B,
                                   int C, int H, int W, long long stride_b,
                                   long long stride_row, float max_offset,
                                   void* stream) {
  return im2col(bf16(x), offset, mask, static_cast<__nv_bfloat16*>(cols),
                {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                max_offset, stream);
}

// dx_f32: a zeroed f32 scratch of dx's size; dx: the bf16 result.
extern "C" int cfd_dcn_col2im_bf16(const void* dcols, const float* offset,
                                   const float* mask, float* dx_f32, void* dx,
                                   int B, int C, int H, int W,
                                   long long stride_b, long long stride_row,
                                   float max_offset, void* stream) {
  const int err = col2im(bf16(dcols), offset, mask, dx_f32,
                         {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                         max_offset, stream);
  if (err != 0) return err;
  const size_t n = (size_t)B * C * H * W;
  round_to_bf16_kernel<<<(unsigned)((n + kRoundThreads - 1) / kRoundThreads),
                         kRoundThreads, 0, (cudaStream_t)stream>>>(
      dx_f32, static_cast<__nv_bfloat16*>(dx), n);
  return (int)cudaGetLastError();
}

extern "C" int cfd_dcn_col2im_coord_bf16(const void* dcols, const void* x,
                                         const float* offset,
                                         const float* mask, float* doffset,
                                         float* dmask, int B, int C, int H,
                                         int W, long long stride_b,
                                         long long stride_row,
                                         float max_offset, void* stream) {
  return col2im_coord(bf16(dcols), bf16(x), offset, mask, doffset, dmask,
                      {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                      max_offset, stream);
}
