// Modulated 3x3 stride-1 deformable convolution (DCNv2) backward, in fp32
// and in bf16 (the mixed-precision model).
//
// Replaces the backward of the TPU kernel deform_conv2d_fast
// (centerfusiondetect3d_tpu/ops/pallas_dcn.py:409, _fast_bwd), which is the
// VJP of the exact gather formulation centerfusiondetect3d_tpu/ops/dcn.py:29
// with the offset clamp inside the differentiated function, in the dtype of
// the activations. The backward of a node is, with cols the modulated
// sampled columns of the forward, pixel-major,
//
//   cols[pix, k, c] = mask[pix, k] * bilinear(x[., c], pix + t_k + off_k)
//   dweight = g . cols           (O, 9C) in (k, c) order, one plain GEMM
//   dcols   = g^T . W_kc         (B*HW, 9C), one plain GEMM (W_kc: the
//                                weight as (O, 9C) in (k, c) order)
//   dx      = the transpose of the sampling, applied to dcols  (dcn_col2im)
//   doffset, dmask = reductions over C of dcols           (dcn_col2im_coord)
//
// and this file holds the kernels around the two GEMMs, each templated on
// the storage type T of x, cols and dcols (float or __nv_bfloat16); every
// sum and product is f32 in both:
//
// dcn_im2col: cols from the saved channels-last x, offset and mask (the
//   forward stays fused and never writes them). A group of lanes owns a
//   pixel and its 9 taps (the front end below): each tap's geometry is
//   computed once for all C, its 4 corners are gathered as 16-byte vectors
//   and blended in f32, and each lane writes one 16-byte vector of the
//   tap's contiguous span of C channels. In bf16 each f32 column value is
//   rounded once, as dcn_fwd_bf16.cu rounds the taps it contracts (the same
//   products in the same order).
// dcn_col2im_coord: doffset (18 per pixel) and dmask (9 per pixel), f32 in
//   both dtypes (offset and mask are f32), on the same front end: the group
//   reads the pixel's dcols row (9C contiguous values) and the corner
//   vectors, sums the 4 corner products over C, reduces them across its
//   lanes in a fixed shuffle order (no atomics: reproducible) and makes the
//   tap's sample and its two derivatives from the 4 sums; the 27 outputs of
//   a block's pixels leave through shared memory, coalesced.
// dcn_col2im: dx, as a gather through an inverse sampling map. This DCN has
//   one deformable group: offset and mask are shared by all C channels, so
//   where column element (pix, k, c) lands in dx, and with what weight
//   mask * wy * wx, does not depend on c. The map has one entry per
//   (b, k, p, corner) that lands in the image with a non-zero weight, at
//   most 36*B*HW entries, C times fewer than a scatter of one f32 atomic
//   per (channel, entry). Four steps build it:
//   1. count (dcn_col2im_zero_kernel, then dcn_col2im_map_kernel<false>,
//      one thread per (b, k, p)): an integer atomicAdd on count[b*HW + q]
//      for each corner that lands on q;
//   2. scan (dcn_col2im_scan_sums_kernel, then dcn_col2im_scan_kernel, a
//      block per 4096 pixels): ends = the inclusive prefix sum of the
//      counts, so that the entries of pixel bq are
//      entries[ends[bq-1] .. ends[bq]) (CSR segments);
//   3. fill (dcn_col2im_map_kernel<true>): each landing corner takes a slot
//      with an integer atomicSub on its count (which ends at 0) and writes
//      its entry there, one 8-byte store: the key p*9 + k (the sample's row
//      in the pixel-major column gradients, so the gather does no division)
//      and the weight, which the fill has at hand;
//   4. sort (dcn_col2im_sort_kernel, one warp per segment): the slots were
//      taken in the order the atomics arrived, so each segment is sorted by
//      key: its entries go into registers, each is written back at its
//      rank.
//      A segment longer than kShortSeg (offsets that converge, up to 9*HW
//      entries when every tap of an image collapses onto one pixel) goes on
//      a list instead, and dcn_col2im_sort_long_kernel sorts it with a
//      block: the keys set bits of a bitmap over the 9*HW keys, and the set
//      bits, counted with a block scan, are written back in order, each
//      with its weight taken again from offset and mask.
//   Then dcn_col2im_gather_kernel<T> reads the pixel-major dcols by entry
//   (row key of image b: the C channels of one (p, k) contiguous, so the
//   GEMM's output is read as it lies, with no copy, where C is a multiple
//   of 32; the wrapper pads other C to Cp, C rounded up to 32) and gives a
//   group of 8 lanes to each (q, 32 channels), 4 channels a lane: the group
//   takes 8 entries of the segment at once, then each entry is one vector
//   load a lane (a coalesced read of the 32 channels), 8 in flight, summed
//   in key order in f32 registers; a warp walks 4 pixels at once, so that
//   4 of the dependent chains (segment end, entries, channels) are in
//   flight. A segment longer than kShortSeg is summed by
//   dcn_col2im_gather_long_kernel<T> instead, so that a pixel on which
//   many samples converge does not hold one group for 9*HW entries: a block
//   per (segment, slab), whose 32 groups take the segment's chunks of 8 in
//   turn, their sums added in group order.
//   dx goes out through a shared-memory tile, each element written once, in
//   T: no float atomic, no f32 scratch, and bf16 rounds once from the f32
//   sum.
//   Run to run: every dx element sums its contributions in the sorted key
//   order of its segment (a long one: a fixed split over the groups, then
//   the groups in order), so dx is bitwise reproducible for the same inputs
//   on the same build.
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
// What bounds them: all of them do a few flops per element they move
// (im2col ~8 per column written, col2im ~8 per column read, coord ~9 per
// column read) against the card's fp32 balance of 20 flops per byte, so they
// are bound by bytes: the 9C x B*HW columns written once by im2col and read
// once by each of col2im and coord dominate (half the bytes in bf16), with
// the corner gathers of x served from L1/L2 (x is C x B*HW, 9 times
// smaller than the columns). im2col and coord move those bytes as 16-byte
// vectors, every warp access to the columns a whole span, so their design
// traffic is the function's own; col2im's design adds the map (8 bytes per
// entry written by the fill, read and written by the sort and read by the
// gather, about 36 entries per pixel) and the gather's reads of each
// entry's 32 channels (about 4 times per column element, mostly from L2).
// Resources (nvcc -Xptxas -v, printed by chip_smoke.py): im2col and coord
// take 256 threads and 256 / G pixels a block, at most 64 registers a
// thread (__launch_bounds__: 4 blocks, 32 warps, per SM; no spills in
// either dtype), coord at most 3.5 KB of shared memory (its output tile),
// im2col none. The GEMMs go through torch.matmul (fp32 with TF32
// off, or bf16 on the tensor cores); fusing them with these kernels so
// that the columns never reach device memory, wgmma and TMA are the next
// steps.
//
// Layouts: x (B, H, W, C) channels-last (im2col, coord); offset
// (B, 18, H, W) f32 with offset[2k] = dy_k and offset[2k+1] = dx_k, taps
// k = 3i + j in row-major order; mask (B, 9, H, W) f32, already sigmoided;
// cols and dcols (B*HW, 9, C): row pix*9 + k holds the C channels of tap k
// of pixel pix = b*HW + p (col2im: (B*HW, 9, Cp)); dx (B, C, H, W), every
// element written by col2im; doffset (B, 18, H, W) f32; dmask (B, 9, H, W)
// f32. col2im's map, int32, allocated by the wrapper: count (B*HW + 1,
// zeroed; the last element counts the long segments), ends (B*HW), entries
// (36*B*HW pairs {key, f32 weight bits}, the first ends[B*HW-1] used),
// long_q (B*HW) and bits (long_blocks * ceil(9*HW / 32)). Every tensor is
// contiguous in that layout, all on one device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

#include "dcn_fwd_common.cuh"  // the 16-byte vector helpers

namespace {

constexpr int kPix = 128;         // pixels per block (the map)
constexpr int kGroup = 8;         // lanes per pixel (gather)
constexpr int kGatherWarps = 8;   // warps per block (gather)
constexpr int kGatherPix = kGatherWarps * 32 / kGroup;  // pixels per block
constexpr int kSortWarps = 8;     // segments per block (sort)
constexpr int kShortSeg = 256;    // longest segment one thread sorts
constexpr int kLongSortThreads = 1024;  // threads per long segment (sort)
constexpr int kMaxEntriesPerPixel = 36;  // 9 taps x 4 corners
constexpr int kScanThreads = 1024;  // threads per block (scan)
constexpr int kScanItems = 4;       // counts per thread (scan)
constexpr int kScanTile = kScanThreads * kScanItems;  // counts per block

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Where tap k of output pixel p samples: its upper-left corner and the
// fractional parts.
struct Sample {
  int y0, x0;      // floor of the sampling position, clamped to [-2, H (W)]
  float ly, lx;    // fractional parts of the sampling position
  bool pass_y;     // dy inside the clamp range: its gradient passes
  bool pass_x;
};

// The geometry of one tap at one output pixel.
struct Tap {
  int idx[4];      // flat index of each corner in the H*W plane, 0 outside
  float valid[4];  // 1 for a corner inside the image, 0 outside
  float ly, lx;
  bool pass_y;
  bool pass_x;
};

__device__ __forceinline__ Sample make_sample(const float* __restrict__ offset,
                                              int b, int k, int p, int H,
                                              int W, float max_offset) {
  const int hw = H * W;
  const int h = p / W;
  const int w = p - h * W;
  float dy = offset[((size_t)b * 18 + 2 * k) * hw + p];
  float dx = offset[((size_t)b * 18 + 2 * k + 1) * hw + p];
  Sample s;
  s.pass_y = true;
  s.pass_x = true;
  if (max_offset >= 0.f) {
    s.pass_y = dy >= -max_offset && dy <= max_offset;
    s.pass_x = dx >= -max_offset && dx <= max_offset;
    dy = fminf(fmaxf(dy, -max_offset), max_offset);
    dx = fminf(fmaxf(dx, -max_offset), max_offset);
  }
  const float py = (float)(h + k / 3 - 1) + dy;
  const float px = (float)(w + k % 3 - 1) + dx;
  const float fy = floorf(py);
  const float fx = floorf(px);
  s.ly = py - fy;
  s.lx = px - fx;
  // a floor below -2 or above H (W) leaves both corners outside either way;
  // clamping it first keeps the int conversion in range for wild offsets
  s.y0 = (int)fminf(fmaxf(fy, -2.f), (float)H);
  s.x0 = (int)fminf(fmaxf(fx, -2.f), (float)W);
  return s;
}

__device__ __forceinline__ Tap make_tap(const float* __restrict__ offset,
                                        int b, int k, int p, int H, int W,
                                        float max_offset) {
  const Sample s = make_sample(offset, b, k, p, H, W, max_offset);
  Tap t;
  t.ly = s.ly;
  t.lx = s.lx;
  t.pass_y = s.pass_y;
  t.pass_x = s.pass_x;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const int yy = s.y0 + (corner >> 1);
    const int xx = s.x0 + (corner & 1);
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

// im2col and coord: one sampling front end on pixel-major columns.
//
// A group of G lanes (C / V vectors rounded up to 8, 16 or 32 lanes; V =
// 16 / sizeof(T) channels a 16-byte vector) owns one pixel and all 9 of
// its taps; a block of kBwdThreads lanes owns kBwdThreads / G consecutive
// pixels of the flattened B*H*W. Lane j computes the geometry of taps j and
// j + G (make_geo, once per (pixel, tap)), and each tap's geometry reaches
// the group's lanes by __shfl_sync. The taps are walked one at a time: a
// lane takes the vectors v = j, j + G, ... of the C channels and issues the
// loads of the tap (the 4 corners of x, and in coord the pixel's dcols
// row) before it uses the first. Few registers (kBwdBlocks blocks per SM)
// hide the loads' latency better than more loads in flight a thread: one
// tap at 4 blocks per SM beat three taps at 2 (1 for coord) and at 3
// blocks per SM, in turns on the H100 (tools/compare_kernels.py; PERF.md).

constexpr int kBwdThreads = 256;  // threads per block (im2col, coord)
constexpr int kBwdBlocks = 4;     // blocks per SM: at most 64 registers

// Where tap k of one pixel samples: row, the channels-last row of x of
// corner (0, 0) (b * HW + y0 * W + x0; the others lie 1, W and W + 1 rows
// on); ly, lx the fractional parts; m the mask; flags bit c for corner
// c = 2 * cy + cx inside the image, kPassY / kPassX for an offset inside the
// clamp range.
struct Geo {
  int row;
  float ly, lx, m;
  int flags;
};
constexpr int kPassY = 16;
constexpr int kPassX = 32;

__device__ __forceinline__ Geo make_geo(const float* __restrict__ offset,
                                        const float* __restrict__ mask,
                                        int pix, int k, int H, int W,
                                        float max_offset) {
  const int hw = H * W;
  const int b = pix / hw;
  const int q = pix - b * hw;
  const Sample s = make_sample(offset, b, k, q, H, W, max_offset);
  Geo g;
  g.row = b * hw + s.y0 * W + s.x0;
  g.ly = s.ly;
  g.lx = s.lx;
  g.m = mask[((size_t)b * 9 + k) * hw + q];
  g.flags = (s.pass_y ? kPassY : 0) | (s.pass_x ? kPassX : 0);
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const int yy = s.y0 + (corner >> 1);
    const int xx = s.x0 + (corner & 1);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) g.flags |= 1 << corner;
  }
  return g;
}

// The geometry of this lane's taps (sub, sub + G) of pixel pix; zeros past
// the last pixel.
template <int G, int kSlots>
__device__ __forceinline__ void lane_geo(Geo (&mine)[kSlots],
                                         const float* __restrict__ offset,
                                         const float* __restrict__ mask,
                                         int pix, int sub, int npix, int H,
                                         int W, float max_offset) {
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int k = sub + t * G;
    mine[t] = (k < 9 && pix < npix)
                  ? make_geo(offset, mask, pix, k, H, W, max_offset)
                  : Geo{0, 0.f, 0.f, 0.f, 0};
  }
}

// Tap k's geometry from the lane of the group (G lanes) that computed it:
// lane k % G, its slot k / G. Every lane of the warp calls it.
template <int G, int kSlots>
__device__ __forceinline__ Geo share_geo(const Geo (&mine)[kSlots], int k) {
  const Geo& src = mine[k / G];
  Geo g;
  g.row = __shfl_sync(0xffffffffu, src.row, k % G, G);
  g.ly = __shfl_sync(0xffffffffu, src.ly, k % G, G);
  g.lx = __shfl_sync(0xffffffffu, src.lx, k % G, G);
  g.m = __shfl_sync(0xffffffffu, src.m, k % G, G);
  g.flags = __shfl_sync(0xffffffffu, src.flags, k % G, G);
  return g;
}

template <typename T>
struct SampleParams {
  const T* x;           // (B, H, W, C) channels-last
  const float* offset;  // (B, 18, H, W)
  const float* mask;    // (B, 9, H, W)
  int C, H, W, npix, nvec;
  int vec;  // C a multiple of V and every pointer 16-byte aligned
  float max_offset;
};

// V channels from c0 of row `row` of a (rows, C) array of T as one 16-byte
// vector, zero past C: one load where `vec`, else element by element.
// kStream: read once and kept out of L1 (dcols); else through L1 (x, whose
// corners neighbouring pixels share).
template <typename T, bool kStream>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ base,
                                          size_t row, int c0, int C,
                                          int vec) {
  constexpr int V = 16 / sizeof(T);
  const T* src = base + row * C + c0;
  if (vec)
    return kStream ? __ldcs(reinterpret_cast<const uint4*>(src))
                   : __ldg(reinterpret_cast<const uint4*>(src));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c0 + j < C)
      w[j * 4 / V] |= dcn_fwd::bits(src[j]) << (V == 8 ? 16 * (j & 1) : 0);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector from c0 of x at corner `corner` of a tap whose corner (0, 0)
// is `row`, the row clamped into x (a corner outside the image has weight
// 0).
template <typename T>
__device__ __forceinline__ uint4 load_corner(const SampleParams<T>& p,
                                             int row, int corner, int c0) {
  const int r = row + (corner >> 1) * p.W + (corner & 1);
  return load_vec<T, false>(p.x, (size_t)min(max(r, 0), p.npix - 1), c0,
                            p.C, p.vec);
}

// Stores V values from c0 of row `row` of a (rows, C) array of T, each
// rounded once to T, none past C.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ base, size_t row,
                                          int c0, int C, int vec,
                                          const float (&v)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  T* dst = base + row * C + c0;
  if (vec) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < V; ++j)
      w[j * 4 / V] |= dcn_fwd::bits(dcn_fwd::from_f32<T>(v[j]))
                      << (V == 8 ? 16 * (j & 1) : 0);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c0 + j < C) dst[j] = dcn_fwd::from_f32<T>(v[j]);
}

// cols[pix, k, c] = mask * bilinear(x, pixel + tap k + offset) for every
// (pixel, tap, channel): the group of pixel pix gathers each tap's 4
// corner vectors, blends them with the mask-folded weights in f32
// (corner_weights' products, summed in corner order) and writes one
// 16-byte vector a lane, rounded once to T: a tap's C channels are one
// contiguous span of cols, written by the group's lanes side by side.
template <typename T, int G>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
dcn_im2col_kernel(const SampleParams<T> p, T* __restrict__ cols) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSlots = (9 + G - 1) / G;
  const int sub = threadIdx.x % G;
  const int pix = blockIdx.x * (kBwdThreads / G) + threadIdx.x / G;
  Geo mine[kSlots];
  lane_geo<G>(mine, p.offset, p.mask, pix, sub, p.npix, p.H, p.W,
              p.max_offset);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const Geo geo = share_geo<G>(mine, k);
    float wgt[4];
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const float wy = (corner >> 1) ? geo.ly : 1.f - geo.ly;
      const float wx = (corner & 1) ? geo.lx : 1.f - geo.lx;
      wgt[corner] = geo.m * wy * wx * (float)((geo.flags >> corner) & 1);
    }
    if (pix >= p.npix) continue;
    for (int v = sub; v < p.nvec; v += G) {
      uint4 raw[4];
#pragma unroll
      for (int corner = 0; corner < 4; ++corner)
        raw[corner] = load_corner(p, geo.row, corner, v * V);
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        out[j] = wgt[0] * dcn_fwd::lane_f32<T>(raw[0], j) +
                 wgt[1] * dcn_fwd::lane_f32<T>(raw[1], j) +
                 wgt[2] * dcn_fwd::lane_f32<T>(raw[2], j) +
                 wgt[3] * dcn_fwd::lane_f32<T>(raw[3], j);
      store_vec(cols, (size_t)pix * 9 + k, v * V, p.C, p.vec, out);
    }
  }
}

// doffset and dmask of every (pixel, tap): the group of pixel pix reads
// the pixel's dcols rows and each tap's 4 corner vectors of x, and each
// lane sums over its channels the products dcols * x of the tap's 4
// corners (D_c, f32). The group sums them over its lanes in a fixed
// __shfl_xor_sync butterfly (every lane gets the same bits; no atomics, so
// the outputs are reproducible), and lane k % G makes tap k's outputs from
// its 4 sums: dmask, the unmasked sample, and doffset, its y and x
// derivatives times the mask (0 for an offset outside the clamp range),
//   val  = (1-ly)((1-lx) D00 + lx D01) + ly((1-lx) D10 + lx D11)
//   d/dy = (1-lx)(D10 - D00) + lx(D11 - D01)
//   d/dx = (1-ly)(D01 - D00) + ly(D11 - D10)
// with D_c = 0 for a corner outside the image: the sums over C of the
// per-channel forms, floor()'s corner pair (one-sided at an integer
// coordinate). The 27 outputs of the block's pixels go out through shared
// memory, coalesced along the pixels.
template <typename T, int G>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
dcn_col2im_coord_kernel(const SampleParams<T> p, const T* __restrict__ dcols,
                        float* __restrict__ doffset,
                        float* __restrict__ dmask) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kP = kBwdThreads / G;  // pixels per block
  constexpr int kSlots = (9 + G - 1) / G;
  __shared__ float s_out[27][kP + 1];  // dmask k, then doffset 2k, 2k+1
  const int sub = threadIdx.x % G;
  const int j = threadIdx.x / G;  // the pixel's place in the block
  const int p0 = blockIdx.x * kP;
  const int pix = p0 + j;
  Geo mine[kSlots];
  lane_geo<G>(mine, p.offset, p.mask, pix, sub, p.npix, p.H, p.W,
              p.max_offset);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const Geo geo = share_geo<G>(mine, k);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (pix < p.npix) {
      for (int v = sub; v < p.nvec; v += G) {
        const uint4 g =
            load_vec<T, true>(dcols, (size_t)pix * 9 + k, v * V, p.C, p.vec);
        uint4 raw[4];
#pragma unroll
        for (int corner = 0; corner < 4; ++corner)
          raw[corner] = load_corner(p, geo.row, corner, v * V);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float gc = dcn_fwd::lane_f32<T>(g, c);
#pragma unroll
          for (int corner = 0; corner < 4; ++corner)
            acc[corner] = fmaf(gc, dcn_fwd::lane_f32<T>(raw[corner], c),
                               acc[corner]);
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int corner = 0; corner < 4; ++corner)
        acc[corner] += __shfl_xor_sync(0xffffffffu, acc[corner], off);
    if (sub == k % G) {
      float d[4];
#pragma unroll
      for (int corner = 0; corner < 4; ++corner)
        d[corner] = (geo.flags >> corner) & 1 ? acc[corner] : 0.f;
      const float ly = geo.ly, lx = geo.lx;
      const float val = (1.f - ly) * ((1.f - lx) * d[0] + lx * d[1]) +
                        ly * ((1.f - lx) * d[2] + lx * d[3]);
      const float d_y = (1.f - lx) * (d[2] - d[0]) + lx * (d[3] - d[1]);
      const float d_x = (1.f - ly) * (d[1] - d[0]) + ly * (d[3] - d[2]);
      s_out[k][j] = val;
      s_out[9 + 2 * k][j] = geo.flags & kPassY ? geo.m * d_y : 0.f;
      s_out[10 + 2 * k][j] = geo.flags & kPassX ? geo.m * d_x : 0.f;
    }
  }
  __syncthreads();
  const int hw = p.H * p.W;
  for (int t = threadIdx.x; t < 27 * kP; t += kBwdThreads) {
    const int r = t / kP;
    const int q_pix = p0 + t % kP;
    if (q_pix >= p.npix) continue;
    const int b = q_pix / hw;
    const int q = q_pix - b * hw;
    if (r < 9)
      dmask[((size_t)b * 9 + r) * hw + q] = s_out[r][t % kP];
    else
      doffset[((size_t)b * 18 + r - 9) * hw + q] = s_out[r][t % kP];
  }
}

// Steps 1 and 3 of col2im's map, one thread per (b, k, p): for each corner
// that lands in the image with a non-zero weight, count it (kFill false),
// or write the entry {key p*9 + k, weight bits} into the slot its count
// gives (kFill true), one 8-byte store. Both instantiations decide "lands" from the same
// arithmetic, and the fill writes only while its count lasts, so no entry
// leaves its segment.
template <bool kFill>
__global__ void __launch_bounds__(kPix)
dcn_col2im_map_kernel(const float* __restrict__ offset,
                      const float* __restrict__ mask, int* __restrict__ count,
                      const int* __restrict__ ends, int2* __restrict__ entries,
                      int H, int W, float max_offset) {
  const int hw = H * W;
  const int p = blockIdx.x * kPix + threadIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  if (p >= hw) return;
  const Tap t = make_tap(offset, b, k, p, H, W, max_offset);
  float wgt[4];
  corner_weights(t, mask[((size_t)b * 9 + k) * hw + p], wgt);
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    if (t.valid[corner] == 0.f || wgt[corner] == 0.f) continue;
    const size_t bq = (size_t)b * hw + t.idx[corner];
    if (!kFill) {
      atomicAdd(count + bq, 1);
    } else {
      const int left = atomicSub(count + bq, 1);
      if (left > 0)
        entries[ends[bq] - left] = make_int2(p * 9 + k,
                                             __float_as_int(wgt[corner]));
    }
  }
}

__device__ __forceinline__ int segment_start(const int* __restrict__ ends,
                                             size_t bq) {
  return bq == 0 ? 0 : ends[bq - 1];
}

// Sorts the n <= 32 * kPer entries of one segment by key, one warp: the
// entries go into registers, kPer a lane, each key's rank is the number of
// smaller keys (the keys of a segment are distinct: a sample's 4 corners
// are 4 pixels), and each entry is written back at its rank.
template <int kPer>
__device__ __forceinline__ void warp_rank_sort(int2* __restrict__ seg, int n,
                                               int lane) {
  int2 entry[kPer];
  int rank[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = t * 32 + lane;
    entry[t] = e < n ? seg[e] : make_int2(INT_MAX, 0);
    rank[t] = 0;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    for (int src = 0; src < 32; ++src) {
      const int other = __shfl_sync(0xffffffffu, entry[u].x, src);
#pragma unroll
      for (int t = 0; t < kPer; ++t) rank[t] += other < entry[t].x;
    }
  }
  __syncwarp();  // every lane has read its entries before any is moved
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    if (t * 32 + lane < n) seg[rank[t]] = entry[t];
}

// Step 4, one warp per segment: a segment of at most kShortSeg entries is
// sorted in registers (warp_rank_sort); a longer one goes on the long list.
__global__ void __launch_bounds__(kSortWarps * 32)
dcn_col2im_sort_kernel(const int* __restrict__ ends,
                       int2* __restrict__ entries, int* __restrict__ long_q,
                       int* __restrict__ n_long, size_t n_seg) {
  const int lane = threadIdx.x & 31;
  const size_t bq = (size_t)blockIdx.x * kSortWarps + (threadIdx.x >> 5);
  if (bq >= n_seg) return;  // a whole warp
  const int start = segment_start(ends, bq);
  const int n = ends[bq] - start;
  int2* seg = entries + start;
  switch ((n + 31) / 32) {
    case 0: case 1: warp_rank_sort<1>(seg, n, lane); break;
    case 2: warp_rank_sort<2>(seg, n, lane); break;
    case 3: case 4: warp_rank_sort<4>(seg, n, lane); break;
    case 5: case 6: case 7: case 8: warp_rank_sort<8>(seg, n, lane); break;
    default:
      if (lane == 0) long_q[atomicAdd(n_long, 1)] = (int)bq;
  }
}

// Exclusive prefix sum of one int per thread over a block of kThreads
// threads (Hillis-Steele in shared memory); returns this thread's.
template <int kThreads>
__device__ int block_exclusive_scan(int v, int* s) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = tid >= off ? s[tid - off] : 0;
    __syncthreads();
    s[tid] += add;
    __syncthreads();
  }
  const int out = s[tid] - v;
  __syncthreads();
  return out;
}

// Before step 1: the B*HW counters and the long segments' number after them
// at 0.
__global__ void __launch_bounds__(256)
dcn_col2im_zero_kernel(int* __restrict__ count, size_t n) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i < n) count[i] = 0;
}

// Step 2, first pass: sums[t] = the sum of the counts of tile t (kScanTile
// pixels, one block).
__global__ void __launch_bounds__(kScanThreads)
dcn_col2im_scan_sums_kernel(const int* __restrict__ count, size_t n,
                            int* __restrict__ sums) {
  __shared__ int s[kScanThreads];
  const size_t base = (size_t)blockIdx.x * kScanTile + threadIdx.x;
  int v = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const size_t i = base + (size_t)j * kScanThreads;
    if (i < n) v += count[i];
  }
  const int before = block_exclusive_scan<kScanThreads>(v, s);
  if (threadIdx.x == kScanThreads - 1) sums[blockIdx.x] = before + v;
}

// Step 2, second pass: ends[i] = count[0] + ... + count[i]. Each block adds
// the sums of the tiles before its own, then scans its tile, kScanItems
// consecutive counts a thread.
__global__ void __launch_bounds__(kScanThreads)
dcn_col2im_scan_kernel(const int* __restrict__ count,
                       const int* __restrict__ sums, size_t n,
                       int* __restrict__ ends) {
  __shared__ int s[kScanThreads];
  __shared__ int s_carry;
  int carry = 0;
  for (unsigned t = threadIdx.x; t < blockIdx.x; t += kScanThreads)
    carry += sums[t];
  const int carry_before = block_exclusive_scan<kScanThreads>(carry, s);
  if (threadIdx.x == kScanThreads - 1) s_carry = carry_before + carry;
  __syncthreads();
  const size_t base =
      (size_t)blockIdx.x * kScanTile + (size_t)threadIdx.x * kScanItems;
  int run[kScanItems];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    total += base + j < n ? count[base + j] : 0;
    run[j] = total;
  }
  const int before = s_carry + block_exclusive_scan<kScanThreads>(total, s);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j)
    if (base + j < n) ends[base + j] = before + run[j];
}

// The weight with which entry (k, p) of pixel q's segment adds its column
// element to dx[b, :, q]: mask * wy * wx of the corner of sample (k, p)
// that is q, as corner_weights computes it.
__device__ __forceinline__ float entry_weight(
    const float* __restrict__ offset, const float* __restrict__ mask, int b,
    int k, int p, int qy, int qx, int H, int W, float max_offset) {
  const Sample s = make_sample(offset, b, k, p, H, W, max_offset);
  const float wy = qy != s.y0 ? s.ly : 1.f - s.ly;
  const float wx = qx != s.x0 ? s.lx : 1.f - s.lx;
  return mask[((size_t)b * 9 + k) * (H * W) + p] * wy * wx;
}

// Step 4 for the long segments, one block per segment at a time: each key
// sets its bit in this block's bitmap of the 9*HW keys, then each thread
// counts the set bits of its run of words and, after a block scan, writes
// them back in key order, each with its weight taken again from offset and
// mask.
__global__ void __launch_bounds__(kLongSortThreads)
dcn_col2im_sort_long_kernel(const float* __restrict__ offset,
                            const float* __restrict__ mask,
                            const int* __restrict__ ends,
                            int2* __restrict__ entries,
                            const int* __restrict__ long_q,
                            const int* __restrict__ n_long,
                            unsigned* __restrict__ bits_all, int H, int W,
                            float max_offset) {
  __shared__ int s_scan[kLongSortThreads];
  const int hw = H * W;
  const int tid = threadIdx.x;
  const int n_words = (9 * hw + 31) / 32;
  unsigned* bits = bits_all + (size_t)blockIdx.x * n_words;
  const int per = (n_words + kLongSortThreads - 1) / kLongSortThreads;
  const int w0 = min(tid * per, n_words);
  const int w1 = min(w0 + per, n_words);
  const int n = *n_long;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t bq = (size_t)long_q[i];
    const int b = (int)(bq / hw);
    const int q = (int)(bq - (size_t)b * hw);
    const int start = segment_start(ends, bq);
    const int end = ends[bq];
    for (int w = tid; w < n_words; w += kLongSortThreads) bits[w] = 0u;
    __syncthreads();
    for (int e = start + tid; e < end; e += kLongSortThreads) {
      const int key = entries[e].x;
      atomicOr(bits + (key >> 5), 1u << (key & 31));
    }
    __syncthreads();
    int set = 0;
    for (int w = w0; w < w1; ++w) set += __popc(bits[w]);
    int out = start + block_exclusive_scan<kLongSortThreads>(set, s_scan);
    for (int w = w0; w < w1; ++w) {
      for (unsigned m = bits[w]; m != 0u; m &= m - 1u) {
        const int key = w * 32 + (__ffs(m) - 1);
        entries[out++] = make_int2(
            key, __float_as_int(entry_weight(offset, mask, b, key % 9,
                                             key / 9, q / W, q % W, H, W,
                                             max_offset)));
      }
    }
    __syncthreads();
  }
}

// 4 consecutive channels, one vector load: 16 bytes of float, 8 of bf16.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

// acc += the chunks of kGroup entries at it + shift of a segment of n
// entries at seg, for it = first, first + stride, ... < n_max, walked by
// the kGroup lanes of a group (sub = the lane's place in it): each lane
// holds 4 of the slab's channels, at image + row * Cp. first, stride and
// n_max are uniform over the warp, so every lane runs the same trips.
template <typename T>
__device__ __forceinline__ void gather_entries(
    const T* __restrict__ image, const int2* __restrict__ seg, int n,
    int n_max, int first, int shift, int stride, int Cp, int sub,
    float acc[4]) {
  for (int it = first; it < n_max; it += stride) {
    const int base = it + shift;
    const int2 mine = base + sub < n ? seg[base + sub] : make_int2(0, 0);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int key = __shfl_sync(0xffffffffu, mine.x, i, kGroup);
      const float w =
          __int_as_float(__shfl_sync(0xffffffffu, mine.y, i, kGroup));
      if (base + i < n) {
        float v[4];
        load4(image + (size_t)key * Cp, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[t] = fmaf(w, v[t], acc[t]);
      }
    }
  }
}

// The gather: a block owns kGatherPix consecutive pixels q of one image and
// a slab of 32 channels; a group of kGroup lanes walks the segment of one
// pixel, each lane holding 4 of the slab's channels, so a warp walks 4
// pixels at once. The group's lanes take kGroup entries {key, weight} of
// the segment at once, then each entry is one vector load a lane, a
// coalesced read of the slab's 32 channels of row key = p*9 + k of
// dcols, all kGroup in flight together, summed in key order in f32
// registers. The block writes its 32 x kGatherPix tile of dx through
// shared memory, coalesced along q, each element once, in T; a pixel whose
// segment is longer than kShortSeg is left to
// dcn_col2im_gather_long_kernel.
template <typename T>
__global__ void __launch_bounds__(kGatherWarps * 32)
dcn_col2im_gather_kernel(const T* __restrict__ dcols,
                         const int* __restrict__ ends,
                         const int2* __restrict__ entries, T* __restrict__ dx,
                         int C, int Cp, int hw) {
  __shared__ float s_dx[32][kGatherPix + 1];
  __shared__ bool s_long[kGatherPix];
  const int sub = threadIdx.x % kGroup;
  const int j = threadIdx.x / kGroup;  // this group's pixel in the block
  const int q = blockIdx.x * kGatherPix + j;
  const int b = blockIdx.z;
  const T* image =
      dcols + (size_t)b * hw * 9 * Cp + blockIdx.y * 32 + 4 * sub;
  int start = 0;
  int n = 0;
  if (q < hw) {
    const size_t bq = (size_t)b * hw + q;
    start = segment_start(ends, bq);
    n = ends[bq] - start;
  }
  const bool is_long = n > kShortSeg;
  if (is_long) n = 0;
  int n_max = n;
  for (int o = kGroup; o < 32; o <<= 1)
    n_max = max(n_max, __shfl_xor_sync(0xffffffffu, n_max, o));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  gather_entries(image, entries + start, n, n_max, 0, 0, kGroup, Cp, sub,
                 acc);
#pragma unroll
  for (int t = 0; t < 4; ++t) s_dx[4 * sub + t][j] = acc[t];
  if (sub == 0) s_long[j] = is_long;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * kGatherPix; i += kGatherWarps * 32) {
    const int cc = blockIdx.y * 32 + i / kGatherPix;
    const int qq = blockIdx.x * kGatherPix + i % kGatherPix;
    if (cc < C && qq < hw && !s_long[i % kGatherPix])
      store_f32(dx + ((size_t)b * C + cc) * hw + qq,
                s_dx[i / kGatherPix][i % kGatherPix]);
  }
}

// The long segments, one block per (segment, slab) at a time: its
// kGatherWarps * 32 / kGroup groups take the segment's chunks of kGroup
// entries in turn, and their sums are added in group order.
template <typename T>
__global__ void __launch_bounds__(kGatherWarps * 32)
dcn_col2im_gather_long_kernel(const T* __restrict__ dcols,
                              const int* __restrict__ ends,
                              const int2* __restrict__ entries,
                              const int* __restrict__ long_q,
                              const int* __restrict__ n_long,
                              T* __restrict__ dx, int C, int Cp, int hw) {
  constexpr int kGroups = kGatherWarps * 32 / kGroup;
  __shared__ float s_acc[kGroups][33];
  const int sub = threadIdx.x % kGroup;
  const int g = threadIdx.x / kGroup;
  const int n_seg = *n_long;
  for (int i = blockIdx.x; i < n_seg; i += gridDim.x) {
    const size_t bq = (size_t)long_q[i];
    const int b = (int)(bq / hw);
    const int q = (int)(bq - (size_t)b * hw);
    const int start = segment_start(ends, bq);
    const int n = ends[bq] - start;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    // the groups of a warp take consecutive chunks of each stride
    constexpr int kPerWarp = 32 / kGroup;
    gather_entries(
        dcols + (size_t)b * hw * 9 * Cp + blockIdx.y * 32 + 4 * sub,
        entries + start, n, n, (g - g % kPerWarp) * kGroup,
        (g % kPerWarp) * kGroup, kGroups * kGroup, Cp, sub, acc);
#pragma unroll
    for (int t = 0; t < 4; ++t) s_acc[g][4 * sub + t] = acc[t];
    __syncthreads();
    if (threadIdx.x < 32) {
      float sum = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) sum += s_acc[gg][threadIdx.x];
      const int cc = blockIdx.y * 32 + threadIdx.x;
      if (cc < C) store_f32(dx + ((size_t)b * C + cc) * hw + q, sum);
    }
    __syncthreads();
  }
}

bool bad_shape(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535;
}

// The map's keys and slots are int32: 36 entries a pixel must fit.
bool bad_map(int B, int H, int W) {
  return bad_shape(B, 1, H, W) ||
         (long long)kMaxEntriesPerPixel * B * H * W >= (1LL << 31);
}

// B*H*W pixels index x's rows and 9 column rows each as int
bool bad_pixels(int B, int C, int H, int W) {
  return bad_shape(B, C, H, W) || (long long)9 * B * H * W >= (1LL << 31);
}

template <typename T>
SampleParams<T> sample_params(const T* x, const float* offset,
                              const float* mask, int B, int C, int H, int W,
                              int vec, float max_offset) {
  constexpr int V = 16 / sizeof(T);
  return {x, offset, mask, C, H, W, B * H * W, (C + V - 1) / V, vec,
          max_offset};
}

// The group of lanes a pixel gets: C / V vectors rounded up to 8, 16 or 32.
template <typename T>
int group_lanes(int C) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = (C + V - 1) / V;
  return nvec <= 8 ? 8 : nvec <= 16 ? 16 : 32;
}

// Blocks of im2col and coord for npix pixels, one a group of G lanes.
unsigned bwd_grid(int npix, int G) {
  const int per_block = kBwdThreads / G;
  return (unsigned)((npix + per_block - 1) / per_block);
}

template <typename T>
int im2col(const T* x, const float* offset, const float* mask, T* cols,
           int B, int C, int H, int W, int vec, float max_offset,
           void* stream) {
  if (bad_pixels(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const SampleParams<T> p =
      sample_params(x, offset, mask, B, C, H, W, vec, max_offset);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group_lanes<T>(C)) {
    case 8: dcn_im2col_kernel<T, 8>
        <<<bwd_grid(p.npix, 8), kBwdThreads, 0, s>>>(p, cols);
      break;
    case 16: dcn_im2col_kernel<T, 16>
        <<<bwd_grid(p.npix, 16), kBwdThreads, 0, s>>>(p, cols);
      break;
    default: dcn_im2col_kernel<T, 32>
        <<<bwd_grid(p.npix, 32), kBwdThreads, 0, s>>>(p, cols);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int col2im_coord(const T* dcols, const T* x, const float* offset,
                 const float* mask, float* doffset, float* dmask, int B,
                 int C, int H, int W, int vec, float max_offset,
                 void* stream) {
  if (bad_pixels(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const SampleParams<T> p =
      sample_params(x, offset, mask, B, C, H, W, vec, max_offset);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group_lanes<T>(C)) {
    case 8: dcn_col2im_coord_kernel<T, 8>
        <<<bwd_grid(p.npix, 8), kBwdThreads, 0, s>>>(p, dcols, doffset, dmask);
      break;
    case 16: dcn_col2im_coord_kernel<T, 16>
        <<<bwd_grid(p.npix, 16), kBwdThreads, 0, s>>>(p, dcols, doffset,
                                                      dmask);
      break;
    default: dcn_col2im_coord_kernel<T, 32>
        <<<bwd_grid(p.npix, 32), kBwdThreads, 0, s>>>(p, dcols, doffset,
                                                      dmask);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int col2im(const T* dcols, const int* count, const int* ends,
           const int2* entries, const int* long_q, T* dx, int B, int C,
           int H, int W, int long_blocks, void* stream) {
  if (bad_shape(B, C, H, W) || bad_map(B, H, W) || long_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W;
  const int cp = (C + 31) / 32 * 32;
  dcn_col2im_gather_kernel<T>
      <<<dim3((hw + kGatherPix - 1) / kGatherPix, cp / 32, B),
         kGatherWarps * 32, 0, s>>>(dcols, ends, entries, dx, C, cp, hw);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_gather_long_kernel<T>
      <<<dim3(long_blocks, cp / 32), kGatherWarps * 32, 0, s>>>(
          dcols, ends, entries, long_q, count + (size_t)B * hw, dx, C, cp,
          hw);
  return (int)cudaGetLastError();
}

const __nv_bfloat16* bf16(const void* p) {
  return static_cast<const __nv_bfloat16*>(p);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success) after each of its launches. The bf16 ones take bf16 x, cols,
// dcols and dx as void pointers. x is channels-last (B, H, W, C); cols and
// dcols are (B*H*W, 9, C); vec = 1 where C is a multiple of the 16-byte
// vector (4 float32, 8 bf16) and x, cols and dcols are 16-byte aligned.

extern "C" int cfd_dcn_im2col(const float* x, const float* offset,
                              const float* mask, float* cols, int B, int C,
                              int H, int W, int vec, float max_offset,
                              void* stream) {
  return im2col(x, offset, mask, cols, B, C, H, W, vec, max_offset, stream);
}

// col2im's map, steps 1 and 2: count (B*HW + 1 int32) gets the number of
// entries of each pixel and a 0 after them, ends (B*HW int32) their
// inclusive prefix sum; sums (ceil(B*HW / 4096) int32) is the scan's
// scratch.
extern "C" int cfd_dcn_col2im_count(const float* offset, const float* mask,
                                    int* count, int* ends, int* sums, int B,
                                    int H, int W, float max_offset,
                                    void* stream) {
  if (bad_map(B, H, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n_seg = (size_t)B * H * W;
  dcn_col2im_zero_kernel<<<(unsigned)((n_seg + 256) / 256), 256, 0, s>>>(
      count, n_seg + 1);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_map_kernel<false>
      <<<dim3((H * W + kPix - 1) / kPix, 9, B), kPix, 0, s>>>(
          offset, mask, count, nullptr, nullptr, H, W, max_offset);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const unsigned tiles = (unsigned)((n_seg + kScanTile - 1) / kScanTile);
  dcn_col2im_scan_sums_kernel<<<tiles, kScanThreads, 0, s>>>(count, n_seg,
                                                              sums);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_scan_kernel<<<tiles, kScanThreads, 0, s>>>(count, sums, n_seg,
                                                         ends);
  return (int)cudaGetLastError();
}

// Steps 3 and 4, after ends = the inclusive prefix sum of count[0 .. B*HW):
// fills entries (36*B*HW {key, weight bits}) segment by segment, leaving
// count[0 .. B*HW) at 0, and sorts each segment; the long segments' pixels
// go to long_q, their number to count[B*HW], and bits (long_blocks *
// ceil(9*HW/32) int32) is the long sort's scratch.
extern "C" int cfd_dcn_col2im_fill(const float* offset, const float* mask,
                                   int* count, const int* ends,
                                   int2* entries, int* long_q, unsigned* bits,
                                   int B, int H, int W, int long_blocks,
                                   float max_offset, void* stream) {
  if (bad_map(B, H, W) || long_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W;
  const size_t n_seg = (size_t)B * hw;
  dcn_col2im_map_kernel<true>
      <<<dim3((hw + kPix - 1) / kPix, 9, B), kPix, 0, s>>>(
          offset, mask, count, ends, entries, H, W, max_offset);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_sort_kernel<<<(unsigned)((n_seg + kSortWarps - 1) /
                                      kSortWarps),
                           kSortWarps * 32, 0, s>>>(ends, entries, long_q,
                                                    count + n_seg, n_seg);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_sort_long_kernel<<<long_blocks, kLongSortThreads, 0, s>>>(
      offset, mask, ends, entries, long_q, count + n_seg, bits, H, W,
      max_offset);
  return (int)cudaGetLastError();
}

// The gathers, after the map: dcols (B, HW, 9, Cp), Cp = C rounded up to
// 32 (the padding is read and never stored), dx (B, C, H, W) gets every
// element written.
extern "C" int cfd_dcn_col2im(const float* dcols, const int* count,
                              const int* ends, const int2* entries,
                              const int* long_q, float* dx, int B, int C,
                              int H, int W, int long_blocks, void* stream) {
  return col2im(dcols, count, ends, entries, long_q, dx, B, C, H, W,
                long_blocks, stream);
}

extern "C" int cfd_dcn_col2im_coord(const float* dcols, const float* x,
                                    const float* offset, const float* mask,
                                    float* doffset, float* dmask, int B,
                                    int C, int H, int W, int vec,
                                    float max_offset, void* stream) {
  return col2im_coord(dcols, x, offset, mask, doffset, dmask, B, C, H, W,
                      vec, max_offset, stream);
}

extern "C" int cfd_dcn_im2col_bf16(const void* x, const float* offset,
                                   const float* mask, void* cols, int B,
                                   int C, int H, int W, int vec,
                                   float max_offset, void* stream) {
  return im2col(bf16(x), offset, mask, static_cast<__nv_bfloat16*>(cols), B,
                C, H, W, vec, max_offset, stream);
}

extern "C" int cfd_dcn_col2im_bf16(const void* dcols, const int* count,
                                   const int* ends, const int2* entries,
                                   const int* long_q, void* dx, int B, int C,
                                   int H, int W, int long_blocks,
                                   void* stream) {
  return col2im(bf16(dcols), count, ends, entries, long_q,
                static_cast<__nv_bfloat16*>(dx), B, C, H, W, long_blocks,
                stream);
}

extern "C" int cfd_dcn_col2im_coord_bf16(const void* dcols, const void* x,
                                         const float* offset,
                                         const float* mask, float* doffset,
                                         float* dmask, int B, int C, int H,
                                         int W, int vec, float max_offset,
                                         void* stream) {
  return col2im_coord(bf16(dcols), bf16(x), offset, mask, doffset, dmask, B,
                      C, H, W, vec, max_offset, stream);
}
