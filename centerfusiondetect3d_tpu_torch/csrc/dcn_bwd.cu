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
//   dx      = the transpose of the sampling, applied to dcols  (dcn_col2im)
//   doffset, dmask = reductions over C of dcols           (dcn_col2im_coord)
//
// and this file holds the kernels around the two GEMMs, each templated on
// the storage type T of x, cols and dcols (float or __nv_bfloat16); every
// sum and product is f32 in both:
//
// dcn_im2col: cols from the saved x, offset and mask (the forward stays fused
//   and never writes them). One thread per (b, k, pixel) and 16 channels:
//   the tap's corner indices and mask-folded weights are computed once and
//   reused for the 16 gathers; the writes are coalesced along the pixel. In
//   bf16 each f32 column value is rounded once, as dcn_fwd_bf16.cu rounds the
//   taps it contracts (the same products in the same order).
// dcn_col2im: dx, as a gather through an inverse sampling map. This DCN has
//   one deformable group: offset and mask are shared by all C channels, so
//   where column element (c*9+k, p) lands in dx, and with what weight
//   mask * wy * wx, does not depend on c. The map has one entry per
//   (b, k, p, corner) that lands in the image with a non-zero weight, at
//   most 36*B*HW entries, C times fewer than the scatter of one f32 atomic
//   per (channel, entry) that this kernel replaced (671 M atomics at the
//   largest node at the training microbatch, bound by the L2's atomic
//   rate). Four steps build it:
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
//      in the transposed columns below, so the gather does no division)
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
//   Then the gather reads dcols by entry, and an entry's p is data
//   dependent: in dcols' layout neighbouring pixels q read scattered p, one
//   32-byte sector for each 4 bytes used. So
//   dcn_col2im_transpose_kernel first copies dcols to a (B, HW, 9, Cp)
//   scratch (Cp = C rounded up to 32) through shared-memory tiles,
//   coalesced on both sides, and dcn_col2im_gather_kernel<T> gives a group
//   of 8 lanes to each (q, 32 channels), 4 channels a lane: the group takes
//   8 entries of the segment at once, then each entry is one vector load a
//   lane (a coalesced read of the 32 channels), 8 in flight, summed in key
//   order in f32 registers; a warp walks 4 pixels at once, so that 4 of the
//   dependent chains (segment end, entries, channels) are in flight. A
//   segment longer than kShortSeg is summed by
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
// What bounds them: all of them do a few flops per element they move
// (im2col ~8 per column written, col2im ~8 per column read, coord ~14 per
// column read) against the card's fp32 balance of 20 flops per byte, so they
// are bound by bytes: the 9C x HW columns written once by im2col and read
// once by each of col2im and coord dominate (half the bytes in bf16), with
// the gathers of x served from L1/L2. col2im's own bytes are dcols read
// once, dx written once and offset and mask read once; its design adds
// traffic beside them: the transpose writes and the gather reads the
// columns once more (each entry's 32 channels are read once per entry,
// about 4 times per column element, mostly from L2), and the map takes
// 8 bytes per entry written by the fill, read and written by the sort and
// read by the gather (about 36 entries per pixel, against 9C column
// elements per pixel: 8/C of the columns' f32 bytes) and a count and a
// segment end per pixel. The design
// keeps every access to the columns coalesced and pays the tap geometry
// once per 16 channels (im2col), per 32 channels and entry (col2im's
// gather) or per pixel (coord). The GEMMs go through torch.matmul
// (fp32 with TF32 off, or bf16 on the tensor cores); fusing them with these
// kernels so that the columns never reach device memory, wgmma and TMA are
// the next steps.
//
// Layouts: x (B, C, H, W); offset (B, 18, H, W) f32 with offset[2k] = dy_k
// and offset[2k+1] = dx_k, taps k = 3i + j in row-major order; mask
// (B, 9, H, W) f32, already sigmoided; cols and dcols hold row c*9 + k (the
// row order of weight.reshape(O, 9C)) of image b at pixel p at
// b * stride_b + row * stride_row + p: the entry points take the two strides,
// the pixels are contiguous. The wrappers (ops/dcn.py) write the columns
// (9C, B, HW), so that each GEMM is one product over the B*HW axis; dx
// (B, C, H, W), every element written by col2im; doffset (B, 18, H, W) f32;
// dmask (B, 9, H, W) f32. col2im's scratch, allocated by the wrapper: the
// transposed columns dcols_t (B, HW, 9, Cp) in T, and the map, int32:
// count (B*HW + 1, zeroed; the last element counts the long segments),
// ends (B*HW), entries (36*B*HW pairs {key, f32 weight bits}, the first
// ends[B*HW-1] used), long_q (B*HW) and bits (long_blocks * ceil(9*HW /
// 32)). Every other tensor is contiguous in that layout, all on one
// device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kPix = 128;         // pixels per block (im2col, the map)
constexpr int kChanPerThread = 16;  // channels per thread (im2col)
constexpr int kCoordPix = 32;     // pixels per block (coord)
constexpr int kCoordLanes = 8;    // channel lanes per block (coord)
constexpr int kTile = 32;         // channels and pixels per tile (transpose)
constexpr int kTileRows = 8;      // rows of threads per tile (transpose)
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

// dcols (row c*9 + k of image b at pixel p, see Layouts) to dcols_t
// (B, HW, 9, Cp): the channels of one (b, p, k) contiguous, for the gather,
// Cp = C rounded up to 32 (the padding is never written, and the gather's
// sums over it are never stored).
// A block moves a tile of kTile channels x kTile pixels of one (b, k)
// through shared memory: reads coalesced along p, writes along c. Bits is a
// type of T's size: the transpose moves values without arithmetic.
template <typename Bits>
__global__ void __launch_bounds__(kTile * kTileRows)
dcn_col2im_transpose_kernel(const Bits* __restrict__ dcols,
                            Bits* __restrict__ dcols_t, Columns layout,
                            int C, int Cp, int hw) {
  __shared__ Bits tile[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int p0 = blockIdx.x * kTile;
  const int k = blockIdx.y % 9;
  const int c0 = (blockIdx.y / 9) * kTile;
  const int b = blockIdx.z;
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int c = c0 + r;
    const int p = p0 + tx;
    if (c < C && p < hw) tile[r][tx] = dcols[layout.at(b, c * 9 + k, p)];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int p = p0 + r;
    const int c = c0 + tx;
    if (c < C && p < hw)
      dcols_t[(((size_t)b * hw + p) * 9 + k) * Cp + c] = tile[tx][r];
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
// dcols_t, all kGroup in flight together, summed in key order in f32
// registers. The block writes its 32 x kGatherPix tile of dx through
// shared memory, coalesced along q, each element once, in T; a pixel whose
// segment is longer than kShortSeg is left to
// dcn_col2im_gather_long_kernel.
template <typename T>
__global__ void __launch_bounds__(kGatherWarps * 32)
dcn_col2im_gather_kernel(const T* __restrict__ dcols_t,
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
      dcols_t + (size_t)b * hw * 9 * Cp + blockIdx.y * 32 + 4 * sub;
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
dcn_col2im_gather_long_kernel(const T* __restrict__ dcols_t,
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
        dcols_t + (size_t)b * hw * 9 * Cp + blockIdx.y * 32 + 4 * sub,
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

bool bad_shape(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535;
}

// The map's keys and slots are int32: 36 entries a pixel must fit.
bool bad_map(int B, int H, int W) {
  return bad_shape(B, 1, H, W) ||
         (long long)kMaxEntriesPerPixel * B * H * W >= (1LL << 31);
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

// Bits of T's size, for the transpose.
template <typename T> struct BitsOf { using type = unsigned int; };
template <> struct BitsOf<__nv_bfloat16> { using type = unsigned short; };

template <typename T>
int col2im(const T* dcols, const int* count, const int* ends,
           const int2* entries, const int* long_q, T* dcols_t, T* dx,
           Columns layout, int B, int C, int H, int W, int long_blocks,
           void* stream) {
  if (bad_shape(B, C, H, W) || bad_map(B, H, W) || long_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  using Bits = typename BitsOf<T>::type;
  static_assert(sizeof(Bits) == sizeof(T), "transpose bits");
  const cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W;
  const int cp = (C + 31) / 32 * 32;
  dcn_col2im_transpose_kernel<Bits>
      <<<dim3((hw + kTile - 1) / kTile, 9 * ((C + kTile - 1) / kTile), B),
         dim3(kTile, kTileRows), 0, s>>>(
          reinterpret_cast<const Bits*>(dcols),
          reinterpret_cast<Bits*>(dcols_t), layout, C, cp, hw);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dcn_col2im_gather_kernel<T>
      <<<dim3((hw + kGatherPix - 1) / kGatherPix, cp / 32, B),
         kGatherWarps * 32, 0, s>>>(dcols_t, ends, entries, dx, C, cp, hw);
  const int err2 = (int)cudaGetLastError();
  if (err2 != 0) return err2;
  dcn_col2im_gather_long_kernel<T>
      <<<dim3(long_blocks, cp / 32), kGatherWarps * 32, 0, s>>>(
          dcols_t, ends, entries, long_q, count + (size_t)B * hw, dx, C, cp,
          hw);
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
// success) after each of its launches. The bf16 ones take bf16 x, cols,
// dcols and dx as void pointers. stride_b and stride_row place the rows of
// cols or dcols (see Layouts).

extern "C" int cfd_dcn_im2col(const float* x, const float* offset,
                              const float* mask, float* cols, int B, int C,
                              int H, int W, long long stride_b,
                              long long stride_row, float max_offset,
                              void* stream) {
  return im2col(x, offset, mask, cols, {(size_t)stride_b, (size_t)stride_row},
                B, C, H, W, max_offset, stream);
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

// The transpose and the gathers, after the map: dcols_t (B, HW, 9, Cp),
// Cp = C rounded up to 32, is their scratch, dx (B, C, H, W) gets every
// element written.
extern "C" int cfd_dcn_col2im(const float* dcols, const int* count,
                              const int* ends, const int2* entries,
                              const int* long_q, float* dcols_t, float* dx,
                              int B, int C, int H, int W, int long_blocks,
                              long long stride_b, long long stride_row,
                              void* stream) {
  return col2im(dcols, count, ends, entries, long_q, dcols_t, dx,
                {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                long_blocks, stream);
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

extern "C" int cfd_dcn_col2im_bf16(const void* dcols, const int* count,
                                   const int* ends, const int2* entries,
                                   const int* long_q, void* dcols_t, void* dx,
                                   int B, int C, int H, int W,
                                   int long_blocks, long long stride_b,
                                   long long stride_row, void* stream) {
  return col2im(bf16(dcols), count, ends, entries, long_q,
                static_cast<__nv_bfloat16*>(dcols_t),
                static_cast<__nv_bfloat16*>(dx),
                {(size_t)stride_b, (size_t)stride_row}, B, C, H, W,
                long_blocks, stream);
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
