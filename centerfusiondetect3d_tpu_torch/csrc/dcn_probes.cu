// The DCN probe kernels: the toolchain probes of the TPU rounds, in CUDA.
//
// Replaces the kernel bodies of scripts/probe_dcn_bisect.py (P1: k1 :62,
// k2 :71, k3 :77, k4 :93, k5 :120), scripts/probe_dcn_bisect2.py (P2: ka
// :64, kb :80, kc :95, kd :110, ke :131), scripts/probe_dcn_bisect3.py (P3:
// kf :97, kg :117) and scripts/probe_mosaic.py (P5: p1 :45, p2 :68, p3 :98,
// p4 :122). Each isolated one ingredient of the clamped shifted-window DCN
// kernel (K1, centerfusiondetect3d_tpu/ops/pallas_dcn.py:117) for the TPU
// compiler. Here each probe is one entry point with its own launch count
// (ops/probes.py), built from these kernels:
//   window_sum_kernel   k1, k3, kc, ka: unweighted window sums of a tile
//   row_window_kernel   p1, p2: P5's windows, summed over a run of rows
//   broadcast_kernel    k2: the offset field's dy, broadcast to O
//   shift_if_max_kernel p3: a whole-array min/max
//   hat_sampler_kernel  kb, k4 (= kd), ke: the hat-weighted sampler of
//                       channel 0
//   hat_cols_kernel     kf (= kg): the hat-weighted sampler of every channel
//   hat_tap_kernel      k5: the hat-weighted tap of every channel,
//                       contracted with bf16 taps on the tensor cores
//   contract_kernel     p4: a scaled bf16 tap in shared memory, contracted
//                       with bf16 taps on the tensor cores
// ops/probes.py states what each probe computes; its plain versions are
// the reference these kernels are held against.
//
// Layout of the tile probes (P1-P3), as the scripts have it: x bf16
// (B, HP, WP, C), HP = n_rb*BR + 2*pad, WP = W + 2*pad; off f32
// (B, 18, n_rb*BR, W) with dy in channel 4 and dx in channel 5; mask f32
// (B, 9, n_rb*BR, W); w bf16 (9, C, O); out f32 (B, n_rb*BR, W, O), or C
// channels for kf and kg. A thread block of the sampling probes is one
// (b, rb) tile of BR x W pixels, the Pallas grid's unit: the tile's loop
// bounds come from the min and max of its clipped dy and dx, reduced in
// shared memory first; then threads run over (pixel, channel) and sum in
// f32 registers in the scripts' order (gy outer, gx inner), with the
// products and sums rounded where the scripts round them (no fused
// multiply-add), so the plain version and the kernel differ only where a
// sum runs in another order. The wrapper checks that every window lies
// inside x.
//
// What bounds them: at the scripts' shapes a probe moves about 100 KB and
// does at most a few MFLOP, well under a microsecond of the card's memory
// or arithmetic; the launch itself (a few microseconds) bounds every one.
// So most tile probes keep the plainest correct design: one block per
// tile, 256 threads, no staging beyond the tile bounds. Where one block a
// tile put the work through 4 of 132 SMs, the kernel runs over the output
// instead: P5's windows (p1, p2: row_window_kernel), k2's broadcast
// (broadcast_kernel), k5's tap and contraction (hat_tap_kernel, a block
// per 16 pixels of a tile), kf's sampler (hat_cols_kernel) and p4's
// contraction (contract_kernel, a block per 16 pixels and 32 columns).

#include <algorithm>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kClip = 8.f;        // the probes clip dy and dx to +-8
constexpr int kOpen = 1 << 20;      // a loop range that is not cut
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block can use

__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float clip(float v) {
  return fminf(fmaxf(v, -kClip), kClip);
}
__device__ __forceinline__ float hat(float v) {
  return fmaxf(0.f, 1.f - fabsf(v));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// min and max of (lo, hi) over the block; every thread gets both. The
// block's size is a multiple of 32.
__device__ void block_min_max(float& lo, float& hi) {
  __shared__ float s_lo[32], s_hi[32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    lo = fminf(lo, s_lo[i]);
    hi = fmaxf(hi, s_hi[i]);
  }
  __syncthreads();  // s_lo and s_hi may be written again
}

// The loop bounds of tile (b, rb), the scripts' bounds(): ylo =
// floor(min dy), yhi = floor(max dy) + 1 over the tile's br x w pixels of
// the clipped offset field (B, 18, h, w); xlo, xhi likewise from dx.
struct Bounds {
  int ylo, yhi, xlo, xhi;
};

__device__ Bounds tile_bounds(const float* __restrict__ off, int h, int w,
                              int br, int b, int rb) {
  const size_t plane = (size_t)h * w;
  const float* dy = off + ((size_t)b * 18 + 4) * plane + (size_t)rb * br * w;
  const float* dx = dy + plane;
  float ymin = CUDART_INF_F, ymax = -CUDART_INF_F;
  float xmin = CUDART_INF_F, xmax = -CUDART_INF_F;
  for (int i = threadIdx.x; i < br * w; i += blockDim.x) {
    const float vy = clip(dy[i]), vx = clip(dx[i]);
    ymin = fminf(ymin, vy);
    ymax = fmaxf(ymax, vy);
    xmin = fminf(xmin, vx);
    xmax = fmaxf(xmax, vx);
  }
  block_min_max(ymin, ymax);
  block_min_max(xmin, xmax);
  return {(int)floorf(ymin), (int)floorf(ymax) + 1, (int)floorf(xmin),
          (int)floorf(xmax) + 1};
}

// The tile grid of a P1-P3 probe launch
struct Tiles {
  int batch, n_rb, br, w, c, o, pad;
  __host__ __device__ int h() const { return n_rb * br; }
  __host__ __device__ int hp() const { return h() + 2 * pad; }
  __host__ __device__ int wp() const { return w + 2 * pad; }
  __host__ __device__ int pixels() const { return br * w; }
  // offset of pixel (r, c) of tile (b, rb) in a (B, h, w, n) array
  __device__ size_t at(int b, int rb, int r, int c, int n) const {
    return (((size_t)b * h() + rb * br + r) * w + c) * n;
  }
};

// ------------------------------------------------------- window sums

enum class Reduce {
  kSumChannels,  // k1: the channel sum, rounded to bf16, broadcast
  kChannel0,     // k3, kc: channel 0, broadcast
  kCount,        // ka: 1 per (gy, gx), broadcast
};
enum class Loop { kFixed, kTileY, kTileYX };

// Tile (b, rb) of br x w pixels sums, over gy and gx, the windows
// x[b, row0 + rb*row_step + gy + r, col0 + gx + c, :] of an x of
// (batch, xh, xw, xc). Fixed loops run gy = lo ... hi, gx = 0; tile loops
// take the tile's bounds from off (batch, 18, off_h, w).
struct Windows {
  int batch, n_rb, br, w;
  int xh, xw, xc;
  int nc;  // output channels
  int row0, row_step, col0;
  int lo, hi;
};

template <Reduce R, Loop L>
__global__ void __launch_bounds__(kThreads)
window_sum_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                  float* __restrict__ out, Windows g) {
  const int b = blockIdx.x / g.n_rb, rb = blockIdx.x % g.n_rb;
  int ylo = g.lo, yhi = g.hi, xlo = 0, xhi = 0;
  if (L != Loop::kFixed) {
    const Bounds bd = tile_bounds(off, g.n_rb * g.br, g.w, g.br, b, rb);
    ylo = bd.ylo;
    yhi = bd.yhi;
    if (L == Loop::kTileYX) {
      xlo = bd.xlo;
      xhi = bd.xhi;
    }
  }
  const bf16* xb =
      R == Reduce::kCount ? nullptr : x + (size_t)b * g.xh * g.xw * g.xc;
  for (int p = threadIdx.x; p < g.br * g.w; p += blockDim.x) {
    const int r = p / g.w, c = p % g.w;
    float acc = 0.f;
    for (int gy = ylo; gy <= yhi; ++gy) {
      for (int gx = xlo; gx <= xhi; ++gx) {
        if (R == Reduce::kCount) {
          acc += 1.f;
          continue;
        }
        const bf16* px = xb + ((size_t)(g.row0 + rb * g.row_step + gy + r)
                               * g.xw + (g.col0 + gx + c)) * g.xc;
        if (R == Reduce::kSumChannels) {
          float s = 0.f;
          for (int k = 0; k < g.xc; ++k) s += load(px + k);
          acc += s;
        } else {
          acc += load(px);
        }
      }
    }
    if (R == Reduce::kSumChannels) acc = round_bf16(acc);
    float* o = out + (((size_t)b * g.n_rb * g.br + rb * g.br + r) * g.w + c)
                         * g.nc;
    for (int j = 0; j < g.nc; ++j) o[j] = acc;
  }
}

// ------------------------------------------------------- P5's windows

// out[r, :span] = the sum over i = lo ... hi-1, in that order, of the span
// floats of x that start col0 floats into row i + r (rows row_stride
// floats apart): p2 sums its hi - lo windows from zero, as the script's
// fori_loop does; p1 (kCopy, hi = lo + 1) copies its one window, with
// nothing added to it (0 + -0.0 would be +0.0). Each window row is
// contiguous in x, so the grid runs over the output: blockIdx.y is the
// output row, blockIdx.x a chunk of kRowThreads vectors of its span, one
// vector a thread; the rows of a thread's sum lie row_stride floats apart.
// No index is divided at run time. V is float4 where the wrapper found
// every window row of x and out 16-byte aligned and whole in float4s (the
// entry checks it again), else float. p1's 8 x 16 x 128 window is 4,096
// float4s: 32 blocks of 128 threads, one 16-byte load and store each.
constexpr int kRowThreads = 128;

struct RowWindows {
  int row_stride, col0, span, lo, hi;  // in floats
  int vectors;                         // span in V
};

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename V, bool kCopy>
__global__ void __launch_bounds__(kRowThreads)
row_window_kernel(const float* __restrict__ x, float* __restrict__ out,
                  RowWindows g) {
  const int v = blockIdx.x * kRowThreads + threadIdx.x;
  if (v >= g.vectors) return;
  const int r = blockIdx.y;
  constexpr int kWidth = sizeof(V) / sizeof(float);
  const size_t step = (size_t)g.row_stride / kWidth;  // rows, in V
  const V* src = reinterpret_cast<const V*>(x + g.col0) + v;
  V acc = V{};
  if (kCopy) {
    acc = __ldg(src + (size_t)(g.lo + r) * step);
  } else {
    for (int i = g.lo; i < g.hi; ++i)
      acc = vadd(acc, __ldg(src + (size_t)(i + r) * step));
  }
  reinterpret_cast<V*>(out + (size_t)r * g.span)[v] = acc;
}

// ------------------------------------------------------- k2's broadcast

// out[b, p, :] = dy[b, p] (offset channel 4, not clipped) for the hw
// pixels p of each batch b. The grid runs over the output, not over tiles:
// blockIdx.y is b, and a block of (vectors of O on x, pixels on y)
// threads strides over the batch's pixels, so a thread reads its pixel's
// dy once and stores it broadcast as V: float4 where the wrapper found O
// whole in float4s and out on 16 bytes (the entry checks it again), else
// float. No index is divided at run time. At the scripts' geometry (O =
// 16, 384 pixels a batch): blocks of 4 x 64 threads, 12 blocks, one
// 16-byte store a thread.
__device__ __forceinline__ void splat(float v, float& o) { o = v; }
__device__ __forceinline__ void splat(float v, float4& o) {
  o = make_float4(v, v, v, v);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
broadcast_kernel(const float* __restrict__ off, float* __restrict__ out,
                 int hw, int vectors) {
  const int b = blockIdx.y;
  const float* dy = off + ((size_t)b * 18 + 4) * hw;
  V* o = reinterpret_cast<V*>(out) + (size_t)b * hw * vectors;
  for (int p = blockIdx.x * blockDim.y + threadIdx.y; p < hw;
       p += gridDim.x * blockDim.y) {
    V v;
    splat(__ldg(dy + p), v);
    for (int j = threadIdx.x; j < vectors; j += blockDim.x)
      o[(size_t)p * vectors + j] = v;
  }
}

// ------------------------------------------------------- p3's field read

// x + trunc(min x) where max x > 0.5, else 0; one block
__global__ void __launch_bounds__(kThreads)
shift_if_max_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int n) {
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    lo = fminf(lo, in[i]);
    hi = fmaxf(hi, in[i]);
  }
  block_min_max(lo, hi);
  const float shift = (float)(int)lo;  // the int32 cast: toward zero
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = hi > 0.5f ? in[i] + shift : 0.f;
}

// ------------------------------------------------- hat-weighted sampler

// The sum over gy in [ylo, yhi] and gx in [xlo, xhi] of hat(gy - dy) *
// hat(gx - dx) * x[b, base + gy + pad + r, pad + gx + c, ch] for one pixel
// and channel, base = rb*BR with the row-block term and 0 without; without
// the x loop (kb) the term is hat(gy - dy) * x[..., pad + c, ch]. xb is
// x[b].
template <bool kRowBlock, bool kXLoop>
__device__ float hat_sum(const bf16* __restrict__ xb, const Tiles& t, int rb,
                         int r, int c, int ch, float dy, float dx, int ylo,
                         int yhi, int xlo, int xhi) {
  const int base = kRowBlock ? rb * t.br : 0;
  float acc = 0.f;
  for (int gy = ylo; gy <= yhi; ++gy) {
    const float wy = hat((float)gy - dy);
    const bf16* row = xb + (size_t)(base + gy + t.pad + r) * t.wp() * t.c;
    if (!kXLoop) {
      acc = __fadd_rn(acc, __fmul_rn(wy, load(row + (t.pad + c) * t.c + ch)));
      continue;
    }
    for (int gx = xlo; gx <= xhi; ++gx) {
      const float wyx = __fmul_rn(wy, hat((float)gx - dx));
      const int col = t.pad + gx + c;
      acc = __fadd_rn(acc, __fmul_rn(wyx, load(row + (size_t)col * t.c + ch)));
    }
  }
  return acc;
}

// kb, k4/kd, ke: the tile's bounds, gy cut to [kYMin, kYMax]; channel 0
// broadcast to O
template <bool kRowBlock, bool kXLoop, int kYMin, int kYMax>
__global__ void __launch_bounds__(kThreads)
hat_sampler_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                   float* __restrict__ out, Tiles t) {
  const int b = blockIdx.x / t.n_rb, rb = blockIdx.x % t.n_rb;
  const Bounds bd = tile_bounds(off, t.h(), t.w, t.br, b, rb);
  const int ylo = max(bd.ylo, kYMin), yhi = min(bd.yhi, kYMax);
  const bf16* xb = x + (size_t)b * t.hp() * t.wp() * t.c;
  const size_t plane = (size_t)t.h() * t.w;
  for (int p = threadIdx.x; p < t.pixels(); p += blockDim.x) {
    const int r = p / t.w, c = p % t.w;
    const size_t pix = (size_t)(rb * t.br + r) * t.w + c;
    const float dy = clip(off[((size_t)b * 18 + 4) * plane + pix]);
    const float dx = clip(off[((size_t)b * 18 + 5) * plane + pix]);
    const float acc = hat_sum<kRowBlock, kXLoop>(
        xb, t, rb, r, c, 0, dy, dx, ylo, yhi, bd.xlo, bd.xhi);
    float* o = out + t.at(b, rb, r, c, t.o);
    for (int j = 0; j < t.o; ++j) o[j] = acc;
  }
}

// ------------------------------------------ k5's tap and its contraction

// The raw bits of kVec bf16 channels: one 16- or 4-byte load of 8 (k5) or 2
// (kf) (its address on as many bytes), or one 2-byte load
__device__ __forceinline__ void words(const uint4& b, unsigned (&w)[4]) {
  w[0] = b.x;
  w[1] = b.y;
  w[2] = b.z;
  w[3] = b.w;
}
__device__ __forceinline__ void words(unsigned b, unsigned (&w)[1]) {
  w[0] = b;
}

template <int kVec>
struct Channels {
  static_assert(kVec == 2 || kVec == 8, "2 or 8 channels");
  using Bits = std::conditional_t<kVec == 8, uint4, unsigned>;
  Bits bits;
  __device__ __forceinline__ void fetch(const bf16* __restrict__ p) {
    bits = __ldg(reinterpret_cast<const Bits*>(p));
  }
  __device__ __forceinline__ void unpack(float (&v)[kVec]) const {
    unsigned pair[kVec / 2];
    words(bits, pair);
#pragma unroll
    for (int q = 0; q < kVec / 2; ++q) {  // bf16 -> f32 is exact: the high half
      v[2 * q] = __uint_as_float(pair[q] << 16);
      v[2 * q + 1] = __uint_as_float(pair[q] & 0xffff0000u);
    }
  }
};
template <>
struct Channels<1> {
  bf16 bits;
  __device__ __forceinline__ void fetch(const bf16* __restrict__ p) {
    bits = *p;
  }
  __device__ __forceinline__ void unpack(float (&v)[1]) const {
    v[0] = __bfloat162float(bits);
  }
};

// The most gx a tile's box can hold: with dx clipped to +-8, xlo >= -8 and
// xhi <= 9
constexpr int kBox = 2 * 8 + 2;

// the n terms of one row of a box: r[j] from row + j * c, j < n
template <int kVec>
__device__ __forceinline__ void fetch_row(Channels<kVec> (&r)[kBox],
                                          const bf16* row, int n, int c) {
#pragma unroll
  for (int j = 0; j < kBox; ++j) {
    if (j >= n) break;
    r[j].fetch(row + (ptrdiff_t)j * c);
  }
}

// acc += (wy * wx[j]) * r[j] for j < n, in order, rounded as hat_sum does
template <int kVec>
__device__ __forceinline__ void sum_row(const Channels<kVec> (&r)[kBox],
                                        float wy, const float (&wx)[kBox],
                                        int n, float (&acc)[kVec]) {
#pragma unroll
  for (int j = 0; j < kBox; ++j) {
    if (j >= n) break;
    const float wyx = __fmul_rn(wy, wx[j]);
    float v[kVec];
    r[j].unpack(v);
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      acc[q] = __fadd_rn(acc[q], __fmul_rn(wyx, v[q]));
  }
}

// acc += the box's rows gy = ylo ... yhi in order, each as sum_row, with the
// next row's loads in flight while a row sums; at is the term (gy, gx) =
// (0, xlo), rows row_step apart, terms c apart; wx[j] = hat(xlo + j - dx)
template <int kVec>
__device__ __forceinline__ void sum_box(const bf16* at, ptrdiff_t row_step,
                                        int c, int ylo, int yhi, float py,
                                        const float (&wx)[kBox], int nx,
                                        float (&acc)[kVec]) {
  Channels<kVec> even[kBox], odd[kBox];
  fetch_row(even, at + ylo * row_step, nx, c);
  for (int gy = ylo; gy <= yhi; gy += 2) {
    const bool pair = gy < yhi;
    if (pair) fetch_row(odd, at + (gy + 1) * row_step, nx, c);
    sum_row(even, hat((float)gy - py), wx, nx, acc);
    if (!pair) break;
    if (gy + 2 <= yhi) fetch_row(even, at + (gy + 2) * row_step, nx, c);
    sum_row(odd, hat((float)(gy + 1) - py), wx, nx, acc);
  }
}

// v rounded to bf16 at s (16-byte aligned for kVec 8)
template <int kVec>
__device__ __forceinline__ void store_tap(bf16* s, const float (&v)[kVec]) {
  if constexpr (kVec == 8) {
    uint4 u;
    unsigned* pair = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      pair[q] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(s) = u;
  } else {
    s[0] = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ unsigned ld_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
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

// k5: per pixel of tile (b, rb) the k4 sum of every channel, in hat_sum's
// order and rounding (gy outer, gx inner, __fmul_rn / __fadd_rn, every term of
// the tile's box: a term of weight zero stays, so 0 * inf is NaN as in the
// script), times mask channel 3, rounded to bf16 once; then contracted with
// w[3] (C, O) in f32. One block a tile would put the work through 4 of 132
// SMs, so the grid is (group of kTapPixels pixels, rb, b), and each block
// reduces its tile's bounds itself (tile_bounds) with at least kTapThreads
// threads, so that the fixed work (the bounds over the tile, w[3] to shared
// memory) takes one or two loads a thread. A thread owns one (pixel, vector of
// kVec channels): wy once a gy, wy * wx once a (gy, gx), and one 16-byte load
// of 8 bf16 channels a term (kVec 8, where C % 8 == 0 and x lies on 16 bytes,
// the wrapper's choice that the entry checks again; else one channel). With
// about one warp an SM there is no other warp to hide a load's latency or a
// dependent instruction's behind, so a thread runs whole rows of its box: the
// weights hat(gx - dx) of its pixel once, in registers (a row holds at most
// kBox terms), the next row's loads in flight while a row sums, and nothing
// but the loads and the arithmetic in a row's straight-line code. The bf16
// taps (K = C zero-padded to kp, a multiple of 16) go to shared memory beside
// w[3] transposed (O zero-padded to op, a multiple of 8), rows ld = kp + 8
// apart: an odd number of 16-byte units, so the fragment loads hit 32 banks.
// Each warp contracts the 16 x kp tap with n8 tiles of w in turn, mma.sync
// m16n8k16 (bf16 in, f32 out; the products of two bf16 values are exact in
// f32, the order of the sums is the tensor core's), and stores the rows of the
// tile's pixels and the columns below O.
constexpr int kTapPixels = 16;  // pixels a block: one mma M tile
constexpr int kTapThreads = 128;  // the fewest threads a block

template <int kVec>
__global__ void __launch_bounds__(kThreads)
hat_tap_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const bf16* __restrict__ w,
               float* __restrict__ out, Tiles t, int kp, int op) {
  extern __shared__ __align__(16) unsigned char s_k5[];
  const int ld = kp + 8;
  bf16* s_tap = reinterpret_cast<bf16*>(s_k5);  // [kTapPixels][ld]
  bf16* s_w = s_tap + kTapPixels * ld;          // [op][ld]: w[3] transposed
  const int b = blockIdx.z, rb = blockIdx.y, p0 = blockIdx.x * kTapPixels;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int tile_px = t.pixels();
  const size_t plane = (size_t)t.h() * t.w, tile0 = (size_t)rb * tile_px;
  const float* dy = off + ((size_t)b * 18 + 4) * plane + tile0;
  const float* dx = dy + plane;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < kp * op; i += blockDim.x) {
    const int n = i / kp, k = i - n * kp;
    s_w[n * ld + k] = k < t.c && n < t.o ? w[(size_t)k * t.o + n] : zero;
  }
  const int pad_c = kp - t.c;
  for (int i = threadIdx.x; i < kTapPixels * pad_c; i += blockDim.x) {
    const int r = i / pad_c;
    s_tap[r * ld + t.c + (i - r * pad_c)] = zero;
  }
  const Bounds bd = tile_bounds(off, t.h(), t.w, t.br, b, rb);
  const int nx = bd.xhi - bd.xlo + 1;
  const bf16* xb = x + (size_t)b * t.hp() * t.wp() * t.c;
  const ptrdiff_t row_step = (ptrdiff_t)t.wp() * t.c;
  const int vectors = t.c / kVec;
  for (int item = threadIdx.x; item < kTapPixels * vectors;
       item += blockDim.x) {
    const int i = item / vectors, ch = (item - i * vectors) * kVec;
    const int p = p0 + i;
    float acc[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[q] = 0.f;
    if (p < tile_px) {
      const int r = p / t.w, c = p - r * t.w;
      const float py = clip(dy[p]), px = clip(dx[p]);
      const float m = mask[((size_t)b * 9 + 3) * plane + tile0 + p];
      const bf16* at = xb + ((size_t)(rb * t.br + t.pad + r) * t.wp()
                             + t.pad + c + bd.xlo) * t.c + ch;  // gx = xlo
      float wx[kBox];  // hat(gx - dx) for gx = xlo + j
#pragma unroll
      for (int j = 0; j < kBox; ++j) wx[j] = hat((float)(bd.xlo + j) - px);
      sum_box(at, row_step, t.c, bd.ylo, bd.yhi, py, wx, nx, acc);
#pragma unroll
      for (int q = 0; q < kVec; ++q) acc[q] = __fmul_rn(acc[q], m);
    }
    store_tap<kVec>(s_tap + i * ld + ch, acc);
  }
  __syncthreads();
  float* o = out + ((size_t)b * plane + tile0) * t.o;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' row, column pair
  const bf16* a_lo = s_tap + g * ld + tq * 2;
  const bf16* a_hi = a_lo + 8 * ld;
  for (int nt = warp; nt < op / 8; nt += warps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* bp = s_w + (nt * 8 + g) * ld + tq * 2;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      const unsigned a[4] = {ld_pair(a_lo + k0), ld_pair(a_hi + k0),
                             ld_pair(a_lo + k0 + 8), ld_pair(a_hi + k0 + 8)};
      mma_bf16(acc, a, ld_pair(bp + k0), ld_pair(bp + k0 + 8));
    }
    const int n = nt * 8 + tq * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + g + 8 * h;
      if (p >= tile_px) continue;
      float* dst = o + (size_t)p * t.o + n;
      if (n < t.o) dst[0] = acc[2 * h];
      if (n + 1 < t.o) dst[1] = acc[2 * h + 1];
    }
  }
}

// ------------------------------------------ kf's sampler of every channel

// kf (= kg): per pixel of tile (b, rb) and channel, the sum over the tile's
// box, gx cut to [kKfXMin, kKfXMax], of hat(gy - dy) * hat(gx - dx) * x,
// with hat_sum's rounding (__fmul_rn / __fadd_rn) and every term kept (0 *
// inf is NaN, as in the plain version). One block a tile
// (hat_sampler_kernel) put this through 4 of 132 SMs, one 2-byte load and
// two integer divisions a term. Here the grid is (group of px_block pixels,
// rb, b), and each block reduces its tile's bounds itself (tile_bounds). What
// bounds the kernel is each thread's chain of terms (up to 18 x 18 on the
// wide input), so a (pixel, vector of kVec channels) takes kSplit threads,
// adjacent lanes of a warp: part s sums its own run of the box's rows, in
// order (the rows cut into kSplit runs of ceil(ny / kSplit)), as
// hat_tap_kernel sums a whole box: its row weights hat(gx - dx) once, in
// registers, each gy weight once, one kVec-channel load a term, whole rows
// in straight-line code with the next row's loads in flight (sum_box). The
// parts' sums are then added in one fixed order, ((part 0 + part 1) + part
// 2) + part 3 (the plain version adds the same terms in one run: the two
// differ by the order of the sums, within kf's 1e-5, and are bitwise
// reproducible). Part 0 stores the vector, a float2 or a float. kVec is 2
// channels (one 4-byte load) where C is even and x on 4 bytes, else 1: the
// wrapper's choice (ops/probes.py:kf_width), checked again by the entry. A
// block holds about kColThreads threads; nothing ties it to k5's 16-pixel
// M tiles. Timed against 8, 4 and 1 channels a thread, 2 or 8 parts and 64
// or 256 threads a block (PERF.md §6), this design was the fastest on the
// wide input (18 x 18 terms) that is no slower on the script's (8 parts
// read about 1% lower on the wide input and 1-2% higher on the script's);
// float4 stores, gathered from the lanes beside, were no faster.
constexpr int kColThreads = 128;  // threads a block, where C allows
constexpr int kSplit = 4;         // threads a (pixel, vector)
constexpr int kKfXMin = -9, kKfXMax = 10;  // kf's GX_RANGE, range(-9, 11)

// v to o: one float2 (o on 8 bytes) or float store
template <int kVec>
__device__ __forceinline__ void store_cols(float* o, const float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  } else {
    o[0] = v[0];
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
hat_cols_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                float* __restrict__ out, Tiles t, int px_block) {
  static_assert(32 % kSplit == 0, "a (pixel, vector) within one warp");
  static_assert(kVec == 1 || kVec == 2, "1 or 2 channels a thread");
  const int b = blockIdx.z, rb = blockIdx.y, p0 = blockIdx.x * px_block;
  const int tile_px = t.pixels();
  const size_t plane = (size_t)t.h() * t.w, tile0 = (size_t)rb * tile_px;
  const float* dy = off + ((size_t)b * 18 + 4) * plane + tile0;
  const float* dx = dy + plane;
  const Bounds bd = tile_bounds(off, t.h(), t.w, t.br, b, rb);
  const int xlo = max(bd.xlo, kKfXMin);
  const int nx = min(bd.xhi, kKfXMax) - xlo + 1;
  const int chunk = (bd.yhi - bd.ylo + kSplit) / kSplit;  // rows a part
  const bf16* xb = x + (size_t)b * t.hp() * t.wp() * t.c;
  const ptrdiff_t row_step = (ptrdiff_t)t.wp() * t.c;
  const int vectors = t.c / kVec, items = px_block * vectors;
  const int lane = threadIdx.x & 31, part = lane % kSplit;
  const int first = lane - part;  // the lane of part 0
  // every lane runs every pass (the warp's shuffles), items past the end
  // or past the tile idle
  for (int i0 = 0; i0 < items; i0 += blockDim.x / kSplit) {
    const int item = i0 + threadIdx.x / kSplit;
    const int i = item / vectors, v = item - i * vectors, p = p0 + i;
    const bool valid = item < items && p < tile_px;
    float acc[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[q] = 0.f;
    const int lo = bd.ylo + part * chunk, hi = min(bd.yhi, lo + chunk - 1);
    if (valid && lo <= hi) {
      const int r = p / t.w, c = p - r * t.w;
      const float py = clip(dy[p]), px = clip(dx[p]);
      const bf16* at = xb + ((size_t)(rb * t.br + t.pad + r) * t.wp()
                             + t.pad + c + xlo) * t.c + v * kVec;  // gx = xlo
      float wx[kBox];  // hat(gx - dx) for gx = xlo + j
#pragma unroll
      for (int j = 0; j < kBox; ++j) wx[j] = hat((float)(xlo + j) - px);
      sum_box(at, row_step, t.c, lo, hi, py, wx, nx, acc);
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      float sum = __shfl_sync(0xffffffffu, acc[q], first);
#pragma unroll
      for (int j = 1; j < kSplit; ++j)
        sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, acc[q], first + j));
      acc[q] = sum;
    }
    float* o = out + ((size_t)b * plane + tile0 + p) * t.c + v * kVec;
    if (valid && part == 0) store_cols<kVec>(o, acc);
  }
}

// ------------------------------------------------------- p4's contraction

// p4's window: rows x cols pixels at (row0, col0) of x (xh, xw, k)
struct TapWindow {
  int xh, xw, row0, col0, rows, cols;
  float scale;
};

// out[p, n] = sum_k tap[p, k] * w[k, n] in f32, tap = bf16(x * bf16(scale))
// of the window's pixels p (row-major), w (k, n). One block (the old
// kernel) contracted the 128 x 64 tap in scalar FMA, reading w from device
// memory for every product. Here the grid runs over the output: blockIdx.y
// is a group of 16 pixels (one mma M tile; one window row of p4's 16
// columns), blockIdx.x a slice of kContractCols columns, so p4's 128 x 128
// output is 32 blocks. A block stages its 16 pixels' scaled, bf16-rounded
// taps and its slice of w transposed in shared memory (K zero-padded to kp,
// a multiple of 16; columns past n zero), rows ld = kp + 8 apart (an odd
// number of 16-byte units, so the fragment loads hit 32 banks), with 16-byte
// loads where the entry found k (for x; n for w) whole in 8-element vectors
// and the array on 16 bytes (every pixel's k channels are contiguous, so
// col0 does not break the alignment). Each warp contracts the 16 x kp tap
// with one n8 tile of the slice, mma.sync m16n8k16 (bf16 in, f32 out: a
// product of two bf16 values is exact in f32, so only the order of the sums
// differs from the plain version), and stores the pixels below rows * cols
// and the columns below n, as float2 where n is even.
constexpr int kContractThreads = 128;  // 4 warps, one n8 tile each
constexpr int kContractCols = 32;      // output columns a block
constexpr int kContractPixels = 16;    // pixels a block: one mma M tile

// bf16(v * scale) of the 8 bf16 values in u
__device__ __forceinline__ uint4 scale_bf16x8(uint4 u, float scale) {
  unsigned in[4], o[4];
  words(u, in);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        __fmul_rn(__uint_as_float(in[q] << 16), scale),
        __fmul_rn(__uint_as_float(in[q] & 0xffff0000u), scale));
    o[q] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// the bf16 in the low (hi = 0) or high half of u
__device__ __forceinline__ bf16 half_of(unsigned u, int hi) {
  return __ushort_as_bfloat16((unsigned short)(hi ? u >> 16 : u & 0xffffu));
}

__global__ void __launch_bounds__(kContractThreads)
contract_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                float* __restrict__ out, TapWindow win, int k, int n, int kp,
                bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) unsigned char s_p4[];
  const int ld = kp + 8;
  bf16* s_tap = reinterpret_cast<bf16*>(s_p4);  // [kContractPixels][ld]
  bf16* s_w = s_tap + kContractPixels * ld;     // [kContractCols][ld]
  const int pixels = win.rows * win.cols;
  const int m0 = blockIdx.y * kContractPixels, n0 = blockIdx.x * kContractCols;
  const float scale = round_bf16(win.scale);
  const bf16 zero = __float2bfloat16_rn(0.f);
  // the tap: pixel m0 + i at x[row0 + r, col0 + c, :]
  if (vec_x) {
    const int vectors = k / 8;
    for (int it = threadIdx.x; it < kContractPixels * vectors;
         it += blockDim.x) {
      const int i = it / vectors, v = it - i * vectors, p = m0 + i;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (p < pixels) {
        const int r = p / win.cols, c = p - r * win.cols;
        u = scale_bf16x8(
            __ldg(reinterpret_cast<const uint4*>(
                x + ((size_t)(win.row0 + r) * win.xw + win.col0 + c) * k)
                + v),
            scale);
      }
      *reinterpret_cast<uint4*>(s_tap + i * ld + v * 8) = u;
    }
  } else {
    for (int it = threadIdx.x; it < kContractPixels * k; it += blockDim.x) {
      const int i = it / k, ch = it - i * k, p = m0 + i;
      bf16 v = zero;
      if (p < pixels) {
        const int r = p / win.cols, c = p - r * win.cols;
        v = __float2bfloat16_rn(__fmul_rn(
            load(x + ((size_t)(win.row0 + r) * win.xw + win.col0 + c) * k
                 + ch),
            scale));
      }
      s_tap[i * ld + ch] = v;
    }
  }
  const int pad_k = kp - k;
  for (int it = threadIdx.x; it < kContractPixels * pad_k; it += blockDim.x) {
    const int i = it / pad_k;
    s_tap[i * ld + k + (it - i * pad_k)] = zero;
  }
  // w's slice, transposed: s_w[j][kk] = w[kk, n0 + j]
  if (vec_w) {
    constexpr int kVecs = kContractCols / 8;
    for (int it = threadIdx.x; it < kp * kVecs; it += blockDim.x) {
      const int kk = it / kVecs, j = (it - kk * kVecs) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (kk < k && n0 + j < n)  // n % 8 == 0: a vector is whole or past n
        u = __ldg(reinterpret_cast<const uint4*>(w + (size_t)kk * n + n0 + j));
      unsigned e[4];
      words(u, e);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        s_w[(j + q) * ld + kk] = half_of(e[q / 2], q & 1);
    }
  } else {
    for (int it = threadIdx.x; it < kp * kContractCols; it += blockDim.x) {
      const int kk = it / kContractCols, j = it - kk * kContractCols;
      s_w[j * ld + kk] =
          kk < k && n0 + j < n ? w[(size_t)kk * n + n0 + j] : zero;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' row, column pair
  const bf16* a_lo = s_tap + g * ld + tq * 2;
  const bf16* a_hi = a_lo + 8 * ld;
  for (int nt = warp; nt < kContractCols / 8; nt += blockDim.x >> 5) {
    const int col = n0 + nt * 8 + tq * 2;
    if (n0 + nt * 8 >= n) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* bp = s_w + (nt * 8 + g) * ld + tq * 2;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      const unsigned a[4] = {ld_pair(a_lo + k0), ld_pair(a_hi + k0),
                             ld_pair(a_lo + k0 + 8), ld_pair(a_hi + k0 + 8)};
      mma_bf16(acc, a, ld_pair(bp + k0), ld_pair(bp + k0 + 8));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      if (p >= pixels) continue;
      float* dst = out + (size_t)p * n + col;
      if (n % 2 == 0 && col < n) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[2 * h], acc[2 * h + 1]);
      } else {
        if (col < n) dst[0] = acc[2 * h];
        if (col + 1 < n) dst[1] = acc[2 * h + 1];
      }
    }
  }
}

// ------------------------------------------------------------ launches

Tiles make_tiles(int batch, int n_rb, int br, int w, int c, int o, int pad) {
  return Tiles{batch, n_rb, br, w, c, o, pad};
}

int launched() { return (int)cudaGetLastError(); }

template <Reduce R, Loop L>
int launch_windows(const void* x, const float* off, float* out,
                   const Windows& g, cudaStream_t stream) {
  window_sum_kernel<R, L><<<g.batch * g.n_rb, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), off, out, g);
  return launched();
}

// out (rows, span) from x as row_window_kernel says; vec 4 (float4) or 1,
// chosen by the wrapper (ops/probes.py:row_windows) and refused here where
// a window row of x or out would not be 16-byte aligned and whole in float4s
template <bool kCopy>
int launch_row_windows(const float* x, float* out, int row_stride, int col0,
                       int span, int rows, int lo, int hi, int vec,
                       cudaStream_t stream) {
  if (rows < 1 || span < 1 || lo < 0 || hi < lo || (kCopy && hi != lo + 1))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<size_t>(x + col0) | reinterpret_cast<size_t>(out))
       & 15) == 0 && row_stride % 4 == 0 && span % 4 == 0;
  if (vec != 1 && !(vec == 4 && aligned)) return (int)cudaErrorInvalidValue;
  const RowWindows g{row_stride, col0, span, lo, hi, span / vec};
  const dim3 grid((g.vectors + kRowThreads - 1) / kRowThreads, rows);
  if (vec == 4)
    row_window_kernel<float4, kCopy><<<grid, kRowThreads, 0, stream>>>(
        x, out, g);
  else
    row_window_kernel<float, kCopy><<<grid, kRowThreads, 0, stream>>>(
        x, out, g);
  return launched();
}

// the windows of a tile probe of tiles t: rows row0 + rb*row_step + gy + r,
// columns col0 + gx + c of x (B, HP, WP, C); O outputs
Windows tile_windows(const Tiles& t, int row0, int row_step, int col0) {
  return Windows{t.batch, t.n_rb, t.br, t.w, t.hp(), t.wp(), t.c, t.o,
                 row0, row_step, col0, 0, 0};
}

template <bool kRowBlock, bool kXLoop, int kYMin = -kOpen,
          int kYMax = kOpen>
int launch_hat(const void* x, const float* off, float* out, const Tiles& t,
               cudaStream_t stream) {
  hat_sampler_kernel<kRowBlock, kXLoop, kYMin, kYMax>
      <<<t.batch * t.n_rb, kThreads, 0, stream>>>(
          static_cast<const bf16*>(x), off, out, t);
  return launched();
}

// p4: a block per 16 pixels and kContractCols columns of the output
int launch_contract(const bf16* x, const bf16* w, float* out,
                    const TapWindow& win, int k, int n, cudaStream_t stream) {
  const int kp = (k + 15) / 16 * 16;
  const size_t smem =
      (size_t)(kContractPixels + kContractCols) * (kp + 8) * sizeof(bf16);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec_x = k % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const bool vec_w = n % 8 == 0 && (reinterpret_cast<size_t>(w) & 15) == 0;
  const int pixels = win.rows * win.cols;
  const dim3 grid((n + kContractCols - 1) / kContractCols,
                  (pixels + kContractPixels - 1) / kContractPixels);
  contract_kernel<<<grid, kContractThreads, smem, stream>>>(
      x, w, out, win, k, n, kp, vec_x, vec_w);
  return launched();
}

// kf on tiles t: a block per px_block pixels of a tile, kVec channels a
// thread
template <int kVec>
int launch_cols(const void* x, const float* off, float* out, const Tiles& t,
                cudaStream_t stream) {
  const int lanes = t.c / kVec * kSplit;  // threads a pixel
  const int px_block = std::max(1, kColThreads / lanes);
  const int threads = std::min(kThreads, (px_block * lanes + 31) / 32 * 32);
  const dim3 grid((t.pixels() + px_block - 1) / px_block, t.n_rb, t.batch);
  hat_cols_kernel<kVec><<<grid, threads, 0, stream>>>(
      static_cast<const bf16*>(x), off, out, t, px_block);
  return launched();
}

// kf and kg: as hat_cols_kernel says; vec 2 (one 4-byte load and one
// float2 store of 2 channels) or 1, chosen by the wrapper
// (ops/probes.py:kf_width) and refused here where C is odd, x is off 4
// bytes or out off 8 bytes
int launch_cols_checked(const void* x, const float* off, float* out,
                        const Tiles& t, int vec, cudaStream_t stream) {
  if (t.batch < 1 || t.n_rb < 1 || t.br < 1 || t.w < 1 || t.c < 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = t.c % 2 == 0 && (reinterpret_cast<size_t>(x) & 3) == 0
      && (reinterpret_cast<size_t>(out) & 7) == 0;
  if (vec != 1 && !(vec == 2 && aligned)) return (int)cudaErrorInvalidValue;
  if (vec == 2) return launch_cols<2>(x, off, out, t, stream);
  return launch_cols<1>(x, off, out, t, stream);
}

// k5 on tiles t: a block per kTapPixels pixels of a tile, w3 = w[3]
template <int kVec>
int launch_tap(const void* x, const float* off, const float* mask,
               const bf16* w3, float* out, const Tiles& t, int kp, int op,
               size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hat_tap_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int items = kTapPixels * (t.c / kVec);
  const int threads =
      std::min(kThreads, std::max(kTapThreads, (items + 31) / 32 * 32));
  const dim3 grid((t.pixels() + kTapPixels - 1) / kTapPixels, t.n_rb,
                  t.batch);
  hat_tap_kernel<kVec><<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x), off, mask, w3, out, t, kp, op);
  return launched();
}

}  // namespace

// Tile probes (P1-P3): x bf16 (B, HP, WP, C), off, mask f32, w bf16, out
// f32; a null pointer for an input the probe does not read. Each returns
// cudaGetLastError() after its launch.
#define TILE_PROBE(name)                                                   \
  extern "C" int cfd_probe_##name(                                         \
      const void* x, const float* off, const float* mask, const void* w,   \
      float* out, int batch, int n_rb, int br, int wd, int c, int o,       \
      int pad, cudaStream_t stream)
#define TILES make_tiles(batch, n_rb, br, wd, c, o, pad)

TILE_PROBE(k1) {  // the channel sum at rows rb*BR + 3 + r, columns 2 + c
  return launch_windows<Reduce::kSumChannels, Loop::kFixed>(
      x, off, out, tile_windows(TILES, 3, br, 2), stream);
}
TILE_PROBE(k3) {  // no row-block term
  return launch_windows<Reduce::kChannel0, Loop::kTileY>(
      x, off, out, tile_windows(TILES, pad, 0, pad), stream);
}
TILE_PROBE(k4) {
  return launch_hat<true, true>(x, off, out, TILES, stream);
}
TILE_PROBE(ka) {
  return launch_windows<Reduce::kCount, Loop::kTileYX>(
      x, off, out, tile_windows(TILES, pad, br, pad), stream);
}
TILE_PROBE(kb) {  // no row-block term, no x loop
  return launch_hat<false, false>(x, off, out, TILES, stream);
}
TILE_PROBE(kc) {
  return launch_windows<Reduce::kChannel0, Loop::kTileY>(
      x, off, out, tile_windows(TILES, pad, br, pad), stream);
}
TILE_PROBE(kd) {  // k4's function: its device code
  return launch_hat<true, true>(x, off, out, TILES, stream);
}
TILE_PROBE(ke) {  // gy cut to [-2, 2]
  return launch_hat<true, true, -2, 2>(x, off, out, TILES, stream);
}

#undef TILES
#undef TILE_PROBE

// kf (every channel, gx cut to GX_RANGE = [-9, 10]) and kg (kf's function:
// its roll never wraps; kf's device code): as hat_cols_kernel says, vec
// as launch_cols_checked says. The tile arguments are the tile probes'.
#define COLS_PROBE(name)                                                   \
  extern "C" int cfd_probe_##name(                                         \
      const void* x, const float* off, const float*, const void*,          \
      float* out, int batch, int n_rb, int br, int wd, int c, int o,       \
      int pad, int vec, cudaStream_t stream) {                             \
    return launch_cols_checked(x, off, out,                                \
                               make_tiles(batch, n_rb, br, wd, c, o, pad), \
                               vec, stream);                               \
  }
COLS_PROBE(kf)
COLS_PROBE(kg)
#undef COLS_PROBE

// k2: out (B, H*W, O) = dy broadcast to O, as broadcast_kernel says; vec 4
// (float4 stores) or 1, chosen by the wrapper (ops/probes.py:k2_width) and
// refused here where O is not whole in float4s or out is off 16 bytes.
// The tile arguments are the tile probes'.
extern "C" int cfd_probe_k2(const void*, const float* off, const float*,
                            const void*, float* out, int batch, int n_rb,
                            int br, int wd, int, int o, int, int vec,
                            cudaStream_t stream) {
  const int hw = n_rb * br * wd;
  if (batch < 1 || hw < 1 || o < 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<size_t>(out) & 15) == 0 && o % 4 == 0;
  if (vec != 1 && !(vec == 4 && aligned)) return (int)cudaErrorInvalidValue;
  const int vectors = o / vec;
  const int bx = std::min(vectors, kThreads);
  const int by = std::max(1, std::min(kThreads / bx, hw));
  const dim3 grid((hw + by - 1) / by, batch);
  const dim3 block(bx, by);
  if (vec == 4)
    broadcast_kernel<float4><<<grid, block, 0, stream>>>(off, out, hw,
                                                         vectors);
  else
    broadcast_kernel<float><<<grid, block, 0, stream>>>(off, out, hw, vectors);
  return launched();
}

// k5: as hat_tap_kernel says; vec 8 (16-byte loads of 8 channels) or 1,
// chosen by the wrapper (ops/probes.py:k5_width) and refused here where C
// % 8 != 0 or x is off 16 bytes. Refused too where the tap and w[3] would
// not fit in a block's shared memory.
extern "C" int cfd_probe_k5(const void* x, const float* off,
                            const float* mask, const void* w, float* out,
                            int batch, int n_rb, int br, int wd, int c, int o,
                            int pad, int vec, cudaStream_t stream) {
  if (batch < 1 || n_rb < 1 || br < 1 || wd < 1 || c < 1 || o < 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<size_t>(x) & 15) == 0 && c % 8 == 0;
  if (vec != 1 && !(vec == 8 && aligned)) return (int)cudaErrorInvalidValue;
  const int kp = (c + 15) / 16 * 16, op = (o + 7) / 8 * 8;
  const size_t smem = (size_t)(kTapPixels + op) * (kp + 8) * sizeof(bf16);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const Tiles t = make_tiles(batch, n_rb, br, wd, c, o, pad);
  const bf16* w3 = static_cast<const bf16*>(w) + (size_t)3 * c * o;
  if (vec == 8)
    return launch_tap<8>(x, off, mask, w3, out, t, kp, op, smem, stream);
  return launch_tap<1>(x, off, mask, w3, out, t, kp, op, smem, stream);
}

// p1 and p2: out (rows, span) as row_window_kernel says, x f32. p1 is one
// window, a copy: lo = g, hi = g + 1, col0 = (g + 1) * d2 of x (d0, d1, d2),
// span = cols * d2; p2 sums rows lo ... hi-1 of x (n, l) from zero: col0 =
// 0, span = l.
extern "C" int cfd_probe_p1(const float* x, float* out, int row_stride,
                            int col0, int span, int rows, int lo, int hi,
                            int vec, cudaStream_t stream) {
  return launch_row_windows<true>(x, out, row_stride, col0, span, rows, lo,
                                  hi, vec, stream);
}

extern "C" int cfd_probe_p2(const float* x, float* out, int row_stride,
                            int col0, int span, int rows, int lo, int hi,
                            int vec, cudaStream_t stream) {
  return launch_row_windows<false>(x, out, row_stride, col0, span, rows, lo,
                                   hi, vec, stream);
}

// p3: out = x + trunc(min x) where max x > 0.5, else 0; x f32 of n
// elements, one block
extern "C" int cfd_probe_p3(const float* x, float* out, int n,
                            cudaStream_t stream) {
  shift_if_max_kernel<<<1, kThreads, 0, stream>>>(x, out, n);
  return launched();
}

// p4: out (rows*cols, n) = bf16(x[row0:row0+rows, col0:col0+cols, :] *
// bf16(scale)) as (rows*cols, k) @ w (k, n), x bf16 (xh, xw, k), w bf16
extern "C" int cfd_probe_p4(const void* x, const void* w, float* out, int xh,
                            int xw, int k, int n, int row0, int col0,
                            int rows, int cols, float scale,
                            cudaStream_t stream) {
  if (xh < 1 || xw < 1 || k < 0 || n < 1 || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  return launch_contract(static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w), out,
                         TapWindow{xh, xw, row0, col0, rows, cols, scale}, k,
                         n, stream);
}
