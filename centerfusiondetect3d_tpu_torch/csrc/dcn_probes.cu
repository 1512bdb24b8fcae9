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
//   tile_sum_kernel     k1, k3, kc, ka: unweighted window sums of a tile,
//                       broadcast to O
//   row_window_kernel   p1, p2: P5's windows, summed over a run of rows
//   broadcast_kernel    k2: the offset field's dy, broadcast to O
//   shift_if_max_kernel p3: a whole-array min/max (NaN-propagating) and a
//                       select, x read once into registers
//   hat_channel0_kernel kb, k4 (= kd), ke: the hat-weighted sampler of
//                       channel 0, broadcast to O
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
// channels for kf and kg. A tile is one (b, rb) program of the Pallas grid,
// BR x W pixels, and its loop bounds come from the min and max of its clipped
// dy and dx (tile_bounds, reduced in shared memory by every block that needs
// them). The sampling probes sum in f32 registers in the scripts' order (gy
// outer, gx inner), with the products and sums rounded where the scripts
// round them (no fused multiply-add), so the plain version and the kernel
// differ only where a sum runs in another order. The wrapper checks that
// every window lies inside x.
//
// What bounds them: at the scripts' shapes a probe moves about 100 KB and
// does at most a few MFLOP, well under a microsecond of the card's memory
// or arithmetic; the launch itself (a few microseconds) bounds every one.
// One block a tile, the Pallas grid's unit, put a probe through 4 of 132
// SMs, so every tile probe runs over the output instead, each block with its
// own tile's bounds: k1, k3, kc, ka (tile_sum_kernel) a block per 32 pixels
// of a tile, k4, kd, ke, kb (hat_channel0_kernel) per 16, k5 (hat_tap_kernel)
// per 16, kf and kg (hat_cols_kernel) per pixels of about 128 threads, k2
// (broadcast_kernel) over each batch's pixels; P5's windows (p1, p2:
// row_window_kernel) and p4's contraction (contract_kernel, a block per 16
// pixels and 32 columns) likewise. Only p3's whole-array min/max
// (shift_if_max_kernel) keeps one block: its inputs are 8 KB, and a second
// block would need a grid-wide barrier that costs more than the work.

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
// the clipped offset field (B, 18, h, w); xlo, xhi likewise from dx, or 0
// where the caller has no x loop (kCols false: dx is not read).
struct Bounds {
  int ylo, yhi, xlo, xhi;
};

template <bool kCols = true>
__device__ Bounds tile_bounds(const float* __restrict__ off, int h, int w,
                              int br, int b, int rb) {
  const size_t plane = (size_t)h * w;
  const float* dy = off + ((size_t)b * 18 + 4) * plane + (size_t)rb * br * w;
  const float* dx = dy + plane;
  float ymin = CUDART_INF_F, ymax = -CUDART_INF_F;
  float xmin = CUDART_INF_F, xmax = -CUDART_INF_F;
  for (int i = threadIdx.x; i < br * w; i += blockDim.x) {
    const float vy = clip(dy[i]);
    ymin = fminf(ymin, vy);
    ymax = fmaxf(ymax, vy);
    if (kCols) {
      const float vx = clip(dx[i]);
      xmin = fminf(xmin, vx);
      xmax = fmaxf(xmax, vx);
    }
  }
  block_min_max(ymin, ymax);
  if (!kCols) return {(int)floorf(ymin), (int)floorf(ymax) + 1, 0, 0};
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
};

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

// min and max that return NaN where either operand is NaN (fminf and fmaxf
// return the other operand), as jnp.min, jnp.max, torch.min and torch.max do
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

constexpr int kP3Threads = 256;
constexpr int kP3Regs = 4;  // vectors a thread keeps in registers

__device__ __forceinline__ void fold(float v, float& lo, float& hi) {
  lo = min_nan(lo, v);
  hi = max_nan(hi, v);
}
__device__ __forceinline__ void fold(const float4& v, float& lo, float& hi) {
  fold(v.x, lo, hi);
  fold(v.y, lo, hi);
  fold(v.z, lo, hi);
  fold(v.w, lo, hi);
}
__device__ __forceinline__ float select(float v, bool on, float shift) {
  return on ? v + shift : 0.f;
}
__device__ __forceinline__ float4 select(const float4& v, bool on,
                                         float shift) {
  return make_float4(select(v.x, on, shift), select(v.y, on, shift),
                     select(v.z, on, shift), select(v.w, on, shift));
}

// x + trunc(min x) where max x > 0.5, else 0, over n floats; one block. Each
// thread reads its vectors of kVec floats (float4 or float) once and keeps
// the first kP3Regs in registers (the whole of x up to kP3Threads * kP3Regs
// vectors; any further vector is read again for the select), plus one of
// the n % kVec tail floats. The min and max propagate NaN: a NaN anywhere
// makes max x > 0.5 false and the output zeros. The cast to int32
// saturates (-inf gives -2^31), as torch's cast does on the card.
template <int kVec>
__global__ void __launch_bounds__(kP3Threads)
shift_if_max_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int n) {
  using V = typename std::conditional<kVec == 4, float4, float>::type;
  const V* vin = reinterpret_cast<const V*>(in);
  V* vout = reinterpret_cast<V*>(out);
  const int nv = n / kVec, t = threadIdx.x;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  V r[kP3Regs];
#pragma unroll
  for (int k = 0; k < kP3Regs; ++k) {
    const int i = t + k * kP3Threads;
    if (i < nv) {
      r[k] = __ldg(vin + i);
      fold(r[k], lo, hi);
    }
  }
  for (int i = t + kP3Regs * kP3Threads; i < nv; i += kP3Threads)
    fold(__ldg(vin + i), lo, hi);
  const int tail = nv * kVec + t;
  float last = 0.f;
  if (tail < n) {
    last = __ldg(in + tail);
    fold(last, lo, hi);
  }

  __shared__ float s_lo[kP3Threads / 32], s_hi[kP3Threads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((t & 31) == 0) {
    s_lo[t >> 5] = lo;
    s_hi[t >> 5] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int i = 1; i < kP3Threads / 32; ++i) {
    lo = min_nan(lo, s_lo[i]);
    hi = max_nan(hi, s_hi[i]);
  }

  const bool on = hi > 0.5f;
  const float shift = (float)__float2int_rz(lo);
#pragma unroll
  for (int k = 0; k < kP3Regs; ++k) {
    const int i = t + k * kP3Threads;
    if (i < nv) vout[i] = select(r[k], on, shift);
  }
  for (int i = t + kP3Regs * kP3Threads; i < nv; i += kP3Threads)
    vout[i] = select(__ldg(vin + i), on, shift);
  if (tail < n) out[tail] = select(last, on, shift);
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

// acc += (wy * wx[j]) * r[j] for j < n, in order, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn), as the plain versions round
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

// k5: per pixel of tile (b, rb) the k4 sum of every channel, in the plain
// version's order and rounding (gy outer, gx inner, __fmul_rn / __fadd_rn, every term of
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
// with the plain version's rounding (__fmul_rn / __fadd_rn) and every term
// kept (0 * inf is NaN, as in the plain version). One block a tile (the old
// all-channel sampler) put this through 4 of 132 SMs, one 2-byte load and
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

// ----------------------------------------- the broadcast tile probes

// k4 (= kd), ke, kb, and k1, k3, kc, ka: one value a pixel of tile (b, rb),
// broadcast to the O outputs. One block a tile (the Pallas grid's unit)
// would put these through 4 of 132 SMs, and O serial float stores a pixel
// would bound them (as they bound k2's first kernel), so the grid runs over
// the output, (group of pixels, rb, b), as in hat_cols_kernel, and each block
// reduces its own tile's bounds (tile_bounds; only dy where the probe has no
// x loop). The pixels' threads are adjacent
// lanes of a warp, and after the sum they store the pixel's broadcast
// together, lane j the vectors j, j + lanes, ...: V is float4 where the
// wrapper found O whole in float4s and out on 16 bytes (ops/probes.py:
// broadcast_width; the entry checks it again), else float.

// k4/kd, ke, kb: per pixel of tile (b, rb) the sum over gy in [ylo, yhi] (ke:
// cut to [max(ylo, -2), min(yhi, 2)]) and gx in [xlo, xhi] of hat(gy - dy) *
// hat(gx - dx) * x[b, [rb*BR] + gy + pad + r, pad + gx + c, 0], with the
// plain version's rounding (__fmul_rn / __fadd_rn) and every term kept (0 *
// inf is NaN, as in the plain version). kb has no row-block term and no x
// loop: its term is hat(gy - dy) * x[..., pad + c, 0], which sum_box computes
// with nx = 1 and wx[0] = 1 (__fmul_rn(wy, 1) is wy exactly). One thread's
// chain of up to 18 x 18 terms on the wide input would bound the kernel, so
// a pixel takes kHatSplit adjacent lanes: part s sums its own run of the
// box's rows in order (the rows cut into runs of ceil(ny / kHatSplit)) with
// sum_box, the row weights hat(gx - dx) once in registers and the next row's
// loads in flight, and the parts' sums are added in one fixed order by
// shuffles, ((part 0 + part 1) + part 2) + ... (within the probes' 1e-5 of
// the plain version's one run; bitwise reproducible). No integer division
// runs per term. Timed against 2 and 4 lanes a pixel, 64 and 256 threads a
// block, and the pixel's dy and dx read before the bounds, 8 lanes were the
// fastest on the wide input (3 rows of 18 terms a lane) and the narrow one,
// and as fast on the script's but for kb's, whose two rows leave six lanes
// idle (PERF.md §6).
constexpr int kHatSplit = 8;                         // lanes a pixel
constexpr int kHatThreads = 128;                     // threads a block
constexpr int kHatPixels = kHatThreads / kHatSplit;  // pixels a block

template <typename V>
__device__ __forceinline__ void store_broadcast(float* o, int n, float v,
                                                int lane, int lanes) {
  V vv;
  splat(v, vv);
  V* ov = reinterpret_cast<V*>(o);
  const int vectors = n / (int)(sizeof(V) / sizeof(float));
  for (int j = lane; j < vectors; j += lanes) ov[j] = vv;
}

template <bool kRowBlock, bool kXLoop, int kYMin, int kYMax, typename V>
__global__ void __launch_bounds__(kHatThreads)
hat_channel0_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                    float* __restrict__ out, Tiles t) {
  static_assert(32 % kHatSplit == 0, "a pixel's lanes within one warp");
  const int b = blockIdx.z, rb = blockIdx.y, p0 = blockIdx.x * kHatPixels;
  const int tile_px = t.pixels();
  const size_t plane = (size_t)t.h() * t.w, tile0 = (size_t)rb * tile_px;
  const float* dy = off + ((size_t)b * 18 + 4) * plane + tile0;
  const float* dx = dy + plane;
  const Bounds bd = tile_bounds<kXLoop>(off, t.h(), t.w, t.br, b, rb);
  const int ylo = max(bd.ylo, kYMin), yhi = min(bd.yhi, kYMax);
  const int chunk = (max(0, yhi - ylo + 1) + kHatSplit - 1) / kHatSplit;
  const int nx = kXLoop ? bd.xhi - bd.xlo + 1 : 1;
  const int lane = threadIdx.x & 31, part = lane % kHatSplit;
  const int first = lane - part;  // the lane of part 0
  const int p = p0 + (int)threadIdx.x / kHatSplit;
  const bool valid = p < tile_px;
  float acc[1] = {0.f};
  const int lo = ylo + part * chunk, hi = min(yhi, lo + chunk - 1);
  if (valid && lo <= hi) {
    const int r = p / t.w, c = p - r * t.w;
    const float py = clip(dy[p]), px = kXLoop ? clip(dx[p]) : 0.f;
    const int row = (kRowBlock ? rb * t.br : 0) + t.pad + r;
    const int col = t.pad + c + (kXLoop ? bd.xlo : 0);
    const bf16* at = x + (((size_t)b * t.hp() + row) * t.wp() + col) * t.c;
    float wx[kBox];  // hat(gx - dx) for gx = xlo + j; kb: 1
#pragma unroll
    for (int j = 0; j < kBox; ++j)
      wx[j] = kXLoop ? hat((float)(bd.xlo + j) - px) : 1.f;
    sum_box(at, (ptrdiff_t)t.wp() * t.c, t.c, lo, hi, py, wx, nx, acc);
  }
  // every lane runs the shuffles; each gets the same sum
  float sum = __shfl_sync(0xffffffffu, acc[0], first);
#pragma unroll
  for (int j = 1; j < kHatSplit; ++j)
    sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, acc[0], first + j));
  if (valid)
    store_broadcast<V>(out + ((size_t)b * plane + tile0 + p) * t.o, t.o, sum,
                       part, kHatSplit);
}

// k1, k3, kc, ka: per pixel (r, c) of tile (b, rb) one window sum of x at
// rows row0 + rb*row_step + gy + r and column col0 + c, broadcast to O.
// k3 (row_step 0) and kc (row_step BR) sum channel 0 over the tile's gy
// range. With dy clipped to +-8 that range lies in [-8, 9], kBox rows that
// stay inside x (the wrapper's pad >= 9), so a thread loads all kBox of them
// before the tile's bounds are known, in flight while the block reduces
// them, and then sums those in [ylo, yhi] in gy order, as the plain version
// does. k1 (gy = 0 alone; no offsets read) sums the C channels of its window
// in channel order within one thread, 16-byte loads of 8 channels where C %
// 8 == 0 and x lies on 16 bytes (kVec 8; the entry decides), and rounds to
// bf16: another order of an inexact float32 sum could flip that rounding by
// one bf16 ulp. ka stores the size of the tile's box, (yhi - ylo + 1) (xhi -
// xlo + 1), with no x loads (bitwise the plain version's). A pixel takes
// kSumLanes adjacent lanes, each of which computes the same sum (their loads
// meet at one address) and stores its share of the broadcast. Timed against
// loading only the tile's rows once its bounds are known, 1 or 8 lanes a
// pixel, 64 or 256 threads a block and k1 with one channel a load on every
// x, this design was the fastest (PERF.md §6).
enum class Reduce {
  kSumChannels,  // k1
  kChannel0,     // k3, kc
  kCount,        // ka
};

// rows row0 + rb*row_step + gy + r, columns col0 + c of x (B, HP, WP, C)
struct Windows {
  int row0, row_step, col0;
};

constexpr int kSumLanes = 4;                         // lanes a pixel
constexpr int kSumThreads = 128;                     // threads a block
constexpr int kSumPixels = kSumThreads / kSumLanes;  // pixels a block
constexpr int kGyMin = -(int)kClip;                  // the first gy of kBox

template <Reduce R, typename V, int kVec>
__global__ void __launch_bounds__(kSumThreads)
tile_sum_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                float* __restrict__ out, Tiles t, Windows win) {
  const int b = blockIdx.z, rb = blockIdx.y;
  const int lane = (int)threadIdx.x % kSumLanes;
  const int p = blockIdx.x * kSumPixels + (int)threadIdx.x / kSumLanes;
  const bool valid = p < t.pixels();
  const int r = p / t.w, c = p - r * t.w;
  const bf16* at = nullptr;  // (gy, channel) = (0, 0) of the pixel's window
  if (R != Reduce::kCount)
    at = x + (((size_t)b * t.hp() + win.row0 + rb * win.row_step + r)
              * t.wp() + win.col0 + c) * t.c;
  const ptrdiff_t row_step = (ptrdiff_t)t.wp() * t.c;
  bf16 rows[kBox];  // k3, kc: channel 0 at gy = kGyMin + j
  if (R == Reduce::kChannel0 && valid) {
#pragma unroll
    for (int j = 0; j < kBox; ++j) rows[j] = at[(kGyMin + j) * row_step];
  }
  Bounds bd{0, 0, 0, 0};
  if (R != Reduce::kSumChannels)
    bd = tile_bounds<R == Reduce::kCount>(off, t.h(), t.w, t.br, b, rb);
  if (!valid) return;
  float acc = 0.f;
  if constexpr (R == Reduce::kCount) {
    acc = (float)((bd.yhi - bd.ylo + 1) * (bd.xhi - bd.xlo + 1));
  } else if constexpr (R == Reduce::kChannel0) {
#pragma unroll
    for (int j = 0; j < kBox; ++j)
      if (kGyMin + j >= bd.ylo && kGyMin + j <= bd.yhi)
        acc += __bfloat162float(rows[j]);
  } else {
    for (int k = 0; k < t.c; k += kVec) {
      Channels<kVec> ch;
      ch.fetch(at + k);
      float v[kVec];
      ch.unpack(v);
#pragma unroll
      for (int q = 0; q < kVec; ++q) acc += v[q];
    }
    acc = round_bf16(acc);
  }
  store_broadcast<V>(out + ((size_t)b * t.h() * t.w + (size_t)rb * t.pixels()
                            + p) * t.o,
                     t.o, acc, lane, kSumLanes);
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

// vec 4 (float4 stores of a broadcast) or 1, as the wrapper chose it
// (ops/probes.py:broadcast_width): 4 only where O is whole in float4s and out
// lies on 16 bytes
bool broadcast_ok(const float* out, int o, int vec) {
  const bool aligned = (reinterpret_cast<size_t>(out) & 15) == 0 && o % 4 == 0;
  return vec == 1 || (vec == 4 && aligned);
}

// positive sizes and a pad that covers gy, gx in [-kClip, kClip + 1]: the
// window sums load all kBox rows of that range whatever the offsets are
bool tiles_ok(const Tiles& t) {
  return t.batch >= 1 && t.n_rb >= 1 && t.br >= 1 && t.w >= 1 && t.c >= 1
      && t.o >= 1 && t.pad >= (int)kClip + 1;
}

// k4/kd, ke, kb on tiles t: a block per kHatPixels pixels of a tile; gy cut
// to [kYMin, kYMax]
template <bool kRowBlock, bool kXLoop, int kYMin = -kOpen,
          int kYMax = kOpen>
int launch_hat(const void* x, const float* off, float* out, const Tiles& t,
               int vec, cudaStream_t stream) {
  if (!tiles_ok(t) || !broadcast_ok(out, t.o, vec))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t.pixels() + kHatPixels - 1) / kHatPixels, t.n_rb,
                  t.batch);
  const bf16* xb = static_cast<const bf16*>(x);
  if (vec == 4)
    hat_channel0_kernel<kRowBlock, kXLoop, kYMin, kYMax, float4>
        <<<grid, kHatThreads, 0, stream>>>(xb, off, out, t);
  else
    hat_channel0_kernel<kRowBlock, kXLoop, kYMin, kYMax, float>
        <<<grid, kHatThreads, 0, stream>>>(xb, off, out, t);
  return launched();
}

// k1, k3, kc, ka on tiles t: a block per kSumPixels pixels of a tile; kVec
// channels a load (k1)
template <Reduce R, int kVec = 1>
int launch_sums(const void* x, const float* off, float* out, const Tiles& t,
                const Windows& win, int vec, cudaStream_t stream) {
  if (!tiles_ok(t) || !broadcast_ok(out, t.o, vec))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t.pixels() + kSumPixels - 1) / kSumPixels, t.n_rb,
                  t.batch);
  const bf16* xb = static_cast<const bf16*>(x);
  if (vec == 4)
    tile_sum_kernel<R, float4, kVec><<<grid, kSumThreads, 0, stream>>>(
        xb, off, out, t, win);
  else
    tile_sum_kernel<R, float, kVec><<<grid, kSumThreads, 0, stream>>>(
        xb, off, out, t, win);
  return launched();
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
// f32; a null pointer for an input the probe does not read; vec the vector
// width that the wrapper chose (ops/probes.py), refused where the tensors do
// not allow it. Each returns cudaGetLastError() after its launch.
#define TILE_PROBE(name)                                                   \
  extern "C" int cfd_probe_##name(                                         \
      const void* x, const float* off, const float* mask, const void* w,   \
      float* out, int batch, int n_rb, int br, int wd, int c, int o,       \
      int pad, int vec, cudaStream_t stream)
#define TILES make_tiles(batch, n_rb, br, wd, c, o, pad)

// k1, k3, k4 (= kd), ka, kb, kc, ke: as tile_sum_kernel and
// hat_channel0_kernel say; vec 4 (float4 stores) or 1, as broadcast_ok says
TILE_PROBE(k1) {  // the channel sum at rows rb*BR + 3 + r, columns 2 + c;
                  // 8 channels a load where C % 8 == 0 and x is on 16 bytes
  const Windows win{3, br, 2};
  if (c % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0)
    return launch_sums<Reduce::kSumChannels, 8>(x, off, out, TILES, win, vec,
                                                stream);
  return launch_sums<Reduce::kSumChannels, 1>(x, off, out, TILES, win, vec,
                                              stream);
}
TILE_PROBE(k3) {  // no row-block term
  return launch_sums<Reduce::kChannel0>(x, off, out, TILES,
                                        Windows{pad, 0, pad}, vec, stream);
}
TILE_PROBE(k4) {
  return launch_hat<true, true>(x, off, out, TILES, vec, stream);
}
TILE_PROBE(ka) {
  return launch_sums<Reduce::kCount>(x, off, out, TILES,
                                     Windows{pad, br, pad}, vec, stream);
}
TILE_PROBE(kb) {  // no row-block term, no x loop
  return launch_hat<false, false>(x, off, out, TILES, vec, stream);
}
TILE_PROBE(kc) {
  return launch_sums<Reduce::kChannel0>(x, off, out, TILES,
                                        Windows{pad, br, pad}, vec, stream);
}
TILE_PROBE(kd) {  // k4's function: its device code
  return launch_hat<true, true>(x, off, out, TILES, vec, stream);
}
TILE_PROBE(ke) {  // gy cut to [-2, 2]
  return launch_hat<true, true, -2, 2>(x, off, out, TILES, vec, stream);
}

// kf (every channel, gx cut to GX_RANGE = [-9, 10]) and kg (kf's function:
// its roll never wraps; kf's device code): as hat_cols_kernel says, vec
// as launch_cols_checked says.
TILE_PROBE(kf) {
  return launch_cols_checked(x, off, out, TILES, vec, stream);
}
TILE_PROBE(kg) {
  return launch_cols_checked(x, off, out, TILES, vec, stream);
}

#undef TILES
#undef TILE_PROBE

// k2: out (B, H*W, O) = dy broadcast to O, as broadcast_kernel says; vec
// as broadcast_ok says. The tile arguments are the tile probes'.
extern "C" int cfd_probe_k2(const void*, const float* off, const float*,
                            const void*, float* out, int batch, int n_rb,
                            int br, int wd, int, int o, int, int vec,
                            cudaStream_t stream) {
  const int hw = n_rb * br * wd;
  if (batch < 1 || hw < 1 || o < 1 || !broadcast_ok(out, o, vec))
    return (int)cudaErrorInvalidValue;
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
// elements, one block. vec 4 (float4 loads and stores) or 1, chosen by the
// wrapper (ops/probes.py:p3_width) and refused here where x or out does not
// start on 16 bytes
extern "C" int cfd_probe_p3(const float* x, float* out, int n, int vec,
                            cudaStream_t stream) {
  if (n < 1 || (vec != 4 && vec != 1) ||
      (vec == 4 && ((reinterpret_cast<size_t>(x) & 15) != 0 ||
                    (reinterpret_cast<size_t>(out) & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec == 4)
    shift_if_max_kernel<4><<<1, kP3Threads, 0, stream>>>(x, out, n);
  else
    shift_if_max_kernel<1><<<1, kP3Threads, 0, stream>>>(x, out, n);
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
