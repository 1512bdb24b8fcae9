// The DCN probe kernels: the toolchain probes of the TPU rounds, in CUDA.
//
// Replaces the kernel bodies of scripts/probe_dcn_bisect.py (P1: k1 :62,
// k2 :71, k3 :77, k4 :93, k5 :120), scripts/probe_dcn_bisect2.py (P2: ka
// :64, kb :80, kc :95, kd :110, ke :131), scripts/probe_dcn_bisect3.py (P3:
// kf :97, kg :117) and scripts/probe_mosaic.py (P5: p1 :45, p2 :68, p3 :98,
// p4 :122). Each isolated one ingredient of the clamped shifted-window DCN
// kernel (K1, centerfusiondetect3d_tpu/ops/pallas_dcn.py:117) for the TPU
// compiler. Here each probe is one entry point with its own launch count
// (ops/probes.py), built from four kernel templates:
//   window_sum_kernel   k1, k3, kc, ka, p1, p2: unweighted window sums
//   field_kernel        k2, p3: an offset field read, a whole-array min/max
//   hat_sampler_kernel  kb, k4 (= kd), ke, kf (= kg): the hat-weighted
//                       sampler
//   contract_kernel     k5, p4: a bf16 tap in shared memory, contracted
//                       with bf16 taps in f32
// ops/probes.py states what each probe computes; its plain versions are
// the reference these kernels are held against.
//
// Layout of the tile probes (P1-P3), as the scripts have it: x bf16
// (B, HP, WP, C), HP = n_rb*BR + 2*pad, WP = W + 2*pad; off f32
// (B, 18, n_rb*BR, W) with dy in channel 4 and dx in channel 5; mask f32
// (B, 9, n_rb*BR, W); w bf16 (9, C, O); out f32 (B, n_rb*BR, W, O), or C
// channels for kf and kg. A thread block is one (b, rb) tile of BR x W
// pixels, the Pallas grid's unit: the tile's loop bounds come from the min
// and max of its clipped dy and dx, reduced in shared memory first; then
// threads run over (pixel, channel) and sum in f32 registers in the
// scripts' order (gy outer, gx inner), with the products and sums rounded
// where the scripts round them (no fused multiply-add), so the plain
// version and the kernel differ only where a sum runs in another order.
// The wrapper checks that every window lies inside x.
//
// What bounds them: at the scripts' shapes a probe moves about 100 KB and
// does at most a few MFLOP, well under a microsecond of the card's memory
// or arithmetic; the launch itself (a few microseconds) bounds every one.
// So the design is the plainest correct one: one block per tile, 256
// threads, no staging beyond the tile bounds and the contraction's tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kClip = 8.f;        // the probes clip dy and dx to +-8
constexpr int kOpen = 1 << 20;      // a loop range that is not cut
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block can use

__device__ __forceinline__ float load(const float* p) { return *p; }
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
  kCopy,         // p1, p2: every channel on its own
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

template <typename T, Reduce R, Loop L>
__global__ void __launch_bounds__(kThreads)
window_sum_kernel(const T* __restrict__ x, const float* __restrict__ off,
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
  const T* xb =
      R == Reduce::kCount ? nullptr : x + (size_t)b * g.xh * g.xw * g.xc;
  const int per_pixel = R == Reduce::kCopy ? g.xc : 1;
  for (int i = threadIdx.x; i < g.br * g.w * per_pixel; i += blockDim.x) {
    const int ch = i % per_pixel, p = i / per_pixel;
    const int r = p / g.w, c = p % g.w;
    float acc = 0.f;
    for (int gy = ylo; gy <= yhi; ++gy) {
      for (int gx = xlo; gx <= xhi; ++gx) {
        if (R == Reduce::kCount) {
          acc += 1.f;
          continue;
        }
        const T* px = xb + ((size_t)(g.row0 + rb * g.row_step + gy + r) * g.xw
                             + (g.col0 + gx + c)) * g.xc;
        if (R == Reduce::kSumChannels) {
          float s = 0.f;
          for (int k = 0; k < g.xc; ++k) s += load(px + k);
          acc += s;
        } else {
          acc += load(px + ch);
        }
      }
    }
    if (R == Reduce::kSumChannels) acc = round_bf16(acc);
    float* o = out + (((size_t)b * g.n_rb * g.br + rb * g.br + r) * g.w + c)
                         * g.nc;
    if (R == Reduce::kCopy) {
      o[ch] = acc;
    } else {
      for (int j = 0; j < g.nc; ++j) o[j] = acc;
    }
  }
}

// ------------------------------------------------------- field reads

enum class Field {
  kBroadcast,   // k2: dy of tile (b, rb), not clipped, broadcast to O
  kShiftIfMax,  // p3: x + trunc(min x) where max x > 0.5, else 0
};

template <Field F>
__global__ void __launch_bounds__(kThreads)
field_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
             Tiles t) {
  if (F == Field::kBroadcast) {
    const int b = blockIdx.x / t.n_rb, rb = blockIdx.x % t.n_rb;
    const float* dy = in + ((size_t)b * 18 + 4) * t.h() * t.w
                      + (size_t)rb * t.pixels();
    float* o = out + t.at(b, rb, 0, 0, t.o);
    for (int i = threadIdx.x; i < t.pixels() * t.o; i += blockDim.x)
      o[i] = dy[i / t.o];
  } else {
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

// kb, k4/kd, ke, kf/kg: the tile's bounds, cut to [kYMin, kYMax] and
// [kXMin, kXMax]; every channel (kf, kg) or channel 0 broadcast to O
template <bool kAllChannels, bool kRowBlock, bool kXLoop, int kYMin,
          int kYMax, int kXMin, int kXMax>
__global__ void __launch_bounds__(kThreads)
hat_sampler_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                   float* __restrict__ out, Tiles t) {
  const int b = blockIdx.x / t.n_rb, rb = blockIdx.x % t.n_rb;
  const Bounds bd = tile_bounds(off, t.h(), t.w, t.br, b, rb);
  const int ylo = max(bd.ylo, kYMin), yhi = min(bd.yhi, kYMax);
  const int xlo = max(bd.xlo, kXMin), xhi = min(bd.xhi, kXMax);
  const bf16* xb = x + (size_t)b * t.hp() * t.wp() * t.c;
  const size_t plane = (size_t)t.h() * t.w;
  const int nch = kAllChannels ? t.c : 1;
  for (int i = threadIdx.x; i < t.pixels() * nch; i += blockDim.x) {
    const int ch = i % nch, p = i / nch;
    const int r = p / t.w, c = p % t.w;
    const size_t pix = (size_t)(rb * t.br + r) * t.w + c;
    const float dy = clip(off[((size_t)b * 18 + 4) * plane + pix]);
    const float dx = clip(off[((size_t)b * 18 + 5) * plane + pix]);
    const float acc = hat_sum<kRowBlock, kXLoop>(
        xb, t, rb, r, c, ch, dy, dx, ylo, yhi, xlo, xhi);
    if (kAllChannels) {
      out[t.at(b, rb, r, c, t.c) + ch] = acc;
    } else {
      float* o = out + t.at(b, rb, r, c, t.o);
      for (int j = 0; j < t.o; ++j) o[j] = acc;
    }
  }
}

// ------------------------------------------------------- contractions

enum class Tap {
  kHat,     // k5: bf16(k4's sample of every channel * mask channel 3)
  kScaled,  // p4: bf16(x[row0 + r, col0 + c, :] * bf16(scale))
};

// p4's window: rows x cols pixels at (row0, col0) of x (xh, xw, k)
struct TapWindow {
  int xh, xw, row0, col0, rows, cols;
  float scale;
};

// One block per tile (k5) or the one window (p4): the bf16 tap of its
// pixels (pixels x k) goes to shared memory, then out[p, n] = sum_k
// tap[p, k] * w[k, n] in f32 (a product of two bf16 values is exact in
// f32); w is (k, n), for k5 the taps' w[3] (C, O).
template <Tap P>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const bf16* __restrict__ x, const float* __restrict__ off,
                const float* __restrict__ mask, const bf16* __restrict__ w,
                float* __restrict__ out, Tiles t, TapWindow win, int k, int n) {
  extern __shared__ unsigned short s_raw[];
  bf16* s_tap = reinterpret_cast<bf16*>(s_raw);
  int pixels;
  float* o;
  if (P == Tap::kHat) {
    const int b = blockIdx.x / t.n_rb, rb = blockIdx.x % t.n_rb;
    const Bounds bd = tile_bounds(off, t.h(), t.w, t.br, b, rb);
    const bf16* xb = x + (size_t)b * t.hp() * t.wp() * t.c;
    const size_t plane = (size_t)t.h() * t.w;
    pixels = t.pixels();
    for (int i = threadIdx.x; i < pixels * k; i += blockDim.x) {
      const int ch = i % k, p = i / k;
      const int r = p / t.w, c = p % t.w;
      const size_t pix = (size_t)(rb * t.br + r) * t.w + c;
      const float dy = clip(off[((size_t)b * 18 + 4) * plane + pix]);
      const float dx = clip(off[((size_t)b * 18 + 5) * plane + pix]);
      const float m = mask[((size_t)b * 9 + 3) * plane + pix];
      const float tap = hat_sum<true, true>(
          xb, t, rb, r, c, ch, dy, dx, bd.ylo, bd.yhi, bd.xlo, bd.xhi);
      s_tap[i] = __float2bfloat16_rn(__fmul_rn(tap, m));
    }
    o = out + t.at(b, rb, 0, 0, n);
  } else {
    const float scale = round_bf16(win.scale);
    pixels = win.rows * win.cols;
    for (int i = threadIdx.x; i < pixels * k; i += blockDim.x) {
      const int ch = i % k, p = i / k;
      const int r = p / win.cols, c = p % win.cols;
      const float v = load(x + ((size_t)(win.row0 + r) * win.xw
                                + win.col0 + c) * k + ch);
      s_tap[i] = __float2bfloat16_rn(__fmul_rn(v, scale));
    }
    o = out;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pixels * n; i += blockDim.x) {
    const int j = i % n, p = i / n;
    const bf16* a = s_tap + (size_t)p * k;
    float acc = 0.f;
    for (int kk = 0; kk < k; ++kk)
      acc = fmaf(__bfloat162float(a[kk]), load(w + (size_t)kk * n + j), acc);
    o[(size_t)p * n + j] = acc;
  }
}

// ------------------------------------------------------------ launches

Tiles make_tiles(int batch, int n_rb, int br, int w, int c, int o, int pad) {
  return Tiles{batch, n_rb, br, w, c, o, pad};
}

int launched() { return (int)cudaGetLastError(); }

template <typename T, Reduce R, Loop L>
int launch_windows(const void* x, const float* off, float* out,
                   const Windows& g, cudaStream_t stream) {
  window_sum_kernel<T, R, L><<<g.batch * g.n_rb, kThreads, 0, stream>>>(
      static_cast<const T*>(x), off, out, g);
  return launched();
}

// the windows of a tile probe of tiles t: rows row0 + rb*row_step + gy + r,
// columns col0 + gx + c of x (B, HP, WP, C); O outputs
Windows tile_windows(const Tiles& t, int row0, int row_step, int col0) {
  return Windows{t.batch, t.n_rb, t.br, t.w, t.hp(), t.wp(), t.c, t.o,
                 row0, row_step, col0, 0, 0};
}

template <bool kAllChannels, bool kRowBlock, bool kXLoop,
          int kYMin = -kOpen, int kYMax = kOpen, int kXMin = -kOpen,
          int kXMax = kOpen>
int launch_hat(const void* x, const float* off, float* out, const Tiles& t,
               cudaStream_t stream) {
  hat_sampler_kernel<kAllChannels, kRowBlock, kXLoop, kYMin, kYMax, kXMin,
                     kXMax>
      <<<t.batch * t.n_rb, kThreads, 0, stream>>>(
          static_cast<const bf16*>(x), off, out, t);
  return launched();
}

template <Tap P>
int launch_contract(const void* x, const float* off, const float* mask,
                    const void* w, float* out, const Tiles& t,
                    const TapWindow& win, int k, int n, int blocks,
                    int pixels, cudaStream_t stream) {
  const size_t smem = (size_t)pixels * k * sizeof(bf16);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        contract_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  contract_kernel<P><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), off, mask, static_cast<const bf16*>(w),
      out, t, win, k, n);
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
  return launch_windows<bf16, Reduce::kSumChannels, Loop::kFixed>(
      x, off, out, tile_windows(TILES, 3, br, 2), stream);
}
TILE_PROBE(k2) {
  field_kernel<Field::kBroadcast>
      <<<batch * n_rb, kThreads, 0, stream>>>(off, out, 0, TILES);
  return launched();
}
TILE_PROBE(k3) {  // no row-block term
  return launch_windows<bf16, Reduce::kChannel0, Loop::kTileY>(
      x, off, out, tile_windows(TILES, pad, 0, pad), stream);
}
TILE_PROBE(k4) {
  return launch_hat<false, true, true>(x, off, out, TILES, stream);
}
TILE_PROBE(k5) {
  return launch_contract<Tap::kHat>(
      x, off, mask, static_cast<const bf16*>(w) + 3 * c * o, out, TILES,
      TapWindow{}, c, o, batch * n_rb, br * wd, stream);
}
TILE_PROBE(ka) {
  return launch_windows<bf16, Reduce::kCount, Loop::kTileYX>(
      x, off, out, tile_windows(TILES, pad, br, pad), stream);
}
TILE_PROBE(kb) {  // no row-block term, no x loop
  return launch_hat<false, false, false>(x, off, out, TILES, stream);
}
TILE_PROBE(kc) {
  return launch_windows<bf16, Reduce::kChannel0, Loop::kTileY>(
      x, off, out, tile_windows(TILES, pad, br, pad), stream);
}
TILE_PROBE(kd) {  // k4's function: its device code
  return launch_hat<false, true, true>(x, off, out, TILES, stream);
}
TILE_PROBE(ke) {  // gy cut to [-2, 2]
  return launch_hat<false, true, true, -2, 2>(x, off, out, TILES, stream);
}
TILE_PROBE(kf) {  // every channel, gx cut to GX_RANGE = [-9, 10]
  return launch_hat<true, true, true, -kOpen, kOpen, -9, 10>(
      x, off, out, TILES, stream);
}
TILE_PROBE(kg) {  // kf's function (its roll never wraps): its device code
  return launch_hat<true, true, true, -kOpen, kOpen, -9, 10>(
      x, off, out, TILES, stream);
}

#undef TILES
#undef TILE_PROBE

// p1: out (rows, cols, d2) = x[g:g+rows, g+1:g+1+cols, :] of x f32
// (d0, d1, d2)
extern "C" int cfd_probe_p1(const float* x, float* out, int d0, int d1,
                            int d2, int g, int rows, int cols,
                            cudaStream_t stream) {
  return launch_windows<float, Reduce::kCopy, Loop::kFixed>(
      x, nullptr, out,
      Windows{1, 1, rows, cols, d0, d1, d2, d2, g, 0, g + 1, 0, 0}, stream);
}

// p2: out (rows, l) = sum over lo <= i < hi of x[i:i+rows, :], x f32 (n, l)
// read as (n, 1, l)
extern "C" int cfd_probe_p2(const float* x, float* out, int n, int l, int lo,
                            int hi, int rows, cudaStream_t stream) {
  return launch_windows<float, Reduce::kCopy, Loop::kFixed>(
      x, nullptr, out, Windows{1, 1, rows, 1, n, 1, l, l, 0, 0, 0, lo, hi - 1},
      stream);
}

// p3: out = x + trunc(min x) where max x > 0.5, else 0; x f32 of n
// elements, one block
extern "C" int cfd_probe_p3(const float* x, float* out, int n,
                            cudaStream_t stream) {
  field_kernel<Field::kShiftIfMax><<<1, kThreads, 0, stream>>>(x, out, n,
                                                               Tiles{});
  return launched();
}

// p4: out (rows*cols, n) = bf16(x[row0:row0+rows, col0:col0+cols, :] *
// bf16(scale)) as (rows*cols, k) @ w (k, n), x bf16 (xh, xw, k), w bf16
extern "C" int cfd_probe_p4(const void* x, const void* w, float* out, int xh,
                            int xw, int k, int n, int row0, int col0,
                            int rows, int cols, float scale,
                            cudaStream_t stream) {
  return launch_contract<Tap::kScaled>(
      x, nullptr, nullptr, w, out, Tiles{},
      TapWindow{xh, xw, row0, col0, rows, cols, scale}, k, n, 1, rows * cols,
      stream);
}
