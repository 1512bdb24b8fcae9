// The front end shared by the two DCNv2 forward kernels, dcn_fwd.cu (float32
// on the CUDA cores) and dcn_fwd_bf16.cu (bf16 on the tensor cores): a
// modulated 3x3 stride-1 deformable convolution of a channels-last x.
//
// Decomposition (the plain model is ops/dcn.py:deform_conv2d_tiled_plain,
// the plan ops/dcn.py:dcn_fwd_plan):
// - Pixel tiles of kP pixels are cut from the flattened B*H*W, so a tile may
//   straddle two images and only the last tile is ragged. A block owns one
//   pixel tile and kNO output channels: every O <= 256 is one output tile,
//   so each pixel's 9 taps are sampled once per call.
// - The 9*C contraction rows (row c*9 + k, the order of the (O, C, 3, 3)
//   weight) are walked in groups of kGC channels. Where the pixel tiles
//   give fewer than 264 blocks (two per SM of an H100's 132; the wrapper's
//   plan decides and passes `splits`, with its tiles, which run() holds
//   against the engine's), blockIdx.z splits the groups into
//   `splits` contiguous ranges; each split writes its float32 partial sums
//   (split, O, B*H*W) and dcn_fwd_reduce_kernel sums them in split order,
//   adds the bias and rounds once: no float atomics, the output is bitwise
//   reproducible.
// - Prologue: each (tap, pixel) of the tile gets the NHWC row of x of its
//   top-left corner and its 4 mask-folded bilinear weights (m * wy * wx,
//   zero for a corner outside the image) in shared memory, once.
// - The gather: per (pixel, tap, 16-byte channel vector) item, 4 corner
//   vectors of the NHWC x (8 bf16 or 4 float32 channels a load), weighted
//   and summed in float32 and stored in the tap tile A (pixel x the group's
//   9 * kGC rows) as the engine's type (bf16 rounds each tap once, the
//   rounding of K1 before its dot). The vector index runs fastest over the
//   lanes, so the lanes of one (pixel, tap) read one corner's kGC channels
//   as one contiguous segment. A thread issues the loads of kBatch items
//   before it uses the first, so many loads are in flight.
// - The pipeline: one tap tile and a ring of kStages weight stages of kKB
//   rows each, filled by cp.async straight from the (O, C, 3, 3) tensor
//   (one output channel's (c, tap) rows are contiguous) kStages - 1 steps
//   ahead, across groups: while a step is contracted the next stages are in
//   flight, and the first stages of a group land while its gather runs.
//   One barrier a step. Gather and contraction overlap across the blocks
//   of an SM where two fit (every tile but the bf16 256-channel one, which
//   runs one block per SM and so gathers and contracts in series), not
//   inside a block. The variant that overlaps inside a block,
//   Overlapped<E> below (a second tap tile, the next group gathered
//   during the current group's steps), holds one block per SM and is
//   slower at every node shape it covers on the H100
//   (tools/compare_kernels.py --overlap; PERF.md).
// - The engine (the .cu files) contracts a step and writes the tile out
//   through shared memory, coalesced along the pixels: to the NCHW output
//   (bias added, one rounding) or, when split, to its partial.
// Any C works: where C is not a multiple of the vector width (or a pointer
// is not 16-byte aligned) the wrapper passes vec = 0 and the gather and the
// weight stages take a masked per-channel path.
// The row origin: offset and mask may hold Ho <= H rows, the output rows
// [row0, row0 + Ho) of the op on the whole x (a rank's rows of a
// height-sharded map, models/layers.py): output row h samples as row
// row0 + h, x is read whole and the output has Ho rows. Pixel tiles cut
// the B*Ho*W output pixels. With row0 = 0 and Ho = H every index and
// every value is the op's own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcn_fwd {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// channel j of a 16-byte vector of T, widened to float32 (exact)
template <typename T>
__device__ __forceinline__ float lane_f32(const uint4& v, int j);
template <>
__device__ __forceinline__ float lane_f32<float>(const uint4& v, int j) {
  const unsigned w = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float lane_f32<__nv_bfloat16>(const uint4& v,
                                                          int j) {
  const int q = j >> 1;
  const unsigned w = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the bits of one value of T, in the low bits
__device__ __forceinline__ unsigned bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past src_bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// cp.async.wait_group n: all but the n most recent groups of copies landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

template <typename T>
struct Params {
  const T* x;            // (B, H, W, C) channels-last
  const float* offset;   // (B, 18, Ho, W)
  const float* mask;     // (B, 9, Ho, W)
  const T* weight;       // (O, C, 3, 3)
  const T* bias;         // (O,) or null
  T* out;                // (B, O, Ho, W)
  float* partial;        // (splits, O, B*Ho*W) float32 when splits > 1
  // hw, npix: the output's Ho*W and B*Ho*W; xhw, xpix: x's H*W and B*H*W
  int C, H, W, O, hw, npix, xhw, xpix, row0, groups, groups_per_split,
      splits, vec;
  float max_offset;
};

// Corner tables of a tile, for tap k of pixel p at t = p * 9 + k: wgt[t]
// the mask-folded bilinear weights of the corners (cy, cx) = (0, 0),
// (0, 1), (1, 0), (1, 1) (0 outside the image or past the last pixel), and
// row[t] the NHWC row of x (b * H * W + y * W + x, y counted from x's
// first row) of corner (0, 0); the
// others lie 1, W and W + 1 rows on (a corner outside the image has weight
// 0, and its row is clamped into x). 20 bytes a (pixel, tap).
template <int kP>
struct Tables {
  float4 wgt[9 * kP];
  int row[9 * kP];
};

template <int kP, typename T>
__device__ __forceinline__ void build_tables(Tables<kP>& tab,
                                             const Params<T>& prm, int p0) {
  for (int t = threadIdx.x; t < 9 * kP; t += kThreads) {
    const int k = t / kP;
    const int pix = p0 + t % kP;
    int row = 0;
    float wgt[4] = {0.f, 0.f, 0.f, 0.f};
    if (pix < prm.npix) {
      const int b = pix / prm.hw;
      const int q = pix - b * prm.hw;
      const int h = q / prm.W;
      const int w = q - h * prm.W;
      float dy = prm.offset[((size_t)b * 18 + 2 * k) * prm.hw + q];
      float dx = prm.offset[((size_t)b * 18 + 2 * k + 1) * prm.hw + q];
      if (prm.max_offset >= 0.f) {
        dy = fminf(fmaxf(dy, -prm.max_offset), prm.max_offset);
        dx = fminf(fmaxf(dx, -prm.max_offset), prm.max_offset);
      }
      const float m = prm.mask[((size_t)b * 9 + k) * prm.hw + q];
      const float py = (float)(prm.row0 + h + k / 3 - 1) + dy;
      const float px = (float)(w + k % 3 - 1) + dx;
      const float fy = floorf(py);
      const float fx = floorf(px);
      const float ly = py - fy;
      const float lx = px - fx;
      const int y0 = (int)fy;
      const int x0 = (int)fx;
      bool any = false;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int cy = corner >> 1;
        const int cx = corner & 1;
        const int yy = y0 + cy;
        const int xx = x0 + cx;
        if (yy >= 0 && yy < prm.H && xx >= 0 && xx < prm.W) {
          wgt[corner] = m * (cy ? ly : 1.f - ly) * (cx ? lx : 1.f - lx);
          any = true;
        }
      }
      // y0 in [-1, H - 1] and x0 in [-1, W - 1] where a corner is inside
      if (any) row = b * prm.xhw + y0 * prm.W + x0;
    }
    const int at = (t % kP) * 9 + k;
    tab.row[at] = row;
    tab.wgt[at] = make_float4(wgt[0], wgt[1], wgt[2], wgt[3]);
  }
}

// The gather of one group of kGC channels into the tap tile A[kP][kLdA] of
// TA (row c * 9 + k of the group's channel c and tap k). Items are
// (pixel, tap, vector of kV channels) with the vector fastest, so the kGV
// lanes of one (pixel, tap) read one corner's kGC channels as contiguous
// 16-byte vectors. A thread takes kPerThread items in batches of kBatch:
// all 4 * kBatch corner loads of a batch are issued before the first is
// used, so that many loads are in flight.
template <typename T, typename TA, int kP, int kGC, int kLdA, int kBatch>
struct Gather {
  static constexpr int kV = 16 / sizeof(T);  // channels per 16-byte vector
  static constexpr int kGV = kGC / kV;       // vectors per (pixel, tap)
  static constexpr int kItems = kP * 9 * kGV;
  static constexpr int kPerThread = kItems / kThreads;
  static constexpr int kBatches = kPerThread / kBatch;  // a group's
  static_assert(kGC % kV == 0, "a group is whole vectors");
  static_assert(kPerThread * kThreads == kItems &&
                    kPerThread % kBatch == 0,
                "whole batches of items a thread");

  // item it: vector v of (pixel, tap) t = p * 9 + k
  __device__ __forceinline__ static void item(int it, int& t, int& v) {
    v = it % kGV;
    t = it / kGV;
  }

  // the kV channels from c of NHWC row `row`, zero past C
  __device__ __forceinline__ static uint4 load(const Params<T>& prm, int row,
                                               int c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c >= prm.C) return v;
    const T* src = prm.x + (size_t)row * prm.C + c;
    if (prm.vec) return __ldg(reinterpret_cast<const uint4*>(src));
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (c + j < prm.C)
        w[j * 4 / kV] |= bits(src[j]) << (kV == 8 ? 16 * (j & 1) : 0);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // batches b0 .. b1 - 1 of the group at channel c0 into the tile `a`
  __device__ __forceinline__ static void run(const Tables<kP>& tab,
                                             const Params<T>& prm, int c0,
                                             TA* a, int b0, int b1) {
#pragma unroll 1
    for (int n0 = b0 * kBatch; n0 < b1 * kBatch; n0 += kBatch) {
      uint4 raw[kBatch][4];
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        int t, v;
        item((n0 + n) * kThreads + threadIdx.x, t, v);
        const int row = tab.row[t];
        const int c = c0 + v * kV;
        const int last = prm.xpix - 1;
        raw[n][0] = load(prm, min(max(row, 0), last), c);
        raw[n][1] = load(prm, min(max(row + 1, 0), last), c);
        raw[n][2] = load(prm, min(max(row + prm.W, 0), last), c);
        raw[n][3] = load(prm, min(max(row + prm.W + 1, 0), last), c);
      }
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        int t, v;
        item((n0 + n) * kThreads + threadIdx.x, t, v);
        const float4 w = tab.wgt[t];
        const int p = t / 9;
        TA* dst = a + p * kLdA + v * kV * 9 + (t - p * 9);
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          const float s = w.x * lane_f32<T>(raw[n][0], c) +
                          w.y * lane_f32<T>(raw[n][1], c) +
                          w.z * lane_f32<T>(raw[n][2], c) +
                          w.w * lane_f32<T>(raw[n][3], c);
          dst[c * 9] = from_f32<TA>(s);
        }
      }
    }
  }
};

// One stage of the weight ring: B[o][r] = weight[o0 + o][c0 * 9 + r0 + r]
// for the kKB rows from r0 of the group at channel c0, zero past O and past
// C. On the vector path by cp.async in 16-byte pieces (a piece lies wholly
// inside or outside C, since C, c0 and r0 are multiples of the vector
// width); else element-wise.
template <typename T, int kNO, int kKB, int kLdB>
__device__ __forceinline__ void load_weight(T* bt, const Params<T>& prm,
                                            int o0, int c0, int r0) {
  const int valid = (prm.C - c0) * 9 - r0;  // rows of the stage inside C
  if (prm.vec) {
    constexpr int kEl = 16 / sizeof(T);  // elements per piece
    constexpr int kPieces = kKB / kEl;
    static_assert(kKB % kEl == 0, "rows are whole pieces");
    for (int t = threadIdx.x; t < kNO * kPieces; t += kThreads) {
      const int o = t / kPieces;
      const int r = (t - o * kPieces) * kEl;
      const bool in = o0 + o < prm.O && r < valid;
      const T* src =
          prm.weight + (in ? (size_t)(o0 + o) * prm.C * 9 + c0 * 9 + r0 + r
                           : 0);
      cp_async16(bt + o * kLdB + r, src, in ? 16 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < kNO * kKB; t += kThreads) {
      const int o = t / kKB;
      const int r = t - o * kKB;
      bt[o * kLdB + r] =
          (o0 + o < prm.O && r < valid)
              ? prm.weight[(size_t)(o0 + o) * prm.C * 9 + c0 * 9 + r0 + r]
              : from_f32<T>(0.f);
    }
  }
}

// Writes one output value of the tile: to the NCHW output with the bias and
// one rounding, or to this split's float32 partial.
template <typename T>
__device__ __forceinline__ void write_out(const Params<T>& prm, int o,
                                          int pix, float v) {
  if (prm.splits > 1) {
    prm.partial[((size_t)blockIdx.z * prm.O + o) * prm.npix + pix] = v;
    return;
  }
  if (prm.bias) v += to_f32(prm.bias[o]);
  const int b = pix / prm.hw;
  prm.out[((size_t)b * prm.O + o) * prm.hw + (pix - b * prm.hw)] =
      from_f32<T>(v);
}

// Engine E with its corner loads in flight during its contraction inside
// the block (E::kOverlap): two tap tiles, and the gather of the next group
// cut into batches interleaved with the current group's contraction steps.
// Twice the tap tile holds one block per SM, and the bf16 256-channel tile
// does not fit at all. The kernels run E itself, two blocks per SM for most
// tiles, whose gather and contraction overlap across the blocks of an SM,
// and are faster; this variant stays so that the comparison can be rerun
// (ops/dcn.py FWD_OVERLAP, tools/compare_kernels.py --overlap). Same
// values in the same order: the output is bitwise that of E.
template <class E>
struct Overlapped : E {
  static constexpr bool kOverlap = true;
  static constexpr int kABytes = 2 * E::kABytes;
  static constexpr int kMinBlocks = 1;
};

// The kernel: tables, then per group of kGC channels the gather into the
// tap tile and E::kSteps steps of kKB weight rows, each contracted by
// engine E from a ring of E::kStages weight stages that cp.async fills
// kStages - 1 steps ahead (across groups, so the first stages of a group
// land while its gather runs). One barrier a step. With E::kOverlap the
// next group is gathered into the other tap tile during the steps.
template <class E>
__global__ void __launch_bounds__(kThreads, E::kMinBlocks)
    dcn_fwd_kernel(const Params<typename E::T> prm) {
  using T = typename E::T;
  using TA = typename E::TA;
  extern __shared__ __align__(128) unsigned char smem[];
  auto& tab = *reinterpret_cast<Tables<E::kP>*>(smem);
  TA* a_tile = reinterpret_cast<TA*>(smem + sizeof(Tables<E::kP>));
  T* b_ring = reinterpret_cast<T*>(smem + sizeof(Tables<E::kP>) +
                                   E::kABytes);
  constexpr int kStageEl = E::kBBytes / sizeof(T);

  const int p0 = blockIdx.x * E::kP;
  const int o0 = blockIdx.y * E::kNO;
  const int first = blockIdx.z * prm.groups_per_split;
  const int groups = max(0, min(prm.groups - first, prm.groups_per_split));
  const int steps = groups * E::kSteps;
  E engine;

  // weight stage s: group s / kSteps, rows from (s % kSteps) * kKB
  auto issue = [&](int s) {
    if (s < steps) {
      const int g = s / E::kSteps;
      load_weight<T, E::kNO, E::kKB, E::kLdB>(
          b_ring + (s % E::kStages) * kStageEl, prm, o0,
          (first + g) * E::kGC, (s - g * E::kSteps) * E::kKB);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < E::kStages - 1; ++s) issue(s);
  build_tables<E::kP>(tab, prm, p0);
  __syncthreads();

  using G = Gather<T, TA, E::kP, E::kGC, E::kLdA, E::kBatch>;
  constexpr int kTile = E::kP * E::kLdA;  // elements of a tap tile
  if constexpr (E::kOverlap) G::run(tab, prm, first * E::kGC, a_tile, 0,
                                    G::kBatches);
  for (int g = 0; g < groups; ++g) {
    TA* tile = a_tile + (E::kOverlap ? (g & 1) * kTile : 0);
    if constexpr (!E::kOverlap)
      G::run(tab, prm, (first + g) * E::kGC, tile, 0, G::kBatches);
    for (int j = 0; j < E::kSteps; ++j) {
      const int s = g * E::kSteps + j;
      cp_async_wait<E::kStages - 2>();  // stage s landed
      __syncthreads();  // ... for every thread; the tile is written; the
                        // slot of stage s - 1 (and with kOverlap the other
                        // tile, from step 0 on) is free
      issue(s + E::kStages - 1);
      if constexpr (E::kOverlap) {
        if (g + 1 < groups)
          G::run(tab, prm, (first + g + 1) * E::kGC,
                 a_tile + (~g & 1) * kTile, j * G::kBatches / E::kSteps,
                 (j + 1) * G::kBatches / E::kSteps);
      }
      engine.contract(tile, j * E::kKB,
                      b_ring + (s % E::kStages) * kStageEl);
    }
    if constexpr (!E::kOverlap) __syncthreads();  // the tile is read
                                                  // before the next gather
  }
  if constexpr (E::kOverlap) __syncthreads();  // before the epilogue
  cp_async_wait<0>();
  engine.epilogue(prm, smem, p0, o0);
}

// Sums the splits' partials in split order, adds the bias, rounds once and
// writes the NCHW output, coalesced along the pixels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_reduce_kernel(const float* __restrict__ partial,
                          const T* __restrict__ bias, T* __restrict__ out,
                          int O, int hw, int npix, int splits) {
  const size_t n = (size_t)O * npix;
  for (size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (size_t)gridDim.x * kThreads) {
    const int o = (int)(t / npix);
    const int pix = (int)(t - (size_t)o * npix);
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * n + t];
    if (bias) v += to_f32(bias[o]);
    const int b = pix / hw;
    out[((size_t)b * O + o) * hw + (pix - b * hw)] = from_f32<T>(v);
  }
}

// x (B, C, HW) -> (B, HW, C) through 32 x 32 shared-memory tiles; T is a
// plain type of the element's size (unsigned short for bf16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_nhwc_kernel(const T* __restrict__ x, T* __restrict__ xh, int C,
                        int hw) {
  __shared__ T tile[32][33];
  const size_t base = (size_t)blockIdx.z * C * hw;
  const int q0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    const int q = q0 + threadIdx.x;
    if (c < C && q < hw) tile[r][threadIdx.x] = x[base + (size_t)c * hw + q];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int q = q0 + r;
    const int c = c0 + threadIdx.x;
    if (c < C && q < hw) xh[base + (size_t)q * C + c] = tile[threadIdx.x][r];
  }
}

template <typename T>
int launch_nhwc(const void* x, void* xh, int B, int C, int hw,
                void* stream) {
  if (B <= 0 || C <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((hw + 31) / 32, (C + 31) / 32, B);
  dcn_fwd_nhwc_kernel<T><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xh), C, hw);
  return (int)cudaGetLastError();
}

// Launches engine E's kernel and, when split, the reduction; returns the
// CUDA error of the launches (0 on success).
template <class E>
int launch_engine(const Params<typename E::T>& prm, void* stream) {
  using T = typename E::T;
  constexpr int kSmem = (int)sizeof(Tables<E::kP>) + E::kABytes +
                        E::kStages * E::kBBytes;
  static_assert(kSmem <= 232448, "shared memory of one block");
  static unsigned configured = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(dcn_fwd_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid((prm.npix + E::kP - 1) / E::kP,
                  (prm.O + E::kNO - 1) / E::kNO, prm.splits);
  dcn_fwd_kernel<E><<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess || prm.splits == 1) return (int)err;
  const size_t n = (size_t)prm.O * prm.npix;
  const int blocks = (int)min((n + kThreads - 1) / kThreads, (size_t)4096);
  dcn_fwd_reduce_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      prm.partial, prm.bias, prm.out, prm.O, prm.hw, prm.npix, prm.splits);
  return (int)cudaGetLastError();
}

// Checks the shape, the split and the caller's plan (tile_p pixels,
// tile_o output channels, groups of `group` channels: ops/dcn.py's
// dcn_fwd_plan, which must cut as engine E does), fills Params and
// launches, on `stream`: the channels-last copy of x into xh where xh is
// given (x is then NCHW; else x is channels-last), engine E's kernel and,
// when split, the reduction. Returns the CUDA error of the launches (0 on
// success; cudaErrorInvalidValue for a plan that is not E's).
template <class E, typename U>
int run(const void* x, void* xh, const float* offset, const float* mask,
        const void* weight, const void* bias, void* out, float* partial,
        int B, int C, int H, int W, int Ho, int row0, int O, int tile_p,
        int tile_o, int group, int splits, int vec, float max_offset,
        void* stream) {
  using T = typename E::T;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || splits <= 0 ||
      Ho <= 0 || row0 < 0 || row0 + Ho > H ||
      (long long)B * H * W >= (1LL << 31) || (splits > 1 && !partial) ||
      tile_p != E::kP || tile_o != E::kNO || group != E::kGC)
    return (int)cudaErrorInvalidValue;
  const int groups = (C + E::kGC - 1) / E::kGC;
  const int groups_per_split = (groups + splits - 1) / splits;
  if (groups_per_split * (splits - 1) >= groups)
    return (int)cudaErrorInvalidValue;  // an empty split: not the plan's
  if (xh) {
    const int err = launch_nhwc<U>(x, xh, B, C, H * W, stream);
    if (err) return err;
    x = xh;
  }
  Params<T> prm;
  prm.x = static_cast<const T*>(x);
  prm.offset = offset;
  prm.mask = mask;
  prm.weight = static_cast<const T*>(weight);
  prm.bias = static_cast<const T*>(bias);
  prm.out = static_cast<T*>(out);
  prm.partial = partial;
  prm.C = C;
  prm.H = H;
  prm.W = W;
  prm.O = O;
  prm.hw = Ho * W;
  prm.npix = B * Ho * W;
  prm.xhw = H * W;
  prm.xpix = B * H * W;
  prm.row0 = row0;
  prm.groups = groups;
  prm.groups_per_split = groups_per_split;
  prm.splits = splits;
  prm.vec = vec;
  prm.max_offset = max_offset;
  return launch_engine<E>(prm, stream);
}

}  // namespace dcn_fwd
