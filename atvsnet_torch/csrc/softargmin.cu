// Fused soft-argmin over the depth axis, for Hopper (sm_90a).
//
//   depth[b, p] = sum_d sweep[b, d] * softmax_d(-cost[b, d, p]),  p = y * w + x,
//   sweep[b, d] = start[b] + d * interval[b]
//
// Replaces the Pallas TPU kernel atvsnet_tpu/ops/softargmin.py:_kernel, which held a
// (D, rows, W) block in on-chip memory and reduced it in several passes.
//
// Bound: bytes. Per cost element the kernel does ~6 fp32 operations and moves 4 bytes (2
// for bf16), far below the ~20 fp32 operations per byte of device memory that an H100
// can do. The volume is read exactly once and only the depth is written, so what decides
// the time is how many bytes are in flight and whether every SM has work: at 3.35 TB/s
// and 0.6-0.9 us of memory latency the card wants 2-3 MB outstanding at any moment.
//
// Design, in answer to that:
//  - A block owns a tile of kTile = 64 adjacent pixels and all of D. Its 128 threads form
//    kSlices groups of kLanes lanes; each group takes a contiguous slice of D and each
//    lane a packet of adjacent pixels, so a block is a (slice, lane) grid over (D, tile):
//    8 slices x 16 lanes for fp32, 16 x 8 for bf16. The (1,128,120,224) volume makes 420
//    blocks, all resident at once on 132 SMs (8 blocks per SM at <= 64 registers).
//  - Aligned path: a packet is 16 bytes of one plane (4 fp32 or 8 bf16 pixels) fetched
//    with one streaming load (ld.global.cs: the volume is read once). It needs the base
//    pointer and the plane stride h*w*elem_size to be multiples of 16 bytes. The scalar
//    path is the same code with one-pixel packets and takes everything else.
//  - Loads do not wait on arithmetic. A lane walks its slice in chunks of kChunk planes
//    (128 bytes per lane) and starts the whole chunk's loads before the first exponent.
//    At D = 128 a slice is two chunks and a block has 16 KB in flight, 128 KB per SM.
//  - Each lane keeps the online-softmax triple (max, sum, weighted sum) per pixel in
//    registers. The triples of the slices are combined through shared memory by one thread
//    per pixel, and the tile's depths are written 16 bytes per lane on the aligned path.
//  - A chunk or slice whose planes are all +inf (max of -cost = -inf) contributes
//    (-inf, 0, 0): every exponent is taken against finite_or_zero(max), never as
//    -inf - -inf. Pixels whose planes are all +inf give 0/0 = NaN, as a softmax does.
//  - Each exponent is one multiply by log2(e) and one ex2.approx, taken of the difference
//    to the max, instead of libm's longer expf sequence.
//  - The sweep value is rebuilt as start + d * interval with unfused multiply and add, so
//    that it rounds like the plain PyTorch version.
//
// The file also holds the backward kernel (below: the gradient with respect to the cost),
// built on the same tiling, packets and exponent, and the two entry points of a D split
// across the ranks of a 'depth' mesh axis (atvsnet_torch/parallel/depth.py), which the
// TPU package leaves to XLA's partitioner around the same Pallas kernel:
//  - the partial forward: this kernel with the global index of the slice's first plane
//    (`offset`) added to every sweep index, writing the merged triple of its slices
//    (max, sum, weighted sum) per pixel instead of their ratio; the wrapper merges the
//    ranks' triples;
//  - the stats-fed backward: the backward's second pass alone, its reference point and
//    sum read from the merged ones.
// Both are bound by bytes, as the whole-D kernels are: the partial forward reads its slice
// once and writes 12 bytes per pixel; the stats-fed backward reads its slice once (no first
// pass: the merged stats come in) and writes its gradient.
//
// Plain C interface for ctypes; the wrapper (atvsnet_torch/ops/softargmin.py) checks
// shapes, dtypes and contiguity, picks the path and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // pixels per block
constexpr int kThreads = 128;     // threads per block
constexpr int kMinBlocks = 8;     // blocks per SM that the register budget must allow
constexpr int kChunkBytes = 128;  // bytes a lane of the aligned path loads before it computes

// What one lane loads from one plane: Raw is the load's type, kPix the pixels it holds,
// kChunk the planes loaded before any arithmetic.
template <typename Raw> struct Packet;
template <> struct Packet<float4> {          // aligned fp32
  static constexpr int kPix = 4, kChunk = kChunkBytes / 16;
};
template <> struct Packet<uint4> {           // aligned bf16, two pixels per 32-bit word
  static constexpr int kPix = 8, kChunk = kChunkBytes / 32;
};
template <> struct Packet<float> {           // scalar fp32
  static constexpr int kPix = 1, kChunk = 8;
};
template <> struct Packet<unsigned short> {  // scalar bf16, as its bits
  static constexpr int kPix = 1, kChunk = 8;
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const float& r, float (&v)[1]) { v[0] = r; }
__device__ __forceinline__ void unpack(const unsigned short& r, float (&v)[1]) {
  v[0] = bf16_bits_to_float(r);
}

// exp(x) for x = -cost - max <= 0. The difference is taken first, in the cost's own
// units, so its rounding error scales with the distance to the max and not with the cost;
// then one multiply by log2(e) and the hardware's ex2.approx (relative error 2^-22), in
// place of libm's longer expf sequence.
__device__ __forceinline__ float exp_of(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The reference point of every exponent: the max, or 0 while no finite value was seen.
__device__ __forceinline__ float finite_or_zero(float m) { return m == -INFINITY ? 0.f : m; }

// Online-softmax state of kPix pixels: running max of -cost, sum of exp(-cost - max) and
// the same sum weighted by the sweep value.
template <int kPix> struct Triple {
  float m[kPix], sum[kPix], num[kPix];
};

// Fold kChunk planes into the state. v[j][p] is -cost of plane d0 + j at pixel p, or -inf
// for a plane beyond the slice; s0 and step rebuild that plane's sweep value.
template <int kPix, int kChunk>
__device__ __forceinline__ void fold(Triple<kPix>& t, const float (&v)[kChunk][kPix],
                                     int d0, float s0, float step) {
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    float cm = t.m[p];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cm = fmaxf(cm, v[j][p]);
    const float ref = finite_or_zero(cm);
    // rescale what was summed against the old max; exp(-inf - ref) = 0 while it was empty
    const float r = exp_of(t.m[p] - ref);
    float sum = t.sum[p] * r, num = t.num[p] * r;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float e = exp_of(v[j][p] - ref);
      // start + d * interval, rounded like the plain version (no fma)
      const float sw = __fadd_rn(s0, __fmul_rn((float)(d0 + j), step));
      sum += e;
      num = __fadd_rn(num, __fmul_rn(sw, e));
    }
    t.m[p] = cm; t.sum[p] = sum; t.num[p] = num;
  }
}

// The kSlices triples of tile pixel px in shared memory, merged into one: the max, and
// the two sums taken against finite_or_zero of it.
template <int kSlices>
__device__ __forceinline__ void combine(const float (&part)[3][kSlices][kTile], int px,
                                        float& m, float& sum, float& num) {
  m = -INFINITY;
#pragma unroll
  for (int s = 0; s < kSlices; ++s) m = fmaxf(m, part[0][s][px]);
  const float ref = finite_or_zero(m);
  sum = 0.f;
  num = 0.f;
#pragma unroll
  for (int s = 0; s < kSlices; ++s) {
    const float w = exp_of(part[0][s][px] - ref);  // 0 for a slice that saw only +inf
    sum += part[1][s][px] * w;
    num += part[2][s][px] * w;
  }
}

// Write value v of tile pixel o (o = blockIdx.x * kTile + threadIdx.x, one per thread of
// the first kTile). With packets (kPix > 1) four neighbours hand their values to one lane,
// which writes 16 bytes: B*h*w is then a multiple of 4, so a group of four is all inside
// or all outside. Every thread of the two warps must call it (shuffles).
template <int kPix>
__device__ __forceinline__ void store_tile(float* __restrict__ out, float v, uint32_t o,
                                           uint32_t total) {
  if constexpr (kPix > 1) {
    const float v1 = __shfl_down_sync(0xffffffffu, v, 1);
    const float v2 = __shfl_down_sync(0xffffffffu, v, 2);
    const float v3 = __shfl_down_sync(0xffffffffu, v, 3);
    if (threadIdx.x % 4 == 0 && o < total)
      __stcs(reinterpret_cast<float4*>(out + o), make_float4(v, v1, v2, v3));
  } else {
    if (o < total) out[o] = v;
  }
}

// kPartial = false: out is the depth (B, HW). kPartial = true: out is (3, B, HW), the
// triple of planes offset .. offset + D - 1 of a longer sweep (the partial forward).
template <typename Raw, bool kPartial>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
softargmin_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                  const float* __restrict__ interval, float* __restrict__ out,
                  int B, int D, int HW, int offset) {
  constexpr int kPix = Packet<Raw>::kPix;
  constexpr int kChunk = Packet<Raw>::kChunk;
  constexpr int kLanes = kTile / kPix;        // lanes that cover one plane of the tile
  constexpr int kSlices = kThreads / kLanes;  // slices of D, one per group of kLanes threads
  static_assert(kTile % 32 == 0 && kThreads >= kTile && kThreads % kLanes == 0 && kChunk >= 1,
                "tile, block and packet sizes do not fit");
  __shared__ __align__(16) float part[3][kSlices][kTile];

  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const uint32_t total = (uint32_t)B * HW;   // the wrapper keeps B*D*h*w below 2^31
  // First pixel of this lane's packet, flat over (B, h*w). On the aligned path h*w is a
  // multiple of kPix, so a packet lies inside one sample and is all inside or all outside.
  const uint32_t pix0 = blockIdx.x * kTile + lane * kPix;

  Triple<kPix> t;
#pragma unroll
  for (int p = 0; p < kPix; ++p) { t.m[p] = -INFINITY; t.sum[p] = 0.f; t.num[p] = 0.f; }

  if (pix0 < total) {
    const int b = (int)(pix0 / (uint32_t)HW);
    const int per = (D + kSlices - 1) / kSlices;
    const int begin = min(D, slice * per);
    const int end = min(D, begin + per);
    const int64_t stride = HW / kPix;         // plane stride in packets
    const Raw* src = cost + ((int64_t)b * D * HW + (pix0 - (uint32_t)b * HW)) / kPix;
    const float s0 = start[b];
    const float step = interval[b];

    for (int d0 = begin; d0 < end; d0 += kChunk) {
      Raw raw[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        raw[j] = (d0 + j < end) ? __ldcs(src + (int64_t)(d0 + j) * stride) : Raw{};
      float v[kChunk][kPix];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        unpack(raw[j], v[j]);
#pragma unroll
        for (int p = 0; p < kPix; ++p) v[j][p] = (d0 + j < end) ? -v[j][p] : -INFINITY;
      }
      fold<kPix, kChunk>(t, v, offset + d0, s0, step);
    }
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    part[0][slice][lane * kPix + p] = t.m[p];
    part[1][slice][lane * kPix + p] = t.sum[p];
    part[2][slice][lane * kPix + p] = t.num[p];
  }
  __syncthreads();

  // The first kTile threads combine the slices, one pixel each, and write the depth (or
  // the triple) 16 bytes per lane on the aligned path.
  if (threadIdx.x < kTile) {
    const uint32_t o = blockIdx.x * kTile + threadIdx.x;
    float m, sum, num;
    combine<kSlices>(part, threadIdx.x, m, sum, num);
    if constexpr (kPartial) {
      store_tile<kPix>(out, m, o, total);
      store_tile<kPix>(out + total, sum, o, total);
      store_tile<kPix>(out + 2 * (int64_t)total, num, o, total);
    } else {
      store_tile<kPix>(out, num / sum, o, total);
    }
  }
}

// ---------------------------------------------------------------------------------------
// Backward: the vector-Jacobian product with respect to the cost,
//
//   dcost[b, d, p] = -g[b, p] * prob[b, d, p] * (sweep[b, d] - depth[b, p]),
//   prob = softmax_d(-cost),  depth = the forward's output,  g = the incoming gradient.
//
// Replaces what jax.vjp derives from the XLA formula in atvsnet_tpu/ops/softargmin.py:
// _fused_bwd (the TPU package has no Pallas backward: pallas_call is not differentiable).
//
// Bound: bytes, as the forward: ~8 operations per element against 4 bytes read and 4
// written (2 and 2 for bf16). Design, the forward's tiling again: a block owns 64 pixels
// and all of D, its 128 threads are kSlices groups of lanes, each group a slice of D.
//  - Pass 1: each lane folds its slice into (max, sum of exp) per pixel, as the forward
//    folds, with the same finite_or_zero rule, so planes of +inf cost get probability 0
//    and gradient 0. The slices are combined in shared memory into the reference point of
//    the exponents and g / sum per pixel.
//  - Pass 2: each lane reads its slice again and writes the gradient, in the cost's dtype
//    (bf16 rounded to nearest even, as a cast in PyTorch). A block's tile is D x 64 pixels
//    (32 KB at D = 128 in fp32) and is read again a few microseconds after pass 1, so the
//    second read is served by the 50 MB L2 at the main path's shapes: the first pass loads
//    with the default caching, the second with ld.global.cs (last use).
//  - A pixel whose planes are all +inf gets NaN in every plane, as a softmax gives it.
// ---------------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t float_to_bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;  // NaN, as PyTorch writes it
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;         // round to nearest even
}

__device__ __forceinline__ void pack(const float (&v)[4], float4& r) {
  r = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float (&v)[8], uint4& r) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = float_to_bf16_bits(v[2 * i]) | (float_to_bf16_bits(v[2 * i + 1]) << 16);
  r = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void pack(const float (&v)[1], float& r) { r = v[0]; }
__device__ __forceinline__ void pack(const float (&v)[1], unsigned short& r) {
  r = (unsigned short)float_to_bf16_bits(v[0]);
}

// The backward's second pass for one lane: planes begin .. end - 1 of its slice (sweep
// indices offset + d), from the per-pixel reference point, g / sum and depth. The cost is
// read for the last time (ld.global.cs) and the gradient written in the cost's dtype.
template <typename Raw, int kPix, int kChunk>
__device__ __forceinline__ void write_gradient(const Raw* __restrict__ src, Raw* __restrict__ dst,
                                               int begin, int end, int64_t stride, float s0,
                                               float step, int offset, const float (&ref)[kPix],
                                               const float (&scale)[kPix],
                                               const float (&dep)[kPix]) {
  for (int d0 = begin; d0 < end; d0 += kChunk) {
    Raw raw[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      raw[j] = (d0 + j < end) ? __ldcs(src + (int64_t)(d0 + j) * stride) : Raw{};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (d0 + j >= end) break;
      float c[kPix], out[kPix];
      unpack(raw[j], c);
      // start + d * interval, rounded like the plain version (no fma)
      const float sw = __fadd_rn(s0, __fmul_rn((float)(offset + d0 + j), step));
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const float e = exp_of(-c[p] - ref[p]);
        out[p] = -(scale[p] * e) * (sw - dep[p]);
      }
      Raw packed;
      pack(out, packed);
      __stcs(dst + (int64_t)(d0 + j) * stride, packed);
    }
  }
}

// 4 blocks per SM (<= 128 registers): pass 2 holds a chunk of loads and three values per
// pixel; the main path's volumes make at most 3.2 blocks per SM (420 on 132 SMs).
template <typename Raw>
__global__ void __launch_bounds__(kThreads, 4)
softargmin_backward_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                           const float* __restrict__ interval, const float* __restrict__ depth,
                           const float* __restrict__ grad_depth, Raw* __restrict__ grad_cost,
                           int B, int D, int HW) {
  constexpr int kPix = Packet<Raw>::kPix;
  constexpr int kChunk = Packet<Raw>::kChunk;
  constexpr int kLanes = kTile / kPix;
  constexpr int kSlices = kThreads / kLanes;
  __shared__ __align__(16) float part[2][kSlices][kTile];  // per slice: max, sum
  __shared__ float stat[3][kTile];                          // per pixel: ref, g / sum, depth

  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const uint32_t total = (uint32_t)B * HW;
  const uint32_t pix0 = blockIdx.x * kTile + lane * kPix;
  const bool active = pix0 < total;

  int begin = 0, end = 0;
  int64_t stride = 0, offset = 0;
  float s0 = 0.f, step = 0.f;
  float m[kPix], sum[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) { m[p] = -INFINITY; sum[p] = 0.f; }

  if (active) {
    const int b = (int)(pix0 / (uint32_t)HW);
    const int per = (D + kSlices - 1) / kSlices;
    begin = min(D, slice * per);
    end = min(D, begin + per);
    stride = HW / kPix;
    offset = ((int64_t)b * D * HW + (pix0 - (uint32_t)b * HW)) / kPix;
    s0 = start[b];
    step = interval[b];
    const Raw* src = cost + offset;
    for (int d0 = begin; d0 < end; d0 += kChunk) {
      Raw raw[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        raw[j] = (d0 + j < end) ? __ldg(src + (int64_t)(d0 + j) * stride) : Raw{};
      float v[kChunk][kPix];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        unpack(raw[j], v[j]);
#pragma unroll
        for (int p = 0; p < kPix; ++p) v[j][p] = (d0 + j < end) ? -v[j][p] : -INFINITY;
      }
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        float cm = m[p];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) cm = fmaxf(cm, v[j][p]);
        const float ref = finite_or_zero(cm);
        float s = sum[p] * exp_of(m[p] - ref);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s += exp_of(v[j][p] - ref);
        m[p] = cm;
        sum[p] = s;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    part[0][slice][lane * kPix + p] = m[p];
    part[1][slice][lane * kPix + p] = sum[p];
  }
  __syncthreads();

  if (threadIdx.x < kTile) {
    const uint32_t o = blockIdx.x * kTile + threadIdx.x;
    float mm = -INFINITY;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) mm = fmaxf(mm, part[0][s][threadIdx.x]);
    const float ref = finite_or_zero(mm);
    float ss = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
      ss += part[1][s][threadIdx.x] * exp_of(part[0][s][threadIdx.x] - ref);
    const bool in = o < total;
    stat[0][threadIdx.x] = ref;
    stat[1][threadIdx.x] = in ? grad_depth[o] / ss : 0.f;  // 0 / 0 = NaN if all planes are +inf
    stat[2][threadIdx.x] = in ? depth[o] : 0.f;
  }
  __syncthreads();
  if (!active) return;

  float ref[kPix], scale[kPix], dep[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    ref[p] = stat[0][lane * kPix + p];
    scale[p] = stat[1][lane * kPix + p];
    dep[p] = stat[2][lane * kPix + p];
  }
  write_gradient<Raw, kPix, kChunk>(cost + offset, grad_cost + offset, begin, end, stride, s0,
                                    step, 0, ref, scale, dep);
}

// The stats-fed backward of a D split: the slice's planes are offset .. offset + D - 1 of
// the sweep, and stats (2, B, HW) holds the merged max and sum of every rank's planes, so
// the per-pixel reference point and g / sum come in and one pass writes the gradient.
// Same grid, packets and paths as the backward; no shared memory, no barrier.
template <typename Raw>
__global__ void __launch_bounds__(kThreads, 4)
softargmin_backward_stats_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                                 const float* __restrict__ interval,
                                 const float* __restrict__ stats, const float* __restrict__ depth,
                                 const float* __restrict__ grad_depth, Raw* __restrict__ grad_cost,
                                 int B, int D, int HW, int offset) {
  constexpr int kPix = Packet<Raw>::kPix;
  constexpr int kChunk = Packet<Raw>::kChunk;
  constexpr int kLanes = kTile / kPix;
  constexpr int kSlices = kThreads / kLanes;

  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const uint32_t total = (uint32_t)B * HW;
  const uint32_t pix0 = blockIdx.x * kTile + lane * kPix;
  if (pix0 >= total) return;

  const int b = (int)(pix0 / (uint32_t)HW);
  const int per = (D + kSlices - 1) / kSlices;
  const int begin = min(D, slice * per);
  const int end = min(D, begin + per);
  const int64_t elem = ((int64_t)b * D * HW + (pix0 - (uint32_t)b * HW)) / kPix;
  float ref[kPix], scale[kPix], dep[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    ref[p] = finite_or_zero(stats[pix0 + p]);
    scale[p] = grad_depth[pix0 + p] / stats[total + pix0 + p];  // NaN if all planes are +inf
    dep[p] = depth[pix0 + p];
  }
  write_gradient<Raw, kPix, kChunk>(cost + elem, grad_cost + elem, begin, end, HW / kPix,
                                    start[b], interval[b], offset, ref, scale, dep);
}

// An empty launch of the grid a soft-argmin call uses: its device time is what a launch
// costs before any byte moves.
__global__ void __launch_bounds__(kThreads) noop_kernel() {}

unsigned grid_blocks(int B, int HW) {
  return (unsigned)(((int64_t)B * HW + kTile - 1) / kTile);
}

template <typename Vec, typename Scalar, bool kPartial>
int launch(const void* cost, const void* start, const void* interval, void* out,
           int B, int D, int HW, int offset, int aligned, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = grid_blocks(B, HW);
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  if (!aligned) {
    softargmin_kernel<Scalar, kPartial><<<blocks, kThreads, 0, stream>>>(
        (const Scalar*)cost, s, i, (float*)out, B, D, HW, offset);
    return (int)cudaGetLastError();
  }
  // 16-byte loads and stores fault on anything else
  if ((uintptr_t)cost % 16 || (uintptr_t)out % 16 || ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  softargmin_kernel<Vec, kPartial><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)cost, s, i, (float*)out, B, D, HW, offset);
  return (int)cudaGetLastError();
}

template <typename Vec, typename Scalar>
int launch_backward(const void* cost, const void* start, const void* interval, const void* depth,
                    const void* grad_depth, void* grad_cost, int B, int D, int HW, int aligned,
                    void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = grid_blocks(B, HW);
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  const float* d = (const float*)depth;
  const float* g = (const float*)grad_depth;
  if (!aligned) {
    softargmin_backward_kernel<Scalar><<<blocks, kThreads, 0, stream>>>(
        (const Scalar*)cost, s, i, d, g, (Scalar*)grad_cost, B, D, HW);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)cost % 16 || (uintptr_t)grad_cost % 16 || ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  softargmin_backward_kernel<Vec><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)cost, s, i, d, g, (Vec*)grad_cost, B, D, HW);
  return (int)cudaGetLastError();
}

template <typename Vec, typename Scalar>
int launch_backward_stats(const void* cost, const void* start, const void* interval,
                          const void* stats, const void* depth, const void* grad_depth,
                          void* grad_cost, int B, int D, int HW, int offset, int aligned,
                          void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = grid_blocks(B, HW);
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  const float* st = (const float*)stats;
  const float* d = (const float*)depth;
  const float* g = (const float*)grad_depth;
  if (!aligned) {
    softargmin_backward_stats_kernel<Scalar><<<blocks, kThreads, 0, stream>>>(
        (const Scalar*)cost, s, i, st, d, g, (Scalar*)grad_cost, B, D, HW, offset);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)cost % 16 || (uintptr_t)grad_cost % 16 || ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  softargmin_backward_stats_kernel<Vec><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)cost, s, i, st, d, g, (Vec*)grad_cost, B, D, HW, offset);
  return (int)cudaGetLastError();
}

}  // namespace

// cost (B, D, HW) contiguous, start and interval (B,) fp32, out (B, HW) fp32. `aligned`
// selects the 16-byte path; its conditions are checked here again. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_f32(const void* cost, const void* start, const void* interval,
                                      void* out, int B, int D, int HW, int aligned,
                                      void* stream) {
  return launch<float4, float, false>(cost, start, interval, out, B, D, HW, 0, aligned, stream);
}

extern "C" int atvsnet_softargmin_bf16(const void* cost, const void* start, const void* interval,
                                       void* out, int B, int D, int HW, int aligned,
                                       void* stream) {
  return launch<uint4, unsigned short, false>(cost, start, interval, out, B, D, HW, 0, aligned,
                                              stream);
}

// The partial forward of a D split: cost (B, D, HW) holds planes offset .. offset + D - 1
// of the sweep; out (3, B, HW) fp32 gets the max of -cost, the sum of exp(-cost - ref) and
// the same sum weighted by the sweep, ref = finite_or_zero(max). `aligned` as above, with
// out's pointer checked. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_partial_f32(const void* cost, const void* start,
                                              const void* interval, void* out, int B, int D,
                                              int HW, int offset, int aligned, void* stream) {
  return launch<float4, float, true>(cost, start, interval, out, B, D, HW, offset, aligned,
                                     stream);
}

extern "C" int atvsnet_softargmin_partial_bf16(const void* cost, const void* start,
                                               const void* interval, void* out, int B, int D,
                                               int HW, int offset, int aligned, void* stream) {
  return launch<uint4, unsigned short, true>(cost, start, interval, out, B, D, HW, offset,
                                             aligned, stream);
}

// The backward: cost (B, D, HW) as the forward's; depth and grad_depth (B, HW) fp32;
// grad_cost (B, D, HW) in the cost's dtype. `aligned` as above, with grad_cost's pointer
// checked too. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_backward_f32(const void* cost, const void* start,
                                               const void* interval, const void* depth,
                                               const void* grad_depth, void* grad_cost, int B,
                                               int D, int HW, int aligned, void* stream) {
  return launch_backward<float4, float>(cost, start, interval, depth, grad_depth, grad_cost, B,
                                        D, HW, aligned, stream);
}

extern "C" int atvsnet_softargmin_backward_bf16(const void* cost, const void* start,
                                                const void* interval, const void* depth,
                                                const void* grad_depth, void* grad_cost, int B,
                                                int D, int HW, int aligned, void* stream) {
  return launch_backward<uint4, unsigned short>(cost, start, interval, depth, grad_depth,
                                                grad_cost, B, D, HW, aligned, stream);
}

// The stats-fed backward of a D split: cost (B, D, HW) as the partial forward's; stats
// (2, B, HW) the merged max and sum; depth and grad_depth (B, HW) fp32; grad_cost
// (B, D, HW) in the cost's dtype. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_backward_stats_f32(const void* cost, const void* start,
                                                     const void* interval, const void* stats,
                                                     const void* depth, const void* grad_depth,
                                                     void* grad_cost, int B, int D, int HW,
                                                     int offset, int aligned, void* stream) {
  return launch_backward_stats<float4, float>(cost, start, interval, stats, depth, grad_depth,
                                              grad_cost, B, D, HW, offset, aligned, stream);
}

extern "C" int atvsnet_softargmin_backward_stats_bf16(const void* cost, const void* start,
                                                      const void* interval, const void* stats,
                                                      const void* depth, const void* grad_depth,
                                                      void* grad_cost, int B, int D, int HW,
                                                      int offset, int aligned, void* stream) {
  return launch_backward_stats<uint4, unsigned short>(cost, start, interval, stats, depth,
                                                      grad_depth, grad_cost, B, D, HW, offset,
                                                      aligned, stream);
}

extern "C" int atvsnet_softargmin_noop(int B, int HW, void* stream) {
  noop_kernel<<<grid_blocks(B, HW), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
