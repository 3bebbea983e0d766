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
//    When autograd records the call, the same threads also write the combined max and sum
//    (the softmax statistics, 8 bytes per pixel) for the backward below.
//  - A chunk or slice whose planes are all +inf (max of -cost = -inf) contributes
//    (-inf, 0, 0): every exponent is taken against finite_or_zero(max), never as
//    -inf - -inf. Pixels whose planes are all +inf give 0/0 = NaN, as a softmax does.
//  - Each exponent is one multiply by log2(e) and one ex2.approx, taken of the difference
//    to the max, instead of libm's longer expf sequence.
//  - The sweep value is rebuilt as start + d * interval with unfused multiply and add, so
//    that it rounds like the plain PyTorch version.
//
// The file also holds the gradient kernel (below: one streaming pass from those
// statistics) and the partial forward of a D split across the ranks of a 'depth' mesh
// axis (atvsnet_torch/parallel/depth.py; its own kernel, further below). The gradient
// kernel serves the split too, from the merged statistics.
//
// Plain C interface for ctypes; the wrapper (atvsnet_torch/ops/softargmin.py) checks
// shapes, dtypes and contiguity, picks the path and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// Fold kChunk planes into the state. v[j][p] is -cost of plane d0 + j * kStride at pixel
// p, or -inf for a plane beyond the slice; s0 and step rebuild that plane's sweep value.
template <int kPix, int kChunk, int kStride = 1>
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
      const float sw = __fadd_rn(s0, __fmul_rn((float)(d0 + j * kStride), step));
      sum += e;
      num = __fadd_rn(num, __fmul_rn(sw, e));
    }
    t.m[p] = cm; t.sum[p] = sum; t.num[p] = num;
  }
}

// Merge n triples, (m, s, n) of triple k at a + k * step, b + k * step, c + k * step: the
// max, and the two sums taken against finite_or_zero of it, in the order of k.
__device__ __forceinline__ void merge_triples(const float* a, const float* b, const float* c,
                                              int n, int step, float& m, float& s, float& num) {
  m = -INFINITY;
#pragma unroll
  for (int k = 0; k < n; ++k) m = fmaxf(m, a[k * step]);
  const float ref = finite_or_zero(m);
  s = 0.f;
  num = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float w = exp_of(a[k * step] - ref);  // 0 for a triple that saw only +inf
    s += b[k * step] * w;
    num += c[k * step] * w;
  }
}

// Write value v of pixel o (one per thread, o % 4 == threadIdx.x % 4; o >= total writes
// nothing). With packets (kPix > 1) four neighbours hand their values to one lane, which
// writes 16 bytes: B*h*w is then a multiple of 4, so a group of four is all inside or all
// outside. Every lane of the warp must call it (shuffles).
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

// What the forward writes: the depth (B, HW); or the depth and the statistics (2, B, HW),
// the max of -cost and the sum of exp(-cost - finite_or_zero(max)).
enum Out { kDepth, kDepthStats };

template <typename Raw, int kOut>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
softargmin_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                  const float* __restrict__ interval, float* __restrict__ out,
                  float* __restrict__ stats, int B, int D, int HW) {
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
      fold<kPix, kChunk>(t, v, d0, s0, step);
    }
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    part[0][slice][lane * kPix + p] = t.m[p];
    part[1][slice][lane * kPix + p] = t.sum[p];
    part[2][slice][lane * kPix + p] = t.num[p];
  }
  __syncthreads();

  // The first kTile threads combine the slices, one pixel each, and write the depth (and
  // the statistics) 16 bytes per lane on the aligned path.
  if (threadIdx.x < kTile) {
    const uint32_t o = blockIdx.x * kTile + threadIdx.x;
    float m, sum, num;
    merge_triples(&part[0][0][threadIdx.x], &part[1][0][threadIdx.x], &part[2][0][threadIdx.x],
                  kSlices, kTile, m, sum, num);
    store_tile<kPix>(out, num / sum, o, total);
    if constexpr (kOut == kDepthStats) {
      store_tile<kPix>(stats, m, o, total);
      store_tile<kPix>(stats + total, sum, o, total);
    }
  }
}


// ---------------------------------------------------------------------------------------
// Gradient: the vector-Jacobian product with respect to the cost,
//
//   dcost[b, d, p] = -(g[b, p] / sum[b, p]) * exp(-cost[b, d, p] - ref[b, p])
//                    * (sweep[b, offset + d] - depth[b, p]),
//
// g the incoming gradient, depth the forward's output and (max, sum) the softmax
// statistics, ref = finite_or_zero(max). One kernel serves both entry points: the whole
// volume (offset 0, with the statistics that the forward kernel wrote beside the depth)
// and a rank's slice of a D split (offset = the slice's first plane, with the ranks'
// merged statistics).
//
// Replaces what jax.vjp derives from the XLA formula in atvsnet_tpu/ops/softargmin.py:
// _fused_bwd (the TPU package has no Pallas backward: pallas_call is not differentiable).
//
// Bound: bytes. ~6 operations per element against the cost read once and its gradient
// written once (4 + 4 bytes, 2 + 2 for bf16), and 16 bytes of per-pixel maps. Design, in
// answer to that:
//  - With the statistics in hand nothing is reduced over D: an element's gradient needs
//    its own cost and four values of its pixel. So the kernel is one streaming pass, with
//    no shared memory, no barrier and no second read of the cost.
//  - Grid: 2-D, (tiles of kGradLanes packets) x (chunks of D). A block is kGradWarps warps
//    over one tile: a lane owns one packet (16 bytes of a plane on the aligned path, one
//    element on the scalar path), and the warps take the chunk's planes in turn (warp w
//    planes w, w + kGradWarps, ...). A thread loads its packet's per-pixel terms once and
//    reuses them over its planes; the block's other warps find the same terms in L1, so
//    each chunk reads the 16 bytes of per-pixel maps from L2 once per pixel. The chunk
//    follows from the volume and the SM count (read once per device): about
//    kGradThreadsPerSM threads per SM in one wave, at least one plane per warp. At 132 SMs
//    the train shape (1,32,32,40) bf16 spreads over 5 x 8 blocks, one plane per thread;
//    (1,128,120,224) fp32 over 210 x 3 blocks of 43 planes, ~11 per thread.
//  - Loads: a thread starts kGradUnroll 16-byte streaming loads (ld.global.cs: the cost is
//    read for the last time) before its first exponent, the first batch together with the
//    per-pixel terms (16-byte loads on the aligned path): 128 bytes per thread, ~64 KB per
//    SM in flight, against the ~18 KB that 3.35 TB/s at ~0.7 us of latency asks of each of
//    132 SMs.
//  - Stores: 16-byte streaming stores (st.global.cs), bf16 rounded to nearest even as a
//    cast in PyTorch.
//  - No shared memory and no TMA: nothing is shared between threads and nothing is read
//    twice, so staging the cost through shared memory, by hand or by bulk copies, adds a
//    hop and buys nothing. The per-pixel maps that the chunks of a tile share come from L2.
//  - +inf planes: exp(-inf) = 0 gives probability 0 and gradient 0. A pixel whose planes
//    are all +inf has max -inf and sum 0, so g / sum is inf and its depth NaN: NaN in every
//    plane, as a softmax gives it.
// ---------------------------------------------------------------------------------------

constexpr int kGradLanes = 32;           // packets per block of the gradient kernel
constexpr int kGradWarps = 4;            // warps per block, taking its planes in turn
constexpr int kGradThreadsPerSM = 512;   // threads per SM that one wave of its grid aims at
constexpr int kGradUnroll = 8;           // planes whose loads a thread starts together
constexpr int kMaxDevices = 64;

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

// Start the loads of planes d0 + j * kStep, j < kN (those before end), of one packet.
template <int kStep, typename Raw, int kN>
__device__ __forceinline__ void load_planes(Raw (&raw)[kN], const Raw* __restrict__ src,
                                            int d0, int end, int64_t stride) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = d0 + j * kStep;
    raw[j] = d < end ? __ldcs(src + (int64_t)d * stride) : Raw{};
  }
}

// kPix values of a per-pixel map from p: 16-byte loads for packets of 4 or 8 pixels (p is
// then 16-byte aligned: the wrapper hands aligned maps to the aligned path).
template <int kPix>
__device__ __forceinline__ void load_map(const float* __restrict__ p, float (&v)[kPix]) {
  if constexpr (kPix % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kPix / 4; ++q) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = r.x; v[4 * q + 1] = r.y; v[4 * q + 2] = r.z; v[4 * q + 3] = r.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) v[i] = __ldg(p + i);
  }
}

// stats (2, B, HW): the max of -cost and the sum; depth, grad_depth (B, HW); the cost and
// its gradient (B, D, HW), of which block (x, y) covers planes y * planes .. + planes - 1.
template <typename Raw>
__global__ void __launch_bounds__(kGradLanes * kGradWarps,
                                  kGradThreadsPerSM / (kGradLanes * kGradWarps))
softargmin_grad_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                       const float* __restrict__ interval, const float* __restrict__ stats,
                       const float* __restrict__ depth, const float* __restrict__ grad_depth,
                       Raw* __restrict__ grad_cost, int B, int D, int HW, int offset,
                       int planes) {
  constexpr int kPix = Packet<Raw>::kPix;
  const uint32_t total = (uint32_t)B * HW;   // the wrapper keeps B*D*h*w below 2^31
  // First pixel of this thread's packet, flat over (B, h*w); on the aligned path h*w is a
  // multiple of kPix, so a packet lies inside one sample.
  const uint32_t pix0 = (blockIdx.x * kGradLanes + threadIdx.x) * kPix;
  const int begin = blockIdx.y * planes + threadIdx.y;   // this warp's first plane
  const int end = min(D, (int)blockIdx.y * planes + planes);
  if (pix0 >= total || begin >= end) return;
  const int b = (int)(pix0 / (uint32_t)HW);
  const int64_t stride = HW / kPix;          // plane stride in packets
  const int64_t elem = ((int64_t)b * D * HW + (pix0 - (uint32_t)b * HW)) / kPix;
  const Raw* src = cost + elem;
  Raw* dst = grad_cost + elem;

  float mx[kPix], total_sum[kPix], g[kPix], dep[kPix];
  load_map<kPix>(stats + pix0, mx);
  load_map<kPix>(stats + total + pix0, total_sum);
  load_map<kPix>(grad_depth + pix0, g);
  load_map<kPix>(depth + pix0, dep);
  Raw raw[kGradUnroll];
  load_planes<kGradWarps>(raw, src, begin, end, stride);  // in flight with the per-pixel terms
  const float s0 = start[b];
  const float step = interval[b];
  float ref[kPix], scale[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    ref[p] = finite_or_zero(mx[p]);
    scale[p] = g[p] / total_sum[p];  // inf, and the depth NaN, where every plane is +inf
  }

  for (int d0 = begin;;) {
#pragma unroll
    for (int j = 0; j < kGradUnroll; ++j) {
      const int d = d0 + j * kGradWarps;
      if (d >= end) break;
      float c[kPix], out[kPix];
      unpack(raw[j], c);
      // start + d * interval, rounded like the plain version (no fma)
      const float sw = __fadd_rn(s0, __fmul_rn((float)(offset + d), step));
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const float e = exp_of(-c[p] - ref[p]);
        out[p] = -(scale[p] * e) * (sw - dep[p]);
      }
      Raw packed;
      pack(out, packed);
      __stcs(dst + (int64_t)d * stride, packed);
    }
    d0 += kGradUnroll * kGradWarps;
    if (d0 >= end) break;
    load_planes<kGradWarps>(raw, src, d0, end, stride);
  }
}

// ---------------------------------------------------------------------------------------
// The partial forward of a D split across the ranks of a 'depth' mesh axis: for planes
// offset .. offset + D - 1 of a longer sweep, the online-softmax triple per pixel,
//
//   (max_d -cost[b, d, p],  sum_d exp(-cost - ref),  sum_d sweep[b, offset + d] * exp(...)),
//
// ref = finite_or_zero(max); the wrapper merges the ranks' triples. The TPU package leaves
// this to XLA's partitioner around the Pallas kernel (atvsnet_tpu/ops/softargmin.py:_kernel,
// split by atvsnet_tpu/parallel/pipeline.py:51-71).
//
// Bound: bytes, as the whole-D forward: the slice is read once and 12 bytes a pixel are
// written. At a rank's flagship slice (1,64,120,224) that is 2.15 us of HBM time against a
// launch that costs ~2 us on its own, so what decides the time is the fixed cost of a
// launch and how short the path of one block is from its first load to its last store.
// Design, in answer to that:
//  - Launch: a programmatic dependent launch. The grid is dispatched and every block
//    computes its addresses while the previous kernel in the stream drains; griddepcontrol
//    .wait holds the first read until that kernel has completed. An empty launch of this
//    grid costs about half of a plain one's (PERF.md).
//  - Grid: 2-D, (tiles of kPartLanes packets) x (chunks of D), the chunks of one tile a
//    thread-block cluster of (1, chunks, 1). A block is kPartWarps warps over one tile: a
//    lane owns one packet (16 bytes of a plane on the aligned path, one element on the
//    scalar path) and the warps take the chunk's planes in turn (warp w planes w,
//    w + kPartWarps, ...). Chunks, a power of two up to the portable cluster size of 8, are
//    doubled while the grid stays within one wave of kPartBlocksPerSM blocks per SM and
//    every warp keeps two batches of planes: at 132 SMs (1,64,120,224) is 210 tiles x 2
//    chunks in fp32, 105 x 2 in bf16; a row tile (1,64,120,896) 840 x 1; the train slice
//    (2,16,32,40) 20 x 1 (one batch a warp: a cluster there measured 25% slower). One
//    chunk is launched without a cluster.
//  - Loads: a thread takes its planes in batches of kPartBatch and starts the next batch's
//    16-byte streaming loads (ld.global.cs: the slice is read once) before it folds the
//    current one, so only its first batch waits a whole DRAM round trip. The fold is the
//    whole-D kernel's online-softmax step, ex2.approx and the sweep without fma. Chunk
//    bounds and owners come from shifts, so no division delays the first load.
//  - Merge: within a warp nothing (a lane owns its pixels); across the block's warps one
//    shared-memory step, every thread merging a share of the tile's pixels; across the
//    cluster each block sends its merged triples by st.async into the shared memory of
//    the block that owns each pixel (distributed shared memory), counted on the owner's
//    transaction barrier, and every block merges and writes its share of the tile once
//    its bytes have arrived: one launch, no global scratch, no atomics, no second pass,
//    and no cluster-wide barrier on the way out (a merge through cluster.sync() took a few
//    tenths of a us more). One relaxed cluster arrive at the start, waited for only before
//    the first remote store, makes sure every owner's barrier is initialised.
//  - Stores: 16-byte streaming stores of four neighbouring pixels on the aligned path.
//  - No staging of the slice through shared memory: every byte is read once by the
//    thread that folds it.
//  - +inf planes: a batch, warp or chunk that saw only +inf contributes (-inf, 0, 0), and
//    every exponent is taken against finite_or_zero(max); a pixel whose planes are all +inf
//    gets (-inf, 0, 0).
// ---------------------------------------------------------------------------------------

constexpr int kPartLanes = 32;        // packets per tile
constexpr int kPartWarps = 4;         // warps per block, taking the chunk's planes in turn
constexpr int kPartThreads = kPartLanes * kPartWarps;
constexpr int kPartBlocksPerSM = 4;   // blocks per SM in one wave of the grid
constexpr int kPartBatch = 4;         // planes a thread folds at a time
constexpr int kPartMinBatches = 2;    // batches each warp keeps when D is cut
constexpr int kMaxCluster = 8;        // the portable cluster size

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The same shared-memory address (of this block) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// A transaction barrier in shared memory that completes its first phase once `bytes` have
// arrived by st.async; initialised by one thread, visible to the cluster after a cluster
// barrier.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void wait_bytes(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(bar)
      : "memory");
}

// 16 bytes into another block's shared memory (`addr`, from map_rank), counted on that
// block's transaction barrier `bar` (also from map_rank).
__device__ __forceinline__ void send(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// Store a lane's kPix values of one row at row[lane * kPix ..]: 16 bytes at a time for
// packets, which leaves no bank conflict.
template <int kPix, int kN>
__device__ __forceinline__ void put_packet(float (&row)[kN], int lane, const float (&v)[kPix]) {
  if constexpr (kPix % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kPix / 4; ++q)
      reinterpret_cast<float4*>(&row[lane * kPix])[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPix; ++p) row[lane * kPix + p] = v[p];
  }
}

// Write the triple (m, s, n) of tile pixel o into the three rows of out (3, B*HW), as
// store_tile writes one value; o = total for a lane that has no pixel to write.
template <int kPix>
__device__ __forceinline__ void store_triple(float* __restrict__ out, float m, float s, float n,
                                             uint32_t o, uint32_t total) {
  store_tile<kPix>(out, m, o, total);
  store_tile<kPix>(out + total, s, o, total);
  store_tile<kPix>(out + 2 * (int64_t)total, n, o, total);
}

// Fold one batch of a thread's planes, d + j * kPartWarps (-inf from `end` on), into t.
template <typename Raw, int kPix>
__device__ __forceinline__ void fold_batch(Triple<kPix>& t, const Raw (&raw)[kPartBatch], int d,
                                           int end, int offset, float s0, float step) {
  float v[kPartBatch][kPix];
#pragma unroll
  for (int j = 0; j < kPartBatch; ++j) {
    unpack(raw[j], v[j]);
#pragma unroll
    for (int p = 0; p < kPix; ++p) v[j][p] = (d + j * kPartWarps < end) ? -v[j][p] : -INFINITY;
  }
  fold<kPix, kPartBatch, kPartWarps>(t, v, offset + d, s0, step);
}

// cost (B, D, HW) planes offset .. offset + D - 1; out (3, B, HW). Block (x, y) covers
// tile x and chunk y of D: chunks = gridDim.y (a power of two, the cluster's size) of
// D / chunks planes, the first D % chunks of them one plane more.
template <typename Raw>
__global__ void __launch_bounds__(kPartThreads, kPartBlocksPerSM)
softargmin_partial_kernel(const Raw* __restrict__ cost, const float* __restrict__ start,
                          const float* __restrict__ interval, float* __restrict__ out, int B,
                          int D, int HW, int offset) {
  constexpr int kPix = Packet<Raw>::kPix;
  constexpr int kTilePix = kPartLanes * kPix;     // pixels of one tile
  constexpr int kStep = kPartBatch * kPartWarps;  // planes between a thread's batches
  __shared__ __align__(16) float part[3][kPartWarps][kTilePix];
  __shared__ __align__(16) float4 recv[kTilePix];  // (m, s, n, -) per (chunk, pixel of the share)
  __shared__ __align__(8) uint64_t arrived;        // counts the bytes of recv that arrived

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kPartLanes + lane;
  const int chunks = gridDim.y, chunk = blockIdx.y;
  const int lg_chunks = __ffs(chunks) - 1;   // chunks is a power of two: shifts, no division
  const bool clustered = chunks > 1;         // the same in every block
  const uint32_t recv_addr = (uint32_t)__cvta_generic_to_shared(recv);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&arrived);
  if (clustered) {
    if (tid == 0) expect_bytes(bar, kTilePix * sizeof(float4));
    cluster_arrive_relaxed();   // waited for before the first remote store
  }
  // launched as a programmatic dependent launch: nothing the previous kernel wrote is read
  // before it has completed
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const uint32_t total = (uint32_t)B * HW;   // the wrapper keeps B*D*h*w below 2^31
  const uint32_t tile0 = blockIdx.x * kTilePix;
  // First pixel of this lane's packet, flat over (B, h*w); on the aligned path h*w is a
  // multiple of kPix, so a packet lies inside one sample.
  const uint32_t pix0 = tile0 + lane * kPix;
  const int rem = D & (chunks - 1);
  const int first = chunk * (D >> lg_chunks) + min(chunk, rem);   // this chunk's first plane
  const int end = first + (D >> lg_chunks) + (chunk < rem);
  const int begin = first + warp;                                  // this warp's first plane

  Triple<kPix> t;
#pragma unroll
  for (int p = 0; p < kPix; ++p) { t.m[p] = -INFINITY; t.sum[p] = 0.f; t.num[p] = 0.f; }

  if (pix0 < total && begin < end) {
    const int b = (int)(pix0 / (uint32_t)HW);
    const int64_t stride = HW / kPix;        // plane stride in packets
    const Raw* src = cost + ((int64_t)b * D * HW + (pix0 - (uint32_t)b * HW)) / kPix;
    Raw a[kPartBatch], c[kPartBatch];
    load_planes<kPartWarps>(a, src, begin, end, stride);
    const float s0 = start[b];
    const float step = interval[b];
    // two register buffers in turn: the next batch's loads go out before this one is folded
    for (int d = begin;;) {
      if (d + kStep < end) load_planes<kPartWarps>(c, src, d + kStep, end, stride);
      fold_batch(t, a, d, end, offset, s0, step);
      if ((d += kStep) >= end) break;
      if (d + kStep < end) load_planes<kPartWarps>(a, src, d + kStep, end, stride);
      fold_batch(t, c, d, end, offset, s0, step);
      if ((d += kStep) >= end) break;
    }
  }

  // the warps' triples of each pixel, merged by one thread per pixel
  put_packet(part[0][warp], lane, t.m);
  put_packet(part[1][warp], lane, t.sum);
  put_packet(part[2][warp], lane, t.num);
  __syncthreads();
  if (clustered) cluster_wait();   // every block of the cluster has initialised its barrier
  const int share = kTilePix >> lg_chunks;          // pixels of the tile each chunk writes
  const int lg_share = __ffs(share) - 1;
#pragma unroll
  for (int base = 0; base < kTilePix; base += kPartThreads) {
    const int px = base + tid;
    const bool valid = px < kTilePix;
    float m = -INFINITY, s = 0.f, n = 0.f;
    if (valid)
      merge_triples(&part[0][0][px], &part[1][0][px], &part[2][0][px], kPartWarps, kTilePix, m,
                    s, n);
    if (!clustered) {
      store_triple<kPix>(out, m, s, n, valid ? tile0 + px : total, total);
    } else if (valid) {
      const uint32_t owner = px >> lg_share;
      const uint32_t slot = chunk * share + (px & (share - 1));
      send(map_rank(recv_addr + slot * sizeof(float4), owner), make_float4(m, s, n, 0.f),
           map_rank(bar, owner));
    }
  }
  if (!clustered) return;

  // this block's share of the tile: the chunks' triples merged in chunk order
  if (warp * kPartLanes < share) {
    wait_bytes(bar);   // every chunk's triples of this share have arrived
    const int i = tid;
    const bool valid = i < share;
    float m = -INFINITY, s = 0.f, n = 0.f;
    if (valid) {
      const float* r = reinterpret_cast<const float*>(&recv[i]);
      merge_triples(r, r + 1, r + 2, chunks, 4 * share, m, s, n);
    }
    store_triple<kPix>(out, m, s, n, valid ? tile0 + chunk * share + i : total, total);
  }
}

// An empty launch of the grid a soft-argmin call uses: its device time is what a launch
// costs before any byte moves.
__global__ void noop_kernel() {}

unsigned grid_blocks(int B, int HW) {
  return (unsigned)(((int64_t)B * HW + kTile - 1) / kTile);
}

int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? count[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) count[dev] = n;
  }
  return n > 0 ? n : 1;
}

// The gradient kernel's grid for a volume whose packets hold `pix` pixels: tiles of
// kGradLanes packets, and D cut into as many chunks as bring the grid to about
// kGradThreadsPerSM threads per SM (at least one plane per warp), of `planes` planes each
// but the last.
struct GradGrid {
  unsigned tiles, chunks;
  int planes;
};
GradGrid grad_grid(int B, int D, int HW, int pix) {
  const int64_t packets = ((int64_t)B * HW + pix - 1) / pix;
  const int64_t tiles = std::max<int64_t>(1, (packets + kGradLanes - 1) / kGradLanes);
  const int64_t want = (int64_t)sm_count() * kGradThreadsPerSM / (kGradLanes * kGradWarps);
  const int64_t most = (D + kGradWarps - 1) / kGradWarps;
  const int64_t chunks = std::max<int64_t>(1, std::min<int64_t>(most, (want + tiles - 1) / tiles));
  const int planes = (int)((D + chunks - 1) / chunks);
  return {(unsigned)tiles, (unsigned)((D + planes - 1) / planes), planes};
}

// The partial kernel's grid for a volume whose packets hold `pix` pixels: tiles of
// kPartLanes packets, and D cut into `chunks` (the cluster's size), a power of two up to
// kMaxCluster, doubled while the grid stays within one wave of kPartBlocksPerSM blocks per
// SM and every warp keeps kPartMinBatches batches of planes: the cluster's merge costs
// about what one batch's round trip to memory does, so a cut that leaves a warp a single
// batch saves nothing.
struct PartialGrid {
  unsigned tiles, chunks;
};
PartialGrid partial_grid(int B, int D, int HW, int pix) {
  const int64_t packets = ((int64_t)B * HW + pix - 1) / pix;
  const int64_t tiles = std::max<int64_t>(1, (packets + kPartLanes - 1) / kPartLanes);
  const int64_t want = (int64_t)sm_count() * kPartBlocksPerSM;
  int64_t chunks = 1;
  while (2 * chunks <= kMaxCluster && 2 * chunks * tiles <= want &&
         2 * chunks * kPartWarps * kPartMinBatches * kPartBatch <= D)
    chunks *= 2;
  return {(unsigned)tiles, (unsigned)chunks};
}

// The launch configuration of the partial kernel's grid `g`: a programmatic dependent
// launch, and a cluster of (1, chunks, 1) when D is cut (a cluster launch dispatches its
// blocks more slowly, and a cluster of one has nothing to merge); `attrs` must outlive it.
cudaLaunchConfig_t partial_config(PartialGrid g, cudaLaunchAttribute (&attrs)[2],
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles, g.chunks);
  cfg.blockDim = dim3(kPartLanes, kPartWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 0;
  if (g.chunks > 1) {
    cudaLaunchAttribute& a = attrs[cfg.numAttrs++];
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = 1;
    a.val.clusterDim.y = g.chunks;
    a.val.clusterDim.z = 1;
  }
  cudaLaunchAttribute& a = attrs[cfg.numAttrs++];
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return cfg;
}

// Whether the device can hold at least one cluster of `cfg` for kernel `fn`
// (cudaOccupancyMaxActiveClusters), asked once per device and cluster size.
template <typename Kernel>
cudaError_t cluster_fits(Kernel fn, const cudaLaunchConfig_t& cfg) {
  static int known[kMaxDevices][kMaxCluster + 1] = {};   // 1 fits, -1 refused, 0 not asked
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned size = cfg.gridDim.y;
  int* k = dev < kMaxDevices ? &known[dev][size] : nullptr;
  if (k == nullptr || *k == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) return err;
    if (k == nullptr) return n > 0 ? cudaSuccess : cudaErrorInvalidClusterSize;
    *k = n > 0 ? 1 : -1;
  }
  return *k > 0 ? cudaSuccess : cudaErrorInvalidClusterSize;
}

// Launch the partial kernel's grid; the device is asked first whether it can hold one of
// its clusters.
template <typename Raw>
int launch_partial_grid(const void* cost, const float* s, const float* i, float* out, int B,
                        int D, int HW, int offset, cudaStream_t stream) {
  const PartialGrid g = partial_grid(B, D, HW, Packet<Raw>::kPix);
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = partial_config(g, attrs, stream);
  cudaError_t err = g.chunks > 1 ? cluster_fits(softargmin_partial_kernel<Raw>, cfg) : cudaSuccess;
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, softargmin_partial_kernel<Raw>, (const Raw*)cost, s, i, out,
                             B, D, HW, offset);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(err != cudaSuccess ? err : last);
}

template <typename Vec, typename Scalar>
int launch_partial(const void* cost, const void* start, const void* interval, void* out, int B,
                   int D, int HW, int offset, int aligned, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  if (!aligned)
    return launch_partial_grid<Scalar>(cost, s, i, (float*)out, B, D, HW, offset, stream);
  // 16-byte loads and stores fault on anything else
  if ((uintptr_t)cost % 16 || (uintptr_t)out % 16 || ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return launch_partial_grid<Vec>(cost, s, i, (float*)out, B, D, HW, offset, stream);
}

template <typename Vec, typename Scalar, int kOut>
int launch(const void* cost, const void* start, const void* interval, void* out, void* stats,
           int B, int D, int HW, int aligned, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = grid_blocks(B, HW);
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  if (!aligned) {
    softargmin_kernel<Scalar, kOut><<<blocks, kThreads, 0, stream>>>(
        (const Scalar*)cost, s, i, (float*)out, (float*)stats, B, D, HW);
    return (int)cudaGetLastError();
  }
  // 16-byte loads and stores fault on anything else
  if ((uintptr_t)cost % 16 || (uintptr_t)out % 16 || (uintptr_t)stats % 16 ||
      ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  softargmin_kernel<Vec, kOut><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)cost, s, i, (float*)out, (float*)stats, B, D, HW);
  return (int)cudaGetLastError();
}

template <typename Vec, typename Scalar>
int launch_forward(const void* cost, const void* start, const void* interval, void* out,
                   void* stats, int B, int D, int HW, int aligned, void* stream) {
  if (stats)
    return launch<Vec, Scalar, kDepthStats>(cost, start, interval, out, stats, B, D, HW,
                                            aligned, stream);
  return launch<Vec, Scalar, kDepth>(cost, start, interval, out, nullptr, B, D, HW, aligned,
                                     stream);
}

template <typename Vec, typename Scalar>
int launch_gradient(const void* cost, const void* start, const void* interval, const void* stats,
                    const void* depth, const void* grad_depth, void* grad_cost, int B, int D,
                    int HW, int offset, int aligned, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* s = (const float*)start;
  const float* i = (const float*)interval;
  const float* st = (const float*)stats;
  const float* d = (const float*)depth;
  const float* g = (const float*)grad_depth;
  const dim3 block(kGradLanes, kGradWarps);
  if (!aligned) {
    const GradGrid grid = grad_grid(B, D, HW, 1);
    softargmin_grad_kernel<Scalar><<<dim3(grid.tiles, grid.chunks), block, 0, stream>>>(
        (const Scalar*)cost, s, i, st, d, g, (Scalar*)grad_cost, B, D, HW, offset, grid.planes);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)cost % 16 || (uintptr_t)grad_cost % 16 || (uintptr_t)st % 16 ||
      (uintptr_t)d % 16 || (uintptr_t)g % 16 || ((int64_t)HW * sizeof(Scalar)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const GradGrid grid = grad_grid(B, D, HW, Packet<Vec>::kPix);
  softargmin_grad_kernel<Vec><<<dim3(grid.tiles, grid.chunks), block, 0, stream>>>(
      (const Vec*)cost, s, i, st, d, g, (Vec*)grad_cost, B, D, HW, offset, grid.planes);
  return (int)cudaGetLastError();
}

}  // namespace

// cost (B, D, HW) contiguous, start and interval (B,) fp32, out (B, HW) fp32; stats, when
// not null, (2, B, HW) fp32 gets the max of -cost and the sum of exp(-cost - ref) per
// pixel, ref = finite_or_zero(max). `aligned` selects the 16-byte path; its conditions are
// checked here again. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_f32(const void* cost, const void* start, const void* interval,
                                      void* out, void* stats, int B, int D, int HW, int aligned,
                                      void* stream) {
  return launch_forward<float4, float>(cost, start, interval, out, stats, B, D, HW, aligned,
                                       stream);
}

extern "C" int atvsnet_softargmin_bf16(const void* cost, const void* start, const void* interval,
                                       void* out, void* stats, int B, int D, int HW, int aligned,
                                       void* stream) {
  return launch_forward<uint4, unsigned short>(cost, start, interval, out, stats, B, D, HW,
                                               aligned, stream);
}

// The partial forward of a D split: cost (B, D, HW) holds planes offset .. offset + D - 1
// of the sweep; out (3, B, HW) fp32 gets the max of -cost, the sum of exp(-cost - ref) and
// the same sum weighted by the sweep, ref = finite_or_zero(max). `aligned` as above, with
// out's pointer checked. Returns a cudaError_t: cudaErrorInvalidClusterSize if the device
// cannot hold one cluster of the grid.
extern "C" int atvsnet_softargmin_partial_f32(const void* cost, const void* start,
                                              const void* interval, void* out, int B, int D,
                                              int HW, int offset, int aligned, void* stream) {
  return launch_partial<float4, float>(cost, start, interval, out, B, D, HW, offset, aligned,
                                       stream);
}

extern "C" int atvsnet_softargmin_partial_bf16(const void* cost, const void* start,
                                               const void* interval, void* out, int B, int D,
                                               int HW, int offset, int aligned, void* stream) {
  return launch_partial<uint4, unsigned short>(cost, start, interval, out, B, D, HW, offset,
                                               aligned, stream);
}

// The backward: cost (B, D, HW) holds planes offset .. offset + D - 1 of the sweep (offset
// 0 for the whole volume, the slice's first plane for a rank of a D split); stats
// (2, B, HW) the forward's statistics, or the ranks' merged ones; depth and grad_depth
// (B, HW) fp32; grad_cost (B, D, HW) in the cost's dtype. `aligned` as above, with the
// pointers of grad_cost and of the three maps checked too. Returns a cudaError_t.
extern "C" int atvsnet_softargmin_backward_f32(const void* cost, const void* start,
                                               const void* interval, const void* stats,
                                               const void* depth, const void* grad_depth,
                                               void* grad_cost, int B, int D, int HW,
                                               int offset, int aligned, void* stream) {
  return launch_gradient<float4, float>(cost, start, interval, stats, depth, grad_depth,
                                        grad_cost, B, D, HW, offset, aligned, stream);
}

extern "C" int atvsnet_softargmin_backward_bf16(const void* cost, const void* start,
                                                const void* interval, const void* stats,
                                                const void* depth, const void* grad_depth,
                                                void* grad_cost, int B, int D, int HW,
                                                int offset, int aligned, void* stream) {
  return launch_gradient<uint4, unsigned short>(cost, start, interval, stats, depth, grad_depth,
                                                grad_cost, B, D, HW, offset, aligned, stream);
}

// The gradient kernel's grid for a volume (B, D, HW) whose packets hold `pix` pixels (4 or
// 8 on the aligned path, 1 on the scalar one) on the current device: grid[0] tiles, grid[1]
// chunks of D, grid[2] planes per chunk.
extern "C" int atvsnet_softargmin_grad_grid(int B, int D, int HW, int pix, int* grid) {
  const GradGrid g = grad_grid(B, D, HW, pix);
  grid[0] = (int)g.tiles;
  grid[1] = (int)g.chunks;
  grid[2] = g.planes;
  return (int)cudaGetLastError();
}

// The partial kernel's grid for a volume (B, D, HW) whose packets hold `pix` pixels on the
// current device: grid[0] tiles, grid[1] chunks of D, grid[2] the cluster's size (the
// chunks of a tile), grid[3] warps per block, grid[4] planes a thread folds at a time.
extern "C" int atvsnet_softargmin_partial_grid(int B, int D, int HW, int pix, int* grid) {
  const PartialGrid g = partial_grid(B, D, HW, pix);
  grid[0] = (int)g.tiles;
  grid[1] = (int)g.chunks;
  grid[2] = (int)g.chunks;
  grid[3] = kPartWarps;
  grid[4] = kPartBatch;
  return (int)cudaGetLastError();
}

// An empty launch of the forward's grid (which = 0), of the gradient kernel's (1) or of
// the partial kernel's, launched as that kernel is (2); packets of `pix` pixels.
extern "C" int atvsnet_softargmin_noop(int B, int D, int HW, int pix, int which,
                                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (which == 1) {
    const GradGrid g = grad_grid(B, D, HW, pix);
    noop_kernel<<<dim3(g.tiles, g.chunks), dim3(kGradLanes, kGradWarps), 0, s>>>();
  } else if (which == 2) {
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg = partial_config(partial_grid(B, D, HW, pix), attrs, s);
    const cudaError_t err = cudaLaunchKernelExC(&cfg, (const void*)noop_kernel, nullptr);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  } else {
    noop_kernel<<<grid_blocks(B, HW), kThreads, 0, s>>>();
  }
  return (int)cudaGetLastError();
}
