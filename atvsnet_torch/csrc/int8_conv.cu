// int8 3D convolution with int32 accumulation on the tensor cores, for Hopper (sm_90a).
//
//   acc[b, od, oh, ow, co] = sum_{kd, kh, kw, ci} x[b, od*s - pd + kd, oh*s - ph + kh,
//                                                   ow*s - pw + kw, ci] * w[co, ci, kd, kh, kw]
//
// x is int8 (B, D, H, W, Ci) channel-last, w int8 (Co, Ci, 3, 3, 3), zeros outside x (the
// pads and the ragged edge). The output is channel-last (B, Do, Ho, Wo, Co): the int32 sums
// themselves, or float(acc) * scale stored as fp32 or bf16, where scale is an fp32 scalar
// on the device. The int32 -> fp32 conversion rounds to nearest even (__int2float_rn), as
// XLA's convert does, and the product is one fp32 multiply, so the scaled output has the
// bits of (acc.float() * scale).to(dtype).
//
// Replaces XLA's int8 convolution under act_quant="int8mxu" (atvsnet_tpu/nn/layers.py:233-246:
// the depth-tap-decomposed lax.conv_general_dilated with int8 operands and
// preferred_element_type=int32, then the output scale). That is XLA's, not a Pallas kernel.
//
// Bound: bytes. A voxel of the flagship's largest volumes reads Ci = 8 int8 values and
// writes Co = 8 or 16 fp32 values, against 27 * Ci * Co multiply-adds: ~2 int8 operations
// per byte at Co = 8, where the H100's tensor cores do ~590 (1,979 TOPS over 3.35 TB/s).
// The output write dominates the bytes, and the input's 27-fold reuse has to stay on chip.
// The multiply-adds of every class of the flagship need 1-3% of its bound time, so the
// arithmetic stays on mma.sync.m16n8k32 s8 (wgmma would buy nothing the bytes allow).
//
// Shared by all three designs: an implicit GEMM on mma.sync.m16n8k32 s8 x s8 -> s32. M
// is a tile of kM = 128 output voxels of one (b, od) plane, tile_h rows of tile_w voxels
// along W; eight warps each take 16 rows of M and every N fragment. N is Co, padded to a
// multiple of 8 (Co = 1, the prob convs, is one fragment of 8). K is taps x Ci4 channels
// (Ci rounded up to 4), padded to a multiple of 32 with zero weights. A block is
// persistent (a grid of at most the blocks that fit on the card) and holds its weights
// (N, K) in shared memory, staged once. A table in shared memory maps groups of K to
// their byte offsets in the staged input. The epilogue converts, scales and stores from
// the accumulators, two adjacent channels per store where Co is even; voxels past the
// plane's edge are masked.
//
// The ring design (conv3d_int8_ring_kernel), for every input a tensor map describes. It
// replaced the per-tile design below as the main path because that design staged each
// 128-voxel tile's 3 x in_h x in_w patch anew with per-unit index math (six divisions and
// four bounds tests per 8-16 bytes) and then waited on it: nothing was in flight while a
// tile computed, and the next tile down D staged again two of the three planes it had
// just had (4.2-5.1x the input's bytes at stride 1). 6.5-70x its bound per class.
//  - Work item: one (b, h-tile, w-tile) column over a chunk of `planes` output planes. D is
//    cut into chunks so that the items fill the card's resident blocks in even rounds; a
//    block walks its items with a stride of the grid.
//  - Input planes stream along D through a ring of `ring` stages in shared memory. Each
//    stage is one input plane's tile, in_h rows x in_w voxels x Ci bytes, brought by ONE
//    cp.async.bulk.tensor (TMA) load that thread 0 starts, completing on the stage's
//    mbarrier. An output plane at stride 1 takes one new input plane and at stride 2 two;
//    the loads run up to `ring` planes ahead of the plane being computed, across items.
//    Each input plane of a chunk is staged once (the two halo planes once per chunk).
//  - The tensor map's out-of-bounds fill writes zeros for the TF-SAME pads, the ragged
//    edges and the planes before 0 and after D (negative start coordinates included), so
//    the kernel does no index math and no bounds tests on the input.
//  - Two map layouts: Ci a multiple of 16 -> 5-D (Ci, W, H, D, B), a box of (Ci, in_w,
//    in_h, 1, 1); Ci = 8 (the full-resolution classes) -> 4-D (W*Ci, H, D, B), W and Ci
//    merged into one byte dimension; its out-of-range bytes read 0 as well. A box must
//    start on a 16-byte boundary of its inner dimension (a start 8 bytes off faults with
//    an illegal instruction, measured on the H100), so the merged box starts `shift` =
//    (-pw * 8) mod 16 bytes before the window's first voxel and is in_w*8 + shift bytes
//    rounded up to 16 wide (<= 256: tile_w <= 16 at stride 1, <= 8 at stride 2).
//  - The offset table holds kd * stage + kh * pitch + kw * Ci + ci for each group of 8
//    values of K (one voxel's channels: Ci is 8 or a multiple of 16); the window's first
//    stage plus that offset wraps once around the ring's end. A thread reads the 8 values
//    at 8t of a k-step with one LDS.64 per row of A and per fragment of B, and hands their
//    first 4 to the mma as k = 4t.. and their last 4 as k = 16 + 4t..: A and B agree, so
//    the sums are the natural order's (the per-tile design used twice as many LDS.32,
//    with 2- and 4-way bank conflicts at Ci 32 and 64). Weight rows are padded to 32 mod 128 bytes so
//    a half-warp's B loads fall in distinct banks.
//  - Each block gathers its weights from wq itself into that layout (no packing pass on
//    the device); at Ci 8 and 16 with 1 or 2 fragments (K = 224 or 448) a thread holds
//    its B fragments and table offsets in registers for the whole launch. At 4 or more
//    fragments a pass computes two output planes from one wait, one barrier and one
//    top-up, sharing each k-step's offsets and B fragments (ring_pair).
//  - Per pass: wait the barriers of the window's loads not yet seen complete, run the MMA
//    loop, __syncthreads (every warp has read the window), thread 0 tops the ring up, then
//    the epilogue. Ring stages and phases are counted without a division, and a thread's
//    output voxels are addressed once per item: the plane loop is bound by instruction
//    throughput and shared-memory wavefronts, not by the loads (on the H100 every window was
//    complete at its first wait; at Ci 32 the A fragments alone need 864 bytes of shared
//    memory reads per output voxel, reckoned ~100 us at (1,128,120,224) against a 66 us
//    bound).
//  The design measured 2.4x the per-tile design's speed per fp32 flagship forward, in
//  turns on the H100 (PERF.md).
//
// The cluster design (the same kernel with kSplit = 3, "ring_cluster"), for the
// classes whose plane-tiles are too few to fill the card with one block per tile: the 27
// taps are split by kd across a thread-block cluster of 3. Rank r holds only the weights
// of kd = r (a third of them: 37 KB at 64->64 against 110 KB) and runs a third of the
// k-steps, and its ring stages only input plane od*s - pd + r. Each warp's 16 rows are
// owned by rank warp % 3: the other two ranks send their int32 partial sums by st.async
// into the owner's shared memory (distributed shared memory), counted on the owner's
// transaction barrier; the owner adds them (integer sums: exact in any order) and stores.
// A cluster barrier per output plane (arrived at after the owners' reads, waited for
// before the next send) keeps a receive buffer from being overwritten before it is read.
// The planner (atvsnet_torch/ops/int8_conv.py `plan`) takes the cluster where one block
// per plane-tile leaves most of the card idle: fewer plane-tiles (B * Do * tiles) than
// SMs. On the H100 (fp32 out, us, cluster against one block) it won at 64 plane-tiles,
// (1,16,15,28) 64->64 31.9 / 41.6 and (1,32,30,56) 32->64 s2 21.8 / 24.2, and lost at
// 448, (1,32,30,56) 32->32 31.0 / 21.2 and (1,64,60,112) 16->32 s2 30.2 / 17.7: its
// exchange and cluster barrier per plane cost more than the parallelism buys there.
//
// The generic design (the per-tile one; conv3d_int8_kernel), for what no tensor map
// describes (Ci neither 8 nor a multiple of 16, W * Ci not a multiple of 16 at Ci 8, an
// x not 16-byte aligned): per tile it stages the input patch with its halo, 3 x in_h x in_w
// voxels x Ci4, in loads of up to 16 bytes with several in flight per thread; anything
// outside x is 0. The main path's 196 launches never take it.
//
// The launch plan (path, tile, ring depth, D chunks, cluster and grid) is computed in
// Python (ops/int8_conv.py `plan`); this file checks it against its own layout and the
// device's limits and refuses, with a cudaError, what it cannot take. It never substitutes
// a plan of its own.
//
// Plain C interface for ctypes; the wrapper (atvsnet_torch/ops/int8_conv.py) checks
// shapes, dtypes and contiguity, plans, packs the weights for the generic path and
// launches on PyTorch's current stream.
// cuTensorMapEncodeTiled lives in libcuda: it is reached through
// cudaGetDriverEntryPointByVersion, so the library links no -lcuda.

#include <cuda.h>   // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kM = kWarps * 16;      // output voxels per tile
constexpr int kK = 32;               // K per mma
constexpr int kMaxNF = 8;            // N fragments of 8: Co <= 64
constexpr int kWeightRowPad = 16;    // bytes after each weight row in shared memory
constexpr int kMaxRing = 8;          // ring stages at most
constexpr int kSplitCluster = 3;     // the cluster design's ranks, one per kd
constexpr int kOwnedWarps = (kWarps + kSplitCluster - 1) / kSplitCluster;   // at most, per rank
// receive buffer of a rank, per N fragment: 2 senders x its owned warps x 32 lanes x 16 bytes
constexpr int kRecvBytesPerNF = 2 * kOwnedWarps * 32 * 16;

enum OutKind { kInt32 = 0, kFloat32 = 1, kBFloat16 = 2 };
enum Path { kGeneric = 0, kRing = 1, kRingCluster = 2 };

struct Conv {
  int B, D, H, W, Ci;       // input, channel-last
  int Do, Ho, Wo, Co;       // output, channel-last
  int stride, pd, ph, pw;   // stride, leading pads
  int ci4, kp, np;          // Ci rounded up to 4, K padded to 32 (generic), Co padded to 8
  int tile_w, tile_h;       // output voxels of a tile along W and H (tile_w * tile_h = kM)
  int in_w, in_h;           // staged input columns and rows per depth tap
  int tiles_w, tiles_h;     // tiles along W and H of one output plane
  long long tiles;          // generic: all tiles, B * Do * tiles_h * tiles_w
  int vec;                  // generic: bytes per staging load: 16, 8, 4 or 1
  // the ring designs
  int split;                // 1 (ring) or 3 (ring_cluster: one kd per rank)
  int merged;               // 1: the (W*Ci, H, D, B) map, 0: (Ci, W, H, D, B)
  int pitch;                // bytes of one staged row
  int shift;                // bytes before the window's first voxel in a staged row
  int box_bytes;            // bytes one TMA load brings: pitch * in_h
  int stage;                // bytes of one ring stage: box_bytes rounded up to 128
  int ring;                 // stages
  int kc;                   // K of one rank: round_up(27 or 9 * Ci, 32)
  int planes, chunks;       // output planes per D chunk, chunks
  long long items;          // B * chunks * tiles_h * tiles_w
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the N fragments an instantiation holds accumulators for (1, 2, 4 or 8): the least that
// covers np, so that the narrow convs keep few registers
__host__ __device__ inline int fragments(int np) {
  const int nf = np / 8;
  return nf <= 1 ? 1 : nf <= 2 ? 2 : nf <= 4 ? 4 : 8;
}

// generic: bytes of dynamic shared memory: weights, K-offset table, input patch
__host__ __device__ inline int weight_bytes(const Conv& c) { return c.np * (c.kp + kWeightRowPad); }
__host__ __device__ inline int smem_bytes(const Conv& c) {
  return weight_bytes(c) + c.kp + 3 * c.in_h * c.in_w * c.ci4;
}

// ring designs: a weight row of kc bytes padded to 32 mod 128 bytes, so that the 8-byte B
// loads of a half-warp (rows g = 0..3, groups t = 0..3) fall in distinct banks
__host__ __device__ inline int ring_wstride(int kc) { return kc + ((32 - kc) % 128 + 128) % 128; }
// ring designs: byte offsets in dynamic shared memory (after aligning its base up to 128):
// the ring, the weights (np rows of ring_wstride(kc)), the receive buffers (cluster), the
// K-offset table (one int per 8 values of K), the stages' barriers, the receive barrier
// (cluster); total includes the 128 bytes of alignment slack.
struct RingSmem {
  int weights, recv, offs, full, recv_bar, total;
};
__host__ __device__ inline RingSmem ring_smem(const Conv& c) {
  RingSmem s;
  s.weights = c.ring * c.stage;
  s.recv = s.weights + c.np * ring_wstride(c.kc);
  s.offs = s.recv + (c.split > 1 ? kRecvBytesPerNF * fragments(c.np) : 0);
  s.full = s.offs + c.kc / 2;
  s.recv_bar = s.full + 8 * c.ring;
  s.total = s.recv_bar + (c.split > 1 ? 8 : 0) + 128;
  return s;
}

__device__ __forceinline__ void mma_s8(int (&acc)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kOut> struct Store;
template <> struct Store<kInt32> {
  using T = int;
  __device__ static void one(int* p, int v, float) { *p = v; }
  __device__ static void two(int* p, int v0, int v1, float) { *(int2*)p = make_int2(v0, v1); }
};
template <> struct Store<kFloat32> {
  using T = float;
  __device__ static float f(int v, float s) { return __fmul_rn(__int2float_rn(v), s); }
  __device__ static void one(float* p, int v, float s) { *p = f(v, s); }
  __device__ static void two(float* p, int v0, int v1, float s) {
    *(float2*)p = make_float2(f(v0, s), f(v1, s));
  }
};
template <> struct Store<kBFloat16> {
  using T = __nv_bfloat16;
  __device__ static __nv_bfloat16 f(int v, float s) {
    return __float2bfloat16_rn(__fmul_rn(__int2float_rn(v), s));
  }
  __device__ static void one(__nv_bfloat16* p, int v, float s) { *p = f(v, s); }
  __device__ static void two(__nv_bfloat16* p, int v0, int v1, float s) {
    __nv_bfloat162 pair;
    pair.x = f(v0, s);
    pair.y = f(v1, s);
    *(__nv_bfloat162*)p = pair;
  }
};

// The accumulators of this thread's row r of M (r = 0: row g, r = 1: row g + 8) to the
// output voxel at o: accumulator (j, i) is channel j * 8 + 2t + (i & 1).
template <int kOut, int kNF>
__device__ __forceinline__ void store_voxel(const Conv& c, typename Store<kOut>::T* o,
                                            const int (&acc)[kNF][4], int r, int t, float s) {
  const int nf = c.np / 8;
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    if (j >= nf) continue;
    const int n = j * 8 + 2 * t;
    const int v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
    if (n + 1 < c.Co && c.Co % 2 == 0) {
      Store<kOut>::two(o + n, v0, v1, s);
    } else {
      if (n < c.Co) Store<kOut>::one(o + n, v0, s);
      if (n + 1 < c.Co) Store<kOut>::one(o + n + 1, v1, s);
    }
  }
}
// ... at voxel (oh, ow) of the output plane (b, od), if it lies in the plane
template <int kOut, int kNF>
__device__ __forceinline__ void store_row(const Conv& c, typename Store<kOut>::T* __restrict__ out,
                                          const int (&acc)[kNF][4], int r, int b, int od, int oh,
                                          int ow, int t, float s) {
  if (oh >= c.Ho || ow >= c.Wo) return;
  store_voxel<kOut, kNF>(c, out + (((long long)(b * c.Do + od) * c.Ho + oh) * c.Wo + ow) * c.Co,
                         acc, r, t, s);
}

// ---------------------------------------------------------------------------------------
// The generic design (the per-tile kernel)
// ---------------------------------------------------------------------------------------

// Loads that one thread keeps in flight before it stores them: 64 bytes, at least 4 loads.
template <typename V> struct Batch {
  static constexpr int kLoads = 64 / sizeof(V) < 4 ? 4 : (64 / sizeof(V) > 8 ? 8 : 64 / sizeof(V));
};

// Stage one tile's input patch, 3 x in_h x in_w voxels of ci4 channels, in loads of V: a
// thread issues Batch<V>::kLoads loads before its first store, so that the patch is a few
// memory latencies and not one per load. Channels past Ci (V of one byte) and voxels
// outside x are 0.
template <typename V>
__device__ void stage_patch(const Conv& c, const int8_t* __restrict__ x, unsigned char* xs,
                            int b, int od, int oh0, int ow0) {
  constexpr int kV = sizeof(V), kLoads = Batch<V>::kLoads;
  const int per_voxel = c.ci4 / kV;
  const int units = 3 * c.in_h * c.in_w * per_voxel;
  const int d0 = od * c.stride - c.pd, h0 = oh0 * c.stride - c.ph, w0 = ow0 * c.stride - c.pw;
  for (int u0 = threadIdx.x; u0 < units; u0 += kThreads * kLoads) {
    V v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = u0 + j * kThreads;
      v[j] = V{};
      if (u < units) {
        const int ci = (u % per_voxel) * kV;
        const int voxel = u / per_voxel;
        const int col = voxel % c.in_w;
        const int row = (voxel / c.in_w) % c.in_h;
        const int kd = voxel / (c.in_w * c.in_h);
        const int id = d0 + kd, ih = h0 + row, iw = w0 + col;
        if (id >= 0 && id < c.D && ih >= 0 && ih < c.H && iw >= 0 && iw < c.W && ci < c.Ci)
          v[j] = __ldg((const V*)(x + (((long long)(b * c.D + id) * c.H + ih) * c.W + iw) * c.Ci + ci));
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = u0 + j * kThreads;
      if (u < units) ((V*)xs)[u] = v[j];
    }
  }
}

__device__ void stage_patch(const Conv& c, const int8_t* __restrict__ x, unsigned char* xs,
                            int b, int od, int oh0, int ow0) {
  switch (c.vec) {
    case 16: stage_patch<uint4>(c, x, xs, b, od, oh0, ow0); break;
    case 8: stage_patch<uint2>(c, x, xs, b, od, oh0, ow0); break;
    case 4: stage_patch<unsigned int>(c, x, xs, b, od, oh0, ow0); break;
    default: stage_patch<unsigned char>(c, x, xs, b, od, oh0, ow0);
  }
}

// The packed weights (np rows of kbytes) into rows of `wstride` bytes in shared memory:
// 16 bytes a load and 4 loads in flight a thread.
__device__ void stage_weights(const int8_t* __restrict__ wk, unsigned char* ws, int np,
                              int kbytes, int wstride) {
  const int row_units = kbytes / 16, w_units = np * row_units;
  for (int u0 = threadIdx.x; u0 < w_units; u0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + j * kThreads;
      if (u < w_units) v[j] = __ldg((const uint4*)(wk + (long long)u * 16));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + j * kThreads;
      if (u < w_units) *(uint4*)(ws + (u / row_units) * wstride + (u % row_units) * 16) = v[j];
    }
  }
}

// kNF: the N fragments this instantiation holds accumulators for (fragments(np)).
template <int kOut, int kNF>
__global__ void __launch_bounds__(kThreads, kNF <= 2 ? 4 : 2)
conv3d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                   const float* __restrict__ scale, typename Store<kOut>::T* __restrict__ out,
                   const Conv c) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;
  int* offs = (int*)(smem + weight_bytes(c));
  unsigned char* xs = smem + weight_bytes(c) + c.kp;
  const int wstride = c.kp + kWeightRowPad;

  stage_weights(wk, ws, c.np, c.kp, wstride);
  // offset in the patch of each group of 4 values of K (taps past 27 have zero weights)
  for (int q = threadIdx.x; q < c.kp / 4; q += kThreads) {
    const int k = 4 * q;
    int off = 0;
    if (k < 27 * c.ci4) {
      const int tap = k / c.ci4, ci = k % c.ci4;
      off = (((tap / 9) * c.in_h + (tap / 3) % 3) * c.in_w + tap % 3) * c.ci4 + ci;
    }
    offs[q] = off;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nf = c.np / 8;
  const float s = kOut == kInt32 ? 0.f : *scale;
  // this thread's two rows of M, as voxels of the tile and as offsets into the patch
  int rows[2], cols[2], base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = warp * 16 + g + 8 * i;
    rows[i] = m / c.tile_w;
    cols[i] = m % c.tile_w;
    base[i] = (rows[i] * c.stride * c.in_w + cols[i] * c.stride) * c.ci4;
  }

  for (long long tile = blockIdx.x; tile < c.tiles; tile += gridDim.x) {
    long long rest = tile;
    const int tw = (int)(rest % c.tiles_w);
    rest /= c.tiles_w;
    const int th = (int)(rest % c.tiles_h);
    rest /= c.tiles_h;
    const int od = (int)(rest % c.Do);
    const int b = (int)(rest / c.Do);
    const int oh0 = th * c.tile_h, ow0 = tw * c.tile_w;

    __syncthreads();   // the weights and table are in; the last tile's patch is read
    stage_patch(c, x, xs, b, od, oh0, ow0);
    __syncthreads();

    int acc[kNF][4];
#pragma unroll
    for (int j = 0; j < kNF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int kk = 0; kk < c.kp; kk += kK) {
      const int o0 = offs[kk / 4 + t], o1 = offs[kk / 4 + 4 + t];
      const uint32_t a0 = *(const uint32_t*)(xs + base[0] + o0);
      const uint32_t a1 = *(const uint32_t*)(xs + base[1] + o0);
      const uint32_t a2 = *(const uint32_t*)(xs + base[0] + o1);
      const uint32_t a3 = *(const uint32_t*)(xs + base[1] + o1);
      const unsigned char* wrow = ws + g * wstride + kk + 4 * t;
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        if (j < nf) {
          const unsigned char* p = wrow + j * 8 * wstride;
          mma_s8(acc[j], a0, a1, a2, a3, *(const uint32_t*)p, *(const uint32_t*)(p + 16));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store_row<kOut, kNF>(c, out, acc, r, b, od, oh0 + rows[r], ow0 + cols[r], t, s);
  }
}

// ---------------------------------------------------------------------------------------
// The ring designs
// ---------------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of `parity` of the barrier to complete. A wait that outlasts any
// real copy by orders of magnitude traps (a launch failure the wrapper reports) rather
// than hang the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int merged,
                                         int c0, int c1, int c2, int c3, int c4, uint32_t bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (merged)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst), "l"(m), "r"(c1), "r"(c2), "r"(c3),
        "r"(c4), "r"(bar)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(dst), "l"(m), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(c4), "r"(bar)
        : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// The same shared-memory address (of this block) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into another block's shared memory (`addr`, from map_rank), counted on that
// block's transaction barrier `bar` (also from map_rank).
__device__ __forceinline__ void send(uint32_t addr, const int (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(bar)
      : "memory");
}

// This rank's weights straight from wq (Co, Ci, 3, 3, 3) int8 into rows of `wstride` bytes
// in shared memory, in packed_weights' order (ops/int8_conv.py): k = (tap - tap0) * Ci + ci
// over `taps` taps from tap0, zero past Co and those taps. A 32-bit store holds 4 channels
// of one tap (27 bytes apart in wq). A warp takes T taps x G groups of 4 channels (G =
// min(8, Ci / 4), T = 32 / G), so that each of its byte loads touches G rows of wq at T
// neighbouring taps, a few sectors, and its stores fall in G x 2 banks or more; a thread
// has the loads of 4 stores in flight.
__device__ void gather_weights(const int8_t* __restrict__ wq, unsigned char* ws, const Conv& c,
                               int tap0, int taps, int wstride) {
  const unsigned char* w = (const unsigned char*)wq;
  const int groups = c.Ci / 4, G = min(8, groups), T = 32 / G;
  const int tiles = (taps + T - 1) / T * (groups / G);   // warp tiles of a row
  const int units = c.np * tiles * 32;
  for (int u0 = threadIdx.x; u0 < units; u0 += 4 * kThreads) {
    uint32_t v[4];
    int dst[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + j * kThreads, lane = u % 32, tile = u / 32 % tiles, n = u / 32 / tiles;
      const int tap = tile / (groups / G) * T + lane / G;
      const int ci = (tile % (groups / G) * G + lane % G) * 4;
      v[j] = 0;
      dst[j] = u < units && tap < taps ? n * wstride + tap * c.Ci + ci : -1;
      if (dst[j] >= 0 && n < c.Co) {
        const unsigned char* src = w + (n * c.Ci + ci) * 27 + tap0 + tap;
        v[j] = (uint32_t)__ldg(src) | (uint32_t)__ldg(src + 27) << 8 |
               (uint32_t)__ldg(src + 54) << 16 | (uint32_t)__ldg(src + 81) << 24;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (dst[j] >= 0) *(uint32_t*)(ws + dst[j]) = v[j];
  }
  // K past the taps: zero weights
  const int tail = (c.kc - taps * c.Ci) / 4;
  for (int u = threadIdx.x; u < c.np * tail; u += kThreads)
    *(uint32_t*)(ws + u / tail * wstride + taps * c.Ci + u % tail * 4) = 0;
}

// __launch_bounds__' least resident blocks per SM of a ring kernel (ops/int8_conv.py
// min_blocks_per_sm mirrors it): kNF fragments, kRegK k-steps held in registers
__host__ __device__ constexpr int ring_min_blocks(int nf, int reg_k) {
  return reg_k > 7 ? 2 : reg_k && nf == 2 ? 3 : nf <= 2 ? 4 : 2;
}
// Output planes a pass of a ring kernel computes: two on one block at 4 or more fragments
// (2 blocks per SM either way), sharing each k-step's offsets and B fragments; one
// otherwise (two there took 4 blocks per SM down to 3 and measured slower on the H100:
// (1,128,120,224) 8->8 87.1 against 82.5 us, 16->16 33.8 against 30.4 us).
__host__ __device__ constexpr int ring_pair(int nf, int split) { return split == 1 && nf >= 4 ? 2 : 1; }

// A work item: the column (b, th, tw) over output planes [od0, od0 + n_out).
struct Item {
  int b, oh0, ow0, od0, n_out;
};
__device__ __forceinline__ Item decode(const Conv& c, int item) {
  Item it;
  const int tw = item % c.tiles_w;
  item /= c.tiles_w;
  const int th = item % c.tiles_h;
  item /= c.tiles_h;
  const int chunk = item % c.chunks;
  it.b = item / c.chunks;
  it.oh0 = th * c.tile_h;
  it.ow0 = tw * c.tile_w;
  it.od0 = chunk * c.planes;
  it.n_out = min(c.planes, c.Do - it.od0);
  return it;
}
// input planes an item stages: its window's planes at each output plane, each once
template <int kSplit>
__device__ __forceinline__ int item_loads(const Conv& c, int n_out) {
  return kSplit == 1 ? (n_out - 1) * c.stride + 3 : n_out;
}

// The producer, thread 0: starts the block's input-plane loads in order (its items in
// turn, each item's planes along D) while the load counter is below `limit`. Load L goes to
// stage L % ring and completes phase (L / ring) & 1 of that stage's barrier. The current
// item is decoded once, when the producer reaches it.
struct Producer {
  int item, q, next;      // the item of the next load, its plane in the item, its number
  int slot;               // its stage: next % ring
  int n_in, d0, dstep;    // that item's loads, its first input plane and the step along D
  int w0, h0, b;          // its box origin: W (bytes on the merged map, voxels on 5-D), H, B
};
template <int kSplit>
__device__ void producer_item(const Conv& c, Producer& p, int rank) {
  if (p.item >= c.items) return;
  const Item it = decode(c, p.item);
  p.n_in = item_loads<kSplit>(c, it.n_out);
  p.d0 = it.od0 * c.stride - c.pd + (kSplit == 1 ? 0 : rank);
  p.dstep = kSplit == 1 ? 1 : c.stride;
  p.w0 = it.ow0 * c.stride - c.pw;
  p.w0 = c.merged ? p.w0 * c.Ci - c.shift : p.w0;
  p.h0 = it.oh0 * c.stride - c.ph;
  p.b = it.b;
}
template <int kSplit>
__device__ void top_up(const CUtensorMap* map, const Conv& c, Producer& p, int limit,
                       int item_stride, int rank, uint32_t ring_addr, uint32_t full_addr) {
  while (p.next < limit && p.item < c.items) {
    const uint32_t bar = full_addr + 8 * p.slot;
    bar_expect(bar, c.box_bytes);
    tma_load(ring_addr + p.slot * c.stage, map, c.merged, 0, p.w0, p.h0, p.d0 + p.q * p.dstep,
             p.b, bar);
    ++p.next;
    if (++p.slot == c.ring) p.slot = 0;
    if (++p.q == p.n_in) {
      p.q = 0;
      p.item += item_stride;
      producer_item<kSplit>(c, p, rank);
    }
  }
}

// kRegK: 0, or the k-steps of a ring kernel on one block whose K is held in registers
// (reg_steps: 7 at Ci = 8, 14 at Ci = 16, with N of 1 or 2 fragments):
// the k-steps unrolled, each thread's B fragments and table offsets loaded once per block.
template <int kOut, int kNF, int kSplit, int kRegK>
__global__ void __launch_bounds__(kThreads, ring_min_blocks(kNF, kRegK))
conv3d_int8_ring_kernel(const __grid_constant__ CUtensorMap map, const int8_t* __restrict__ wq,
                        const float* __restrict__ scale,
                        typename Store<kOut>::T* __restrict__ out, const Conv c) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const RingSmem L = ring_smem(c);
  unsigned char* ring = smem;
  unsigned char* ws = smem + L.weights;
  int* offs = (int*)(smem + L.offs);
  const uint32_t ring_addr = smem_u32(ring), full_addr = smem_u32(smem + L.full);
  const int ring_bytes = c.ring * c.stage;
  const unsigned char* ring_end = ring + ring_bytes;
  const int wstride = ring_wstride(c.kc);
  const int rank = kSplit == 1 ? 0 : (int)cluster_rank();
  const int item_stride = gridDim.x / kSplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  Producer prod{(int)(blockIdx.x / kSplit), 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < c.ring; ++i) bar_init(full_addr + 8 * i, 1);
    if (kSplit > 1) {
      const int owned = (kWarps - rank + kSplitCluster - 1) / kSplitCluster;
      bar_init(smem_u32(smem + L.recv_bar), 1);
      bar_expect(smem_u32(smem + L.recv_bar), 2 * owned * 32 * kNF * 16);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the first planes go out before the weights are staged
    producer_item<kSplit>(c, prod, rank);
    top_up<kSplit>(&map, c, prod, c.ring, item_stride, rank, ring_addr, full_addr);
  }
  // this rank's taps: all 27, or the 9 of kd = rank
  gather_weights(wq, ws, c, kSplit == 1 ? 0 : 9 * rank, kSplit == 1 ? 27 : 9, wstride);
  // offset from the window's first stage of each group of 8 values of K (one voxel's 8
  // channels, Ci being 8 or a multiple of 16): kd * stage + kh * pitch + kw * Ci + ci (taps
  // past this rank's have zero weights)
  for (int q = threadIdx.x; q < c.kc / 8; q += kThreads) {
    const int k = 8 * q;
    int off = 0;
    if (k < (kSplit == 1 ? 27 : 9) * c.Ci) {
      const int tap = k / c.Ci, ci = k % c.Ci, r9 = tap % 9;
      off = (tap / 9) * c.stage + (r9 / 3) * c.pitch + (r9 % 3) * c.Ci + ci;
    }
    offs[q] = off;
  }
  __syncthreads();
  if (kSplit > 1) cluster_arrive();   // the receive barrier is initialised

  const int nf = c.np / 8;
  const float s = kOut == kInt32 ? 0.f : *scale;
  // this thread's two rows of M, as voxels of the tile and as offsets into a stage
  int rows[2], cols[2], base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = warp * 16 + g + 8 * i;
    rows[i] = m / c.tile_w;
    cols[i] = m % c.tile_w;
    base[i] = rows[i] * c.stride * c.pitch + c.shift + cols[i] * c.stride * c.Ci;
  }
  // the cluster design: the rank that owns this warp's rows, and where this thread's
  // partial sums go in it (slot 0 from the rank after the owner, 1 from the one after that)
  const int owner = warp % kSplitCluster;
  const uint32_t recv_local = smem_u32(smem + L.recv);
  const uint32_t recv_bar = smem_u32(smem + L.recv_bar);
  const int owned_bytes = 2 * ((kWarps - rank + kSplitCluster - 1) / kSplitCluster) * 32 * kNF * 16;
  uint32_t phase = 0;   // output planes this block has done: the receive barrier's phase
  const unsigned char* wrow = ws + g * wstride + 8 * t;
  uint2 breg[kRegK > 0 ? kRegK : 1][kNF];
  int oreg[kRegK > 0 ? kRegK : 1];
  if constexpr (kRegK > 0) {
#pragma unroll
    for (int ks = 0; ks < kRegK; ++ks) {
      oreg[ks] = offs[4 * ks + t];
#pragma unroll
      for (int n = 0; n < kNF; ++n)
        breg[ks][n] = n < nf ? *(const uint2*)(wrow + n * 8 * wstride + kK * ks) : make_uint2(0, 0);
    }
  }
  // the ring positions of this thread's next load to wait for and of the window's first
  // load, kept without a division: stage and phase parity
  int wslot = 0, fslot = 0;
  uint32_t wpar = 0;
  int waited = 0;       // the loads this thread has seen complete
  const int plane_step = kSplit == 1 ? c.stride : 1;    // loads between windows of an item
  const int item_step = kSplit == 1 ? 3 : 1;            // from an item's last window to the next item
  constexpr int kPair = ring_pair(kNF, kSplit);         // output planes a pass computes
  const long long plane_elems = (long long)c.Ho * c.Wo * c.Co;

  int first_load = 0;   // the number of the current item's first load
  for (int item = blockIdx.x / kSplit; item < c.items; item += item_stride) {
    const Item it = decode(c, item);
    const int n_in = item_loads<kSplit>(c, it.n_out);
    // this thread's two output voxels at the item's first plane (null: past the plane's edge)
    typename Store<kOut>::T* orow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int oh = it.oh0 + rows[r], ow = it.ow0 + cols[r];
      orow[r] = oh < c.Ho && ow < c.Wo
                    ? out + (((long long)(it.b * c.Do + it.od0) * c.Ho + oh) * c.Wo + ow) * c.Co
                    : nullptr;
    }
    for (int j = 0; j < it.n_out; j += kPair) {
      const bool two = kPair == 2 && j + 1 < it.n_out;   // a second output plane this pass
      const int first = first_load + j * plane_step;
      const int last = first + (kSplit == 1 ? 2 : 0) + (two ? plane_step : 0);   // its last load
      for (; waited <= last; ++waited) {                 // the loads not seen complete yet
        bar_wait(full_addr + 8 * wslot, wpar);
        if (++wslot == c.ring) wslot = 0, wpar ^= 1;
      }
      // the windows' first stages: plane j's, and plane j + 1's plane_step stages on
      const unsigned char* cur[kPair];
      cur[0] = ring + fslot * c.stage;
      if constexpr (kPair == 2) {
        const unsigned char* q = cur[0] + plane_step * c.stage;
        cur[1] = q >= ring_end ? q - ring_bytes : q;
      }
      fslot += j + kPair < it.n_out ? kPair * plane_step : item_step + (two ? plane_step : 0);
      while (fslot >= c.ring) fslot -= c.ring;

      // a k-step of 32: thread t takes the 8 values of K at 8t (one LDS.64 per row of A
      // and per fragment of B) and hands their first 4 to the mma as k = 4t.. and their
      // last 4 as k = 16 + 4t..: A and B agree, so the sums are those of the natural order.
      // The pass's windows share each k-step's offsets and B fragments.
      int acc[kPair][kNF][4];
#pragma unroll
      for (int w = 0; w < kPair; ++w)
#pragma unroll
        for (int n = 0; n < kNF; ++n) acc[w][n][0] = acc[w][n][1] = acc[w][n][2] = acc[w][n][3] = 0;
      if constexpr (kRegK > 0) {
#pragma unroll
        for (int ks = 0; ks < kRegK; ++ks) {
#pragma unroll
          for (int w = 0; w < kPair; ++w) {
            if (w == 1 && !two) break;
            const unsigned char* p = cur[w] + oreg[ks];
            if (p >= ring_end) p -= ring_bytes;   // the window wraps the ring
            const uint2 a_lo = *(const uint2*)(p + base[0]);
            const uint2 a_hi = *(const uint2*)(p + base[1]);
#pragma unroll
            for (int n = 0; n < kNF; ++n)
              if (n < nf)
                mma_s8(acc[w][n], a_lo.x, a_hi.x, a_lo.y, a_hi.y, breg[ks][n].x, breg[ks][n].y);
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < c.kc; kk += kK) {
          const int off = offs[kk / 8 + t];
          uint2 b[kNF];
#pragma unroll
          for (int n = 0; n < kNF; ++n)
            if (n < nf) b[n] = *(const uint2*)(wrow + n * 8 * wstride + kk);
#pragma unroll
          for (int w = 0; w < kPair; ++w) {
            if (w == 1 && !two) break;
            const unsigned char* p = cur[w] + off;
            if (kSplit == 1 && p >= ring_end) p -= ring_bytes;   // the window wraps the ring
            const uint2 a_lo = *(const uint2*)(p + base[0]);
            const uint2 a_hi = *(const uint2*)(p + base[1]);
#pragma unroll
            for (int n = 0; n < kNF; ++n)
              if (n < nf) mma_s8(acc[w][n], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b[n].x, b[n].y);
          }
        }
      }

      __syncthreads();   // every warp has read the windows
      if (threadIdx.x == 0) {
        // the stages before the next pass's windows are free; the async proxy's writes
        // follow the generic reads of them
        const int released = j + kPair >= it.n_out ? first_load + n_in : first + kPair * plane_step;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        top_up<kSplit>(&map, c, prod, released + c.ring, item_stride, rank, ring_addr, full_addr);
      }

      if (kSplit == 1) {
#pragma unroll
        for (int w = 0; w < kPair; ++w) {
          if (w == 1 && !two) break;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (orow[r] != nullptr)
              store_voxel<kOut, kNF>(c, orow[r] + (j + w) * plane_elems, acc[w], r, t, s);
        }
      } else {
        cluster_wait();   // every owner has read the last plane's partial sums
        if (rank != owner) {
          const int slot = (rank - owner + kSplitCluster - 1) % kSplitCluster;
          const uint32_t dst = map_rank(
              recv_local + (((slot * kOwnedWarps + warp / kSplitCluster) * 32 + lane) * kNF) * 16,
              owner);
          const uint32_t bar = map_rank(recv_bar, owner);
#pragma unroll
          for (int n = 0; n < kNF; ++n) send(dst + 16 * n, acc[0][n], bar);
        } else {
          bar_wait(recv_bar, phase & 1);
          if (warp == rank && lane == 0) bar_expect(recv_bar, owned_bytes);   // the next plane's
          const int4* recv = (const int4*)(smem + L.recv);
#pragma unroll
          for (int slot = 0; slot < 2; ++slot) {
            const int4* in = recv + ((slot * kOwnedWarps + warp / kSplitCluster) * 32 + lane) * kNF;
#pragma unroll
            for (int n = 0; n < kNF; ++n) {
              const int4 v = in[n];
              acc[0][n][0] += v.x, acc[0][n][1] += v.y, acc[0][n][2] += v.z, acc[0][n][3] += v.w;
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (orow[r] != nullptr) store_voxel<kOut, kNF>(c, orow[r] + j * plane_elems, acc[0], r, t, s);
        }
        cluster_arrive();
        ++phase;
      }
    }
    first_load += n_in;
  }
  if (kSplit > 1) cluster_wait();   // no block leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------------------

template <int kOut>
const void* generic_kernel(int np) {
  switch (fragments(np)) {
    case 1: return (const void*)conv3d_int8_kernel<kOut, 1>;
    case 2: return (const void*)conv3d_int8_kernel<kOut, 2>;
    case 4: return (const void*)conv3d_int8_kernel<kOut, 4>;
    default: return (const void*)conv3d_int8_kernel<kOut, 8>;
  }
}
template <int kOut, int kSplit>
const void* ring_kernel(int np, int reg_k) {
  if constexpr (kSplit == 1) {   // K in registers on one block only
    switch (fragments(np) * 100 + reg_k) {
      case 107: return (const void*)conv3d_int8_ring_kernel<kOut, 1, 1, 7>;
      case 114: return (const void*)conv3d_int8_ring_kernel<kOut, 1, 1, 14>;
      case 207: return (const void*)conv3d_int8_ring_kernel<kOut, 2, 1, 7>;
      case 214: return (const void*)conv3d_int8_ring_kernel<kOut, 2, 1, 14>;
    }
  }
  switch (fragments(np)) {
    case 1: return (const void*)conv3d_int8_ring_kernel<kOut, 1, kSplit, 0>;
    case 2: return (const void*)conv3d_int8_ring_kernel<kOut, 2, kSplit, 0>;
    case 4: return (const void*)conv3d_int8_ring_kernel<kOut, 4, kSplit, 0>;
    default: return (const void*)conv3d_int8_ring_kernel<kOut, 8, kSplit, 0>;
  }
}
// the ring kernels that hold K in registers (its k-steps, else 0): one block (not the
// cluster), Ci 8 or 16, N of 1 or 2 fragments. (Ci 32 with one fragment, 27 k-steps at 2
// blocks per SM, measured no faster than the shared-memory loop at 4: 250 against 246 us
// at (1,128,120,224) 32->8 on the H100.)
inline int reg_steps(const Conv& c) {
  const bool held = c.split == 1 && (c.Ci == 8 || c.Ci == 16) && fragments(c.np) <= 2;
  return held ? c.kc / kK : 0;
}
template <int kOut>
const void* kernel_for(int path, const Conv& c) {
  return path == kGeneric ? generic_kernel<kOut>(c.np)
         : path == kRing  ? ring_kernel<kOut, 1>(c.np, reg_steps(c))
                          : ring_kernel<kOut, kSplitCluster>(c.np, 0);
}
const void* kernel_for(int out_kind, int path, const Conv& c) {
  return out_kind == kInt32     ? kernel_for<kInt32>(path, c)
         : out_kind == kFloat32 ? kernel_for<kFloat32>(path, c)
                                : kernel_for<kBFloat16>(path, c);
}

// An empty launch of a plan's grid: its device time is what a launch costs before any
// byte moves.
__global__ void noop_kernel() {}

// The fields of a launch plan, in this order (ops/int8_conv.py PLAN_FIELDS).
enum PlanField {
  kPath, kTileW, kTileH, kRingDepth, kPlanes, kChunks, kCluster, kGrid, kBlocksPerSM,
  kSmemBytes, kPlanFields
};

struct Launch {
  const void* fn;
  int smem, grid, cluster, per_sm, clusters;   // clusters: cudaOccupancyMaxActiveClusters
};

cudaLaunchConfig_t launch_config(const Launch& l, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)l.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)l.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (l.cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = l.cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// Check `plan` against this file's layout for conv `c` (its shapes filled in) and against
// the device: fill in the derived sizes, the instantiation, its shared memory, the
// occupancy. Returns a cudaError_t: cudaErrorInvalidValue for a plan this file does not
// lay out as given, cudaErrorInvalidConfiguration for one the device cannot hold.
int configure(Conv& c, const int* plan, int out_kind, Launch& l) {
  if (c.B < 1 || c.D < 1 || c.H < 1 || c.W < 1 || c.Ci < 1 || c.Do < 1 || c.Ho < 1 ||
      c.Wo < 1 || c.Co < 1 || c.Co > 8 * kMaxNF || (c.stride != 1 && c.stride != 2) ||
      out_kind < kInt32 || out_kind > kBFloat16 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int path = plan[kPath];
  if (path < kGeneric || path > kRingCluster) return (int)cudaErrorInvalidValue;
  c.ci4 = round_up(c.Ci, 4);
  c.np = round_up(c.Co, 8);
  c.tile_w = plan[kTileW];
  c.tile_h = plan[kTileH];
  if (c.tile_w < 1 || c.tile_h < 1 || c.tile_w * c.tile_h != kM) return (int)cudaErrorInvalidValue;
  c.in_w = (c.tile_w - 1) * c.stride + 3;
  c.in_h = (c.tile_h - 1) * c.stride + 3;
  c.tiles_w = (c.Wo + c.tile_w - 1) / c.tile_w;
  c.tiles_h = (c.Ho + c.tile_h - 1) / c.tile_h;
  l.cluster = path == kRingCluster ? kSplitCluster : 1;
  if (plan[kCluster] != l.cluster) return (int)cudaErrorInvalidValue;
  if (path == kGeneric) {
    c.kp = round_up(27 * c.ci4, kK);
    c.vec = c.Ci % 16 == 0 ? 16 : c.Ci % 8 == 0 ? 8 : c.Ci % 4 == 0 ? 4 : 1;
    c.tiles = (long long)c.B * c.Do * c.tiles_h * c.tiles_w;
    l.smem = smem_bytes(c);
  } else {
    c.split = l.cluster;
    if (c.Ci == 8 && (c.W * c.Ci) % 16 == 0) c.merged = 1;
    else if (c.Ci % 16 == 0) c.merged = 0;
    else return (int)cudaErrorInvalidValue;   // no tensor map describes this input
    c.shift = c.merged ? ((-c.pw * c.Ci) % 16 + 16) % 16 : 0;
    c.pitch = c.merged ? round_up(c.in_w * c.Ci + c.shift, 16) : c.in_w * c.Ci;
    if ((c.merged ? c.pitch : c.Ci) > 256 || c.in_w > 256 || c.in_h > 256)
      return (int)cudaErrorInvalidValue;     // a box extent past 256
    c.box_bytes = c.pitch * c.in_h;
    c.stage = round_up(c.box_bytes, 128);
    c.kc = round_up((c.split == 1 ? 27 : 9) * c.Ci, kK);
    c.ring = plan[kRingDepth];
    const int least = c.split > 1 ? 2 : c.stride == 1 ? 4 : 5;
    if (c.ring < least || c.ring > kMaxRing) return (int)cudaErrorInvalidValue;
    c.planes = plan[kPlanes];
    if (c.planes < 1) return (int)cudaErrorInvalidValue;
    c.chunks = (c.Do + c.planes - 1) / c.planes;
    if (plan[kChunks] != c.chunks) return (int)cudaErrorInvalidValue;
    c.items = (long long)c.B * c.chunks * c.tiles_h * c.tiles_w;
    if (c.items > 0x7fffffff) return (int)cudaErrorInvalidValue;   // the kernel counts in int
    l.smem = ring_smem(c).total;
  }
  if (plan[kSmemBytes] != l.smem) return (int)cudaErrorInvalidValue;
  l.grid = plan[kGrid];
  if (l.grid < 1 || l.grid % l.cluster) return (int)cudaErrorInvalidValue;
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (l.smem > max_smem) return (int)cudaErrorInvalidConfiguration;
  l.fn = kernel_for(out_kind, path, c);
  cudaError_t err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, l.fn, kThreads, l.smem);
  if (err != cudaSuccess) return (int)err;
  if (l.per_sm < 1 || l.per_sm < plan[kBlocksPerSM]) return (int)cudaErrorInvalidConfiguration;
  l.clusters = 0;
  if (l.cluster > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(l, &attr, 0);
    err = cudaOccupancyMaxActiveClusters(&l.clusters, l.fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (l.clusters < 1) return (int)cudaErrorInvalidClusterSize;
  }
  return 0;
}

// cuTensorMapEncodeTiled, from libcuda through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The tensor map of x for conv `c` (configured): int8 as bytes, zeros out of bounds.
int encode_map(CUtensorMap* map, const void* x, const Conv& c) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((uintptr_t)x % 16) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t row = (cuuint64_t)c.W * c.Ci, plane = row * c.H, volume = plane * c.D;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], elem[5] = {1, 1, 1, 1, 1};
  cuuint32_t rank;
  if (c.merged) {
    rank = 4;
    dims[0] = row, dims[1] = c.H, dims[2] = c.D, dims[3] = c.B;
    strides[0] = row, strides[1] = plane, strides[2] = volume;
    box[0] = c.pitch, box[1] = c.in_h, box[2] = 1, box[3] = 1;
  } else {
    rank = 5;
    dims[0] = c.Ci, dims[1] = c.W, dims[2] = c.H, dims[3] = c.D, dims[4] = c.B;
    strides[0] = c.Ci, strides[1] = row, strides[2] = plane, strides[3] = volume;
    box[0] = c.Ci, box[1] = c.in_w, box[2] = c.in_h, box[3] = 1, box[4] = 1;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

Conv conv_of(int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo, int Co, int stride,
             int pd, int ph, int pw) {
  Conv c{};
  c.B = B, c.D = D, c.H = H, c.W = W, c.Ci = Ci;
  c.Do = Do, c.Ho = Ho, c.Wo = Wo, c.Co = Co;
  c.stride = stride, c.pd = pd, c.ph = ph, c.pw = pw;
  return c;
}

}  // namespace

// x (B, D, H, W, Ci) int8 contiguous; wk: on the generic path the packed weights
// (ops/int8_conv.py packed_weights(wq)): (round_up(Co, 8), kp) int8 contiguous, kp =
// round_up(27 * round_up(Ci, 4), 32), column k = tap * round_up(Ci, 4) + ci with tap =
// kd * 9 + kh * 3 + kw, zero past Ci, the taps and Co; on the ring paths wq itself, (Co,
// Ci, 3, 3, 3) int8 contiguous, which each block gathers into that order. scale an fp32 scalar (unused for out_kind 0); out (B, Do, Ho, Wo, Co)
// contiguous, int32 (out_kind 0), fp32 (1) or bf16 (2). pads are the leading pads of D, H,
// W; the output sizes say where the trailing ones end. plan: kPlanFields ints (PlanField).
// Returns a cudaError_t.
extern "C" int atvsnet_conv3d_int8(const void* x, const void* wk, const void* scale, void* out,
                                   int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo,
                                   int Co, int stride, int pd, int ph, int pw, int out_kind,
                                   const int* plan, void* stream) {
  Conv c = conv_of(B, D, H, W, Ci, Do, Ho, Wo, Co, stride, pd, ph, pw);
  Launch l{};
  int err = configure(c, plan, out_kind, l);
  if (err) return err;
  if ((plan[kPath] == kGeneric && (uintptr_t)wk % 16) || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const int8_t* wp = (const int8_t*)wk;
  const float* sp = (const float*)scale;
  cudaError_t launched;
  if (plan[kPath] == kGeneric) {
    if ((uintptr_t)x % c.vec) return (int)cudaErrorMisalignedAddress;
    const int8_t* xp = (const int8_t*)x;
    void* args[] = {(void*)&xp, (void*)&wp, (void*)&sp, (void*)&out, (void*)&c};
    launched = cudaLaunchKernel(l.fn, dim3((unsigned)l.grid), dim3(kThreads), args, (size_t)l.smem,
                                (cudaStream_t)stream);
  } else {
    alignas(64) CUtensorMap map;
    err = encode_map(&map, x, c);
    if (err) return err;
    void* args[] = {(void*)&map, (void*)&wp, (void*)&sp, (void*)&out, (void*)&c};
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(l, &attr, (cudaStream_t)stream);
    launched = cudaLaunchKernelExC(&cfg, l.fn, args);
  }
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(launched != cudaSuccess ? launched : last);
}

// Whether the device takes `plan` for this conv, without launching: result[0] the blocks
// of the plan's kernel that fit on an SM, result[1] the clusters that fit on the device at
// once (0 without a cluster). Returns a cudaError_t, as a launch would.
extern "C" int atvsnet_conv3d_int8_check(int B, int D, int H, int W, int Ci, int Do, int Ho,
                                         int Wo, int Co, int stride, int pd, int ph, int pw,
                                         int out_kind, const int* plan, int* result) {
  Conv c = conv_of(B, D, H, W, Ci, Do, Ho, Wo, Co, stride, pd, ph, pw);
  Launch l{};
  const int err = configure(c, plan, out_kind, l);
  if (err) return err;
  result[0] = l.per_sm;
  result[1] = l.clusters;
  return 0;
}

// An empty launch of `plan`'s grid: the same blocks, threads, shared memory and cluster.
extern "C" int atvsnet_conv3d_int8_noop(int B, int D, int H, int W, int Ci, int Do, int Ho,
                                        int Wo, int Co, int stride, int pd, int ph, int pw,
                                        int out_kind, const int* plan, void* stream) {
  Conv c = conv_of(B, D, H, W, Ci, Do, Ho, Wo, Co, stride, pd, ph, pw);
  Launch l{};
  const int err = configure(c, plan, out_kind, l);
  if (err) return err;
  l.fn = (const void*)noop_kernel;
  cudaError_t launched = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (launched == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(l, &attr, (cudaStream_t)stream);
    launched = cudaLaunchKernelExC(&cfg, l.fn, nullptr);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// The device's streaming multiprocessors and opt-in shared memory per block, the planner's
// two inputs: result[0], result[1]. Returns a cudaError_t.
extern "C" int atvsnet_conv3d_int8_device(int* result) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&result[0], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&result[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}
