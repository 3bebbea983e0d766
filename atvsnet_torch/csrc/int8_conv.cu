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
//
// Design, in answer to that (the simple version; wgmma, TMA and a fused quantize are
// later work):
//  - An implicit GEMM on mma.sync.m16n8k32 s8 x s8 -> s32. M is a tile of kM = 128 output
//    voxels of one (b, od) plane: tile_h rows of tile_w voxels along W (tile_w in 16..128,
//    the shape that stages the fewest input voxels over the plane). N is Co, padded to a
//    multiple of 8 (Co = 1, the prob convs, is one fragment of 8). K is the 27 taps x Ci4
//    channels (Ci rounded up to 4), padded to a multiple of 32 with zero weights.
//  - A block is persistent: it stages the whole packed weight matrix (the wrapper packs it
//    as (N, K) int8, k = tap * Ci4 + ci; 64 x 1,728 bytes = 110 KB at its largest) in
//    shared memory once, then walks output tiles with a stride of the grid. The grid is the
//    card's SMs times the blocks that fit on one, so the weights are read once per block,
//    not once per tile.
//  - Per tile it stages the input patch with its halo, 3 depth taps x in_h rows x in_w
//    columns x Ci4 channels, in loads of up to 16 bytes as Ci allows, each thread with
//    several loads in flight before its first store (staging one load at a time made
//    every tile wait a memory latency per load); anything outside x is 0. Each input
//    byte is then read from shared memory by up to 27 taps.
//  - Eight warps each take 16 rows of M and every N fragment. A table in shared memory maps
//    each group of 4 values of K to its offset in the patch, so the A fragment is 4 aligned
//    32-bit loads per k-step; B fragments are 2 per N fragment, from weight rows padded by
//    16 bytes so that the 8 rows of a fragment fall in distinct banks.
//  - The epilogue converts, scales and stores from the accumulators, two adjacent channels
//    per store where Co is even; tiles past the plane's edge are masked.
//
// Plain C interface for ctypes; the wrapper (atvsnet_torch/ops/int8_conv.py) checks
// shapes, dtypes and contiguity, packs the weights and launches on PyTorch's current stream.

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

enum OutKind { kInt32 = 0, kFloat32 = 1, kBFloat16 = 2 };

struct Conv {
  int B, D, H, W, Ci;       // input, channel-last
  int Do, Ho, Wo, Co;       // output, channel-last
  int stride, pd, ph, pw;   // stride, leading pads
  int ci4, kp, np;          // Ci rounded up to 4, K padded to 32, Co padded to 8
  int tile_w, tile_h;       // output voxels of a tile along W and H (tile_w * tile_h = kM)
  int in_w, in_h;           // staged input columns and rows per depth tap
  int tiles_w, tiles_h;     // tiles along W and H of one output plane
  long long tiles;          // all tiles: B * Do * tiles_h * tiles_w
  int vec;                  // bytes per staging load: 16, 8, 4 or 1
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// bytes of dynamic shared memory: weights, K-offset table, input patch
__host__ __device__ inline int weight_bytes(const Conv& c) { return c.np * (c.kp + kWeightRowPad); }
__host__ __device__ inline int smem_bytes(const Conv& c) {
  return weight_bytes(c) + c.kp + 3 * c.in_h * c.in_w * c.ci4;
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

// kNF: the N fragments this instantiation holds accumulators for (1, 2, 4 or 8; the launch
// takes the least that covers Co), so that the narrow convs keep few registers.
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

  // the packed weights (np, kp), 16 bytes a load and 4 loads in flight a thread, into rows
  // of wstride bytes
  const int row_units = c.kp / 16, w_units = c.np * row_units;
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

    // accumulator (j, i): row g (i < 2) or g + 8 (i >= 2), channel j * 8 + 2t + (i & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int oh = oh0 + rows[r], ow = ow0 + cols[r];
      if (oh >= c.Ho || ow >= c.Wo) continue;
      typename Store<kOut>::T* o =
          out + (((long long)(b * c.Do + od) * c.Ho + oh) * c.Wo + ow) * c.Co;
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
  }
}

// Fill in the derived sizes and the tile; false if no tile fits in shared memory.
bool plan(Conv& c, int max_smem) {
  c.ci4 = round_up(c.Ci, 4);
  c.kp = round_up(27 * c.ci4, kK);
  c.np = round_up(c.Co, 8);
  c.vec = c.Ci % 16 == 0 ? 16 : c.Ci % 8 == 0 ? 8 : c.Ci % 4 == 0 ? 4 : 1;
  // the tile shape (tile_w from 128 down to 16, tile_h = kM / tile_w) that stages the fewest
  // input voxels over the plane, ragged tiles included, among those that fit
  long long best = -1;
  Conv pick = c;
  for (int tw = 128; tw >= 16; tw /= 2) {
    Conv t = c;
    t.tile_w = tw;
    t.tile_h = kM / tw;
    t.in_w = (tw - 1) * c.stride + 3;
    t.in_h = (t.tile_h - 1) * c.stride + 3;
    t.tiles_w = (c.Wo + tw - 1) / tw;
    t.tiles_h = (c.Ho + t.tile_h - 1) / t.tile_h;
    const long long staged = (long long)t.tiles_w * t.tiles_h * t.in_w * t.in_h;
    if (smem_bytes(t) <= max_smem && (best < 0 || staged < best)) {
      best = staged;
      pick = t;
    }
  }
  if (best < 0) return false;
  c = pick;
  c.tiles = (long long)c.B * c.Do * c.tiles_h * c.tiles_w;
  return true;
}

// The instantiation for these output kind and channel counts.
template <int kOut>
const void* kernel_for(int np) {
  switch (np / 8) {
    case 1: return (const void*)conv3d_int8_kernel<kOut, 1>;
    case 2: return (const void*)conv3d_int8_kernel<kOut, 2>;
    case 3: case 4: return (const void*)conv3d_int8_kernel<kOut, 4>;
    default: return (const void*)conv3d_int8_kernel<kOut, 8>;
  }
}

const void* kernel_for(int out_kind, int np) {
  return out_kind == kInt32 ? kernel_for<kInt32>(np)
         : out_kind == kFloat32 ? kernel_for<kFloat32>(np) : kernel_for<kBFloat16>(np);
}

// Plan the launch: the tile, the instantiation, its shared memory and the grid (blocks
// that fit on an SM at once, times the SMs, at most one per tile). Returns a cudaError_t.
int configure(Conv& c, int out_kind, const void** fn, int* smem, int* per_sm, long long* blocks) {
  int device = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (!plan(c, max_smem)) return (int)cudaErrorInvalidValue;
  *fn = kernel_for(out_kind, c.np);
  *smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, *fn, kThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)*per_sm * sms;
  *blocks = c.tiles < most ? c.tiles : most;
  return 0;
}

}  // namespace

// x (B, D, H, W, Ci) int8 contiguous; wk the packed weights (round_up(Co, 8),
// round_up(27 * round_up(Ci, 4), 32)) int8 contiguous, k = tap * round_up(Ci, 4) + ci with
// tap = kd * 9 + kh * 3 + kw, zero past Ci, 27 taps and Co; scale an fp32 scalar (unused for
// out_kind 0); out (B, Do, Ho, Wo, Co) contiguous, int32 (out_kind 0), fp32 (1) or bf16 (2).
// pads are the leading pads of D, H, W; the output sizes say where the trailing ones end.
// Returns a cudaError_t.
extern "C" int atvsnet_conv3d_int8(const void* x, const void* wk, const void* scale, void* out,
                                   int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo,
                                   int Co, int stride, int pd, int ph, int pw, int out_kind,
                                   void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Do < 1 || Ho < 1 || Wo < 1 || Co < 1 ||
      Co > 8 * kMaxNF || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  Conv c{};
  c.B = B, c.D = D, c.H = H, c.W = W, c.Ci = Ci;
  c.Do = Do, c.Ho = Ho, c.Wo = Wo, c.Co = Co;
  c.stride = stride, c.pd = pd, c.ph = ph, c.pw = pw;
  if (out_kind < kInt32 || out_kind > kBFloat16) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int smem = 0, per_sm = 0;
  long long blocks = 0;
  const int err = configure(c, out_kind, &fn, &smem, &per_sm, &blocks);
  if (err) return err;
  if ((uintptr_t)x % c.vec || (uintptr_t)wk % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)wk;
  const float* sp = (const float*)scale;
  void* args[] = {(void*)&xp, (void*)&wp, (void*)&sp, (void*)&out, (void*)&c};
  const cudaError_t launched = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kThreads), args,
                                                (size_t)smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(launched != cudaSuccess ? launched : last);
}

// The tile that a launch at these sizes takes, for the wrapper's records: tile_w, tile_h,
// blocks per SM, grid blocks and shared memory bytes in plan[0..4]. Returns a cudaError_t.
extern "C" int atvsnet_conv3d_int8_plan(int B, int Ci, int Do, int Ho, int Wo, int Co, int stride,
                                        int out_kind, int* result) {
  if (Co < 1 || Co > 8 * kMaxNF || out_kind < kInt32 || out_kind > kBFloat16 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  Conv c{};
  c.B = B, c.Ci = Ci, c.Do = Do, c.Ho = Ho, c.Wo = Wo, c.Co = Co, c.stride = stride;
  const void* fn = nullptr;
  int smem = 0, per_sm = 0;
  long long blocks = 0;
  const int err = configure(c, out_kind, &fn, &smem, &per_sm, &blocks);
  if (err) return err;
  result[0] = c.tile_w;
  result[1] = c.tile_h;
  result[2] = per_sm;
  result[3] = (int)blocks;
  result[4] = smem;
  return 0;
}
