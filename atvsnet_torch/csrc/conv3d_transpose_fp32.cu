// fp32 transposed 3D convolution for Hopper (sm_90a): 3x3x3 taps, stride 2, padding 0, its
// output cropped as it is written. With w (Ci, Co, 3, 3, 3), PyTorch's transpose layout,
//
//   full[b, o, co] = sum over (i, k) with o = 2 i + k, per axis, and ci of
//                    x[b, i, ci] * w[ci, co, k]           (conv_transpose3d, padding 0)
//   out[b, o, co]  = full[b, o + beg, co],   o in [0, 2 n - beg) per axis
//
// x is float32 (B, D, H, W, Ci) channel-last, as every volume of the port; the output is
// channel-last (B, 2D - bd, 2H - bh, 2W - bw, Co), contiguous. The crop begins are even:
// 0 on every axis in a forward (TF-SAME on an even output size crops (0, 1)), 2 on D for a
// depth split's block, whose first input plane is its left neighbour's last (nn/layers.py
// `deconv`). Products and sums are fp32 (FFMA), the arithmetic of fp32_precision="highest"
// with TF32 off; no tensor cores and no atomics: each output is one accumulator summed in a
// fixed order (input-channel groups, then taps, then the channels of a group), so a call
// gives the same bits every time.
//
// Replaces no TPU kernel: the JAX package leaves the transposed conv to XLA
// (atvsnet_tpu/nn/layers.py `deconv`: the vjp of the strided SAME conv, Precision.HIGHEST;
// `_deconv3d_s2_shuffle` there is the same parity form as a 2x2x2 conv). It replaces cuDNN
// under the port's "highest" 3D deconvs (CRM's three a U-Net pass, the refinement's three):
// convolveNd_dgrad_float_engine with TF32 off, which scatters the gradient of a conv at
// ~9% of the fp32 FFMA peak, after cudnn's setTensor5d has zero-filled the uncropped
// output; the crop then left a strided view.
//
// Bound, per class: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), the bytes counting input,
// weights and cropped output once each; 27 Ci Co multiply-adds an input position (every tap
// of every input feeds one output). At full size (480x896, D = 128, base filter 8):
//   64->32 (1,16,15,28,64)  -> (1,32,30,56,32)    0.372 G MACs  11.1 us (FLOPs)
//   32->16 (1,32,30,56,32)  -> (1,64,60,112,16)   0.743 G MACs  22.2 us (FLOPs)
//   16->8  (1,64,60,112,16) -> (1,128,120,224,8)  1.486 G MACs  44.4 us (FLOPs; bytes 41.1)
// 28 such triples a 5-view map (2.18 ms), 49 at 8 views (3.81 ms).
//
// Design: a parity ("sub-pixel") decomposition, output-stationary: no scatter. Along each
// axis an even output 2m takes x[m + e] w[0] + x[m + e - 1] w[2] and an odd one 2m + 1
// takes x[m + e] w[1] (e = beg / 2). So the output splits into cells (2m + p), p in
// {0, 1}^3, and the cell of input position m reads the eight inputs x[m + e - d],
// d in {0, 1}^3: each of the 27 taps pairs one input with one output of the cell.
//  - A block is 128 threads: GS groups of TN output channels (the block's chunk of GS TN
//    channels, the group fastest across lanes) x a CW x CH tile of input cells along
//    (w, h); each thread owns TMD consecutive cells along D: 8 TMD TN accumulators. Grid:
//    x = channel chunks (fastest) x (w, h) tiles, y = D tiles of TMD cells, z = batch.
//  - Input channels walk in groups of CG (4: the "vector" path, 16-byte copies, Ci % 4 == 0
//    and x 16-byte aligned; 1: the "scalar" path, 4-byte copies) through a ring of NST
//    stages filled by cp.async. A stage holds the block's input brick for the group,
//    (TMD + 1) x (CH + 1) x (CW + 1) positions x CG channels (the cells and a one-position
//    halo at the low end; a position outside x copies 0 source bytes, which fills zeros),
//    shared by all the block's channel groups, and the group's weights as
//    [ci][tap][channel], copied from w in its own order.
//  - Per input offset (dh, dw) a thread loads its column of TMD + 1 input vectors along D;
//    each serves the taps of that offset: per (kd, ci) the thread's TN weights, each
//    feeding TMD multiply-adds.
//  - Epilogue: each thread writes its TN channels of every output of its cells (8-byte
//    stores where Co is even): every output element written once, no fill pass and no
//    uncropped border. The ReLU and the norm stay with the caller.
//  - The plan (ops/conv3d_transpose_fp32.py `plan`): TN 2, TMD 4, GS 4 (chunks of 8
//    channels, cells 8 x 4), two stages, at every class. Shared-memory traffic sets the
//    ceiling: a thread loads a weight for every TMD multiply-adds, and a block's channel
//    groups share one brick, so small TN costs no extra input copies. Measured on an H100
//    at full size (the three classes 38.9 / 64.1 / 120.8 us, 2.9x their bounds; cuDNN
//    129 / 410 / 1902 us): one channel group a block with TN 4 or 8 ran 1.2-1.4x slower,
//    TN 1 with TMD 8 about as fast, three stages, four blocks an SM, streaming stores and a
//    persistent grid that walked several tiles a block no faster, the last 1.2x slower.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

struct Deconv3 {
  int B, D, H, W, Ci, Co;   // x (B, D, H, W, Ci), w (Ci, Co, 3, 3, 3)
  int ed, eh, ew;           // half the crop begins: cell m reads x[m + e - d]
  int Md, Mh, Mw;           // cells per axis: the output is (2 Md, 2 Mh, 2 Mw)
  int tiles_w, co_chunks;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copies through L2 only (.cg: the bricks are read once per block); 4-byte copies
// through L1 (.ca: every block of a launch reads the same weights)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

template <int CG> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float at(float v, int) { return v; }
};

constexpr int ceil_log2(int n) { return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2); }

// A block: GS channel groups of TN channels (the block's chunk of GS * TN output channels)
// x CW x CH input cells along (w, h), each thread TMD cells along D.
template <int CG, int TN, int TMD, int GS, int NST>
struct TileT {
  static constexpr int kCells = kThreads / GS;                       // (w, h) cells a block
  static constexpr int CW = 1 << ((ceil_log2(kCells) + 1) / 2);      // the wider side
  static constexpr int CH = kCells / CW;
  static constexpr int kChunk = GS * TN;                             // output channels a block
  static constexpr int PD = TMD + 1;                // brick planes
  static constexpr int PH = CH + 1;                 // brick rows
  static constexpr int PW = CW + 1;                 // brick columns
  static constexpr int kPos = PD * PH * PW;
  static constexpr int kSlab = (kPos * CG + 3) / 4 * 4;       // floats, 16-byte multiple
  static constexpr int kWts = (27 * CG * kChunk + 3) / 4 * 4;
  static constexpr int kStage = kSlab + kWts;
  static constexpr int kSmem = NST * kStage * 4;
  // blocks an SM must hold: three up to 64 accumulators a thread, two above
  static constexpr int kMinBlocks = 8 * TMD * TN <= 64 ? 3 : 2;
  static_assert(kThreads % GS == 0 && CW * CH == kCells, "a block's cells fill its threads");
};

template <int CG, int TN, int TMD, int GS, int NST>
__global__ void __launch_bounds__(kThreads, (TileT<CG, TN, TMD, GS, NST>::kMinBlocks))
conv3d_transpose_fp32_parity_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                    float* __restrict__ out, Deconv3 c) {
  using T = TileT<CG, TN, TMD, GS, NST>;
  using V = Vec<CG>;
  using VT = typename V::T;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int gs = tid % GS, cell = tid / GS;          // lanes: channel groups fastest
  const int tx = cell % T::CW, ty = cell / T::CW;
  const int chunk = blockIdx.x % c.co_chunks;
  const int tile = blockIdx.x / c.co_chunks;
  const int tile_w = tile % c.tiles_w, tile_h = tile / c.tiles_w;
  const int md0 = blockIdx.y * TMD, mh0 = tile_h * T::CH, mw0 = tile_w * T::CW;
  const int b = blockIdx.z;
  const int nb = chunk * T::kChunk;                  // the block's first output channel
  const int n0 = nb + gs * TN;                       // the thread's
  // the brick's first position: the input one below the first cell's own (d = 1)
  const int id0 = md0 + c.ed - 1, ih0 = mh0 + c.eh - 1, iw0 = mw0 + c.ew - 1;
  const float* xb = x + (size_t)b * c.D * c.H * c.W * c.Ci;
  const int G = (c.Ci + CG - 1) / CG;

  // stage `g`'s copies into slot `slot`: the brick of channel group g, then its weights
  // as [ci][tap][channel of the chunk], read from w in its own order (coalesced)
  auto load = [&](int g, int slot) {
    float* slab = smem + slot * T::kStage;
    float* wts = slab + T::kSlab;
    const int c0 = g * CG;
    for (int i = tid; i < T::kPos; i += kThreads) {
      const int p = i / (T::PH * T::PW);
      const int rc = i - p * (T::PH * T::PW);
      const int r = rc / T::PW;
      const int col = rc - r * T::PW;
      const int id = id0 + p, ih = ih0 + r, iw = iw0 + col;
      const bool ok = (unsigned)id < (unsigned)c.D && (unsigned)ih < (unsigned)c.H &&
                      (unsigned)iw < (unsigned)c.W;
      const float* src = ok ? xb + (((size_t)id * c.H + ih) * c.W + iw) * c.Ci + c0 : x;
      cp_async<CG * 4>(slab + i * CG, src, ok);
    }
    for (int j = tid; j < 27 * CG * T::kChunk; j += kThreads) {
      const int ci = j / (27 * T::kChunk);
      const int rest = j - ci * (27 * T::kChunk);
      const int n = rest / 27;
      const int tap = rest - n * 27;
      const bool ok = nb + n < c.Co && c0 + ci < c.Ci;
      cp_async<4>(wts + (ci * 27 + tap) * T::kChunk + n,
                  ok ? w + ((size_t)(c0 + ci) * c.Co + nb + n) * 27 + tap : w, ok);
    }
  };

  // acc[i][pd][ph][pw][n]: cell i along D, output parity (pd, ph, pw), channel n0 + n
  float acc[TMD][2][2][2][TN];
#pragma unroll
  for (int i = 0; i < TMD; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][q >> 2][(q >> 1) & 1][q & 1][n] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < G) load(s, s);
    cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    const int next = g + NST - 1;
    if (next < G) load(next, next % NST);   // its slot was last read at g - 1, then a barrier
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();                        // stage g has landed for every thread

    const float* slab = smem + (g % NST) * T::kStage;
    const float* wts = slab + T::kSlab + gs * TN;
#pragma unroll
    for (int dhw = 0; dhw < 4; ++dhw) {
      const int dh = dhw >> 1, dw = dhw & 1;   // the inputs x[mh + eh - dh, mw + ew - dw]
      VT v[TMD + 1];                           // v[q]: the brick's plane q (cell q's, less 1)
#pragma unroll
      for (int q = 0; q <= TMD; ++q)
        v[q] = *reinterpret_cast<const VT*>(
            slab + ((q * T::PH + ty + 1 - dh) * T::PW + tx + 1 - dw) * CG);
      // the taps of offset d along an axis: d = 0 feeds parity 0 by tap 0 and parity 1 by
      // tap 1; d = 1 feeds parity 0 by tap 2
#pragma unroll
      for (int ph = 0; ph < 2 - dh; ++ph) {
        const int kh = dh ? 2 : ph;
#pragma unroll
        for (int pw = 0; pw < 2 - dw; ++pw) {
          const int kw = dw ? 2 : pw;
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            const int pd = kd == 1 ? 1 : 0, dd = kd == 2 ? 1 : 0;
#pragma unroll
            for (int ci = 0; ci < CG; ++ci) {
              const float* wp = wts + (ci * 27 + (kd * 3 + kh) * 3 + kw) * T::kChunk;
              float wv[TN];
              if constexpr (TN == 2) {
                const float2 t2 = *reinterpret_cast<const float2*>(wp);
                wv[0] = t2.x; wv[1] = t2.y;
              } else {
#pragma unroll
                for (int n = 0; n < TN; ++n) wv[n] = wp[n];
              }
#pragma unroll
              for (int i = 0; i < TMD; ++i) {
                const float a = V::at(v[i + 1 - dd], ci);
#pragma unroll
                for (int n = 0; n < TN; ++n)
                  acc[i][pd][ph][pw][n] = fmaf(a, wv[n], acc[i][pd][ph][pw][n]);
              }
            }
          }
        }
      }
    }
    __syncthreads();                        // slot g % NST is free for stage g + NST
  }

  // ---- epilogue: every output of the thread's cells, once ----
  const int mh = mh0 + ty, mw = mw0 + tx;
  if (mh >= c.Mh || mw >= c.Mw || n0 >= c.Co) return;
  const int Do = 2 * c.Md, Ho = 2 * c.Mh, Wo = 2 * c.Mw;
  const bool pair_out = TN == 2 && (c.Co & 1) == 0;
#pragma unroll
  for (int i = 0; i < TMD; ++i) {
    const int md = md0 + i;
    if (md >= c.Md) break;
#pragma unroll
    for (int pd = 0; pd < 2; ++pd)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        float* row = out + ((((size_t)b * Do + 2 * md + pd) * Ho + 2 * mh + ph) * Wo + 2 * mw)
                               * c.Co + n0;
#pragma unroll
        for (int pw = 0; pw < 2; ++pw) {
          float* o = row + pw * c.Co;
          if (pair_out) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[i][pd][ph][pw][0], acc[i][pd][ph][pw][1]);
          } else {
#pragma unroll
            for (int n = 0; n < TN; ++n)
              if (n0 + n < c.Co) o[n] = acc[i][pd][ph][pw][n];
          }
        }
      }
  }
}

template <int CG, int TN, int TMD, int GS, int NST>
int launch(const float* x, const float* w, float* out, Deconv3 c, cudaStream_t stream) {
  using T = TileT<CG, TN, TMD, GS, NST>;
  const void* fn = (const void*)conv3d_transpose_fp32_parity_kernel<CG, TN, TMD, GS, NST>;
  // per launch: the attributes hold for the current device only
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    const int tiles_h = (c.Mh + T::CH - 1) / T::CH;
    const int tiles_d = (c.Md + TMD - 1) / TMD;
    c.tiles_w = (c.Mw + T::CW - 1) / T::CW;
    c.co_chunks = (c.Co + T::kChunk - 1) / T::kChunk;
    if (tiles_d > 65535 || c.B > 65535 ||
        (long long)c.co_chunks * c.tiles_w * tiles_h > 2147483647LL) {
      err = cudaErrorInvalidConfiguration;
    } else {
      const dim3 grid((unsigned)(c.co_chunks * c.tiles_w * tiles_h), (unsigned)tiles_d,
                      (unsigned)c.B);
      void* args[] = {(void*)&x, (void*)&w, (void*)&out, (void*)&c};
      err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, (size_t)T::kSmem, stream);
    }
  }
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(err != cudaSuccess ? err : last);
}

// The plans the wrapper names (ops/conv3d_transpose_fp32.py `plan`):
// (tn, planes, groups, stages).
#define DECONV3D_PLANS(X) X(2, 4, 4, 2)

template <int CG>
int dispatch(int tn, int planes, int groups, int stages, const float* x, const float* w,
             float* out, const Deconv3& c, cudaStream_t s) {
#define DECONV3D_CASE(TN_, TMD_, GS_, NST_)                                       \
  if (tn == TN_ && planes == TMD_ && groups == GS_ && stages == NST_)             \
    return launch<CG, TN_, TMD_, GS_, NST_>(x, w, out, c, s);
  DECONV3D_PLANS(DECONV3D_CASE)
#undef DECONV3D_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bd, bh, bw: the crop begins (even, >= 0); the output is (B, 2D - bd, 2H - bh, 2W - bw, Co).
// Returns a cudaError_t: cudaErrorInvalidValue for a plan or path it does not have, an odd
// or negative crop begin or an empty output; cudaErrorMisalignedAddress where the vector
// path's x or the output does not start on 16 bytes.
extern "C" int atvsnet_conv3d_transpose_fp32(const void* x, const void* w, void* out, int B,
                                             int D, int H, int W, int Ci, int Co, int bd,
                                             int bh, int bw, int path, int tn, int planes,
                                             int groups, int stages, void* stream) {
  if (path < 0 || path > 1 || B < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 ||
      bd < 0 || bh < 0 || bw < 0 || (bd | bh | bw) & 1)
    return (int)cudaErrorInvalidValue;
  Deconv3 c{B, D, H, W, Ci, Co, bd / 2, bh / 2, bw / 2, D - bd / 2, H - bh / 2, W - bw / 2,
            0, 0};
  if (c.Md < 1 || c.Mh < 1 || c.Mw < 1) return (int)cudaErrorInvalidValue;
  const bool vec = path == 0;
  if ((vec && (Ci % 4 != 0 || (uintptr_t)x % 16)) || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *xf = (const float*)x, *wf = (const float*)w;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? dispatch<4>(tn, planes, groups, stages, xf, wf, of, c, s)
             : dispatch<1>(tn, planes, groups, stages, xf, wf, of, c, s);
}
