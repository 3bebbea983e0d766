// fp32 3D convolution for Hopper (sm_90a): a direct convolution on the CUDA cores (FFMA),
// 3x3x3 taps, stride 1 or 2, rate 1.
//
//   out[b, od, oh, ow, co] = bias[co] + sum_{kd, kh, kw, ci}
//       x[b, od*s - pd + kd, oh*s - ph + kh, ow*s - pw + kw, ci] * w[co, ci, kd, kh, kw]
//
// x is float32 (B, D, H, W, Ci) channel-last, as every volume of the port; zeros outside x
// (TF-SAME's (1, 1) and (0, 1) pads, a depth split's halo'd block with (0, 0) on D, the
// ragged edge: a tap that falls outside x is zero-filled by the copy itself, so no padded
// copy of x is made). w is read as it lies, (Co, Ci, 3, 3, 3): no packing launch. The
// output is channel-last (B, Do, Ho, Wo, Co), contiguous. Products and sums are fp32
// (FFMA), the arithmetic of fp32_precision="highest" with TF32 off; no tensor cores and no
// atomics: each output is one accumulator summed in a fixed order (ci groups, then (kh,
// kw), kd, ci within the group), then the bias is added, so a call gives the same bits
// every time.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (atvsnet_tpu/nn/layers.py, conv with Precision.HIGHEST). It replaces cuDNN under the
// port's "highest" 3D convolutions (nn.layers._padded_conv): CRM, the refinement and AAM,
// where cuDNN with TF32 off ran implicit_convolveNd_sgemm and sm80_xmma_fprop at ~9% of the
// fp32 FFMA peak, plus layout kernels and a padded copy for the strided convs.
//
// Bound, per class: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), the bytes counting input,
// weights and output once each. K = 27 * Ci; a class at Ci >= 8 and Co >= 8 does 2 * 27 *
// Ci * Co FLOPs per 4 * (Ci + Co) bytes of input and output, 35-460 per byte, over the
// ridge (~20): bound by the multiply-adds. Co = 1 (the probability convs) and Ci = 1, 2
// (the refinement's small entries) are bound by bytes. Most FLOPs of a forward are at Ci
// 8-32 and Co 8-16 (5 views, 480x896, D = 128: 1.635 TFLOP in 228 launches, 24.7 ms).
//
// Design: small Co leaves a GEMM tile mostly idle, and copying A tap by tap would read each
// input element 27 times; so this is a direct convolution that stages each input element
// in shared memory once per block and reuses it from registers.
//  - A block is 128 threads laid out 16 (w) x 8 (h): thread (tx, ty) owns output column
//    (oh0 + ty, ow0 + tx) over TMD consecutive output planes and TN output channels:
//    TMD x TN accumulators. Grid: x = (w, h) tiles, y = D tiles of TMD planes, z = batch x
//    groups of TN channels.
//  - Input channels walk in groups of CG (4: the "vector" path, 16-byte copies, Ci % 4 == 0
//    and x 16-byte aligned; 1: the "scalar" path, 4-byte copies: Ci = 1 and 2) through a
//    ring of NST stages in shared memory, filled by cp.async. A stage holds the block's input
//    brick for that group: ((TMD-1)s+3) x (7s+3) x (15s+3) positions x CG channels (the
//    output tile and its halo; a tap outside x copies 0 source bytes, which fills zeros),
//    and the group's weights as [tap][ci][co]. Channel groups are distinct data, so each
//    input element of the brick is read once per block; neighbouring blocks share halos
//    through L2.
//  - Per (kh, kw) a thread loads its column of (TMD-1)s+3 input vectors along D into
//    registers: each serves the 3 kd taps of up to 3 output planes. Per (kd, ci) the TN
//    weights are broadcast reads (every lane reads the same address: one wavefront), and
//    each feeds TMD multiply-adds. Lanes read consecutive 16-byte vectors: no bank
//    conflicts; at stride 2 the brick's columns are stored evens first, then odds, so lanes
//    reading columns 2 tx + kw still read consecutive vectors.
//  - The plan (ops/conv3d_fp32.py `plan`) picks TN, TMD and NST from (Ci, Co, stride)
//    alone: TN 16 where Co is a multiple of 16 and Ci * Co <= 512 (AAM 8->16, the 16-channel
//    classes, the strided entries), 1 for Co = 1, else 8; TMD 8 planes at stride 1 (4 with
//    TN 16), halved while Ci * Co is large (32->32: 4, 64->64: 2) so that the small deep
//    levels still fill the card; TMD 2 at stride 2, whose brick is ~8x its output tile. Two
//    stages at stride 1 (~30-65 KB a block), one at stride 2 (~50 KB: four blocks an SM
//    overlap each other's copies instead).
//  - Epilogue: the bias, then 16-byte stores straight from the accumulators where Co is a
//    multiple of 4, 4-byte stores otherwise. The ReLU stays with the caller.
//  - Measured on an H100 (the classes above at full size): the large stride-1 classes run
//    their multiply-adds at ~52-55% of the fp32 peak; blocks of 16 rows (less halo, fewer
//    weight copies an output) spilled at 128 registers and ran 4-20% slower, two stages at
//    stride 2 or 4 planes there gained under 3%. The stride-2 classes are bound by their
//    copies (one 16-byte request per brick position and per channel group).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTW = 16;                 // output columns per block (threads along w)
constexpr int kTH = 8;                  // output rows per block (threads along h)
constexpr int kThreads = kTW * kTH;     // 128

struct Conv3 {
  int B, D, H, W, Ci, Do, Ho, Wo, Co, pd, ph, pw;
  int tiles_w, co_groups;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copies through L2 only (.cg: the bricks are read once, and allocating them in L1
// evicted the weights, ~30% slower at the largest class); 4-byte copies through L1 (.ca)
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

template <int S, int CG, int TN, int TMD, int NST>
struct Tile3 {
  static constexpr int PD = (TMD - 1) * S + 3;      // brick planes
  static constexpr int PH = (kTH - 1) * S + 3;      // brick rows
  static constexpr int PW = (kTW - 1) * S + 3;      // brick columns
  static constexpr int PWE = (PW + 1) / 2;          // even columns (the stride-2 layout)
  static constexpr int kPos = PD * PH * PW;
  static constexpr int kSlab = (kPos * CG + 3) / 4 * 4;       // floats, 16-byte multiple
  static constexpr int kWts = (27 * CG * TN + 3) / 4 * 4;
  static constexpr int kStage = kSlab + kWts;
  static constexpr int kSmem = NST * kStage * 4;
  // the brick's column index of column c: at stride 2 evens first, then odds
  static __device__ __forceinline__ int col(int c) {
    return S == 1 ? c : (c & 1) ? PWE + (c >> 1) : (c >> 1);
  }
};

template <int S, int CG, int TN, int TMD, int NST>
__global__ void __launch_bounds__(kThreads, 3)
conv3d_fp32_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out, Conv3 c) {
  using T = Tile3<S, CG, TN, TMD, NST>;
  using V = Vec<CG>;
  using VT = typename V::T;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % kTW, ty = tid / kTW;
  const int tile_w = blockIdx.x % c.tiles_w, tile_h = blockIdx.x / c.tiles_w;
  const int od0 = blockIdx.y * TMD, oh0 = tile_h * kTH, ow0 = tile_w * kTW;
  const int group = blockIdx.z % c.co_groups, b = blockIdx.z / c.co_groups;
  const int n0 = group * TN;
  const int id0 = od0 * S - c.pd, ih0 = oh0 * S - c.ph, iw0 = ow0 * S - c.pw;
  const float* xb = x + (size_t)b * c.D * c.H * c.W * c.Ci;
  const int G = (c.Ci + CG - 1) / CG;

  // stage `g`'s copies into slot `slot`: the brick of channel group g, then its weights
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
      cp_async<CG * 4>(slab + ((p * T::PH + r) * T::PW + T::col(col)) * CG, src, ok);
    }
    for (int j = tid; j < 27 * CG * TN; j += kThreads) {
      const int n = j % TN;
      const int ci = (j / TN) % CG;
      const int tap = j / (TN * CG);
      const bool ok = n0 + n < c.Co && c0 + ci < c.Ci;
      cp_async<4>(wts + j, ok ? w + ((size_t)(n0 + n) * c.Ci + c0 + ci) * 27 + tap : w, ok);
    }
  };

  float acc[TMD][TN];
#pragma unroll
  for (int i = 0; i < TMD; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

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
    const float* wts = slab + T::kSlab;
#pragma unroll 1
    for (int khw = 0; khw < 9; ++khw) {
      const int kh = khw / 3, kw = khw - kh * 3;
      const int r = ty * S + kh;
      const int cidx = S == 1 ? tx + kw : (kw == 1 ? T::PWE + tx : tx + (kw >> 1));
      VT v[T::PD];
#pragma unroll
      for (int p = 0; p < T::PD; ++p)
        v[p] = *reinterpret_cast<const VT*>(slab + ((p * T::PH + r) * T::PW + cidx) * CG);
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int ci = 0; ci < CG; ++ci) {
          const float* wp = wts + ((kd * 9 + khw) * CG + ci) * TN;
          float wv[TN];
          if (TN % 4 == 0) {
#pragma unroll
            for (int q = 0; q < TN / 4; ++q) {
              const float4 t4 = *reinterpret_cast<const float4*>(wp + 4 * q);
              wv[4 * q] = t4.x; wv[4 * q + 1] = t4.y; wv[4 * q + 2] = t4.z; wv[4 * q + 3] = t4.w;
            }
          } else {
#pragma unroll
            for (int n = 0; n < TN; ++n) wv[n] = wp[n];
          }
#pragma unroll
          for (int i = 0; i < TMD; ++i) {
            const float a = V::at(v[i * S + kd], ci);
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a, wv[n], acc[i][n]);
          }
        }
      }
    }
    __syncthreads();                        // slot g % NST is free for stage g + NST
  }

  // ---- epilogue: bias, then the stores ----
  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh >= c.Ho || ow >= c.Wo) return;
  float bv[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) bv[n] = (bias != nullptr && n0 + n < c.Co) ? bias[n0 + n] : 0.f;
  const bool vec_out = TN % 4 == 0 && (c.Co & 3) == 0;
#pragma unroll
  for (int i = 0; i < TMD; ++i) {
    const int od = od0 + i;
    if (od >= c.Do) break;
    float* o = out + ((((size_t)b * c.Do + od) * c.Ho + oh) * c.Wo + ow) * c.Co + n0;
#pragma unroll
    for (int q = 0; q < (TN + 3) / 4; ++q) {
      const int n = 4 * q;
      if (vec_out && n0 + n + 3 < c.Co) {
        *reinterpret_cast<float4*>(o + n) =
            make_float4(acc[i][n] + bv[n], acc[i][n + 1] + bv[n + 1],
                        acc[i][n + 2] + bv[n + 2], acc[i][n + 3] + bv[n + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < TN && n0 + n + e < c.Co) o[n + e] = acc[i][n + e] + bv[n + e];
      }
    }
  }
}

template <int S, int CG, int TN, int TMD, int NST>
int launch(const float* x, const float* w, const float* bias, float* out, Conv3 c,
           cudaStream_t stream) {
  using T = Tile3<S, CG, TN, TMD, NST>;
  const void* fn = (const void*)conv3d_fp32_direct_kernel<S, CG, TN, TMD, NST>;
  // per launch: the attributes hold for the current device only
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    const int tiles_h = (c.Ho + kTH - 1) / kTH;
    const int tiles_d = (c.Do + TMD - 1) / TMD;
    c.tiles_w = (c.Wo + kTW - 1) / kTW;
    c.co_groups = (c.Co + TN - 1) / TN;
    if (tiles_d > 65535 || (long long)c.B * c.co_groups > 65535) {
      err = cudaErrorInvalidConfiguration;
    } else {
      const dim3 grid((unsigned)(c.tiles_w * tiles_h), (unsigned)tiles_d,
                      (unsigned)(c.B * c.co_groups));
      void* args[] = {(void*)&x, (void*)&w, (void*)&bias, (void*)&out, (void*)&c};
      err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, (size_t)T::kSmem, stream);
    }
  }
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(err != cudaSuccess ? err : last);
}

// The plans the wrapper names (ops/conv3d_fp32.py `plan`): (stride, tn, planes, stages).
#define CONV3D_PLANS(X) \
  X(1, 1, 8, 2) X(1, 8, 8, 2) X(1, 8, 4, 2) X(1, 8, 2, 2) X(1, 16, 4, 2) X(2, 8, 2, 1) X(2, 16, 2, 1)

template <int CG>
int dispatch(int stride, int tn, int planes, int stages, const float* x, const float* w,
             const float* bias, float* out, const Conv3& c, cudaStream_t s) {
#define CONV3D_CASE(S_, TN_, TMD_, NST_)                                            \
  if (stride == S_ && tn == TN_ && planes == TMD_ && stages == NST_)                \
    return launch<S_, CG, TN_, TMD_, NST_>(x, w, bias, out, c, s);
  CONV3D_PLANS(CONV3D_CASE)
#undef CONV3D_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a plan or path it does not have, or for
// sizes that disagree; cudaErrorMisalignedAddress where the vector path's x or the output
// does not start on 16 bytes.
extern "C" int atvsnet_conv3d_fp32(const void* x, const void* w, const void* bias, void* out,
                                   int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo,
                                   int Co, int stride, int pd, int ph, int pw, int path, int tn,
                                   int planes, int stages, void* stream) {
  Conv3 c{B, D, H, W, Ci, Do, Ho, Wo, Co, pd, ph, pw, 0, 0};
  if (path < 0 || path > 1 || B < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 ||
      Do < 1 || Ho < 1 || Wo < 1 || pd < 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = path == 0;
  if ((vec && (Ci % 4 != 0 || (uintptr_t)x % 16)) || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? dispatch<4>(stride, tn, planes, stages, xf, wf, bf, of, c, s)
             : dispatch<1>(stride, tn, planes, stages, xf, wf, bf, of, c, s);
}
