// fp32 2D convolution for Hopper (sm_90a): an implicit GEMM on the CUDA cores (FFMA).
//
//   out[b, oh, ow, co] = bias[co] + sum_{kh, kw, ci} x[b, oh*s - ph + kh*d, ow*s - pw + kw*d, ci]
//                                                    * w[co, ci, kh, kw]
//
// x is float32 (B, H, W, Ci) channel-last, as every activation of the port; zeros outside x
// (TF-SAME's asymmetric (beg, end) pads and the ragged edge: a tap that falls there is
// zero-filled by the copy itself, so no padded copy of x is ever made). The weights come
// packed by the wrapper, K-major (kh, kw, Ci) x Np with Np = Co rounded up to 4 (zero
// columns past Co). The output is channel-last (B, Ho, Wo, Co), contiguous. Products and
// sums are fp32 (FFMA), the arithmetic of fp32_precision="highest" with TF32 off; no tensor
// cores (TF32 and the split bf16 passes are other arithmetics: the port runs "high" and
// "default" on them) and no atomics: each output is one accumulator summed over k in
// ascending order, then the bias is added, so a call gives the same bits every time.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (atvsnet_tpu/nn/layers.py, conv with Precision.HIGHEST). It replaces cuDNN under the
// port's "highest" 2D convolutions (nn.layers._padded_conv), where cuDNN picked its FFT
// algorithm for the FEM at a batch of 5 views (tens of thousands of small complex GEMMs, a
// ~20 GB workspace) and implicit GEMM at 8.
//
// Bound, per class: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), the bytes counting input,
// weights and output once each. fp32's ridge is ~20 FLOP per byte. A 1x1 conv at 32
// channels does 2 * 32 * 32 FLOPs per 256 bytes of input and output (8 per byte) and is
// bound by memory; the 3x3 convs at 32-320 channels do 72-720 per byte and are bound by
// the multiply-adds. Most of the FEM's FLOPs are 3x3 convs at 64-320 input channels.
//
// Design:
//  - GEMM view: M = B * Ho * Wo output pixels, N = Co, K = kh * kw * Ci, k ordered (kh, kw,
//    ci) so that a run of K within one tap is contiguous in x.
//  - A block computes a tile of kBM = 128 pixels by BN channels (32, 64 or 128, the
//    wrapper's choice from Co), with 16 x BN / TN threads each holding an 8 x TN tile of
//    accumulators (8 x 8 at BN 128, 8 x 4 at 64 and 32): per 4 values of k a thread reads
//    8 + TN / 4 float4 from shared memory for 32 * TN multiply-adds.
//  - K walks in slices of kBK = 16 through a ring of kStages = 4 slices in shared memory,
//    filled by cp.async: A as 16-byte copies of 4 channels (Ci % 4 == 0, the "vector"
//    path) or 4-byte copies (the "scalar" path: the 3-channel stem and the shallow FEM, the
//    2-channel geometric half of the refinement). A tap outside x copies 0 source bytes,
//    which fills zeros. Each thread keeps the (kh, kw, ci) of its column of A and advances
//    it by kBK per slice without a division; its rows' (b, oh, ow) are decoded once.
//  - Shared layout: A as [pixel][k] rows of kBK + 4 floats, B as [k][channel]. A warp
//    covers 4 consecutive pixels x 8 groups of 4 channels: its A reads are 4 float4 at
//    rows 80 bytes apart (distinct banks) broadcast over the channel lanes, its B reads 8
//    consecutive float4 (128 bytes), each one wavefront.
//  - One barrier per slice: wait for the slice, barrier, refill the slot read last, then
//    the multiply-adds. Epilogue: the bias, then 16-byte stores straight from the
//    accumulators (a warp writes 4 runs of 128 contiguous bytes); 4-byte stores where Co
//    is not a multiple of 4. The ReLU stays with the caller.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBK = 16;         // k per slice of the ring
constexpr int kStages = 4;      // slices in flight
constexpr int kTM = 8;          // accumulator rows per thread
constexpr int kAPitch = kBK + 4;  // floats per row of A in shared memory

struct Conv {
  int B, H, W, Ci, Ho, Wo, Co, Np, KH, KW, stride, dil, ph, pw;
  int M, K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A through L1 (.ca: the taps of a 3x3 conv read overlapping rows of x), B through L2 only
__device__ __forceinline__ void cp_async16_ca(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// The position in K of one column of A: k and its (kh, kw, ci).
struct KPos {
  int k, kh, kw, ci;
  __device__ __forceinline__ void advance(int n, const Conv& c) {
    k += n;
    ci += n;
    while (ci >= c.Ci) {
      ci -= c.Ci;
      if (++kw == c.KW) { kw = 0; ++kh; }
    }
  }
  // whether the tap lies inside x for a row whose window starts at (ih0, iw0)
  __device__ __forceinline__ bool inside(int ih0, int iw0, const Conv& c) const {
    return k < c.K && (unsigned)(ih0 + kh * c.dil) < (unsigned)c.H &&
           (unsigned)(iw0 + kw * c.dil) < (unsigned)c.W;
  }
  // its offset in x from the row's window origin
  __device__ __forceinline__ int offset(const Conv& c) const {
    return ((kh * c.W + kw) * c.dil) * c.Ci + ci;
  }
};

template <int BN, int TN>
struct Tile {
  static constexpr int kNT = BN / TN;                 // threads along N
  static constexpr int kThreads = (kBM / kTM) * kNT;  // 256, 256, 128
  static constexpr int kARows = kBM * (kBK / 4) / kThreads;  // rows of A a thread loads
  static constexpr int kBChunks = kBK * BN / 4;             // 16-byte chunks of B a slice
  static constexpr int kAFloats = kBM * kAPitch;
  static constexpr int kBFloats = kBK * BN;
  static constexpr int kStageFloats = kAFloats + kBFloats;
  static constexpr int kSmem = kStages * kStageFloats * 4;
};

template <int BN, int TN, bool VEC>
__global__ void __launch_bounds__(Tile<BN, TN>::kThreads, (BN == 32 ? 4 : 2))
conv2d_fp32_igemm_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                         const float* __restrict__ bias, float* __restrict__ out, Conv c) {
  using T = Tile<BN, TN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // ---- the loaders' state: a thread fills column (tid % 4) * 4.. of A in kARows rows ----
  const int acol = (tid & 3) * 4;
  int ih0[T::kARows], iw0[T::kARows], rowoff[T::kARows];
#pragma unroll
  for (int j = 0; j < T::kARows; ++j) {
    const int m = m0 + (tid >> 2) + j * (T::kThreads / 4);
    if (m < c.M) {
      const int hw = c.Ho * c.Wo;
      const int b = m / hw;
      const int p = m - b * hw;
      const int oh = p / c.Wo;
      const int ow = p - oh * c.Wo;
      ih0[j] = oh * c.stride - c.ph;
      iw0[j] = ow * c.stride - c.pw;
      rowoff[j] = ((b * c.H + ih0[j]) * c.W + iw0[j]) * c.Ci;
    } else {
      ih0[j] = iw0[j] = -(1 << 29);   // every tap of a row past M is outside x
      rowoff[j] = 0;
    }
  }
  KPos pos;
  pos.k = acol;
  pos.ci = acol % c.Ci;
  const int tap = acol / c.Ci;
  pos.kh = tap / c.KW;
  pos.kw = tap - pos.kh * c.KW;

  auto load = [&](int slot, int kt) {
    float* As = smem + slot * T::kStageFloats;
    float* Bs = As + T::kAFloats;
#pragma unroll
    for (int j = 0; j < T::kARows; ++j) {
      float* dst = As + ((tid >> 2) + j * (T::kThreads / 4)) * kAPitch + acol;
      if (VEC) {
        const bool ok = pos.inside(ih0[j], iw0[j], c);
        cp_async16_ca(dst, ok ? x + rowoff[j] + pos.offset(c) : x, ok);
      } else {
        KPos e = pos;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = e.inside(ih0[j], iw0[j], c);
          cp_async4(dst + i, ok ? x + rowoff[j] + e.offset(c) : x, ok);
          e.advance(1, c);
        }
      }
    }
    pos.advance(kBK, c);
#pragma unroll
    for (int q = tid; q < T::kBChunks; q += T::kThreads) {
      const int kk = q / (BN / 4);
      const int nn = (q % (BN / 4)) * 4;
      const int k = kt * kBK + kk;
      const bool ok = k < c.K && n0 + nn < c.Np;
      cp_async16_cg(Bs + kk * BN + nn, ok ? wp + (size_t)k * c.Np + n0 + nn : wp, ok);
    }
  };

  // ---- the multiply-adds' layout: warp (wm, wn) covers 32 pixels x 32 channels a group ----
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (kBM / 32), wn = warp / (kBM / 32);
  const int ty = lane >> 3;
  const int tn = wn * 8 + (lane & 7);
  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int KT = (c.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt has landed for every thread; slot (kt - 1) is read
    const int next = kt + kStages - 1;
    if (next < KT) load(next % kStages, next);
    cp_async_commit();

    const float* As = smem + (kt % kStages) * T::kStageFloats;
    const float* Bs = As + T::kAFloats;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (wm * 32 + i * 4 + ty) * kAPitch + k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + (k4 + e) * BN + g * T::kNT * 4 + tn * 4);
          bv[g * 4 + 0] = v.x; bv[g * 4 + 1] = v.y; bv[g * 4 + 2] = v.z; bv[g * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: bias, then the stores ----
  const bool vec_out = (c.Co & 3) == 0;
#pragma unroll
  for (int g = 0; g < TN / 4; ++g) {
    const int n = n0 + g * T::kNT * 4 + tn * 4;
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = (bias != nullptr && n + e < c.Co) ? bias[n + e] : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + wm * 32 + i * 4 + ty;
      if (m >= c.M) continue;
      float* o = out + (size_t)m * c.Co + n;
      const float4 v = make_float4(acc[i][g * 4 + 0] + bv[0], acc[i][g * 4 + 1] + bv[1],
                                   acc[i][g * 4 + 2] + bv[2], acc[i][g * 4 + 3] + bv[3]);
      if (vec_out && n + 3 < c.Co) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < c.Co) o[e] = vs[e];
      }
    }
  }
}

// tile 0, 1, 2: BN 32, 64, 128 (nn.ops.conv2d_fp32.TILES); path 0 vector, 1 scalar
template <int BN, int TN>
int launch_tile(bool vec, const float* x, const float* wp, const float* bias, float* out,
                const Conv& c, cudaStream_t stream) {
  using T = Tile<BN, TN>;
  const void* fn = vec ? (const void*)conv2d_fp32_igemm_kernel<BN, TN, true>
                       : (const void*)conv2d_fp32_igemm_kernel<BN, TN, false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) {
    const dim3 grid((unsigned)((c.M + kBM - 1) / kBM), (unsigned)((c.Co + BN - 1) / BN));
    void* args[] = {(void*)&x, (void*)&wp, (void*)&bias, (void*)&out, (void*)&c};
    err = cudaLaunchKernel(fn, grid, dim3(T::kThreads), args, (size_t)T::kSmem, stream);
  }
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a tile or path it does not have, or for
// sizes that disagree; cudaErrorMisalignedAddress where the vector path's x, the packed
// weights or the output do not start on 16 bytes.
extern "C" int atvsnet_conv2d_fp32(const void* x, const void* wp, const void* bias, void* out,
                                   int B, int H, int W, int Ci, int Ho, int Wo, int Co, int Np,
                                   int KH, int KW, int stride, int dil, int ph, int pw,
                                   int tile, int path, void* stream) {
  Conv c{B, H, W, Ci, Ho, Wo, Co, Np, KH, KW, stride, dil, ph, pw, B * Ho * Wo, KH * KW * Ci};
  if (tile < 0 || tile > 2 || path < 0 || path > 1 || B < 1 || Ci < 1 || Co < 1 || Ho < 1 ||
      Wo < 1 || stride < 1 || dil < 1 || Np < Co || Np % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = path == 0;
  if ((vec && (Ci % 4 != 0 || (uintptr_t)x % 16)) || (uintptr_t)wp % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *xf = (const float*)x, *wf = (const float*)wp, *bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 0) return launch_tile<32, 4>(vec, xf, wf, bf, of, c, s);
  if (tile == 1) return launch_tile<64, 4>(vec, xf, wf, bf, of, c, s);
  return launch_tile<128, 8>(vec, xf, wf, bf, of, c, s);
}
