// The plane-sweep sampler for Hopper (sm_90a): geometry.warp._sample in one pass. For an
// image (B, H, W, C) channel-last and texture coordinates x, y (B, P) fp32 it writes
//
//   valid[b, p]    = x' = x - 0.5, y' = y - 0.5 finite and in [0, W-1) x [0, H-1)
//   bilinear[b, p] = ((wa A + wb B) + wc C) + wd D, the four corners of (x', y')
//   nearest[b, p]  = image[b, rint(y'), rint(x'), c0 : c0 + Cn]     (round half to even)
//
// and nothing else: each output once, the source map and the coordinates read once each
// (the corners hit L2). An invalid sample's coordinates are zeroed first, so its bilinear
// weights vanish (x1 = y1 = 0) and its nearest sample reads pixel (0, 0) of its own batch
// element, as the reference's sampler does.
//
// The arithmetic is _sample's on aten, operation by operation, so the kernel gives its bits:
// x - 0.5 in fp32; floor and rint; the weights (y1 - y')(x1 - x') etc. in fp32, then
// rounded to the image's dtype; the sum in the image's dtype, left to right. In fp32 every
// product and sum is __fmul_rn / __fadd_rn (no FMA contraction); in bf16 each operand is
// widened to fp32 and each product and sum rounded back to bf16 (cvt.rn), as aten's
// elementwise kernels do. Corner reads of an invalid sample still happen (pixel (0, 0),
// weight 0), so a non-finite pixel there propagates as it does on aten.
//
// Replaces no TPU kernel: the JAX package's sampler is XLA's (atvsnet_tpu/geometry/warp.py;
// Mosaic could not lower in-kernel gathers). It replaces aten's chain under the port's
// _sample: ~60 small passes over (B, P) for indices, clamps, casts and weights, four
// index_select gathers (vectorized_gather_kernel) of whole (B, P, C) volumes, four
// broadcast multiplies and three adds.
//
// Bound, per call: the coordinates read once (8 bytes a sample), the source map read once,
// every output and the mask written once, over 3.35 TB/s. It is memory-bound: ~20 fp32
// operations per sample and channel group against 16-64 bytes moved.
//
// Design:
//  - One thread per (sample, channel group). A group is 16 bytes of channels (4 fp32 or 8
//    bf16): on the "vector" path one 16-byte load a corner and one 16-byte store, on the
//    "scalar" path element loads and stores (the last group of a sample may hold fewer
//    channels). A block is G x S threads: x the G groups of a sample, y S = 256 / G
//    consecutive samples, so a warp's stores are one contiguous run of the channel-last
//    output (512 bytes at C = 32 fp32) and its corner loads whole rows; the grid's y is the
//    batch. A thread's fixed work (its coordinates, validity and weights) is what bounds
//    the scalar path, so no thread divides an index, and a scalar thread takes a whole
//    group: on an H100 one channel a thread ran the 17-channel sweep 2.1x slower, and a
//    flat index split by 64-bit divisions the 32-channel sweep 8% slower.
//  - The vector path needs C and the nearest slice's start and width to be multiples of a
//    group, and a 16-byte aligned image; anything else (the refinement's 17-channel source,
//    the 1-channel depth maps, 3-channel images) takes the scalar path. The wrapper picks
//    from what the input shows (ops/plane_sweep.py `plan`).
//  - Corner reads go through the read-only path and hit L2: within a plane the homography
//    is nearly affine, so neighbouring samples share corners, and one source map (3.4 MB at
//    120x224x32 fp32) stays in the 50 MB L2 while its sweep is written. Stores are
//    streaming (st.global.cs) so that the output does not evict the map.
//  - No shared memory, no atomics, one fixed order of operations: the same bits every call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Sweep {
  int H, W, C, c0, cn, P;
};

// V channels of a dtype, loaded and stored as one unit
template <typename T, int V> struct Pack;
template <> struct Pack<float, 1> {
  using U = float;
  static __device__ __forceinline__ void unpack(U u, float* v) { v[0] = u; }
};
template <> struct Pack<float, 4> {
  using U = float4;
  static __device__ __forceinline__ void unpack(U u, float* v) {
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
};
template <> struct Pack<__nv_bfloat16, 1> {
  using U = unsigned short;
  static __device__ __forceinline__ void unpack(U u, float* v) {
    v[0] = __uint_as_float((uint32_t)u << 16);
  }
};
template <> struct Pack<__nv_bfloat16, 8> {
  using U = uint4;
  static __device__ __forceinline__ void unpack(U u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// rounding of an fp32 result to the image's dtype (the identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {   // v is already a bf16 value
  return __float_as_uint(v) >> 16;
}

template <typename T, int V> __device__ __forceinline__ typename Pack<T, V>::U pack(const float* v);
template <> __device__ __forceinline__ float pack<float, 1>(const float* v) { return v[0]; }
template <> __device__ __forceinline__ float4 pack<float, 4>(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ unsigned short pack<__nv_bfloat16, 1>(const float* v) {
  return (unsigned short)bf16_bits(v[0]);
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16, 8>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* v) {
  using U = typename Pack<T, V>::U;
  Pack<T, V>::unpack(__ldg(reinterpret_cast<const U*>(p)), v);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v) {
  using U = typename Pack<T, V>::U;
  __stcs(reinterpret_cast<U*>(p), pack<T, V>(v));
}

// the n <= V channels of a group from p (16 bytes at once on the vector path; element by
// element on the scalar path, which reads and writes only the first n)
template <typename T, bool VEC>
__device__ __forceinline__ void load_group(const T* p, float* v, int n) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (VEC) {
    load<T, V>(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = 0.0f;
      if (k < n) load<T, 1>(p + k, v + k);
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_group(T* p, const float* v, int n) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (VEC) {
    store<T, V>(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < n) store<T, 1>(p + k, v + k);
  }
}

template <typename T, bool VEC, bool BIL, bool NEAR>
__global__ void __launch_bounds__(kThreads)
plane_sweep_gather_kernel(const T* __restrict__ image, const float* __restrict__ xs,
                          const float* __restrict__ ys, T* __restrict__ out,
                          T* __restrict__ near_out, unsigned char* __restrict__ valid_out,
                          const Sweep s) {
  constexpr int V = 16 / sizeof(T);                  // channels a group
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= s.P) return;
  const int ch = threadIdx.x * V;                    // first channel of this group
  const long long b = blockIdx.y;
  const long long sample = b * s.P + p;
  const int H = s.H, W = s.W, C = s.C;

  float x = __fsub_rn(__ldg(xs + sample), 0.5f);
  float y = __fsub_rn(__ldg(ys + sample), 0.5f);
  const bool ok = isfinite(x) && isfinite(y) && x >= 0.0f && y >= 0.0f &&
                  x < (float)(W - 1) && y < (float)(H - 1);
  if (!ok) { x = 0.0f; y = 0.0f; }   // before floor and rint: the integer casts stay defined
  const T* img = image + b * H * W * (long long)C;

  if (NEAR && ch < s.cn) {
    const int ix = (int)rintf(x), iy = (int)rintf(y);
    float v[V];
    load_group<T, VEC>(img + ((long long)iy * W + ix) * C + s.c0 + ch, v, s.cn - ch);
    store_group<T, VEC>(near_out + sample * s.cn + ch, v, s.cn - ch);
  }
  if (BIL && ch < C) {
    int x0 = (int)floorf(x), y0 = (int)floorf(y);
    // an invalid sample gets x1 = y1 = 0 (= x' = x0 = y0): all four weights vanish
    int x1 = ok ? x0 + 1 : 0, y1 = ok ? y0 + 1 : 0;
    x0 = min(max(x0, 0), W - 1);
    y0 = min(max(y0, 0), H - 1);
    const float x0f = (float)x0, x1f = (float)x1, y0f = (float)y0, y1f = (float)y1;
    const float wa = round_to<T>(__fmul_rn(__fsub_rn(y1f, y), __fsub_rn(x1f, x)));
    const float wb = round_to<T>(__fmul_rn(__fsub_rn(y1f, y), __fsub_rn(x, x0f)));
    const float wc = round_to<T>(__fmul_rn(__fsub_rn(y, y0f), __fsub_rn(x1f, x)));
    const float wd = round_to<T>(__fmul_rn(__fsub_rn(y, y0f), __fsub_rn(x, x0f)));
    x1 = min(x1, W - 1);
    y1 = min(y1, H - 1);
    float a[V], bb[V], c[V], d[V];
    const int n = C - ch;
    load_group<T, VEC>(img + ((long long)y0 * W + x0) * C + ch, a, n);
    load_group<T, VEC>(img + ((long long)y0 * W + x1) * C + ch, bb, n);
    load_group<T, VEC>(img + ((long long)y1 * W + x0) * C + ch, c, n);
    load_group<T, VEC>(img + ((long long)y1 * W + x1) * C + ch, d, n);
    float r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float acc = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(wa, a[k])),
                                        round_to<T>(__fmul_rn(wb, bb[k]))));
      acc = round_to<T>(__fadd_rn(acc, round_to<T>(__fmul_rn(wc, c[k]))));
      r[k] = round_to<T>(__fadd_rn(acc, round_to<T>(__fmul_rn(wd, d[k]))));
    }
    store_group<T, VEC>(out + sample * C + ch, r, n);
  }
  if (ch == 0) __stcs(valid_out + sample, (unsigned char)ok);
}

template <typename T, bool VEC, bool BIL, bool NEAR>
int launch(const void* image, const float* x, const float* y, void* out, void* near_out,
           unsigned char* valid, const Sweep& s, int B, int groups, cudaStream_t stream) {
  const int per_block = kThreads / groups;          // samples a block
  const long long blocks = ((long long)s.P + per_block - 1) / per_block;
  if (blocks > 0)
    plane_sweep_gather_kernel<T, VEC, BIL, NEAR>
        <<<dim3((unsigned)blocks, (unsigned)B), dim3(groups, per_block), 0, stream>>>(
            (const T*)image, x, y, (T*)out, (T*)near_out, valid, s);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch(int bilinear, int nearest, const void* image, const float* x, const float* y,
             void* out, void* near_out, unsigned char* valid, const Sweep& s, int B, int groups,
             cudaStream_t st) {
  if (bilinear && nearest)
    return launch<T, VEC, true, true>(image, x, y, out, near_out, valid, s, B, groups, st);
  if (bilinear) return launch<T, VEC, true, false>(image, x, y, out, near_out, valid, s, B, groups, st);
  return launch<T, VEC, false, true>(image, x, y, out, near_out, valid, s, B, groups, st);
}

}  // namespace

// image (B, H, W, C) of dtype 0 (fp32) or 1 (bf16), x and y (B, P) fp32, all contiguous;
// out (B, P, C) when bilinear, near (B, P, cn) when cn > 0 (the channels c0 .. c0 + cn),
// valid (B, P) bytes. path 0 is the vector path, 1 the scalar one. Returns a cudaError_t:
// cudaErrorInvalidValue for sizes that disagree, nothing asked for, more than 256 channel
// groups, B over 65535, or P or a batch element's H * W * C beyond 32-bit indexing;
// cudaErrorMisalignedAddress where the vector path cannot take the image.
extern "C" int atvsnet_plane_sweep(const void* image, const void* x, const void* y, void* out,
                                   void* near_out, void* valid, int B, int H, int W, int C,
                                   long long P, int c0, int cn, int bilinear, int dtype,
                                   int path, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 0 || c0 < 0 || cn < 0 || c0 + cn > C ||
      dtype < 0 || dtype > 1 || path < 0 || path > 1 || (!bilinear && cn == 0) ||
      (bilinear && !out) || (cn > 0 && !near_out) || !valid)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;    // channels a group: 16 bytes
  if (path == 0 && (C % V || c0 % V || cn % V || (uintptr_t)image % 16 ||
                    (bilinear && (uintptr_t)out % 16) || (cn > 0 && (uintptr_t)near_out % 16)))
    return (int)cudaErrorMisalignedAddress;
  const int widest = bilinear ? C : cn;   // cn <= C
  const int groups = (widest + V - 1) / V;
  if (groups > kThreads || B > 65535 || P > 0x7fffffffLL ||
      (long long)H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Sweep s{H, W, C, c0, cn, (int)P};
  const float *xf = (const float*)x, *yf = (const float*)y;
  unsigned char* vb = (unsigned char*)valid;
  cudaStream_t st = (cudaStream_t)stream;
  const int near = cn > 0;
  if (dtype == 0)
    return path == 0
        ? dispatch<float, true>(bilinear, near, image, xf, yf, out, near_out, vb, s, B, groups, st)
        : dispatch<float, false>(bilinear, near, image, xf, yf, out, near_out, vb, s, B, groups, st);
  return path == 0
      ? dispatch<__nv_bfloat16, true>(bilinear, near, image, xf, yf, out, near_out, vb, s, B,
                                      groups, st)
      : dispatch<__nv_bfloat16, false>(bilinear, near, image, xf, yf, out, near_out, vb, s, B,
                                       groups, st);
}
