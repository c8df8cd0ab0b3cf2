// The ResNet stem of the space-to-depth serving path, straight from uint8
// pixels: normalize + conv1 + eval-mode BN + relu (+ 3x3/s2 maxpool, pad 1).
//
//   y[p, q, o] = relu( sum_{a, b < 4, k < 12} x[p+a-2, q+b-2, k] * w[(a*4+b)*12 + k, o] + t[p, q, o] )
//   out[r, s, o] = max over p in 2r-1..2r+1, q in 2s-1..2s+1 inside [0, 112) of y[p, q, o]
//
// x is the s2d image [B, 112, 112, 12] (channel k = (di, dj, c)), or the RGB
// image [B, 224, 224, 3] read through x[i, j, (di, dj, c)] = rgb[2i+di,
// 2j+dj, c]; taps outside [0, 112) are zero, so no padded copy is needed.
// w [192, 64] is conv1 as the 4x4/s1 s2d kernel with BN's multiplier and
// the normalize scale 1/(255 std_c) folded in (K order (a, b, di, dj, c),
// ops/stem.py prepare_stem); t [112, 112, 64] f32 carries the normalize
// shift through the convolution, only where a tap lies inside the image
// (conv1 pads after normalization), plus BN's bias.  Output in the compute
// dtype, NHWC [B, 56, 56, 64] (pool) or [B, 112, 112, 64].
//
// Replaces show_tell_tpu/ops/stem_pallas.py::stem_fused_pallas.
//
// What bounds it on an H100: operations, 112 x 112 x 64 x 192 multiply-adds
// an image against 147 KB in and 392 KB (bf16, pooled) out.  This first
// kernel runs them as f32 FMAs on the SIMT units (the bound assumes the
// bf16 tensor cores; mma/wgmma with positions as M is later work).  Design:
// one CTA per (image, band of 7 pooled rows, or 14 conv rows without the
// pool), 224 threads, each owning 4 adjacent conv columns x 8 output
// channels (32 f32 accumulators).  The CTA walks its band's conv rows in
// order; the 4 s2d input rows a conv row reads sit in a ring in shared
// memory as f32 (one row enters per conv row), and the folded weights sit
// there as f32 for the whole band.  Rows pool in registers as they pass
// (conv row 2r+1 closes pooled row r and opens r+1); columns pool across
// threads through one shared-memory row of each thread's last column.  Only
// the pooled rows reach device memory: the [112, 112, 64] conv activation
// never does.  Relu makes every value >= 0 and every window holds at least
// one in-image value, so 0 stands in for the pool's -inf padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 112;                      // s2d side, conv1's output side
constexpr int kK = 12;                       // s2d channels
constexpr int kC = 64;                       // output channels
constexpr int kTaps = 16 * kK;               // 192
constexpr int kPitch = kS + 4;               // a smem input row holds cols -2 .. 113 (zeros outside)
constexpr int kSlot = kK * kPitch;           // one s2d row, [k][col]
constexpr int kGroups = kS / 4;              // 28 groups of 4 conv columns
constexpr int kThreads = kGroups * 8;        // x 8 channel groups = 224
constexpr int kBands = 8;                    // CTAs an image
constexpr int kPoolRows = kS / 2 / kBands;   // 7 pooled rows a band
constexpr int kConvRows = kS / kBands;       // 14 conv rows a band without the pool
constexpr int kSmemFloats = 4 * kSlot + kTaps * kC + kGroups * kC;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 78,592

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 consecutive channels out, as one 16-byte (f32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* out, const float* v) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(out) = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// s2d row i of image b into ring slot `dst` ([k][col + 2]); rows outside the image are zeros.
__device__ __forceinline__ void load_row(float* dst, const uint8_t* __restrict__ x, int b, int i, bool rgb) {
  if (i < 0 || i >= kS) {
    for (int e = threadIdx.x; e < kS * kK; e += kThreads) dst[(e / kS) * kPitch + e % kS + 2] = 0.f;
    return;
  }
  if (rgb) {  // rgb rows 2i (di = 0) and 2i+1 (di = 1): byte e of a row is col e / 6, (dj, c) = e % 6
    const uint8_t* src = x + (static_cast<size_t>(b) * 2 * kS + 2 * i) * 2 * kS * 3;
    for (int e = threadIdx.x; e < 2 * 6 * kS; e += kThreads) {
      const int di = e / (6 * kS), r = e % (6 * kS);
      dst[(di * 6 + r % 6) * kPitch + r / 6 + 2] = static_cast<float>(src[e]);
    }
  } else {    // byte e of an s2d row is col e / 12, channel e % 12
    const uint8_t* src = x + (static_cast<size_t>(b) * kS + i) * kS * kK;
    for (int e = threadIdx.x; e < kS * kK; e += kThreads) dst[(e % kK) * kPitch + e / kK + 2] = static_cast<float>(src[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const uint8_t* __restrict__ x, const T* __restrict__ w, const float* __restrict__ t, T* __restrict__ out,
            bool rgb, bool pool) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4 slots][kK][kPitch]
  float* ws = xs + 4 * kSlot;                    // [kTaps][kC]
  float* xch = ws + kTaps * kC;                  // [kGroups][kC]: each group's last column, for the column pool

  const int b = blockIdx.y;
  const int g = threadIdx.x >> 3, cg = threadIdx.x & 7;  // columns 4g..4g+3; channels cg*4 + {0..3} and 32 + cg*4 + {0..3}
  int p_begin, p_end;
  if (pool) {
    const int r0 = blockIdx.x * kPoolRows;
    p_begin = r0 > 0 ? 2 * r0 - 1 : 0;
    p_end = 2 * (r0 + kPoolRows);
  } else {
    p_begin = blockIdx.x * kConvRows;
    p_end = p_begin + kConvRows;
  }

  for (int e = threadIdx.x; e < kTaps * kC; e += kThreads) ws[e] = to_f32(w[e]);
  for (int e = threadIdx.x; e < 4 * kK * 4; e += kThreads) {  // the pad columns -2, -1, 112, 113 of every slot row
    const int c = e & 3;
    xs[(e >> 2) * kPitch + (c < 2 ? c : kS + c)] = 0.f;
  }
  for (int i = p_begin - 2; i <= p_begin + 1; ++i) load_row(xs + (i & 3) * kSlot, x, b, i, rgb);
  __syncthreads();

  float cur[4][8];  // the running max over the pooled row's window rows
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 8; ++o) cur[j][o] = 0.f;

  for (int p = p_begin; p < p_end; ++p) {
    if (p > p_begin) {
      __syncthreads();  // every thread is done with row p-3's slot
      load_row(xs + ((p + 1) & 3) * kSlot, x, b, p + 1, rgb);
      __syncthreads();
    }
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = 0.f;
#pragma unroll 1
    for (int a = 0; a < 4; ++a) {
      const float* xrow = xs + ((p + a - 2) & 3) * kSlot + 4 * g;  // cols 4g-2 .. 4g+4 at offsets 0..6
      const float* wa = ws + a * 4 * kK * kC + cg * 4;
#pragma unroll 2
      for (int k = 0; k < kK; ++k) {
        const float4 x0 = *reinterpret_cast<const float4*>(xrow + k * kPitch);
        const float2 x1 = *reinterpret_cast<const float2*>(xrow + k * kPitch + 4);
        const float xv[7] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, xrow[k * kPitch + 6]};
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float* wr = wa + (bb * kK + k) * kC;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[j][o] = fmaf(xv[j + bb], wv[o], acc[j][o]);
        }
      }
    }
    // + t, relu
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* tr = t + (static_cast<size_t>(p) * kS + 4 * g + j) * kC + cg * 4;
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(tr));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(tr + 32));
      const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = fmaxf(acc[j][o] + tv[o], 0.f);
    }
    if (!pool) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T* dst = out + ((static_cast<size_t>(b) * kS + p) * kS + 4 * g + j) * kC + cg * 4;
        store4(dst, acc[j]);
        store4(dst + 32, acc[j] + 4);
      }
      continue;
    }
    const bool closes = (p & 1) && p > p_begin;  // conv row 2r+1 closes pooled row r (and opens r+1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) cur[j][o] = (p & 1) && !closes ? acc[j][o] : fmaxf(cur[j][o], acc[j][o]);
    if (!closes) continue;
    const int r = (p - 1) / 2;
#pragma unroll
    for (int o = 0; o < 8; ++o) xch[g * kC + (o >> 2) * 32 + cg * 4 + (o & 3)] = cur[3][o];
    __syncthreads();
    float pooled[2][8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float left = g > 0 ? xch[(g - 1) * kC + (o >> 2) * 32 + cg * 4 + (o & 3)] : 0.f;  // column 4g-1
      pooled[0][o] = fmaxf(left, fmaxf(cur[0][o], cur[1][o]));
      pooled[1][o] = fmaxf(cur[1][o], fmaxf(cur[2][o], cur[3][o]));
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      T* dst = out + ((static_cast<size_t>(b) * (kS / 2) + r) * (kS / 2) + 2 * g + s) * kC + cg * 4;
      store4(dst, pooled[s]);
      store4(dst + 32, pooled[s] + 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) cur[j][o] = acc[j][o];  // row 2r+1 opens pooled row r+1
  }
}

template <typename T>
cudaError_t launch(const uint8_t* x, const void* w, const float* t, void* out, int B, bool rgb, bool pool,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  stem_kernel<T><<<dim3(kBands, B), kThreads, kSmemBytes, stream>>>(x, static_cast<const T*>(w), t,
                                                                    static_cast<T*>(out), rgb, pool);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w and out).  layout: 0 = s2d [B,112,112,12],
// 1 = RGB [B,224,224,3].  pool: 1 = [B,56,56,64] out, 0 = [B,112,112,64].
// Returns a cudaError_t (0 on success).
extern "C" int st_stem(int dtype, int layout, int pool, const void* x, const void* w, const void* t, void* out, int B,
                       void* stream) {
  if (B < 1 || B > 65535 || (layout != 0 && layout != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const float* tp = static_cast<const float*>(t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(xp, w, tp, out, B, layout == 1, pool != 0, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(xp, w, tp, out, B, layout == 1, pool != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
