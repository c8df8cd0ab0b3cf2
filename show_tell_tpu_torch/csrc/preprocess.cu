// The serving preprocess of uint8 images, in the layout they arrive in:
//   y[i] = ((float(x[i]) * (1/255)) - mean[c]) / std[c],   c = i % 3
// cast to float32 or bfloat16.  x is NHWC with 3 channels (RGB) or 12
// (space-to-depth, channel k = (di, dj, c) holds colour k % 3); either way
// element i's colour is i % 3, so the kernel sees a flat array.
//
// Replaces show_tell_tpu/ops/preprocess_pallas.py::preprocess_images_pallas.
//
// What bounds it on an H100: bytes, 1 in and 4 (f32) or 2 (bf16) out per
// element; nothing is reused.  A grid-stride loop over 16-byte chunks: each
// thread loads one uint4 (16 pixels' bytes) and writes 16 outputs as 16-byte
// stores.  The arithmetic copies the plain twin's as PyTorch runs it on the
// card, operation by operation, so the two agree bit for bit: a division by
// a Python scalar runs there as a multiplication by its float reciprocal,
// the mean and std tensors as a subtraction and a true division.  The
// intrinsics (__fmul_rn, __fsub_rn, __fdiv_rn) keep nvcc from contracting
// the multiply and subtract into one fused multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Consts {
  float inv255;
  float mean[3];
  float stdev[3];
};

__device__ __forceinline__ float normalize(uint32_t u, float inv255, float mean, float stdev) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(static_cast<float>(u), inv255), mean), stdev);
}

// Colour c's constant without indexing the parameter struct at run time.
__device__ __forceinline__ float pick(const float* v, int c) { return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]); }

__device__ __forceinline__ void store16(float* out, const float* y) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* y) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);  // round to nearest even, as .to(bf16)
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(w[0], w[1], w[2], w[3]);
  o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void store1(float* out, float y) { *out = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float y) { *out = __float2bfloat16_rn(y); }

template <typename T>
__global__ void preprocess_kernel(const uint8_t* __restrict__ x, T* __restrict__ y, long long n, Consts k) {
  const long long chunks = n / 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < chunks; i += stride) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    const int c0 = static_cast<int>(i % 3);  // the colour of element 16 i: (16 i) % 3 == i % 3
    float mean[3], stdev[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      mean[r] = pick(k.mean, (c0 + r) % 3);
      stdev[r] = pick(k.stdev, (c0 + r) % 3);
    }
    float out[16];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      out[e] = normalize((words[e / 4] >> (8 * (e % 4))) & 0xffu, k.inv255, mean[e % 3], stdev[e % 3]);
    store16(y + 16 * i, out);
  }
  // the ragged end: fewer than 16 elements, one thread each
  const long long tail = chunks * 16 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tail < n) {
    const int c = static_cast<int>(tail % 3);
    store1(y + tail, normalize(x[tail], k.inv255, pick(k.mean, c), pick(k.stdev, c)));
  }
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const uint8_t* x, void* y, long long n, const Consts& k, cudaStream_t stream) {
  int sms = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long chunks = n / 16;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // 8 resident 256-thread blocks an SM; the loop strides over the rest
  if (blocks < 1) blocks = 1;                   // the tail alone
  preprocess_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(x, static_cast<T*>(y), n, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 output.  x and y 16-byte aligned, n elements.
// Returns a cudaError_t (0 on success).
extern "C" int st_preprocess(int dtype, const void* x, void* y, long long n, float inv255, float m0, float m1, float m2,
                             float s0, float s1, float s2, void* stream) {
  Consts k{inv255, {m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  if (dtype == 0) return static_cast<int>(launch<float>(xp, y, n, k, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(xp, y, n, k, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
