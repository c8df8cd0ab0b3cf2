// The soft-attention context of one decode step, in feature space: one
// block per batch row.
//
// Replaces show_tell_tpu/ops/attention_pallas.py::attention_context_pallas.
//
//   att2   = h[b] . W_dec^T + b_dec                          [A]  (f32)
//   e_p    = sum_a LeakyReLU_0.2(att1[b,p,a] + att2[a]) * w_full[a]
//            (b_full is softmax-invariant and dropped, as on the TPU)
//   alpha  = softmax_p(e)                                    [P]  (f32, out)
//   ctx    = sum_p alpha_p * feats[b,p,:]                    [C]  (feature dtype, out)
// att1 = feats @ W_enc + b_enc is a per-image constant computed once per
// decode outside the kernel.
//
// What bounds it on an H100.  At the flagship (C=2048, P=49, A=512, H=512)
// a row reads 49 x 2048 feature values and 49 x 512 att1 values (250 KB in
// bf16) and W_dec (512 KB in bf16, from L2 after the first block).  The
// feature stream is the one that grows with B (12.8 MB at B=64), so the
// design reads it once, coalesced: the threads of a block own 16-byte
// column chunks of C and walk the 49 positions.  W_dec is re-read by
// every row; a row tile that shares it is the obvious next step.  The TPU
// kernel's batch blocks of 8 rows bounded VMEM; a block per row needs no
// cross-block reduction, so the launch is a plain one.

#include "decode_common.cuh"

namespace {

struct Params {
  const void* feats;  // [B, P, C]  positions-major features
  const void* att1;   // [B, P, A]
  const void* h;      // [B, H]     the last layer's hidden state
  const void* wdec;   // [A, H]     decoder_att, torch layout
  const void* bdec;   // [A]
  const void* wfull;  // [A]
  void* ctx;          // [B, C]     out, feature dtype
  float* alpha;       // [B, P]     out
  int B, P, C, A, H;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_context_kernel(Params p) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, P = p.P, C = p.C, A = p.A, H = p.H;
  float* hrow = smem;           // [H]
  float* att2 = smem + H;       // [A]
  float* alpha = att2 + A;      // [P]: e, then exp(e - max)
  const T* wdec = static_cast<const T*>(p.wdec);
  const T* bdec = static_cast<const T*>(p.bdec);
  const T* wfull = static_cast<const T*>(p.wfull);
  const T* h = static_cast<const T*>(p.h) + static_cast<size_t>(b) * H;
  for (int k = threadIdx.x * N; k < H; k += kThreads * N) Vec<T>::ldg(h + k, hrow + k);
  __syncthreads();
  for (int a = warp; a < A; a += kWarps) {
    float acc = 0.0f;
    for (int k = lane * N; k < H; k += 32 * N) {
      float w[N];
      Vec<T>::ldg(wdec + static_cast<size_t>(a) * H + k, w);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += w[i] * hrow[k + i];
    }
    acc = warp_sum(acc);
    if (lane == 0) att2[a] = acc + Vec<T>::to_f32(bdec[a]);
  }
  __syncthreads();
  const T* att1 = static_cast<const T*>(p.att1) + static_cast<size_t>(b) * P * A;
  for (int q = warp; q < P; q += kWarps) {
    float acc = 0.0f;
    for (int k = lane * N; k < A; k += 32 * N) {
      float u[N], w[N];
      Vec<T>::ldg(att1 + static_cast<size_t>(q) * A + k, u);
      Vec<T>::ldg(wfull + k, w);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float v = u[i] + att2[k + i];
        acc += (v >= 0.0f ? v : 0.2f * v) * w[i];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) alpha[q] = acc;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int q = 0; q < P; ++q) m = fmaxf(m, alpha[q]);
  __syncthreads();  // every thread has read the scores
  for (int q = threadIdx.x; q < P; q += kThreads) alpha[q] = expf(alpha[q] - m);
  __syncthreads();
  float sum = 0.0f;
  for (int q = 0; q < P; ++q) sum += alpha[q];
  for (int q = threadIdx.x; q < P; q += kThreads) p.alpha[static_cast<size_t>(b) * P + q] = alpha[q] / sum;
  const T* feats = static_cast<const T*>(p.feats) + static_cast<size_t>(b) * P * C;
  T* ctx = static_cast<T*>(p.ctx) + static_cast<size_t>(b) * C;
  for (int c = threadIdx.x * N; c < C; c += kThreads * N) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
    for (int q = 0; q < P; ++q) {
      float f[N];
      Vec<T>::ldg(feats + static_cast<size_t>(q) * C + c, f);
      const float a = alpha[q] / sum;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += a * f[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ctx[c + i] = Vec<T>::from_f32(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.H + p.A + p.P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_context_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attention_context_kernel<T><<<p.B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feats, att1, h and the weights share it).
// Returns a cudaError_t (0 on success).
extern "C" int st_attention_context(int dtype, const void* feats, const void* att1, const void* h,
                                    const void* wdec, const void* bdec, const void* wfull, void* ctx,
                                    float* alpha, int B, int P, int C, int A, int H, void* stream) {
  Params p{feats, att1, h, wdec, bdec, wfull, ctx, alpha, B, P, C, A, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
