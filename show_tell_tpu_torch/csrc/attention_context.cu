// The soft-attention context of one decode step, in feature space, spread
// over the card: one cooperative launch of three phases.
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
// What bounds it on an H100: bytes.  At the flagship (C=2048, P=49,
// A=512, H=512) a row reads 49 x 2048 feature values and 49 x 512 att1
// values (250 KB in bf16), and the call reads W_dec (512 KB in bf16) once:
// 16.9 MB at B=64, 5.1 us at 3.35 TB/s.  So the design spreads every
// phase over the card (a block a row would leave 131 SMs idle at B=1),
// reads W_dec once per 32 batch rows, keeps each lane's loads of all its
// positions in flight together, and reduces over P by warp shuffles.
//
// The design: items go round the cooperative grid (launch_cooperative),
// phases end in grid barriers, and what a phase reads that another block
// wrote in this launch (att2, alpha) it reads through L2 only (__ldcg).
// - Phase 1, att2 into a [B, A] f32 scratch.  bf16: a tensor-core product
//   on dense_mma.cuh's tiles (mma_project): W_dec's rows (A) as M, the
//   batch rows as N, both K-contiguous in their torch layouts (the K
//   permutation of mma_load is a lane mapping, the same for both, so W_dec
//   needs no permuted copy), f32 sums; an item is 64 rows of W_dec x 32
//   batch rows, its K split over the four warps and added in warp order,
//   so W_dec is read once per 32 batch rows, not once per row.  f32 (the
//   parity dtype; the tensor cores would take it as TF32): a warp per (row
//   of W_dec, 8 batch rows), lanes over 16-byte chunks of K, the warp's
//   sums by shuffles.
// - Phase 2, scores and softmax, a block per row: warp w scores positions
//   w, w + 4, ... with the att1 loads of up to kBatch = 16 positions in
//   flight at once (13 at P=49: all of them), lanes over 16-byte chunks of
//   A, each position's sum by shuffles into shared memory; warp 0 then
//   takes the row's max and sum over P by warp reductions and writes
//   alpha.  (A warp per (row, position) spreads B=1 over 13 blocks, but
//   leaves the softmax to every item of phase 3, an L2 round trip and a
//   block barrier each; on the H100 it was faster at B=1 and slower at
//   B=256, PERF.md.)
// - Phase 3, the context: an item is (row, 32 x 16 bytes of channels: 256
//   in bf16, 128 in f32), B x 8 items at C=2048 in bf16, so at B=64 every
//   SM pulls features and at B=1 eight do.  Warp w sums the positions w,
//   w + 4, ... of its lanes' channels: each lane issues its feature and
//   alpha loads of up to kBatch positions before it uses one, then the four
//   warps' partial sums are added in warp order through shared memory and
//   stored in the feature dtype, 16 bytes a lane.
// One launch with two grid barriers (1.62 us each, PERF.md) rather than
// three plain launches: the composite decode calls it 25 times a request,
// and each launch costs the host a ctypes call and the card a launch gap.

#include <type_traits>

#include "dense_mma.cuh"

namespace {

constexpr int kBatch = 16;  // positions whose loads a lane has in flight at once (phases 2 and 3)

struct Params {
  const void* feats;  // [B, P, C]  positions-major features
  const void* att1;   // [B, P, A]
  const void* h;      // [B, H]     the last layer's hidden state
  const void* wdec;   // [A, H]     decoder_att, torch layout
  const void* bdec;   // [A]
  const void* wfull;  // [A]
  void* ctx;          // [B, C]     out, feature dtype
  float* alpha;       // [B, P]     out
  float* att2;        // [B, A]     scratch: phase 1 -> 2
  int B, P, C, A, H;
};

// Channels a phase-3 item: a warp's 16-byte loads across one position.
template <typename T>
__host__ __device__ constexpr int ctx_cols() {
  return 32 * (16 / static_cast<int>(sizeof(T)));
}

// Floats of shared memory: phase 1's staged sums (bf16), phase 2's scores [P], phase 3's partial sums [4][cols].
template <typename T>
size_t smem_floats(int P) {
  size_t n = std::is_same<T, __nv_bfloat16>::value ? kMmaSmemFloats : 0;
  n = n > static_cast<size_t>(P) ? n : static_cast<size_t>(P);
  const size_t part = static_cast<size_t>(kWarps) * ctx_cols<T>();
  return n > part ? n : part;
}

// 16 bytes of T as floats, and back (rounded to nearest even).
template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float* out) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    Vec<__nv_bfloat16>::unpack(u, out);
  } else {
    out[0] = __uint_as_float(u.x), out[1] = __uint_as_float(u.y), out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
}
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Phase 1: att2[b, a] = h[b] . wdec[a] + bdec[a] for all B rows.
template <typename T>
__device__ void att2_phase(const Params& p, float* smem) {
  const T* h = static_cast<const T*>(p.h);
  const T* wdec = static_cast<const T*>(p.wdec);
  const T* bdec = static_cast<const T*>(p.bdec);
  const int B = p.B, A = p.A, H = p.H;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    mma_project(h, wdec, B, H, A, smem, [&](int n0, int nb, int a0) {
      for (int o = threadIdx.x; o < kMmaVocabRows * kMmaSlab; o += kThreads) {  // a batch row's 64 values together
        const int m = o % kMmaVocabRows, n = o / kMmaVocabRows, a = a0 + m;
        if (n < nb && a < A)
          p.att2[static_cast<size_t>(n0 + n) * A + a] = mma_sum(smem, m >> 4, m & 15, n) + __bfloat162float(bdec[a]);
      }
    });
  } else {
    const int lane = threadIdx.x & 31, tiles = (B + kBM - 1) / kBM;
    for (int task = blockIdx.x * kWarps + (threadIdx.x >> 5); task < A * tiles; task += gridDim.x * kWarps) {
      const int a = task % A, b0 = task / A * kBM, nb = min(kBM, B - b0);
      float acc[kBM] = {};
      for (int k = lane * 4; k < H; k += 32 * 4) {
        float w[4];
        Vec<float>::ldg(wdec + static_cast<size_t>(a) * H + k, w);
#pragma unroll
        for (int b = 0; b < kBM; ++b) {
          if (b < nb) {
            float x[4];
            Vec<float>::ldg(h + static_cast<size_t>(b0 + b) * H + k, x);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[b] += w[i] * x[i];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBM; ++b) {
        const float s = warp_sum(acc[b]);
        if (lane == 0 && b < nb) p.att2[static_cast<size_t>(b0 + b) * A + a] = s + bdec[a];
      }
    }
  }
}

// Phase 2: alpha[b] = softmax_q(e[b, q]), e[b, q] = sum_a LeakyReLU_0.2(att1[b, q, a] + att2[b, a]) wfull[a], a block
// per row: warp w scores the positions w, w + 4, ... (up to kBatch of them at once, their att1 loads in flight
// together), lanes over 16-byte chunks of A, the warp's sums by shuffles; then warp 0 takes the row's softmax.
template <typename T>
__device__ void score_phase(const Params& p, float* es) {
  constexpr int N = Vec<T>::N;
  const T* att1 = static_cast<const T*>(p.att1);
  const T* wfull = static_cast<const T*>(p.wfull);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, P = p.P, A = p.A;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const T* u0 = att1 + static_cast<size_t>(b) * P * A;
    const float* a2 = p.att2 + static_cast<size_t>(b) * A;
    __syncthreads();  // the previous row's softmax is done with es
    for (int q0 = warp; q0 < P; q0 += kWarps * kBatch) {
      float acc[kBatch] = {};
      for (int k = lane * N; k < A; k += 32 * N) {
        float s[N], w[N];
#pragma unroll
        for (int i = 0; i < N; i += 4) Vec<float>::ldcg(a2 + k + i, s + i);
        Vec<T>::ldg(wfull + k, w);
        uint4 u[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = q0 + j * kWarps;
          if (q < P) u[j] = __ldg(reinterpret_cast<const uint4*>(u0 + static_cast<size_t>(q) * A + k));
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (q0 + j * kWarps < P) {
            float x[N];
            unpack16<T>(u[j], x);
#pragma unroll
            for (int i = 0; i < N; ++i) {
              const float v = x[i] + s[i];
              acc[j] += (v >= 0.0f ? v : 0.2f * v) * w[i];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float v = warp_sum(acc[j]);
        if (lane == 0 && q0 + j * kWarps < P) es[q0 + j * kWarps] = v;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY;
      for (int q = lane; q < P; q += 32) m = fmaxf(m, es[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.0f;
      for (int q = lane; q < P; q += 32) sum += expf(es[q] - m);
      sum = warp_sum(sum);
      for (int q = lane; q < P; q += 32) p.alpha[static_cast<size_t>(b) * P + q] = expf(es[q] - m) / sum;
    }
  }
}

// Phase 3: ctx[b] = sum_q alpha[b, q] feats[b, q], by (row, channel chunk) items: warp w sums the positions w, w + 4,
// ... of its lanes' 16-byte chunks (every feature and alpha load of a batch in flight before the first use), then the
// four warps' partial sums are added in warp order through shared memory.
template <typename T>
__device__ void context_phase(const Params& p, float* part) {
  constexpr int N = Vec<T>::N, kCols = ctx_cols<T>();
  const int P = p.P, C = p.C, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (C + kCols - 1) / kCols;
  for (int item = blockIdx.x; item < p.B * chunks; item += gridDim.x) {
    const int b = item / chunks, c = item % chunks * kCols + lane * N;
    const T* f0 = static_cast<const T*>(p.feats) + static_cast<size_t>(b) * P * C + c;
    const float* al = p.alpha + static_cast<size_t>(b) * P;
    float acc[N] = {};
    for (int q0 = warp; q0 < P; q0 += kWarps * kBatch) {
      uint4 f[kBatch];
      float a[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = q0 + j * kWarps;
        if (q < P) {
          a[j] = __ldcg(al + q);  // written by phase 2 in this launch
          if (c < C) f[j] = __ldg(reinterpret_cast<const uint4*>(f0 + static_cast<size_t>(q) * C));
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q0 + j * kWarps < P && c < C) {
          float v[N];
          unpack16<T>(f[j], v);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] += a[j] * v[i];
        }
      }
    }
    __syncthreads();  // the previous item's sum is done with part
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(part + warp * kCols + lane * N + i) = make_float4(acc[i], acc[i + 1], acc[i + 2],
                                                                                   acc[i + 3]);
    __syncthreads();
    if (warp == 0 && c < C) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = part[lane * N + i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc[i] += part[w * kCols + lane * N + i];
      }
      store16(static_cast<T*>(p.ctx) + static_cast<size_t>(b) * C + c, acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_context_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  att2_phase<T>(p, smem);
  grid.sync();  // att2 complete
  score_phase<T>(p, smem);
  grid.sync();  // alpha complete
  context_phase<T>(p, smem);
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  void* argv[] = {&p};
  return launch_cooperative(attention_context_kernel<T>, smem_floats<T>(p.P) * sizeof(float), argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feats, att1, h and the weights share it).  att2 [B, A] is f32 scratch.
// Returns a cudaError_t (0 on success).
extern "C" int st_attention_context(int dtype, const void* feats, const void* att1, const void* h,
                                    const void* wdec, const void* bdec, const void* wfull, void* ctx,
                                    float* alpha, float* att2, int B, int P, int C, int A, int H, void* stream) {
  Params p{feats, att1, h, wdec, bdec, wfull, ctx, alpha, att2, B, P, C, A, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
