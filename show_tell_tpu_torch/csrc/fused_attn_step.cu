// One decode step of the soft-attention captioner in one kernel launch:
// additive attention over the P spatial positions, the context in embed
// space, the L-layer recurrence with a 2E-wide layer 0, the H x V vocab
// projection and either the first-max argmax (greedy) or the dense f32
// logits (beam).
//
// Replaces, for both cells, show_tell_tpu/ops/fused_attn_pallas.py::
// fused_attn_decode_step_pallas in greedy argmax mode (st_fused_attn_step,
// st_fused_attn_lstm_step) and ::fused_attn_dense_step_pallas, its dense
// mode (st_fused_attn_dense_step, st_fused_attn_lstm_dense_step): one
// kernel templated on the cell (GruCell, LstmCell in decode_common.cuh)
// and the vocab end (VocabMode); the LSTM instances take cs in and out.
//
//   h      = hs[L-1][b]                          the last layer's INCOMING h (never c)
//   att2   = h . W_dec^T + b_dec                 [A]        (f32)
//   e_p    = sum_a LeakyReLU_0.2(att1[b,p,a] + att2[a]) * w_full[a]
//            (b_full is softmax-invariant and dropped, as on the TPU)
//   alpha  = softmax_p(e)                        f32, max subtracted
//   ctx_e  = sum_p alpha_p * feats_e[b,p,:] + b_emb               [E]
//   x[b]   = cat(w_emb[b], ctx_e) in T           [2E]
//   then the recurrence (layer 0 reads x with w_ih0 [G*H, 2E]), the
//   projection and the argmax or the logits [B, V], exactly as fused_step.cu.
// att1 = feats @ W_enc + b_enc and feats_e = feats @ W_embed are per-image
// constants, computed once per decode outside the kernel.
//
// What bounds it on an H100.  At the flagship (L=5, E=512, H=512, A=512,
// P=49, V=9,956) one step reads about 28 MB (GRU) or 34 MB (LSTM) of bf16
// weights (layer 0 G*H x 1024 + G*H x 512, four upper layers 2 x G*H x 512
// each, W_dec 512 x 512, the vocabulary 9,956 x 512) plus 2 x B x 49 x
// 512 values of att1 and feats_e: 6.4 MB at B=64, all of it inside the
// 50 MB L2: 10-12 us at 3.35 TB/s, less from L2.  At beam's B = 192 rows
// att1 and feats_e are 19.3 MB and the dense logits another 7.6 MB
// written; the greedy step writes only B tokens.  As in the pooled step
// the SIMT code streams the weights once per kBM-row batch tile and
// multiplies in f32; every bf16 instance, greedy (argmax) and beam
// (dense), runs the recurrence and the projection on the tensor cores
// (dense_mma.cuh, mma_step()), at this kernel's 128-thread block.  The
// attention adds little work (2 x 49 x 512 multiply-adds a row) but three
// more grid barriers, and its phases A1 and A2 stay SIMT in every instance.
// The design:
//   * phase A1 computes att2 for all rows as a (batch tile, column range)
//     product like a GRU layer, so W_dec is read once per tile and every
//     SM gets columns even at B=1, and writes it to an f32 [B, A] scratch;
//   * phase A2 gives each batch row to one block: its warps form e over the
//     positions (lanes over A), every thread takes the softmax of the P
//     scores from shared memory, and threads over E sum alpha-weighted
//     feats_e rows, so each att1 and feats_e row is read once, coalesced;
//     x = cat(w_emb, ctx_e) goes to a [B, 2E] scratch;
//   * the recurrence and projection reuse decode_common.cuh.  Layer 0 is
//     2E wide, so the shared-memory input tile is sized by max(2E, H):
//     8 x (1024 + 512) f32 = 48 KiB at the flagship, the default limit;
//     launch_cooperative raises the limit for wider tiles.  The bf16
//     instances need max(A1's 8 rows of h, A2's A + P scores, the staged
//     tensor-core sums): 33 KiB at the flagship;
//   * the ends are fused_step.cu's: f32 logits stores stride by V, bf16
//     stores each row's 64 logits of a tile as one run; the bf16 argmax
//     merges each 64-row vocabulary item's first max of a row by one
//     atomicMax (dense_mma.cuh).
// The TPU kernel ran the attention in 8-row sub-stages of a sequential
// grid to bound VMEM; here the grid barriers order the phases instead.

#include <algorithm>

#include "dense_mma.cuh"

namespace {

struct Params {
  StackArgs stack;           // x = the [B, 2E] scratch, w_ih0 [G*H, 2E], ...
  const void* w_emb;         // [B, E]     current token embeddings
  const void* feats_e;       // [B, P, E]  feats @ W_embed
  const void* att1;          // [B, P, A]  feats @ W_enc + b_enc
  const void* wdec;          // [A, H]     decoder_att, torch layout
  const void* bdec;          // [A]
  const void* wfull;         // [A]        full_att weight
  const void* b_emb;         // [E]        embed bias
  const void* wv;            // [V, H]
  const void* bv;            // [V]
  float* att2;               // [B, A]     scratch
  VocabOut out;              // tok and best (argmax) or logits (dense)
  int E, A, P, V;
};

// att2[b, a] = hs[L-1][b] . wdec[a] + bdec[a] for all rows, in f32.
template <typename T>
__device__ void attention_scores_in(const Params& p, float* xs) {
  constexpr int N = Vec<T>::N;
  const StackArgs& s = p.stack;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = s.B, H = s.H, A = p.A;
  const T* h_last = static_cast<const T*>(s.hs) + static_cast<size_t>(s.L - 1) * B * H;
  const T* wdec = static_cast<const T*>(p.wdec);
  const T* bdec = static_cast<const T*>(p.bdec);
  Tiling t(B, A);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, B - b0);
    const int a0 = (item % t.splits) * t.per_split;
    const int a1 = min(A, a0 + t.per_split);
    __syncthreads();
    load_rows<T>(xs, h_last, b0, nb, H);
    __syncthreads();
    for (int a = a0 + warp; a < a1; a += kWarps) {
      float acc[kBM];
#pragma unroll
      for (int b = 0; b < kBM; ++b) acc[b] = 0.0f;
      for (int k = lane * N; k < H; k += 32 * N) {
        float w[N];
        Vec<T>::ldg(wdec + static_cast<size_t>(a) * H + k, w);
#pragma unroll
        for (int b = 0; b < kBM; ++b) {
          if (b < nb) {
#pragma unroll
            for (int i = 0; i < N; ++i) acc[b] += w[i] * xs[b * H + k + i];
          }
        }
      }
      float mine = 0.0f;
#pragma unroll
      for (int b = 0; b < kBM; ++b) {
        if (b < nb) {
          const float v = warp_sum(acc[b]);
          if (lane == b) mine = v;
        }
      }
      if (lane < nb) p.att2[static_cast<size_t>(b0 + lane) * A + a] = mine + Vec<T>::to_f32(bdec[a]);
    }
  }
}

// For each row: e, alpha and ctx_e, then x[b] = cat(w_emb[b], ctx_e).
template <typename T>
__device__ void attention_context_e(const Params& p, float* smem) {
  constexpr int N = Vec<T>::N;
  const StackArgs& s = p.stack;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = p.E, A = p.A, P = p.P;
  float* att2 = smem;        // [A]
  float* alpha = smem + A;   // [P]: e, then exp(e - max)
  const T* wfull = static_cast<const T*>(p.wfull);
  const T* b_emb = static_cast<const T*>(p.b_emb);
  for (int b = blockIdx.x; b < s.B; b += gridDim.x) {
    __syncthreads();
    for (int a = threadIdx.x * 4; a < A; a += kThreads * 4) {  // A % 8 == 0
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p.att2 + static_cast<size_t>(b) * A + a));
      att2[a] = v.x; att2[a + 1] = v.y; att2[a + 2] = v.z; att2[a + 3] = v.w;
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
    const T* fe = static_cast<const T*>(p.feats_e) + static_cast<size_t>(b) * P * E;
    T* x = static_cast<T*>(const_cast<void*>(s.x)) + static_cast<size_t>(b) * 2 * E;
    for (int c = threadIdx.x * N; c < E; c += kThreads * N) {
      float acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.0f;
      for (int q = 0; q < P; ++q) {
        float f[N];
        Vec<T>::ldg(fe + static_cast<size_t>(q) * E + c, f);
        const float a = alpha[q] / sum;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += a * f[i];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) x[E + c + i] = Vec<T>::from_f32(acc[i] + Vec<T>::to_f32(b_emb[c + i]));
    }
    const T* w_emb = static_cast<const T*>(p.w_emb) + static_cast<size_t>(b) * E;
    for (int c = threadIdx.x; c < E; c += kThreads) x[c] = w_emb[c];
  }
}

template <typename T, typename Cell, int kMode>
__global__ void __launch_bounds__(kThreads) fused_attn_step_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const StackArgs& s = p.stack;
  constexpr bool kMma = mma_step<T, kMode>();  // the tensor cores (dense_mma.cuh)
  if constexpr (kMode == kArgmax)
    for (int b = grid_thread(); b < s.B; b += grid_threads()) p.out.best[b] = 0ull;  // below every packed key
  attention_scores_in<T>(p, smem);
  grid.sync();  // att2 is complete
  attention_context_e<T>(p, smem);
  grid.sync();  // x = cat(w_emb, ctx_e) is complete
  for (int l = 0; l < s.L; ++l) {
    if constexpr (kMma)
      mma_stack_layer<Cell>(s, l, smem);
    else
      stack_layer<T, Cell>(s, l, smem);
    grid.sync();
  }
  const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
  if constexpr (kMma)
    mma_vocab_phase<kMode>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.out, smem,
                           grid);
  else
    vocab_phase<kMode, T>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.out,
                          smem, grid);
}

template <typename T, typename Cell, int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // A1's kBM rows of h and A2's scores beside the recurrence's tiles (an mma_step instance: its staged sums)
  const size_t attn = std::max(static_cast<size_t>(p.A) + p.P, static_cast<size_t>(kBM) * p.stack.H);
  const size_t stack = mma_step<T, kMode>() ? kMmaSmemFloats : stack_smem_floats(p.stack);
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(fused_attn_step_kernel<T, Cell, kMode>, (attn > stack ? attn : stack) * sizeof(float),
                            argv, stream);
}

template <typename Cell, int kMode>
int run(int dtype, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float, Cell, kMode>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16, Cell, kMode>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is the [B, 2E] scratch for layer 0's
// input, att2 a [B, A] f32 scratch.  Each returns a cudaError_t (0 on success).
// Greedy: tok [B] int32, best [B] scratch.  Beam: logits [B, V] f32.
extern "C" int st_fused_attn_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                  const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                  const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                  const void* b_hh, const void* hs, const void* wv, const void* bv, void* x,
                                  float* att2, void* new_hs, int32_t* tok, unsigned long long* best, int L,
                                  int B, int E, int H, int A, int P, int V, void* stream) {
  return run<GruCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, 2 * E, H}, w_emb, feats_e, att1,
             wdec, bdec, wfull, b_emb, wv, bv, att2, VocabOut{tok, best, nullptr, {}}, E, A, P, V},
      stream);
}

extern "C" int st_fused_attn_lstm_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                       const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                       const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                       const void* b_hh, const void* hs, const void* cs, const void* wv,
                                       const void* bv, void* x, float* att2, void* new_hs, void* new_cs,
                                       int32_t* tok, unsigned long long* best, int L, int B, int E, int H, int A,
                                       int P, int V, void* stream) {
  return run<LstmCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, 2 * E, H}, w_emb, feats_e, att1, wdec,
             bdec, wfull, b_emb, wv, bv, att2, VocabOut{tok, best, nullptr, {}}, E, A, P, V},
      stream);
}

extern "C" int st_fused_attn_dense_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                        const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                        const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                        const void* b_hh, const void* hs, const void* wv, const void* bv, void* x,
                                        float* att2, void* new_hs, float* logits, int L, int B, int E, int H, int A,
                                        int P, int V, void* stream) {
  return run<GruCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, 2 * E, H}, w_emb, feats_e, att1,
             wdec, bdec, wfull, b_emb, wv, bv, att2, VocabOut{nullptr, nullptr, logits, {}}, E, A, P, V},
      stream);
}

extern "C" int st_fused_attn_lstm_dense_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                             const void* wdec, const void* bdec, const void* wfull,
                                             const void* b_emb, const void* w_ih0, const void* w_ihU,
                                             const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                             const void* cs, const void* wv, const void* bv, void* x, float* att2,
                                             void* new_hs, void* new_cs, float* logits, int L, int B, int E, int H,
                                             int A, int P, int V, void* stream) {
  return run<LstmCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, 2 * E, H}, w_emb, feats_e, att1, wdec,
             bdec, wfull, b_emb, wv, bv, att2, VocabOut{nullptr, nullptr, logits, {}}, E, A, P, V},
      stream);
}
