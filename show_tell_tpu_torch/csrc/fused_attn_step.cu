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
// written; the greedy step writes only B tokens.  In f32 every weight and
// activation is twice those bytes (56-68 MB of weights, past the L2).
// Every instance, greedy (argmax) and beam (dense), runs the recurrence and
// the projection on the tensor cores (dense_mma.cuh) at this kernel's
// 128-thread block: bf16 as mma_step() names it, f32 in split-precision
// TF32 (tf32x3_step<T, kMode, true>(): three tf32 mma's a product, about
// f32's precision) with the layers' K split across blocks (SplitK, S from
// ops/fused_step.stack_tiles for the 2E-wide layer 0 and the H-wide ones;
// the greedy and the dense instance at the same rows take the same S, so
// their states are bit-equal).  The attention adds little work (2 x 49 x
// 512 multiply-adds a row) but two more grid barriers (f32: a launch of
// its own, attention_f32_kernel, with two).  In f32 the attention phases
// go ahead of the step's launch because in one launch with the 3xTF32
// layers the LSTM instances spilled (255 registers, 56-72 bytes of stack
// on an H100's ptxas), whatever the phases' own arrays: the layers alone
// take 190-194 registers, and any f32 attention phase ahead of them in the
// same kernel took the rest.
// The design:
//   * phase A1 computes att2 for all rows into an f32 [B, A] scratch as a
//     (batch tile, column range) product like a SIMT GRU layer, so W_dec is
//     read once per tile and every SM gets columns even at B=1.  In f32
//     every load of a thread's share is in flight at once (att2_f32).  On
//     the 3xTF32 tiles (the projection's dense end with W_dec as the
//     vocabulary) A1 has 8 items at B <= 32 and took 29-30 us at B = 32
//     and 64 against att2_f32's 7-8 on an H100 (tools/attn_phase_probe.py),
//     so it stays SIMT;
//   * phase A2, bf16: each batch row to one block: its warps form e over
//     the positions (lanes over A), the softmax of the P scores is taken
//     from shared memory, and threads over E sum alpha-weighted feats_e
//     rows, so each att1 and feats_e row is read once, coalesced.  f32 (a
//     row is 200 KB of att1 and feats_e, and a block a row left 100 SMs idle
//     at B=32): the scores spread over the grid's warps, a few positions of
//     a row a warp, into a [B, P] scratch after att2 (scores_f32); after one
//     more grid barrier, (row, 128 columns of E) items take the row's
//     softmax and sum the alpha-weighted feats_e columns (context_f32).
//     Either way x = cat(w_emb, ctx_e) goes to a [B, 2E] scratch;
//   * the recurrence and projection are fused_step.cu's tensor-core code
//     (dense_mma.cuh).  A block needs max(A1's 8 rows of h, A2's A + P
//     scores, the staged tensor-core sums): 33 KiB at the flagship; in f32
//     the attention launch max(A1's rows, P + 1024: alpha and the
//     context's f64 sums) and the step's the staged sums;
//   * the ends are fused_step.cu's: the dense end stores each row's 64
//     logits of an item as one run; the argmax end merges each 64-row
//     vocabulary item's first max of a row by one atomicMax.  In f32 the
//     chunk chain is one chunk deep (kTf32Depth): a second register buffer
//     for the projection spilled here too, and asking L2 for each warp's
//     run of vocabulary rows ahead of the chain made the phase slower.
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
  float* att2;               // [B, A]     scratch, then the f32 A2's scores [B, P]
  VocabOut out;              // tok and best (argmax) or logits (dense)
  int E, A, P, V;
  SplitK split;              // the layers' K split (f32); S = 1 in bf16
};

// The f32 phases' loads in flight: A1's 16-byte loads of h a thread, its W_dec columns a warp and 16-byte chunks of
// a row a lane; A2's positions a warp scores and 16-byte chunks of A a lane; the context's positions a lane, and the
// columns of E an item (a warp's 16-byte loads across one position)
constexpr int kA1Loads = 8, kA1Cols = 4, kA1Chunks = 4;
constexpr int kScorePositions = 4, kScoreChunks = 4;
constexpr int kBatch = 16, kCtxCols = 32 * 4;

// The bf16 A1: att2[b, a] = hs[L-1][b] . wdec[a] + bdec[a] for all rows, in f32.
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

// The bf16 A2, for each row: e, alpha and ctx_e, then x[b] = cat(w_emb[b], ctx_e).
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

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The f32 A1: att2[b, a] = hs[L-1][b] . wdec[a] + bdec[a] by attention_scores_in's (batch tile, column range)
// items, with a thread's loads in flight together: the tile's kBM rows of h into shared memory, kA1Loads 16-byte
// loads a thread before its first store; then each warp takes kA1Cols of the item's columns at once, a lane's chunks
// of their W_dec rows (k = 4 lane + 128 c) loaded together, and the sums of the kBM rows by shuffles.
__device__ void att2_f32(const Params& p, float* xs) {
  const StackArgs& s = p.stack;
  const int tid = phase_thread(), lane = tid & 31, warp = tid >> 5;
  int B = s.B, H = s.H, A = p.A;
  asm volatile("" : "+r"(B), "+r"(H), "+r"(A));  // opaque, as phase_thread()
  const float* h_last = static_cast<const float*>(s.hs) + static_cast<size_t>(s.L - 1) * B * H;
  const float* wdec = static_cast<const float*>(p.wdec);
  const float* bdec = static_cast<const float*>(p.bdec);
  Tiling t(B, A);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM, nb = min(kBM, B - b0);
    const int a0 = (item % t.splits) * t.per_split, a1 = min(A, a0 + t.per_split);
    __syncthreads();  // the previous item is done with xs
#pragma unroll 1
    for (int i0 = tid * 4; i0 < nb * H; i0 += kThreads * 4 * kA1Loads) {
      float4 v[kA1Loads];
#pragma unroll
      for (int j = 0; j < kA1Loads; ++j) {
        const int i = i0 + j * kThreads * 4;
        if (i < nb * H) v[j] = __ldcg(reinterpret_cast<const float4*>(h_last + static_cast<size_t>(b0) * H + i));
      }
#pragma unroll
      for (int j = 0; j < kA1Loads; ++j) {
        const int i = i0 + j * kThreads * 4;
        if (i < nb * H) *reinterpret_cast<float4*>(xs + i) = v[j];
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int af = a0 + warp; af < a1; af += kWarps * kA1Cols) {
      float acc[kA1Cols][kBM] = {};
#pragma unroll 1
      for (int k0 = lane * 4; k0 < H; k0 += 32 * 4 * kA1Chunks) {
        float4 w[kA1Cols][kA1Chunks];
#pragma unroll
        for (int i = 0; i < kA1Cols; ++i)
#pragma unroll
          for (int c = 0; c < kA1Chunks; ++c) {
            const int a = af + i * kWarps, k = k0 + 32 * 4 * c;
            if (a < a1 && k < H) w[i][c] = __ldg(reinterpret_cast<const float4*>(wdec + static_cast<size_t>(a) * H + k));
          }
#pragma unroll
        for (int c = 0; c < kA1Chunks; ++c) {
          const int k = k0 + 32 * 4 * c;
          if (k < H) {
#pragma unroll
            for (int b = 0; b < kBM; ++b) {
              if (b < nb) {
                const float4 x = *reinterpret_cast<const float4*>(xs + b * H + k);
#pragma unroll
                for (int i = 0; i < kA1Cols; ++i) {
                  if (af + i * kWarps < a1) {
                    acc[i][b] += w[i][c].x * x.x;
                    acc[i][b] += w[i][c].y * x.y;
                    acc[i][b] += w[i][c].z * x.z;
                    acc[i][b] += w[i][c].w * x.w;
                  }
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kA1Cols; ++i) {
        const int a = af + i * kWarps;
        float mine = 0.0f;
#pragma unroll
        for (int b = 0; b < kBM; ++b) {
          const float v = warp_sum(acc[i][b]);
          if (lane == b) mine = v;
        }
        if (a < a1 && lane < nb) p.att2[static_cast<size_t>(b0 + lane) * A + a] = mine + bdec[a];
      }
    }
  }
}

// The f32 A2's first part, the scores e[b, q] = sum_a LeakyReLU_0.2(att1[b, q, a] + att2[b, a]) wfull[a] into the
// [B, P] scratch after att2, spread over the grid's warps: a warp takes kScorePositions positions of a row, a lane
// the 16-byte chunks k = 4 lane + 128 c of A, every att1, att2 and wfull load of a pass in flight together; the sums
// by shuffles.  A2 sums in f64 and rounds each score, weight and context value once, so that the states err no more
// than the twin's f32 sums (A1 stays f32: in f64 it took 1.4-2.1x as long on an H100).
__device__ void scores_f32(const Params& p) {
  const int tid = phase_thread(), lane = tid & 31;
  int B = p.stack.B, A = p.A, P = p.P;
  asm volatile("" : "+r"(B), "+r"(A), "+r"(P));  // opaque, as phase_thread()
  const int groups = (P + kScorePositions - 1) / kScorePositions;
  const float* att1 = static_cast<const float*>(p.att1);
  const float* wfull = static_cast<const float*>(p.wfull);
  float* scores = p.att2 + static_cast<size_t>(B) * A;
#pragma unroll 1
  for (int task = blockIdx.x * kWarps + (tid >> 5); task < B * groups; task += gridDim.x * kWarps) {
    const int b = task / groups, q0 = (task % groups) * kScorePositions;
    const float* u0 = att1 + (static_cast<size_t>(b) * P + q0) * A;
    double acc[kScorePositions] = {};
#pragma unroll 1
    for (int k0 = lane * 4; k0 < A; k0 += 32 * 4 * kScoreChunks) {
      float4 u[kScorePositions][kScoreChunks], t[kScoreChunks], w[kScoreChunks];
#pragma unroll
      for (int c = 0; c < kScoreChunks; ++c) {
        const int k = k0 + 32 * 4 * c;
        if (k < A) {
          t[c] = __ldcg(reinterpret_cast<const float4*>(p.att2 + static_cast<size_t>(b) * A + k));
          w[c] = __ldg(reinterpret_cast<const float4*>(wfull + k));
#pragma unroll
          for (int j = 0; j < kScorePositions; ++j)
            if (q0 + j < P) u[j][c] = __ldg(reinterpret_cast<const float4*>(u0 + static_cast<size_t>(j) * A + k));
        }
      }
#pragma unroll
      for (int c = 0; c < kScoreChunks; ++c) {
        if (k0 + 32 * 4 * c < A) {
          const float tv[4] = {t[c].x, t[c].y, t[c].z, t[c].w}, wv[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
#pragma unroll
          for (int j = 0; j < kScorePositions; ++j) {
            const float uv[4] = {u[j][c].x, u[j][c].y, u[j][c].z, u[j][c].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const double v = static_cast<double>(uv[i]) + tv[i];
              acc[j] += (v >= 0.0 ? v : 0.2 * v) * wv[i];
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kScorePositions; ++j) {
      const double v = warp_sum_f64(acc[j]);
      if (lane == 0 && q0 + j < P) scores[static_cast<size_t>(b) * P + q0 + j] = static_cast<float>(v);
    }
  }
}

// The f32 A2's second part, after a grid barrier: x[b] = cat(w_emb[b], ctx_e), ctx_e = sum_q alpha[b, q]
// feats_e[b, q] + b_emb, by (row, kCtxCols columns of E) items: warp 0 takes the row's softmax of the scores by
// shuffles into shared memory; warp w sums the positions w, w + 4, ... of its lanes' 16-byte chunks, the feats_e
// loads of up to kBatch positions in flight together; the four warps' sums are added in warp order.  The softmax's
// sum, the context's sums and the warps' are f64.
__device__ void context_f32(const Params& p, float* smem) {
  const StackArgs& s = p.stack;
  const int tid = phase_thread(), lane = tid & 31, warp = tid >> 5;
  int B = s.B, E = p.E, P = p.P;
  asm volatile("" : "+r"(B), "+r"(E), "+r"(P));  // opaque, as phase_thread()
  const int chunks = (E + kCtxCols - 1) / kCtxCols;
  double* part = reinterpret_cast<double*>(smem);  // [kWarps][kCtxCols]
  float* alpha = smem + 2 * kWarps * kCtxCols;      // [P]
  const float* scores = p.att2 + static_cast<size_t>(B) * p.A;
  const float* b_emb = static_cast<const float*>(p.b_emb);
  for (int item = blockIdx.x; item < B * chunks; item += gridDim.x) {
    const int b = item / chunks, c0 = (item % chunks) * kCtxCols;
    __syncthreads();  // the previous item is done with alpha and part
    if (warp == 0) {  // each lane reads and writes its own positions
      float m = -INFINITY;
      for (int q = lane; q < P; q += 32) m = fmaxf(m, __ldcg(scores + static_cast<size_t>(b) * P + q));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      double sum = 0.0;
      for (int q = lane; q < P; q += 32) {
        alpha[q] = expf(__ldcg(scores + static_cast<size_t>(b) * P + q) - m);
        sum += alpha[q];
      }
      sum = warp_sum_f64(sum);
      for (int q = lane; q < P; q += 32) alpha[q] = static_cast<float>(alpha[q] / sum);
    }
    __syncthreads();
    const int c = c0 + lane * 4;
    double acc[4] = {};
    if (c < E) {
      const float* fe = static_cast<const float*>(p.feats_e) + static_cast<size_t>(b) * P * E + c;
#pragma unroll 1
      for (int q0 = warp; q0 < P; q0 += kWarps * kBatch) {
        float4 f[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = q0 + j * kWarps;
          if (q < P) f[j] = __ldg(reinterpret_cast<const float4*>(fe + static_cast<size_t>(q) * E));
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = q0 + j * kWarps;
          if (q < P) {
            const double a = alpha[q];
            acc[0] += a * f[j].x;
            acc[1] += a * f[j].y;
            acc[2] += a * f[j].z;
            acc[3] += a * f[j].w;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp * kCtxCols + lane * 4 + i] = acc[i];
    __syncthreads();
    for (int o = tid; o < kCtxCols && c0 + o < E; o += kThreads) {
      double v = part[o];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += part[w * kCtxCols + o];
      float* x = static_cast<float*>(const_cast<void*>(s.x)) + static_cast<size_t>(b) * 2 * E;
      x[E + c0 + o] = static_cast<float>(v + b_emb[c0 + o]);
      x[c0 + o] = static_cast<const float*>(p.w_emb)[static_cast<size_t>(b) * E + c0 + o];
    }
  }
}

// The f32 instances' attention phases, a cooperative launch of their own just before the step's (see the design):
// A1, then A2's scores and, after another grid barrier, its context, x = cat(w_emb, ctx_e) into the [B, 2E] scratch.
__global__ void __launch_bounds__(kThreads) attention_f32_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  att2_f32(p, smem);
  grid.sync();  // att2 is complete
  scores_f32(p);
  grid.sync();  // the scores are complete
  context_f32(p, smem);
}

template <typename T, typename Cell, int kMode>
__global__ void __launch_bounds__(kThreads) fused_attn_step_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const StackArgs& s = p.stack;
  // the tensor cores (dense_mma.cuh): bf16, or f32 in split-precision TF32 with the layers' K split
  constexpr bool kTf32 = tf32x3_step<T, kMode, true>();
  static_assert(mma_step<T, kMode>() || kTf32, "every instance of the attention step runs the tensor cores");
  if constexpr (kMode == kArgmax)
    for (int b = grid_thread(); b < s.B; b += grid_threads()) p.out.best[b] = 0ull;  // below every packed key
  if constexpr (!kTf32) {  // bf16: the attention phases here (f32: attention_f32_kernel, launched before)
    attention_scores_in<T>(p, smem);
    grid.sync();  // att2 is complete
    attention_context_e<T>(p, smem);
    grid.sync();  // x = cat(w_emb, ctx_e) is complete
  }
  for (int l = 0; l < s.L; ++l) {
    if constexpr (kTf32)
      mma_stack_layer<T, Cell>(s, l, smem, p.split);
    else
      mma_stack_layer<T, Cell>(s, l, smem);
    grid.sync();
  }
  const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
  mma_vocab_phase<kMode>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.out, smem,
                         grid);
}

// Shared memory of the attention phases: A1's kBM rows of h and A2's scores (f32: alpha and the context's f64 sums).
inline size_t attention_smem_floats(const Params& p, bool f32) {
  const size_t a2 = f32 ? static_cast<size_t>(p.P) + 2 * kWarps * kCtxCols : static_cast<size_t>(p.A) + p.P;
  return std::max(static_cast<size_t>(kBM) * p.stack.H, a2);
}

template <typename T, typename Cell, int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr bool kTf32 = tf32x3_step<T, kMode, true>();
  Params args = p;
  void* argv[] = {&args};
  if constexpr (kTf32) {
    const cudaError_t err =
        launch_cooperative(attention_f32_kernel, attention_smem_floats(p, true) * sizeof(float), argv, stream);
    if (err != cudaSuccess) return err;
  }
  // the staged tensor-core sums, beside the bf16 attention phases
  const size_t floats = std::max(kTf32 ? 0 : attention_smem_floats(p, false), kMmaSmemFloats);
  return launch_cooperative(fused_attn_step_kernel<T, Cell, kMode>, floats * sizeof(float), argv, stream);
}

// The layers' K split checked (f32: 1 <= S <= kMaxSplits with its scratch; bf16: S = 1), then the launch.
template <typename Cell, int kMode>
int run(int dtype, const Params& p, void* stream) {
  if (!split_args_ok(dtype == 0, p.split, p.stack.B, p.stack.H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float, Cell, kMode>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16, Cell, kMode>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is the [B, 2E] scratch for layer 0's
// input, att2 a [B, A + P] f32 scratch (att2, then the f32 A2's scores).
// Each returns a cudaError_t (0 on success).
// Greedy: tok [B] int32, best [B] scratch.  Beam: logits [B, V] f32.
// partial, arrivals, s0, su, max_parts: the layers' K split in f32, as the
// pooled greedy step's (fused_step.cu); bf16: S = 1.
extern "C" int st_fused_attn_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                  const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                  const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                  const void* b_hh, const void* hs, const void* wv, const void* bv, void* x,
                                  float* att2, void* new_hs, int32_t* tok, unsigned long long* best, float* partial,
                                  unsigned int* arrivals, int L, int B, int E, int H, int A, int P, int V, int s0,
                                  int su, int max_parts, void* stream) {
  return run<GruCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, 2 * E, H}, w_emb, feats_e, att1,
             wdec, bdec, wfull, b_emb, wv, bv, att2, VocabOut{tok, best, nullptr, {}}, E, A, P, V,
             SplitK{partial, arrivals, s0, su, max_parts}},
      stream);
}

extern "C" int st_fused_attn_lstm_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                       const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                       const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                       const void* b_hh, const void* hs, const void* cs, const void* wv,
                                       const void* bv, void* x, float* att2, void* new_hs, void* new_cs,
                                       int32_t* tok, unsigned long long* best, float* partial, unsigned int* arrivals,
                                       int L, int B, int E, int H, int A, int P, int V, int s0, int su, int max_parts,
                                       void* stream) {
  return run<LstmCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, 2 * E, H}, w_emb, feats_e, att1, wdec,
             bdec, wfull, b_emb, wv, bv, att2, VocabOut{tok, best, nullptr, {}}, E, A, P, V,
             SplitK{partial, arrivals, s0, su, max_parts}},
      stream);
}

extern "C" int st_fused_attn_dense_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                        const void* wdec, const void* bdec, const void* wfull, const void* b_emb,
                                        const void* w_ih0, const void* w_ihU, const void* w_hh, const void* b_ih,
                                        const void* b_hh, const void* hs, const void* wv, const void* bv, void* x,
                                        float* att2, void* new_hs, float* logits, float* partial,
                                        unsigned int* arrivals, int L, int B, int E, int H, int A, int P, int V,
                                        int s0, int su, int max_parts, void* stream) {
  return run<GruCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, 2 * E, H}, w_emb, feats_e, att1,
             wdec, bdec, wfull, b_emb, wv, bv, att2, VocabOut{nullptr, nullptr, logits, {}}, E, A, P, V,
             SplitK{partial, arrivals, s0, su, max_parts}},
      stream);
}

extern "C" int st_fused_attn_lstm_dense_step(int dtype, const void* w_emb, const void* feats_e, const void* att1,
                                             const void* wdec, const void* bdec, const void* wfull,
                                             const void* b_emb, const void* w_ih0, const void* w_ihU,
                                             const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                             const void* cs, const void* wv, const void* bv, void* x, float* att2,
                                             void* new_hs, void* new_cs, float* logits, float* partial,
                                             unsigned int* arrivals, int L, int B, int E, int H, int A, int P, int V,
                                             int s0, int su, int max_parts, void* stream) {
  return run<LstmCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, 2 * E, H}, w_emb, feats_e, att1, wdec,
             bdec, wfull, b_emb, wv, bv, att2, VocabOut{nullptr, nullptr, logits, {}}, E, A, P, V,
             SplitK{partial, arrivals, s0, su, max_parts}},
      stream);
}
