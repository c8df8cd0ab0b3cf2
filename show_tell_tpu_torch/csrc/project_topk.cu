// The vocab projection of one beam step and each row's K best
// continuations, without a [B, V] logits tensor:
//   logit[b, v] = top[b] . wv[v] + bv[v]                                  (f32)
//   (logp[b, :], ids[b, :]) = the K greatest logit[b, v], greatest first and
//       of equal values the lower v first, as (logit - logsumexp_v logit[b, v], v)
//
// Replaces show_tell_tpu/ops/vocab_pallas.py::project_topk_pallas (its
// per-vocab-block top-k and online logsumexp, topk_block_stage, and the
// wrapper's top_k over the blocks' candidates).
//
// What bounds it on an H100: the V x H weight stream (9,956 x 512 in bf16,
// 10.2 MB, 3 us at 3.35 TB/s) and, at beam's B = 192 rows, the f32 SIMT
// multiply-adds (2 GFLOP a step: 29 us at the 67 TFLOP/s f32 rate, as no
// tensor cores are used), not the K outputs.  The device code is the top-K end of the fused
// steps (decode_common.cuh): a warp owns a vocabulary row and reads it
// coalesced against kBM batch rows in shared memory; lane b keeps row b's
// top-K (value, index) keys and an online (max, sum of exp) over the
// columns its warp visits, in registers; each (column range, warp) part
// writes them to scratch; after a grid barrier one warp per row merges
// the parts by the 64-bit key order (a greater value first, of equal
// values the lower index: jax.lax.top_k's rule) and forms logsumexp.  The
// TPU kernel carried (m, s) through a sequential grid and took k masked
// max passes per block; here the parts are independent and the merge is
// a second phase of one cooperative launch.  The vocabulary is not padded.

#include "decode_common.cuh"

namespace {

struct Params {
  const void* top;  // [B, H]
  const void* wv;   // [V, H]  torch layout
  const void* bv;   // [V]
  VocabOut out;     // top-K outputs and scratch
  int B, H, V;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) project_topk_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  vocab_phase<kTopk, T>(static_cast<const T*>(p.top), static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), p.B,
                        p.H, p.V, p.out, smem, grid);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(project_topk_kernel<T>, static_cast<size_t>(kBM) * p.H * sizeof(float), argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K <= 8; per-part scratch part_keys
// [max_splits * 4, B, K] (u64) and part_ms [max_splits * 4, B] (float2),
// where max_splits bounds the column ranges of the grid.  Returns a
// cudaError_t (0 on success).
extern "C" int st_project_topk(int dtype, const void* top, const void* wv, const void* bv,
                               unsigned long long* part_keys, float2* part_ms, float* logp, int32_t* ids, int B,
                               int H, int V, int K, int max_splits, void* stream) {
  if (K < 1 || K > kMaxK || K > V || max_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{top, wv, bv, VocabOut{nullptr, nullptr, nullptr, {part_keys, part_ms, logp, ids, K, max_splits}}, B, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
