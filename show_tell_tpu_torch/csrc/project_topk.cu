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
// 10.2 MB, 3 us at 3.35 TB/s), not the K outputs; at beam's B = 192 rows
// the products are 1.96 GFLOP, 192 operations a weight byte, still below
// the card's 295.  In f32 the weights are 20.4 MB (6.1 us) and the three
// TF32 products of each multiply-add 5.87 GFLOP at R = 192 (11.9 us at
// 495 TFLOP/s: operations-bound; vocab_mma.cuh).  Every part (one per
// V-tile and row) holds its top-K (value, index) keys and an online (max, sum of
// exp) in scratch; after a grid barrier one warp per row merges the parts
// by the 64-bit key order (a greater value first, of equal values the
// lower index: jax.lax.top_k's rule) and forms logsumexp (merge_topk in
// decode_common.cuh).  The TPU kernel carried (m, s) through a sequential
// grid and took k masked max passes per block; here the parts are
// independent and the merge is a second phase of one cooperative launch.
// The vocabulary is not padded.
//
// Both element types run on the tensor cores (vocab_mma.cuh): a block owns
// a V-tile of mv rows with its weights in shared memory, takes every batch
// row against them, and writes one part per (V-tile, row); bf16 by
// mma.sync m16n8k16, f32 by m16n8k8 in split-precision TF32 (3xTF32).

#include "decode_common.cuh"
#include "vocab_mma.cuh"

namespace {

struct Params {
  const void* top;  // [B, H]
  const void* wv;   // [V, H]  torch layout
  const void* bv;   // [V]
  TopkArgs topk;    // top-K outputs and scratch
  int B, H, V;
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1) project_topk_tiles_kernel(TileArgs<T> a, TopkArgs k) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  cg::grid_group grid = cg::this_grid();
  TopkTileEnd end{k, a.B};
  project_tiles(a, tile_smem, end);
  grid.sync();  // every part is in scratch
  if (threadIdx.x < kThreads) merge_topk(k, a.B, vocab_tiles(a));  // a warp a row over kWarps-warp blocks
}

template <typename T>
cudaError_t launch(const Params& p, int mv, cudaStream_t stream) {
  static TileLaunchCache cache;  // one per instance
  TileArgs<T> a{static_cast<const T*>(p.top), static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), p.B, p.H,
                p.V, mv};
  TopkArgs k = p.topk;
  void* argv[] = {&a, &k};
  return launch_tiles<T>(project_topk_tiles_kernel<T>, cache, mv, p.H, (p.V + mv - 1) / mv, argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; V-tiles of mv rows (vocab_tiles in
// ops/vocab.py).  K <= 8.  Scratch part_keys [n, B, K] (u64) and part_ms
// [n, B] (float2): one part per V-tile, n = ceil(V / mv) <= max_splits.
// Returns a cudaError_t (0 on success).
extern "C" int st_project_topk(int dtype, const void* top, const void* wv, const void* bv,
                               unsigned long long* part_keys, float2* part_ms, float* logp, int32_t* ids, int B,
                               int H, int V, int K, int max_splits, int mv, void* stream) {
  if (K < 1 || K > kMaxK || K > V || max_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{top, wv, bv, {part_keys, part_ms, logp, ids, K, max_splits}, B, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool parts_fit = mv > 0 && (V + mv - 1) / mv <= max_splits;
  if (dtype == 0 && vocab_tile_ok<float>(mv, H) && parts_fit) return static_cast<int>(launch<float>(p, mv, s));
  if (dtype == 1 && vocab_tile_ok<__nv_bfloat16>(mv, H) && parts_fit)
    return static_cast<int>(launch<__nv_bfloat16>(p, mv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
