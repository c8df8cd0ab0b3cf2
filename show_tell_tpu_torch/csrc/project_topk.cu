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
// the card's 295 (vocab_mma.cuh).  Every part (one per column range and
// writer) holds its top-K (value, index) keys and an online (max, sum of
// exp) in scratch; after a grid barrier one warp per row merges the parts
// by the 64-bit key order (a greater value first, of equal values the
// lower index: jax.lax.top_k's rule) and forms logsumexp (merge_topk in
// decode_common.cuh).  The TPU kernel carried (m, s) through a sequential
// grid and took k masked max passes per block; here the parts are
// independent and the merge is a second phase of one cooperative launch.
// The vocabulary is not padded.
//
// bf16 runs on the tensor cores (vocab_mma.cuh): a block owns a V-tile of
// mv rows with its weights in shared memory, takes every batch row against
// them, and writes one part per (V-tile, row).  f32 runs the SIMT
// topk_phase (decode_common.cuh): a warp owns a vocabulary row and
// reads it coalesced against kBM batch rows in shared memory; lane b keeps
// row b's keys and (m, s) over the columns its warp visits, and each
// (column range, warp) writes a part.

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
__global__ void __launch_bounds__(kThreads) project_topk_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  topk_phase<T>(static_cast<const T*>(p.top), static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), p.B, p.H, p.V,
                p.topk, smem, grid);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(project_topk_kernel<T>, static_cast<size_t>(kBM) * p.H * sizeof(float), argv, stream);
}

__global__ void __launch_bounds__(kTileThreads, 1) project_topk_tiles_kernel(TileArgs a, TopkArgs k) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  cg::grid_group grid = cg::this_grid();
  TopkTileEnd end{k, a.B};
  project_tiles(a, tile_smem, end);
  grid.sync();  // every part is in scratch
  if (threadIdx.x < kThreads) merge_topk(k, a.B, vocab_tiles(a));  // a warp a row over kWarps-warp blocks
}

TileLaunchCache tiles_cache;

cudaError_t launch_tiles_bf16(const Params& p, int mv, cudaStream_t stream) {
  TileArgs a{static_cast<const __nv_bfloat16*>(p.top), static_cast<const __nv_bfloat16*>(p.wv),
             static_cast<const __nv_bfloat16*>(p.bv), p.B, p.H, p.V, mv};
  TopkArgs k = p.topk;
  void* argv[] = {&a, &k};
  return launch_tiles(project_topk_tiles_kernel, tiles_cache, mv, p.H, (p.V + mv - 1) / mv, argv, stream);
}

}  // namespace

// dtype: 0 = float32 (mv = 0), 1 = bfloat16 with V-tiles of mv rows
// (vocab_tiles in ops/vocab.py).  K <= 8.  Scratch part_keys [n, B, K]
// (u64) and part_ms [n, B] (float2): f32 writes n = max_splits * 4 parts,
// where max_splits bounds the column ranges of the grid; bf16 writes one
// part per V-tile, n = ceil(V / mv) <= max_splits.  Returns a cudaError_t
// (0 on success).
extern "C" int st_project_topk(int dtype, const void* top, const void* wv, const void* bv,
                               unsigned long long* part_keys, float2* part_ms, float* logp, int32_t* ids, int B,
                               int H, int V, int K, int max_splits, int mv, void* stream) {
  if (K < 1 || K > kMaxK || K > V || max_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{top, wv, bv, {part_keys, part_ms, logp, ids, K, max_splits}, B, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mv == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1 && vocab_tile_ok(mv, H) && (V + mv - 1) / mv <= max_splits)
    return static_cast<int>(launch_tiles_bf16(p, mv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
