// The vocab projection and first-max argmax of one greedy step:
//   tok[b] = lowest v maximising  top[b] . wv[v] + bv[v]            (int32)
//
// Replaces show_tell_tpu/ops/vocab_pallas.py::project_argmax_pallas.
//
// What bounds it on an H100: the V x H weight stream (9,956 x 512 in bf16,
// 10.2 MB, 3.0 us at 3.35 TB/s; in f32 20.4 MB, 6.1 us, against 4.0 us of
// 3xTF32 products at B = 64); see vocab_mma.cuh for the arithmetic.
// Blocks merge by a 64-bit atomicMax on (ordered float, ~index), so across
// blocks equal values resolve to the lowest index, as
// vocab_pallas.merge_block_argmax does.  One cooperative launch: the keys
// are zeroed, a grid barrier, the projection, a second barrier, and the
// winning indices are written out.  The vocabulary is not padded.
//
// Both element types run on the tensor cores (vocab_mma.cuh): a block owns
// a V-tile of mv rows, holds its weights in shared memory for all of K and
// takes every batch row against them, so the weights are read once per
// call; bf16 by mma.sync m16n8k16, f32 by m16n8k8 in split-precision TF32
// (3xTF32) with its own ring and pitches.

#include "decode_common.cuh"
#include "vocab_mma.cuh"

namespace {

struct Params {
  const void* top;            // [B, H]
  const void* wv;             // [V, H]  torch layout
  const void* bv;             // [V]
  int32_t* tok;               // [B]
  unsigned long long* best;   // [B] scratch: packed (value, index) keys
  int B, H, V;
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
    project_argmax_tiles_kernel(TileArgs<T> a, int32_t* tok, unsigned long long* best) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  cg::grid_group grid = cg::this_grid();
  for (int b = tile_grid_thread(); b < a.B; b += tile_grid_threads()) best[b] = 0ull;  // below every packed key
  grid.sync();
  ArgmaxTileEnd end{best};
  project_tiles(a, tile_smem, end);
  grid.sync();
  for (int b = tile_grid_thread(); b < a.B; b += tile_grid_threads()) tok[b] = key_index(__ldcg(best + b));
}

template <typename T>
cudaError_t launch(const Params& p, int mv, cudaStream_t stream) {
  static TileLaunchCache cache;  // one per instance
  TileArgs<T> a{static_cast<const T*>(p.top), static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), p.B, p.H,
                p.V, mv};
  int32_t* tok = p.tok;
  unsigned long long* best = p.best;
  void* argv[] = {&a, &tok, &best};
  return launch_tiles<T>(project_argmax_tiles_kernel<T>, cache, mv, p.H, (p.V + mv - 1) / mv, argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; V-tiles of mv rows (vocab_tiles in
// ops/vocab.py: a multiple of 16, at most 128, within the shared-memory
// limit at this H and dtype).  Returns a cudaError_t (0 on success).
extern "C" int st_project_argmax(int dtype, const void* top, const void* wv, const void* bv, int32_t* tok,
                                 unsigned long long* best, int B, int H, int V, int mv, void* stream) {
  Params p{top, wv, bv, tok, best, B, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vocab_tile_ok<float>(mv, H)) return static_cast<int>(launch<float>(p, mv, s));
  if (dtype == 1 && vocab_tile_ok<__nv_bfloat16>(mv, H)) return static_cast<int>(launch<__nv_bfloat16>(p, mv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
