// Where the time of the projection kernels' V-tiles goes (tools/vocab_tile_probe.py): the kernels of
// show_tell_tpu_torch/csrc/project_argmax.cu and project_topk.cu, their device code included from vocab_mma.cuh,
// with an end that adds up, on thread 0 of every block, the clock64 cycles between project_tiles' marks
// (TileMark): waiting for a step's chunk (and the barrier), issuing the next chunk's copies, the products, staging
// a group's logits, the end's scan; and the kernel's own phases around project_tiles.
//
// stamps [grid][kStamps] int64 of one launch, block b at b * kStamps:
//   0 .. 5  cycles charged to the phase that each mark ends: 0 a tile's start (the barrier before it), 1 waiting
//           for a chunk, 2 issuing copies, 3 products, 4 staging logits, 5 the end's scan
//   6 .. 10 clock64 at the kernel's start, before project_tiles, after it, after the grid barrier after it, and at
//           the kernel's end
//   11, 12  %globaltimer (ns) at the kernel's start and end (block 0's converts cycles to time)

#include "../show_tell_tpu_torch/csrc/decode_common.cuh"
#include "../show_tell_tpu_torch/csrc/vocab_mma.cuh"

namespace {

constexpr int kStamps = 13;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// An end that forwards group() to the library's end and sums thread 0's cycles between marks.
template <typename Inner>
struct ProbeEnd {
  Inner inner;
  long long last, sums[6];
  __device__ __forceinline__ void mark(int point) {
    const long long now = clock64();
    sums[point] += now - last;
    last = now;
  }
  __device__ __forceinline__ void group(int tile, int v0, int nv, int b0, int nb, const float* logits, int lp) {
    inner.group(tile, v0, nv, b0, nb, logits, lp);
  }
};

template <typename T, bool kTopk>
__global__ void __launch_bounds__(kTileThreads, 1)
    probe_kernel(TileArgs<T> a, int32_t* tok, unsigned long long* best, TopkArgs k, long long* stamps) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  cg::grid_group grid = cg::this_grid();
  const long long g0 = global_ns(), t0 = clock64();
  if (!kTopk) {
    for (int b = tile_grid_thread(); b < a.B; b += tile_grid_threads()) best[b] = 0ull;
    grid.sync();
  }
  using Inner = typename std::conditional<kTopk, TopkTileEnd, ArgmaxTileEnd>::type;
  ProbeEnd<Inner> end{};
  if constexpr (kTopk) {
    end.inner.a = k;
    end.inner.B = a.B;
  } else {
    end.inner.best = best;
  }
  const long long t_in = clock64();
  end.last = t_in;
  project_tiles(a, tile_smem, end);
  const long long t1 = clock64();
  grid.sync();
  const long long t2 = clock64();
  if constexpr (kTopk) {
    if (threadIdx.x < kThreads) merge_topk(k, a.B, vocab_tiles(a));
  } else {
    for (int b = tile_grid_thread(); b < a.B; b += tile_grid_threads()) tok[b] = key_index(__ldcg(best + b));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* at = stamps + static_cast<size_t>(blockIdx.x) * kStamps;
    for (int i = 0; i < 6; ++i) at[i] = end.sums[i];
    at[6] = t0;
    at[7] = t_in;
    at[8] = t1;
    at[9] = t2;
    at[10] = clock64();
    at[11] = g0;
    at[12] = global_ns();
  }
}

template <typename T, bool kTopk>
cudaError_t launch(TileArgs<T> a, int32_t* tok, unsigned long long* best, TopkArgs k, long long* stamps,
                   cudaStream_t stream) {
  static TileLaunchCache cache;
  void* argv[] = {&a, &tok, &best, &k, &stamps};
  return launch_tiles<T>(probe_kernel<T, kTopk>, cache, a.mv, a.H, (a.V + a.mv - 1) / a.mv, argv, stream);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; topk 0: the argmax kernel (tok, best), 1: the top-k kernel (K parts of scratch
// part_keys [ceil(V / mv), B, K], part_ms; logp, ids).  Returns a cudaError_t; the grid is ceil(V / mv) blocks.
extern "C" int st_vocab_tile_probe(int dtype, int topk, const void* top, const void* wv, const void* bv, int32_t* tok,
                                   unsigned long long* best, unsigned long long* part_keys, float2* part_ms,
                                   float* logp, int32_t* ids, long long* stamps, int B, int H, int V, int K, int mv,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (V + mv - 1) / mv;
  TopkArgs k{part_keys, part_ms, logp, ids, K, tiles};
  if (dtype == 0 && vocab_tile_ok<float>(mv, H)) {
    TileArgs<float> a{static_cast<const float*>(top), static_cast<const float*>(wv), static_cast<const float*>(bv),
                      B, H, V, mv};
    return static_cast<int>(topk ? launch<float, true>(a, tok, best, k, stamps, s)
                                 : launch<float, false>(a, tok, best, k, stamps, s));
  }
  if (dtype == 1 && vocab_tile_ok<__nv_bfloat16>(mv, H)) {
    TileArgs<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(top), static_cast<const __nv_bfloat16*>(wv),
                              static_cast<const __nv_bfloat16*>(bv), B, H, V, mv};
    return static_cast<int>(topk ? launch<__nv_bfloat16, true>(a, tok, best, k, stamps, s)
                                 : launch<__nv_bfloat16, false>(a, tok, best, k, stamps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
