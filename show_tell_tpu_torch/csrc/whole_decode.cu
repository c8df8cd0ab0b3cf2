// All T greedy steps of the pooled GRU captioner in one kernel launch.
//
// Replaces show_tell_tpu/ops/whole_decode_pallas.py::gru_whole_greedy_decode_pallas
// (body _whole_gru_kernel, the pallas_call of _whole_gru_raw).
//
//   x_0 = feat [B, E];  h = 0 [L, B, H];  for t in 0..T-1:
//     h = the L-layer GRU step of (x_t, h)          (GruCell, as fused_step.cu)
//     tok[b] = lowest v maximising h[L-1][b] . wv[v] + bv[v]     (f32 logits)
//     toks[b, t] = tok[b];  x_{t+1} = emb[tok]
//
// Fixed T (no early exit), GRU only, an unsharded projection: the TPU
// kernel's scope.  Layer 0 reads x at its own width E (w_ih0 [3H, E]).
//
// What bounds it on an H100.  Each step reads the recurrence weights
// (14.9 MB in bf16 at L=5, E=256, H=512) and the projection (10.2 MB at
// V=9,956): 25 MB a step, 627 MB for T=25, all inside the 50 MB L2 cache
// after the first step (f32: 50.3 MB a step, at the L2's size).  At small
// B those bytes bound it.  The layers and the projection run on the tensor
// cores (dense_mma.cuh: mma_stack_layer, mma_argmax_keys), whose weights
// are re-read once per 32 batch rows, in bf16 as bf16 products and in f32
// in split-precision TF32 (tf32x3_step(), the layers' K split across
// blocks), as the pooled GRU greedy step of the same dtype runs.  What it
// saves over T launches of the per-step kernel is T-1 launches, T-1
// embedding gathers as separate torch ops and the host's work between
// them; what it adds is one grid barrier a step (L+2 a step against the
// per-step kernel's L+1).
//
// The design:
//   * the time axis, the TPU grid's sequential middle dimension, is a loop
//     inside one cooperative launch; every phase that reads what other
//     blocks wrote sits behind a grid barrier: L layer phases, the
//     projection + argmax, and the token and gather phase;
//   * the state ping-pongs between two [L, B, H] buffers that the wrapper
//     allocates (the first zeroed): even steps read hs0 and write hs1, odd
//     steps the reverse, so no phase reads a buffer that it writes.  The
//     two directions are two StackArgs in the kernel's parameters and the
//     loop runs two steps a turn, each with its own;
//   * the step (decode_step) is inlined into the loop, its operands read
//     from the parameter bank as in the per-step kernel; dense_mma.cuh's
//     phases take their thread index and widths through an empty asm, so
//     that the compiler does not hoist what each phase derives from them
//     out of the loop and hold it through the other phases (the bf16
//     instance then spilled at 255 registers; a step called as a
//     __noinline__ function spilled nothing but ran slower at B=512);
//   * the feedback is a row copy, emb[tok] into the [B, E] buffer x that
//     held the features at step 0 and that step t+1's layer 0 reads (its
//     reads of step t ended L + 1 barriers before).  The TPU kernel folded
//     it into the argmax merge as a one-hot x embedding matmul, since
//     Mosaic had no dynamic row gather; here one warp a row reads the
//     row's winning key, writes the token, zeroes the key for the next step
//     (the next atomicMax comes L barriers later) and copies the row with
//     16-byte loads;
//   * everything that other blocks wrote in this launch (x, both state
//     buffers, the argmax keys) is read through L2 (ld.cg: load_rows,
//     mma_load's activation fragments, __ldcg) and the gathered rows are
//     stored through L2 (__stcg), since L1 is not coherent across SMs;
//   * the layer and projection code is the per-step kernel's of the same
//     dtype (pooled_mma_step<T, kArgmax>(): dense_mma.cuh in both, in f32
//     with the same K split across blocks, S from the same rule), whose
//     f32 sums run in one order per output whatever the grid (split-K by
//     warp index, added in warp order; the S parts in order) and
//     whose first max merges by packed keys: the tokens are bit-equal to T
//     launches of st_fused_gru_step and index_select.

#include "dense_mma.cuh"

namespace {

struct Params {
  StackArgs even, odd;            // the weights and L, B, I0 = E, H; x; even steps hs0 -> hs1, odd steps hs1 -> hs0
  const void* emb;                // [V, E]
  const void* wv;                 // [V, H]     torch layout
  const void* bv;                 // [V]
  int32_t* toks;                  // [B, T]     out
  unsigned long long* best;       // [B]        scratch: packed (logit, index) keys
  int V, T;
  SplitK split;                   // the layers' K split in f32, as st_fused_gru_step's (bf16: S = 1)
};

// After the argmax barrier of step t: one warp a row.  Lane 0 reads the
// row's key, zeroes it and writes toks[b, t]; with ``gather`` the warp
// copies emb[tok] into x[b].
template <typename T>
__device__ void emit_tokens(const Params& p, int t, bool gather) {
  const int lane = threadIdx.x & 31;
  const int B = p.even.B, E = p.even.I0;
  const int chunks = E * static_cast<int>(sizeof(T)) / 16;  // E is a multiple of 8: whole 16-byte chunks
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < B; b += gridDim.x * kWarps) {
    int tok = 0;
    if (lane == 0) {
      tok = key_index(__ldcg(p.best + b));
      p.best[b] = 0ull;
      p.toks[static_cast<size_t>(b) * p.T + t] = tok;
    }
    tok = __shfl_sync(0xffffffffu, tok, 0);
    if (gather) {
      const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(p.emb) + static_cast<size_t>(tok) * E);
      uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(const_cast<void*>(p.even.x)) + static_cast<size_t>(b) * E);
      for (int i = lane; i < chunks; i += 32) __stcg(dst + i, __ldg(src + i));
    }
  }
}

// Step t with its stack operands s (p.even or p.odd): the L layers, the
// projection's key merge, the tokens and, but for the last step, the
// gathered rows of step t+1.
template <typename T>
__device__ __forceinline__ void decode_step(const Params& p, const StackArgs& s, int t, float* smem,
                                            cg::grid_group& grid) {
  static_assert(pooled_mma_step<T, kArgmax>(), "both instances run st_fused_gru_step's tensor-core code");
  for (int l = 0; l < s.L; ++l) {
    if constexpr (tf32x3_step<T, kArgmax>())
      mma_stack_layer<T, GruCell>(s, l, smem, p.split);
    else
      mma_stack_layer<T, GruCell>(s, l, smem);
    grid.sync();  // layer l's h' is complete (the first also orders the zeroed keys before any atomicMax)
  }
  const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
  mma_argmax_keys(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.best, smem);
  grid.sync();  // every key is final
  const bool more = t + 1 < p.T;
  emit_tokens<T>(p, t, more);
  if (more) grid.sync();  // x holds step t+1's input
}

template <typename T>
__global__ void __launch_bounds__(kThreads) whole_gru_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int b = grid_thread(); b < p.even.B; b += grid_threads()) p.best[b] = 0ull;  // below every packed key
  for (int t = 0; t < p.T; t += 2) {
    decode_step<T>(p, p.even, t, smem, grid);
    if (t + 1 < p.T) decode_step<T>(p, p.odd, t + 1, smem, grid);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(whole_gru_kernel<T>, kMmaSmemFloats * sizeof(float), argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
// x [B, E] holds the features in and is scratch after step 0 (the gathered
// rows); toks [B, T] int32 out; hs0 (zeroed) and hs1 [L, B, H] and best [B]
// (u64) are scratch.  s0, su, partial, arrivals, max_parts: the layers' K
// split in f32, as st_fused_gru_step takes it (every step reuses the
// scratch, and the counters are back at zero after each layer); bf16: S = 1.
extern "C" int st_whole_gru_decode(int dtype, void* x, const void* emb, const void* w_ih0, const void* w_ihU,
                                   const void* w_hh, const void* b_ih, const void* b_hh, const void* wv, const void* bv,
                                   void* hs0, void* hs1, int32_t* toks, unsigned long long* best, float* partial,
                                   unsigned int* arrivals, int L, int B, int E, int H, int V, int T, int s0, int su,
                                   int max_parts, void* stream) {
  if (T < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(dtype == 0, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  const StackArgs even{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs0, nullptr, hs1, nullptr, L, B, E, H};
  StackArgs odd = even;
  odd.hs = hs1;
  odd.new_hs = hs0;
  const Params p{even, odd, emb, wv, bv, toks, best, V, T, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
