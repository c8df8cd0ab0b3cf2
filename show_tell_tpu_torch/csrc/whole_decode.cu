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
// after the first step.  At small B those bytes bound it; at large B the
// f32 SIMT multiply-adds of the shared layer and projection loops do, as
// in the per-step kernel.  What it saves over T launches of the per-step
// kernel is T-1 launches, T-1 embedding gathers as separate torch ops and
// the host's work between them; what it adds is one grid barrier a step
// (L+2 a step against the per-step kernel's L+1).
//
// The design:
//   * the time axis, the TPU grid's sequential middle dimension, is a loop
//     inside one cooperative launch; every phase that reads what other
//     blocks wrote sits behind a grid barrier: L layer phases, the
//     projection + argmax, and the token and gather phase;
//   * the state ping-pongs between two [L, B, H] buffers that the wrapper
//     allocates (the first zeroed): step t reads hs[t % 2] and writes
//     hs[(t + 1) % 2], so no phase reads a buffer that it writes;
//   * the feedback is a row copy, emb[tok] into a [B, E] buffer that step
//     t+1's layer 0 reads.  The TPU kernel folded it into the argmax merge
//     as a one-hot x embedding matmul, since Mosaic had no dynamic row
//     gather; here one warp a row reads the row's winning key, writes the
//     token, zeroes the key for the next step (the next atomicMax comes L
//     barriers later) and copies the row with 16-byte loads;
//   * everything that other blocks wrote in this launch (x, both state
//     buffers, the argmax keys) is read through L2 (ld.cg: load_rows,
//     __ldcg) and the gathered rows are stored through L2 (__stcg), since
//     L1 is not coherent across SMs;
//   * the layer and projection loops are decode_common.cuh's, whose f32
//     sums run in one order per column whatever the grid: the tokens are
//     bit-equal to T launches of st_fused_gru_step and index_select.

#include "decode_common.cuh"

namespace {

struct Params {
  StackArgs stack;                // the weights and L, B, I0 = E, H; x, hs and new_hs are set each step
  const void* feat;               // [B, E]     step 0's layer-0 input
  const void* emb;                // [V, E]
  const void* wv;                 // [V, H]     torch layout
  const void* bv;                 // [V]
  void* hs[2];                    // [L, B, H]  each; hs[0] is zero at entry
  void* x;                        // [B, E]     scratch: the gathered rows, steps 1..T-1's layer-0 input
  int32_t* toks;                  // [B, T]     out
  unsigned long long* best;       // [B]        scratch: packed (logit, index) keys
  int V, T;
};

// After the argmax barrier of step t: one warp a row.  Lane 0 reads the
// row's key, zeroes it and writes toks[b, t]; with ``gather`` the warp
// copies emb[tok] into x[b].
template <typename T>
__device__ void emit_tokens(const Params& p, int t, bool gather) {
  const int lane = threadIdx.x & 31;
  const int B = p.stack.B, E = p.stack.I0;
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
      uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(p.x) + static_cast<size_t>(b) * E);
      for (int i = lane; i < chunks; i += 32) __stcg(dst + i, __ldg(src + i));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) whole_gru_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  StackArgs s = p.stack;
  for (int b = grid_thread(); b < s.B; b += grid_threads()) p.best[b] = 0ull;  // below every packed key
  for (int t = 0; t < p.T; ++t) {
    s.x = t == 0 ? p.feat : p.x;
    s.hs = p.hs[t & 1];
    s.new_hs = p.hs[(t + 1) & 1];
    for (int l = 0; l < s.L; ++l) {
      stack_layer<T, GruCell>(s, l, smem);
      grid.sync();  // layer l's h' is complete (the first also orders the zeroed keys before any atomicMax)
    }
    const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
    project_argmax<T>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.best, smem);
    grid.sync();  // every key is final
    const bool more = t + 1 < p.T;
    emit_tokens<T>(p, t, more);
    if (more) grid.sync();  // x holds step t+1's input
  }
}

size_t smem_bytes(const Params& p) { return stack_smem_floats(p.stack) * sizeof(float); }

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(whole_gru_kernel<T>, smem_bytes(p), argv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
// toks [B, T] int32 out; hs0 (zeroed) and hs1 [L, B, H], x [B, E] and best
// [B] (u64) are scratch.
extern "C" int st_whole_gru_decode(int dtype, const void* feat, const void* emb, const void* w_ih0,
                                   const void* w_ihU, const void* w_hh, const void* b_ih, const void* b_hh,
                                   const void* wv, const void* bv, void* hs0, void* hs1, void* x, int32_t* toks,
                                   unsigned long long* best, int L, int B, int E, int H, int V, int T, void* stream) {
  if (T < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{{nullptr, w_ih0, w_ihU, w_hh, b_ih, b_hh, nullptr, nullptr, nullptr, nullptr, L, B, E, H},
                 feat, emb, wv, bv, {hs0, hs1}, x, toks, best, V, T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

