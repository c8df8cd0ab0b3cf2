// One greedy decode step of the pooled GRU captioner in one kernel launch:
// the L-layer GRU recurrence, the H x V vocab projection and the first-max
// argmax over the vocabulary.
//
// Replaces show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas.
//
//   x_0 = x [B, E]; for l in 0..L-1:
//     h'_l = GRU(x_l, h_l; w_ih_l, w_hh[l], b_ih[l], b_hh[l]);  x_{l+1} = h'_l
//   tok[b] = lowest v maximising  x_L[b] . wv[v] + bv[v]              (int32)
//
// Layer 0 has its own input width E (w_ih0 [3H, E]), so E may be smaller
// or larger than H; layers 1..L-1 read H-wide inputs (w_ihU [L-1, 3H, H]).
// Gate order r, z, n with double biases; the reset gate multiplies the
// hidden-side affine (W_hn h + b_hn).  Products are summed and the gate
// math is done in f32; h' is cast back to the carry type T (float or bf16).
//
// What bounds it on an H100.  At the serving shapes (L=5, E=256, H=512,
// V=9,956) one step reads 3H x E + (2L-1) x 3H x H recurrence weights plus
// 9,956 x 512 projection weights: about 25 MB in bf16, which fits the 50 MB
// L2 cache.  At small batches the step is bound by those weight bytes; each
// weight row is read once per batch tile of kBM rows, so at large batches
// it turns into an f32 SIMT FMA loop (no tensor cores in this version).
// The design (device code in decode_common.cuh):
//   * weights are kept in the torch layout [out, in] so that one output
//     column is one contiguous row: a warp owns a column and reads it as
//     coalesced 16-byte lane loads against kBM batch rows in shared memory;
//   * one cooperative launch covers the whole step.  The TPU kernel carried
//     the layer activation and the running (max, index) from one grid step
//     to the next on one core; Hopper's blocks run in parallel and in no
//     order, so layer l+1 starts after a grid-wide barrier (layer l's h'
//     is read back from new_hs, which stays in L2), and the argmax merges
//     across blocks with a 64-bit atomicMax on (ordered float, ~index):
//     a greater value wins, and on equal values the lower index wins,
//     exactly the first-max rule of vocab_pallas.merge_block_argmax;
//   * the grid is sized from the occupancy of this kernel times the SM
//     count, and each block walks over (batch tile, column range) items,
//     so any B, H and V run, and at B=1 every SM still gets columns.
// The vocabulary is not padded: the last columns are simply the last items.

#include "decode_common.cuh"

namespace {

struct Params {
  StackArgs stack;            // x [B, E], w_ih0 [3H, E], ..., new_hs
  const void* wv;             // [V, H]  vocab projection, torch layout
  const void* bv;             // [V]
  int32_t* tok;               // [B]
  unsigned long long* best;   // [B] scratch: packed (value, index) keys
  int V;
};

template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads) fused_gru_step_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const StackArgs& s = p.stack;
  for (int b = grid_thread(); b < s.B; b += grid_threads()) p.best[b] = 0ull;  // below every packed key
  for (int l = 0; l < s.L; ++l) {
    Cell::template layer<T>(s, l, smem);
    grid.sync();  // layer l's h' is complete in new_hs
  }
  const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
  project_argmax<T>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.best, smem);
  grid.sync();
  for (int b = grid_thread(); b < s.B; b += grid_threads()) p.tok[b] = key_index(p.best[b]);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(fused_gru_step_kernel<T, GruCell>, stack_smem_floats(p.stack) * sizeof(float), argv,
                            stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success); a
// width whose [kBM, max(E, H) + H] f32 tile exceeds a block's shared memory fails here.
extern "C" int st_fused_gru_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                 const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                 const void* wv, const void* bv, void* new_hs, int32_t* tok,
                                 unsigned long long* best, int L, int B, int E, int H, int V, void* stream) {
  Params p{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, new_hs, L, B, E, H}, wv, bv, tok, best, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
