// One decode step of the pooled captioner in one kernel launch: the L-layer
// GRU or LSTM recurrence, then the H x V vocab projection with one of three
// ends: the first-max argmax (greedy), the dense f32 logits (beam, dense)
// or each row's top-K log-probabilities (beam, sparse); or the recurrence
// alone (the stack step, whose caller projects the top activation itself).
//
// Replaces, one kernel templated on the cell (GruCell, LstmCell in
// decode_common.cuh) and the vocab end (VocabMode):
//   show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas
//     (st_fused_gru_step) and ::fused_lstm_decode_step_pallas (st_fused_lstm_step);
//   show_tell_tpu/ops/fused_beam_pallas.py::fused_dense_step_pallas
//     (st_fused_gru_dense_step, st_fused_lstm_dense_step);
//   show_tell_tpu/ops/fused_beam_pallas.py::fused_topk_step_pallas
//     (st_fused_gru_topk_step, st_fused_lstm_topk_step);
//   show_tell_tpu/ops/rnn_pallas.py::gru_stack_step_pallas (_gru_stack_kernel;
//     st_gru_stack_step) and ::lstm_stack_step_pallas (_lstm_stack_kernel;
//     st_lstm_stack_step), the kNone end: the sharded-projection route.
//
//   x_0 = x [B, E]; for l in 0..L-1:
//     h'_l (, c'_l) = Cell(x_l, h_l (, c_l); w_ih_l, w_hh[l], b_ih[l], b_hh[l]);  x_{l+1} = h'_l
//   logit[b, v] = x_L[b] . wv[v] + bv[v]                                  (f32)
//   argmax: tok[b] = lowest v maximising logit[b, v]                      (int32)
//   dense:  logits[b, v]                                                  [B, V] f32
//   top-K:  the K greatest logit[b, v] (of equal ones the lower v first) as
//           (logit - logsumexp_v logit[b, v], v)                          [B, K] each
//
// Layer 0 has its own input width E (w_ih0 [G*H, E]), so E may be smaller
// or larger than H; layers 1..L-1 read H-wide inputs (w_ihU [L-1, G*H, H]).
// The TPU beam kernels pad x up to H and take no E > H; these take any E.
// GRU gates r, z, n (the reset gate multiplies W_hn h + b_hn); LSTM gates
// i, f, g, o with the cell state carried in T beside h.  Double biases.
// Products are summed and the gate math is done in f32; h' (and c') are
// cast back to the carry type T (float or bf16).
//
// What bounds it on an H100.  At the serving shapes (L=5, H=512,
// V=9,956; E=256 GRU, E=512 LSTM) one step reads G x H x E + (2L-1) x
// G x H x H recurrence weights plus 9,956 x 512 projection weights: about
// 25 MB (GRU) and 31 MB (LSTM) in bf16, both inside the 50 MB L2 cache.
// The dense end adds B x V x 4 bytes of logits (7.6 MB at B = 192 beam
// rows); the top-K end writes only [B, K] and a few MB of per-part scratch.
// At small batches the step is bound by those bytes (7.5 and 9.3 us at
// 3.35 TB/s, less from L2): the greedy step writes only B tokens, and its
// 1.6-2.0 GFLOP at B = 64 are about 2 us on the tensor cores.
// Every instance runs the recurrence and the projection on the tensor
// cores (dense_mma.cuh: mma.sync, weights re-read once per 32 batch rows):
// in bf16 the instances that mma_step() names, every end of both cells,
// the stack step's none included; in f32 those that tf32x3_step() names,
// the same ends (the greedy, dense, top-k and stack steps of both cells),
// in split-precision TF32 (three tf32 mma's a product, about f32's
// precision), their layers' K split across blocks at small B, the same S
// for the four ends at the same rows, so their new states are bit-equal.
// The argmax end merges each 64-row
// vocabulary item's first max into best by one atomicMax a row; the top-K
// end writes one part per 64-row vocabulary item (its K greatest keys and
// (max, sum)), and after a grid barrier merge_topk reduces each row's
// ceil(V / 64) parts, so it needs scratch for that many parts (max_splits
// >= ceil(V / 64)).  The whole decode (whole_decode.cu) runs the GRU argmax
// instance's layers and key merge, so its ids stay bit-equal to this
// instance's loop.
// The stack step (kNone) reads the recurrence weights alone: 14.9 MB (GRU,
// E=256) and 21.0 MB (LSTM, E=512) in bf16, 29.9 and 41.9 MB in f32, plus
// [L, B, H] states in and out; its bound is those bytes at small B (4.5
// and 6.3 us in bf16, 8.9 and 12.5 us in f32 at 3.35 TB/s), and its 7.65
// and 10.7 GFLOP at B = 512 (7.7 and 10.8 us on the bf16 tensor cores, 46
// and 65 us at three TF32 products a multiply-add).  It runs the
// tensor-core layers with no vocab phase, and at small B splits each
// item's K chunks across S blocks (dense_mma.cuh, SplitK: the last part to
// arrive adds the S parts in order and finishes), so that more than a
// layer's 32 items (B = 1) pull its weights; S per layer comes from the
// wrapper (ops/fused_step.py stack_tiles), with the partial-sum scratch
// and the arrival counters, which it leaves at zero.  The f32 GRU
// instance's layer pipeline is two chunks deep (layer_depth()): its kernel
// holds no vocabulary phase, so its registers go to the layers alone.
// The design (device code in dense_mma.cuh and decode_common.cuh):
//   * weights are kept in the torch layout [out, in] so that one output
//     column is one contiguous row, and a tensor-core A fragment is a
//     plain row read;
//   * one cooperative launch covers the whole step.  The TPU kernel carried
//     the layer activation and the running (max, index) from one grid step
//     to the next on one core; Hopper's blocks run in parallel and in no
//     order, so layer l+1 starts after a grid-wide barrier (layer l's h'
//     is read back from new_hs, which stays in L2), and the argmax merges
//     across blocks with a 64-bit atomicMax on (ordered float, ~index):
//     a greater value wins, and on equal values the lower index wins,
//     exactly the first-max rule of vocab_pallas.merge_block_argmax;
//   * the top-K end replaces the TPU's per-vocab-block top-k and online
//     logsumexp (vocab_pallas.topk_block_stage): each 64-row vocabulary
//     item's four threads a row keep the row's top-K keys and (max, sum)
//     over the item and write them to that item's part of the scratch
//     (dense_mma.cuh); after one more barrier a warp per row merges the
//     parts in item order by the same 64-bit key order (jax.lax.top_k's
//     tie rule) and forms lse, whatever the grid;
//   * the dense end: dense_mma.cuh stages each tile's logits in shared
//     memory and stores each row's 64 as one run;
//   * the grid is sized from the occupancy of this kernel times the SM
//     count, and each block walks over its items, so any B, H and V run;
//   * the LSTM sums a gate's x side and h side into one accumulator, so
//     an item holds four gates' sums where the GRU's holds r, z and n's
//     two sides.
// The vocabulary is not padded: the last columns are simply the last items.

#include "dense_mma.cuh"

namespace {

struct Params {
  StackArgs stack;  // x [B, E], w_ih0 [G*H, E], ..., new_hs, new_cs
  const void* wv;   // [V, H]  vocab projection, torch layout
  const void* bv;   // [V]
  VocabOut out;     // the vocab end's outputs and scratch
  int V;
  SplitK split;     // the layers' K split (the stack steps, f32 every end); S = 1 elsewhere
};

template <typename T, typename Cell, int kMode>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const StackArgs& s = p.stack;
  // the tensor cores (dense_mma.cuh): every bf16 instance, and every f32 instance in split-precision TF32
  static_assert(pooled_mma_step<T, kMode>(), "every instance runs the tensor cores");
  if constexpr (kMode == kArgmax)
    for (int b = grid_thread(); b < s.B; b += grid_threads()) p.out.best[b] = 0ull;  // below every packed key
  for (int l = 0; l < s.L; ++l) {
    if constexpr (kMode == kNone || tf32x3_step<T, kMode>())
      mma_stack_layer<T, Cell, layer_depth<T, Cell, kMode>()>(s, l, smem, p.split);
    else
      mma_stack_layer<T, Cell>(s, l, smem);
    if (kMode != kNone || l + 1 < s.L) grid.sync();  // layer l's h' is complete in new_hs
  }
  if constexpr (kMode != kNone) {
    const T* top = static_cast<const T*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
    mma_vocab_phase<kMode>(top, static_cast<const T*>(p.wv), static_cast<const T*>(p.bv), s.B, s.H, p.V, p.out, smem,
                           grid);
  }
}

template <typename T, typename Cell, int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args};
  return launch_cooperative(fused_step_kernel<T, Cell, kMode>, kMmaSmemFloats * sizeof(float), argv, stream);
}

template <typename Cell, int kMode>
int run(int dtype, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float, Cell, kMode>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16, Cell, kMode>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

VocabOut argmax_out(int32_t* tok, unsigned long long* best) { return VocabOut{tok, best, nullptr, {}}; }
VocabOut dense_out(float* logits) { return VocabOut{nullptr, nullptr, logits, {}}; }
VocabOut topk_out(unsigned long long* part_keys, float2* part_ms, float* logp, int32_t* ids, int K, int max_splits) {
  return VocabOut{nullptr, nullptr, nullptr, {part_keys, part_ms, logp, ids, K, max_splits}};
}

// A top-K step's K and scratch: 1 <= K <= min(kMaxK, V), and room for one
// part per 64-row vocabulary item (every instance runs the tensor cores).
bool topk_args_ok(int V, int K, int max_splits) {
  return K >= 1 && K <= kMaxK && K <= V && max_splits >= (V + kMmaVocabRows - 1) / kMmaVocabRows;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 on
// success).  The top-K steps take K <=
// 8 and per-part scratch part_keys [n, B, K] (u64) and part_ms [n, B]
// (float2), n = max_splits >= ceil(V / 64), one part per vocabulary item
// (else cudaErrorInvalidValue).  s0, su, partial, arrivals, max_parts of
// the greedy, dense and top-k steps: the layers' K split in f32 (as the
// stack step's below, at the same S for the same rows; bf16: S = 1).

// Greedy: tok [B] int32; best [B] scratch.
extern "C" int st_fused_gru_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                 const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                 const void* wv, const void* bv, void* new_hs, int32_t* tok,
                                 unsigned long long* best, float* partial, unsigned int* arrivals, int L, int B,
                                 int E, int H, int V, int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(dtype == 0, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<GruCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, E, H}, wv, bv,
             argmax_out(tok, best), V, split},
      stream);
}

extern "C" int st_fused_lstm_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                  const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                  const void* cs, const void* wv, const void* bv, void* new_hs, void* new_cs,
                                  int32_t* tok, unsigned long long* best, float* partial, unsigned int* arrivals,
                                  int L, int B, int E, int H, int V, int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(dtype == 0, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<LstmCell, kArgmax>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, E, H}, wv, bv, argmax_out(tok, best),
             V, split},
      stream);
}

// Beam, dense: logits [B, V] f32.
extern "C" int st_fused_gru_dense_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                       const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                       const void* wv, const void* bv, void* new_hs, float* logits, float* partial,
                                       unsigned int* arrivals, int L, int B, int E, int H, int V, int s0, int su,
                                       int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(dtype == 0, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<GruCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, E, H}, wv, bv,
             dense_out(logits), V, split},
      stream);
}

extern "C" int st_fused_lstm_dense_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                        const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                        const void* cs, const void* wv, const void* bv, void* new_hs, void* new_cs,
                                        float* logits, float* partial, unsigned int* arrivals, int L, int B, int E,
                                        int H, int V, int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(dtype == 0, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<LstmCell, kDense>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, E, H}, wv, bv, dense_out(logits), V,
             split},
      stream);
}

// Beam, sparse: logp [B, K] f32 and ids [B, K] int32, best first.
extern "C" int st_fused_gru_topk_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                      const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                      const void* wv, const void* bv, void* new_hs, unsigned long long* part_keys,
                                      float2* part_ms, float* logp, int32_t* ids, float* partial,
                                      unsigned int* arrivals, int L, int B, int E, int H, int V, int K,
                                      int max_splits, int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!topk_args_ok(V, K, max_splits) || !split_args_ok(dtype == 0, split, B, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return run<GruCell, kTopk>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, E, H}, wv, bv,
             topk_out(part_keys, part_ms, logp, ids, K, max_splits), V, split},
      stream);
}

extern "C" int st_fused_lstm_topk_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU,
                                       const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                       const void* cs, const void* wv, const void* bv, void* new_hs, void* new_cs,
                                       unsigned long long* part_keys, float2* part_ms, float* logp, int32_t* ids,
                                       float* partial, unsigned int* arrivals, int L, int B, int E, int H, int V,
                                       int K, int max_splits, int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!topk_args_ok(V, K, max_splits) || !split_args_ok(dtype == 0, split, B, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return run<LstmCell, kTopk>(
      dtype,
      Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, E, H}, wv, bv,
             topk_out(part_keys, part_ms, logp, ids, K, max_splits), V, split},
      stream);
}

// The stack step: the recurrence alone, new_hs (and new_cs) out; the top
// activation is new_hs[L-1].  s0, su: the K split of layer 0 and of the
// upper layers, 1 .. 8 in both dtypes; where one exceeds 1, partial
// [max_parts, 4, 32, 16] f32 scratch and arrivals [ceil(B/32) ceil(H/16)]
// u32 counters, zero, which the kernel leaves at zero.
extern "C" int st_gru_stack_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU, const void* w_hh,
                                 const void* b_ih, const void* b_hh, const void* hs, void* new_hs, float* partial,
                                 unsigned int* arrivals, int L, int B, int E, int H, int s0, int su, int max_parts,
                                 void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(true, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<GruCell, kNone>(
      dtype, Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, nullptr, new_hs, nullptr, L, B, E, H}, nullptr, nullptr,
                    VocabOut{}, 0, split},
      stream);
}

extern "C" int st_lstm_stack_step(int dtype, const void* x, const void* w_ih0, const void* w_ihU, const void* w_hh,
                                  const void* b_ih, const void* b_hh, const void* hs, const void* cs, void* new_hs,
                                  void* new_cs, float* partial, unsigned int* arrivals, int L, int B, int E, int H,
                                  int s0, int su, int max_parts, void* stream) {
  const SplitK split{partial, arrivals, s0, su, max_parts};
  if (!split_args_ok(true, split, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  return run<LstmCell, kNone>(
      dtype, Params{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, E, H}, nullptr, nullptr,
                    VocabOut{}, 0, split},
      stream);
}
