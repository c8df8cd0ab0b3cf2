// The bf16 fused steps on Hopper's tensor cores: the recurrence and the
// vocab projection as mma.sync m16n8k16 products (bf16 in, f32 sums), with
// three ends of the projection: the dense f32 logits (beam), each row's
// top-K log-probabilities (beam, sparse) and the first-max argmax (greedy),
// or none (the stack step, kNone: the recurrence alone).
// mma_step() names the instances that run this file's code: in bf16, every
// instance of fused_step.cu and fused_attn_step.cu (both cells), and the
// whole decode of whole_decode.cu, which runs the pooled GRU argmax
// instance's layers and key merge T times and so stays bit-equal to its
// per-step loop.  tf32x3_step() names the f32 instances that run it in
// split-precision TF32 (below): every end of the pooled step (fused_step.cu,
// both cells: argmax, dense, top-k and the stack step's none) and, with the
// argmax one, the whole decode; and the four attention steps
// (fused_attn_step.cu's argmax and dense ends, both cells, att2 included).
// So every decode step of either dtype runs its layers here.
//
// What bounds a step on an H100.  It reads the recurrence weights (15-23 MB
// in bf16 at the flagships) and the 10.2 MB projection, 25-34 MB in all,
// inside the 50 MB L2; a dense step at R = 192 beam rows also writes R x V
// f32 logits (7.6 MB), a greedy step only B tokens.  Its 5-8 GFLOP at R =
// 192 (1.6-2.2 at B = 64) are a few microseconds on the tensor cores, so
// at small batches the step is bound by those bytes, 7.5-10 us from HBM
// and less from L2.  The SIMT code converted every weight to f32 and
// re-read it once per 8 batch rows (8 times at B = 64, 24 at R = 192); its
// dense end stored each logit alone, 4 bytes at a stride of V, and its
// argmax end finished each row with one warp.
//
// The design:
// - Products: rows of a weight matrix (gate rows, vocabulary rows) are M,
//   batch rows are N, both K-contiguous in their torch layouts, so an
//   m16n8k16 A fragment (row-major) and B fragment (column-major) are
//   plain row reads.  Fragments are loaded straight from global memory
//   into registers (weights by ld.global.nc, activations through L2 only,
//   as other blocks wrote them in this launch), with no shared-memory ring:
//   each weight fragment is used by one warp only, and the SIMT phases of
//   the same launch (attention's A1 and A2) keep the occupancy of a small
//   shared-memory footprint.  K is permuted inside each 32-column chunk,
//   the same way for A and B, so that lane (g, t) reads 16 contiguous
//   bytes of a row (columns 8t .. 8t+7) and feeds them to two k16 steps:
//   columns 8t..8t+3 to the first, 8t+4..8t+7 to the second.  A warp's
//   load is then 8 rows x 64 contiguous bytes.  Each chunk's loads are
//   issued kMmaDepth - 1 chunks ahead of its mma (a ring of register
//   buffers).
// - Items: a block of kThreads = 128 threads (the SIMT phases' block) takes
//   an item of kMmaSlots m16 row tiles x kMmaSlab = 32 batch rows, and its
//   four warps split K into four runs of chunks (split-K), so a small B
//   still spreads over the SMs.  The recurrence's tile is 16 columns j of
//   every gate (rows g*H + j of w_ih and w_hh); the GRU keeps four sums,
//   r and z over both sides, n's x side and n's h side apart; the LSTM its
//   four gates.  The vocabulary's tile is 64 rows.  Items go round the
//   cooperative grid; a layer ends in the grid barrier, as before.
// - K split across blocks (the stack steps and the f32 tf32x3_step()
//   instances, SplitK): at a small batch a layer has few items (32 at B =
//   1: 32 of 132 SMs pull its weights), so those instances may cut each
//   item into S parts, part s taking
//   the contiguous run [s n / S, (s + 1) n / S) of the layer's n K chunks,
//   split over the four warps as above.  Each part writes its warp-ordered
//   sums (16 columns x up to 32 rows, each slot) to a global scratch; the
//   part that arrives last at the item's counter (a block barrier, then one
//   thread's acquire-release atomicInc that wraps the counter back to 0)
//   adds the S parts in the order s = 0 .. S - 1, read through L2 all at
//   once, and finishes the item.  The
//   state then depends on S, never on the grid or the order of arrival.
//   S comes per layer from the wrapper (ops/fused_step.stack_tiles); S = 1
//   finishes from shared memory as every other instance does.
// - Staging: each warp writes its 64 f32 sums a lane to shared memory
//   (kMmaPitch = 33 floats a row of 32 lanes), and after one barrier the
//   block's threads add the four warps' sums in warp order.  The
//   recurrence then finishes column j of a row in f32 with the cells of
//   decode_common.cuh (GruCell::finish, LstmCell::finish), unchanged.  The
//   projection (mma_project) hands each item's staged sums to its end:
//   the dense end adds the bias and stores each batch row's 64 logits as
//   one contiguous run (a warp writes 128 contiguous bytes); the argmax
//   end gives each batch row four neighbouring threads, each scanning 16
//   consecutive vocabulary rows (sum + bias) for their first max, combines
//   the four by packed (logit, ~index) key (pack_key: of equal values the
//   lower index) and merges the item into best[row] with one atomicMax,
//   the first-max rule of vocab_pallas.merge_block_argmax, whatever the
//   grid or the order of the atomics (mma_argmax_keys).  The per-step
//   kernels read the tokens from best after a grid barrier (argmax_tokens);
//   the whole decode reads them in its own token phase.
//   The top-k end scans the same runs into each thread's K greatest keys
//   and its (max, sum of exp), combines a row's four threads into one part
//   per vocabulary item (mma_topk_parts) and, after a grid barrier,
//   merge_topk reduces each row's ceil(V / 64) parts: the dense end's
//   7.6 MB of logits at R = 192 never reach memory, and log_softmax is
//   taken in f32 from the same sums (logit - lse).
// - Registers: a phase reads threadIdx.x and its widths through an empty
//   asm (phase_thread), so that the whole decode, which inlines every
//   phase into its step loop, derives them anew in each phase instead of
//   holding them through the others (it spilled before, at 255 registers).
// - Coherence: every operand that another block may have written in the
//   same launch (layer inputs, the state h in the finish) is read through
//   L2 only (__ldcg), since L1 is not coherent across SMs; in the whole
//   decode that is every step's input and state.
// - Ragged edges: rows j >= H, v >= V and n >= B, and columns from K up to
//   the chunk's 32, are zeros in registers (never loaded); only j < H,
//   v < V and n < B are written or form a key.  K need only be a multiple
//   of 8.
//
// The f32 instances of tf32x3_step().  Their weights are twice the bf16
// bytes: 50.3 MB (GRU, E=256) and 62.3 MB (LSTM, E=512) a step at the
// pooled flagships, 56 and 68 MB at the attention ones (2E = 1024, W_dec),
// no longer inside the 50 MB L2, so every re-read of a weight is HBM
// traffic (the stack steps' recurrence alone: 29.9 and 41.9 MB, the
// LSTM's still past what L2 holds beside the states); the SIMT code
// re-read each weight once per 8 batch rows
// (24 times at R = 192 beam rows) and multiplied in an f32 FMA loop, its
// dense end stored each logit alone at a stride of V and its top-k end
// wrote a part per (warp, column range) of the grid.  Here the same items,
// pipeline, staging and ends run on mma.sync.m16n8k8 with tf32 operands
// (weights re-read once per 32-row slab, 6 times at R = 192; the dense
// end's runs of 64 logits; the top-k end's part per 64-row vocabulary
// item, so its keys and their merge do not depend on the grid):
// - Products in split-precision TF32 (3xTF32), this code's one deliberate
//   numeric choice.  Each f32 operand a is split in registers, as it
//   arrives, into big = tf32(a) and small = tf32(a - big), both rounded to
//   nearest with ties away (cvt.rna, which leaves the low 13 bits zero),
//   and a product is big_a big_b + big_a small_b + small_a big_b: three
//   mma's from a zeroed partial sum (small_a big_b first, big_a big_b
//   last), the partial sum then added to the item's f32 sum by an f32 add,
//   since the tensor cores truncate what they accumulate.  The small x
//   small term and the split's remainders are about 2^-21 of |a b|, f32's
//   order.  One-pass TF32 keeps about 2^-11 and would miss the f32 bars
//   (states within 1e-5 of the plain twin).  No pre-split copy of the
//   weights: it would double the bytes a step reads.
// - Fragments: m16n8k8 takes 8 K columns a step where m16n8k16 took 16.  A
//   chunk is kTf32Chunk = 16 columns, and lane (g, t) reads columns
//   4t .. 4t+3 of each row (16 contiguous bytes, as in bf16: a warp's load
//   is 8 rows x 64 contiguous bytes) and feeds them to two k8 steps:
//   columns 4t and 4t+1 to the first as its k = t and t + 4, 4t+2 and 4t+3
//   to the second, the same for A and B.  The accumulators' layout is
//   m16n8k16's, so the staging and the ends are shared.
// - Items: bf16's, and the layers split K across blocks as the stack step
//   does (S from ops/fused_step.stack_tiles for 16-column chunks: 8 parts
//   at B <= 32, 4 at B = 64, 2 at R = 96, 1 from B = 160; the attention
//   steps' 2E-wide layer 0 the same; the greedy, dense, top-k and stack
//   instances of a cell take the same S at the same rows, so their new
//   states are bit-equal): unsplit, a layer's 32 items
//   at B <= 32 left 100 SMs idle and each warp's chunks in one long chain
//   of HBM reads, and the step ran no faster than the SIMT code.  A weight
//   tile's slabs run at once on other blocks: taking a tile's two slabs in
//   turn on one block (its second read from L2) gained a little at B >= 64
//   but, with the K split, spilled registers.  kTf32Depth = 1: with a
//   second register buffer the f32 instances spilled too, the greedy ones
//   and even the LSTM stack step, whose kernel holds the layers alone (255
//   registers and 8 bytes of stack).  The GRU stack step's fit in 230
//   registers: it alone takes kTf32StackDepth = 2 (layer_depth()), 8-18%
//   faster at B = 32 .. 512; the depth moves only when loads are issued,
//   never a sum, so its states stay bit-equal to the greedy step's.

#pragma once

#include <type_traits>

#include "vocab_mma.cuh"

namespace {

constexpr int kMmaSlab = 32;                   // batch rows of an item: four n8 tiles
constexpr int kMmaChunk = 32;                  // K columns a step of a warp: two k16 mma steps
constexpr int kMmaSlots = 4;                   // m16 accumulator tiles of an item
constexpr int kMmaVals = kMmaSlots * 4 * 4;    // f32 sums a lane: slots x n8 tiles x 4
constexpr int kMmaPitch = 33;                  // floats a staged row of 32 lanes
constexpr int kMmaVocabRows = 16 * kMmaSlots;  // vocabulary rows of an item
constexpr int kMmaDepth = 2;                   // register buffers of a warp's chunk pipeline (3 and 4 ran slower)
constexpr size_t kMmaSmemFloats = static_cast<size_t>(kWarps) * kMmaVals * kMmaPitch;
constexpr int kMaxSplits = 8;                  // parts an item's K chunks may be split into (the stack step)
constexpr int kMmaPartFloats = kMmaSlots * kMmaSlab * 16;  // f32 sums of one part in the split-K scratch
constexpr int kTf32Chunk = 16;                 // K columns a step of a warp in f32: two k8 mma steps
constexpr int kTf32Depth = 1;                  // kMmaDepth of the f32 instances (2 spilled)
constexpr int kTf32StackDepth = 2;             // kMmaDepth of the f32 GRU stack step's layers (layer_depth)

// Whether a fused step's instance (or, with kArgmax, the whole decode) runs this file's code: bf16, any vocab end
// (dense, top-k, argmax or none), either cell.
template <typename T, int kMode>
__host__ __device__ constexpr bool mma_step() {
  return std::is_same<T, __nv_bfloat16>::value &&
         (kMode == kDense || kMode == kTopk || kMode == kArgmax || kMode == kNone);
}

// Whether a step's f32 instance runs this file's code in split-precision TF32: every end of fused_step.cu (argmax,
// dense, top-k and the stack step's none), either cell, and the whole decode, which runs the argmax instance's layers
// and key merge (fused_step.cu and whole_decode.cu ask it through pooled_mma_step); with kAttention,
// fused_attn_step.cu's argmax and dense ends, either cell.
template <typename T, int kMode, bool kAttention = false>
__host__ __device__ constexpr bool tf32x3_step() {
  return std::is_same<T, float>::value &&
         (kMode == kArgmax || kMode == kDense || (!kAttention && (kMode == kTopk || kMode == kNone)));
}

// Whether a pooled step's instance (fused_step.cu, whole_decode.cu) runs this file's code.
template <typename T, int kMode>
__host__ __device__ constexpr bool pooled_mma_step() {
  return mma_step<T, kMode>() || tf32x3_step<T, kMode>();
}

// The K geometry of each operand type: columns a chunk, columns a lane's 16-byte load, and the register buffers of a
// warp's chunk pipeline.
template <typename T> struct MmaShape;
template <> struct MmaShape<__nv_bfloat16> {
  static constexpr int kChunk = kMmaChunk, kLane = 8, kDepth = kMmaDepth;
};
template <> struct MmaShape<float> {
  static constexpr int kChunk = kTf32Chunk, kLane = 4, kDepth = kTf32Depth;
};

// The register buffers of a pooled step's layer pipeline: kTf32StackDepth for the f32 GRU stack step, whose kernel
// holds the layers alone (the LSTM's spills at two); its type's kDepth for every other instance.
template <typename T, typename Cell, int kMode>
__host__ __device__ constexpr int layer_depth() {
  return std::is_same<T, float>::value && kMode == kNone && Cell::kGates == 3 ? kTf32StackDepth : MmaShape<T>::kDepth;
}

// A layer's K split across blocks: S parts an item, for layer 0 and for the upper layers.
struct SplitK {
  float* partial;          // [max_parts, kMmaSlots, kMmaSlab, 16] scratch: each part's warp-ordered sums
  unsigned int* arrivals;  // [items] counters: 0 before a layer, 0 again after it
  int s0, su;              // S of layer 0 and of layers 1 .. L-1, 1 <= S <= kMaxSplits
  int max_parts;           // parts the scratch holds: items x S for each S > 1
};

// A K split of the layers (the stack steps of both types, the f32 tf32x3_step() instances: ``split``): 1 <= S <=
// kMaxSplits for layer 0 and for the upper layers, and where S > 1 the scratch and counters for items x S parts, an
// item 16 columns and 32 rows; the other instances (bf16 with a vocabulary end) take S = 1.
inline bool split_args_ok(bool split, const SplitK& k, int B, int H) {
  if (!split) return k.s0 == 1 && k.su == 1;
  const int items = (B + kMmaSlab - 1) / kMmaSlab * ((H + 15) / 16);
  auto ok = [&](int S) {
    return S >= 1 && S <= kMaxSplits && (S == 1 || (k.partial && k.arrivals && items * S <= k.max_parts));
  };
  return ok(k.s0) && ok(k.su);
}

// threadIdx.x, opaque to the compiler: a phase (a layer, a projection) reads it once, and its widths through the same
// empty asm, so that nothing it derives from them is hoisted out of the whole decode's step loop (see Registers above).
__device__ __forceinline__ int phase_thread() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// One chunk of a lane's fragments: rows g and g + 8 of each A tile, rows
// g, 8 + g, 16 + g, 24 + g of the batch slab.
struct MmaChunk {
  uint4 a[kMmaSlots][2];
  uint4 b[4];
};

// A: NA m16 row tiles, tile i at a + i * tile_step, its row r at + r * K; row r
// of tile i is real while r + i * row_step < a_rows.  B: the slab's rows at
// b, nb of them real.  Columns k0 + 8t .. k0 + 8t + 7 of each (bf16; f32:
// k0 + 4t .. k0 + 4t + 3), zero past K.
template <typename T, int NA>
__device__ __forceinline__ void mma_load(MmaChunk& f, const T* a, size_t tile_step, int a_rows, int row_step,
                                         const T* b, int nb, int K, int k0, int lane) {
  const int g = lane >> 2, k = k0 + MmaShape<T>::kLane * (lane & 3);
  const bool in_k = k < K;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      f.a[i][h] = in_k && r + i * row_step < a_rows
                      ? __ldg(reinterpret_cast<const uint4*>(a + i * tile_step + static_cast<size_t>(r) * K + k))
                      : zero;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = 8 * nt + g;
    f.b[nt] = in_k && n < nb ? __ldcg(reinterpret_cast<const uint4*>(b + static_cast<size_t>(n) * K + k)) : zero;
  }
}

// acc[nt] += tile i of the chunk x its n8 tiles nt < nts (those holding
// real rows; the rest stay 0): the two k16 steps.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const MmaChunk& f, int i, int nts) {
  const uint32_t lo[4] = {f.a[i][0].x, f.a[i][1].x, f.a[i][0].y, f.a[i][1].y};
  const uint32_t hi[4] = {f.a[i][0].z, f.a[i][1].z, f.a[i][0].w, f.a[i][1].w};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt < nts) {
      mma_bf16_16816(acc[nt], lo, f.b[nt].x, f.b[nt].y);
      mma_bf16_16816(acc[nt], hi, f.b[nt].z, f.b[nt].w);
    }
  }
}

// 3xTF32's split of an f32 value: big = tf32(v), small = tf32(v - big), each
// rounded to nearest with ties away (cvt.rna leaves the low 13 bits zero, so
// big reads back as the float it stands for, and v - big is exact in f32).
__device__ __forceinline__ void tf32_split(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(v - __uint_as_float(big)));
}

// mma_tf32_1688 is vocab_mma.cuh's, which the f32 projection kernels share.

// Float e (0..3, static once unrolled) of a lane's 16-byte load.
__device__ __forceinline__ float lane_float(const uint4& u, int e) {
  return __uint_as_float(e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w);
}

// f32: acc[nt] += k8 step s of tile i of the chunk x its n8 tiles nt < nts, in
// 3xTF32; bb, bs are the big and small halves of the B values of step s.  A
// fragment (m16n8k8, tf32): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4], logical k = t and t + 4 being the lane's floats 2s and
// 2s + 1 (columns 4t + 2s and 4t + 2s + 1 of the chunk); b0 = B[t][g],
// b1 = B[t+4][g] from the same floats of the batch row's load.  The step's
// three products are summed from zero on the tensor cores and added to acc
// by an f32 add (round to nearest): the tensor cores truncate what they
// accumulate, and a running sum carried through them over K drifted by
// about 2^-23 of its size an mma, past the f32 bar of 1e-5 on the states
// at the flagship widths.
__device__ __forceinline__ void mma_tile_tf32x3(float (&acc)[4][4], const MmaChunk& f, int i, int s, int nts,
                                                const uint32_t (&bb)[4][2], const uint32_t (&bs)[4][2]) {
  uint32_t ab[4], as[4];
  tf32_split(lane_float(f.a[i][0], 2 * s), ab[0], as[0]);
  tf32_split(lane_float(f.a[i][1], 2 * s), ab[1], as[1]);
  tf32_split(lane_float(f.a[i][0], 2 * s + 1), ab[2], as[2]);
  tf32_split(lane_float(f.a[i][1], 2 * s + 1), ab[3], as[3]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt < nts) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32_1688(d, as, bb[nt][0], bb[nt][1]);
      mma_tf32_1688(d, ab, bs[nt][0], bs[nt][1]);
      mma_tf32_1688(d, ab, bb[nt][0], bb[nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += d[e];
    }
  }
}

// The chunk's products: A tile i < NA into acc[i], but the GRU's n gate
// (NA == 3, tile 2) of an h-side chunk (n_h) into acc[3], its h side apart.
// bf16: mma_tile's two k16 steps a tile; f32: two k8 steps, each splitting
// the slab's B values once for all NA tiles.
template <typename T, int NA>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMmaSlots][4][4], const MmaChunk& f, int nts, bool n_h) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (NA == 3 && i == 2 && n_h)
        mma_tile(acc[3], f, i, nts);
      else
        mma_tile(acc[i], f, i, nts);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) tf32_split(lane_float(f.b[nt], 2 * s + h), bb[nt][h], bs[nt][h]);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if (NA == 3 && i == 2 && n_h)
          mma_tile_tf32x3(acc[3], f, i, s, nts, bb, bs);
        else
          mma_tile_tf32x3(acc[i], f, i, s, nts, bb, bs);
      }
    }
  }
}

__device__ __forceinline__ void mma_zero(float (&acc)[kMmaSlots][4][4]) {
#pragma unroll
  for (int s = 0; s < kMmaSlots; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.0f;
}

// Chunks [c0, c1) through load(f, c) and then compute(f, c), the loads of
// the next kDepth - 1 chunks in flight while one is computed (a ring of
// register buffers, unrolled so that every index is static).
template <int kDepth = kMmaDepth, typename Load, typename Compute>
__device__ __forceinline__ void mma_pipeline(int c0, int c1, Load load, Compute compute) {
  MmaChunk buf[kDepth];
#pragma unroll
  for (int d = 0; d + 1 < kDepth; ++d)
    if (c0 + d < c1) load(buf[d], c0 + d);
  for (int c = c0; c < c1; c += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (c + d < c1) {
        if (c + d + kDepth - 1 < c1) load(buf[(d + kDepth - 1) % kDepth], c + d + kDepth - 1);
        compute(buf[d], c + d);
      }
    }
  }
}

// Chunks [c0, c1) of this warp's split of n_chunks.
__device__ __forceinline__ void mma_split(int n_chunks, int& c0, int& c1, int warp) {
  c0 = warp * n_chunks / kWarps;
  c1 = (warp + 1) * n_chunks / kWarps;
}

// Chunks [c0, c1) of this warp's split of part s of S: the part's run [s n / S, (s + 1) n / S), split as mma_split.
__device__ __forceinline__ void mma_part_split(int n_chunks, int S, int s, int& c0, int& c1, int warp) {
  const int lo = s * n_chunks / S, n = (s + 1) * n_chunks / S - lo;
  mma_split(n, c0, c1, warp);
  c0 += lo;
  c1 += lo;
}

// Each warp's sums into shared memory, then the barrier after which any thread may read them.
__device__ __forceinline__ void mma_stage(const float (&acc)[kMmaSlots][4][4], float* red, int tid) {
  const int lane = tid & 31;
  float* mine = red + (tid >> 5) * kMmaVals * kMmaPitch;
#pragma unroll
  for (int s = 0; s < kMmaSlots; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((s * 4 + nt) * 4 + e) * kMmaPitch + lane] = acc[s][nt][e];
  __syncthreads();
}

// The item's sum at slot s, tile row m (0..15) and slab row n (0..31), over
// the four warps in order.  Accumulator e of lane 4g + t holds row g + 8(e/2),
// column 2t + e%2 of its n8 tile.
__device__ __forceinline__ float mma_sum(const float* red, int s, int m, int n) {
  const int at = ((s * 4 + (n >> 3)) * 4 + 2 * (m >> 3) + (n & 1)) * kMmaPitch + 4 * (m & 7) + ((n & 7) >> 1);
  float v = red[at];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += red[w * kMmaVals * kMmaPitch + at];
  return v;
}

// The sum of each slot at tile row m and slab row n over an item's S parts
// in the split-K scratch, added in the order s = 0 .. S - 1; the S x 4
// loads (through L2: other blocks wrote them) go out together.
__device__ __forceinline__ void mma_part_sums(const float* parts, int S, int m, int n, float (&t)[kMmaSlots]) {
  float v[kMaxSplits][kMmaSlots];
#pragma unroll
  for (int p = 0; p < kMaxSplits; ++p)
#pragma unroll
    for (int s = 0; s < kMmaSlots; ++s)
      v[p][s] = p < S ? __ldcg(parts + static_cast<size_t>(p) * kMmaPartFloats + (s * kMmaSlab + n) * 16 + m) : 0.0f;
#pragma unroll
  for (int s = 0; s < kMmaSlots; ++s) {
    t[s] = v[0][s];
#pragma unroll
    for (int p = 1; p < kMaxSplits; ++p)
      if (p < S) t[s] += v[p][s];
  }
}

// One layer of the recurrence over all B rows, by (16 columns, 32 rows)
// items.  K is the layer input's I columns, then h's H.  kSplit (the stack
// steps, the f32 tf32x3_step() instances): each item is S parts over its K
// chunks, finished by the last part to arrive (see the K split above);
// with S = 1 as without kSplit.  kDepth: the register buffers of the chunk
// pipeline (layer_depth()).
template <typename T, typename Cell, bool kSplit = false, int kDepth = MmaShape<T>::kDepth>
__device__ void mma_rnn_layer(const Layer<T>& y, float* red, const SplitK* sk = nullptr, int S = 1) {
  constexpr int G = Cell::kGates, kChunk = MmaShape<T>::kChunk;
  int H = y.H, I = y.I, B = y.B;
  asm volatile("" : "+r"(H), "+r"(I), "+r"(B));  // opaque, as phase_thread()
  const int cx = (I + kChunk - 1) / kChunk, n_chunks = cx + (H + kChunk - 1) / kChunk;
  const int tid = phase_thread(), lane = tid & 31;
  int c0, c1;
  mma_split(n_chunks, c0, c1, tid >> 5);
  const int slabs = (B + kMmaSlab - 1) / kMmaSlab, items = slabs * ((H + 15) / 16);
  for (int it = blockIdx.x; it < (kSplit ? items * S : items); it += gridDim.x) {
    const int item = kSplit ? it / S : it;
    if constexpr (kSplit) mma_part_split(n_chunks, S, it % S, c0, c1, tid >> 5);
    const int n0 = (item % slabs) * kMmaSlab, j0 = (item / slabs) * 16;
    const int nb = min(kMmaSlab, B - n0), nts = (nb + 7) / 8;
    auto load = [&](MmaChunk& f, int c) {
      if (c < cx)
        mma_load<T, G>(f, y.w_ih + static_cast<size_t>(j0) * I, static_cast<size_t>(H) * I, H - j0, 0,
                       y.xin + static_cast<size_t>(n0) * I, nb, I, c * kChunk, lane);
      else
        mma_load<T, G>(f, y.w_hh + static_cast<size_t>(j0) * H, static_cast<size_t>(H) * H, H - j0, 0,
                       y.hin + static_cast<size_t>(n0) * H, nb, H, (c - cx) * kChunk, lane);
    };
    float acc[kMmaSlots][4][4];
    mma_zero(acc);
    // the chunk's products; the GRU's n gate: the h side apart
    mma_pipeline<kDepth>(c0, c1, load, [&](const MmaChunk& f, int c) { mma_chunk<T, G>(acc, f, nts, c >= cx); });
    __syncthreads();  // the previous item's finish is done with red
    mma_stage(acc, red, tid);
    const float* parts = nullptr;  // the item's S parts in the scratch, once this block is the last to arrive
    if constexpr (kSplit) {
      if (S > 1) {
        float* mine = sk->partial + static_cast<size_t>(it) * kMmaPartFloats;  // part it % S of item it / S
        for (int o = tid; o < 16 * kMmaSlab; o += kThreads) {
          const int m = o & 15, n = o >> 4;
          if (n < nb && j0 + m < H)
#pragma unroll
            for (int s = 0; s < kMmaSlots; ++s) mine[(s * kMmaSlab + n) * 16 + m] = mma_sum(red, s, m, n);
        }
        // the block's stores, then one thread's arrival: an acquire-release atomicInc (wrapping back to 0), whose
        // release is cumulative over the stores the barrier ordered before it and whose acquire orders the last
        // part's loads after every part's stores
        __syncthreads();
        int last = 0;
        if (tid == 0) {
          unsigned int old;
          asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                       : "=r"(old) : "l"(sk->arrivals + item), "r"(static_cast<unsigned int>(S - 1)) : "memory");
          last = old == static_cast<unsigned int>(S - 1);
        }
        if (!__syncthreads_or(last)) continue;
        parts = sk->partial + static_cast<size_t>(item) * S * kMmaPartFloats;
      }
    }
    for (int o = tid; o < 16 * kMmaSlab; o += kThreads) {
      const int m = o & 15, n = o >> 4, j = j0 + m;
      if (n < nb && j < H) {
        float t[kMmaSlots];  // the item's sum of each slot: the staged warps, or the S parts in order
        if (kSplit && parts)
          mma_part_sums(parts, S, m, n, t);
        else
#pragma unroll
          for (int s = 0; s < kMmaSlots; ++s) t[s] = mma_sum(red, s, m, n);
        // GruCell: r and z over both sides in the x-side slots (their h-side sums 0), n apart
        float s[Cell::kAcc] = {};
        s[0] = t[0];
        s[1] = t[1];
        s[2] = t[2];
        if constexpr (G == 3)
          s[5] = t[3];
        else
          s[3] = t[3];
        const int row = n0 + n;
        const float h = Cell::kHidden ? Vec<T>::to_f32(__ldcg(y.hin + static_cast<size_t>(row) * H + j)) : 0.0f;
        Cell::template finish<T>(y, s, row, j, h);
      }
    }
  }
}

// Layer l of the stack on the tensor cores (stack_layer_args' operands).
template <typename T, typename Cell>
__device__ void mma_stack_layer(const StackArgs& s, int l, float* red) {
  mma_rnn_layer<T, Cell>(stack_layer_args<T, Cell>(s, l), red);
}

// Layer l with its K split S ways across blocks, S = sk.s0 for layer 0, sk.su above: the stack steps (kNone) and
// the f32 tf32x3_step() instances; kDepth as mma_rnn_layer's.
template <typename T, typename Cell, int kDepth = MmaShape<T>::kDepth>
__device__ void mma_stack_layer(const StackArgs& s, int l, float* red, const SplitK& sk) {
  mma_rnn_layer<T, Cell, true, kDepth>(stack_layer_args<T, Cell>(s, l), red, &sk, l == 0 ? sk.s0 : sk.su);
}

// top[b] . wv[v] in f32 for all B rows, by (64 vocabulary rows, 32 batch
// rows) items; top [B, H], wv [V, H].  After an item's sums are staged,
// every thread calls end(n0, nb, v0): mma_sum(red, m >> 4, m & 15, n) is
// the product of batch row n0 + n (n < nb) and vocabulary row v0 + m.
template <typename T, typename End>
__device__ __forceinline__ void mma_project(const T* top, const T* wv, int B, int H, int V, float* red, End end) {
  constexpr int kChunk = MmaShape<T>::kChunk;
  asm volatile("" : "+r"(B), "+r"(H), "+r"(V));  // opaque, as phase_thread()
  const int tid = phase_thread(), lane = tid & 31;
  int c0, c1;
  mma_split((H + kChunk - 1) / kChunk, c0, c1, tid >> 5);
  const int slabs = (B + kMmaSlab - 1) / kMmaSlab, items = slabs * ((V + kMmaVocabRows - 1) / kMmaVocabRows);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item % slabs) * kMmaSlab, v0 = (item / slabs) * kMmaVocabRows;
    const int nb = min(kMmaSlab, B - n0), nts = (nb + 7) / 8;
    auto load = [&](MmaChunk& f, int c) {
      mma_load<T, kMmaSlots>(f, wv + static_cast<size_t>(v0) * H, static_cast<size_t>(16) * H, V - v0, 16,
                             top + static_cast<size_t>(n0) * H, nb, H, c * kChunk, lane);
    };
    float acc[kMmaSlots][4][4];
    mma_zero(acc);
    mma_pipeline<MmaShape<T>::kDepth>(c0, c1, load,
                                      [&](const MmaChunk& f, int) { mma_chunk<T, kMmaSlots>(acc, f, nts, false); });
    __syncthreads();  // the previous item's end is done with red
    mma_stage(acc, red, tid);
    end(n0, nb, v0);
  }
}

// best[b] = max(best[b], the packed (logit, index) key of b's first max over
// v < V of top[b] . wv[v] + bv[v]), by one atomicMax an item and batch row;
// best must start below every key (0) behind a grid barrier.
template <typename T>
__device__ void mma_argmax_keys(const T* top, const T* wv, const T* bv, int B, int H, int V, unsigned long long* best,
                                float* red) {
  static_assert(kThreads == kRowThreads * kMmaSlab && kMmaVocabRows == kRowThreads * 16,
                "the argmax end: four threads a batch row, 16 vocabulary rows (one slot) each");
  const int tid = phase_thread();
  mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {
    const int n = tid / kRowThreads, q = tid % kRowThreads;  // slot q: rows v0 + 16q + m
    float val = -INFINITY;
    int idx = -1;
    if (n < nb) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {  // increasing v: of equal values the first stays
        const int v = v0 + 16 * q + m;
        if (v < V) {
          const float x = mma_sum(red, q, m, n) + Vec<T>::to_f32(bv[v]);
          if (idx < 0 || x > val) {
            val = x;
            idx = v;
          }
        }
      }
    }
    const unsigned long long key = row_max_key(idx >= 0 ? pack_key(val, idx) : 0ull);
    if (n < nb && q == 0) atomicMax(best + n0 + n, key);
  });
}

// The top-k end's parts: for each (64 vocabulary rows, 32 batch rows) item,
// each batch row's K greatest packed (logit, ~index) keys over the item
// (0 = empty) at part_keys[p][row][0..K), and the item's (max, sum of
// exp(logit - max)) at part_ms[p][row], p = v0 / 64.  The part is the
// vocabulary item, not the block that ran it, so the keys, and the order
// in which merge_topk folds the (max, sum) pairs, do not depend on the
// grid.  Thread 4n + q scans rows v0 + 16q .. v0 + 16q + 15 of batch row n
// (sum + bias in f32, v < V only) into a TopkList and its (m, s); the four
// threads of a row take the max of m and the rescaled sum of s by xor
// shuffles and K pops of the greatest head (TopkTileEnd's combine).  The
// bf16 and the f32 (3xTF32) instances alike.
template <typename T>
__device__ void mma_topk_parts(const T* top, const T* wv, const T* bv, int B, int H, int V, const TopkArgs& a,
                               float* red) {
  const int tid = phase_thread();
  mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {
    const int n = tid / kRowThreads, q = tid % kRowThreads;  // slot q: rows v0 + 16q + i
    TopkList list;
    list.clear();
    float x[16], m = -INFINITY, s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = v0 + 16 * q + i;
      x[i] = 0.0f;
      if (n < nb && v < V) {
        x[i] = mma_sum(red, q, i, n) + Vec<T>::to_f32(bv[v]);
        m = fmaxf(m, x[i]);
        list.insert(pack_key(x[i], v));
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (n < nb && v0 + 16 * q + i < V) s += expf(x[i] - m);
    float mx = m;
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = s > 0.0f ? s * expf(m - mx) : 0.0f;
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const bool writer = n < nb && q == 0;
    const size_t at = static_cast<size_t>(v0 / kMmaVocabRows) * B + n0 + n;
    for (int j = 0; j < a.K; ++j) {
      const unsigned long long best = row_max_key(list.keys[0]);
      if (list.keys[0] == best) list.pop();  // keys are unique (0 = empty pops harmlessly)
      if (writer) a.part_keys[at * a.K + j] = best;
    }
    if (writer) a.part_ms[at] = make_float2(mx, sum);
  });
}

// The vocab phase of an mma_step instance (or a tf32x3_step one), after
// the top activation is complete: the dense f32 logits, each row's top-K
// log-probabilities, or the first-max argmax tokens.
template <int kMode, typename T>
__device__ void mma_vocab_phase(const T* top, const T* wv, const T* bv, int B, int H, int V, const VocabOut& out,
                                float* red, cg::grid_group& grid) {
  if constexpr (kMode == kDense) {
    mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {
      // a batch row's 64 logits, one contiguous run: consecutive threads take consecutive v
      for (int o = threadIdx.x; o < kMmaVocabRows * kMmaSlab; o += kThreads) {
        const int m = o % kMmaVocabRows, n = o / kMmaVocabRows, v = v0 + m;
        if (n < nb && v < V)
          out.logits[static_cast<size_t>(n0 + n) * V + v] = mma_sum(red, m >> 4, m & 15, n) + Vec<T>::to_f32(bv[v]);
      }
    });
  } else if constexpr (kMode == kTopk) {
    mma_topk_parts(top, wv, bv, B, H, V, out.topk, red);
    grid.sync();  // every part is in scratch
    merge_topk(out.topk, B, (V + kMmaVocabRows - 1) / kMmaVocabRows);
  } else {
    static_assert(kMode == kArgmax, "the tensor-core steps end in dense logits, the top-k or the argmax");
    mma_argmax_keys(top, wv, bv, B, H, V, out.best, red);
    argmax_tokens(out, B, grid);
  }
}

}  // namespace
