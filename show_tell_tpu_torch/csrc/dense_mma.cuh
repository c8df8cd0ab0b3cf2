// The bf16 fused steps on Hopper's tensor cores: the recurrence and the
// vocab projection as mma.sync m16n8k16 products (bf16 in, f32 sums), with
// three ends of the projection: the dense f32 logits (beam), each row's
// top-K log-probabilities (beam, sparse) and the first-max argmax (greedy),
// or none (the stack step, kNone: the recurrence alone).
// mma_step() names the instances that run this file's code: in bf16, every
// instance of fused_step.cu and fused_attn_step.cu (both cells), and the
// whole decode of whole_decode.cu, which runs the pooled GRU argmax
// instance's layers and key merge T times and so stays bit-equal to its
// per-step loop.  The f32 instances keep the SIMT code of decode_common.cuh.
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
// - K split across blocks (the stack step only, SplitK): at a small batch a
//   layer has few items (32 at B = 1: 32 of 132 SMs pull its weights), so
//   the stack step's instance may cut each item into S parts, part s taking
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
//   kernels read the tokens from best after a grid barrier (argmax_tokens,
//   as the SIMT end); the whole decode reads them in its own token phase.
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

// Whether a fused step's instance (or, with kArgmax, the whole decode) runs this file's code: bf16, any vocab end
// (dense, top-k, argmax or none), either cell.
template <typename T, int kMode>
__host__ __device__ constexpr bool mma_step() {
  return std::is_same<T, __nv_bfloat16>::value &&
         (kMode == kDense || kMode == kTopk || kMode == kArgmax || kMode == kNone);
}

// The stack step's K split across blocks: S parts an item, for layer 0 and for the upper layers.
struct SplitK {
  float* partial;          // [max_parts, kMmaSlots, kMmaSlab, 16] scratch: each part's warp-ordered sums
  unsigned int* arrivals;  // [items] counters: 0 before a layer, 0 again after it
  int s0, su;              // S of layer 0 and of layers 1 .. L-1, 1 <= S <= kMaxSplits
  int max_parts;           // parts the scratch holds: items x S for each S > 1
};

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
// b, nb of them real.  Columns k0 + 8t .. k0 + 8t + 7 of each, zero past K.
template <int NA>
__device__ __forceinline__ void mma_load(MmaChunk& f, const __nv_bfloat16* a, size_t tile_step, int a_rows,
                                         int row_step, const __nv_bfloat16* b, int nb, int K, int k0, int lane) {
  const int g = lane >> 2, k = k0 + 8 * (lane & 3);
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

__device__ __forceinline__ void mma_zero(float (&acc)[kMmaSlots][4][4]) {
#pragma unroll
  for (int s = 0; s < kMmaSlots; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.0f;
}

// Chunks [c0, c1) through load(f, c) and then compute(f, c), the loads of
// the next kMmaDepth - 1 chunks in flight while one is computed (a ring of
// register buffers, unrolled so that every index is static).
template <typename Load, typename Compute>
__device__ __forceinline__ void mma_pipeline(int c0, int c1, Load load, Compute compute) {
  MmaChunk buf[kMmaDepth];
#pragma unroll
  for (int d = 0; d + 1 < kMmaDepth; ++d)
    if (c0 + d < c1) load(buf[d], c0 + d);
  for (int c = c0; c < c1; c += kMmaDepth) {
#pragma unroll
    for (int d = 0; d < kMmaDepth; ++d) {
      if (c + d < c1) {
        if (c + d + kMmaDepth - 1 < c1) load(buf[(d + kMmaDepth - 1) % kMmaDepth], c + d + kMmaDepth - 1);
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
// step): each item is S parts over its K chunks, finished by the last part
// to arrive (see the K split above); with S = 1 as without kSplit.
template <typename Cell, bool kSplit = false>
__device__ void mma_rnn_layer(const Layer<__nv_bfloat16>& y, float* red, const SplitK* sk = nullptr, int S = 1) {
  constexpr int G = Cell::kGates;
  int H = y.H, I = y.I, B = y.B;
  asm volatile("" : "+r"(H), "+r"(I), "+r"(B));  // opaque, as phase_thread()
  const int cx = (I + kMmaChunk - 1) / kMmaChunk, n_chunks = cx + (H + kMmaChunk - 1) / kMmaChunk;
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
        mma_load<G>(f, y.w_ih + static_cast<size_t>(j0) * I, static_cast<size_t>(H) * I, H - j0, 0,
                    y.xin + static_cast<size_t>(n0) * I, nb, I, c * kMmaChunk, lane);
      else
        mma_load<G>(f, y.w_hh + static_cast<size_t>(j0) * H, static_cast<size_t>(H) * H, H - j0, 0,
                    y.hin + static_cast<size_t>(n0) * H, nb, H, (c - cx) * kMmaChunk, lane);
    };
    float acc[kMmaSlots][4][4];
    mma_zero(acc);
    mma_pipeline(c0, c1, load, [&](const MmaChunk& f, int c) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (G == 3 && i == 2 && c >= cx)
          mma_tile(acc[3], f, i, nts);  // the GRU's n gate: the h side apart
        else
          mma_tile(acc[i], f, i, nts);
      }
    });
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
        const float h = Cell::kHidden ? __bfloat162float(__ldcg(y.hin + static_cast<size_t>(row) * H + j)) : 0.0f;
        Cell::template finish<__nv_bfloat16>(y, s, row, j, h);
      }
    }
  }
}

// Layer l of the stack on the tensor cores (stack_layer's operands).
template <typename Cell>
__device__ void mma_stack_layer(const StackArgs& s, int l, float* red) {
  mma_rnn_layer<Cell>(stack_layer_args<__nv_bfloat16, Cell>(s, l), red);
}

// Layer l of the stack step (kNone): its K split S ways across blocks, S = sk.s0 for layer 0, sk.su above.
template <typename Cell>
__device__ void mma_stack_layer(const StackArgs& s, int l, float* red, const SplitK& sk) {
  mma_rnn_layer<Cell, true>(stack_layer_args<__nv_bfloat16, Cell>(s, l), red, &sk, l == 0 ? sk.s0 : sk.su);
}

// top[b] . wv[v] in f32 for all B rows, by (64 vocabulary rows, 32 batch
// rows) items; top [B, H], wv [V, H].  After an item's sums are staged,
// every thread calls end(n0, nb, v0): mma_sum(red, m >> 4, m & 15, n) is
// the product of batch row n0 + n (n < nb) and vocabulary row v0 + m.
template <typename End>
__device__ __forceinline__ void mma_project(const __nv_bfloat16* top, const __nv_bfloat16* wv, int B, int H, int V,
                                            float* red, End end) {
  asm volatile("" : "+r"(B), "+r"(H), "+r"(V));  // opaque, as phase_thread()
  const int tid = phase_thread(), lane = tid & 31;
  int c0, c1;
  mma_split((H + kMmaChunk - 1) / kMmaChunk, c0, c1, tid >> 5);
  const int slabs = (B + kMmaSlab - 1) / kMmaSlab, items = slabs * ((V + kMmaVocabRows - 1) / kMmaVocabRows);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item % slabs) * kMmaSlab, v0 = (item / slabs) * kMmaVocabRows;
    const int nb = min(kMmaSlab, B - n0), nts = (nb + 7) / 8;
    auto load = [&](MmaChunk& f, int c) {
      mma_load<kMmaSlots>(f, wv + static_cast<size_t>(v0) * H, static_cast<size_t>(16) * H, V - v0, 16,
                          top + static_cast<size_t>(n0) * H, nb, H, c * kMmaChunk, lane);
    };
    float acc[kMmaSlots][4][4];
    mma_zero(acc);
    mma_pipeline(c0, c1, load, [&](const MmaChunk& f, int) {
#pragma unroll
      for (int i = 0; i < kMmaSlots; ++i) mma_tile(acc[i], f, i, nts);
    });
    __syncthreads();  // the previous item's end is done with red
    mma_stage(acc, red, tid);
    end(n0, nb, v0);
  }
}

// best[b] = max(best[b], the packed (logit, index) key of b's first max over
// v < V of top[b] . wv[v] + bv[v]), by one atomicMax an item and batch row;
// best must start below every key (0) behind a grid barrier.
__device__ void mma_argmax_keys(const __nv_bfloat16* top, const __nv_bfloat16* wv, const __nv_bfloat16* bv, int B,
                                int H, int V, unsigned long long* best, float* red) {
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
          const float x = mma_sum(red, q, m, n) + __bfloat162float(bv[v]);
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
// shuffles and K pops of the greatest head (TopkTileEnd's combine).
__device__ void mma_topk_parts(const __nv_bfloat16* top, const __nv_bfloat16* wv, const __nv_bfloat16* bv, int B,
                               int H, int V, const TopkArgs& a, float* red) {
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
        x[i] = mma_sum(red, q, i, n) + __bfloat162float(bv[v]);
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

// The vocab phase of an mma_step instance, after the top activation is
// complete: the dense f32 logits, each row's top-K log-probabilities, or
// the first-max argmax tokens.
template <int kMode>
__device__ void mma_vocab_phase(const __nv_bfloat16* top, const __nv_bfloat16* wv, const __nv_bfloat16* bv, int B,
                                int H, int V, const VocabOut& out, float* red, cg::grid_group& grid) {
  if constexpr (kMode == kDense) {
    mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {
      // a batch row's 64 logits, one contiguous run: consecutive threads take consecutive v
      for (int o = threadIdx.x; o < kMmaVocabRows * kMmaSlab; o += kThreads) {
        const int m = o % kMmaVocabRows, n = o / kMmaVocabRows, v = v0 + m;
        if (n < nb && v < V)
          out.logits[static_cast<size_t>(n0 + n) * V + v] = mma_sum(red, m >> 4, m & 15, n) + __bfloat162float(bv[v]);
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
