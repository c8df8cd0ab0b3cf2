// Device code shared by the decode kernels (fused_step.cu,
// fused_attn_step.cu, attention_context.cu, project_argmax.cu,
// project_topk.cu, whole_decode.cu): 16-byte vector loads, warp
// reductions, the first-max argmax key, the GRU and LSTM stack layers, the
// vocab projection with its ends (first-max argmax, dense f32 logits,
// top-K with logsumexp, or none), and the cooperative launch.
//
// Every kernel here runs kThreads threads a block.  Weights are in the torch
// layout [out, in], so one output column is one contiguous row: a warp owns
// a column, each lane reads 16 contiguous bytes of it per chunk (512 bytes a
// warp load), multiplies them with up to kBM batch rows held in shared
// memory as f32, and the warp reduces by shuffles.  Row widths must be
// multiples of 8 elements (the callers check), so every 16-byte load is
// aligned and whole.
//
// Everything is a template, inline or in an anonymous namespace, so each
// .cu file that includes this header compiles its own copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;  // batch rows per tile (<= 32: lane b finishes row b)

// 16-byte vector loads converted to f32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void ldg(const float* p, float* out) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  // Through L2 only: the data may have been written by another block in this launch.
  __device__ static void ldcg(const float* p, float* out) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float to_f32(float v) { return v; }
  __device__ static float from_f32(float v) { return v; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void ldg(const __nv_bfloat16* p, float* out) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
  __device__ static void ldcg(const __nv_bfloat16* p, float* out) {
    unpack(__ldcg(reinterpret_cast<const uint4*>(p)), out);
  }
  __device__ static float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f32(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// Monotone map of a float onto unsigned bits: a < b  <=>  key(a) < key(b).
// +0.0f folds -0.0 onto +0.0, which compare equal as floats.  The low half
// holds ~index, so of two equal values the lower index has the larger key:
// atomicMax over keys is the first-max rule of vocab_pallas.merge_block_argmax.
__device__ __forceinline__ unsigned long long pack_key(float v, int idx) {
  unsigned int u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned int>(idx));
}

__device__ __forceinline__ int32_t key_index(unsigned long long key) {
  return static_cast<int32_t>(0xffffffffu - static_cast<unsigned int>(key & 0xffffffffull));
}

// The float that pack_key packed (-0.0 comes back as +0.0).
__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned int u = static_cast<unsigned int>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// Rows [b0, b0 + nb) of src [*, width] into smem [kBM][width] as f32.
template <typename T>
__device__ void load_rows(float* smem, const T* src, int b0, int nb, int width) {
  constexpr int N = Vec<T>::N;
  for (int i = threadIdx.x * N; i < nb * width; i += kThreads * N) {
    Vec<T>::ldcg(src + static_cast<size_t>(b0) * width + i, smem + i);
  }
}

// Splits the work of one phase into (batch tile, column range) items:
// every block gets at least one item while there are columns to go round.
// max_splits caps the column ranges (the top-k phase's scratch holds that
// many per row).
struct Tiling {
  int row_tiles, splits, per_split;
  __device__ Tiling(int B, int cols, int max_splits = 0x7fffffff) {
    row_tiles = (B + kBM - 1) / kBM;
    splits = max(1, static_cast<int>(gridDim.x) / row_tiles);
    splits = min(min(splits, cols), max_splits);
    per_split = (cols + splits - 1) / splits;
  }
  __device__ int items() const { return row_tiles * splits; }
};

// The recurrence's state and weights, stacked over the L layers.  Layer 0
// reads x [B, I0] with its own w_ih0 [G*H, I0]; layer l > 0 reads layer
// l-1's output from new_hs with w_ihU[l-1] [G*H, H].  G is the cell's gate
// count (3 GRU, 4 LSTM); cs and new_cs are the LSTM's cell state, null for
// the GRU.
struct StackArgs {
  const void* x;      // [B, I0]     layer-0 input
  const void* w_ih0;  // [G*H, I0]
  const void* w_ihU;  // [L-1, G*H, H]
  const void* w_hh;   // [L, G*H, H]
  const void* b_ih;   // [L, G*H]
  const void* b_hh;   // [L, G*H]
  const void* hs;     // [L, B, H]   state in
  const void* cs;     // [L, B, H]   cell state in (LSTM), or null
  void* new_hs;       // [L, B, H]   state out
  void* new_cs;       // [L, B, H]   cell state out (LSTM), or null
  int L, B, I0, H;
};

// Shared memory a block needs for one layer: kBM rows of the wider input plus kBM rows of h.
inline size_t stack_smem_floats(const StackArgs& s) {
  return static_cast<size_t>(kBM) * ((s.I0 > s.H ? s.I0 : s.H) + s.H);
}

// One layer of the stack over all B rows, as pointers into StackArgs.
template <typename T>
struct Layer {
  const T* xin;   // [B, I]
  const T* hin;   // [B, H]
  const T* cin;   // [B, H] (LSTM) or null
  const T* w_ih;  // [G*H, I]
  const T* w_hh;  // [G*H, H]
  const T* b_ih;  // [G*H]
  const T* b_hh;  // [G*H]
  T* hout;        // [B, H]
  T* cout;        // [B, H] (LSTM) or null
  int I, B, H;
};

// acc[b][A0 + g] += w[g*H + j] . rows[b] for the G gates of column j and
// the nb rows held in shared memory (width floats each).  Each lane takes
// 16-byte chunks of the weight rows; the warp sums the lanes afterwards.
template <typename T, int G, int A0, int NA>
__device__ __forceinline__ void gate_dots(float (&acc)[kBM][NA], const T* w, int width, int H, int j,
                                          const float* rows, int nb) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  for (int k = lane * N; k < width; k += 32 * N) {
    float wv[G][N];
#pragma unroll
    for (int g = 0; g < G; ++g) Vec<T>::ldg(w + static_cast<size_t>(g * H + j) * width + k, wv[g]);
#pragma unroll
    for (int b = 0; b < kBM; ++b) {
      if (b < nb) {
        const float* r = rows + b * width + k;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g) acc[b][A0 + g] += wv[g][i] * r[i];
      }
    }
  }
}

// The cells.  Each names its gate count G, its kAcc f32 sums per row and
// column (the x-side sums go to acc[0..G), the h-side sums from kHidden),
// and finish(), which turns lane b's sums into row b's outputs at column j
// (inlined, so that the sums stay in registers).
// Weights are in the torch layout with torch's gate order and double
// biases; the gate math is f32 and only the stored states are cast to T.

// GRU, gates r, z, n: the reset gate multiplies the hidden-side affine
// W_hn h + b_hn, so the two sides are summed apart.
struct GruCell {
  static constexpr int kGates = 3, kAcc = 6, kHidden = 3;
  template <typename T>
  __device__ __forceinline__ static void finish(const Layer<T>& y, const float* s, int row, int j, float h) {
    const int H = y.H;
    const float gx_r = s[0] + Vec<T>::to_f32(y.b_ih[j]);
    const float gx_z = s[1] + Vec<T>::to_f32(y.b_ih[H + j]);
    const float gx_n = s[2] + Vec<T>::to_f32(y.b_ih[2 * H + j]);
    const float gh_r = s[3] + Vec<T>::to_f32(y.b_hh[j]);
    const float gh_z = s[4] + Vec<T>::to_f32(y.b_hh[H + j]);
    const float gh_n = s[5] + Vec<T>::to_f32(y.b_hh[2 * H + j]);
    const float r = sigmoidf(gx_r + gh_r);
    const float z = sigmoidf(gx_z + gh_z);
    const float n = tanhf(gx_n + r * gh_n);
    y.hout[static_cast<size_t>(row) * H + j] = Vec<T>::from_f32((1.0f - z) * n + z * h);
  }
};

// LSTM, gates i, f, g, o: both sides of a gate go into one sum (4 sums a
// row where keeping them apart would take 8 and spill).  c' = f c + i g
// and h' = o tanh(c') are taken in f32 from the unrounded c', as
// rnn_pallas.lstm_cell_math does; then each is cast to T.
struct LstmCell {
  static constexpr int kGates = 4, kAcc = 4, kHidden = 0;
  template <typename T>
  __device__ __forceinline__ static void finish(const Layer<T>& y, const float* s, int row, int j, float) {
    const int H = y.H;
    const float ig = sigmoidf(s[0] + Vec<T>::to_f32(y.b_ih[j]) + Vec<T>::to_f32(y.b_hh[j]));
    const float fg = sigmoidf(s[1] + Vec<T>::to_f32(y.b_ih[H + j]) + Vec<T>::to_f32(y.b_hh[H + j]));
    const float gg = tanhf(s[2] + Vec<T>::to_f32(y.b_ih[2 * H + j]) + Vec<T>::to_f32(y.b_hh[2 * H + j]));
    const float og = sigmoidf(s[3] + Vec<T>::to_f32(y.b_ih[3 * H + j]) + Vec<T>::to_f32(y.b_hh[3 * H + j]));
    const size_t at = static_cast<size_t>(row) * H + j;
    const float c = fg * Vec<T>::to_f32(y.cin[at]) + ig * gg;
    y.cout[at] = Vec<T>::from_f32(c);
    y.hout[at] = Vec<T>::from_f32(og * tanhf(c));
  }
};

// One layer over all B rows, split into (batch tile, column range) items.
// xs holds kBM rows of I floats, hsm kBM rows of H.
template <typename T, typename Cell>
__device__ void rnn_layer(const Layer<T>& y, float* xs, float* hsm) {
  constexpr int G = Cell::kGates, NA = Cell::kAcc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = y.H;
  Tiling t(y.B, H);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, y.B - b0);
    const int j0 = (item % t.splits) * t.per_split;
    const int j1 = min(H, j0 + t.per_split);
    __syncthreads();  // the previous item is done with the tiles
    load_rows<T>(xs, y.xin, b0, nb, y.I);
    load_rows<T>(hsm, y.hin, b0, nb, H);
    __syncthreads();
    for (int j = j0 + warp; j < j1; j += kWarps) {
      float acc[kBM][NA];
#pragma unroll
      for (int b = 0; b < kBM; ++b)
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[b][a] = 0.0f;
      gate_dots<T, G, 0>(acc, y.w_ih, y.I, H, j, xs, nb);
      gate_dots<T, G, Cell::kHidden>(acc, y.w_hh, H, H, j, hsm, nb);
      float mine[NA];  // lane b ends with row b0 + b's sums
#pragma unroll
      for (int a = 0; a < NA; ++a) mine[a] = 0.0f;
#pragma unroll
      for (int b = 0; b < kBM; ++b) {
        if (b < nb) {
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const float v = warp_sum(acc[b][a]);
            if (lane == b) mine[a] = v;
          }
        }
      }
      if (lane < nb) Cell::template finish<T>(y, mine, b0 + lane, j, hsm[lane * H + j]);
    }
  }
}

// Layer l of the stack as pointers into StackArgs: its input is x (l = 0)
// or layer l-1's output in new_hs.
template <typename T, typename Cell>
__device__ __forceinline__ Layer<T> stack_layer_args(const StackArgs& s, int l) {
  const size_t GH = static_cast<size_t>(Cell::kGates) * s.H;
  const size_t BH = static_cast<size_t>(s.B) * s.H;
  const T* new_hs = static_cast<const T*>(s.new_hs);
  return Layer<T>{
      l == 0 ? static_cast<const T*>(s.x) : new_hs + (l - 1) * BH,
      static_cast<const T*>(s.hs) + l * BH,
      s.cs ? static_cast<const T*>(s.cs) + l * BH : nullptr,
      l == 0 ? static_cast<const T*>(s.w_ih0) : static_cast<const T*>(s.w_ihU) + (l - 1) * GH * s.H,
      static_cast<const T*>(s.w_hh) + l * GH * s.H,
      static_cast<const T*>(s.b_ih) + l * GH,
      static_cast<const T*>(s.b_hh) + l * GH,
      static_cast<T*>(s.new_hs) + l * BH,
      s.new_cs ? static_cast<T*>(s.new_cs) + l * BH : nullptr,
      l == 0 ? s.I0 : s.H,
      s.B,
      s.H,
  };
}

// Layer l of a decode step's recurrence.  A kernel templated on the cell
// calls it for l = 0..L-1 with a grid barrier after each.
template <typename T, typename Cell>
__device__ void stack_layer(const StackArgs& s, int l, float* smem) {
  float* xs = smem;
  float* hsm = smem + static_cast<size_t>(kBM) * (s.I0 > s.H ? s.I0 : s.H);
  rnn_layer<T, Cell>(stack_layer_args<T, Cell>(s, l), xs, hsm);
}

// The vocab projection  logit = top[b] . wv[v] + bv[v]  (f32) for all B
// rows, split into (batch tile, column range) items; top [B, H], wv [V, H].
// A warp takes one column at a time and lane b ends with row b0 + b's
// logit.  Per item, each warp calls sink.start(), then sink.column(row, v,
// logit) on its lanes b < nb for its columns in increasing v, then
// sink.finish(b0, nb, split, warp, lane).
template <typename T, typename Sink>
__device__ __forceinline__ void project_items(const T* top, const T* wv, const T* bv, int B, int H, int V,
                                              const Tiling& t, float* xs, Sink& sink) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int split = item % t.splits;
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, B - b0);
    const int v0 = split * t.per_split;
    const int v1 = min(V, v0 + t.per_split);
    __syncthreads();
    load_rows<T>(xs, top, b0, nb, H);
    __syncthreads();
    sink.start();
    for (int v = v0 + warp; v < v1; v += kWarps) {
      float acc[kBM];
#pragma unroll
      for (int b = 0; b < kBM; ++b) acc[b] = 0.0f;
      for (int k = lane * N; k < H; k += 32 * N) {
        float w[N];
        Vec<T>::ldg(wv + static_cast<size_t>(v) * H + k, w);
#pragma unroll
        for (int b = 0; b < kBM; ++b) {
          if (b < nb) {
            const float* xr = xs + b * H + k;
#pragma unroll
            for (int i = 0; i < N; ++i) acc[b] += w[i] * xr[i];
          }
        }
      }
      float mine = 0.0f;
#pragma unroll
      for (int b = 0; b < kBM; ++b) {
        if (b < nb) {
          const float s = warp_sum(acc[b]);
          if (lane == b) mine = s;
        }
      }
      if (lane < nb) sink.column(b0 + lane, v, mine + Vec<T>::to_f32(bv[v]));
    }
    sink.finish(b0, nb, split, warp, lane);
  }
}

// Greedy end: lane b keeps the running first max of its row over the
// warp's columns (visited in increasing order), then merges it into
// best[row] by atomicMax over packed (logit, index) keys.  best must start
// below every key (0).
struct ArgmaxSink {
  unsigned long long* best;  // [B]
  float val;
  int idx;
  __device__ __forceinline__ void start() {
    val = -INFINITY;
    idx = -1;
  }
  __device__ __forceinline__ void column(int, int v, float logit) {
    if (idx < 0 || logit > val) {
      val = logit;
      idx = v;
    }
  }
  __device__ __forceinline__ void finish(int b0, int nb, int, int, int lane) {
    if (lane < nb && idx >= 0) atomicMax(best + b0 + lane, pack_key(val, idx));
  }
};

// Beam's dense end: the f32 logits themselves, logits[row, v].  Lane b
// stores row b's logit, so a warp's 8 stores stride by V: simple, not
// coalesced (a staging tile in shared memory would coalesce them).
struct DenseSink {
  float* logits;  // [B, V]
  int V;
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void column(int row, int v, float logit) {
    logits[static_cast<size_t>(row) * V + v] = logit;
  }
  __device__ __forceinline__ void finish(int, int, int, int, int) {}
};

// Beam's sparse end: each row's K best (log-probability, index) pairs.
// Part p = split * kWarps + warp of a row is what one warp saw of it in
// one column range; the phase writes every part's top-K keys and its
// online logsumexp (m, s) to scratch, and merge_topk reduces the parts.
constexpr int kMaxK = 8;

struct TopkArgs {
  unsigned long long* part_keys;  // [n_parts, B, K] scratch: packed (logit, index), 0 = empty
  float2* part_ms;                // [n_parts, B] scratch: (max, sum of exp(logit - max))
  float* logp;                    // [B, K] out: logit - logsumexp, best first
  int32_t* ids;                   // [B, K] out
  int K, max_splits;              // K <= kMaxK; n_parts <= max_splits * kWarps
};

// A sorted (descending) list of the kMaxK greatest keys seen, in registers:
// the K greatest are its first K.  A key enters when it beats the last;
// every index is static (no index depends on K, which would put the list
// in local memory).
struct TopkList {
  unsigned long long keys[kMaxK];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) keys[i] = 0ull;
  }
  __device__ __forceinline__ void insert(unsigned long long key) {
    if (key <= keys[kMaxK - 1]) return;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {  // keep the larger, carry the smaller on
      const unsigned long long hi = keys[i] > key ? keys[i] : key;
      key = keys[i] > key ? key : keys[i];
      keys[i] = hi;
    }
  }
  __device__ __forceinline__ void pop() {  // drop keys[0]
#pragma unroll
    for (int i = 0; i + 1 < kMaxK; ++i) keys[i] = keys[i + 1];
    keys[kMaxK - 1] = 0ull;
  }
};

// (m, s) <- the logsumexp pair of both (m, s) and (m2, s2); s2 = 0 is empty.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (s2 == 0.0f) return;
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

struct TopkSink {
  TopkArgs a;
  int B;
  TopkList list;
  float m, s;
  __device__ __forceinline__ void start() {
    list.clear();
    m = -INFINITY;
    s = 0.0f;
  }
  __device__ __forceinline__ void column(int, int v, float logit) {
    lse_merge(m, s, logit, 1.0f);
    list.insert(pack_key(logit, v));
  }
  __device__ __forceinline__ void finish(int b0, int nb, int split, int warp, int lane) {
    if (lane >= nb) return;
    const size_t at = static_cast<size_t>(split * kWarps + warp) * B + b0 + lane;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < a.K) a.part_keys[at * a.K + j] = list.keys[j];
    a.part_ms[at] = make_float2(m, s);
  }
};

// After a grid barrier: one warp per row merges the row's parts.  Each lane
// folds every 32nd part into its own top-K and (m, s); the warp then takes
// the K greatest heads in turn (a greater value first, of equal values the
// lower index: jax.lax.top_k's order) and lse = m* + log sum_i s_i
// exp(m_i - m*) over the lanes.
__device__ __forceinline__ void merge_topk(const TopkArgs& a, int B, int n_parts) {
  const int lane = threadIdx.x & 31;
  const int K = a.K;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < B; row += gridDim.x * kWarps) {
    TopkList list;
    list.clear();
    float m = -INFINITY, s = 0.0f;
    for (int p = lane; p < n_parts; p += 32) {
      const size_t at = static_cast<size_t>(p) * B + row;
      for (int j = 0; j < K; ++j) list.insert(__ldcg(a.part_keys + at * K + j));
      const float2 ms = __ldcg(a.part_ms + at);
      lse_merge(m, s, ms.x, ms.y);
    }
    float mx = m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float lse = mx + logf(warp_sum(s > 0.0f ? s * expf(m - mx) : 0.0f));
    for (int j = 0; j < K; ++j) {
      unsigned long long best = list.keys[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
        best = other > best ? other : best;
      }
      if (list.keys[0] == best) list.pop();  // keys are unique: one lane pops
      if (lane == 0) {
        a.logp[static_cast<size_t>(row) * K + j] = key_value(best) - lse;
        a.ids[static_cast<size_t>(row) * K + j] = key_index(best);
      }
    }
  }
}

// best[b] = atomicMax over packed (logit, index) keys of top[b] . wv[v] + bv[v]
// for v in [0, V).  top [B, H], wv [V, H]; best must start below every key (0).
template <typename T>
__device__ void project_argmax(const T* top, const T* wv, const T* bv, int B, int H, int V,
                               unsigned long long* best, float* xs) {
  ArgmaxSink sink{best};
  project_items<T>(top, wv, bv, B, H, V, Tiling(B, V), xs, sink);
}

__device__ __forceinline__ int grid_thread() { return blockIdx.x * kThreads + threadIdx.x; }
__device__ __forceinline__ int grid_threads() { return gridDim.x * kThreads; }

// The ends of a decode step's vocab phase, picked at compile time; kNone
// ends the step after the recurrence (the top activation is new_hs[L-1]).
enum VocabMode { kArgmax = 0, kDense = 1, kTopk = 2, kNone = 3 };

struct VocabOut {
  int32_t* tok;               // argmax: [B] out
  unsigned long long* best;   // argmax: [B] scratch, zeroed before a grid barrier that precedes the phase
  float* logits;              // dense: [B, V] out
  TopkArgs topk;              // top-k: outs and scratch
};

// The argmax end's last barrier and its tokens: once every block's
// atomicMax has landed in best, tok[b] is the index of best[b]'s key.
__device__ __forceinline__ void argmax_tokens(const VocabOut& o, int B, cg::grid_group& grid) {
  grid.sync();
  for (int b = grid_thread(); b < B; b += grid_threads()) o.tok[b] = key_index(o.best[b]);
}

// The vocab phase after the top activation is complete (a grid barrier
// before it): argmax tokens, dense logits or top-K log-probabilities.
template <int kMode, typename T>
__device__ __forceinline__ void vocab_phase(const T* top, const T* wv, const T* bv, int B, int H, int V,
                                            const VocabOut& o, float* xs, cg::grid_group& grid) {
  if constexpr (kMode == kArgmax) {
    project_argmax<T>(top, wv, bv, B, H, V, o.best, xs);
    argmax_tokens(o, B, grid);
  } else if constexpr (kMode == kDense) {
    DenseSink sink{o.logits, V};
    project_items<T>(top, wv, bv, B, H, V, Tiling(B, V), xs, sink);
  } else {
    const Tiling t(B, V, o.topk.max_splits);
    TopkSink sink{o.topk, B};
    project_items<T>(top, wv, bv, B, H, V, t, xs, sink);
    grid.sync();  // every part is in scratch
    merge_topk(o.topk, B, t.splits * kWarps);
  }
}

// Launch ``kernel`` cooperatively with kThreads threads a block and as many
// blocks as can be resident at once (the occupancy API times the SM count),
// so that grid.sync() is legal.  Returns the first CUDA error.
template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, size_t smem, void** argv, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(per_sm * sms), dim3(kThreads),
                                    argv, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
