// A measurement probe for tools/attn_phase_probe.py, not part of the kernel
// library: the f32 fused attention step of show_tell_tpu_torch/csrc/
// fused_attn_step.cu (included, so that every phase is that file's own
// device code) with a clock64 stamp at each phase boundary of every block.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -shared -I . tools/attn_phase_probe.cu -o libattn_phase_probe.so
//
// Routes (0 and 1 for both cells and ends, 2-5 for the GRU's argmax end):
//   0  SIMT, one launch: the f32 code the attention steps ran before the
//      3xTF32 tiles (A1 attention_scores_in, A2 attention_context_e; the
//      SIMT layers, the SIMT projection and the dense end's strided stores,
//      which the library no longer keeps, are copied below);
//   1  the library's f32 instance: the attention launch (A1 att2_f32, A2
//      scores_f32 and, after a grid barrier, context_f32), then the step's
//      launch (the 3xTF32 tiles' layers with their K split, the projection);
//   2  route 1 with route 0's A1 (attention_scores_in) in the first launch;
//   3  route 1 with A1 on the 3xTF32 tiles in the first launch: the
//      projection's dense end with W_dec as the vocabulary (64 rows of W_dec
//      x 32 batch rows an item);
//   4  route 1 with A2 a block a row in the first launch (a2_rows_f32 below);
//   5  route 1 in one launch (the attention phases, a grid barrier, the
//      step's phases): the layout whose LSTM instances spilled.
// Stamps: a header of 8 (the blocks of the first and the second launch;
// block 0's %globaltimer in ns at the start and the end of each launch; 0,
// 0), then for every block of the first launch 6: its start, A1 done (a
// block barrier), after the grid barrier, A2's scores done, after the grid
// barrier (routes 0 and 4 have none there: their A2 is one part), A2 done;
// then for every block of the second launch 2L + 2: its start, each layer
// done and after its grid barrier, the projection's end (the argmax end's
// tokens included).  The one-launch routes stamp both parts, the second
// starting after the grid barrier that follows A2.

#include "show_tell_tpu_torch/csrc/fused_attn_step.cu"

namespace {

constexpr int kHeader = 8, kFirst = 6;
constexpr size_t kMaxBlocks = 132 * 16;  // a bound on the cooperative grid: the SM count times 16 resident blocks

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A block's stamps: a clock64 once every thread of the block (and, across_grid, of the grid) is done.
struct Stamps {
  unsigned long long* at;
  int k = 0;
  __device__ void mark(cg::grid_group& grid, bool across_grid) {
    if (across_grid)
      grid.sync();
    else
      __syncthreads();
    if (threadIdx.x == 0) at[k] = clock64();
    ++k;
  }
};

// Route 4's A2: a block a row (attention_context_e's layout) with every lane's loads of up to kBatch positions in
// flight together: warp w scores the positions w, w + 4, ..., lanes over 16-byte chunks of A; warp 0 takes the
// softmax by shuffles; threads over 16-byte chunks of E sum the alpha-weighted feats_e rows.
__device__ void a2_rows_f32(const Params& p, float* smem) {
  const StackArgs& s = p.stack;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = p.E, A = p.A, P = p.P;
  float* att2 = smem;        // [A]
  float* alpha = smem + A;   // [P]: e, then alpha
  const float* wfull = static_cast<const float*>(p.wfull);
  const float* b_emb = static_cast<const float*>(p.b_emb);
  for (int b = blockIdx.x; b < s.B; b += gridDim.x) {
    __syncthreads();  // the previous row is done with att2 and alpha
    for (int a = threadIdx.x * 4; a < A; a += kThreads * 4)  // A % 8 == 0
      *reinterpret_cast<float4*>(att2 + a) =
          __ldcg(reinterpret_cast<const float4*>(p.att2 + static_cast<size_t>(b) * A + a));
    __syncthreads();
    const float* att1 = static_cast<const float*>(p.att1) + static_cast<size_t>(b) * P * A;
    for (int q0 = warp; q0 < P; q0 += kWarps * kBatch) {
      float acc[kBatch] = {};
      for (int k = lane * 4; k < A; k += 32 * 4) {
        float4 u[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = q0 + j * kWarps;
          if (q < P) u[j] = __ldg(reinterpret_cast<const float4*>(att1 + static_cast<size_t>(q) * A + k));
        }
        const float4 w = __ldg(reinterpret_cast<const float4*>(wfull + k));
        const float4 t = *reinterpret_cast<const float4*>(att2 + k);
        const float wv[4] = {w.x, w.y, w.z, w.w}, tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (q0 + j * kWarps < P) {
            const float uv[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = uv[i] + tv[i];
              acc[j] += (v >= 0.0f ? v : 0.2f * v) * wv[i];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float v = warp_sum(acc[j]);
        if (lane == 0 && q0 + j * kWarps < P) alpha[q0 + j * kWarps] = v;
      }
    }
    __syncthreads();
    if (warp == 0) {  // each lane reads and rewrites its own positions
      float m = -INFINITY;
      for (int q = lane; q < P; q += 32) m = fmaxf(m, alpha[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.0f;
      for (int q = lane; q < P; q += 32) sum += expf(alpha[q] - m);
      sum = warp_sum(sum);
      for (int q = lane; q < P; q += 32) alpha[q] = expf(alpha[q] - m) / sum;
    }
    __syncthreads();
    const float* fe = static_cast<const float*>(p.feats_e) + static_cast<size_t>(b) * P * E;
    float* x = static_cast<float*>(const_cast<void*>(s.x)) + static_cast<size_t>(b) * 2 * E;
    const float* w_emb = static_cast<const float*>(p.w_emb) + static_cast<size_t>(b) * E;
    for (int c = threadIdx.x * 4; c < E; c += kThreads * 4) {
      float acc[4] = {};
      for (int q0 = 0; q0 < P; q0 += kBatch) {
        float4 f[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (q0 + j < P) f[j] = __ldg(reinterpret_cast<const float4*>(fe + static_cast<size_t>(q0 + j) * E + c));
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (q0 + j < P) {
            const float a = alpha[q0 + j];
            acc[0] += a * f[j].x, acc[1] += a * f[j].y, acc[2] += a * f[j].z, acc[3] += a * f[j].w;
          }
        }
      }
      const float4 be = __ldg(reinterpret_cast<const float4*>(b_emb + c));
      *reinterpret_cast<float4*>(x + E + c) = make_float4(acc[0] + be.x, acc[1] + be.y, acc[2] + be.z, acc[3] + be.w);
      *reinterpret_cast<float4*>(x + c) = __ldg(reinterpret_cast<const float4*>(w_emb + c));
    }
  }
}

// The first launch's phases (kRoute 0: route 0's, else route 1's with route 2-4's A1 or A2).
template <int kRoute>
__device__ void attention_part(const Params& p, float* smem, cg::grid_group& grid, Stamps& st) {
  const StackArgs& s = p.stack;
  if constexpr (kRoute == 0 || kRoute == 2) {
    attention_scores_in<float>(p, smem);
  } else if constexpr (kRoute == 3) {
    const float* h_last = static_cast<const float*>(s.hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
    mma_vocab_phase<kDense>(h_last, static_cast<const float*>(p.wdec), static_cast<const float*>(p.bdec), s.B, s.H,
                            p.A, VocabOut{nullptr, nullptr, p.att2, {}}, smem, grid);
  } else {
    att2_f32(p, smem);
  }
  st.mark(grid, false);
  st.mark(grid, true);
  constexpr bool kOneA2 = kRoute == 0 || kRoute == 4;
  if constexpr (kRoute == 0)
    attention_context_e<float>(p, smem);
  else if constexpr (kRoute == 4)
    a2_rows_f32(p, smem);
  else
    scores_f32(p);
  st.mark(grid, false);
  st.mark(grid, !kOneA2);
  if constexpr (!kOneA2) context_f32(p, smem);
  st.mark(grid, false);
}

// Route 0's projection, as the SIMT code ran it before the 3xTF32 tiles (the library keeps no SIMT projection):
// (batch tile, column range) items, a warp a column, lane b ending with row b0 + b's logit, handed to a sink.
template <typename T, typename Sink>
__device__ __forceinline__ void simt_project_items(const T* top, const T* wv, const T* bv, int B, int H, int V,
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
struct SimtArgmaxSink {
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

// Route 0's dense end, as the SIMT code stored it before the 3xTF32 tiles (the library keeps no SIMT dense end): lane
// b stores row b's logit at logits[row, v], a warp's 8 stores strided by V.
struct SimtDenseSink {
  float* logits;  // [B, V]
  int V;
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void column(int row, int v, float logit) {
    logits[static_cast<size_t>(row) * V + v] = logit;
  }
  __device__ __forceinline__ void finish(int, int, int, int, int) {}
};

// Route 0's projection: simt_project_items with the argmax or the dense end.
template <int kMode>
__device__ void simt_vocab_phase(const float* top, const float* wv, const float* bv, int B, int H, int V,
                                 const VocabOut& o, float* xs, cg::grid_group& grid) {
  if constexpr (kMode == kArgmax) {
    SimtArgmaxSink sink{o.best};
    simt_project_items<float>(top, wv, bv, B, H, V, Tiling(B, V), xs, sink);
    argmax_tokens(o, B, grid);
  } else {
    SimtDenseSink sink{o.logits, V};
    simt_project_items<float>(top, wv, bv, B, H, V, Tiling(B, V), xs, sink);
  }
}

// Route 0's layers, as the SIMT code ran them before the 3xTF32 tiles (the library keeps no SIMT layer): a warp
// owns a column j, reads its G gate rows as 16-byte lane loads against kBM batch rows held in shared memory, and
// reduces each (row, gate) sum by shuffles; lane b finishes row b.

// Shared memory a block needs for one layer: kBM rows of the wider input plus kBM rows of h.
inline size_t simt_stack_smem_floats(const StackArgs& s) {
  return static_cast<size_t>(kBM) * ((s.I0 > s.H ? s.I0 : s.H) + s.H);
}

// acc[b][A0 + g] += w[g*H + j] . rows[b] for the G gates of column j and the nb rows held in shared memory (width
// floats each).
template <int G, int A0, int NA>
__device__ __forceinline__ void simt_gate_dots(float (&acc)[kBM][NA], const float* w, int width, int H, int j,
                                               const float* rows, int nb) {
  constexpr int N = Vec<float>::N;
  const int lane = threadIdx.x & 31;
  for (int k = lane * N; k < width; k += 32 * N) {
    float wv[G][N];
#pragma unroll
    for (int g = 0; g < G; ++g) Vec<float>::ldg(w + static_cast<size_t>(g * H + j) * width + k, wv[g]);
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

// Layer l over all B rows, split into (batch tile, column range) items.
template <typename Cell>
__device__ void simt_stack_layer(const StackArgs& s, int l, float* smem) {
  constexpr int G = Cell::kGates, NA = Cell::kAcc;
  const Layer<float> y = stack_layer_args<float, Cell>(s, l);
  float* xs = smem;
  float* hsm = smem + static_cast<size_t>(kBM) * (s.I0 > s.H ? s.I0 : s.H);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = y.H;
  Tiling t(y.B, H);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, y.B - b0);
    const int j0 = (item % t.splits) * t.per_split;
    const int j1 = min(H, j0 + t.per_split);
    __syncthreads();  // the previous item is done with the tiles
    load_rows<float>(xs, y.xin, b0, nb, y.I);
    load_rows<float>(hsm, y.hin, b0, nb, H);
    __syncthreads();
    for (int j = j0 + warp; j < j1; j += kWarps) {
      float acc[kBM][NA];
#pragma unroll
      for (int b = 0; b < kBM; ++b)
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[b][a] = 0.0f;
      simt_gate_dots<G, 0>(acc, y.w_ih, y.I, H, j, xs, nb);
      simt_gate_dots<G, Cell::kHidden>(acc, y.w_hh, H, H, j, hsm, nb);
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
      if (lane < nb) Cell::template finish<float>(y, mine, b0 + lane, j, hsm[lane * H + j]);
    }
  }
}

// The second launch's phases: the layers and the projection (kRoute 0: the SIMT code, else the 3xTF32 tiles).
template <typename Cell, int kMode, int kRoute>
__device__ void step_part(const Params& p, float* smem, cg::grid_group& grid, Stamps& st) {
  const StackArgs& s = p.stack;
  for (int l = 0; l < s.L; ++l) {
    if constexpr (kRoute == 0)
      simt_stack_layer<Cell>(s, l, smem);
    else
      mma_stack_layer<float, Cell>(s, l, smem, p.split);
    st.mark(grid, false);
    st.mark(grid, true);
  }
  const float* top = static_cast<const float*>(s.new_hs) + static_cast<size_t>(s.L - 1) * s.B * s.H;
  if constexpr (kRoute == 0)
    simt_vocab_phase<kMode>(top, static_cast<const float*>(p.wv), static_cast<const float*>(p.bv), s.B, s.H, p.V,
                            p.out, smem, grid);
  else
    mma_vocab_phase<kMode>(top, static_cast<const float*>(p.wv), static_cast<const float*>(p.bv), s.B, s.H, p.V,
                           p.out, smem, grid);
  st.mark(grid, false);
}

__device__ __forceinline__ unsigned long long* first_stamps(unsigned long long* stamps) {
  return stamps + kHeader + static_cast<size_t>(blockIdx.x) * kFirst;
}

__device__ __forceinline__ unsigned long long* second_stamps(unsigned long long* stamps, int L) {
  return stamps + kHeader + kMaxBlocks * kFirst + static_cast<size_t>(blockIdx.x) * (2 * L + 2);
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads) probe_attention_kernel(Params p, unsigned long long* stamps) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  Stamps st{first_stamps(stamps)};
  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[0] = gridDim.x, stamps[2] = global_ns();
  st.mark(grid, false);
  attention_part<kRoute>(p, smem, grid, st);
  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[3] = global_ns();
}

// The step's launch (kOne: the whole step, the attention phases first, as one launch).
template <typename Cell, int kMode, int kRoute, bool kOne>
__global__ void __launch_bounds__(kThreads) probe_step_kernel(Params p, unsigned long long* stamps) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  if constexpr (kMode == kArgmax)
    for (int b = grid_thread(); b < p.stack.B; b += grid_threads()) p.out.best[b] = 0ull;
  if constexpr (kOne) {
    Stamps first{first_stamps(stamps)};
    if (threadIdx.x == 0 && blockIdx.x == 0) stamps[0] = gridDim.x, stamps[2] = global_ns();
    first.mark(grid, false);
    attention_part<kRoute == 5 ? 1 : kRoute>(p, smem, grid, first);
    if (threadIdx.x == 0 && blockIdx.x == 0) stamps[3] = global_ns();
    grid.sync();  // x is complete
  }
  Stamps st{second_stamps(stamps, p.stack.L)};
  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[1] = gridDim.x, stamps[4] = global_ns();
  st.mark(grid, false);
  step_part<Cell, kMode, kRoute == 0 ? 0 : 1>(p, smem, grid, st);
  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[5] = global_ns();
}

template <typename Kernel>
cudaError_t launch_probe(Kernel kernel, size_t floats, const Params& p, unsigned long long* stamps,
                         cudaStream_t stream) {
  Params args = p;
  void* argv[] = {&args, &stamps};
  return launch_cooperative(kernel, floats * sizeof(float), argv, stream);
}

template <typename Cell, int kMode, int kRoute>
int probe_launch(const Params& p, unsigned long long* stamps, cudaStream_t stream) {
  if (kRoute != 0 && !split_args_ok(true, p.split, p.stack.B, p.stack.H)) return cudaErrorInvalidValue;
  size_t attn = std::max(attention_smem_floats(p, false), attention_smem_floats(p, true));
  if (kRoute == 3) attn = std::max(attn, kMmaSmemFloats);  // A1's staged tensor-core sums
  if constexpr (kRoute == 0 || kRoute == 5) {
    const size_t stack = kRoute == 0 ? simt_stack_smem_floats(p.stack) : kMmaSmemFloats;
    return launch_probe(probe_step_kernel<Cell, kMode, kRoute, true>, std::max(attn, stack), p, stamps, stream);
  } else {
    const cudaError_t err = launch_probe(probe_attention_kernel<kRoute>, attn, p, stamps, stream);
    if (err != cudaSuccess) return err;
    return launch_probe(probe_step_kernel<Cell, kMode, kRoute, false>, kMmaSmemFloats, p, stamps, stream);
  }
}

template <typename Cell, int kMode>
int probe_route(int route, const Params& p, unsigned long long* stamps, cudaStream_t stream) {
  if (route == 0) return probe_launch<Cell, kMode, 0>(p, stamps, stream);
  if (route == 1) return probe_launch<Cell, kMode, 1>(p, stamps, stream);
  if constexpr (std::is_same<Cell, GruCell>::value && kMode == kArgmax) {
    if (route == 2) return probe_launch<Cell, kMode, 2>(p, stamps, stream);
    if (route == 3) return probe_launch<Cell, kMode, 3>(p, stamps, stream);
    if (route == 4) return probe_launch<Cell, kMode, 4>(p, stamps, stream);
    if (route == 5) return probe_launch<Cell, kMode, 5>(p, stamps, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// f32 only.  The library's arguments of st_fused_attn_lstm_step and _dense_step in one list (cs, new_cs null for the
// GRU; tok and best for the argmax end, logits for the dense end); stamps as above.
extern "C" int st_attn_phase_probe(int route, int lstm, int dense, unsigned long long* stamps, const void* w_emb,
                                   const void* feats_e, const void* att1, const void* wdec, const void* bdec,
                                   const void* wfull, const void* b_emb, const void* w_ih0, const void* w_ihU,
                                   const void* w_hh, const void* b_ih, const void* b_hh, const void* hs,
                                   const void* cs, const void* wv, const void* bv, void* x, float* att2,
                                   void* new_hs, void* new_cs, int32_t* tok, unsigned long long* best, float* logits,
                                   float* partial, unsigned int* arrivals, int L, int B, int E, int H, int A, int P,
                                   int V, int s0, int su, int max_parts, void* stream) {
  const Params p{{x, w_ih0, w_ihU, w_hh, b_ih, b_hh, hs, cs, new_hs, new_cs, L, B, 2 * E, H}, w_emb, feats_e, att1,
                 wdec, bdec, wfull, b_emb, wv, bv, att2, VocabOut{tok, best, logits, {}}, E, A, P, V,
                 SplitK{partial, arrivals, s0, su, max_parts}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lstm)
    return dense ? probe_route<LstmCell, kDense>(route, p, stamps, s)
                 : probe_route<LstmCell, kArgmax>(route, p, stamps, s);
  return dense ? probe_route<GruCell, kDense>(route, p, stamps, s) : probe_route<GruCell, kArgmax>(route, p, stamps, s);
}
