// One greedy decode step of the pooled GRU captioner in one kernel launch:
// the L-layer GRU recurrence, the H x V vocab projection and the first-max
// argmax over the vocabulary.
//
// Replaces show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas.
//
//   x0 = x (layer-0 input, zero-padded to H); for l in 0..L-1:
//     h'_l = GRU(x_l, h_l; w_ih[l], w_hh[l], b_ih[l], b_hh[l]);  x_{l+1} = h'_l
//   tok[b] = lowest v maximising  x_L[b] . wv[v] + bv[v]              (int32)
//
// Gate order r, z, n with double biases; the reset gate multiplies the
// hidden-side affine (W_hn h + b_hn).  Products are summed and the gate
// math is done in f32; h' is cast back to the carry type T (float or bf16).
//
// What bounds it on an H100.  At the serving shapes (L=5, H=512, V=9,956)
// one step reads 5 x 2 x 1536 x 512 recurrence weights plus 9,956 x 512
// projection weights: 26 MB in bf16, which fits the 50 MB L2 cache.  At
// small batches the step is bound by those weight bytes; each weight row
// is read once per batch tile of BM rows, so at large batches it turns
// into an f32 SIMT FMA loop (no tensor cores in this version).  The design:
//   * weights are kept in the torch layout [out, in] so that one output
//     column is one contiguous row of H values.  A warp owns an output
//     column, each lane reads 16 contiguous bytes of it per chunk
//     (fully coalesced 512-byte warp reads), multiplies them with BM batch
//     rows held in shared memory as f32, and the warp reduces by shuffles;
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;  // batch rows per tile (<= 32: lane b finishes row b)

struct Params {
  const void* x;     // [B, H]      layer-0 input, zero-padded from E to H
  const void* w_ih;  // [L, 3H, H]  torch layout; layer 0 zero-padded on the input side
  const void* w_hh;  // [L, 3H, H]
  const void* b_ih;  // [L, 3H]
  const void* b_hh;  // [L, 3H]
  const void* hs;    // [L, B, H]   hidden state in
  const void* wv;    // [V, H]      vocab projection, torch layout
  const void* bv;    // [V]
  void* new_hs;      // [L, B, H]   hidden state out
  int32_t* tok;      // [B]
  unsigned long long* best;  // [B] scratch: packed (value, index) keys
  int L, B, H, V;
};

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
// +0.0f folds -0.0 onto +0.0, which compare equal as floats.
__device__ __forceinline__ unsigned long long pack_key(float v, int idx) {
  unsigned int u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned int>(idx));
}

// Rows [b0, b0 + nb) of src [*, H] into smem [kBM][H] as f32.
template <typename T>
__device__ void load_rows(float* smem, const T* src, int b0, int nb, int H) {
  constexpr int N = Vec<T>::N;
  for (int i = threadIdx.x * N; i < nb * H; i += kThreads * N) {
    Vec<T>::ldcg(src + static_cast<size_t>(b0) * H + i, smem + i);
  }
}

// Splits the work of one phase into (batch tile, column range) items:
// every block gets at least one item while there are columns to go round.
struct Tiling {
  int row_tiles, splits, per_split;
  __device__ Tiling(int B, int cols) {
    row_tiles = (B + kBM - 1) / kBM;
    splits = max(1, static_cast<int>(gridDim.x) / row_tiles);
    splits = min(splits, cols);
    per_split = (cols + splits - 1) / splits;
  }
  __device__ int items() const { return row_tiles * splits; }
};

template <typename T>
__device__ void gru_layer(const Params& p, int l, float* xs, float* hsm) {
  constexpr int N = Vec<T>::N;
  const int B = p.B, H = p.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t LH3 = static_cast<size_t>(3) * H * H;
  const T* w_ih = static_cast<const T*>(p.w_ih) + l * LH3;
  const T* w_hh = static_cast<const T*>(p.w_hh) + l * LH3;
  const T* b_ih = static_cast<const T*>(p.b_ih) + static_cast<size_t>(l) * 3 * H;
  const T* b_hh = static_cast<const T*>(p.b_hh) + static_cast<size_t>(l) * 3 * H;
  const T* xin = l == 0 ? static_cast<const T*>(p.x)
                        : static_cast<const T*>(p.new_hs) + static_cast<size_t>(l - 1) * B * H;
  const T* hin = static_cast<const T*>(p.hs) + static_cast<size_t>(l) * B * H;
  T* hout = static_cast<T*>(p.new_hs) + static_cast<size_t>(l) * B * H;

  Tiling t(B, H);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, B - b0);
    const int j0 = (item % t.splits) * t.per_split;
    const int j1 = min(H, j0 + t.per_split);
    __syncthreads();  // the previous item is done with the tiles
    load_rows<T>(xs, xin, b0, nb, H);
    load_rows<T>(hsm, hin, b0, nb, H);
    __syncthreads();
    for (int j = j0 + warp; j < j1; j += kWarps) {
      float acc[kBM][6];
#pragma unroll
      for (int b = 0; b < kBM; ++b)
#pragma unroll
        for (int g = 0; g < 6; ++g) acc[b][g] = 0.0f;
      for (int k = lane * N; k < H; k += 32 * N) {
        float w[6][N];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          Vec<T>::ldg(w_ih + static_cast<size_t>(g * H + j) * H + k, w[g]);
          Vec<T>::ldg(w_hh + static_cast<size_t>(g * H + j) * H + k, w[3 + g]);
        }
#pragma unroll
        for (int b = 0; b < kBM; ++b) {
          if (b < nb) {
            const float* xr = xs + b * H + k;
            const float* hr = hsm + b * H + k;
#pragma unroll
            for (int i = 0; i < N; ++i) {
              const float xv = xr[i], hv = hr[i];
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                acc[b][g] += w[g][i] * xv;
                acc[b][3 + g] += w[3 + g][i] * hv;
              }
            }
          }
        }
      }
      float mine[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < kBM; ++b) {
        if (b < nb) {
#pragma unroll
          for (int g = 0; g < 6; ++g) {
            const float s = warp_sum(acc[b][g]);
            if (lane == b) mine[g] = s;
          }
        }
      }
      if (lane < nb) {
        const float gx_r = mine[0] + Vec<T>::to_f32(b_ih[j]);
        const float gx_z = mine[1] + Vec<T>::to_f32(b_ih[H + j]);
        const float gx_n = mine[2] + Vec<T>::to_f32(b_ih[2 * H + j]);
        const float gh_r = mine[3] + Vec<T>::to_f32(b_hh[j]);
        const float gh_z = mine[4] + Vec<T>::to_f32(b_hh[H + j]);
        const float gh_n = mine[5] + Vec<T>::to_f32(b_hh[2 * H + j]);
        const float r = sigmoidf(gx_r + gh_r);
        const float z = sigmoidf(gx_z + gh_z);
        const float n = tanhf(gx_n + r * gh_n);
        const float h = hsm[lane * H + j];
        hout[static_cast<size_t>(b0 + lane) * H + j] = Vec<T>::from_f32((1.0f - z) * n + z * h);
      }
    }
  }
}

template <typename T>
__device__ void project_argmax(const Params& p, float* xs) {
  constexpr int N = Vec<T>::N;
  const int B = p.B, H = p.H, V = p.V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* wv = static_cast<const T*>(p.wv);
  const T* bv = static_cast<const T*>(p.bv);
  const T* top = static_cast<const T*>(p.new_hs) + static_cast<size_t>(p.L - 1) * B * H;

  Tiling t(B, V);
  for (int item = blockIdx.x; item < t.items(); item += gridDim.x) {
    const int b0 = (item / t.splits) * kBM;
    const int nb = min(kBM, B - b0);
    const int v0 = (item % t.splits) * t.per_split;
    const int v1 = min(V, v0 + t.per_split);
    __syncthreads();
    load_rows<T>(xs, top, b0, nb, H);
    __syncthreads();
    // Lane b keeps the running first max of row b0 + b over this warp's
    // columns, which it visits in increasing order.
    float best_val = -INFINITY;
    int best_idx = -1;
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
      if (lane < nb) {
        const float logit = mine + Vec<T>::to_f32(bv[v]);
        if (best_idx < 0 || logit > best_val) {
          best_val = logit;
          best_idx = v;
        }
      }
    }
    if (lane < nb && best_idx >= 0) atomicMax(p.best + b0 + lane, pack_key(best_val, best_idx));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_gru_step_kernel(Params p) {
  extern __shared__ float smem[];
  float* xs = smem;              // [kBM][H]
  float* hsm = smem + kBM * p.H;  // [kBM][H]
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gthreads = gridDim.x * kThreads;
  for (int b = gtid; b < p.B; b += gthreads) p.best[b] = 0ull;  // below every packed key
  for (int l = 0; l < p.L; ++l) {
    gru_layer<T>(p, l, xs, hsm);
    grid.sync();  // layer l's h' is complete in new_hs
  }
  project_argmax<T>(p, xs);
  grid.sync();
  for (int b = gtid; b < p.B; b += gthreads) {
    p.tok[b] = static_cast<int32_t>(0xffffffffu - static_cast<unsigned int>(p.best[b] & 0xffffffffull));
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = fused_gru_step_kernel<T>;
  const size_t smem = static_cast<size_t>(2) * kBM * p.H * sizeof(float);
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
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(per_sm * sms), dim3(kThreads),
                                    argv, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success); a hidden
// width whose two [kBM, H] f32 tiles exceed a block's shared memory fails here.
extern "C" int st_fused_gru_step(int dtype, const void* x, const void* w_ih, const void* w_hh,
                                 const void* b_ih, const void* b_hh, const void* hs, const void* wv,
                                 const void* bv, void* new_hs, int32_t* tok, unsigned long long* best,
                                 int L, int B, int H, int V, void* stream) {
  Params p{x, w_ih, w_hh, b_ih, b_hh, hs, wv, bv, new_hs, tok, best, L, B, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
