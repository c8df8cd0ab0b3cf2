// The ResNet stem of the space-to-depth serving path, straight from uint8
// pixels: normalize + conv1 + eval-mode BN + relu (+ 3x3/s2 maxpool, pad 1).
//
//   y[p, q, o] = relu( sum_{a, b < 4, k < 12} x[p+a-2, q+b-2, k] * w[(a*4+b)*12 + k, o] + t[p, q, o] )
//   out[r, s, o] = max over p in 2r-1..2r+1, q in 2s-1..2s+1 inside [0, 112) of y[p, q, o]
//
// x is the s2d image [B, 112, 112, 12] (channel k = (di, dj, c)), or the RGB
// image [B, 224, 224, 3] read through x[i, j, (di, dj, c)] = rgb[2i+di,
// 2j+dj, c]; taps outside [0, 112) are zero, so no padded copy is needed.
// w [192, 64] is conv1 as the 4x4/s1 s2d kernel with BN's multiplier and
// the normalize scale 1/(255 std_c) folded in (K order (a, b, di, dj, c),
// ops/stem.py prepare_stem); t [112, 112, 64] f32 carries the normalize
// shift through the convolution, only where a tap lies inside the image
// (conv1 pads after normalization), plus BN's bias.  Which taps fall
// outside depends only on whether a row (column) is 0, 1, 2..110 or 111,
// so t takes 16 distinct 64-vectors: tc [4, 4, 64] holds them (t at rows
// and columns 0, 1, 2, 111).  Output in the compute dtype, NHWC
// [B, 56, 56, 64] (pool) or [B, 112, 112, 64].
//
// Replaces show_tell_tpu/ops/stem_pallas.py::stem_fused_pallas.
//
// What bounds it on an H100: operations, 112 x 112 x 64 x 147 real
// multiply-adds an image (the 192 taps of the s2d form hold 45 structural
// zeros) on the bf16 tensor cores, against 147 KB in and 392 KB (bf16,
// pooled) out.
//
// bf16 (stem_mma_kernel): an implicit GEMM on mma.sync m16n8k16, bf16 in,
// f32 sums.  M is conv positions (an m16 tile is 16 columns of one conv
// row), N the 64 output channels, K the 192 taps.  Every pixel is an
// integer 0..255, exact in bf16, and w is bf16, so the products are the
// ones the SIMT kernel formed; only the order of the f32 additions differs.
// - Grid: one CTA per (image, band of kBandPooled = 2 pooled rows, or
//   kBandConv = 4 conv rows without the pool): 28 CTAs an image, so a
//   single image spreads over 28 SMs (the SIMT kernel: 8).  A pooled band
//   computes conv rows 2r0-1 .. 2r0+3: the first is its neighbour's last
//   too (a fifth of the products computed twice).
// - Shared memory: the band's 8 s2d input rows as bf16, laid out
//   [row][col -2 .. 113][12], so the 48 K values of tap row a at position
//   q (b = 0..3 x 12 channels) are the 48 contiguous values from column
//   q - 2: A[q][a*48 + kk] = row(p + a - 2)[(q + 2 - 2) * 12 + kk].  The
//   column stride is 24 bytes, so an odd column is not 16-byte aligned and
//   ldmatrix cannot address it: A fragments are 32-bit shared loads (the
//   PTX fragment layout read directly, two bf16 a register), which pad
//   nothing and compute no zero taps.  Row m of an m16 tile is column
//   2 (m % 8) + m / 8 of its 16, so the eight rows a load reads are every
//   other column and fall on distinct banks (in order, two of them shared
//   a bank).  The weights sit as they come, [192
//   taps][64 + 8] (144-byte rows, nine 16-byte units: ldmatrix's eight row
//   addresses fall on distinct banks), copied once a CTA by cp.async;
//   B fragments come by ldmatrix.x4.trans, two n8 tiles a load (a
//   transposed copy, stored a bf16 at a time, would put 16 of a warp's
//   stores on one bank).  tc sits there as f32.
// - Warps: seven, warp w owning conv columns 16w .. 16w + 15 of every row,
//   all 64 channels (eight n8 tiles, 32 f32 sums a row); each k16 step
//   feeds one B fragment load to two conv rows (a pooled row's pair 2r,
//   2r+1), so the weights are read from shared memory once per two rows.
// - Epilogue: + tc of the position's (row class, column class), relu; rows
//   pool as they pass: the pair 2r, 2r+1 closes pooled row r with the open
//   row 2r-1, and row 2r+1 opens r+1.  Rows wait in shared memory as bf16
//   (rounding is monotone, so the max of rounded values is the rounded
//   max): the open row in a row of its own, which each thread reads back
//   where it wrote (32 registers fewer: ptxas spilled with it held in
//   registers), the closed row where the columns pool across it, 16 bytes
//   a thread.  Only pooled rows reach device memory.  Relu makes every
//   value >= 0 and every window holds at least one in-image value, so 0
//   stands in for the pool's -inf padding.
//
// f32 (stem_simt_kernel, the parity dtype, on the SIMT units; the tensor
// cores would take f32 as TF32): one CTA per (image, band of 7 pooled rows,
// or 14 conv rows without the pool), 224 threads, each owning 4 adjacent
// conv columns x 8 output channels (32 f32 accumulators).  The CTA walks
// its band's conv rows in order; the 4 s2d input rows a conv row reads sit
// in a ring in shared memory as f32 (one row enters per conv row), and the
// folded weights sit there as f32 for the whole band.  Rows pool in
// registers as they pass; columns pool across threads through one
// shared-memory row of each thread's last column.  Both kernels read tc.

#include "vocab_mma.cuh"  // mma_bf16_16816, ldmatrix_x4 (and decode_common.cuh)

namespace {

constexpr int kS = 112;                      // s2d side, conv1's output side
constexpr int kK = 12;                       // s2d channels
constexpr int kC = 64;                       // output channels
constexpr int kTaps = 16 * kK;               // 192
constexpr int kClasses = 4;                  // row (column) classes of tc: 0, 1, 2..110, 111

__device__ __forceinline__ int pos_class(int p) { return p < 2 ? p : (p == kS - 1 ? 3 : 2); }

// ---------------------------------------------------------------- f32: the SIMT kernel

constexpr int kPitch = kS + 4;               // a smem input row holds cols -2 .. 113 (zeros outside)
constexpr int kSlot = kK * kPitch;           // one s2d row, [k][col]
constexpr int kGroups = kS / 4;              // 28 groups of 4 conv columns
constexpr int kSimtThreads = kGroups * 8;    // x 8 channel groups = 224
constexpr int kBands = 8;                    // CTAs an image
constexpr int kPoolRows = kS / 2 / kBands;   // 7 pooled rows a band
constexpr int kConvRows = kS / kBands;       // 14 conv rows a band without the pool
constexpr int kSmemFloats = 4 * kSlot + kTaps * kC + kGroups * kC;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 78,592

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }

// 4 consecutive channels out, as one 16-byte store.
__device__ __forceinline__ void store4(float* out, const float* v) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

// s2d row i of image b into ring slot `dst` ([k][col + 2]); rows outside the image are zeros.
__device__ __forceinline__ void load_row(float* dst, const uint8_t* __restrict__ x, int b, int i, bool rgb) {
  if (i < 0 || i >= kS) {
    for (int e = threadIdx.x; e < kS * kK; e += kSimtThreads) dst[(e / kS) * kPitch + e % kS + 2] = 0.f;
    return;
  }
  if (rgb) {  // rgb rows 2i (di = 0) and 2i+1 (di = 1): byte e of a row is col e / 6, (dj, c) = e % 6
    const uint8_t* src = x + (static_cast<size_t>(b) * 2 * kS + 2 * i) * 2 * kS * 3;
    for (int e = threadIdx.x; e < 2 * 6 * kS; e += kSimtThreads) {
      const int di = e / (6 * kS), r = e % (6 * kS);
      dst[(di * 6 + r % 6) * kPitch + r / 6 + 2] = static_cast<float>(src[e]);
    }
  } else {    // byte e of an s2d row is col e / 12, channel e % 12
    const uint8_t* src = x + (static_cast<size_t>(b) * kS + i) * kS * kK;
    for (int e = threadIdx.x; e < kS * kK; e += kSimtThreads) dst[(e % kK) * kPitch + e / kK + 2] = static_cast<float>(src[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads, 2)
stem_simt_kernel(const uint8_t* __restrict__ x, const T* __restrict__ w, const float* __restrict__ tc,
                 T* __restrict__ out, bool rgb, bool pool) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4 slots][kK][kPitch]
  float* ws = xs + 4 * kSlot;                    // [kTaps][kC]
  float* xch = ws + kTaps * kC;                  // [kGroups][kC]: each group's last column, for the column pool

  const int b = blockIdx.y;
  const int g = threadIdx.x >> 3, cg = threadIdx.x & 7;  // columns 4g..4g+3; channels cg*4 + {0..3} and 32 + cg*4 + {0..3}
  int p_begin, p_end;
  if (pool) {
    const int r0 = blockIdx.x * kPoolRows;
    p_begin = r0 > 0 ? 2 * r0 - 1 : 0;
    p_end = 2 * (r0 + kPoolRows);
  } else {
    p_begin = blockIdx.x * kConvRows;
    p_end = p_begin + kConvRows;
  }

  for (int e = threadIdx.x; e < kTaps * kC; e += kSimtThreads) ws[e] = to_f32(w[e]);
  for (int e = threadIdx.x; e < 4 * kK * 4; e += kSimtThreads) {  // the pad columns -2, -1, 112, 113 of every slot row
    const int c = e & 3;
    xs[(e >> 2) * kPitch + (c < 2 ? c : kS + c)] = 0.f;
  }
  for (int i = p_begin - 2; i <= p_begin + 1; ++i) load_row(xs + (i & 3) * kSlot, x, b, i, rgb);
  __syncthreads();

  float cur[4][8];  // the running max over the pooled row's window rows
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 8; ++o) cur[j][o] = 0.f;

  for (int p = p_begin; p < p_end; ++p) {
    if (p > p_begin) {
      __syncthreads();  // every thread is done with row p-3's slot
      load_row(xs + ((p + 1) & 3) * kSlot, x, b, p + 1, rgb);
      __syncthreads();
    }
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = 0.f;
#pragma unroll 1
    for (int a = 0; a < 4; ++a) {
      const float* xrow = xs + ((p + a - 2) & 3) * kSlot + 4 * g;  // cols 4g-2 .. 4g+4 at offsets 0..6
      const float* wa = ws + a * 4 * kK * kC + cg * 4;
#pragma unroll 2
      for (int k = 0; k < kK; ++k) {
        const float4 x0 = *reinterpret_cast<const float4*>(xrow + k * kPitch);
        const float2 x1 = *reinterpret_cast<const float2*>(xrow + k * kPitch + 4);
        const float xv[7] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, xrow[k * kPitch + 6]};
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float* wr = wa + (bb * kK + k) * kC;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[j][o] = fmaf(xv[j + bb], wv[o], acc[j][o]);
        }
      }
    }
    // + tc of the position's (row class, column class), relu
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* tr = tc + (pos_class(p) * kClasses + pos_class(4 * g + j)) * kC + cg * 4;
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(tr));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(tr + 32));
      const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = fmaxf(acc[j][o] + tv[o], 0.f);
    }
    if (!pool) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T* dst = out + ((static_cast<size_t>(b) * kS + p) * kS + 4 * g + j) * kC + cg * 4;
        store4(dst, acc[j]);
        store4(dst + 32, acc[j] + 4);
      }
      continue;
    }
    const bool closes = (p & 1) && p > p_begin;  // conv row 2r+1 closes pooled row r (and opens r+1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) cur[j][o] = (p & 1) && !closes ? acc[j][o] : fmaxf(cur[j][o], acc[j][o]);
    if (!closes) continue;
    const int r = (p - 1) / 2;
#pragma unroll
    for (int o = 0; o < 8; ++o) xch[g * kC + (o >> 2) * 32 + cg * 4 + (o & 3)] = cur[3][o];
    __syncthreads();
    float pooled[2][8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float left = g > 0 ? xch[(g - 1) * kC + (o >> 2) * 32 + cg * 4 + (o & 3)] : 0.f;  // column 4g-1
      pooled[0][o] = fmaxf(left, fmaxf(cur[0][o], cur[1][o]));
      pooled[1][o] = fmaxf(cur[1][o], fmaxf(cur[2][o], cur[3][o]));
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      T* dst = out + ((static_cast<size_t>(b) * (kS / 2) + r) * (kS / 2) + 2 * g + s) * kC + cg * 4;
      store4(dst, pooled[s]);
      store4(dst + 32, pooled[s] + 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) cur[j][o] = acc[j][o];  // row 2r+1 opens pooled row r+1
  }
}


// ---------------------------------------------------------------- bf16: the tensor-core kernel

constexpr int kMmaWarps = kS / 16;               // 7: an m16 tile of 16 conv columns each
constexpr int kMmaThreads = 32 * kMmaWarps;      // 224
constexpr int kBandPooled = 2;                   // pooled rows a CTA (pool)
constexpr int kBandConv = 4;                     // conv rows a CTA (no pool)
constexpr int kMmaBands = kS / 2 / kBandPooled;  // 28 CTAs an image, = kS / kBandConv
constexpr int kInRows = 2 * kBandPooled + 4;     // s2d rows a band reads: 2r0-3 .. 2r0+4 (no pool: p0-2 .. p0+4)
constexpr int kRowPitch = (kS + 4) * kK;         // bf16 an input row: columns -2 .. 113, 12 channels each
constexpr int kWPitch = kC + 8;                  // bf16 a weight row (one tap, 64 channels): 144 bytes
constexpr int kStagePitch = kC + 8;              // bf16 a staged position: 144 bytes
constexpr size_t kMmaSmemBytes =
    2 * (static_cast<size_t>(kInRows) * kRowPitch + kTaps * kWPitch + 2 * kS * kStagePitch) +
    4 * kClasses * kClasses * kC;  // 86,272
static_assert(kMmaBands * kBandConv == kS, "the pooled and the unpooled grid have the same bands");

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two pixels -> two bf16 (integers 0..255, exact).
__device__ __forceinline__ uint32_t u8x2(uint32_t v) {
  return bf16x2(static_cast<float>(v & 0xffu), static_cast<float>((v >> 8) & 0xffu));
}

// The band's s2d rows i0 .. i0 + kInRows - 1 of image b into xs ([row][col + 2][12] bf16); rows outside the
// image and the pad columns -2, -1, 112, 113 are zeros.  Four pixels a 32-bit load, all of a thread's loads in
// flight before its first store; two pixels a 32-bit store.
__device__ void load_band(__nv_bfloat16* xs, const uint8_t* __restrict__ x, int b, int i0, bool rgb) {
  uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
  constexpr int kRowWords = kRowPitch / 2, kPadWords = kK;  // 696 words a row; 12 words = 2 columns of each pad
  for (int e = threadIdx.x; e < kInRows * 2 * kPadWords; e += kMmaThreads) {
    const int r = e / (2 * kPadWords), c = e % (2 * kPadWords);
    xw[r * kRowWords + (c < kPadWords ? c : kRowWords - 2 * kPadWords + c)] = 0u;
  }
  constexpr int kQuads = kS * kK / 4;                     // 336 four-byte loads an s2d row (an RGB row: 168)
  constexpr int kPer = kInRows * kQuads / kMmaThreads;    // 12 a thread
  static_assert(kPer * kMmaThreads == kInRows * kQuads, "the band's loads divide evenly over the threads");
  uint32_t v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads, r = e / kQuads, q = e % kQuads, i = i0 + r;
    const uint8_t* src = rgb ? x + (static_cast<size_t>(b) * 2 * kS + 2 * i + q / (kQuads / 2)) * 2 * kS * 3 +
                                   4 * (q % (kQuads / 2))  // RGB row 2i + di, di = q / 168
                             : x + (static_cast<size_t>(b) * kS + i) * kS * kK + 4 * q;
    v[j] = i >= 0 && i < kS ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads, r = e / kQuads, q = e % kQuads;
    uint32_t* row = xw + r * kRowWords + kPadWords;  // column 0
    if (rgb) {  // bytes 4u .. 4u + 3 of RGB row 2i + di: byte e' is column e' / 6, channel di*6 + e' % 6
      const int di = q / (kQuads / 2), u = q % (kQuads / 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e2 = 4 * u + 2 * h;  // an even byte: its pair stays in one column
        row[((e2 / 6) * kK + di * 6 + e2 % 6) / 2] = u8x2(v[j] >> (16 * h));
      }
    } else {    // byte e' of an s2d row is element e' of the [col][12] row
      row[2 * q] = u8x2(v[j]);
      row[2 * q + 1] = u8x2(v[j] >> 16);
    }
  }
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the address of row l % 8 of matrix l / 8 and
// gets, of matrix j, M[2t][g] and M[2t + 1][g] in register j (g = l / 4, t = l % 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc[j] = the conv sums of rows p + j (j < kRows) at this warp's 16 columns, all 64 channels.  Row m of an m16
// tile is column q0 + 2 (m % 8) + m / 8, so lane (g, t)'s accumulator e of n8 tile nt is column q0 + 2g + e / 2,
// channel 8 nt + 2t + e % 2: its A rows g and g + 8 are the neighbouring columns 2g and 2g + 1, whose 32-bit loads
// (word 6 column + t) fall on distinct banks for the eight g (columns g and g + 8 put g = 0 and 5 on one bank).
template <int kRows>
__device__ __forceinline__ void conv_rows(float (&acc)[2][8][4], const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                          int p, int i0, int q0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.0f;
  // ldmatrix.trans: lane l addresses row (tap) l % 8 of matrix l / 8 = (k half 0 / 1, n8 tile +0 / +1)
  const __nv_bfloat16* wl = ws + (((lane >> 3) & 1) * 8 + (lane & 7)) * kWPitch + (lane >> 4) * 8;
#pragma unroll 1
  for (int a = 0; a < 4; ++a) {  // tap row a: three k16 steps, K = 48 a + 16 s .. + 15
    const __nv_bfloat16* xr = xs + (p + a - 2 - i0) * kRowPitch + (q0 + 2 * g) * kK + 2 * t;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      uint32_t af[2][4];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const __nv_bfloat16* r = xr + j * kRowPitch + 16 * s;
        af[j][0] = *reinterpret_cast<const uint32_t*>(r);           // row g (column 2g),    k 2t, 2t+1
        af[j][1] = *reinterpret_cast<const uint32_t*>(r + kK);      // row g + 8 (2g + 1)
        af[j][2] = *reinterpret_cast<const uint32_t*>(r + 8);       // row g,                k 2t + 8, 2t + 9
        af[j][3] = *reinterpret_cast<const uint32_t*>(r + kK + 8);  // row g + 8
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n8 tiles 2np, 2np + 1
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, wl + (48 * a + 16 * s) * kWPitch + 16 * np);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          mma_bf16_16816(acc[j][2 * np], af[j], bf[0], bf[1]);
          mma_bf16_16816(acc[j][2 * np + 1], af[j], bf[2], bf[3]);
        }
      }
    }
  }
}

// acc[j] = relu(acc[j] + tc[class of row p + j][class of the column]).
template <int kRows>
__device__ __forceinline__ void shift_relu(float (&acc)[2][8][4], const float* ts, int p, int q0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* tr = ts + (pos_class(p + j) * kClasses + pos_class(q0 + 2 * g + h)) * kC + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 tv = *reinterpret_cast<const float2*>(tr + 8 * nt);
        acc[j][nt][2 * h] = fmaxf(acc[j][nt][2 * h] + tv.x, 0.0f);
        acc[j][nt][2 * h + 1] = fmaxf(acc[j][nt][2 * h + 1] + tv.y, 0.0f);
      }
    }
}

// A row of sums in the accumulator layout into a staged row st [kS][kStagePitch] as bf16.
__device__ __forceinline__ void stage_row(__nv_bfloat16* st, const float (&v)[8][4], int q0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t* sw = reinterpret_cast<uint32_t*>(st);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      sw[((q0 + 2 * g + h) * kStagePitch + 8 * nt + 2 * t) / 2] = bf16x2(v[nt][2 * h], v[nt][2 * h + 1]);
}

// v = max(v, the bf16 values at the same places of the staged row st), in f32.
__device__ __forceinline__ void max_staged(float (&v)[8][4], const __nv_bfloat16* st, int q0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 o = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(st + (q0 + 2 * g + h) * kStagePitch + 8 * nt + 2 * t));
      v[nt][2 * h] = fmaxf(v[nt][2 * h], o.x);
      v[nt][2 * h + 1] = fmaxf(v[nt][2 * h + 1], o.y);
    }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
stem_mma_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w, const float* __restrict__ tc,
                __nv_bfloat16* __restrict__ out, bool rgb, bool pool) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kInRows][kRowPitch]
  __nv_bfloat16* ws = xs + kInRows * kRowPitch;                  // [kTaps][kWPitch]: w
  __nv_bfloat16* st = ws + kTaps * kWPitch;                      // [2][kS][kStagePitch]: staged rows
  float* ts = reinterpret_cast<float*>(st + 2 * kS * kStagePitch);  // [kClasses][kClasses][kC]
  const int b = blockIdx.y, lane = threadIdx.x & 31, q0 = 16 * (threadIdx.x >> 5);
  // pool: conv rows p0 = 2r0 - 1 (none for r0 = 0) .. 2r0 + 3; no pool: p0 .. p0 + 3
  const int p0 = pool ? 2 * kBandPooled * blockIdx.x - 1 : kBandConv * blockIdx.x, i0 = p0 - 2;

  for (int e = threadIdx.x; e < kTaps * kC / 8; e += kMmaThreads)  // w row k, channels 8c .. 8c + 7
    cp_async16(ws + e / (kC / 8) * kWPitch + e % (kC / 8) * 8, w + 8 * e, true);
  for (int e = threadIdx.x; e < kClasses * kClasses * kC / 4; e += kMmaThreads) cp_async16(ts + 4 * e, tc + 4 * e, true);
  cp_async_commit();
  load_band(xs, x, b, i0, rgb);
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][8][4];
  if (!pool) {
    for (int p = p0; p < p0 + kBandConv; p += 2) {
      conv_rows<2>(acc, xs, ws, p, i0, q0, lane);
      shift_relu<2>(acc, ts, p, q0, lane);
      stage_row(st, acc[0], q0, lane);
      stage_row(st + kS * kStagePitch, acc[1], q0, lane);
      __syncthreads();
      for (int e = threadIdx.x; e < 2 * kS * kC / 8; e += kMmaThreads) {  // (row, column, 8 channels)
        const int j = e / (kS * kC / 8), q = e / (kC / 8) % kS, c = e % (kC / 8);
        *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * kS + p + j) * kS + q) * kC + 8 * c) =
            *reinterpret_cast<const uint4*>(st + (j * kS + q) * kStagePitch + 8 * c);
      }
      __syncthreads();  // the stores are done with st
    }
    return;
  }
  // The open pooled row's running max (rows 2r - 1 ..) waits between pairs in the second staged row, as bf16 (the
  // max of rounded values is the rounded max): each thread reads back only what it wrote there.
  __nv_bfloat16* open = st + kS * kStagePitch;
  if (p0 >= 0) {
    conv_rows<1>(acc, xs, ws, p0, i0, q0, lane);
    shift_relu<1>(acc, ts, p0, q0, lane);
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.0f;  // relu makes 0 the max's identity
  }
  stage_row(open, acc[0], q0, lane);
  for (int r = 0; r < kBandPooled; ++r) {
    const int p = p0 + 1 + 2 * r;  // the pair 2r', 2r' + 1 of pooled row r' = kBandPooled blockIdx.x + r
    conv_rows<2>(acc, xs, ws, p, i0, q0, lane);
    shift_relu<2>(acc, ts, p, q0, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] = fmaxf(acc[0][nt][e], acc[1][nt][e]);
    max_staged(acc[0], open, q0, lane);
    stage_row(st, acc[0], q0, lane);
    stage_row(open, acc[1], q0, lane);  // row 2r' + 1 opens pooled row r' + 1
    __syncthreads();
    const int pr = kBandPooled * blockIdx.x + r;
    for (int e = threadIdx.x; e < kS / 2 * kC / 8; e += kMmaThreads) {  // (pooled column s, 8 channels)
      const int s = e / (kC / 8), c = e % (kC / 8);
      const __nv_bfloat16* col = st + 2 * s * kStagePitch + 8 * c;
      uint4 m = *reinterpret_cast<const uint4*>(col), n = *reinterpret_cast<const uint4*>(col + kStagePitch);
      __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
      const __nv_bfloat162* nh = reinterpret_cast<const __nv_bfloat162*>(&n);
#pragma unroll
      for (int j = 0; j < 4; ++j) mh[j] = __hmax2(mh[j], nh[j]);
      if (s > 0) {  // column 2s - 1
        n = *reinterpret_cast<const uint4*>(col - kStagePitch);
#pragma unroll
        for (int j = 0; j < 4; ++j) mh[j] = __hmax2(mh[j], nh[j]);
      }
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * (kS / 2) + pr) * (kS / 2) + s) * kC + 8 * c) = m;
    }
    __syncthreads();  // the pool is done with st
  }
}

cudaError_t launch_simt(const uint8_t* x, const float* w, const float* tc, float* out, int B, bool rgb, bool pool,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_simt_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  stem_simt_kernel<float><<<dim3(kBands, B), kSimtThreads, kSmemBytes, stream>>>(x, w, tc, out, rgb, pool);
  return cudaGetLastError();
}

cudaError_t launch_mma(const uint8_t* x, const __nv_bfloat16* w, const float* tc, __nv_bfloat16* out, int B, bool rgb,
                       bool pool, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return err;
  stem_mma_kernel<<<dim3(kMmaBands, B), kMmaThreads, kMmaSmemBytes, stream>>>(x, w, tc, out, rgb, pool);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core kernel), for w and out.
// layout: 0 = s2d [B,112,112,12], 1 = RGB [B,224,224,3].  pool: 1 = [B,56,56,64] out, 0 = [B,112,112,64].
// tc [4, 4, 64] f32.  Returns a cudaError_t (0 on success).
extern "C" int st_stem(int dtype, int layout, int pool, const void* x, const void* w, const void* tc, void* out, int B,
                       void* stream) {
  if (B < 1 || B > 65535 || (layout != 0 && layout != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_simt(xp, static_cast<const float*>(w), static_cast<const float*>(tc),
                                        static_cast<float*>(out), B, layout == 1, pool != 0, s));
  if (dtype == 1)
    return static_cast<int>(launch_mma(xp, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(tc),
                                       static_cast<__nv_bfloat16*>(out), B, layout == 1, pool != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
