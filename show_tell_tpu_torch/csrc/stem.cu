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
// zeros), against 147 KB in and 392 KB (bf16, pooled; f32 784 KB) out: in
// bf16 on the tensor cores' bf16 rate, in f32 as two TF32 products a
// multiply-add on their TF32 rate (0.0305 ms at B = 32).
//
// bf16 (stem_mma_kernel): an implicit GEMM on mma.sync m16n8k16, bf16 in,
// f32 sums.  M is conv positions (an m16 tile is 16 columns of one conv
// row), N the 64 output channels, K the 192 taps.  Every pixel is an
// integer 0..255, exact in bf16, and w is bf16, so each product is exact
// in f32; only the order of the f32 additions differs from the twin's.
// - Grid: one CTA per (image, band of kBandPooled = 2 pooled rows, or
//   kBandConv = 4 conv rows without the pool): 28 CTAs an image, so a
//   single image spreads over 28 SMs.  A pooled band
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
// f32 (stem_tf32_kernel): the same implicit GEMM on mma.sync m16n8k8 with
// tf32 operands, in split precision.  Every pixel is an integer 0..255,
// exact in TF32 (11 significant bits), so A needs no split; each weight is
// split once a CTA into TF32 halves w = hi + lo, rounded to nearest with
// ties away by cvt.rna's rounding in integer arithmetic (tf32_split_bits,
// vocab_mma.cuh), and x w = x hi + x lo: two products a k8 step, not
// 3xTF32's three (x_lo hi is identically zero).  Each product of an 8-bit
// pixel and an 11-bit half is exact in f32; what is left is lo's own
// rounding (at most 2^-22 of w) and the order of the f32 sums.  Both
// products go straight into the running f32 sums (lo first): the 1e-4 bar
// against the twin does not need the 3xTF32 kernels' per-step partial sums
// (tools/stem_precision.py --variant fresh-sums measures both against f64).
// - Grid: one CTA per (image, band, half of the 64 channels): the bf16
//   kernel's 28 bands, each split into two CTAs of 32 channels, so a single
//   image spreads over 56 SMs.  The halves read the same input band.
// - Shared memory (100,608 bytes, two CTAs an SM): the band's 8 s2d rows as
//   f32 in the bf16 kernel's [row][col -2 .. 113][12] layout (44,544 bytes);
//   the CTA's 32 channels of hi and of lo, channel-major [32][192 + 4]
//   (50,176 bytes: w transposed and split during the CTA's one load,
//   neighbouring threads on neighbouring taps); tc; and one exchange row a
//   warp for the column pool.  The f32 column stride is 48 bytes, 16-byte
//   aligned, so A fragments come by ldmatrix.x4 (b16 on the f32 rows: lane
//   (g, t) gets float t of row g, the tf32 fragment layout) in the plain
//   row order, row m = column q0 + m: the eight row addresses of a matrix,
//   48 m bytes apart, fall in distinct 16-byte bank groups.  B fragments
//   come by ldmatrix.x4 from the 784-byte channel rows (49 units), two n8
//   tiles a load, K in its natural order (ldmatrix .trans moves 16-bit
//   elements only).
// - Warps: seven, warp w owning conv columns 16w .. 16w + 15 (one m16 tile)
//   and the CTA's four n8 tiles, for all the band's conv rows at once (five
//   pooled, four without the pool: 80 or 64 f32 sums a thread).  Each k8
//   step loads the hi and lo fragments once (four ldmatrix) for the five
//   rows' A fragments (five ldmatrix) and 40 mma.  ptxas: 124 registers,
//   no stack frame or spill; loading a step's four B fragments before its
//   first mma, or the weights' and the band's global loads together,
//   spilled at 128 registers under __launch_bounds__(224, 2).
// - Epilogue, in registers: + tc, relu; rows pool as maxima over the five
//   rows (band 0's row -1 becomes 0, relu's floor); columns pool across
//   lanes by shuffles (lane g holds columns g and g + 8), column q0 - 1
//   from the previous warp through shared memory.  The even lanes store
//   the pooled columns, 8 bytes a lane, whole 32-byte sectors a warp.
//   No staged row: the f32 output is the max of f32 values, and holding the
//   band's rows in registers leaves the shared memory to two CTAs an SM.

#include "vocab_mma.cuh"  // mma_bf16_16816, ldmatrix_x4 (and decode_common.cuh)

namespace {

constexpr int kS = 112;                      // s2d side, conv1's output side
constexpr int kK = 12;                       // s2d channels
constexpr int kC = 64;                       // output channels
constexpr int kTaps = 16 * kK;               // 192
constexpr int kClasses = 4;                  // row (column) classes of tc: 0, 1, 2..110, 111

__device__ __forceinline__ int pos_class(int p) { return p < 2 ? p : (p == kS - 1 ? 3 : 2); }

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

// ---------------------------------------------------------------- f32: the split-precision TF32 kernel

constexpr int kTfHalves = 2;                        // CTAs of a band: output channels 0..31 and 32..63
constexpr int kTfC = kC / kTfHalves;                // 32 channels a CTA: four n8 tiles
constexpr int kTfNts = kTfC / 8;                    // 4
constexpr int kTfWPitch = kTaps + 4;                // f32 a weight row (one channel, 192 taps): 196, 49 16-byte units
constexpr int kTfPoolRows = 2 * kBandPooled + 1;    // conv rows a pooled band computes: 5
constexpr int kTfExchange = kMmaWarps * 2 * kTfC;   // f32 of the column pool's exchange rows: a warp's two pooled rows
constexpr int kTfSmemFloats = kInRows * kRowPitch + 2 * kTfC * kTfWPitch + kClasses * kClasses * kC + kTfExchange;
constexpr size_t kTfSmemBytes = 4 * static_cast<size_t>(kTfSmemFloats);  // 100,608: two CTAs an SM
static_assert(kTfSmemBytes * 2 + 2048 <= 233472, "two CTAs share an SM's 228 KB");

// The band's s2d rows i0 .. i0 + kInRows - 1 of image b into xs ([row][col + 2][12] f32, as load_band's bf16 rows);
// rows outside the image and the pad columns -2, -1, 112, 113 are zeros.  Four pixels a 32-bit load, all of a
// thread's loads in flight before its first store; four pixels (s2d) or two pairs (RGB) a shared store.
__device__ void load_band_f32(float* xs, const uint8_t* __restrict__ x, int b, int i0, bool rgb) {
  constexpr int kPadUnits = kK / 2;  // 6 float4: the two pad columns on each side of a row
  for (int e = threadIdx.x; e < kInRows * 2 * kPadUnits; e += kMmaThreads) {
    const int r = e / (2 * kPadUnits), c = e % (2 * kPadUnits);
    reinterpret_cast<float4*>(xs + r * kRowPitch)[c < kPadUnits ? c : kRowPitch / 4 - 2 * kPadUnits + c] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  constexpr int kQuads = kS * kK / 4;                   // 336 four-byte loads an s2d row (an RGB row: 168)
  constexpr int kPer = kInRows * kQuads / kMmaThreads;  // 12 a thread
  uint32_t v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads, r = e / kQuads, q = e % kQuads, i = i0 + r;
    const uint8_t* src = rgb ? x + (static_cast<size_t>(b) * 2 * kS + 2 * i + q / (kQuads / 2)) * 2 * kS * 3 +
                                   4 * (q % (kQuads / 2))  // RGB row 2i + di, di = q / 168
                             : x + (static_cast<size_t>(b) * kS + i) * kS * kK + 4 * q;
    v[j] = i >= 0 && i < kS ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
  }
  const auto px = [](uint32_t u, int h) { return static_cast<float>((u >> (8 * h)) & 0xffu); };
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kMmaThreads, r = e / kQuads, q = e % kQuads;
    float* row = xs + r * kRowPitch + 2 * kK;  // column 0
    if (rgb) {  // bytes 4u .. 4u + 3 of RGB row 2i + di: byte e' is column e' / 6, channel di*6 + e' % 6
      const int di = q / (kQuads / 2), u = q % (kQuads / 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e2 = 4 * u + 2 * h;  // an even byte: its pair stays in one column
        *reinterpret_cast<float2*>(row + (e2 / 6) * kK + di * 6 + e2 % 6) =
            make_float2(px(v[j], 2 * h), px(v[j], 2 * h + 1));
      }
    } else {    // byte e' of an s2d row is element e' of the [col][12] row
      *reinterpret_cast<float4*>(row + 4 * q) = make_float4(px(v[j], 0), px(v[j], 1), px(v[j], 2), px(v[j], 3));
    }
  }
}

// The CTA's 32 channels of w [192][64] into wh and wl [32][kTfWPitch], channel-major, as TF32 halves: w = hi + lo
// (tf32_split_bits), each split once a CTA.  Neighbouring threads take neighbouring taps, so a warp's stores fall on
// distinct banks but where its taps wrap past 191; each thread reads 16 bytes of a w row.
__device__ void load_weights_tf32(float* wh, float* wl, const float* __restrict__ w, int half) {
  for (int e = threadIdx.x; e < kTfC / 4 * kTaps; e += kMmaThreads) {
    const int c = e / kTaps, k = e % kTaps;  // channels 4c .. 4c + 3 of the half, tap k
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + k * kC + half * kTfC + 4 * c));
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi, lo;
      tf32_split_bits(__float_as_uint(f[i]), hi, lo);
      wh[(4 * c + i) * kTfWPitch + k] = __uint_as_float(hi);
      wl[(4 * c + i) * kTfWPitch + k] = __uint_as_float(lo);
    }
  }
}

// acc[j] = the conv sums of rows p0 + j (j < kRows; smem input rows j .. j + 3) at this warp's 16 columns, row m of
// the m16 tile being column q0 + m, and the CTA's four n8 tiles of channels.  Each k8 step takes two TF32 products
// into the f32 sums, x lo then x hi: a pixel is exact in TF32, so x w needs no third.  Fragments by ldmatrix.x4 on
// the f32 rows (an 8x8 b16 matrix is 8 rows of 4 floats, and lane (g, t) receives float t of row g, the m16n8k8
// tf32 layout): A as matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7), whose 16-byte row addresses 48 (q0 + m) + 32 s
// (+ 16) bytes fall in distinct bank groups for the eight m; B from the channel-major halves as matrices
// (k 0-3 | 4-7) x (n8 tile 2np | 2np + 1), 784-byte rows.
template <int kRows>
__device__ __forceinline__ void conv_rows_tf32(float (&acc)[kRows][kTfNts][4], const float* xs, const float* wh,
                                               const float* wl, int q0, int lane) {
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int nt = 0; nt < kTfNts; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.0f;
  const uint32_t a_at = smem_addr(xs + (q0 + (lane & 15)) * kK + (lane >> 4) * 4);
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * kTfWPitch + ((lane >> 3) & 1) * 4;
  const uint32_t bh_at = smem_addr(wh + b_off), bl_at = smem_addr(wl + b_off);
#pragma unroll 1
  for (int a = 0; a < 4; ++a) {  // tap row a: six k8 steps, K = 48 a + 8 s .. + 7
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int k = 48 * a + 8 * s;
      uint32_t af[kRows][4];
#pragma unroll
      for (int j = 0; j < kRows; ++j) ldmatrix_x4_at(af[j], a_at + 4 * ((a + j) * kRowPitch + 8 * s));
#pragma unroll
      for (int np = 0; np < kTfNts / 2; ++np) {
        uint32_t bl[4], bh[4];
        ldmatrix_x4_at(bl, bl_at + 4 * (16 * np * kTfWPitch + k));
        ldmatrix_x4_at(bh, bh_at + 4 * (16 * np * kTfWPitch + k));
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_tf32_1688(acc[j][2 * np + h], af[j], bl[2 * h], bl[2 * h + 1]);
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_tf32_1688(acc[j][2 * np + h], af[j], bh[2 * h], bh[2 * h + 1]);
      }
    }
  }
}

// acc[j] = relu(acc[j] + tc[class of row p0 + j][class of the column]) on the CTA's channels; a row above the image
// (p0 + j < 0: band 0's first) becomes 0, the max's identity after relu.  Lane (g, t) holds columns q0 + g
// (e = 0, 1) and q0 + g + 8 (e = 2, 3), channels 8 nt + 2t, + 1 of the half.
template <int kRows>
__device__ __forceinline__ void shift_relu_tf32(float (&acc)[kRows][kTfNts][4], const float* ts, int p0, int q0,
                                                int half, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* tr =
          ts + (pos_class(max(p0 + j, 0)) * kClasses + pos_class(q0 + g + 8 * h)) * kC + half * kTfC + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kTfNts; ++nt) {
        const float2 tv = *reinterpret_cast<const float2*>(tr + 8 * nt);
        acc[j][nt][2 * h] = p0 + j < 0 ? 0.0f : fmaxf(acc[j][nt][2 * h] + tv.x, 0.0f);
        acc[j][nt][2 * h + 1] = p0 + j < 0 ? 0.0f : fmaxf(acc[j][nt][2 * h + 1] + tv.y, 0.0f);
      }
    }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
stem_tf32_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w, const float* __restrict__ tc,
                 float* __restrict__ out, bool rgb, bool pool) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kInRows][kRowPitch]
  float* wh = xs + kInRows * kRowPitch;           // [kTfC][kTfWPitch]: tf32 hi of the CTA's channels, tap-minor
  float* wl = wh + kTfC * kTfWPitch;              // the same, lo
  float* ts = wl + kTfC * kTfWPitch;              // [kClasses][kClasses][kC]
  float* xch = ts + kClasses * kClasses * kC;     // [kMmaWarps][2][kTfC] (kTfExchange): each warp's column 15
  const int b = blockIdx.y, band = blockIdx.x / kTfHalves, half = blockIdx.x % kTfHalves;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q0 = 16 * warp, g = lane >> 2, t = lane & 3;
  // pool: conv rows p0 = 2r0 - 1 .. 2r0 + 3 (row -1 of band 0 computed, then zeroed); no pool: p0 .. p0 + 3
  const int p0 = pool ? 2 * kBandPooled * band - 1 : kBandConv * band;

  for (int e = threadIdx.x; e < kClasses * kClasses * kC / 4; e += kMmaThreads)
    cp_async16(ts + 4 * e, tc + 4 * e, true);
  cp_async_commit();
  load_weights_tf32(wh, wl, w, half);
  load_band_f32(xs, x, b, p0 - 2, rgb);
  cp_async_wait<0>();
  __syncthreads();

  if (!pool) {
    float acc[kBandConv][kTfNts][4];
    conv_rows_tf32<kBandConv>(acc, xs, wh, wl, q0, lane);
    shift_relu_tf32<kBandConv>(acc, ts, p0, q0, half, lane);
#pragma unroll
    for (int j = 0; j < kBandConv; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < kTfNts; ++nt)
          *reinterpret_cast<float2*>(out + ((static_cast<size_t>(b) * kS + p0 + j) * kS + q0 + g + 8 * h) * kC +
                                     half * kTfC + 8 * nt + 2 * t) =
              make_float2(acc[j][nt][2 * h], acc[j][nt][2 * h + 1]);
    return;
  }
  float acc[kTfPoolRows][kTfNts][4];
  conv_rows_tf32<kTfPoolRows>(acc, xs, wh, wl, q0, lane);
  shift_relu_tf32<kTfPoolRows>(acc, ts, p0, q0, half, lane);
  // rows: pooled row 2 band + r is the max of conv rows p0 + 2r .. p0 + 2r + 2
  float v[2][kTfNts][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < kTfNts; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[r][nt][e] = fmaxf(fmaxf(acc[2 * r][nt][e], acc[2 * r + 1][nt][e]), acc[2 * r + 2][nt][e]);
  // columns: pooled column q0 / 2 + g / 2 (even g) is the max of columns q0 + g - 1 .. q0 + g + 1, q0 / 2 + 4 + g / 2
  // that of q0 + g + 7 .. q0 + g + 9; a neighbour column is lane g +- 1's (a shuffle by four lanes), column q0 + 7
  // lane 7's first, and column q0 - 1 the previous warp's column 15, which comes through shared memory
  if (g == 7) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < kTfNts; ++nt)
        *reinterpret_cast<float2*>(xch + (warp * 2 + r) * kTfC + 8 * nt + 2 * t) =
            make_float2(v[r][nt][2], v[r][nt][3]);
  }
  __syncthreads();
  const float* prev = xch + (warp - 1) * 2 * kTfC;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < kTfNts; ++nt) {
      float lo_col[2], hi_col[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float h0 = v[r][nt][c], h1 = v[r][nt][2 + c];
        const int up = (lane + 28) & 31, down = (lane + 4) & 31;  // lanes g - 1 and g + 1 (g = 7 and 0 at the ends)
        const float l0 = __shfl_sync(0xffffffffu, h0, up), l1 = __shfl_sync(0xffffffffu, h1, up);
        const float r0 = __shfl_sync(0xffffffffu, h0, down), r1 = __shfl_sync(0xffffffffu, h1, down);
        const float left0 = g > 0 ? l0 : warp > 0 ? prev[r * kTfC + 8 * nt + 2 * t + c] : 0.0f;
        lo_col[c] = fmaxf(fmaxf(left0, h0), r0);
        hi_col[c] = fmaxf(fmaxf(g > 0 ? l1 : l0, h1), r1);
      }
      if ((g & 1) == 0) {
        float* dst = out + ((static_cast<size_t>(b) * (kS / 2) + 2 * band + r) * (kS / 2) + q0 / 2 + g / 2) * kC +
                     half * kTfC + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(lo_col[0], lo_col[1]);
        *reinterpret_cast<float2*>(dst + 4 * kC) = make_float2(hi_col[0], hi_col[1]);
      }
    }
}

cudaError_t launch_tf32(const uint8_t* x, const float* w, const float* tc, float* out, int B, bool rgb, bool pool,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTfSmemBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_tf32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  stem_tf32_kernel<<<dim3(kMmaBands * kTfHalves, B), kMmaThreads, kTfSmemBytes, stream>>>(x, w, tc, out, rgb, pool);
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

// dtype: 0 = float32 (stem_tf32_kernel), 1 = bfloat16 (stem_mma_kernel), for w and out.
// layout: 0 = s2d [B,112,112,12], 1 = RGB [B,224,224,3].  pool: 1 = [B,56,56,64] out, 0 = [B,112,112,64].
// tc [4, 4, 64] f32.  Returns a cudaError_t (0 on success).
extern "C" int st_stem(int dtype, int layout, int pool, const void* x, const void* w, const void* tc, void* out, int B,
                       void* stream) {
  if (B < 1 || B > 65535 || (layout != 0 && layout != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32(xp, static_cast<const float*>(w), static_cast<const float*>(tc),
                                        static_cast<float*>(out), B, layout == 1, pool != 0, s));
  if (dtype == 1)
    return static_cast<int>(launch_mma(xp, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(tc),
                                       static_cast<__nv_bfloat16*>(out), B, layout == 1, pool != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
