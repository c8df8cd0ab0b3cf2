// The vocab projection on Hopper's tensor cores, for the standalone
// projection kernels (project_argmax.cu, project_topk.cu), in bf16 and f32:
//   logit[b, v] = top[b] . wv[v] + bv[v]      (f32; top [B, H], wv [V, H], bv [V])
// with two ends: the first-max argmax of each row, and each row's top-K
// keys with its online logsumexp (m, s).
//
// What bounds it on an H100: the V x H weights (9,956 x 512 bf16, 10.2 MB:
// 3.0 us at 3.35 TB/s).  The products are 2 B V H operations: 652 MFLOP at
// B = 64 and 1.96 GFLOP at R = 192, 64 and 192 operations a weight byte,
// both below the card's 295 (989 TFLOP/s over 3.35 TB/s), so the call is
// bytes-bound at those shapes; on mma.sync's tensor-core rate (several
// hundred TFLOP/s) the products take about 1-3 us, inside the byte bound's
// order.  The SIMT projection these kernels replaced converted every weight
// to f32, split K across the lanes of a warp and streamed the weights once
// per 8 batch rows; here:
//
// - Products: mma.sync.m16n8k16 bf16 x bf16 -> f32, vocabulary rows as M
//   and batch rows as N.  Both operands are K-contiguous rows ([V, H] and
//   [B, H]), which are A's row-major and B's column-major layouts, so
//   neither is transposed.  Fragments come from shared memory by ldmatrix;
//   row pitches of an odd number of 16-byte units keep its eight row
//   addresses on distinct banks.  Accumulators are f32 registers.
// - Tiling: a block owns a V-tile of mv rows (a multiple of 16, sized by
//   the caller from the SM count so the tiles fill about one wave; see
//   vocab_tiles in ops/vocab.py) and walks over tiles while there are more
//   than resident blocks.  The V-tile's weights stay in shared memory for
//   all of K, so they are read from device memory once per call, whatever
//   B.  The batch goes by in groups of kGroup = 64 rows, four slabs of 16;
//   each group's K-chunks come through a kStages-deep cp.async ring, and
//   during the first group each chunk brings the matching chunk of the
//   weights with it.  A block has 8 warps: warp w takes slab w % 4 and
//   every other m16 tile of the V-tile (w / 4, w / 4 + 2, ...), so two
//   warps on each scheduler hide each other's ldmatrix and mma latency,
//   and each loads all its fragments of a k16 step before its first mma.
// - Ragged edges are zero-filled by cp.async (source size 0): weight rows
//   at v >= V, batch rows at b >= B and columns from H up to the multiple
//   of 16 the mma needs (H need only be a multiple of 8).  Their products
//   are never read: the ends scan only v < V and b < B.
// - Ends: each group's acc + bias is staged in an f32 tile in shared
//   memory; four neighbouring threads take a batch row, each every fourth
//   of its mv columns in increasing v, so all 256 threads scan at once
//   (a warp per row, scanning rows one after another, left the ends
//   latency-bound).  Argmax: first max per thread, the max over the four
//   packed (logit, ~index) keys, one atomicMax per (tile, row).  Top-K:
//   per-thread TopkLists and (m, s), merged over the four into one part
//   per (tile, row); merge_topk (decode_common.cuh) reduces the parts
//   after a grid barrier.  Both keep the key order of decode_common.cuh:
//   a greater value first, of equal values the lower index.
//
// f32 (TileShape<float>) runs the same V-tiles, ring and ends on the tensor
// cores in split-precision TF32 (3xTF32), the arithmetic of dense_mma.cuh's
// tf32x3_step() instances.  Its weights are 20.4 MB (6.1 us at 3.35 TB/s)
// and its products three TF32 products a multiply-add, 1.96 GFLOP at B = 64
// (4.0 us at 495 TFLOP/s of TF32) and 5.87 at R = 192 (11.9 us).  What
// differs from bf16:
// - Products: mma.sync.m16n8k8 with tf32 operands.  Each f32 fragment value
//   a is split in registers into big = tf32(a) and small = tf32(a - big),
//   both rounded to nearest with ties away (tf32_split_bits: cvt.rna's
//   rounding in two integer operations; cvt.rna.tf32.f32 itself compiles to
//   a longer sequence on sm_90), and each k8 step's three products run from
//   a zeroed partial sum, small_a big_b, big_a small_b, big_a big_b, which
//   is then added to the f32 accumulator by an f32 add (the tensor cores
//   truncate what they accumulate).  One-pass TF32 keeps about 2^-11 of a
//   product and misses the port's f32 bars.  The weights stay f32 in shared
//   memory: a pre-split copy would double them.  A warp's chunk of four k8
//   steps is straight-line code (tf32x3_steps, its tile and n8 tile counts
//   static through a dispatch): every fragment's ldmatrix first, then per
//   step the split and the three products in rounds over the warp's (m16
//   tile, n8 tile) pairs: with runtime tile conditions the loops were
//   branches, predicates and address arithmetic, and one pair's chain of
//   three dependent mma's at a time stalled the warp, whose issue is in
//   order.  The products bound the call at B <= 64 (tools/
//   vocab_tile_probe.py splits it by phase and times variants of this code).
// - Fragments: ldmatrix.x4.b16 on the f32 rows.  An 8x8 b16 matrix is 8
//   rows x 4 floats and lane (g, t) receives float t of row g, which is
//   m16n8k8's tf32 A and B layout, so one ldmatrix.x4 gives a k8 step's A
//   fragment (rows 0-7 and 8-15 of columns k .. k+3, then of k+4 .. k+7) or
//   the B fragments of both n8 tiles, and K runs in its natural order.
// - Shared memory, the key constraint: the weight tile takes twice bf16's
//   bytes, so the ring is 4 stages of 32 floats at a pitch of 36 (144 bytes
//   a row, as bf16's stage) and a weight row H rounded up to 8, plus 4
//   floats (an odd number of 16-byte units): 4 (mv (H + 4) + 4 x 64 x 36)
//   + 4 x 64 (mv + 4) bytes, 223,488 at mv = 80, H = 512, so one block an SM
//   takes the flagship's 125 tiles in one wave.
// - Small batches: a group of at most 32 rows has its one or two slabs
//   taken by all 8 warps (every 8th or every 4th m16 tile each), and a slab
//   with at most 8 real rows skips its second n8 tile: an f32 k8 step issues
//   three mma's where bf16's k16 step issued one.  The sums do not depend on
//   which warp takes a tile: each (m16 tile, n8 tile) is one warp's over all
//   of K, in order.

#pragma once

#include <type_traits>

#include "decode_common.cuh"

namespace {

constexpr int kTileWarps = 8;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kTileRowsMax = 128;              // mv <= this
constexpr int kGroup = 64;                     // batch rows a pass
constexpr int kSlabs = kGroup / 16;            // 16-row slabs of a group: a warp takes one (two n8 tiles)
constexpr int kHalves = kTileWarps / kSlabs;   // warps on a slab, each taking every kHalves-th m16 tile
constexpr int kWarpMT = kTileRowsMax / 16 / kHalves;  // m16 tiles of accumulators a warp
constexpr int kRowThreads = kTileThreads / kGroup;    // threads scanning one staged row in the ends
constexpr size_t kSmemLimit = 232448;          // the 227 KB a block may opt into on Hopper

// The K geometry of each element type (ops/vocab.py TILE_SHAPES holds the same numbers): K rounded up to kAlign (the
// mma's k), kPad elements past it in a weight row (an odd number of 16-byte units in all), kChunk K elements a ring
// stage, kStages ring stages (kStages - 1 chunks in flight), kRingPitch elements a ring row (nine 16-byte units).
template <typename T> struct TileShape;
template <> struct TileShape<__nv_bfloat16> {
  static constexpr int kAlign = 16, kPad = 8, kChunk = 64, kStages = 6, kRingPitch = 72;
};
template <> struct TileShape<float> {
  static constexpr int kAlign = 8, kPad = 4, kChunk = 32, kStages = 4, kRingPitch = 36;
};

// K rounded up to the mma's k.
template <typename T>
__host__ __device__ inline int padded_k(int H) {
  return (H + TileShape<T>::kAlign - 1) / TileShape<T>::kAlign * TileShape<T>::kAlign;
}
// Elements a weight-tile row: padded_k fills an even number of 16-byte units, so + kPad makes an odd number.
template <typename T>
__host__ __device__ inline int tile_pitch(int H) { return padded_k<T>(H) + TileShape<T>::kPad; }
// f32 a staged logit row (one batch row, mv columns): mv + 4 is 4 or 20 mod 32, which keeps both the
// epilogue's stores and the ends' loads on distinct banks.
__host__ __device__ inline int logit_pitch(int mv) { return mv + 4; }

// Dynamic shared memory of one block: the V-tile's weights, the ring, the staged logits.
template <typename T>
inline size_t vocab_tile_smem(int mv, int H) {
  using S = TileShape<T>;
  return sizeof(T) * (static_cast<size_t>(mv) * tile_pitch<T>(H) + static_cast<size_t>(S::kStages) * kGroup *
                                                                         S::kRingPitch) +
         4 * static_cast<size_t>(kGroup) * logit_pitch(mv);
}

template <typename T>
inline bool vocab_tile_ok(int mv, int H) {
  return mv >= 16 && mv <= kTileRowsMax && mv % 16 == 0 && H >= 8 && H % 8 == 0 &&
         vocab_tile_smem<T>(mv, H) <= kSmemLimit;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; 16 zero bytes where !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the (32-bit shared) address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix_x4_at(r, smem_addr(p)); }

// d += a (16x16, row-major) x b (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row-major) x b (8x8, column-major), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The max over the kRowThreads neighbouring lanes that share a staged row (every lane takes part).
__device__ __forceinline__ unsigned long long row_max_key(unsigned long long key) {
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other > key ? other : key;
  }
  return key;
}

// dense_mma.cuh's tf32_split by integer arithmetic: + 0x1000 then clearing the low 13 bits rounds the magnitude to
// nearest with ties away, which is cvt.rna's rounding for every finite f32 (and infinities); cvt.rna.tf32.f32 itself
// compiles to a longer sequence on sm_90 (tools/vocab_tile_probe.py --variant cvt-split: the products 12-25% slower).
__device__ __forceinline__ void tf32_split_bits(uint32_t v, uint32_t& big, uint32_t& small) {
  big = (v + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(__uint_as_float(v) - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d = a x b (m16n8k8, tf32 in, f32 out) summed from zero: the first product of a 3xTF32 partial sum.
__device__ __forceinline__ void mma_tf32_1688_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z), "f"(z), "f"(z), "f"(z));
}

// The f32 tile's products of kSteps k8 steps (kSteps x 8 columns from the ldmatrix rows at b_at and a_at) for a warp
// with kCnt m16 tiles (tile i's rows at a_at + i * a_step) and kNts n8 tiles, into acc[nt][i], in 3xTF32: first
// every fragment's ldmatrix, then for each k8 step the split, each (tile, n8 tile) pair's partial sum in three
// rounds over the pairs (small_a big_b from zero, big_a small_b, big_a big_b), and its f32 add to acc.  Every count is
// static, so the loops are straight-line code.
template <int kCnt, int kNts, int kSteps>
__device__ __forceinline__ void tf32x3_steps(float (&acc)[2][kWarpMT][4], uint32_t b_at, uint32_t a_at,
                                             uint32_t a_step) {
  uint32_t b[kSteps][4], a[kSteps][kCnt][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    ldmatrix_x4_at(b[s], b_at + 32 * s);
#pragma unroll
    for (int i = 0; i < kCnt; ++i) ldmatrix_x4_at(a[s][i], a_at + i * a_step + 32 * s);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    uint32_t bb[4], bs[4], ab[kCnt][4], as[kCnt][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_split_bits(b[s][j], bb[j], bs[j]);
#pragma unroll
    for (int i = 0; i < kCnt; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tf32_split_bits(a[s][i][j], ab[i][j], as[i][j]);
    float d[kCnt][kNts][4];
#pragma unroll
    for (int i = 0; i < kCnt; ++i)
#pragma unroll
      for (int nt = 0; nt < kNts; ++nt) mma_tf32_1688_zero(d[i][nt], as[i], bb[2 * nt], bb[2 * nt + 1]);
#pragma unroll
    for (int i = 0; i < kCnt; ++i)
#pragma unroll
      for (int nt = 0; nt < kNts; ++nt) mma_tf32_1688(d[i][nt], ab[i], bs[2 * nt], bs[2 * nt + 1]);
#pragma unroll
    for (int i = 0; i < kCnt; ++i)
#pragma unroll
      for (int nt = 0; nt < kNts; ++nt) mma_tf32_1688(d[i][nt], ab[i], bb[2 * nt], bb[2 * nt + 1]);
#pragma unroll
    for (int i = 0; i < kCnt; ++i)
#pragma unroll
      for (int nt = 0; nt < kNts; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][i][e] += d[i][nt][e];
  }
}

// tf32x3_steps at the warp's tile count cnt (0 .. kWarpMT) and n8 tile count nts (1, 2).
template <int kSteps>
__device__ __forceinline__ void tf32x3_products(float (&acc)[2][kWarpMT][4], int cnt, int nts, uint32_t b_at,
                                                uint32_t a_at, uint32_t a_step) {
  static_assert(kWarpMT == 4, "the dispatch below covers 1 .. 4 tiles a warp");
  if (nts == 2) {
    switch (cnt) {
      case 1: tf32x3_steps<1, 2, kSteps>(acc, b_at, a_at, a_step); break;
      case 2: tf32x3_steps<2, 2, kSteps>(acc, b_at, a_at, a_step); break;
      case 3: tf32x3_steps<3, 2, kSteps>(acc, b_at, a_at, a_step); break;
      case 4: tf32x3_steps<4, 2, kSteps>(acc, b_at, a_at, a_step); break;
    }
  } else {
    switch (cnt) {
      case 1: tf32x3_steps<1, 1, kSteps>(acc, b_at, a_at, a_step); break;
      case 2: tf32x3_steps<2, 1, kSteps>(acc, b_at, a_at, a_step); break;
      case 3: tf32x3_steps<3, 1, kSteps>(acc, b_at, a_at, a_step); break;
      case 4: tf32x3_steps<4, 1, kSteps>(acc, b_at, a_at, a_step); break;
    }
  }
}

// The points of project_tiles at which every thread calls end.mark(point): a tile's start, a step's chunk landed
// (after the wait and the barrier), its copies issued, its products done, a group's logits staged, its end done.  The
// library's ends ignore them; tools/vocab_tile_probe.cu stamps clock64 there.
enum TileMark { kMarkTile = 0, kMarkLanded = 1, kMarkIssued = 2, kMarkProducts = 3, kMarkStaged = 4, kMarkEnded = 5 };

template <typename T>
struct TileArgs {
  const T* top;     // [B, H]
  const T* wv;      // [V, H]  torch layout
  const T* bv;      // [V]
  int B, H, V, mv;  // mv: V-tile rows, vocab_tile_ok<T>(mv, H)
};

template <typename T>
__device__ __forceinline__ int vocab_tiles(const TileArgs<T>& a) { return (a.V + a.mv - 1) / a.mv; }

// The projection over every (V-tile, batch group) of the block's tiles.
// After each group, a __syncthreads and then end.group(tile, v0, nv, b0,
// nb, logits, pitch) on every thread (and end.mark at each TileMark): logits[r * pitch + m] is
// logit[b0 + r, v0 + m] for r < nb, m < nv, in shared memory until the
// next group's epilogue.
template <typename T, typename End>
__device__ void project_tiles(const TileArgs<T>& a, unsigned char* smem, End& end) {
  using S = TileShape<T>;
  constexpr bool kTf32x3 = std::is_same<T, float>::value;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));         // elements a 16-byte piece: 8 bf16, 4 f32
  constexpr int kPieces = S::kChunk / kVec;                      // 16-byte pieces of a row's chunk
  constexpr int kStep = S::kAlign;                               // K columns an mma step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = padded_k<T>(a.H), wp = tile_pitch<T>(a.H), lp = logit_pitch(a.mv);
  const int n_chunks = (kp + S::kChunk - 1) / S::kChunk;
  const int n_steps = (a.B + kGroup - 1) / kGroup * n_chunks;  // (group, chunk) pairs of a tile
  const int n_mt = a.mv / 16;
  T* ws = reinterpret_cast<T*>(smem);                              // [mv][wp]
  T* ring = ws + static_cast<size_t>(a.mv) * wp;                    // [kStages][kGroup][kRingPitch]
  float* logits = reinterpret_cast<float*>(ring + S::kStages * kGroup * S::kRingPitch);  // [kGroup][lp]
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int lr = lane & 7, lm = lane >> 3;

  for (int tile = blockIdx.x; tile < vocab_tiles(a); tile += gridDim.x) {
    const int v0 = tile * a.mv;
    const int nv = min(a.mv, a.V - v0);
    // Step s's copies, one commit group (empty past the last step): the
    // batch rows of its chunk into ring stage s % kStages and, in the
    // first group, the weight tile's chunk into its place.  Columns from kp
    // on are never read and not copied.
    auto load = [&](int s) {
      if (s < n_steps) {
        const int g = s / n_chunks, k0 = (s % n_chunks) * S::kChunk;
        const int nb = min(kGroup, a.B - g * kGroup);
        const int rows = min(kGroup, (nb + 15) / 16 * 16);  // rows a computing warp reads
        T* st = ring + (s % S::kStages) * kGroup * S::kRingPitch;
        for (int i = threadIdx.x; i < rows * kPieces; i += kTileThreads) {
          const int r = i / kPieces, k = k0 + (i % kPieces) * kVec;
          const bool ok = r < nb && k < a.H;
          if (k < kp)
            cp_async16(st + r * S::kRingPitch + (k - k0),
                       ok ? a.top + static_cast<size_t>(g * kGroup + r) * a.H + k : a.top, ok);
        }
        if (g == 0) {
          for (int i = threadIdx.x; i < a.mv * kPieces; i += kTileThreads) {
            const int r = i / kPieces, k = k0 + (i % kPieces) * kVec;
            const bool ok = r < nv && k < a.H;
            if (k < kp) cp_async16(ws + r * wp + k, ok ? a.wv + static_cast<size_t>(v0 + r) * a.H + k : a.wv, ok);
          }
        }
      }
      cp_async_commit();
    };

    __syncthreads();  // the previous tile is done with shared memory
    end.mark(kMarkTile);
#pragma unroll
    for (int s = 0; s < S::kStages - 1; ++s) load(s);
    float acc[2][kWarpMT][4];
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<S::kStages - 2>();  // step s's group has landed (for this thread's copies)
      __syncthreads();                  // ... for everyone's; stage (s - 1) % kStages is free again
      end.mark(kMarkLanded);
      load(s + S::kStages - 1);
      end.mark(kMarkIssued);
      const int g = s / n_chunks, c = s % n_chunks;
      const int nb = min(kGroup, a.B - g * kGroup);
      // The warp's slab (batch rows n0 .. n0 + 15 of the group) and m16 tiles (half, half + halves, ...): bf16
      // spreads the warps over all four slabs; f32 over the slabs that hold rows (see Small batches above).
      const int slabs = kTf32x3 ? (nb <= 16 ? 1 : nb <= 32 ? 2 : kSlabs) : kSlabs;
      const int n0 = (warp % slabs) * 16, half = warp / slabs, halves = kTileWarps / slabs;
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < kWarpMT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][i][e] = 0.0f;
      }
      if (n0 < nb) {
        const T* st = ring + (s % S::kStages) * kGroup * S::kRingPitch;
        const int k0 = c * S::kChunk, kw = min(S::kChunk, kp - k0);
        if constexpr (kTf32x3) {
          // the warp's m16 tiles mt = half + halves * i for i < cnt, its n8 tiles (one where the second holds no
          // real row), and its ldmatrix rows at the chunk's first column
          const int cnt = half < n_mt ? min(kWarpMT, (n_mt - half + halves - 1) / halves) : 0;
          const int nts = n0 + 8 >= nb ? 1 : 2;
          const uint32_t b_at = smem_addr(st + (n0 + lr + (lm >> 1) * 8) * S::kRingPitch + (lm & 1) * kVec);
          const uint32_t a_at = smem_addr(ws + (half * 16 + lr + (lm & 1) * 8) * wp + k0 + (lm >> 1) * kVec);
          const uint32_t a_step = halves * 16 * wp * sizeof(float);  // bytes from one of the warp's tiles to the next
          if (kw == S::kChunk) {
            tf32x3_products<S::kChunk / kStep>(acc, cnt, nts, b_at, a_at, a_step);
          } else {
            for (int kk = 0; kk < kw; kk += kStep)
              tf32x3_products<1>(acc, cnt, nts, b_at + kk * sizeof(float), a_at + kk * sizeof(float), a_step);
          }
        } else {
          for (int kk = 0; kk < kw; kk += kStep) {
            uint32_t b[4];  // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
            ldmatrix_x4(b, st + (n0 + lr + (lm >> 1) * 8) * S::kRingPitch + kk + (lm & 1) * 8);
            uint32_t af[kWarpMT][4];  // (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
#pragma unroll
            for (int i = 0; i < kWarpMT; ++i) {
              const int mt = half + halves * i;
              if (mt < n_mt) ldmatrix_x4(af[i], ws + (mt * 16 + lr + (lm & 1) * 8) * wp + k0 + kk + (lm >> 1) * 8);
            }
#pragma unroll
            for (int i = 0; i < kWarpMT; ++i) {
              if (half + halves * i < n_mt) {
                mma_bf16_16816(acc[0][i], af[i], b[0], b[1]);
                mma_bf16_16816(acc[1][i], af[i], b[2], b[3]);
              }
            }
          }
        }
      }
      end.mark(kMarkProducts);
      if (c == n_chunks - 1) {
        if (n0 < nb) {  // acc[nt][i][2h + j] = logit[v0 + mt*16 + lane/4 + 8h][b0 + n0 + nt*8 + 2(lane%4) + j]
          const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
          for (int i = 0; i < kWarpMT; ++i) {
            const int mt = half + halves * i;
            if (mt < n_mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int m = mt * 16 + gq + 8 * h;
                const float bias = m < nv ? Vec<T>::to_f32(a.bv[v0 + m]) : 0.0f;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                  for (int j = 0; j < 2; ++j) logits[(n0 + nt * 8 + 2 * tq + j) * lp + m] = acc[nt][i][2 * h + j] + bias;
              }
            }
          }
        }
        __syncthreads();
        end.mark(kMarkStaged);
        end.group(tile, v0, nv, g * kGroup, nb, logits, lp);
        end.mark(kMarkEnded);
      }
    }
  }
}

// Greedy end: best[b] = atomicMax over packed keys; best must start at 0.
struct ArgmaxTileEnd {
  unsigned long long* best;  // [B]
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void group(int, int v0, int nv, int b0, int nb, const float* logits, int lp) {
    const int r = threadIdx.x / kRowThreads, q = threadIdx.x % kRowThreads;
    float val = -INFINITY;
    int idx = -1;
    if (r < nb) {
      const float* row = logits + r * lp;
      for (int m = q; m < nv; m += kRowThreads) {  // increasing m: of equal values the first stays
        const float x = row[m];
        if (idx < 0 || x > val) {
          val = x;
          idx = m;
        }
      }
    }
    const unsigned long long key = row_max_key(idx >= 0 ? pack_key(val, v0 + idx) : 0ull);
    if (r < nb && q == 0) atomicMax(best + b0 + r, key);
  }
};

// Beam's sparse end: part `tile` of row b holds the K greatest keys of the
// V-tile (0 = empty) and its (m, s); merge_topk reads n_parts = tiles.
struct TopkTileEnd {
  TopkArgs a;
  int B;
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void group(int tile, int v0, int nv, int b0, int nb, const float* logits, int lp) {
    const int r = threadIdx.x / kRowThreads, q = threadIdx.x % kRowThreads;
    TopkList list;
    list.clear();
    float m = -INFINITY, s = 0.0f;
    if (r < nb) {
      const float* row = logits + r * lp;
      for (int c = q; c < nv; c += kRowThreads) {
        const float x = row[c];
        m = fmaxf(m, x);
        list.insert(pack_key(x, v0 + c));
      }
      for (int c = q; c < nv; c += kRowThreads) s += expf(row[c] - m);
    }
    float mx = m;
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = s > 0.0f ? s * expf(m - mx) : 0.0f;
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const bool writer = r < nb && q == 0;
    const size_t at = static_cast<size_t>(tile) * B + b0 + r;
    for (int j = 0; j < a.K; ++j) {
      const unsigned long long best = row_max_key(list.keys[0]);
      if (list.keys[0] == best) list.pop();  // keys are unique (0 = empty pops harmlessly)
      if (writer) a.part_keys[at * a.K + j] = best;
    }
    if (writer) a.part_ms[at] = make_float2(mx, sum);
  }
};

// What the C entry points keep per kernel instance and device, so that a
// launch queries nothing: the SM count, and the blocks an SM holds at the
// last shared-memory size (the attribute is raised to the limit once).
struct TileLaunchCache {
  static constexpr int kDevices = 16;
  int sms[kDevices] = {};
  int per_sm[kDevices] = {};
  size_t smem[kDevices] = {};
};

// Launch ``kernel`` (an instance for element type T) cooperatively
// (kTileThreads a block) with one block per V-tile, or as many as can be
// resident if fewer, so that grid.sync() is legal.  Returns the first CUDA
// error.
template <typename T, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, TileLaunchCache& cache, int mv, int H, int tiles, void** argv,
                         cudaStream_t stream) {
  cudaError_t err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  const size_t smem = vocab_tile_smem<T>(mv, H);
  int sms = 0, per_sm = 0;
  const bool cached = device < TileLaunchCache::kDevices;
  if (cached && cache.sms[device] > 0 && cache.smem[device] == smem) {
    sms = cache.sms[device];
    per_sm = cache.per_sm[device];
  } else {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (cached) {
      cache.sms[device] = sms;
      cache.per_sm[device] = per_sm;
      cache.smem[device] = smem;
    }
  }
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kTileThreads), argv, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Grid-stride loop bounds over kTileThreads-thread blocks.
__device__ __forceinline__ int tile_grid_thread() { return blockIdx.x * kTileThreads + threadIdx.x; }
__device__ __forceinline__ int tile_grid_threads() { return gridDim.x * kTileThreads; }

}  // namespace
