// fastimage: native JPEG decode + antialiased bilinear resize for the
// host input pipeline.
//
// TPU-native replacement for the reference's PIL decode + torchvision
// Resize (reference utils.py:45,84): the host side of the input pipeline
// must sustain thousands of JPEG decodes/sec to feed the chip
// (SURVEY.md §7 "input pipeline throughput"), which Python-side PIL
// cannot do on few cores.  Decode uses libjpeg; the resize implements
// PIL's triangle (bilinear-with-antialias) resampling so host pixels
// match the parity path closely.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).
//
// Build: see build.py (g++ -O3 -shared -fPIC fastimage.cpp -ljpeg -lpthread).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB8. Returns 0 on success.
//
// When min_h/min_w are positive, uses libjpeg's DCT-domain scaled decode
// (scale_num/scale_denom): the IDCT itself produces the smallest supported
// reduction whose output still covers (min_h, min_w), so a 640x480 source
// headed for 224x224 is decoded at 1/2 scale — a fraction of the IDCT and
// color-conversion work, and 4x fewer pixels through the resize.  This is
// the same mechanism as PIL's Image.draft() fast path.  libjpeg-turbo
// supports M/8 scales (M=1..8 used here); a plain libjpeg rounds the
// request up to its nearest supported power-of-two scale, and the resize
// below consumes whatever dimensions the library actually produced.
int decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
               int* width, int* height, int min_h = 0, int min_w = 0) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK converted like PIL's .convert('RGB')
  if (min_h > 0 && min_w > 0) {
    unsigned m = 8;  // full scale unless a reduction still covers the target
    for (unsigned cand = 1; cand < 8; ++cand) {
      const unsigned sw = (cinfo.image_width * cand + 7) / 8;
      const unsigned sh = (cinfo.image_height * cand + 7) / 8;
      if (int(sw) >= min_w && int(sh) >= min_h) {
        m = cand;
        break;
      }
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  out->resize(size_t(*width) * *height * 3);
  const size_t stride = size_t(*width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// PIL-style triangle-filter resampling coefficients for one axis.
struct AxisCoeffs {
  std::vector<int> bounds_lo;     // first source index per output pixel
  std::vector<int> counts;        // taps per output pixel
  std::vector<double> weights;    // taps (normalized), max_taps per pixel
  int max_taps = 0;
};

AxisCoeffs compute_coeffs(int in_size, int out_size) {
  AxisCoeffs c;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle filter support
  c.max_taps = int(std::ceil(support)) * 2 + 1;
  c.bounds_lo.resize(out_size);
  c.counts.resize(out_size);
  c.weights.assign(size_t(out_size) * c.max_taps, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int lo = int(center - support + 0.5);
    int hi = int(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    double* w = &c.weights[size_t(xx) * c.max_taps];
    double total = 0.0;
    for (int x = lo; x < hi; ++x) {
      double t = (x - center + 0.5) / filterscale;
      double val = (t < 0 ? 1.0 + t : 1.0 - t);
      if (val < 0) val = 0;
      w[x - lo] = val;
      total += val;
    }
    if (total != 0.0)
      for (int i = 0; i < hi - lo; ++i) w[i] /= total;
    c.bounds_lo[xx] = lo;
    c.counts[xx] = hi - lo;
  }
  return c;
}

inline uint8_t clamp8(double v) {
  return uint8_t(std::min(255.0, std::max(0.0, v + 0.5)));
}

// Resize RGB8 (h_in x w_in) -> (h_out x w_out), horizontal then vertical.
void resize_rgb(const uint8_t* in, int w_in, int h_in, uint8_t* out, int w_out,
                int h_out) {
  AxisCoeffs cx = compute_coeffs(w_in, w_out);
  AxisCoeffs cy = compute_coeffs(h_in, h_out);

  // Horizontal pass into a float intermediate (PIL uses 8-bit rounding per
  // pass; float keeps us within ~1 LSB of PIL).
  std::vector<float> tmp(size_t(h_in) * w_out * 3);
  for (int y = 0; y < h_in; ++y) {
    const uint8_t* row = in + size_t(y) * w_in * 3;
    float* trow = tmp.data() + size_t(y) * w_out * 3;
    for (int x = 0; x < w_out; ++x) {
      const double* w = &cx.weights[size_t(x) * cx.max_taps];
      const int lo = cx.bounds_lo[x];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < cx.counts[x]; ++i) {
        const uint8_t* px = row + size_t(lo + i) * 3;
        r += w[i] * px[0];
        g += w[i] * px[1];
        b += w[i] * px[2];
      }
      trow[x * 3 + 0] = float(r);
      trow[x * 3 + 1] = float(g);
      trow[x * 3 + 2] = float(b);
    }
  }
  // Vertical pass.
  for (int y = 0; y < h_out; ++y) {
    const double* w = &cy.weights[size_t(y) * cy.max_taps];
    const int lo = cy.bounds_lo[y];
    uint8_t* orow = out + size_t(y) * w_out * 3;
    for (int x = 0; x < w_out * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < cy.counts[y]; ++i)
        acc += w[i] * tmp[size_t(lo + i) * w_out * 3 + x];
      orow[x] = clamp8(acc);
    }
  }
}

}  // namespace

extern "C" {

// Decode one JPEG and resize to (out_h, out_w) RGB8. Returns 0 on success.
// fast_scale != 0 enables the DCT-domain scaled decode (see decode_rgb):
// pixels differ slightly from the full-resolution path (the 8x8-block
// IDCT reduction is the antialias filter), so it is opt-in — the parity
// path decodes at full resolution like PIL.
int st_decode_resize2(const uint8_t* jpeg, size_t len, int out_h, int out_w,
                      uint8_t* out_rgb, int fast_scale) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc = decode_rgb(jpeg, len, &rgb, &w, &h, fast_scale ? out_h : 0,
                      fast_scale ? out_w : 0);
  if (rc != 0) return rc;
  resize_rgb(rgb.data(), w, h, out_rgb, out_w, out_h);
  return 0;
}

int st_decode_resize(const uint8_t* jpeg, size_t len, int out_h, int out_w,
                     uint8_t* out_rgb) {
  return st_decode_resize2(jpeg, len, out_h, out_w, out_rgb, 0);
}

// Batched, threaded variant. bufs/lens: n JPEG buffers; out: n*out_h*out_w*3.
// Per-image status written to statuses. Returns number of failures.
int st_decode_resize_batch2(const uint8_t** bufs, const size_t* lens, int n,
                            int out_h, int out_w, uint8_t* out, int* statuses,
                            int n_threads, int fast_scale) {
  if (n_threads < 1) n_threads = 1;
  const size_t stride = size_t(out_h) * out_w * 3;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads)
        statuses[i] =
            st_decode_resize2(bufs[i], lens[i], out_h, out_w, out + stride * i, fast_scale);
    });
  }
  for (auto& th : threads) th.join();
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += (statuses[i] != 0);
  return failures;
}

int st_decode_resize_batch(const uint8_t** bufs, const size_t* lens, int n,
                           int out_h, int out_w, uint8_t* out, int* statuses,
                           int n_threads) {
  return st_decode_resize_batch2(bufs, lens, n, out_h, out_w, out, statuses, n_threads, 0);
}

// Space-to-depth relayout: [h, w, 3] RGB8 -> [h/2, w/2, 12] with the
// (di, dj, c) channel order of ops/s2d_stem.py.  Emitting this layout at
// decode time lets the TPU stem run its 4x4/s1 equivalent conv without
// any device-side relayout (the transform that made the on-device s2d
// stem a measured negative).  Pure byte regroup — each output row gathers
// two input rows; memory-bound, negligible next to the JPEG decode.
void st_s2d_relayout(const uint8_t* in, int h, int w, uint8_t* out) {
  const int h2 = h / 2, w2 = w / 2;
  for (int i = 0; i < h2; ++i) {
    const uint8_t* r0 = in + size_t(2 * i) * w * 3;
    const uint8_t* r1 = r0 + size_t(w) * 3;
    uint8_t* o = out + size_t(i) * w2 * 12;
    for (int j = 0; j < w2; ++j) {
      const uint8_t* p00 = r0 + size_t(2 * j) * 3;  // di=0, dj=0
      uint8_t* q = o + size_t(j) * 12;
      // (di, dj, c): [p00, p01, p10, p11] each RGB
      q[0] = p00[0]; q[1] = p00[1]; q[2] = p00[2];
      q[3] = p00[3]; q[4] = p00[4]; q[5] = p00[5];
      q[6] = r1[size_t(2 * j) * 3 + 0]; q[7] = r1[size_t(2 * j) * 3 + 1];
      q[8] = r1[size_t(2 * j) * 3 + 2];
      q[9] = r1[size_t(2 * j) * 3 + 3]; q[10] = r1[size_t(2 * j) * 3 + 4];
      q[11] = r1[size_t(2 * j) * 3 + 5];
    }
  }
}

// Batched decode+resize with optional s2d output layout (s2d != 0:
// out rows are out_h/2 * out_w/2 * 12 bytes each — same byte count).
int st_decode_resize_batch3(const uint8_t** bufs, const size_t* lens, int n,
                            int out_h, int out_w, uint8_t* out, int* statuses,
                            int n_threads, int fast_scale, int s2d) {
  if (!s2d)
    return st_decode_resize_batch2(bufs, lens, n, out_h, out_w, out, statuses,
                                   n_threads, fast_scale);
  if (n_threads < 1) n_threads = 1;
  const size_t stride = size_t(out_h) * out_w * 3;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<uint8_t> tmp(stride);
      for (int i = t; i < n; i += n_threads) {
        statuses[i] =
            st_decode_resize2(bufs[i], lens[i], out_h, out_w, tmp.data(), fast_scale);
        if (statuses[i] == 0)
          st_s2d_relayout(tmp.data(), out_h, out_w, out + stride * i);
      }
    });
  }
  for (auto& th : threads) th.join();
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += (statuses[i] != 0);
  return failures;
}
}
