// Host data path of the training feed: JPEG decode, fused crop + bicubic
// resize, the multi-crop batch fan-out, .lineidx parsing and base64.
//
// Host C++, not a device kernel: the feed's threads spend their time here
// rather than in PIL, and ctypes releases the GIL for the length of each
// call, so decode and crops run beside the thread that launches the
// step's kernels. dp_multicrop_batch decodes each JPEG once and writes
// every view, with one fused crop + resize, straight into the view-major
// (pinned) batch buffer that the loader uploads.
//
// Resampling is PIL's convolution resampler (bicubic a = -0.5, support 2,
// antialias widening on downscale: the algorithm of
// Image.resize(..., BICUBIC, box=...)), accumulated in double precision
// where PIL uses fixed point; its output is within +/-1 LSB of PIL's
// (tests/test_torch_native_datapath.py). The algorithms and the C ABI are
// esvit_tpu/native/datapath.cpp's, so under the same g++ flags the crops
// are the same bytes. Two additions: dp_crop_batch, the crops of images
// decoded elsewhere, and dp_has_jpeg.
//
// Built with -DDP_NO_JPEG where libjpeg's headers are missing: the JPEG
// half (dp_jpeg_dims, dp_jpeg_decode, dp_multicrop_batch) is left out, and
// the caller decodes with PIL and crops with dp_crop_batch.
//
// C ABI only, bound with ctypes (esvit_tpu_torch/native/__init__.py): no
// Python header, so a bare `g++ -shared` builds it in seconds.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifndef DP_NO_JPEG
#include <jpeglib.h>
#endif

// fn(i) for i in [0, n) on min(nthreads, n) threads taking the next index.
template <class F>
static void fan_out(int n, int nthreads, F fn) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int T = std::max(1, std::min(nthreads, n));
  if (T == 1) {
    work();
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(T);
  for (int t = 0; t < T; t++) ts.emplace_back(work);
  for (auto& th : ts) th.join();
}

extern "C" {

// ---------------------------------------------------------------------------
// version / error codes
// ---------------------------------------------------------------------------

#define DP_OK 0
#define DP_ERR_JPEG 1         // libjpeg raised (corrupt stream, ...)
#define DP_ERR_COLORSPACE 2   // source colorspace not converted (CMYK/YCCK)
#define DP_ERR_BOUNDS 3       // output buffer too small / bad box
#define DP_ERR_ARG 4          // bad argument

int dp_version(void) { return 10501; }

int dp_has_jpeg(void) {
#ifdef DP_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// lineidx: parse newline-separated decimal byte offsets (the TSV sidecar) in
// one pass. Returns the number of offsets written, -1 on overflow of `cap`,
// -2 on a non-numeric token. Tolerates \r\n and blank lines, as the Python
// reader does.
// ---------------------------------------------------------------------------

int64_t dp_lineidx_parse(const char* buf, int64_t len, int64_t* out,
                         int64_t cap) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    // skip whitespace/newlines between numbers
    while (i < len && (buf[i] == '\n' || buf[i] == '\r' || buf[i] == ' ' ||
                       buf[i] == '\t'))
      i++;
    if (i >= len) break;
    int64_t v = 0;
    bool any = false;
    while (i < len && buf[i] >= '0' && buf[i] <= '9') {
      v = v * 10 + (buf[i] - '0');
      i++;
      any = true;
    }
    if (!any) return -2;  // non-numeric garbage
    if (n >= cap) return -1;
    out[n++] = v;
  }
  return n;
}

// ---------------------------------------------------------------------------
// base64 decode (standard alphabet, '=' padding, whitespace tolerated): the
// TSV image column. Returns the decoded length, or -1 on bad input.
// ---------------------------------------------------------------------------

static const int8_t* b64_lut() {
  // A function-local static is initialised once, thread-safely.
  static const struct Lut {
    int8_t v[256];
    Lut() {
      for (int i = 0; i < 256; i++) v[i] = -1;
      const char* al =
          "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
      for (int i = 0; i < 64; i++) v[(unsigned char)al[i]] = (int8_t)i;
    }
  } lut;
  return lut.v;
}

int64_t dp_b64_decode(const uint8_t* in, int64_t n, uint8_t* out) {
  const int8_t* lut = b64_lut();
  int64_t o = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = in[i];
    if (c == '=' || c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
    int8_t v = lut[c];
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (uint8_t)((acc >> bits) & 0xFF);
    }
  }
  return o;
}

#ifndef DP_NO_JPEG
// ---------------------------------------------------------------------------
// JPEG decode via libjpeg(-turbo). Always emits RGB8 (grayscale sources are
// expanded by libjpeg; CMYK/YCCK are refused -> the caller falls back to
// PIL).
// ---------------------------------------------------------------------------

struct DpErrMgr {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static void dp_error_exit(j_common_ptr cinfo) {
  DpErrMgr* e = (DpErrMgr*)cinfo->err;
  longjmp(e->jb, 1);
}

static void dp_emit_nothing(j_common_ptr, int) {}

// Header-only probe: full-resolution dimensions without decoding.
int dp_jpeg_dims(const uint8_t* buf, int64_t len, int32_t* w, int32_t* h) {
  struct jpeg_decompress_struct cinfo;
  DpErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = dp_error_exit;
  jerr.pub.emit_message = dp_emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return DP_ERR_JPEG;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int32_t)cinfo.image_width;
  *h = (int32_t)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return DP_OK;
}

// Decode into `out` (resized to fit). denom in {1,2,4,8} uses libjpeg's
// DCT-domain downscale: output dims = ceil(dim / denom).
static int decode_rgb(const uint8_t* buf, int64_t len, int denom,
                      std::vector<uint8_t>& out, int32_t* w, int32_t* h) {
  struct jpeg_decompress_struct cinfo;
  DpErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = dp_error_exit;
  jerr.pub.emit_message = dp_emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return DP_ERR_JPEG;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return DP_ERR_COLORSPACE;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return DP_ERR_COLORSPACE;
  }
  const int W = (int)cinfo.output_width, H = (int)cinfo.output_height;
  const size_t stride = (size_t)W * 3;
  out.resize((size_t)H * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = W;
  *h = H;
  return DP_OK;
}

int dp_jpeg_decode(const uint8_t* buf, int64_t len, int32_t scale_denom,
                   uint8_t* out, int64_t cap, int32_t* w, int32_t* h) {
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return DP_ERR_ARG;
  std::vector<uint8_t> tmp;
  int rc = decode_rgb(buf, len, scale_denom, tmp, w, h);
  if (rc != DP_OK) return rc;
  if ((int64_t)tmp.size() > cap) return DP_ERR_BOUNDS;
  std::memcpy(out, tmp.data(), tmp.size());
  return DP_OK;
}
#endif  // DP_NO_JPEG

// ---------------------------------------------------------------------------
// PIL-style convolution resampling (bicubic a=-0.5, support 2, antialias on
// downscale), fused with a fractional crop box: the work of
// Image.resize((ow, oh), BICUBIC, box=(x0, y0, x1, y1)), accumulated in
// double precision and written as RGB8 straight into a strided output row.
// ---------------------------------------------------------------------------

static inline double bicubic_filter(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// PIL's precompute_coeffs (libImaging/Resample.c) for one axis.
static void precompute_coeffs(int in_size, double in0, double in1,
                              int out_size, std::vector<double>& kk,
                              std::vector<int>& bounds, int* ksize_out) {
  const double support0 = 2.0;  // bicubic
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support0 * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  kk.assign((size_t)out_size * ksize, 0.0);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[(size_t)xx * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int j = 0; j < xmax; j++) k[j] /= ww;
    bounds[(size_t)xx * 2] = xmin;
    bounds[(size_t)xx * 2 + 1] = xmax;
  }
  *ksize_out = ksize;
}

static inline uint8_t clip8(double v) {
  // PIL's fixed-point pipeline rounds half away from zero and clamps.
  int iv = (int)std::floor(v + 0.5);
  return (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
}

// Crop+resize src (ih, iw, 3) RGB8 with float box [y0,y1)x[x0,x1) to
// (oh, ow, 3) written at `out` with row stride `out_stride` bytes.
static int crop_resize_bicubic(const uint8_t* src, int ih, int iw, double y0,
                               double x0, double y1, double x1, uint8_t* out,
                               int oh, int ow, int64_t out_stride) {
  if (!(x1 > x0) || !(y1 > y0) || ow <= 0 || oh <= 0) return DP_ERR_BOUNDS;
  if (x0 < 0 || y0 < 0 || x1 > iw || y1 > ih) return DP_ERR_BOUNDS;

  std::vector<double> kx, ky;
  std::vector<int> bx, by;
  int ksx, ksy;
  precompute_coeffs(iw, x0, x1, ow, kx, bx, &ksx);
  precompute_coeffs(ih, y0, y1, oh, ky, by, &ksy);

  // Row window actually needed by the vertical pass.
  int ymin_all = by[0];
  int ymax_all = 0;
  for (int yy = 0; yy < oh; yy++) {
    ymin_all = std::min(ymin_all, by[(size_t)yy * 2]);
    ymax_all = std::max(ymax_all, by[(size_t)yy * 2] + by[(size_t)yy * 2 + 1]);
  }
  const int nrows = ymax_all - ymin_all;

  // Horizontal pass into a uint8 intermediate: the clip and rounding PIL's
  // 8-bit pipeline applies between its passes (bicubic overshoot must clamp
  // here, or outputs drift by up to ~12 LSB on noisy images).
  std::vector<uint8_t> tmp((size_t)nrows * ow * 3);
  for (int y = 0; y < nrows; y++) {
    const uint8_t* srow = src + (size_t)(y + ymin_all) * iw * 3;
    uint8_t* trow = &tmp[(size_t)y * ow * 3];
    for (int xx = 0; xx < ow; xx++) {
      const int xmin = bx[(size_t)xx * 2], xmax = bx[(size_t)xx * 2 + 1];
      const double* k = &kx[(size_t)xx * ksx];
      double s0 = 0, s1 = 0, s2 = 0;
      const uint8_t* p = srow + (size_t)xmin * 3;
      for (int x = 0; x < xmax; x++) {
        const double w = k[x];
        s0 += w * p[0];
        s1 += w * p[1];
        s2 += w * p[2];
        p += 3;
      }
      trow[xx * 3 + 0] = clip8(s0);
      trow[xx * 3 + 1] = clip8(s1);
      trow[xx * 3 + 2] = clip8(s2);
    }
  }

  // Vertical pass straight into the strided uint8 output.
  for (int yy = 0; yy < oh; yy++) {
    const int ymin = by[(size_t)yy * 2] - ymin_all,
              ymax = by[(size_t)yy * 2 + 1];
    const double* k = &ky[(size_t)yy * ksy];
    uint8_t* orow = out + (size_t)yy * out_stride;
    for (int xx = 0; xx < ow * 3; xx += 3) {
      double s0 = 0, s1 = 0, s2 = 0;
      const uint8_t* p = &tmp[(size_t)ymin * ow * 3 + xx];
      for (int y = 0; y < ymax; y++) {
        const double w = k[y];
        s0 += w * p[0];
        s1 += w * p[1];
        s2 += w * p[2];
        p += (size_t)ow * 3;
      }
      orow[xx + 0] = clip8(s0);
      orow[xx + 1] = clip8(s1);
      orow[xx + 2] = clip8(s2);
    }
  }
  return DP_OK;
}

int dp_crop_resize(const uint8_t* src, int32_t ih, int32_t iw, double y0,
                   double x0, double y1, double x1, uint8_t* out, int32_t oh,
                   int32_t ow) {
  return crop_resize_bicubic(src, ih, iw, y0, x0, y1, x1, out, oh, ow,
                             (int64_t)ow * 3);
}

// ---------------------------------------------------------------------------
// Multi-crop batches: every view of an image, each with one fused
// crop+resize, written directly into per-view batch tensors (the loader's
// view-major layout: view v of image i lands at row `img_rows[i]` of
// view_outs[v], a (n_rows, S_v, S_v, 3) C-contiguous array).
//
// boxes: (n_imgs, n_views, 4) float64 (top, left, h, w) in FULL-RES pixel
// coordinates (the RandomResizedCrop parameters, drawn on the Python side so
// the random stream is the PIL path's).
//
// status[i]: DP_OK or an error code; a failed image's rows are left for the
// caller to fill through PIL.
// ---------------------------------------------------------------------------

// Image i's views from its decoded pixels (H, W, 3), decoded at 1/denom of
// full resolution.
static int crop_views(const uint8_t* img, int H, int W, int denom,
                      const double* ib, const int32_t* view_sizes,
                      uint8_t* const* view_outs, int64_t row, int n_views) {
  const double inv = 1.0 / denom;
  int ok = DP_OK;
  for (int v = 0; v < n_views; v++) {
    const double top = ib[v * 4 + 0] * inv, left = ib[v * 4 + 1] * inv;
    const double h = ib[v * 4 + 2] * inv, w = ib[v * 4 + 3] * inv;
    const int S = view_sizes[v];
    // A scaled decode rounds dims up (ceil); clamp the box to the decoded
    // extent to stay in bounds.
    const double y1 = std::min(top + h, (double)H);
    const double x1 = std::min(left + w, (double)W);
    uint8_t* out = view_outs[v] + (size_t)row * S * S * 3;
    int rc = crop_resize_bicubic(img, H, W, top, left, y1, x1, out, S, S,
                                 (int64_t)S * 3);
    if (rc != DP_OK) ok = rc;
  }
  return ok;
}

#ifndef DP_NO_JPEG
// Decode each JPEG once, then crop every view from it.
//
// allow_scaled: when nonzero, an image whose every view is downscaled by >=2x
// decodes at the largest DCT-domain denom in {2,4,8} that keeps every crop
// at least 2*S_v wide (the bicubic antialias low-pass subsumes the DCT
// low-pass), up to ~8x cheaper on large sources.
int dp_multicrop_batch(const uint8_t* const* jpegs, const int64_t* jlens,
                       int32_t n_imgs, const double* boxes,
                       const int32_t* view_sizes, uint8_t* const* view_outs,
                       const int64_t* img_rows, int32_t n_views,
                       int32_t allow_scaled, int32_t nthreads,
                       int32_t* status) {
  if (n_imgs <= 0 || n_views <= 0) return DP_ERR_ARG;
  fan_out(n_imgs, nthreads, [&](int i) {
    const double* ib = boxes + (size_t)i * n_views * 4;
    int denom = 1;
    if (allow_scaled) {
      // Largest denom keeping every view's crop >= 2*S after prescale.
      double max_d = 8.0;
      for (int v = 0; v < n_views; v++) {
        const double h = ib[v * 4 + 2], w = ib[v * 4 + 3];
        const double s = (double)view_sizes[v];
        max_d = std::min(max_d, std::min(h, w) / (2.0 * s));
      }
      while (denom * 2 <= (int)max_d && denom < 8) denom *= 2;
    }
    std::vector<uint8_t> img;
    int32_t W, H;
    int rc = decode_rgb(jpegs[i], jlens[i], denom, img, &W, &H);
    if (rc != DP_OK && denom != 1) {  // retry unscaled before giving up
      denom = 1;
      rc = decode_rgb(jpegs[i], jlens[i], 1, img, &W, &H);
    }
    status[i] = rc != DP_OK ? rc
                            : crop_views(img.data(), H, W, denom, ib,
                                         view_sizes, view_outs, img_rows[i],
                                         n_views);
  });
  return DP_OK;
}
#endif  // DP_NO_JPEG

// The views of images already decoded: imgs[i] is (heights[i], widths[i],
// 3) RGB8, C-contiguous, at full resolution.
int dp_crop_batch(const uint8_t* const* imgs, const int32_t* heights,
                  const int32_t* widths, int32_t n_imgs, const double* boxes,
                  const int32_t* view_sizes, uint8_t* const* view_outs,
                  const int64_t* img_rows, int32_t n_views, int32_t nthreads,
                  int32_t* status) {
  if (n_imgs <= 0 || n_views <= 0) return DP_ERR_ARG;
  fan_out(n_imgs, nthreads, [&](int i) {
    status[i] = crop_views(imgs[i], heights[i], widths[i], 1,
                           boxes + (size_t)i * n_views * 4, view_sizes,
                           view_outs, img_rows[i], n_views);
  });
  return DP_OK;
}

}  // extern "C"
