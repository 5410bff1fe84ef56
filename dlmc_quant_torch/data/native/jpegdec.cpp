// JPEG decode + crop + bilinear resize (+ flip) for the ImageFolder loader.
//
// libjpeg decodes with DCT scaling (at 1/2, 1/4 or 1/8 of the resolution
// when the target is that much smaller), then one fused pass crops,
// resizes bilinearly and flips; one call per image.  The ctypes call
// releases the GIL, so the loader's decode threads run it in parallel.
//
// Not bit-identical to PIL (another resampling filter); deterministic for
// a given buffer.  The sampling arithmetic is the JAX package's
// (dlmc_quant_tpu/data/native/jpegdec.cpp), so both give the same bytes.
// Returns -1 on any decode error and the Python caller falls back to PIL
// (CMYK JPEGs, truncated files).
//
// libjpeg reports errors by longjmp out of its calls, so nothing with a
// destructor is alive across the setjmp: the decoded frame is one malloc'd
// buffer, declared before it and freed on both exits.
//
// Build (done at first use by native/__init__.py, into native/_build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libdlmcq_jpeg_<hash>.so \
//       jpegdec.cpp -ljpeg

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE
#include <cstdlib>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void silent_emit(j_common_ptr, int) {}

// bilinear sample of channel-interleaved u8 RGB at (fx, fy)
inline void sample_bilinear(const unsigned char* img, int W, int H,
                            double fx, double fy, unsigned char* out3) {
  fx = std::min(std::max(fx, 0.0), static_cast<double>(W - 1));
  fy = std::min(std::max(fy, 0.0), static_cast<double>(H - 1));
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const int x1 = std::min(x0 + 1, W - 1), y1 = std::min(y0 + 1, H - 1);
  const double ax = fx - x0, ay = fy - y0;
  const unsigned char* p00 = img + (static_cast<size_t>(y0) * W + x0) * 3;
  const unsigned char* p01 = img + (static_cast<size_t>(y0) * W + x1) * 3;
  const unsigned char* p10 = img + (static_cast<size_t>(y1) * W + x0) * 3;
  const unsigned char* p11 = img + (static_cast<size_t>(y1) * W + x1) * 3;
  for (int c = 0; c < 3; ++c) {
    const double v = (1 - ay) * ((1 - ax) * p00[c] + ax * p01[c]) +
                     ay * ((1 - ax) * p10[c] + ax * p11[c]);
    out3[c] = static_cast<unsigned char>(v + 0.5);
  }
}

}  // namespace

extern "C" {

// Read (width, height) from a JPEG header.  Returns 0 on success.
int dlmcq_jpeg_dims(const unsigned char* buf, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = silent_emit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode `buf`, crop (cl, ct, cw, ch) in ORIGINAL image coordinates
// (cw <= 0 selects the full image), bilinear-resize the crop to (ow, oh),
// optionally flip horizontally, write u8 RGB to out (oh*ow*3).  DCT
// scaling decodes at the smallest 1/2^k resolution whose scaled crop still
// covers the target.  Returns 0 on success.
int dlmcq_decode_resize(const unsigned char* buf, int64_t len,
                        int cl, int ct, int cw, int ch,
                        int ow, int oh, int flip, unsigned char* out) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  // set after the setjmp and read by its error branch: volatile, so that
  // the longjmp does not leave it indeterminate
  unsigned char* volatile img = nullptr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = silent_emit;
  if (setjmp(jerr.jb)) {
    std::free(img);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale converts; CMYK errors

  const int iw = static_cast<int>(cinfo.image_width);
  const int ih = static_cast<int>(cinfo.image_height);
  if (cw <= 0 || ch <= 0) {
    cl = 0;
    ct = 0;
    cw = iw;
    ch = ih;
  }
  cl = std::min(std::max(cl, 0), iw - 1);
  ct = std::min(std::max(ct, 0), ih - 1);
  cw = std::min(cw, iw - cl);
  ch = std::min(ch, ih - ct);

  int denom = 1;  // largest 1/2^k with scaled crop >= target
  while (denom < 8 && cw / (denom * 2) >= ow && ch / (denom * 2) >= oh) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  const int W = static_cast<int>(cinfo.output_width);
  const int H = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }

  unsigned char* const frame = static_cast<unsigned char*>(
      std::malloc(static_cast<size_t>(W) * H * 3));
  img = frame;
  if (frame == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row =
        frame + static_cast<size_t>(cinfo.output_scanline) * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // crop rectangle in the DCT-scaled frame
  const double sx = static_cast<double>(W) / iw;
  const double sy = static_cast<double>(H) / ih;
  const double scl = cl * sx, sct = ct * sy;
  const double scw = cw * sx, sch = ch * sy;

  for (int y = 0; y < oh; ++y) {
    const double fy = sct + (y + 0.5) * sch / oh - 0.5;
    unsigned char* orow = out + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const double fx = scl + (x + 0.5) * scw / ow - 0.5;
      unsigned char* px =
          orow + static_cast<size_t>(flip ? (ow - 1 - x) : x) * 3;
      sample_bilinear(frame, W, H, fx, fy, px);
    }
  }
  std::free(frame);
  return 0;
}

int dlmcq_jpeg_abi_version() { return 1; }

}  // extern "C"
