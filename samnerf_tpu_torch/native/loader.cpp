// Multithreaded dataset image loader.
//
// Runtime-IO component of the framework (the reference leans on torch's
// C++ dataloader machinery + PIL; here dataset startup decodes every
// image with a C++ thread pool via libjpeg/libpng and writes straight
// into one preallocated RGB buffer, optionally integer-downscaling by
// box average on the fly).
//
// C ABI (ctypes):
//   int decode_images(const char** paths, int n,
//                     unsigned char* out,      // [n, h, w, 3]
//                     int out_h, int out_w, int downscale,
//                     int num_threads);
// Returns 0 on success, else the (1-based) index of the first file that
// failed to decode or whose decoded size does not match.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode one JPEG into rgb [h, w, 3]; returns (h, w) or (0, 0).
bool decode_jpeg(const std::string& path, std::vector<uint8_t>& rgb,
                 int& h, int& w) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(size_t(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // libjpeg reports corrupt/truncated streams as WARNINGS and pads the
  // remaining scanlines with gray blocks — silently accepting that would
  // feed corrupt pixels to training.  Treat any warning as failure (the
  // caller falls back to the strict PIL path).
  bool clean = cinfo.err->num_warnings == 0;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return clean;
}

// Decode one PNG (8/16-bit, gray/rgb/rgba) into rgb [h, w, 3]. RGBA is
// composited over a white background, matching the reference's blender
// alpha_color default (nerfstudio blender dataparser: image = rgb*a + 1-a).
bool decode_png(const std::string& path, std::vector<uint8_t>& rgb,
                int& h, int& w) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) {
    fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(f);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  if (channels != 3 && channels != 4) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  std::vector<uint8_t> raw(size_t(h) * w * channels);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; y++) rows[y] = raw.data() + size_t(y) * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  rgb.resize(size_t(h) * w * 3);
  if (channels == 3) {
    memcpy(rgb.data(), raw.data(), rgb.size());
  } else {
    // out = rgb*a + 255*(1-a), rounded
    const uint8_t* p = raw.data();
    uint8_t* q = rgb.data();
    for (size_t i = 0, np = size_t(h) * w; i < np; i++, p += 4, q += 3) {
      int a = p[3];
      q[0] = uint8_t((p[0] * a + 255 * (255 - a) + 127) / 255);
      q[1] = uint8_t((p[1] * a + 255 * (255 - a) + 127) / 255);
      q[2] = uint8_t((p[2] * a + 255 * (255 - a) + 127) / 255);
    }
  }
  return true;
}

void box_downscale(const std::vector<uint8_t>& src, int h, int w, int d,
                   uint8_t* dst, int oh, int ow) {
  for (int y = 0; y < oh; y++) {
    for (int x = 0; x < ow; x++) {
      int acc[3] = {0, 0, 0};
      for (int dy = 0; dy < d; dy++) {
        const uint8_t* row = src.data() + (size_t(y) * d + dy) * w * 3;
        for (int dx = 0; dx < d; dx++) {
          const uint8_t* p = row + (size_t(x) * d + dx) * 3;
          acc[0] += p[0];
          acc[1] += p[1];
          acc[2] += p[2];
        }
      }
      uint8_t* q = dst + (size_t(y) * ow + x) * 3;
      int area = d * d;
      q[0] = uint8_t(acc[0] / area);
      q[1] = uint8_t(acc[1] / area);
      q[2] = uint8_t(acc[2] / area);
    }
  }
}

bool ends_with(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++)
    if (tolower(s[s.size() - n + i]) != suf[i]) return false;
  return true;
}

}  // namespace

extern "C" int decode_images(const char** paths, int n, unsigned char* out,
                             int out_h, int out_w, int downscale,
                             int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  if (num_threads < 1) num_threads = 1;

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      std::string path(paths[i]);
      int h = 0, w = 0;
      bool ok = ends_with(path, ".png")
                    ? decode_png(path, rgb, h, w)
                    : decode_jpeg(path, rgb, h, w);
      // Exact-size contract: a decoded image must be exactly
      // (out_h*downscale, out_w*downscale); anything else is reported so
      // the caller can fall back to the PIL path (mixed-resolution sets).
      if (!ok || h != out_h * downscale || w != out_w * downscale) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        return;
      }
      uint8_t* dst = out + size_t(i) * out_h * out_w * 3;
      if (downscale == 1 && h == out_h && w == out_w) {
        memcpy(dst, rgb.data(), size_t(out_h) * out_w * 3);
      } else {
        box_downscale(rgb, h, w, downscale, dst, out_h, out_w);
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}
