// Batched PNG decode + centre crop for the training input feed, a copy of
// argus_tpu's native loader: one C call decodes a whole batch with an internal
// thread pool (libpng, no Python per image), crops, and writes straight into
// the caller's numpy buffer, which then ships to the card as uint8.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cpp -lpng -lz -o libargusloader.so
// API: argus_tpu_torch/native/__init__.py (ctypes).

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Decode one PNG file to RGB8 and center-crop into dst (crop_h * crop_w * 3).
// Returns 0 on success, nonzero error code otherwise.
int decode_one(const char* path, int crop_h, int crop_w, uint8_t* dst) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;

  if (!png_image_begin_read_from_file(&image, path)) {
    return 1;  // open/parse failure
  }
  image.format = PNG_FORMAT_RGB;

  const int h = static_cast<int>(image.height);
  const int w = static_cast<int>(image.width);
  if (h < crop_h || w < crop_w) {
    png_image_free(&image);
    return 2;  // image smaller than the requested crop
  }

  const size_t stride = PNG_IMAGE_ROW_STRIDE(image);
  std::vector<uint8_t> full(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, full.data(),
                             static_cast<png_int_32>(stride), nullptr)) {
    png_image_free(&image);
    return 3;  // decode failure
  }

  // center-crop: same index arithmetic as the python path (dataset._center_crop_np)
  const int top = (h - crop_h) / 2;
  const int left = (w - crop_w) / 2;
  for (int row = 0; row < crop_h; ++row) {
    const uint8_t* src = full.data() + (top + row) * stride + left * 3;
    std::memcpy(dst + static_cast<size_t>(row) * crop_w * 3, src,
                static_cast<size_t>(crop_w) * 3);
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode `n` PNGs (paths[i]) into out[n, crop_h, crop_w, 3] (uint8, C-contiguous)
// using up to `n_threads` worker threads. Returns 0 if every image decoded, else
// the first nonzero per-image error code (out rows for failed images are zeroed).
int argus_decode_batch(const char** paths, int n, int crop_h, int crop_w,
                       uint8_t* out, int n_threads) {
  if (n <= 0) return 0;
  const size_t img_bytes = static_cast<size_t>(crop_h) * crop_w * 3;
  std::atomic<int> next{0};
  std::atomic<int> status{0};

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + static_cast<size_t>(i) * img_bytes;
      const int rc = decode_one(paths[i], crop_h, crop_w, dst);
      if (rc != 0) {
        std::memset(dst, 0, img_bytes);
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
      }
    }
  };

  int threads = n_threads < 1 ? 1 : n_threads;
  if (threads > n) threads = n;
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return status.load();
}

// Read just the header: returns 0 and fills (h, w) without decoding pixel data.
int argus_png_size(const char* path, int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return 1;
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  png_image_free(&image);
  return 0;
}

}  // extern "C"
