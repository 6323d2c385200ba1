// Native host-side IO for revo_tpu: PNG decode + threaded prefetch queue.
//
// Replacement for the reference's IO producer thread
// (io/iowrapperRGBD.cpp:257-352): a pool of decoder threads reads TUM-format
// RGB (8-bit, converted to gray) and depth (16-bit) PNGs ahead of the
// consumer, handing frames over through a bounded ring — the same
// producer/consumer pipeline as IOWrapperRGBD::generateImgPyramid +
// getOldestPyramid, minus the benign-by-luck unlocked queue reads
// (iowrapperRGBD.h:218-223) which we do NOT reproduce.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: make -C native   (produces librevo_io.so; links libpng + pthread)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decoding
// ---------------------------------------------------------------------------

struct Image {
  std::vector<uint8_t> gray;     // 8-bit gray (rgb inputs converted)
  std::vector<uint16_t> depth;   // 16-bit raw depth
  int width = 0;
  int height = 0;
  bool is_depth = false;
  bool ok = false;
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int width = png_get_image_width(png, info);
  const int height = png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth_bits = png_get_bit_depth(png, info);

  out->width = width;
  out->height = height;

  if (depth_bits == 16) {
    // 16-bit depth image (TUM depth PNGs are 16-bit grayscale, big-endian).
    out->is_depth = true;
    if (color != PNG_COLOR_TYPE_GRAY) png_set_rgb_to_gray(png, 1, -1, -1);
    png_set_swap(png);  // PNG is big-endian; we want host little-endian
    png_read_update_info(png, info);
    out->depth.resize(static_cast<size_t>(width) * height);
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y)
      rows[y] = reinterpret_cast<png_bytep>(out->depth.data() +
                                            static_cast<size_t>(y) * width);
    png_read_image(png, rows.data());
  } else {
    // 8-bit color/gray image -> gray with OpenCV's BGR weights
    // (0.299 R + 0.587 G + 0.114 B, imgpyramidrgbd.cpp:53).
    out->is_depth = false;
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth_bits < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    png_read_update_info(png, info);
    const int channels = png_get_channels(png, info);
    std::vector<uint8_t> raw(static_cast<size_t>(width) * height * channels);
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y)
      rows[y] = raw.data() + static_cast<size_t>(y) * width * channels;
    png_read_image(png, rows.data());
    out->gray.resize(static_cast<size_t>(width) * height);
    if (channels == 1) {
      std::memcpy(out->gray.data(), raw.data(), out->gray.size());
    } else {
      // Fixed-point weights as in OpenCV (R*4899 + G*9617 + B*1868) >> 14,
      // with rounding — matches cv::cvtColor COLOR_RGB2GRAY exactly.
      for (size_t i = 0; i < out->gray.size(); ++i) {
        const uint8_t* p = raw.data() + i * channels;
        const uint32_t v =
            4899u * p[0] + 9617u * p[1] + 1868u * p[2] + (1u << 13);
        out->gray[i] = static_cast<uint8_t>(v >> 14);
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------------
// Prefetcher: N worker threads decode (rgb, depth) pairs in order; frames are
// released to the consumer strictly in sequence.
// ---------------------------------------------------------------------------

struct Frame {
  Image gray;
  Image depth;
  bool ok = false;
};

struct Prefetcher {
  std::vector<std::string> rgb_paths;
  std::vector<std::string> depth_paths;
  std::vector<Frame> slots;
  std::vector<std::atomic<int>> state;  // 0=pending, 1=ready, 2=consumed
  std::atomic<size_t> next_job{0};
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  size_t window = 16;  // decode-ahead bound
  std::atomic<size_t> consumed{0};

  explicit Prefetcher(size_t n) : slots(n), state(n) {
    for (auto& s : state) s.store(0);
  }

  void worker() {
    for (;;) {
      if (stop.load()) return;
      size_t job = next_job.fetch_add(1);
      if (job >= rgb_paths.size()) return;
      // Bound how far ahead of the consumer we run.
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || job < consumed.load() + window;
        });
        if (stop.load()) return;
      }
      Frame& f = slots[job];
      bool ok = decode_png(rgb_paths[job].c_str(), &f.gray);
      ok = decode_png(depth_paths[job].c_str(), &f.depth) && ok;
      f.ok = ok;
      state[job].store(1);
      cv.notify_all();
    }
  }

  void start(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  ~Prefetcher() {
    stop.store(true);
    cv.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
  }
};

}  // namespace

extern "C" {

// One-shot decode: returns 0 on success.  Caller provides buffers sized
// w*h; pass w=h=0 to query dimensions only (fills *w,*h, no copy).
int revo_png_info(const char* path, int* w, int* h, int* is16) {
  Image img;
  if (!decode_png(path, &img)) return -1;
  *w = img.width;
  *h = img.height;
  *is16 = img.is_depth ? 1 : 0;
  return 0;
}

int revo_load_gray(const char* path, uint8_t* out, int w, int h) {
  Image img;
  if (!decode_png(path, &img) || img.is_depth) return -1;
  if (img.width != w || img.height != h) return -2;
  std::memcpy(out, img.gray.data(), static_cast<size_t>(w) * h);
  return 0;
}

int revo_load_depth16(const char* path, uint16_t* out, int w, int h) {
  Image img;
  if (!decode_png(path, &img) || !img.is_depth) return -1;
  if (img.width != w || img.height != h) return -2;
  std::memcpy(out, img.depth.data(), static_cast<size_t>(w) * h * 2);
  return 0;
}

// Prefetcher API -------------------------------------------------------------

void* revo_prefetch_create(const char** rgb_paths, const char** depth_paths,
                           int n, int n_threads, int window) {
  auto* p = new Prefetcher(static_cast<size_t>(n));
  p->rgb_paths.assign(rgb_paths, rgb_paths + n);
  p->depth_paths.assign(depth_paths, depth_paths + n);
  p->window = window > 0 ? static_cast<size_t>(window) : 16;
  p->start(n_threads > 0 ? n_threads : 2);
  return p;
}

// Blocks until frame idx is decoded; copies into caller buffers.
// Returns 0 ok, -1 decode failure, -2 bad size/index.
int revo_prefetch_get(void* handle, int idx, uint8_t* gray, uint16_t* depth,
                      int w, int h) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || static_cast<size_t>(idx) >= p->slots.size()) return -2;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->state[idx].load() == 1; });
  }
  Frame& f = p->slots[idx];
  if (!f.ok) return -1;
  if (f.gray.width != w || f.gray.height != h || f.depth.width != w ||
      f.depth.height != h)
    return -2;
  std::memcpy(gray, f.gray.gray.data(), static_cast<size_t>(w) * h);
  std::memcpy(depth, f.depth.depth.data(), static_cast<size_t>(w) * h * 2);
  // Release the slot's memory and advance the window.
  f.gray = Image();
  f.depth = Image();
  p->state[idx].store(2);
  p->consumed.store(static_cast<size_t>(idx) + 1);
  p->cv.notify_all();
  return 0;
}

void revo_prefetch_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
