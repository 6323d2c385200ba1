// Live-sensor capture engine for revo_tpu: V4L2 streaming + depth
// registration, with an injectable syscall shim for hardware-free testing.
//
// Replacement for the reference's live-sensor stack
// (io/realsensesensor.cpp:77-139, orbbec_astra_pro/OrbbecAstraEngineUVC.cpp
// :93-140, OrbbecAstraEngineFFMPEG.cpp:315+, OrbbecAstraOpenNIEngine.cpp
// :298+): where the reference goes through librealsense / libuvc / OpenNI2 /
// FFMPEG, this engine speaks the kernel's own V4L2 mmap-streaming protocol
// directly (QUERYCAP -> S_FMT -> REQBUFS -> QUERYBUF/mmap -> QBUF ->
// STREAMON -> poll/DQBUF), so it has no userspace-driver dependencies at
// all.  Color formats: YUYV (Y plane extract), MJPEG (libjpeg grayscale
// decode), GREY; depth: Z16/Y16 passthrough.  Depth-to-color registration
// (the reference delegates it to OpenNI's setImageRegistrationMode /
// rs_frame_align_framesets, OrbbecAstraEngineFFMPEG.cpp:243,
// realsensesensor.cpp:86) is implemented explicitly: back-project, rigid
// transform, z-buffered projective splat.
//
// Every kernel interaction goes through a function-pointer shim
// (rs_set_shim / the built-in session replayer), so tests exercise the FULL
// negotiation + streaming + conversion path against recorded byte streams —
// the honest way to test a device driver in CI (no /dev/video* here).
//
// Plain C ABI for ctypes (no pybind11 in this environment).
// Build: make -C native   (librevo_sensor.so; links libjpeg + pthread)

#include <fcntl.h>
#include <cstdio>  // jpeglib.h needs FILE declared first
#include <jpeglib.h>
#include <linux/videodev2.h>
#include <poll.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <cerrno>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Syscall shim: all device interaction is routed through this vtable so a
// replay implementation can stand in for the kernel.
// ---------------------------------------------------------------------------

struct SensorShim {
  int (*open_)(const char* path, int flags);
  int (*ioctl_)(int fd, unsigned long req, void* arg);
  void* (*mmap_)(size_t len, int fd, int64_t off);
  int (*munmap_)(void* addr, size_t len);
  int (*poll_)(struct pollfd* fds, int nfds, int timeout_ms);
  int (*close_)(int fd);
};

int real_open(const char* path, int flags) { return ::open(path, flags); }
int real_ioctl(int fd, unsigned long req, void* arg) {
  int r;
  do {
    r = ::ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}
void* real_mmap(size_t len, int fd, int64_t off) {
  return ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, off);
}
int real_munmap(void* addr, size_t len) { return ::munmap(addr, len); }
int real_poll(struct pollfd* fds, int nfds, int timeout_ms) {
  return ::poll(fds, nfds, timeout_ms);
}
int real_close(int fd) { return ::close(fd); }

SensorShim g_shim = {real_open,   real_ioctl, real_mmap,
                     real_munmap, real_poll,  real_close};

// ---------------------------------------------------------------------------
// Session replayer: a V4L2 "kernel" serving frames from a recorded session
// file.  Format (little-endian):
//   u32 magic 'RVS1'  u32 width  u32 height  u32 fourcc  u32 nframes
//   nframes x { u32 nbytes, f64 timestamp_s, nbytes bytes }
// ---------------------------------------------------------------------------

struct ReplaySession {
  uint32_t width = 0, height = 0, fourcc = 0;
  std::vector<std::vector<uint8_t>> frames;
  std::vector<double> stamps;
  size_t max_bytes = 0;
};

struct ReplayState {
  // Shared ownership: rs_replay_register may REPLACE a device's session
  // while an already-open fd still streams the old one.
  std::shared_ptr<const ReplaySession> sess;
  size_t next_frame = 0;
  bool streaming = false;
  uint32_t n_buffers = 0;
  std::vector<int> queued;               // FIFO of queued buffer indices
  std::map<int64_t, std::vector<uint8_t>> regions;  // offset -> backing
  std::map<int64_t, double> stamp_at;    // offset -> ts of frame in region
  std::map<int64_t, uint32_t> used_at;   // offset -> bytesused
};

std::mutex g_replay_mu;
std::map<std::string, std::shared_ptr<const ReplaySession>>
    g_sessions;  // device path -> session
std::map<int, ReplayState> g_replay_fds;
int g_next_fd = 1000;

constexpr int64_t kRegionStride = 1 << 22;  // 4 MiB per buffer slot

bool load_session(const char* file, ReplaySession* out) {
  FILE* fp = std::fopen(file, "rb");
  if (!fp) return false;
  uint32_t head[5];
  if (std::fread(head, 4, 5, fp) != 5 || head[0] != 0x31535652u) {  // 'RVS1'
    std::fclose(fp);
    return false;
  }
  out->width = head[1];
  out->height = head[2];
  out->fourcc = head[3];
  uint32_t n = head[4];
  out->frames.clear();
  out->stamps.clear();
  out->max_bytes = 0;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t nbytes;
    double ts;
    if (std::fread(&nbytes, 4, 1, fp) != 1 || std::fread(&ts, 8, 1, fp) != 1) {
      std::fclose(fp);
      return false;
    }
    std::vector<uint8_t> buf(nbytes);
    if (nbytes && std::fread(buf.data(), 1, nbytes, fp) != nbytes) {
      std::fclose(fp);
      return false;
    }
    if (nbytes > out->max_bytes) out->max_bytes = nbytes;
    out->frames.push_back(std::move(buf));
    out->stamps.push_back(ts);
  }
  std::fclose(fp);
  return true;
}

int replay_open(const char* path, int /*flags*/) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  auto it = g_sessions.find(path);
  if (it == g_sessions.end()) {
    errno = ENOENT;
    return -1;
  }
  int fd = g_next_fd++;
  ReplayState st;
  st.sess = it->second;
  g_replay_fds[fd] = std::move(st);
  return fd;
}

int replay_ioctl(int fd, unsigned long req, void* arg) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  auto it = g_replay_fds.find(fd);
  if (it == g_replay_fds.end()) {
    errno = EBADF;
    return -1;
  }
  ReplayState& st = it->second;
  const ReplaySession& s = *st.sess;
  switch (req) {
    case VIDIOC_QUERYCAP: {
      auto* cap = static_cast<v4l2_capability*>(arg);
      std::memset(cap, 0, sizeof(*cap));
      std::snprintf(reinterpret_cast<char*>(cap->driver),
                    sizeof(cap->driver), "revo_replay");
      std::snprintf(reinterpret_cast<char*>(cap->card), sizeof(cap->card),
                    "revo session replayer");
      cap->capabilities =
          V4L2_CAP_VIDEO_CAPTURE | V4L2_CAP_STREAMING | V4L2_CAP_DEVICE_CAPS;
      cap->device_caps = V4L2_CAP_VIDEO_CAPTURE | V4L2_CAP_STREAMING;
      return 0;
    }
    case VIDIOC_ENUM_FMT: {
      auto* f = static_cast<v4l2_fmtdesc*>(arg);
      if (f->index != 0 || f->type != V4L2_BUF_TYPE_VIDEO_CAPTURE) {
        errno = EINVAL;
        return -1;
      }
      f->pixelformat = s.fourcc;
      return 0;
    }
    case VIDIOC_S_FMT:
    case VIDIOC_G_FMT: {
      auto* f = static_cast<v4l2_format*>(arg);
      if (f->type != V4L2_BUF_TYPE_VIDEO_CAPTURE) {
        errno = EINVAL;
        return -1;
      }
      // Like a real driver: the requested format is adjusted to what the
      // device actually delivers (the engine must read these back).
      f->fmt.pix.width = s.width;
      f->fmt.pix.height = s.height;
      f->fmt.pix.pixelformat = s.fourcc;
      f->fmt.pix.field = V4L2_FIELD_NONE;
      f->fmt.pix.sizeimage = static_cast<uint32_t>(s.max_bytes);
      return 0;
    }
    case VIDIOC_REQBUFS: {
      auto* rb = static_cast<v4l2_requestbuffers*>(arg);
      if (rb->memory != V4L2_MEMORY_MMAP) {
        errno = EINVAL;
        return -1;
      }
      st.n_buffers = rb->count > 8 ? 8 : rb->count;
      rb->count = st.n_buffers;
      return 0;
    }
    case VIDIOC_QUERYBUF: {
      auto* b = static_cast<v4l2_buffer*>(arg);
      if (b->index >= st.n_buffers) {
        errno = EINVAL;
        return -1;
      }
      b->length = static_cast<uint32_t>(s.max_bytes);
      b->m.offset = static_cast<uint32_t>(b->index * kRegionStride);
      return 0;
    }
    case VIDIOC_QBUF: {
      auto* b = static_cast<v4l2_buffer*>(arg);
      if (b->index >= st.n_buffers) {
        errno = EINVAL;
        return -1;
      }
      st.queued.push_back(static_cast<int>(b->index));
      return 0;
    }
    case VIDIOC_DQBUF: {
      auto* b = static_cast<v4l2_buffer*>(arg);
      if (!st.streaming || st.queued.empty()) {
        errno = EAGAIN;
        return -1;
      }
      if (st.next_frame >= s.frames.size()) {
        errno = EAGAIN;  // poll() reports end-of-stream via timeout
        return -1;
      }
      int idx = st.queued.front();
      st.queued.erase(st.queued.begin());
      int64_t off = idx * kRegionStride;
      const auto& frame = s.frames[st.next_frame];
      auto reg = st.regions.find(off);
      if (reg != st.regions.end()) {
        std::memcpy(reg->second.data(), frame.data(),
                    std::min(frame.size(), reg->second.size()));
      }
      b->index = static_cast<uint32_t>(idx);
      b->bytesused = static_cast<uint32_t>(frame.size());
      double ts = s.stamps[st.next_frame];
      b->timestamp.tv_sec = static_cast<time_t>(ts);
      b->timestamp.tv_usec =
          static_cast<suseconds_t>((ts - std::floor(ts)) * 1e6);
      st.next_frame++;
      return 0;
    }
    case VIDIOC_STREAMON:
      st.streaming = true;
      return 0;
    case VIDIOC_STREAMOFF:
      st.streaming = false;
      st.queued.clear();
      return 0;
    default:
      errno = ENOTTY;
      return -1;
  }
}

void* replay_mmap(size_t len, int fd, int64_t off) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  auto it = g_replay_fds.find(fd);
  if (it == g_replay_fds.end()) return MAP_FAILED;
  auto& reg = it->second.regions[off];
  reg.assign(len, 0);
  return reg.data();
}

int replay_munmap(void* /*addr*/, size_t /*len*/) { return 0; }

int replay_poll(struct pollfd* fds, int nfds, int /*timeout_ms*/) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  int ready = 0;
  for (int i = 0; i < nfds; ++i) {
    fds[i].revents = 0;
    auto it = g_replay_fds.find(fds[i].fd);
    if (it != g_replay_fds.end() &&
        it->second.next_frame < it->second.sess->frames.size() &&
        !it->second.queued.empty() && it->second.streaming) {
      fds[i].revents = POLLIN;
      ready++;
    }
  }
  return ready;  // 0 == timeout == end-of-stream for exhausted sessions
}

int replay_close(int fd) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  g_replay_fds.erase(fd);
  return 0;
}

SensorShim g_replay_shim = {replay_open,   replay_ioctl, replay_mmap,
                            replay_munmap, replay_poll,  replay_close};

// ---------------------------------------------------------------------------
// MJPEG -> grayscale via libjpeg (the FFMPEG engine's color path,
// OrbbecAstraEngineFFMPEG.cpp:315+, without FFMPEG).
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_mjpeg_gray(const uint8_t* data, size_t len, uint8_t* gray, int w,
                       int h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_height) != h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = gray + static_cast<size_t>(cinfo.output_scanline) * w;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// V4L2 capture stream: negotiation + mmap ring + conversion.
// ---------------------------------------------------------------------------

struct StreamBuffer {
  void* start = nullptr;
  size_t length = 0;
};

class V4L2Stream {
 public:
  int fd = -1;
  uint32_t width = 0, height = 0, fourcc = 0;
  std::vector<StreamBuffer> buffers;
  std::string error;

  bool open(const char* path, uint32_t want_w, uint32_t want_h,
            uint32_t want_fourcc, uint32_t n_buffers = 4) {
    fd = g_shim.open_(path, O_RDWR | O_NONBLOCK);
    if (fd < 0) return fail("open failed");
    v4l2_capability cap{};
    if (g_shim.ioctl_(fd, VIDIOC_QUERYCAP, &cap) < 0)
      return fail("QUERYCAP failed");
    if (!(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
        !(cap.capabilities & V4L2_CAP_STREAMING))
      return fail("device lacks capture+streaming caps");
    v4l2_format fmt{};
    fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    fmt.fmt.pix.width = want_w;
    fmt.fmt.pix.height = want_h;
    fmt.fmt.pix.pixelformat = want_fourcc;
    fmt.fmt.pix.field = V4L2_FIELD_NONE;
    if (g_shim.ioctl_(fd, VIDIOC_S_FMT, &fmt) < 0) return fail("S_FMT failed");
    width = fmt.fmt.pix.width;    // drivers may adjust; read back
    height = fmt.fmt.pix.height;
    fourcc = fmt.fmt.pix.pixelformat;
    if (fourcc != want_fourcc) return fail("format not supported by device");
    v4l2_requestbuffers rb{};
    rb.count = n_buffers;
    rb.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    rb.memory = V4L2_MEMORY_MMAP;
    if (g_shim.ioctl_(fd, VIDIOC_REQBUFS, &rb) < 0 || rb.count == 0)
      return fail("REQBUFS failed");
    buffers.resize(rb.count);
    for (uint32_t i = 0; i < rb.count; ++i) {
      v4l2_buffer b{};
      b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      b.memory = V4L2_MEMORY_MMAP;
      b.index = i;
      if (g_shim.ioctl_(fd, VIDIOC_QUERYBUF, &b) < 0)
        return fail("QUERYBUF failed");
      buffers[i].length = b.length;
      buffers[i].start = g_shim.mmap_(b.length, fd, b.m.offset);
      if (buffers[i].start == MAP_FAILED) return fail("mmap failed");
      if (g_shim.ioctl_(fd, VIDIOC_QBUF, &b) < 0) return fail("QBUF failed");
    }
    v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    if (g_shim.ioctl_(fd, VIDIOC_STREAMON, &t) < 0)
      return fail("STREAMON failed");
    return true;
  }

  // Dequeue one raw frame; returns index >= 0, -1 on end-of-stream/timeout,
  // -2 on error.  Caller must requeue with requeue(idx).
  int dequeue(uint32_t* bytesused, double* ts, int timeout_ms) {
    struct pollfd pfd {
      fd, POLLIN, 0
    };
    for (;;) {
      int pr = g_shim.poll_(&pfd, 1, timeout_ms);
      if (pr < 0) return -2;
      if (pr == 0) return -1;  // timeout: live = dropped frame; replay = EOS
      v4l2_buffer b{};
      b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      b.memory = V4L2_MEMORY_MMAP;
      if (g_shim.ioctl_(fd, VIDIOC_DQBUF, &b) < 0) {
        if (errno == EAGAIN) continue;
        return -2;
      }
      *bytesused = b.bytesused;
      *ts = b.timestamp.tv_sec + b.timestamp.tv_usec * 1e-6;
      return static_cast<int>(b.index);
    }
  }

  bool requeue(int idx) {
    v4l2_buffer b{};
    b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    b.memory = V4L2_MEMORY_MMAP;
    b.index = static_cast<uint32_t>(idx);
    return g_shim.ioctl_(fd, VIDIOC_QBUF, &b) == 0;
  }

  void close() {
    if (fd < 0) return;
    v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    g_shim.ioctl_(fd, VIDIOC_STREAMOFF, &t);
    for (auto& b : buffers)
      if (b.start && b.start != MAP_FAILED) g_shim.munmap_(b.start, b.length);
    buffers.clear();
    g_shim.close_(fd);
    fd = -1;
  }

 private:
  bool fail(const char* msg) {
    error = msg;
    if (fd >= 0) {
      g_shim.close_(fd);
      fd = -1;
    }
    return false;
  }
};

// Convert one dequeued color frame to 8-bit gray.
bool convert_gray(const V4L2Stream& s, const uint8_t* raw, uint32_t nbytes,
                  uint8_t* gray) {
  const size_t n = static_cast<size_t>(s.width) * s.height;
  switch (s.fourcc) {
    case V4L2_PIX_FMT_YUYV: {
      if (nbytes < 2 * n) return false;
      for (size_t i = 0; i < n; ++i) gray[i] = raw[2 * i];  // Y0 Y1 ...
      return true;
    }
    case V4L2_PIX_FMT_GREY: {
      if (nbytes < n) return false;
      std::memcpy(gray, raw, n);
      return true;
    }
    case V4L2_PIX_FMT_MJPEG:
    case V4L2_PIX_FMT_JPEG:
      return decode_mjpeg_gray(raw, nbytes, gray, static_cast<int>(s.width),
                               static_cast<int>(s.height));
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// Paired RGB-D sensor: color stream + depth stream with the reference's
// got_depth/got_color synchronization loop (OrbbecAstraEngineUVC.cpp:93-140:
// poll both, keep the latest of each, emit when both arrived).
// ---------------------------------------------------------------------------

struct Sensor {
  V4L2Stream color, depth;
  bool has_depth = false;
  int warmup_left = 0;  // auto-exposure warmup (realsensesensor.cpp:90)
  std::string error;
};

bool grab_one(Sensor* s, uint8_t* gray, uint16_t* depth_out, double* ts) {
  const size_t n = static_cast<size_t>(s->color.width) * s->color.height;
  bool got_color = false, got_depth = !s->has_depth;
  double ts_c = 0;
  // Bounded sync loop: keep dequeuing whichever stream is behind until one
  // frame of each has arrived (latest-wins, like the reference callbacks).
  for (int spin = 0; spin < 64 && !(got_color && got_depth); ++spin) {
    if (!got_color) {
      uint32_t used;
      double t;
      int idx = s->color.dequeue(&used, &t, 2000);
      if (idx == -1) return false;  // end-of-stream / stall
      if (idx < 0) {
        s->error = "color dequeue failed";
        return false;
      }
      bool ok = convert_gray(
          s->color, static_cast<const uint8_t*>(s->color.buffers[idx].start),
          used, gray);
      s->color.requeue(idx);
      if (!ok) {
        s->error = "color conversion failed";
        return false;
      }
      ts_c = t;
      got_color = true;
    }
    if (!got_depth) {
      uint32_t used;
      double t;
      int idx = s->depth.dequeue(&used, &t, 2000);
      if (idx == -1) return false;
      if (idx < 0) {
        s->error = "depth dequeue failed";
        return false;
      }
      const size_t nd =
          static_cast<size_t>(s->depth.width) * s->depth.height * 2;
      if (used < nd) {
        s->depth.requeue(idx);
        s->error = "short depth frame";
        return false;
      }
      std::memcpy(depth_out, s->depth.buffers[idx].start, nd);
      s->depth.requeue(idx);
      got_depth = true;
    }
  }
  if (!(got_color && got_depth)) {
    s->error = "stream sync failed";
    return false;
  }
  if (!s->has_depth) std::memset(depth_out, 0, n * 2);
  *ts = ts_c;
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Route all device syscalls through the built-in session replayer (tests) or
// back to the real kernel.
void rs_use_replay_shim(int enable) {
  g_shim = enable ? g_replay_shim
                  : SensorShim{real_open, real_ioctl, real_mmap, real_munmap,
                               real_poll, real_close};
}

// Register a recorded session file to be served at a fake device path.
// Returns 0 on success.
int rs_replay_register(const char* device_path, const char* session_file) {
  auto s = std::make_shared<ReplaySession>();
  if (!load_session(session_file, s.get())) return -1;
  std::lock_guard<std::mutex> lk(g_replay_mu);
  g_sessions[device_path] = std::move(s);
  return 0;
}

void rs_replay_clear(void) {
  std::lock_guard<std::mutex> lk(g_replay_mu);
  g_sessions.clear();
  g_replay_fds.clear();
}

// Open a paired RGB-D sensor.  depth_dev may be NULL/empty (color-only).
// fourcc: V4L2 pixel format for the color stream ('YUYV', 'MJPG', 'GREY').
// warmup: frames to discard for auto-exposure settling (the reference skips
// 30, realsensesensor.cpp:90).  Returns an opaque handle or NULL.
void* rs_open(const char* color_dev, const char* depth_dev, int width,
              int height, uint32_t color_fourcc, int warmup) {
  auto* s = new Sensor();
  if (!s->color.open(color_dev, width, height, color_fourcc)) {
    delete s;
    return nullptr;
  }
  if (depth_dev && depth_dev[0]) {
    if (!s->depth.open(depth_dev, width, height, V4L2_PIX_FMT_Z16)) {
      s->color.close();
      delete s;
      return nullptr;
    }
    s->has_depth = true;
  }
  s->warmup_left = warmup;
  return s;
}

int rs_width(void* h) { return static_cast<Sensor*>(h)->color.width; }
int rs_height(void* h) { return static_cast<Sensor*>(h)->color.height; }

// Grab the next synchronized frame pair.  gray: (H*W) u8, depth: (H*W) u16
// raw units, ts: seconds.  Returns 1 on success, 0 on end-of-stream,
// -1 on error.
int rs_grab(void* h, uint8_t* gray, uint16_t* depth, double* ts) {
  auto* s = static_cast<Sensor*>(h);
  while (s->warmup_left > 0) {
    if (!grab_one(s, gray, depth, ts)) return s->error.empty() ? 0 : -1;
    s->warmup_left--;
  }
  if (!grab_one(s, gray, depth, ts)) return s->error.empty() ? 0 : -1;
  return 1;
}

const char* rs_error(void* h) { return static_cast<Sensor*>(h)->error.c_str(); }

void rs_close(void* h) {
  auto* s = static_cast<Sensor*>(h);
  s->color.close();
  if (s->has_depth) s->depth.close();
  delete s;
}

// Depth-to-color registration: back-project each depth pixel through the
// depth intrinsics Kd = (fx, fy, cx, cy), rigid-transform by (R row-major
// 3x3, t metres), project through the color intrinsics Kc, z-buffer splat
// into the color frame (nearest surface wins).  depth_scale converts raw
// u16 units to metres; output stays in raw units.  This is the explicit
// form of OpenNI setImageRegistrationMode / rs align (the reference never
// implements it, it links against it).
void rs_register_depth(const uint16_t* depth, int dh, int dw,
                       const float* Kd, const float* Kc, const float* R,
                       const float* t, float depth_scale, int ch, int cw,
                       uint16_t* out) {
  std::memset(out, 0, static_cast<size_t>(ch) * cw * 2);
  const float fxd = Kd[0], fyd = Kd[1], cxd = Kd[2], cyd = Kd[3];
  const float fxc = Kc[0], fyc = Kc[1], cxc = Kc[2], cyc = Kc[3];
  for (int v = 0; v < dh; ++v) {
    for (int u = 0; u < dw; ++u) {
      uint16_t raw = depth[static_cast<size_t>(v) * dw + u];
      if (raw == 0) continue;
      float z = raw * depth_scale;
      float x = (u - cxd) / fxd * z;
      float y = (v - cyd) / fyd * z;
      float xc = R[0] * x + R[1] * y + R[2] * z + t[0];
      float yc = R[3] * x + R[4] * y + R[5] * z + t[1];
      float zc = R[6] * x + R[7] * y + R[8] * z + t[2];
      if (zc <= 0) continue;
      int uc = static_cast<int>(std::lround(xc / zc * fxc + cxc));
      int vc = static_cast<int>(std::lround(yc / zc * fyc + cyc));
      if (uc < 0 || vc < 0 || uc >= cw || vc >= ch) continue;
      uint16_t rz = static_cast<uint16_t>(
          std::fmin(65535.0f, std::fmax(0.0f, zc / depth_scale + 0.5f)));
      uint16_t& slot = out[static_cast<size_t>(vc) * cw + uc];
      if (slot == 0 || rz < slot) slot = rz;  // z-buffer: nearest wins
    }
  }
}

// Standalone converters (oracle tests).
int rs_yuyv_to_gray(const uint8_t* raw, int w, int h, uint8_t* gray) {
  for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i)
    gray[i] = raw[2 * i];
  return 0;
}

int rs_mjpeg_to_gray(const uint8_t* raw, int nbytes, int w, int h,
                     uint8_t* gray) {
  return decode_mjpeg_gray(raw, static_cast<size_t>(nbytes), gray, w, h) ? 0
                                                                         : -1;
}

}  // extern "C"
