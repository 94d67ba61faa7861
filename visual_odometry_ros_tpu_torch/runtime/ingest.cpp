// Native frame-ingest runtime: threaded decode + bounded prefetch queue.
//
// The port's copy of visual_odometry_ros_tpu/runtime/ingest.cpp, same C ABI
// and return codes. Where the reference ingests frames through ROS topics
// with a subscriber queue and message_filters stereo sync (ros1/
// visual_odometry/stereo_vo_ros1.cpp:14-20), this library decodes image
// files on a worker thread ahead of the device step and hands out
// stereo-synced frame pairs through a lock-guarded bounded queue, keeping
// the Python driver (and the GPU) free of decode latency.
//
// Decoders: 8-bit grayscale/RGB/RGBA PNG (zlib inflate + per-scanline
// unfilter) and binary PGM (P5). Output is always float32 grayscale
// (RGB -> BT.601 luma), matching the pipelines' expected input.
//
// Build: runtime/ingest.py `build()` (g++ -O3 -std=c++17 -shared -fPIC ... -lz -lpthread).

#include <zlib.h>

#include <atomic>
#include <cctype>
#include <cstdlib>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> gray;  // height * width, 0..255
  bool ok = false;
  std::string error;
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = std::fread(out.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0) {
    img.error = "not a png";
    return img;
  }
  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = read_be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) break;
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      width = int(read_be32(data));
      height = int(read_be32(data + 4));
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0) {
    img.error = "bad ihdr";
    return img;
  }
  if (bit_depth != 8 || interlace != 0 ||
      !(color_type == 0 || color_type == 2 || color_type == 6 || color_type == 4)) {
    img.error = "unsupported png variant (need 8-bit non-interlaced gray/rgb)";
    return img;
  }
  int channels = color_type == 0 ? 1 : color_type == 4 ? 2 : color_type == 2 ? 3 : 4;
  size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw(size_t(height) * (stride + 1));
  uLongf raw_len = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) != Z_OK ||
      raw_len != raw.size()) {
    img.error = "zlib inflate failed";
    return img;
  }
  // Unfilter scanlines in place into `pix`.
  std::vector<uint8_t> pix(size_t(height) * stride);
  for (int y = 0; y < height; ++y) {
    uint8_t filter = raw[size_t(y) * (stride + 1)];
    const uint8_t* src = &raw[size_t(y) * (stride + 1) + 1];
    uint8_t* dst = &pix[size_t(y) * stride];
    const uint8_t* up = y > 0 ? &pix[size_t(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(channels) ? dst[x - channels] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(channels)) ? up[x - channels] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          img.error = "bad filter byte";
          return img;
      }
      dst[x] = uint8_t(v);
    }
  }
  img.width = width;
  img.height = height;
  img.gray.resize(size_t(width) * height);
  if (channels == 1) {
    for (size_t i = 0; i < img.gray.size(); ++i) img.gray[i] = float(pix[i]);
  } else if (channels == 2) {  // gray + alpha
    for (size_t i = 0; i < img.gray.size(); ++i) img.gray[i] = float(pix[2 * i]);
  } else {
    for (size_t i = 0; i < img.gray.size(); ++i) {
      const uint8_t* p = &pix[i * channels];
      img.gray[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  }
  img.ok = true;
  return img;
}

Image decode_pgm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P' || buf[1] != '5') {
    img.error = "not a P5 pgm";
    return img;
  }
  size_t pos = 2;
  int vals[3];  // width, height, maxval
  for (int v = 0; v < 3; ++v) {
    // skip whitespace + comments
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else if (std::isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
    int x = 0;
    while (pos < buf.size() && std::isdigit(buf[pos])) x = x * 10 + (buf[pos++] - '0');
    vals[v] = x;
  }
  ++pos;  // single whitespace after maxval
  if (vals[0] <= 0 || vals[1] <= 0 || vals[2] <= 0 || vals[2] > 255) {
    img.error = "bad pgm header";
    return img;
  }
  size_t n = size_t(vals[0]) * vals[1];
  if (pos + n > buf.size()) {
    img.error = "pgm truncated";
    return img;
  }
  img.width = vals[0];
  img.height = vals[1];
  img.gray.resize(n);
  for (size_t i = 0; i < n; ++i) img.gray[i] = float(buf[pos + i]);
  img.ok = true;
  return img;
}

Image decode_path(const std::string& path) {
  std::vector<uint8_t> buf;
  if (!read_file(path.c_str(), buf)) {
    Image img;
    img.error = "cannot read " + path;
    return img;
  }
  if (buf.size() >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png(buf);
  return decode_pgm(buf);
}

// ---------------------------------------------------------------------------
// Prefetching stereo sequence
// ---------------------------------------------------------------------------

struct FramePair {
  int index = -1;
  Image left;
  Image right;  // unused in mono mode (width == 0)
};

struct Sequence {
  std::vector<std::string> left_paths;
  std::vector<std::string> right_paths;  // empty => mono
  size_t queue_depth = 4;

  std::deque<FramePair> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::atomic<int> next_decode{0};
  std::thread worker;

  void run() {
    for (int i = 0; i < int(left_paths.size()) && !stop.load(); ++i) {
      FramePair fp;
      fp.index = i;
      fp.left = decode_path(left_paths[size_t(i)]);
      if (!right_paths.empty()) fp.right = decode_path(right_paths[size_t(i)]);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < queue_depth || stop.load(); });
      if (stop.load()) return;
      queue.push_back(std::move(fp));
      cv_pop.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    FramePair done;
    done.index = -2;  // end marker
    queue.push_back(std::move(done));
    cv_pop.notify_one();
  }
};

}  // namespace

extern "C" {

// Opens a sequence: `paths` is a NUL-separated, double-NUL-terminated list of
// left paths; `right_paths` likewise or nullptr for mono. Returns a handle.
void* vo_ingest_open(const char* paths, const char* right_paths, int queue_depth) {
  auto* seq = new Sequence();
  auto split = [](const char* p, std::vector<std::string>& out) {
    if (!p) return;
    while (*p) {
      out.emplace_back(p);
      p += out.back().size() + 1;
    }
  };
  split(paths, seq->left_paths);
  split(right_paths, seq->right_paths);
  if (!seq->right_paths.empty() && seq->right_paths.size() != seq->left_paths.size()) {
    delete seq;
    return nullptr;
  }
  seq->queue_depth = queue_depth > 0 ? size_t(queue_depth) : 4;
  seq->worker = std::thread([seq] { seq->run(); });
  return seq;
}

// Blocks for the next decoded pair. Returns the frame index, -2 at end of
// sequence, or -1 on decode error (error text via vo_ingest_error).
// On success copies float32 grayscale into out_left/out_right (each of
// capacity cap_h*cap_w) and writes the dims.
int vo_ingest_next(void* handle, float* out_left, float* out_right, int cap_h, int cap_w,
                   int* out_h, int* out_w) {
  auto* seq = static_cast<Sequence*>(handle);
  FramePair fp;
  {
    std::unique_lock<std::mutex> lk(seq->mu);
    seq->cv_pop.wait(lk, [&] { return !seq->queue.empty(); });
    fp = std::move(seq->queue.front());
    seq->queue.pop_front();
    seq->cv_push.notify_one();
  }
  if (fp.index == -2) return -2;
  if (!fp.left.ok) return -1;
  if (fp.left.height > cap_h || fp.left.width > cap_w) return -1;
  *out_h = fp.left.height;
  *out_w = fp.left.width;
  std::memcpy(out_left, fp.left.gray.data(), fp.left.gray.size() * sizeof(float));
  if (!seq->right_paths.empty()) {
    if (!fp.right.ok || fp.right.height != fp.left.height || fp.right.width != fp.left.width)
      return -1;
    std::memcpy(out_right, fp.right.gray.data(), fp.right.gray.size() * sizeof(float));
  }
  return fp.index;
}

void vo_ingest_close(void* handle) {
  auto* seq = static_cast<Sequence*>(handle);
  seq->stop.store(true);
  seq->cv_push.notify_all();
  if (seq->worker.joinable()) seq->worker.join();
  delete seq;
}

// One-shot decode for tools/tests: returns 0 on success.
int vo_decode_image(const char* path, float* out, int cap_h, int cap_w, int* out_h, int* out_w) {
  Image img = decode_path(path);
  if (!img.ok || img.height > cap_h || img.width > cap_w) return 1;
  *out_h = img.height;
  *out_w = img.width;
  std::memcpy(out, img.gray.data(), img.gray.size() * sizeof(float));
  return 0;
}

}  // extern "C"
