// Native data-loading runtime for the vloam pipeline.
//
// Replaces the reference's C++ host IO (point_cloud_util.cpp
// loadPointCloud :118-146 and the rosbag feed): a direct velodyne .bin
// reader plus a multi-threaded prefetching sequence loader that keeps the
// next frames parsed and padded while the device computes the current one.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read one KITTI velodyne .bin (x,y,z,reflectance float32 records) into
// out_xyz[max_pts*3]; returns the number of points written, or -1 on error.
int load_bin(const char* path, float* out_xyz, int max_pts) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> buf(1 << 16);
  int n = 0;
  size_t got;
  size_t carry = 0;
  while ((got = std::fread(buf.data() + carry, sizeof(float),
                           buf.size() - carry, f)) > 0 ||
         carry >= 4) {
    size_t avail = carry + got;
    size_t recs = avail / 4;
    for (size_t r = 0; r < recs && n < max_pts; ++r) {
      out_xyz[3 * n + 0] = buf[4 * r + 0];
      out_xyz[3 * n + 1] = buf[4 * r + 1];
      out_xyz[3 * n + 2] = buf[4 * r + 2];
      ++n;
    }
    carry = avail - recs * 4;
    if (carry) std::memmove(buf.data(), buf.data() + recs * 4,
                            carry * sizeof(float));
    if (got == 0) break;
    if (n >= max_pts) {
      // drain remaining file size for a correct total? capacity reached:
      break;
    }
  }
  std::fclose(f);
  return n;
}

// Project one velodyne .bin onto a [n_scans, n_az] quantized range image
// (the engine's smallest-bytes ingest; see lidar/scan_registration.py
// register_scan_polar). Ring assignment follows the reference's
// elevation-angle formulas (scan_registration.cpp:192-226); azimuth columns
// match the device decode grid az = -2*pi*k/n_az; bin collisions keep the
// NEARER return. Returns the number of projected points, or -1 on error.
int project_polar(const char* path, unsigned short* out, int n_scans,
                  int n_az, float range_scale, float min_range) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::memset(out, 0, sizeof(unsigned short) * n_scans * n_az);
  std::vector<float> buf(1 << 16);
  const double two_pi = 6.283185307179586;
  int n = 0;
  size_t got, carry = 0;
  while ((got = std::fread(buf.data() + carry, sizeof(float),
                           buf.size() - carry, f)) > 0 ||
         carry >= 4) {
    size_t avail = carry + got;
    size_t recs = avail / 4;
    for (size_t r = 0; r < recs; ++r) {
      float x = buf[4 * r + 0], y = buf[4 * r + 1], z = buf[4 * r + 2];
      double rxy = std::sqrt(double(x) * x + double(y) * y);
      double range = std::sqrt(rxy * rxy + double(z) * z);
      if (range < min_range) continue;
      double angle = std::atan2(double(z), rxy) * 57.29577951308232;
      int ring;
      if (n_scans == 64) {
        if (angle > 2.0 || angle < -24.33) continue;
        ring = (angle >= -8.83) ? int((2.0 - angle) * 3.0 + 0.5)
                                : 32 + int((-8.83 - angle) * 2.0 + 0.5);
        if (ring < 0 || ring > 50) continue;
      } else if (n_scans == 32) {
        ring = int((angle + 92.0 / 3.0) * 3.0 / 4.0);
        if (ring < 0 || ring >= n_scans) continue;
      } else {  // 16
        ring = int((angle + 15.0) / 2.0 + 0.5);
        if (ring < 0 || ring >= n_scans) continue;
      }
      double az = -std::atan2(double(y), double(x));
      if (az < 0) az += two_pi;
      int col = int(az / two_pi * n_az + 0.5);
      if (col >= n_az) col -= n_az;
      double q = range / range_scale + 0.5;
      unsigned short qr = q >= 65535.0 ? 65535 : (unsigned short)(q < 1.0 ? 1 : q);
      unsigned short& cell = out[ring * n_az + col];
      if (cell == 0 || qr < cell) cell = qr;
      ++n;
    }
    carry = avail - recs * 4;
    if (carry) std::memmove(buf.data(), buf.data() + recs * 4,
                            carry * sizeof(float));
    if (got == 0) break;
  }
  std::fclose(f);
  return n;
}

struct Frame {
  int index;
  int count;
  std::vector<float> xyz;          // padded to max_pts*3 (xyz mode)
  std::vector<unsigned short> img; // n_scans*n_az (polar mode)
};

struct Loader {
  std::vector<std::string> paths;
  int max_pts;
  // polar mode: project to range images instead of xyz buffers
  bool polar = false;
  int n_scans = 64, n_az = 1800;
  float range_scale = 0.005f, min_range = 0.0f;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::queue<Frame> ready;          // frames parsed, FIFO by submission order
  std::atomic<int> next_submit{0};  // next index to read
  int next_emit = 0;                // next index to hand to python
  std::vector<Frame> out_of_order;  // parsed but waiting for order
  size_t max_queue;
  bool stop = false;

  // Polar config must be set before the worker threads start (they read
  // `polar` immediately), hence constructor parameters, not post-set fields.
  Loader(std::vector<std::string> p, int mp, int n_threads,
         bool polar_mode = false, int scans = 64, int az = 1800,
         float scale = 0.005f, float minr = 0.0f)
      : paths(std::move(p)), max_pts(mp), polar(polar_mode), n_scans(scans),
        n_az(az), range_scale(scale), min_range(minr),
        max_queue(4 + n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    for (;;) {
      int idx = next_submit.fetch_add(1);
      if (idx >= static_cast<int>(paths.size())) return;
      Frame fr;
      fr.index = idx;
      if (polar) {
        fr.img.assign(static_cast<size_t>(n_scans) * n_az, 0);
        fr.count = project_polar(paths[idx].c_str(), fr.img.data(), n_scans,
                                 n_az, range_scale, min_range);
      } else {
        fr.xyz.assign(static_cast<size_t>(max_pts) * 3, 0.0f);
        fr.count = load_bin(paths[idx].c_str(), fr.xyz.data(), max_pts);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [this] {
        return stop || ready.size() + out_of_order.size() < max_queue * 2;
      });
      if (stop) return;
      out_of_order.push_back(std::move(fr));
      // move any in-order frames to the ready queue
      bool moved = true;
      while (moved) {
        moved = false;
        for (size_t i = 0; i < out_of_order.size(); ++i) {
          if (out_of_order[i].index ==
              next_emit + static_cast<int>(ready.size())) {
            ready.push(std::move(out_of_order[i]));
            out_of_order.erase(out_of_order.begin() + i);
            moved = true;
            break;
          }
        }
      }
      cv_ready.notify_all();
    }
  }

  // Returns count (>=0) and fills out; -2 when the sequence is exhausted.
  int next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_emit >= static_cast<int>(paths.size())) return -2;
    cv_ready.wait(lk, [this] { return stop || !ready.empty(); });
    if (stop) return -3;
    Frame fr = std::move(ready.front());
    ready.pop();
    ++next_emit;
    cv_ready.notify_all();
    lk.unlock();
    std::memcpy(out, fr.xyz.data(),
                static_cast<size_t>(max_pts) * 3 * sizeof(float));
    return fr.count;
  }

  int next_polar(unsigned short* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_emit >= static_cast<int>(paths.size())) return -2;
    cv_ready.wait(lk, [this] { return stop || !ready.empty(); });
    if (stop) return -3;
    Frame fr = std::move(ready.front());
    ready.pop();
    ++next_emit;
    cv_ready.notify_all();
    lk.unlock();
    std::memcpy(out, fr.img.data(),
                static_cast<size_t>(n_scans) * n_az * sizeof(unsigned short));
    return fr.count;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

int vloam_load_bin(const char* path, float* out_xyz, int max_pts) {
  return load_bin(path, out_xyz, max_pts);
}

void* vloam_loader_create(const char** paths, int n_paths, int max_pts,
                          int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Loader(std::move(p), max_pts, n_threads);
}

int vloam_project_polar(const char* path, unsigned short* out, int n_scans,
                        int n_az, float range_scale, float min_range) {
  return project_polar(path, out, n_scans, n_az, range_scale, min_range);
}

void* vloam_polar_loader_create(const char** paths, int n_paths, int n_scans,
                                int n_az, float range_scale, float min_range,
                                int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Loader(std::move(p), 0, n_threads, true, n_scans, n_az,
                    range_scale, min_range);
}

int vloam_polar_loader_next(void* handle, unsigned short* out) {
  return static_cast<Loader*>(handle)->next_polar(out);
}

int vloam_loader_next(void* handle, float* out_xyz) {
  return static_cast<Loader*>(handle)->next(out_xyz);
}

void vloam_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
