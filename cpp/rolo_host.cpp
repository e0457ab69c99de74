// rolo_host: native host-side ingest for the rolo_tpu SLAM engine.
//
// The reference is a C++ application whose ingest runs on PCL + the ROS
// transport (sensor_msgs deserialization in roscpp, pcl::fromROSMsg at
// imageProjection.cpp:179-263 of the reference). Here the device computes
// everything, but ingest stays native: this library decodes
// PCD / KITTI scans and ROS bag files, parses sensor_msgs/PointCloud2 and
// nav_msgs/Odometry records, and runs a background prefetch queue (the
// analog of the reference's multi-threaded spinner feeding callbacks,
// imageProjection.cpp:524) so scan decode overlaps device compute.
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PCD
// ---------------------------------------------------------------------------

struct PcdField {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
  int offset = 0;  // byte offset within a point record
};

struct PcdHeader {
  std::vector<PcdField> fields;
  int64_t points = 0;
  int point_size = 0;
  bool binary = false;
  int64_t data_offset = 0;
};

bool parse_pcd_header(std::ifstream& f, PcdHeader* out) {
  std::string line;
  std::vector<std::string> names;
  std::vector<int> sizes, counts;
  std::vector<char> types;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    char key[32];
    if (std::sscanf(line.c_str(), "%31s", key) != 1) continue;
    std::string k(key);
    const char* rest = line.c_str() + k.size();
    if (k == "FIELDS") {
      char buf[64];
      int off = 0, n = 0;
      while (std::sscanf(rest + off, "%63s%n", buf, &n) == 1) {
        names.emplace_back(buf);
        off += n;
      }
    } else if (k == "SIZE") {
      int v, off = 0, n = 0;
      while (std::sscanf(rest + off, "%d%n", &v, &n) == 1) { sizes.push_back(v); off += n; }
    } else if (k == "TYPE") {
      char c; int off = 0, n = 0;
      while (std::sscanf(rest + off, " %c%n", &c, &n) == 1) { types.push_back(c); off += n; }
    } else if (k == "COUNT") {
      int v, off = 0, n = 0;
      while (std::sscanf(rest + off, "%d%n", &v, &n) == 1) { counts.push_back(v); off += n; }
    } else if (k == "POINTS") {
      long long v;
      if (std::sscanf(rest, "%lld", &v) == 1) out->points = v;
    } else if (k == "DATA") {
      char mode[32];
      if (std::sscanf(rest, "%31s", mode) == 1) out->binary = (std::string(mode) == "binary");
      out->data_offset = f.tellg();
      break;
    }
  }
  if (names.empty() || names.size() != sizes.size() || names.size() != types.size()) return false;
  if (counts.size() != names.size()) counts.assign(names.size(), 1);
  int off = 0;
  for (size_t i = 0; i < names.size(); i++) {
    PcdField fld;
    fld.name = names[i];
    fld.size = sizes[i];
    fld.type = types[i];
    fld.count = counts[i];
    fld.offset = off;
    off += sizes[i] * counts[i];
    out->fields.push_back(fld);
  }
  out->point_size = off;
  return true;
}

float read_field_as_float(const uint8_t* p, const PcdField& f) {
  switch (f.type) {
    case 'F':
      if (f.size == 4) { float v; std::memcpy(&v, p, 4); return v; }
      if (f.size == 8) { double v; std::memcpy(&v, p, 8); return (float)v; }
      break;
    case 'U':
      if (f.size == 1) return (float)*p;
      if (f.size == 2) { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
      if (f.size == 4) { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
      break;
    case 'I':
      if (f.size == 1) return (float)*(const int8_t*)p;
      if (f.size == 2) { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
      if (f.size == 4) { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
      break;
  }
  return 0.0f;
}

// ---------------------------------------------------------------------------
// rosbag 2.0
// ---------------------------------------------------------------------------

struct BagConnection {
  std::string topic;
  std::string datatype;
};

struct BagMessage {
  int32_t conn = 0;
  uint64_t time_ns = 0;
  uint64_t offset = 0;  // offset of serialized bytes in the (decompressed) file
  uint32_t size = 0;
};

struct BagFile {
  std::vector<BagConnection> connections;
  std::vector<BagMessage> messages;
  std::vector<uint8_t> data;  // whole file (chunks are stored uncompressed)
};

struct HeaderFields {
  // tiny flat map
  std::vector<std::pair<std::string, std::string>> kv;
  const std::string* get(const char* k) const {
    for (auto& p : kv)
      if (p.first == k) return &p.second;
    return nullptr;
  }
  template <typename T>
  bool get_le(const char* k, T* out) const {
    const std::string* v = get(k);
    if (!v || v->size() < sizeof(T)) return false;
    std::memcpy(out, v->data(), sizeof(T));
    return true;
  }
};

bool parse_header(const uint8_t* buf, uint32_t len, HeaderFields* out) {
  uint32_t i = 0;
  while (i + 4 <= len) {
    uint32_t flen;
    std::memcpy(&flen, buf + i, 4);
    i += 4;
    if (i + flen > len) return false;
    const uint8_t* eq = (const uint8_t*)std::memchr(buf + i, '=', flen);
    if (!eq) return false;
    out->kv.emplace_back(std::string((const char*)buf + i, eq - (buf + i)),
                         std::string((const char*)eq + 1, buf + i + flen - eq - 1));
    i += flen;
  }
  return true;
}

bool index_bag(const std::string& path, BagFile* bag) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  f.seekg(0, std::ios::end);
  int64_t fsize = f.tellg();
  f.seekg(0);
  std::string magic;
  std::getline(f, magic);
  if (magic.rfind("#ROSBAG V2.0", 0) != 0) return false;
  bag->data.resize(fsize);
  f.seekg(0);
  f.read((char*)bag->data.data(), fsize);

  int64_t pos = magic.size() + 1;
  auto read_u32 = [&](int64_t p) {
    uint32_t v;
    std::memcpy(&v, bag->data.data() + p, 4);
    return v;
  };

  // walk top-level records; descend into uncompressed chunks
  std::vector<std::pair<int64_t, int64_t>> spans;  // (start, end) regions to scan
  spans.emplace_back(pos, fsize);
  while (!spans.empty()) {
    auto [p, end] = spans.back();
    spans.pop_back();
    while (p + 8 <= end) {
      uint32_t hlen = read_u32(p);
      if (p + 4 + hlen + 4 > end) break;
      HeaderFields h;
      if (!parse_header(bag->data.data() + p + 4, hlen, &h)) break;
      uint32_t dlen = read_u32(p + 4 + hlen);
      int64_t dstart = p + 8 + hlen;
      if (dstart + dlen > end) break;
      uint8_t op = 0;
      if (const std::string* v = h.get("op"); v && !v->empty()) op = (uint8_t)(*v)[0];

      if (op == 0x05) {  // chunk
        const std::string* comp = h.get("compression");
        if (comp && *comp == "none") {
          spans.emplace_back(dstart, dstart + dlen);
        }
        // compressed chunks (bz2/lz4) are skipped: the reference fixture
        // and the common datasets here are uncompressed
      } else if (op == 0x07) {  // connection
        uint32_t conn_id = 0;
        h.get_le("conn", &conn_id);
        HeaderFields ch;
        parse_header(bag->data.data() + dstart, dlen, &ch);
        if (bag->connections.size() <= conn_id) bag->connections.resize(conn_id + 1);
        if (const std::string* t = h.get("topic")) bag->connections[conn_id].topic = *t;
        if (const std::string* t = ch.get("type")) bag->connections[conn_id].datatype = *t;
      } else if (op == 0x02) {  // message data
        BagMessage m;
        h.get_le("conn", &m.conn);
        uint64_t packed = 0;  // rosbag time: uint32 sec (low) + uint32 nsec (high)
        h.get_le("time", &packed);
        uint64_t sec = packed & 0xffffffffu;
        uint64_t nsec = packed >> 32;
        m.time_ns = sec * 1000000000ull + nsec;
        m.offset = dstart;
        m.size = dlen;
        bag->messages.push_back(m);
      }
      p = dstart + dlen;
    }
  }
  // index order = chunk order; sort by time for replay
  std::stable_sort(bag->messages.begin(), bag->messages.end(),
                   [](const BagMessage& a, const BagMessage& b) { return a.time_ns < b.time_ns; });
  return true;
}

// --- ROS message walkers (little-endian serialized streams) ---------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  template <typename T>
  T take() {
    T v{};
    if (p + sizeof(T) > end) { ok = false; return v; }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  void skip(size_t n) {
    if (p + n > end) { ok = false; return; }
    p += n;
  }
  std::string take_string() {
    uint32_t n = take<uint32_t>();
    if (!ok || p + n > end) { ok = false; return {}; }
    std::string s((const char*)p, n);
    p += n;
    return s;
  }
};

double take_header_stamp(Cursor& c) {
  c.take<uint32_t>();  // seq
  uint32_t sec = c.take<uint32_t>();
  uint32_t nsec = c.take<uint32_t>();
  c.take_string();  // frame_id
  return (double)sec + 1e-9 * (double)nsec;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// PCD API
// ---------------------------------------------------------------------------

// Returns point count, or -1 on error.
int64_t rolo_pcd_count(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  PcdHeader h;
  if (!parse_pcd_header(f, &h)) return -1;
  return h.points;
}

// Reads up to `cap` points. Fills xyz [cap*3]; optional intensity / ring /
// time arrays (pass nullptr to skip; zero-filled when the file lacks the
// field; "t" and "time" both map to time, "ring" to ring — the reference's
// Velodyne/Ouster point types, utility.h:68-95). Returns points read.
int64_t rolo_pcd_read(const char* path, float* xyz, float* intensity,
                      int32_t* ring, float* time_arr, int64_t cap) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  PcdHeader h;
  if (!parse_pcd_header(f, &h)) return -1;
  int64_t n = h.points < cap ? h.points : cap;

  const PcdField *fx = nullptr, *fy = nullptr, *fz = nullptr, *fi = nullptr,
                 *fr = nullptr, *ft = nullptr;
  for (auto& fld : h.fields) {
    if (fld.name == "x") fx = &fld;
    else if (fld.name == "y") fy = &fld;
    else if (fld.name == "z") fz = &fld;
    else if (fld.name == "intensity") fi = &fld;
    else if (fld.name == "ring") fr = &fld;
    else if (fld.name == "t" || fld.name == "time" || fld.name == "timestamp") ft = &fld;
  }
  if (!fx || !fy || !fz) return -1;

  if (h.binary) {
    std::vector<uint8_t> buf(h.point_size);
    f.seekg(h.data_offset);
    for (int64_t i = 0; i < n; i++) {
      f.read((char*)buf.data(), h.point_size);
      if (!f) return i;
      xyz[i * 3 + 0] = read_field_as_float(buf.data() + fx->offset, *fx);
      xyz[i * 3 + 1] = read_field_as_float(buf.data() + fy->offset, *fy);
      xyz[i * 3 + 2] = read_field_as_float(buf.data() + fz->offset, *fz);
      if (intensity) intensity[i] = fi ? read_field_as_float(buf.data() + fi->offset, *fi) : 0.0f;
      if (ring) ring[i] = fr ? (int32_t)read_field_as_float(buf.data() + fr->offset, *fr) : 0;
      if (time_arr) time_arr[i] = ft ? read_field_as_float(buf.data() + ft->offset, *ft) : 0.0f;
    }
    return n;
  }
  // ascii
  int ncols = 0;
  std::vector<const PcdField*> cols;
  for (auto& fld : h.fields)
    for (int c = 0; c < fld.count; c++) cols.push_back(&fld);
  ncols = (int)cols.size();
  std::vector<double> row(ncols);
  for (int64_t i = 0; i < n; i++) {
    for (int c = 0; c < ncols; c++)
      if (!(f >> row[c])) return i;
    auto get = [&](const PcdField* fld) -> double {
      for (int c = 0; c < ncols; c++)
        if (cols[c] == fld) return row[c];
      return 0.0;
    };
    xyz[i * 3 + 0] = (float)get(fx);
    xyz[i * 3 + 1] = (float)get(fy);
    xyz[i * 3 + 2] = (float)get(fz);
    if (intensity) intensity[i] = fi ? (float)get(fi) : 0.0f;
    if (ring) ring[i] = fr ? (int32_t)get(fr) : 0;
    if (time_arr) time_arr[i] = ft ? (float)get(ft) : 0.0f;
  }
  return n;
}

// ---------------------------------------------------------------------------
// KITTI .bin
// ---------------------------------------------------------------------------

int64_t rolo_kitti_read(const char* path, float* xyzi, int64_t cap) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  f.seekg(0, std::ios::end);
  int64_t n = (int64_t)f.tellg() / 16;
  if (n > cap) n = cap;
  f.seekg(0);
  f.read((char*)xyzi, n * 16);
  return f ? n : -1;
}

// ---------------------------------------------------------------------------
// rosbag API
// ---------------------------------------------------------------------------

void* rolo_bag_open(const char* path) {
  auto* bag = new BagFile();
  if (!index_bag(path, bag)) {
    delete bag;
    return nullptr;
  }
  return bag;
}

void rolo_bag_close(void* h) { delete (BagFile*)h; }

int32_t rolo_bag_num_connections(void* h) { return (int32_t)((BagFile*)h)->connections.size(); }

int32_t rolo_bag_connection_info(void* h, int32_t idx, char* topic, int32_t topic_cap,
                                 char* datatype, int32_t type_cap) {
  auto* bag = (BagFile*)h;
  if (idx < 0 || idx >= (int32_t)bag->connections.size()) return -1;
  std::snprintf(topic, topic_cap, "%s", bag->connections[idx].topic.c_str());
  std::snprintf(datatype, type_cap, "%s", bag->connections[idx].datatype.c_str());
  return 0;
}

int64_t rolo_bag_num_messages(void* h) { return (int64_t)((BagFile*)h)->messages.size(); }

// Fills conn id and receive time (seconds) for message `idx`.
int32_t rolo_bag_message_info(void* h, int64_t idx, int32_t* conn, double* time_sec,
                              int64_t* size) {
  auto* bag = (BagFile*)h;
  if (idx < 0 || idx >= (int64_t)bag->messages.size()) return -1;
  const BagMessage& m = bag->messages[idx];
  *conn = m.conn;
  *time_sec = 1e-9 * (double)m.time_ns;
  *size = m.size;
  return 0;
}

// nav_msgs/Odometry -> stamp + pose (x y z qx qy qz qw) + twist (v w).
int32_t rolo_bag_read_odometry(void* h, int64_t idx, double* stamp, double* pose7,
                               double* twist6) {
  auto* bag = (BagFile*)h;
  if (idx < 0 || idx >= (int64_t)bag->messages.size()) return -1;
  const BagMessage& m = bag->messages[idx];
  Cursor c{bag->data.data() + m.offset, bag->data.data() + m.offset + m.size};
  *stamp = take_header_stamp(c);
  c.take_string();  // child_frame_id
  for (int i = 0; i < 7; i++) pose7[i] = c.take<double>();
  c.skip(36 * 8);  // pose covariance
  for (int i = 0; i < 6; i++) twist6[i] = c.take<double>();
  return c.ok ? 0 : -1;
}

// sensor_msgs/PointCloud2 -> stamp + xyz/intensity/ring/time arrays.
// Returns number of points written (<= cap), or -1 on parse error.
int64_t rolo_bag_read_pointcloud2(void* h, int64_t idx, double* stamp, float* xyz,
                                  float* intensity, int32_t* ring, float* time_arr,
                                  int64_t cap) {
  auto* bag = (BagFile*)h;
  if (idx < 0 || idx >= (int64_t)bag->messages.size()) return -1;
  const BagMessage& m = bag->messages[idx];
  Cursor c{bag->data.data() + m.offset, bag->data.data() + m.offset + m.size};
  *stamp = take_header_stamp(c);
  uint32_t height = c.take<uint32_t>();
  uint32_t width = c.take<uint32_t>();
  uint32_t nfields = c.take<uint32_t>();
  struct F {
    std::string name;
    uint32_t offset;
    uint8_t dt;
  };
  std::vector<F> fs(nfields);
  for (auto& fld : fs) {
    fld.name = c.take_string();
    fld.offset = c.take<uint32_t>();
    fld.dt = c.take<uint8_t>();
    c.take<uint32_t>();  // count
  }
  c.take<uint8_t>();  // is_bigendian
  uint32_t point_step = c.take<uint32_t>();
  c.take<uint32_t>();  // row_step
  uint32_t dlen = c.take<uint32_t>();
  if (!c.ok || c.p + dlen > c.end) return -1;
  const uint8_t* data = c.p;

  auto find = [&](std::initializer_list<const char*> names) -> const F* {
    for (const char* n : names)
      for (auto& fld : fs)
        if (fld.name == n) return &fld;
    return nullptr;
  };
  const F* fx = find({"x"});
  const F* fy = find({"y"});
  const F* fz = find({"z"});
  const F* fi = find({"intensity"});
  const F* fr = find({"ring"});
  const F* ft = find({"t", "time", "timestamp", "time_stamp"});
  if (!fx || !fy || !fz || point_step == 0) return -1;

  auto as_float = [&](const uint8_t* p, const F* f) -> float {
    switch (f->dt) {  // sensor_msgs/PointField datatype codes
      case 1: return (float)*(const int8_t*)p;
      case 2: return (float)*p;
      case 3: { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
      case 4: { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
      case 5: { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
      case 6: { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
      case 7: { float v; std::memcpy(&v, p, 4); return v; }
      case 8: { double v; std::memcpy(&v, p, 8); return (float)v; }
    }
    return 0.0f;
  };

  int64_t total = (int64_t)height * width;
  int64_t avail = dlen / point_step;
  if (total > avail) total = avail;
  if (total > cap) total = cap;
  for (int64_t i = 0; i < total; i++) {
    const uint8_t* p = data + i * point_step;
    xyz[i * 3 + 0] = as_float(p + fx->offset, fx);
    xyz[i * 3 + 1] = as_float(p + fy->offset, fy);
    xyz[i * 3 + 2] = as_float(p + fz->offset, fz);
    if (intensity) intensity[i] = fi ? as_float(p + fi->offset, fi) : 0.0f;
    if (ring) ring[i] = fr ? (int32_t)as_float(p + fr->offset, fr) : 0;
    if (time_arr) time_arr[i] = ft ? as_float(p + ft->offset, ft) : 0.0f;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Prefetch queue: background thread decodes scan files ahead of the device
// ---------------------------------------------------------------------------

struct ScanSlot {
  std::vector<float> xyz;
  std::vector<float> intensity;
  std::vector<int32_t> ring;
  std::vector<float> time_arr;
  int64_t n = 0;
  int64_t file_index = 0;
};

struct ScanQueue {
  std::vector<std::string> paths;
  int format;  // 0 = pcd, 1 = kitti bin
  int64_t cap;
  size_t depth;
  std::vector<ScanSlot> slots;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t head = 0, tail = 0, count = 0;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};
  std::thread worker;

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); i++) {
      ScanSlot local;
      local.xyz.resize(cap * 3);
      local.intensity.resize(cap);
      local.ring.resize(cap);
      local.time_arr.resize(cap);
      local.file_index = (int64_t)i;
      if (format == 0) {
        local.n = rolo_pcd_read(paths[i].c_str(), local.xyz.data(), local.intensity.data(),
                                local.ring.data(), local.time_arr.data(), cap);
      } else {
        std::vector<float> xyzi(cap * 4);
        int64_t n = rolo_kitti_read(paths[i].c_str(), xyzi.data(), cap);
        local.n = n;
        for (int64_t j = 0; j < n; j++) {
          local.xyz[j * 3 + 0] = xyzi[j * 4 + 0];
          local.xyz[j * 3 + 1] = xyzi[j * 4 + 1];
          local.xyz[j * 3 + 2] = xyzi[j * 4 + 2];
          local.intensity[j] = xyzi[j * 4 + 3];
          local.ring[j] = 0;
          local.time_arr[j] = 0.0f;
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return count < depth || stop.load(); });
      if (stop.load()) return;
      slots[tail] = std::move(local);
      tail = (tail + 1) % depth;
      count++;
      cv_pop.notify_one();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done.store(true);
    }
    cv_pop.notify_all();
  }
};

void* rolo_queue_create(const char** paths, int64_t n_paths, int32_t format, int64_t cap,
                        int32_t depth) {
  auto* q = new ScanQueue();
  for (int64_t i = 0; i < n_paths; i++) q->paths.emplace_back(paths[i]);
  q->format = format;
  q->cap = cap;
  q->depth = depth > 0 ? (size_t)depth : 4;
  q->slots.resize(q->depth);
  q->worker = std::thread([q] { q->run(); });
  return q;
}

// Blocks until the next scan is ready. Returns point count, or -1 when the
// stream is exhausted. file_index receives the source file's position.
int64_t rolo_queue_pop(void* h, float* xyz, float* intensity, int32_t* ring,
                       float* time_arr, int64_t cap, int64_t* file_index) {
  auto* q = (ScanQueue*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_pop.wait(lk, [&] { return q->count > 0 || q->done.load() || q->stop.load(); });
  if (q->count == 0) return -1;  // exhausted or stopping
  ScanSlot& s = q->slots[q->head];
  int64_t n = s.n < cap ? s.n : cap;
  if (n > 0) {
    std::memcpy(xyz, s.xyz.data(), n * 3 * sizeof(float));
    if (intensity) std::memcpy(intensity, s.intensity.data(), n * sizeof(float));
    if (ring) std::memcpy(ring, s.ring.data(), n * sizeof(int32_t));
    if (time_arr) std::memcpy(time_arr, s.time_arr.data(), n * sizeof(float));
  }
  if (file_index) *file_index = s.file_index;
  q->head = (q->head + 1) % q->depth;
  q->count--;
  q->cv_push.notify_one();
  return n;
}

void rolo_queue_destroy(void* h) {
  auto* q = (ScanQueue*)h;
  q->stop.store(true);
  q->cv_push.notify_all();
  if (q->worker.joinable()) q->worker.join();
  delete q;
}

}  // extern "C"
