// seqio — native sequence-container I/O for aruco_slam_tpu (L3 runtime).
//
// Native counterpart of the reference's native data path (cv_bridge /
// image_transport C++ image plumbing, reference src/aruco_slam_node.cpp:93-101):
// a zero-copy mmap'd binary container for recorded grayscale frame streams
// plus a multithreaded prefetcher that keeps the host->device feed ahead of
// the compute stream. Exposed as a C API consumed from Python via ctypes
// (aruco_slam_tpu/io/native_seqio.py).
//
// Format (little endian):
//   magic  u8[4] = "ASQ1"
//   n      u32   frame count
//   height u32
//   width  u32
//   crc    u32   CRC32 of the payload
//   payload: n * height * width bytes (row-major grayscale frames)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'A', 'S', 'Q', '1'};

struct Header {
  char magic[4];
  uint32_t n;
  uint32_t height;
  uint32_t width;
  uint32_t crc;
};

uint32_t crc32(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Sequence {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  Header hdr{};
  const uint8_t* payload = nullptr;

  size_t frame_bytes() const {
    return static_cast<size_t>(hdr.height) * hdr.width;
  }
};

// Threaded prefetcher: a bounded queue of frame indices decoded ahead of the
// consumer — the native analogue of image_transport's subscriber queue.
struct Prefetcher {
  Sequence* seq = nullptr;
  uint32_t next_submit = 0;
  uint32_t end = 0;
  size_t capacity = 0;
  std::deque<std::pair<uint32_t, std::vector<uint8_t>>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<uint32_t> claim{0};
  std::atomic<bool> stop{false};
  uint32_t next_emit = 0;

  void worker() {
    for (;;) {
      if (stop.load()) return;
      uint32_t idx = claim.fetch_add(1);
      if (idx >= end) return;
      // Admission control on the *claimed index*, not the queue length: a
      // queue-length bound can deadlock (the worker holding frame
      // next_emit starved of space by higher frames filling the queue).
      // Bounding idx < next_emit + capacity guarantees the in-order frame
      // always has room.
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return idx < next_emit + capacity || stop.load();
        });
        if (stop.load()) return;
      }
      std::vector<uint8_t> buf(seq->frame_bytes());
      std::memcpy(buf.data(), seq->payload + (size_t)idx * seq->frame_bytes(),
                  seq->frame_bytes());
      std::unique_lock<std::mutex> lk(mu);
      ready.emplace_back(idx, std::move(buf));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int seq_write(const char* path, const uint8_t* frames, uint32_t n,
              uint32_t height, uint32_t width) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header h;
  std::memcpy(h.magic, kMagic, 4);
  h.n = n;
  h.height = height;
  h.width = width;
  size_t payload = (size_t)n * height * width;
  h.crc = crc32(frames, payload);
  if (std::fwrite(&h, sizeof(h), 1, f) != 1 ||
      std::fwrite(frames, 1, payload, f) != payload) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  return 0;
}

void* seq_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* seq = new Sequence;
  seq->fd = fd;
  seq->map = static_cast<const uint8_t*>(map);
  seq->map_len = st.st_size;
  std::memcpy(&seq->hdr, seq->map, sizeof(Header));
  // Validate each dimension before multiplying: crafted u32 headers could
  // otherwise overflow the 64-bit product and alias a small map_len,
  // enabling out-of-bounds reads in seq_read_frame.
  constexpr uint64_t kMaxDim = 1u << 20;          // 1M px per side
  constexpr uint64_t kMaxFrames = 1u << 24;       // 16M frames
  bool dims_ok = seq->hdr.height > 0 && seq->hdr.width > 0 &&
                 seq->hdr.height <= kMaxDim && seq->hdr.width <= kMaxDim &&
                 seq->hdr.n <= kMaxFrames;
  if (std::memcmp(seq->hdr.magic, kMagic, 4) != 0 || !dims_ok ||
      seq->map_len != sizeof(Header) + (size_t)seq->hdr.n * seq->hdr.height *
                                           seq->hdr.width) {
    munmap(map, st.st_size);
    ::close(fd);
    delete seq;
    return nullptr;
  }
  seq->payload = seq->map + sizeof(Header);
  return seq;
}

int seq_info(void* handle, uint32_t* n, uint32_t* height, uint32_t* width) {
  auto* seq = static_cast<Sequence*>(handle);
  if (!seq) return -1;
  *n = seq->hdr.n;
  *height = seq->hdr.height;
  *width = seq->hdr.width;
  return 0;
}

int seq_verify(void* handle) {
  auto* seq = static_cast<Sequence*>(handle);
  if (!seq) return -1;
  size_t payload = (size_t)seq->hdr.n * seq->frame_bytes();
  return crc32(seq->payload, payload) == seq->hdr.crc ? 0 : 1;
}

int seq_read_frame(void* handle, uint32_t idx, uint8_t* out) {
  auto* seq = static_cast<Sequence*>(handle);
  if (!seq || idx >= seq->hdr.n) return -1;
  std::memcpy(out, seq->payload + (size_t)idx * seq->frame_bytes(),
              seq->frame_bytes());
  return 0;
}

void seq_close(void* handle) {
  auto* seq = static_cast<Sequence*>(handle);
  if (!seq) return;
  munmap(const_cast<uint8_t*>(seq->map), seq->map_len);
  ::close(seq->fd);
  delete seq;
}

void* seq_prefetch_start(void* handle, uint32_t start, uint32_t end,
                         uint32_t queue_capacity, int n_threads) {
  auto* seq = static_cast<Sequence*>(handle);
  if (!seq || end > seq->hdr.n || start >= end) return nullptr;
  auto* pf = new Prefetcher;
  pf->seq = seq;
  pf->end = end;
  pf->capacity = queue_capacity ? queue_capacity : 8;
  pf->claim.store(start);
  pf->next_emit = start;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++)
    pf->workers.emplace_back(&Prefetcher::worker, pf);
  return pf;
}

// Blocks until the next *in-order* frame is available; returns its index or
// -1 when the range is exhausted.
long seq_prefetch_next(void* prefetcher, uint8_t* out) {
  auto* pf = static_cast<Prefetcher*>(prefetcher);
  if (!pf) return -1;
  if (pf->next_emit >= pf->end) return -1;
  std::unique_lock<std::mutex> lk(pf->mu);
  for (;;) {
    for (auto it = pf->ready.begin(); it != pf->ready.end(); ++it) {
      if (it->first == pf->next_emit) {
        std::memcpy(out, it->second.data(), it->second.size());
        long idx = it->first;
        pf->ready.erase(it);
        pf->next_emit++;
        pf->cv_space.notify_all();
        return idx;
      }
    }
    pf->cv_ready.wait(lk);
  }
}

void seq_prefetch_stop(void* prefetcher) {
  auto* pf = static_cast<Prefetcher*>(prefetcher);
  if (!pf) return;
  {
    // The store+notify must happen under the mutex: a worker that has
    // evaluated its wait predicate (stop still false) but not yet blocked
    // would otherwise miss the notification forever and join() would hang.
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->stop.store(true);
    pf->cv_space.notify_all();
    pf->cv_ready.notify_all();
  }
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
