// Batch I/O of the decoded-crop snapshot cache
// (distributed_vgg_f_tpu_torch/data/snapshot_cache.py): the warm path's
// reads of one batch's payloads from the store's pack, each into its place
// in the caller's batch buffer with its crc32 checked, and the cold path's
// crc32s of the items it captures. One call covers a whole batch and runs
// its items over a few threads, so the Python caller releases its
// interpreter lock once a batch instead of twice an item.
//
// crc32 is zlib's (the reflected polynomial 0xEDB88320, the value
// zlib.crc32 returns), computed slicing-by-8: the store's index holds
// zlib's values, so stores written by either package read in both.
//
// Build: data/native_build.py compiles this file with g++ -O3
// -march=native -pthread into build/native/.

#include <errno.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32Tables kCrc;

uint32_t crc32_update(uint32_t crc, const uint8_t* p, int64_t n) {
  const auto& t = kCrc.t;
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// 0 whole, 1 short (end of file), 3 I/O error
int read_full(int fd, uint8_t* dst, int64_t n, int64_t off) {
  while (n > 0) {
    ssize_t r = pread(fd, dst, static_cast<size_t>(n), off);
    if (r < 0) {
      if (errno == EINTR) continue;
      return 3;
    }
    if (r == 0) return 1;
    dst += r;
    n -= r;
    off += r;
  }
  return 0;
}

// Runs body(i) for i in [0, count) over up to `threads` threads, items
// claimed in runs of 8.
template <typename Body>
void for_items(int64_t count, int32_t threads, Body body) {
  int64_t workers = std::max<int64_t>(1, std::min<int64_t>(threads, count));
  std::atomic<int64_t> next{0};
  auto run = [&]() {
    for (;;) {
      int64_t start = next.fetch_add(8);
      if (start >= count) return;
      for (int64_t i = start; i < std::min(count, start + 8); ++i) body(i);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t w = 1; w < workers; ++w) pool.emplace_back(run);
  run();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Bumped on every change of the exports below; checked by the binding
// (data/native_snapshot.py SNAPSHOT_ABI_VERSION).
int64_t dvgg_snapshot_abi_version() { return 1; }

// crcs[i] = crc32 of the lengths[i] bytes at base + offsets[i], for each of
// `count` items, over up to `threads` threads.
void dvgg_snapshot_crc32_many(const uint8_t* base, int64_t count,
                              const int64_t* offsets, const int64_t* lengths,
                              int64_t* crcs, int32_t threads) {
  for_items(count, threads, [&](int64_t i) {
    crcs[i] = crc32_update(0, base + offsets[i], lengths[i]);
  });
}

// For each of `count` items: pread lengths[i] bytes at offsets[i] of `fd`
// into dst + dst_offsets[i], then check their crc32 against crcs[i]. status[i]: 0 good, 1 short read, 2 crc mismatch, 3 I/O
// error. Returns the number of items that are not good.
int64_t dvgg_snapshot_gather(int32_t fd, int64_t count, const int64_t* offsets,
                             const int64_t* lengths, const int64_t* crcs,
                             const int64_t* dst_offsets, uint8_t* dst,
                             int32_t threads, int32_t* status) {
  std::atomic<int64_t> bad{0};
  for_items(count, threads, [&](int64_t i) {
    uint8_t* out = dst + dst_offsets[i];
    int s = read_full(fd, out, lengths[i], offsets[i]);
    if (s == 0 &&
        crc32_update(0, out, lengths[i]) != static_cast<uint32_t>(crcs[i]))
      s = 2;
    status[i] = s;
    if (s) bad.fetch_add(1);
  });
  return bad.load();
}

}  // extern "C"
