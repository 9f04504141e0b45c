// dgraph_tpu native runtime kernels (C ABI, loaded via ctypes).
//
// TPU-native equivalents of the reference's host-side "native" components
// (SURVEY.md §2a): the storage engine under posting lists and the Raft WAL
// (Badger in the reference: posting/mvcc.go, raftwal/storage.go), the
// group-varint UID block codec (codec/codec.go + go-groupvarint SSE), and
// the bounded Levenshtein used by match() (worker/match.go).
//
// Design notes:
//  - The KV store is an ordered std::map guarded by a mutex with an
//    append-only CRC-framed WAL and point-in-time snapshot files; recovery
//    = load snapshot + replay WAL, truncating a torn tail (the same
//    crash-consistency contract Badger gives the reference).
//  - All functions are C ABI; buffers are caller- or callee-owned as
//    documented per function. Errors return negative codes.

#include <cstdint>
#include <cstdio>
#include <charconv>
#include <cstring>
#include <map>
#include <set>
#include <mutex>
#include <string>
#include <vector>

#if defined(_WIN32)
#error "posix only"
#endif
#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <memory>

namespace {

// ---------------------------------------------------------------- crc32
uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- wal
constexpr char kWalMagic[8] = {'D', 'G', 'T', 'W', 'A', 'L', '2', 0};

struct Wal {
  int fd = -1;
  bool sync = false;
  std::mutex mu;
  std::string path;
};

// Record frame: u32 len | u32 crc32(payload) | payload.
int wal_append_locked(Wal* w, const uint8_t* buf, uint32_t len) {
  uint8_t hdr[8];
  uint32_t crc = crc32(buf, len);
  memcpy(hdr, &len, 4);
  memcpy(hdr + 4, &crc, 4);
  if (write(w->fd, hdr, 8) != 8) return -1;
  ssize_t n = write(w->fd, buf, len);
  if (n != (ssize_t)len) return -1;
  if (w->sync && fsync(w->fd) != 0) return -1;
  return 0;
}

// ---------------------------------------------------------------- kv (LSM)
//
// The store is log-structured so datasets far beyond RAM load and
// serve (the Badger role, posting/mvcc.go): writes land in a bounded
// MEMTABLE (std::map) behind the CRC WAL; when it exceeds its cap it
// flushes to an immutable SORTED RUN file (mmap'd, sparse-indexed,
// crc-sealed, tmp+rename atomic) and the WAL truncates. Reads check
// memtable then runs newest->oldest; deletes are tombstones so newer
// layers shadow older ones. dgt_kv_snapshot() = flush + full
// compaction of all runs into one (tombstones dropped). Crash
// recovery = open runs + replay WAL into the memtable, truncating a
// torn tail — the same contract as before, now with bounded memory.

constexpr uint32_t kTomb = 0xFFFFFFFFu;
constexpr char kRunMagic[8] = {'D', 'G', 'T', 'R', 'U', 'N', '1', 0};
constexpr int kIndexEvery = 64;   // sparse index stride (records)

struct Run {
  std::string path;
  int fd = -1;
  uint8_t* map = (uint8_t*)MAP_FAILED;
  size_t size = 0;
  uint64_t recs_end = 0;  // records occupy [8, recs_end)
  std::vector<std::pair<std::string, uint64_t>> index;  // key -> offset
  ~Run() {
    if (map != MAP_FAILED) munmap(map, size);
    if (fd >= 0) close(fd);
  }
};
using RunPtr = std::shared_ptr<Run>;

struct Entry {
  bool tomb = false;
  std::string val;
};

struct Kv {
  std::map<std::string, Entry> mem;
  size_t mem_bytes = 0;
  size_t mem_cap = 64u << 20;
  std::vector<RunPtr> runs;  // oldest .. newest
  uint64_t next_run = 0;
  Wal wal;
  std::string dir;
  std::mutex mu;
  uint64_t wal_records = 0;
};

// one record in a run: klen u32 | vlen u32 (kTomb = tombstone) | key | val
static bool run_decode_at(const Run& r, uint64_t off, std::string_view* k,
                          std::string_view* v, bool* tomb,
                          uint64_t* next_off) {
  if (off + 8 > r.recs_end) return false;
  uint32_t klen, vlen;
  memcpy(&klen, r.map + off, 4);
  memcpy(&vlen, r.map + off + 4, 4);
  uint64_t vbytes = vlen == kTomb ? 0 : vlen;
  if (off + 8 + klen + vbytes > r.recs_end) return false;
  *k = std::string_view((const char*)r.map + off + 8, klen);
  *v = std::string_view((const char*)r.map + off + 8 + klen, vbytes);
  *tomb = vlen == kTomb;
  *next_off = off + 8 + klen + vbytes;
  return true;
}

// file layout: magic(8) | records | index{klen u32, key, off u64}* |
// footer{recs_end u64, index_count u64, crc u32 over [8, size-20)}
static RunPtr run_open(const std::string& path) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 28) {
    close(fd);
    return nullptr;
  }
  auto r = std::make_shared<Run>();
  r->path = path;
  r->fd = fd;
  r->size = st.st_size;
  r->map = (uint8_t*)mmap(nullptr, r->size, PROT_READ, MAP_SHARED, fd, 0);
  if (r->map == MAP_FAILED) return nullptr;
  if (memcmp(r->map, kRunMagic, 8) != 0) return nullptr;
  uint64_t recs_end, icount;
  uint32_t crc;
  memcpy(&recs_end, r->map + r->size - 20, 8);
  memcpy(&icount, r->map + r->size - 12, 8);
  memcpy(&crc, r->map + r->size - 4, 4);
  if (recs_end < 8 || recs_end > r->size - 20) return nullptr;
  if (crc32(r->map + 8, r->size - 28) != crc) return nullptr;
  uint64_t off = recs_end;
  r->recs_end = recs_end;
  const uint64_t limit = r->size - 20;
  for (uint64_t i = 0; i < icount; i++) {
    // sequential checks — a single combined expression here can
    // underflow unsigned and wave a hostile klen through
    if (off > limit || limit - off < 4) return nullptr;
    uint32_t klen;
    memcpy(&klen, r->map + off, 4);
    off += 4;
    if (klen > limit - off) return nullptr;
    std::string key((const char*)r->map + off, klen);
    off += klen;
    if (limit - off < 8) return nullptr;
    uint64_t roff;
    memcpy(&roff, r->map + off, 8);
    off += 8;
    r->index.emplace_back(std::move(key), roff);
  }
  return r;
}

// scan start offset for `key` (or the range start for a prefix scan):
// greatest index point <= key, else the records start
static uint64_t run_seek(const Run& r, std::string_view key) {
  auto it = std::upper_bound(
      r.index.begin(), r.index.end(), key,
      [](std::string_view k, const std::pair<std::string, uint64_t>& e) {
        return k < std::string_view(e.first);
      });
  if (it == r.index.begin()) return 8;
  return std::prev(it)->second;
}

// point lookup; returns 0 absent, 1 live (fills *out), 2 tombstone
static int run_get(const Run& r, std::string_view key, std::string_view* out) {
  uint64_t off = run_seek(r, key);
  std::string_view k, v;
  bool tomb;
  uint64_t next;
  while (run_decode_at(r, off, &k, &v, &tomb, &next)) {
    if (k == key) {
      if (tomb) return 2;
      *out = v;
      return 1;
    }
    if (k > key) return 0;  // sorted: passed it
    off = next;
  }
  return 0;
}

// write the memtable (or any sorted (key, Entry) sequence) as a run
template <typename It>
static int run_write(const std::string& path, It begin, It end) {
  std::string tmp = path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  std::vector<uint8_t> buf;
  buf.reserve(1u << 20);
  auto flush_buf = [&]() -> bool {
    if (buf.empty()) return true;
    bool ok = write(fd, buf.data(), buf.size()) == (ssize_t)buf.size();
    buf.clear();
    return ok;
  };
  auto put_raw = [&](const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    buf.insert(buf.end(), b, b + n);
  };
  uint32_t crc = 0xFFFFFFFFu;
  auto crc_feed = [&](const uint8_t* p, size_t n) {
    for (size_t i = 0; i < n; i++)
      crc = crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  };
  // incremental crc over everything after the magic
  put_raw(kRunMagic, 8);
  bool ok = flush_buf();
  uint64_t off = 8;
  std::vector<std::pair<std::string, uint64_t>> index;
  uint64_t n = 0;
  for (It it = begin; ok && it != end; ++it, ++n) {
    const std::string& key = it->first;
    const Entry& e = it->second;
    if (n % kIndexEvery == 0) index.emplace_back(key, off);
    uint32_t klen = key.size();
    uint32_t vlen = e.tomb ? kTomb : (uint32_t)e.val.size();
    put_raw(&klen, 4);
    put_raw(&vlen, 4);
    put_raw(key.data(), key.size());
    if (!e.tomb) put_raw(e.val.data(), e.val.size());
    crc_feed(buf.data(), buf.size());
    off += buf.size();
    ok = flush_buf();
  }
  uint64_t recs_end = off;
  for (auto& ip : index) {
    uint32_t klen = ip.first.size();
    put_raw(&klen, 4);
    put_raw(ip.first.data(), klen);
    put_raw(&ip.second, 8);
  }
  crc_feed(buf.data(), buf.size());
  uint64_t icount = index.size();
  put_raw(&recs_end, 8);
  put_raw(&icount, 8);
  uint32_t final_crc = crc ^ 0xFFFFFFFFu;
  put_raw(&final_crc, 4);
  ok = ok && flush_buf() && fsync(fd) == 0;
  close(fd);
  if (!ok || rename(tmp.c_str(), path.c_str()) != 0) {
    unlink(tmp.c_str());
    return -1;
  }
  return 0;
}

// MANIFEST: newline list of valid run files, replaced atomically.
// The run set is only authoritative once manifested — a crash between
// writing a run (or compacting) and the manifest update leaves the
// previous manifest in force and the orphan file is deleted at the
// next open. This is what makes compaction's tombstone dropping
// crash-safe: shadowed old runs can never be resurrected, because the
// manifest flips from {old runs} to {merged} in one rename.
static int kv_write_manifest(Kv* kv) {
  std::string body;
  for (auto& r : kv->runs) {
    size_t slash = r->path.find_last_of('/');
    body += r->path.substr(slash + 1);
    body += '\n';
  }
  std::string tmp = kv->dir + "/MANIFEST.tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  bool ok = write(fd, body.data(), body.size()) == (ssize_t)body.size() &&
            fsync(fd) == 0;
  close(fd);
  if (!ok) return -1;
  return rename(tmp.c_str(), (kv->dir + "/MANIFEST").c_str());
}

// locked: memtable -> new run, manifest it, clear memtable, truncate
// WAL (run+manifest are durable FIRST, so a crash in between only
// replays shadowed records)
static int kv_flush_locked(Kv* kv) {
  if (kv->mem.empty()) return 0;
  char name[32];
  snprintf(name, sizeof name, "run-%08llu.sst",
           (unsigned long long)kv->next_run);
  std::string path = kv->dir + "/" + name;
  if (run_write(path, kv->mem.begin(), kv->mem.end()) != 0) return -1;
  RunPtr r = run_open(path);
  if (!r) return -1;
  kv->next_run++;
  kv->runs.push_back(std::move(r));
  if (kv_write_manifest(kv) != 0) return -1;
  kv->mem.clear();
  kv->mem_bytes = 0;
  if (ftruncate(kv->wal.fd, 0) != 0) return -1;
  lseek(kv->wal.fd, 0, SEEK_SET);
  if (write(kv->wal.fd, kWalMagic, 8) != 8) return -1;
  if (fsync(kv->wal.fd) != 0) return -1;
  kv->wal_records = 0;
  return 0;
}

// streaming k-way merge over memtable + runs (newest shadows oldest)
struct MergeCur {
  // layer 0 = memtable iterators (highest priority), then runs newest
  // to oldest
  std::map<std::string, Entry>::const_iterator mit, mend;
  bool is_mem = false;
  RunPtr run;
  uint64_t off = 0;
  std::string_view k, v;
  bool tomb = false;
  bool done = false;

  void load() {
    if (is_mem) {
      if (mit == mend) {
        done = true;
        return;
      }
      k = mit->first;
      v = mit->second.val;
      tomb = mit->second.tomb;
    } else {
      uint64_t next;
      if (!run_decode_at(*run, off, &k, &v, &tomb, &next)) {
        done = true;
        return;
      }
    }
  }
  void advance() {
    if (is_mem) {
      ++mit;
    } else {
      uint64_t next;
      std::string_view k2, v2;
      bool t2;
      run_decode_at(*run, off, &k2, &v2, &t2, &next);
      off = next;
    }
    load();
  }
};

// visible (non-shadowed) records in key order; layers[0] wins ties
struct MergeView {
  std::vector<MergeCur> layers;

  void init_all() {
    for (auto& c : layers) c.load();
  }
  // -> false when exhausted
  bool next(std::string* key, std::string* val, bool* tomb) {
    for (;;) {
      int best = -1;
      for (size_t i = 0; i < layers.size(); i++) {
        if (layers[i].done) continue;
        if (best < 0 || layers[i].k < layers[best].k) best = (int)i;
      }
      if (best < 0) return false;
      std::string k(layers[best].k);
      std::string v(layers[best].v);
      bool t = layers[best].tomb;
      for (auto& c : layers) {  // advance every layer sitting on k
        while (!c.done && c.k == std::string_view(k)) c.advance();
      }
      *key = std::move(k);
      *val = std::move(v);
      *tomb = t;
      return true;
    }
  }
};

static MergeView kv_merge_view_locked(Kv* kv) {
  MergeView mv;
  MergeCur m;
  m.is_mem = true;
  m.mit = kv->mem.begin();
  m.mend = kv->mem.end();
  mv.layers.push_back(m);
  for (auto it = kv->runs.rbegin(); it != kv->runs.rend(); ++it) {
    MergeCur c;
    c.run = *it;
    c.off = 8;
    mv.layers.push_back(c);
  }
  mv.init_all();
  return mv;
}

// full compaction: flush memtable, then merge every run into ONE new
// run with tombstones dropped; old run files unlink afterwards
static int kv_compact_locked(Kv* kv) {
  if (kv_flush_locked(kv) != 0) return -1;
  if (kv->runs.size() <= 1) return 0;
  // merge through a bounded buffer: chunks stream into the writer via
  // a temporary std::map-like vector (already sorted by the merge)
  MergeView mv = kv_merge_view_locked(kv);
  char name[32];
  snprintf(name, sizeof name, "run-%08llu.sst",
           (unsigned long long)kv->next_run);
  std::string path = kv->dir + "/" + name;
  // adapter: MergeView as an iterator pair for run_write via a
  // generator-style vector window is awkward in C++17 templates, so
  // stream manually with the same format
  std::string tmp = path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  uint32_t crc = 0xFFFFFFFFu;
  std::vector<uint8_t> buf;
  auto put_raw = [&](const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    buf.insert(buf.end(), b, b + n);
  };
  auto crc_flush = [&]() -> bool {
    for (size_t i = 0; i < buf.size(); i++)
      crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    bool ok = buf.empty() ||
              write(fd, buf.data(), buf.size()) == (ssize_t)buf.size();
    buf.clear();
    return ok;
  };
  bool ok = write(fd, kRunMagic, 8) == 8;
  uint64_t off = 8, n = 0;
  std::vector<std::pair<std::string, uint64_t>> index;
  std::string k, v;
  bool tomb;
  while (ok && mv.next(&k, &v, &tomb)) {
    if (tomb) continue;  // full compaction: nothing older to shadow
    if (n % kIndexEvery == 0) index.emplace_back(k, off);
    uint32_t klen = k.size(), vlen = v.size();
    put_raw(&klen, 4);
    put_raw(&vlen, 4);
    put_raw(k.data(), klen);
    put_raw(v.data(), vlen);
    off += 8 + klen + vlen;
    n++;
    if (buf.size() > (1u << 20)) ok = crc_flush();
  }
  uint64_t recs_end = off;
  for (auto& ip : index) {
    uint32_t klen = ip.first.size();
    put_raw(&klen, 4);
    put_raw(ip.first.data(), klen);
    put_raw(&ip.second, 8);
  }
  ok = ok && crc_flush();
  uint64_t icount = index.size();
  uint32_t final_crc = crc ^ 0xFFFFFFFFu;
  put_raw(&recs_end, 8);
  put_raw(&icount, 8);
  put_raw(&final_crc, 4);
  ok = ok && (write(fd, buf.data(), buf.size()) == (ssize_t)buf.size()) &&
       fsync(fd) == 0;
  buf.clear();
  close(fd);
  if (!ok || rename(tmp.c_str(), path.c_str()) != 0) {
    unlink(tmp.c_str());
    return -1;
  }
  RunPtr merged = run_open(path);
  if (!merged) return -1;
  kv->next_run++;
  std::vector<RunPtr> old;
  old.swap(kv->runs);
  kv->runs.push_back(std::move(merged));
  if (kv_write_manifest(kv) != 0) {  // the atomic old->merged flip
    kv->runs.swap(old);
    return -1;
  }
  for (auto& r : old) unlink(r->path.c_str());  // open fds keep iterators alive
  return 0;
}

struct KvIter {
  MergeView mv;
  // memtable slice copied for stability (bounded by the memtable cap);
  // run layers hold RunPtr refs so compaction can't unmap under us
  std::map<std::string, Entry> mem_copy;
  std::string prefix;
  std::string cur_k, cur_v;
  bool have = false;

  void step() {
    std::string k, v;
    bool tomb;
    have = false;
    while (mv.next(&k, &v, &tomb)) {
      if (k.compare(0, prefix.size(), prefix) != 0) {
        if (k > prefix) return;  // sorted: past the prefix range
        continue;
      }
      if (tomb) continue;
      cur_k = std::move(k);
      cur_v = std::move(v);
      have = true;
      return;
    }
  }
};

constexpr char kSnapMagic[8] = {'D', 'G', 'T', 'S', 'N', 'P', '2', 0};

// WAL payload: op(1) | klen(u32) | key | vlen(u32) | value   op: 0=put 1=del
// Deletes become TOMBSTONES in the memtable — they must shadow older
// run layers, not just drop the memtable entry.
void kv_apply(Kv* kv, const uint8_t* p, uint32_t len) {
  if (len < 5) return;
  uint8_t op = p[0];
  uint32_t klen;
  memcpy(&klen, p + 1, 4);
  if (5 + klen > len) return;
  std::string key((const char*)p + 5, klen);
  if (op == 1) {
    kv->mem_bytes += key.size() + 64;
    kv->mem[std::move(key)] = Entry{true, std::string()};
    return;
  }
  if (5 + klen + 4 > len) return;
  uint32_t vlen;
  memcpy(&vlen, p + 5 + klen, 4);
  if (9 + klen + vlen > len) return;
  kv->mem_bytes += key.size() + vlen + 64;
  kv->mem[std::move(key)] =
      Entry{false, std::string((const char*)p + 9 + klen, vlen)};
}

int wal_open_file(Wal* w, const std::string& path, int sync) {
  w->path = path;
  w->sync = sync != 0;
  w->fd = open(path.c_str(), O_RDWR | O_CREAT, 0644);
  if (w->fd < 0) return -1;
  struct stat st;
  if (fstat(w->fd, &st) != 0) return -1;
  if (st.st_size == 0) {
    if (write(w->fd, kWalMagic, 8) != 8) return -1;
  }
  lseek(w->fd, 0, SEEK_END);
  return 0;
}

// Replay WAL into kv; truncates a torn/corrupt tail.
int kv_replay(Kv* kv) {
  int fd = kv->wal.fd;
  off_t size = lseek(fd, 0, SEEK_END);
  if (size < 8) return -1;
  std::vector<uint8_t> data(size);
  if (pread(fd, data.data(), size, 0) != size) return -1;
  if (memcmp(data.data(), kWalMagic, 8) != 0) return -2;
  size_t off = 8;
  size_t good = off;
  std::vector<uint8_t> payload;
  while (off + 8 <= (size_t)size) {
    uint32_t len, crc;
    memcpy(&len, &data[off], 4);
    memcpy(&crc, &data[off + 4], 4);
    if (off + 8 + len > (size_t)size) break;
    if (crc32(&data[off + 8], len) != crc) break;
    kv_apply(kv, &data[off + 8], len);
    off += 8 + len;
    good = off;
    kv->wal_records++;
  }
  if (good < (size_t)size) {
    if (ftruncate(fd, good) != 0) return -1;
  }
  lseek(fd, 0, SEEK_END);
  return 0;
}

int kv_load_snapshot(Kv* kv, const std::string& path) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return 1;  // no snapshot: fine
  off_t size = lseek(fd, 0, SEEK_END);
  std::vector<uint8_t> data(size);
  bool ok = pread(fd, data.data(), size, 0) == size;
  close(fd);
  if (!ok || size < 20 || memcmp(data.data(), kSnapMagic, 8) != 0)
    return -2;
  uint32_t crc;
  memcpy(&crc, &data[size - 4], 4);
  if (crc32(&data[8], size - 12) != crc) return -2;
  uint64_t count;
  memcpy(&count, &data[8], 8);
  size_t off = 16;
  // every read below must stay inside [16, size-4); a CRC collision or
  // crafted file must not cause an out-of-bounds read
  const size_t end = (size_t)size - 4;
  for (uint64_t i = 0; i < count; i++) {
    if (off + 4 > end) return -2;
    uint32_t klen;
    memcpy(&klen, &data[off], 4);
    off += 4;
    if (klen > end - off) return -2;
    std::string key((const char*)&data[off], klen);
    off += klen;
    if (off + 4 > end) return -2;
    uint32_t vlen;
    memcpy(&vlen, &data[off], 4);
    off += 4;
    if (vlen > end - off) return -2;
    kv->mem_bytes += key.size() + vlen + 64;
    kv->mem[std::move(key)] =
        Entry{false, std::string((const char*)&data[off], vlen)};
    off += vlen;
  }
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- kv ABI

// Opens (or creates) a store in `dir`: loads dir/SNAPSHOT then replays
// dir/WAL. Returns handle or null.
void* dgt_kv_open(const char* dir, int sync) {
  Kv* kv = new Kv();
  kv->dir = dir;
  mkdir(dir, 0755);
  if (const char* cap = getenv("DGT_KV_MEMTABLE_BYTES")) {
    unsigned long long v = strtoull(cap, nullptr, 10);
    if (v >= (1u << 16)) kv->mem_cap = v;
  }
  // open the immutable runs: the MANIFEST (when present) is the
  // authoritative set; run files it does not list are crash orphans
  // (flush or compaction died before the manifest flip) and are
  // deleted — loading them could resurrect compacted-away deletes
  {
    std::vector<std::string> listed;
    bool have_manifest = false;
    if (FILE* mf = fopen((kv->dir + "/MANIFEST").c_str(), "r")) {
      have_manifest = true;
      char line[64];
      while (fgets(line, sizeof line, mf)) {
        std::string n(line);
        while (!n.empty() && (n.back() == '\n' || n.back() == '\r'))
          n.pop_back();
        if (!n.empty()) listed.push_back(n);
      }
      fclose(mf);
    }
    std::vector<std::string> names;
    if (DIR* d = opendir(dir)) {
      while (struct dirent* de = readdir(d)) {
        std::string n = de->d_name;
        if (n.size() == 16 && n.compare(0, 4, "run-") == 0 &&
            n.compare(12, 4, ".sst") == 0)
          names.push_back(n);
      }
      closedir(d);
    }
    std::sort(names.begin(), names.end());
    for (auto& n : names) {
      uint64_t seq = strtoull(n.c_str() + 4, nullptr, 10);
      if (seq + 1 > kv->next_run) kv->next_run = seq + 1;
      bool ok = !have_manifest ||
                std::find(listed.begin(), listed.end(), n) != listed.end();
      if (!ok) {
        unlink((kv->dir + "/" + n).c_str());
        continue;
      }
      RunPtr r = run_open(kv->dir + "/" + n);
      if (r) kv->runs.push_back(std::move(r));
    }
  }
  // legacy pre-LSM stores: SNAPSHOT loads into the memtable once and
  // becomes a run at the next flush
  if (kv_load_snapshot(kv, kv->dir + "/SNAPSHOT") == 0)
    unlink((kv->dir + "/SNAPSHOT").c_str());
  if (wal_open_file(&kv->wal, kv->dir + "/WAL", sync) != 0) {
    delete kv;
    return nullptr;
  }
  if (kv_replay(kv) < 0) {
    close(kv->wal.fd);
    kv->wal.fd = -1;
    delete kv;
    return nullptr;
  }
  return kv;
}

// lower the memtable cap (tests exercise multi-run shapes with it)
void dgt_kv_set_memtable(void* h, uint64_t bytes) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  kv->mem_cap = bytes < (1u << 10) ? (1u << 10) : bytes;
}

int dgt_kv_put(void* h, const uint8_t* key, uint32_t klen,
               const uint8_t* val, uint32_t vlen) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  std::vector<uint8_t> rec(9 + klen + vlen);
  rec[0] = 0;
  memcpy(&rec[1], &klen, 4);
  memcpy(&rec[5], key, klen);
  memcpy(&rec[5 + klen], &vlen, 4);
  memcpy(&rec[9 + klen], val, vlen);
  if (wal_append_locked(&kv->wal, rec.data(), rec.size()) != 0) return -1;
  kv->wal_records++;
  kv->mem_bytes += klen + vlen + 64;
  kv->mem[std::string((const char*)key, klen)] =
      Entry{false, std::string((const char*)val, vlen)};
  if (kv->mem_bytes > kv->mem_cap) return kv_flush_locked(kv);
  return 0;
}

int dgt_kv_del(void* h, const uint8_t* key, uint32_t klen) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  std::vector<uint8_t> rec(5 + klen);
  rec[0] = 1;
  memcpy(&rec[1], &klen, 4);
  memcpy(&rec[5], key, klen);
  if (wal_append_locked(&kv->wal, rec.data(), rec.size()) != 0) return -1;
  kv->wal_records++;
  kv->mem_bytes += klen + 64;
  kv->mem[std::string((const char*)key, klen)] = Entry{true, std::string()};
  if (kv->mem_bytes > kv->mem_cap) return kv_flush_locked(kv);
  return 0;
}

// Returns value length, or -1 if absent. If out != null, copies up to cap.
int64_t dgt_kv_get(void* h, const uint8_t* key, uint32_t klen,
                   uint8_t* out, uint64_t cap) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  std::string k((const char*)key, klen);
  auto it = kv->mem.find(k);
  std::string_view val;
  if (it != kv->mem.end()) {
    if (it->second.tomb) return -1;
    val = it->second.val;
  } else {
    bool found = false;
    for (auto r = kv->runs.rbegin(); r != kv->runs.rend(); ++r) {
      int got = run_get(**r, k, &val);
      if (got == 2) return -1;  // tombstone shadows older layers
      if (got == 1) {
        found = true;
        break;
      }
    }
    if (!found) return -1;
  }
  if (out) {
    uint64_t n = val.size() < cap ? val.size() : cap;
    memcpy(out, val.data(), n);
  }
  return (int64_t)val.size();
}

// exact live-key count: one streaming merge pass (an infrequent
// introspection call; the hot path never needs it)
uint64_t dgt_kv_count(void* h) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  MergeView mv = kv_merge_view_locked(kv);
  uint64_t n = 0;
  std::string k, v;
  bool tomb;
  while (mv.next(&k, &v, &tomb))
    if (!tomb) n++;
  return n;
}

// fsync the WAL (used when sync=0 for batched durability points).
int dgt_kv_flush(void* h) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  return fsync(kv->wal.fd) == 0 ? 0 : -1;
}

// Durability point: flush the memtable to a run and fully compact the
// runs into one (tombstones dropped), truncating the WAL. The LSM's
// replacement for the old whole-store SNAPSHOT file.
int dgt_kv_snapshot(void* h) {
  Kv* kv = (Kv*)h;
  std::lock_guard<std::mutex> lk(kv->mu);
  return kv_compact_locked(kv);
}

void dgt_kv_close(void* h) {
  Kv* kv = (Kv*)h;
  close(kv->wal.fd);
  kv->wal.fd = -1;
  delete kv;
}

// Prefix iterator: STREAMING k-way merge (memtable slice copied for
// stability — bounded by the memtable cap — run layers pinned via
// shared_ptr so compaction can't unmap them mid-scan). Key-ordered,
// tombstone-shadowed; full-store scans never materialize the keyspace.
void* dgt_kv_iter(void* h, const uint8_t* prefix, uint32_t plen) {
  Kv* kv = (Kv*)h;
  KvIter* it = new KvIter();
  it->prefix.assign((const char*)prefix, plen);
  std::lock_guard<std::mutex> lk(kv->mu);
  auto lo = kv->mem.lower_bound(it->prefix);
  for (auto m = lo; m != kv->mem.end(); ++m) {
    if (m->first.compare(0, plen, it->prefix) != 0) break;
    it->mem_copy.emplace(m->first, m->second);
  }
  MergeCur memc;
  memc.is_mem = true;
  memc.mit = it->mem_copy.begin();
  memc.mend = it->mem_copy.end();
  it->mv.layers.push_back(memc);
  for (auto r = kv->runs.rbegin(); r != kv->runs.rend(); ++r) {
    MergeCur c;
    c.run = *r;
    c.off = it->prefix.empty() ? 8 : run_seek(**r, it->prefix);
    it->mv.layers.push_back(c);
  }
  it->mv.init_all();
  it->step();
  return it;
}

// Two-phase contract (unchanged): a call whose buffers are null
// reports sizes WITHOUT advancing; a call with buffers copies the
// record and advances.
int dgt_kv_iter_next(void* hi, uint8_t* kout, uint64_t kcap, uint64_t* klen,
                     uint8_t* vout, uint64_t vcap, uint64_t* vlen) {
  KvIter* it = (KvIter*)hi;
  if (!it->have) return -1;
  *klen = it->cur_k.size();
  *vlen = it->cur_v.size();
  if (kout) {
    memcpy(kout, it->cur_k.data(),
           it->cur_k.size() < kcap ? it->cur_k.size() : kcap);
    memcpy(vout, it->cur_v.data(),
           it->cur_v.size() < vcap ? it->cur_v.size() : vcap);
    it->step();
  }
  return 0;
}

void dgt_kv_iter_close(void* hi) { delete (KvIter*)hi; }

// ---------------------------------------------------------------- wal ABI
// Standalone WAL (no in-memory map) for the transaction/Raft logs.

void* dgt_wal_open(const char* path, int sync) {
  Wal* w = new Wal();
  if (wal_open_file(w, path, sync) != 0) {
    delete w;
    return nullptr;
  }
  return w;
}

int dgt_wal_append(void* h, const uint8_t* buf, uint64_t len) {
  Wal* w = (Wal*)h;
  if (len > 0xFFFFFFFFull) return -2;  // frame length is u32
  std::lock_guard<std::mutex> lk(w->mu);
  return wal_append_locked(w, buf, (uint32_t)len);
}

int dgt_wal_flush(void* h) {
  Wal* w = (Wal*)h;
  std::lock_guard<std::mutex> lk(w->mu);
  return fsync(w->fd) == 0 ? 0 : -1;
}

// Reads all valid records; returns a malloc'd buffer of concatenated
// [u64 len | payload] entries, sets *total and *count. Truncates torn
// tail. Caller frees via dgt_free.
uint8_t* dgt_wal_replay(void* h, uint64_t* total, uint64_t* count) {
  Wal* w = (Wal*)h;
  std::lock_guard<std::mutex> lk(w->mu);
  *total = 0;
  *count = 0;
  off_t size = lseek(w->fd, 0, SEEK_END);
  if (size < 8) return nullptr;
  std::vector<uint8_t> data(size);
  if (pread(w->fd, data.data(), size, 0) != size) return nullptr;
  if (memcmp(data.data(), kWalMagic, 8) != 0) return nullptr;
  std::vector<uint8_t> out;
  size_t off = 8, good = 8;
  while (off + 8 <= (size_t)size) {
    uint32_t len, crc;
    memcpy(&len, &data[off], 4);
    memcpy(&crc, &data[off + 4], 4);
    if (off + 8 + len > (size_t)size) break;
    if (crc32(&data[off + 8], len) != crc) break;
    uint64_t len64 = len;
    out.insert(out.end(), (uint8_t*)&len64, (uint8_t*)&len64 + 8);
    out.insert(out.end(), &data[off + 8], &data[off + 8 + len]);
    off += 8 + len;
    good = off;
    (*count)++;
  }
  if (good < (size_t)size) {
    if (ftruncate(w->fd, good) != 0) return nullptr;
  }
  lseek(w->fd, 0, SEEK_END);
  *total = out.size();
  uint8_t* buf = (uint8_t*)malloc(out.size() ? out.size() : 1);
  if (!out.empty()) {
    // empty replay: out.data() may be null — memcpy(_, null, 0) is UB
    // even for zero bytes (caught by the UBSan harness)
    memcpy(buf, out.data(), out.size());
  }
  return buf;
}

// Truncates the log to empty (post-snapshot).
int dgt_wal_truncate(void* h) {
  Wal* w = (Wal*)h;
  std::lock_guard<std::mutex> lk(w->mu);
  if (ftruncate(w->fd, 0) != 0) return -1;
  lseek(w->fd, 0, SEEK_SET);
  if (write(w->fd, kWalMagic, 8) != 8) return -1;
  if (w->sync && fsync(w->fd) != 0) return -1;
  return 0;
}

void dgt_wal_close(void* h) {
  Wal* w = (Wal*)h;
  close(w->fd);
  delete w;
}

void dgt_free(void* p) { free(p); }

// ------------------------------------------------------------- codec ABI
// Group-varint delta codec for sorted u64 UID lists. Layout per block of
// up to 4 deltas: 1 tag byte (2 bits per delta = byte width 1/2/4/8 - 1
// encoded as 0..3 meaning 1,2,4,8 bytes) followed by the delta bytes.
// Stream: u64 count | u64 first | blocks of deltas. This is our own
// wire design in the spirit of codec/codec.go; decode is branch-light.

static inline int width_code(uint64_t v) {
  if (v < (1ull << 8)) return 0;
  if (v < (1ull << 16)) return 1;
  if (v < (1ull << 32)) return 2;
  return 3;
}
static const int kWidth[4] = {1, 2, 4, 8};

// Encodes n sorted uids. out must have capacity >= 16 + n*9. Returns
// bytes written, or -1.
int64_t dgt_gv_encode(const uint64_t* uids, uint64_t n, uint8_t* out) {
  uint8_t* p = out;
  memcpy(p, &n, 8);
  p += 8;
  if (n == 0) return p - out;
  memcpy(p, &uids[0], 8);
  p += 8;
  uint64_t i = 1;
  while (i < n) {
    uint64_t cnt = (n - i) < 4 ? (n - i) : 4;
    uint8_t* tag = p++;
    *tag = 0;
    for (uint64_t j = 0; j < cnt; j++) {
      uint64_t d = uids[i + j] - uids[i + j - 1];
      int wc = width_code(d);
      *tag |= (uint8_t)(wc << (2 * j));
      memcpy(p, &d, kWidth[wc]);
      p += kWidth[wc];
    }
    // unused slots in the last tag keep width code 0 and no bytes
    i += cnt;
  }
  return p - out;
}

// Decodes into out (capacity from the stream's count, read via
// dgt_gv_count). Returns number of uids, or -1 on malformed input.
int64_t dgt_gv_decode(const uint8_t* buf, uint64_t len, uint64_t* out) {
  if (len < 8) return -1;
  uint64_t n;
  memcpy(&n, buf, 8);
  if (n == 0) return 0;
  if (len < 16) return -1;
  uint64_t prev;
  memcpy(&prev, buf + 8, 8);
  out[0] = prev;
  const uint8_t* p = buf + 16;
  const uint8_t* end = buf + len;
  uint64_t i = 1;
  while (i < n) {
    if (p >= end) return -1;
    uint8_t tag = *p++;
    uint64_t cnt = (n - i) < 4 ? (n - i) : 4;
    for (uint64_t j = 0; j < cnt; j++) {
      int w = kWidth[(tag >> (2 * j)) & 3];
      if (p + w > end) return -1;
      uint64_t d = 0;
      memcpy(&d, p, w);
      p += w;
      prev += d;
      out[i++] = prev;
    }
  }
  return (int64_t)n;
}

uint64_t dgt_gv_count(const uint8_t* buf, uint64_t len) {
  if (len < 8) return 0;
  uint64_t n;
  memcpy(&n, buf, 8);
  return n;
}

// ------------------------------------------------------------- match ABI

// UTF-8 -> code points (invalid bytes pass through as raw values), so the
// distance is measured in characters like the reference's []rune
// conversion (worker/match.go) and the Python fallback.
static void utf8_decode(const uint8_t* s, uint32_t n,
                        std::vector<uint32_t>* out) {
  uint32_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    uint32_t cp = c;
    uint32_t extra = 0;
    if ((c & 0xE0) == 0xC0) {
      cp = c & 0x1F;
      extra = 1;
    } else if ((c & 0xF0) == 0xE0) {
      cp = c & 0x0F;
      extra = 2;
    } else if ((c & 0xF8) == 0xF0) {
      cp = c & 0x07;
      extra = 3;
    }
    if (i + extra >= n && extra) {  // truncated sequence: raw byte
      out->push_back(c);
      i++;
      continue;
    }
    bool ok = true;
    for (uint32_t k = 1; k <= extra; k++) {
      if ((s[i + k] & 0xC0) != 0x80) {
        ok = false;
        break;
      }
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    if (!ok) {
      out->push_back(c);
      i++;
    } else {
      out->push_back(cp);
      i += extra + 1;
    }
  }
}

// Bounded Levenshtein distance over code points (ref worker/match.go);
// returns the distance, or max_d + 1 if it exceeds max_d.
int32_t dgt_levenshtein(const uint8_t* ab, uint32_t lab, const uint8_t* bb,
                        uint32_t lbb, int32_t max_d) {
  std::vector<uint32_t> av, bv;
  utf8_decode(ab, lab, &av);
  utf8_decode(bb, lbb, &bv);
  const std::vector<uint32_t>* a = &av;
  const std::vector<uint32_t>* b = &bv;
  if (a->size() > b->size()) std::swap(a, b);
  uint32_t la = a->size(), lb = b->size();
  if ((int32_t)(lb - la) > max_d) return max_d + 1;
  std::vector<int32_t> prev(la + 1), cur(la + 1);
  for (uint32_t i = 0; i <= la; i++) prev[i] = i;
  for (uint32_t j = 1; j <= lb; j++) {
    cur[0] = j;
    int32_t row_min = cur[0];
    for (uint32_t i = 1; i <= la; i++) {
      int32_t cost = (*a)[i - 1] == (*b)[j - 1] ? 0 : 1;
      int32_t v = prev[i - 1] + cost;
      if (prev[i] + 1 < v) v = prev[i] + 1;
      if (cur[i - 1] + 1 < v) v = cur[i - 1] + 1;
      cur[i] = v;
      if (v < row_min) row_min = v;
    }
    if (row_min > max_d) return max_d + 1;
    std::swap(prev, cur);
  }
  return prev[la] <= max_d ? prev[la] : max_d + 1;
}

}  // extern "C"

// Batched fuzzy-match verify (ref worker/match.go matchFuzzy over the
// trigram candidates): one call scores every candidate value against
// the term, CASE-SENSITIVE over code points exactly like the
// reference's levenshteinDistance (match.go:35 — no lowering).
extern "C" int dgt_match_mask(
    const uint8_t* term, uint32_t term_len, int32_t max_d,
    const uint8_t* blob, const int64_t* offsets,
    int64_t n, uint8_t* out_mask) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* v = blob + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    int32_t d = dgt_levenshtein(v, (uint32_t)len, term, term_len,
                                max_d);
    out_mask[i] = d <= max_d ? 1 : 0;
  }
  return 0;
}

// Same verify over SELECTED rows of a cached whole-column payload
// blob (the executor joins the column's payloads once per base_ts
// instead of rebuilding a python list per query).
extern "C" int dgt_match_mask_idx(
    const uint8_t* term, uint32_t term_len, int32_t max_d,
    const uint8_t* blob, const int64_t* offsets,
    const int64_t* idx, int64_t n_idx, uint8_t* out_mask) {
  for (int64_t i = 0; i < n_idx; i++) {
    int64_t j = idx[i];
    const uint8_t* v = blob + offsets[j];
    int64_t len = offsets[j + 1] - offsets[j];
    int32_t d = dgt_levenshtein(v, (uint32_t)len, term, term_len,
                                max_d);
    out_mask[i] = d <= max_d ? 1 : 0;
  }
  return 0;
}

// K-way merge-count over SORTED uid buckets (the trigram q-gram count
// filter, ref worker/match.go uidsForMatch's index union): emit every
// uid appearing in >= need buckets. Replaces concatenate+np.unique —
// a full 3M-element sort per query at the 21M regime — with one
// linear merge over the already-sorted index buckets.
extern "C" int dgt_merge_count(
    const uint64_t* vals, const int64_t* bucket_offs, int64_t n_buckets,
    int64_t need, uint64_t* out, int64_t* out_n) {
  // heap of (current value, bucket index)
  struct Head { uint64_t v; int64_t b; };
  Head* heap = (Head*)malloc(sizeof(Head) * (size_t)(n_buckets + 1));
  if (!heap) return 1;
  int64_t* pos = (int64_t*)malloc(sizeof(int64_t) * (size_t)n_buckets);
  if (!pos) { free(heap); return 1; }
  int64_t hn = 0;
  for (int64_t b = 0; b < n_buckets; b++) {
    pos[b] = bucket_offs[b];
    if (pos[b] < bucket_offs[b + 1]) {
      // sift up
      int64_t i = hn++;
      heap[i].v = vals[pos[b]];
      heap[i].b = b;
      while (i > 0) {
        int64_t p = (i - 1) / 2;
        if (heap[p].v <= heap[i].v) break;
        Head t = heap[p]; heap[p] = heap[i]; heap[i] = t;
        i = p;
      }
    }
  }
  int64_t m = 0;
  uint64_t cur = 0;
  int64_t count = 0;
  bool have = false;
  while (hn > 0) {
    uint64_t v = heap[0].v;
    int64_t b = heap[0].b;
    if (!have || v != cur) {
      if (have && count >= need) out[m++] = cur;
      cur = v; count = 1; have = true;
    } else {
      count++;
    }
    // advance bucket b's head
    pos[b]++;
    if (pos[b] < bucket_offs[b + 1]) {
      heap[0].v = vals[pos[b]];
    } else {
      heap[0] = heap[--hn];
    }
    // sift down
    int64_t i = 0;
    while (true) {
      int64_t l = 2 * i + 1, r = 2 * i + 2, s = i;
      if (l < hn && heap[l].v < heap[s].v) s = l;
      if (r < hn && heap[r].v < heap[s].v) s = r;
      if (s == i) break;
      Head t = heap[s]; heap[s] = heap[i]; heap[i] = t;
      i = s;
    }
  }
  if (have && count >= need) out[m++] = cur;
  *out_n = m;
  free(pos);
  free(heap);
  return 0;
}

// -------------------------------------------------------- JSON emitter
// Columnar row serializer for the query result fast path — the role of
// the reference's fastJsonNode encoder (query/outputnode.go), which its
// own benchmarks rank a top-5 hot loop (query/benchmark/
// synthetic_results.txt ToJson 235-460 ms/op). The executor hands over
// typed columns; this writes the JSON array of row objects in one C
// pass. Output formatting matches Python json.dumps defaults exactly
// (ensure_ascii escaping, shortest-roundtrip doubles, lone-key
// omission for absent cells) so the fast path is byte-identical to the
// dict path.

namespace {

struct JBuf {
  uint8_t* p = nullptr;
  uint64_t len = 0, cap = 0;
  bool oom = false;
  void reserve(uint64_t extra) {
    if (len + extra <= cap) return;
    uint64_t want = cap ? cap * 2 : 4096;
    while (want < len + extra) want *= 2;
    uint8_t* np2 = (uint8_t*)realloc(p, want);
    if (!np2) { oom = true; return; }
    p = np2;
    cap = want;
  }
  void put(const char* s, uint64_t n) {
    reserve(n);
    if (oom) return;
    memcpy(p + len, s, n);
    len += n;
  }
  void putc(char c) {
    reserve(1);
    if (oom) return;
    p[len++] = c;
  }
};

// json.dumps default escaping: ", \, control chars, and every
// non-ASCII codepoint as \uXXXX (surrogate pairs above the BMP).
void jesc(JBuf& b, const uint8_t* s, int64_t n) {
  static const char* hex = "0123456789abcdef";
  char u[16];
  int64_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c == '"' || c == '\\') {
      b.putc('\\');
      b.putc((char)c);
      i++;
    } else if (c == '\n') { b.put("\\n", 2); i++; }
    else if (c == '\t') { b.put("\\t", 2); i++; }
    else if (c == '\r') { b.put("\\r", 2); i++; }
    else if (c == '\b') { b.put("\\b", 2); i++; }
    else if (c == '\f') { b.put("\\f", 2); i++; }
    else if (c < 0x20) {
      snprintf(u, sizeof u, "\\u%04x", c);
      b.put(u, 6);
      i++;
    } else if (c < 0x80) {
      b.putc((char)c);
      i++;
    } else {
      // decode one UTF-8 codepoint (input comes from Python str
      // .encode(), so it is valid UTF-8)
      uint32_t cp = 0;
      int extra = 0;
      if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
      else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
      else { cp = c & 0x07; extra = 3; }
      if (i + extra >= n) break;  // truncated tail: stop cleanly
      for (int k = 1; k <= extra; k++) cp = (cp << 6) | (s[i + k] & 0x3F);
      i += extra + 1;
      if (cp >= 0x10000) {
        uint32_t v = cp - 0x10000;
        snprintf(u, sizeof u, "\\u%04x\\u%04x",
                 (unsigned)(0xD800 + (v >> 10)),
                 (unsigned)(0xDC00 + (v & 0x3FF)));
        b.put(u, 12);
      } else {
        u[0] = '\\'; u[1] = 'u';
        u[2] = hex[(cp >> 12) & 0xF]; u[3] = hex[(cp >> 8) & 0xF];
        u[4] = hex[(cp >> 4) & 0xF]; u[5] = hex[cp & 0xF];
        b.put(u, 6);
      }
    }
  }
}

// shortest round-trip double, matching repr(float) / json.dumps:
// std::to_chars (ryu) finds the shortest digit count, then one
// %.*g snprintf renders it with Python's exact formatting rules
// (fixed/scientific switch, 2-digit signed exponent)
void jdouble(JBuf& b, double v) {
  char tmp[40];
  if (v != v) { b.put("NaN", 3); return; }           // json.dumps default
  if (v > 1.7976931348623157e308) { b.put("Infinity", 8); return; }
  if (v < -1.7976931348623157e308) { b.put("-Infinity", 9); return; }
  char tc[32];
  auto res = std::to_chars(tc, tc + sizeof tc, v);
  // digits + decimal exponent of the shortest representation,
  // independent of the fixed/scientific form to_chars picked
  int sig = 0, exp10 = 0, int_digits = 0, lead_zeros = 0, trail0 = 0;
  bool nonzero = false, saw_point = false, has_e = false;
  const char* q = tc;
  if (*q == '-') q++;
  for (; q < res.ptr; q++) {
    if (*q == '.') { saw_point = true; continue; }
    if (*q == 'e' || *q == 'E') { has_e = true; exp10 = atoi(q + 1); break; }
    if (*q >= '1' && *q <= '9') nonzero = true;
    if (nonzero) { sig++; trail0 = (*q == '0') ? trail0 + 1 : 0; }
    else if (saw_point) lead_zeros++;
    if (!saw_point && nonzero) int_digits++;
  }
  sig -= trail0;  // fixed-form trailing zeros are not significant
  if (sig < 1) { sig = 1; nonzero = true; int_digits = 1; }
  if (has_e) exp10 += int_digits - 1;
  else if (saw_point && int_digits == 0) exp10 = -lead_zeros - 1;
  else exp10 = (int_digits ? int_digits : 1) - 1;
  // CPython float repr: fixed form iff -4 <= exp10 < 16
  if (exp10 >= -4 && exp10 < 16)
    snprintf(tmp, sizeof tmp, "%.*g", sig > exp10 ? sig : exp10 + 1, v);
  else
    snprintf(tmp, sizeof tmp, "%.*e", sig - 1, v);
  // Python prints doubles with an exponent as 1e+20 -> "1e+20";
  // %g matches. Integral floats print as "1.0" in Python, %g gives
  // "1": append ".0" when no '.', 'e' or inf/nan marker present.
  bool plain = true;
  for (char* q = tmp; *q; q++)
    if (*q == '.' || *q == 'e' || *q == 'E' || *q == 'n' || *q == 'f')
      plain = false;
  b.put(tmp, strlen(tmp));
  if (plain) b.put(".0", 2);
}

}  // namespace

extern "C" {

// types: 0=int64, 1=double, 2=bool(u8), 3=utf8 string (data + offsets
// [n_rows+1]), 4=uid(u64 -> "0x.."). present: per-column u8 mask or
// NULL (all present). Rows where nothing is present emit nothing (the
// executor drops empty objects, ref outputnode.go). Returns 0 and a
// malloc'd buffer in *out (caller frees with dgt_free), -1 on OOM.
int dgt_json_rows(int64_t n_rows, int32_t n_cols,
                  const char* const* names, const int32_t* types,
                  const void* const* data,
                  const int64_t* const* offsets,
                  const uint8_t* const* present,
                  uint8_t** out, uint64_t* out_len) {
  JBuf b;
  char tmp[40];
  b.putc('[');
  bool first_row = true;
  for (int64_t r = 0; r < n_rows; r++) {
    bool any = false;
    for (int32_t c = 0; c < n_cols && !any; c++)
      any = !present[c] || present[c][r];
    if (!any) continue;
    if (!first_row) b.putc(',');
    first_row = false;
    b.putc('{');
    bool first_col = true;
    for (int32_t c = 0; c < n_cols; c++) {
      if (present[c] && !present[c][r]) continue;
      if (!first_col) b.putc(',');
      first_col = false;
      b.putc('"');
      b.put(names[c], strlen(names[c]));
      b.put("\":", 2);
      switch (types[c]) {
        case 0:
          snprintf(tmp, sizeof tmp, "%lld",
                   (long long)((const int64_t*)data[c])[r]);
          b.put(tmp, strlen(tmp));
          break;
        case 1:
          jdouble(b, ((const double*)data[c])[r]);
          break;
        case 2:
          if (((const uint8_t*)data[c])[r]) b.put("true", 4);
          else b.put("false", 5);
          break;
        case 3: {
          const int64_t* off = offsets[c];
          b.putc('"');
          jesc(b, (const uint8_t*)data[c] + off[r], off[r + 1] - off[r]);
          b.putc('"');
          break;
        }
        case 4:
          snprintf(tmp, sizeof tmp, "\"0x%llx\"",
                   (unsigned long long)((const uint64_t*)data[c])[r]);
          b.put(tmp, strlen(tmp));
          break;
        default:
          free(b.p);
          return -2;
      }
    }
    b.putc('}');
  }
  b.putc(']');
  if (b.oom) { free(b.p); return -1; }
  *out = b.p;
  *out_len = b.len;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched ASCII tokenizer for index builds (ref tok/tok.go term/exact/
// trigram/fulltext tokenizers; bulk/mapper.go:272 sustains 75-80k RDF/s
// WITH index entries — the per-value python tokenizer capped 21M bulk
// loads at ~20k RDF/s, round-3 verdict weak #6).
//
// Scope: pure-ASCII payloads only (python pre-partitions; for ASCII,
// NFKD folding == tolower and byte windows == codepoint windows, so
// the output is bit-identical to models/tokenizer.py).  Fulltext is
// the English analyzer (stopwords + this exact porter port); tagged
// languages stay on the python path.
//
// One call tokenizes a chunk of values and returns the (token ->
// value-index group) structure directly: tokens are unique (shorts sorted, then longs sorted)
// ident-prefixed byte strings, each owning a slice of val_idx.

namespace dgtok {

static inline bool word_byte(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

static inline char lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? (char)(c + 32) : (char)c;
}

// models/stemmer.py STOPWORDS["en"], verbatim.
static bool is_stop(const std::string& w) {
  static const std::set<std::string> kStops = {
      "a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
      "if", "in", "into", "is", "it", "no", "not", "of", "on", "or",
      "such", "that", "the", "their", "then", "there", "these",
      "they", "this", "to", "was", "will", "with"};
  return kStops.count(w) != 0;
}

// --- porter stemmer, a line-for-line port of models/stemmer.py ---

static bool is_cons(const std::string& w, int i) {
  char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u')
    return false;
  if (c == 'y') return i == 0 || !is_cons(w, i - 1);
  return true;
}

static int measure(const std::string& w) {
  int m = 0, i = 0, n = (int)w.size();
  while (i < n && is_cons(w, i)) i++;
  while (i < n) {
    while (i < n && !is_cons(w, i)) i++;
    if (i >= n) break;
    m++;
    while (i < n && is_cons(w, i)) i++;
  }
  return m;
}

static bool has_vowel(const std::string& w) {
  for (int i = 0; i < (int)w.size(); i++)
    if (!is_cons(w, i)) return true;
  return false;
}

static bool ends_double_cons(const std::string& w) {
  int n = (int)w.size();
  return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

static bool ends_cvc(const std::string& w) {
  int n = (int)w.size();
  if (n < 3) return false;
  if (!(is_cons(w, n - 3) && !is_cons(w, n - 2) && is_cons(w, n - 1)))
    return false;
  char c = w[n - 1];
  return c != 'w' && c != 'x' && c != 'y';
}

static bool ends(const std::string& w, const char* suf) {
  size_t l = strlen(suf);
  return w.size() >= l && w.compare(w.size() - l, l, suf) == 0;
}

static std::string porter(std::string w) {
  if (w.size() <= 2) return w;
  // step 1a
  if (ends(w, "sses")) w.resize(w.size() - 2);
  else if (ends(w, "ies")) w.resize(w.size() - 2);
  else if (!ends(w, "ss") && ends(w, "s")) w.resize(w.size() - 1);
  // step 1b
  bool flag = false;
  if (ends(w, "eed")) {
    if (measure(w.substr(0, w.size() - 3)) > 0) w.resize(w.size() - 1);
  } else if (ends(w, "ed") && has_vowel(w.substr(0, w.size() - 2))) {
    w.resize(w.size() - 2);
    flag = true;
  } else if (ends(w, "ing") && has_vowel(w.substr(0, w.size() - 3))) {
    w.resize(w.size() - 3);
    flag = true;
  }
  if (flag) {
    if (ends(w, "at") || ends(w, "bl") || ends(w, "iz")) w += 'e';
    else if (ends_double_cons(w) && w.back() != 'l' &&
             w.back() != 's' && w.back() != 'z')
      w.resize(w.size() - 1);
    else if (measure(w) == 1 && ends_cvc(w)) w += 'e';
  }
  // step 1c
  if (ends(w, "y") && has_vowel(w.substr(0, w.size() - 1)))
    w[w.size() - 1] = 'i';
  // step 2
  static const std::pair<const char*, const char*> kStep2[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
      {"anci", "ance"}, {"izer", "ize"}, {"abli", "able"},
      {"alli", "al"}, {"entli", "ent"}, {"eli", "e"},
      {"ousli", "ous"}, {"ization", "ize"}, {"ation", "ate"},
      {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"},
      {"fulness", "ful"}, {"ousness", "ous"}, {"aliti", "al"},
      {"iviti", "ive"}, {"biliti", "ble"}};
  for (auto& sr : kStep2) {
    if (ends(w, sr.first)) {
      std::string stem = w.substr(0, w.size() - strlen(sr.first));
      if (measure(stem) > 0) w = stem + sr.second;
      break;
    }
  }
  // step 3
  static const std::pair<const char*, const char*> kStep3[] = {
      {"icate", "ic"}, {"ative", ""}, {"alize", "al"},
      {"iciti", "ic"}, {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
  for (auto& sr : kStep3) {
    if (ends(w, sr.first)) {
      std::string stem = w.substr(0, w.size() - strlen(sr.first));
      if (measure(stem) > 0) w = stem + sr.second;
      break;
    }
  }
  // step 4 (python for/else: the ion-clause runs only with NO match)
  static const char* kStep4[] = {
      "al", "ance", "ence", "er", "ic", "able", "ible", "ant",
      "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
      "ive", "ize"};
  bool matched4 = false;
  for (auto* suf : kStep4) {
    if (ends(w, suf)) {
      matched4 = true;
      std::string stem = w.substr(0, w.size() - strlen(suf));
      if (measure(stem) > 1) w = stem;
      break;
    }
  }
  if (!matched4 && ends(w, "ion") && w.size() > 3 &&
      (w[w.size() - 4] == 's' || w[w.size() - 4] == 't') &&
      measure(w.substr(0, w.size() - 3)) > 1)
    w.resize(w.size() - 3);
  // step 5a
  if (ends(w, "e")) {
    std::string stem = w.substr(0, w.size() - 1);
    int m = measure(stem);
    if (m > 1 || (m == 1 && !ends_cvc(stem))) w = stem;
  }
  // step 5b
  if (measure(w) > 1 && ends_double_cons(w) && w.back() == 'l')
    w.resize(w.size() - 1);
  return w;
}

}  // namespace dgtok

extern "C" int dgt_tokenize_batch(
    const uint8_t* payload, const uint64_t* offsets, uint32_t n_vals,
    uint32_t mode,  // 1=term 2=trigram 4=fulltext-en 8=exact
    uint8_t term_id, uint8_t tri_id, uint8_t ft_id, uint8_t ex_id,
    uint8_t** tok_out, uint64_t* tok_len_out,
    uint64_t** tok_offs_out, uint64_t* n_toks_out,
    uint32_t** val_idx_out, uint64_t* n_pairs_out,
    uint64_t** bounds_out) {
  using dgtok::lower;
  using dgtok::word_byte;
  // Tokens <= 15 bytes pack into two big-endian u64 keys with the
  // length folded into the low byte — sorting those is ~5x cheaper
  // than std::string pairs, and they are the overwhelming majority
  // (trigrams are 4 bytes, folded words rarely exceed 14).  Longer
  // tokens (typically exact-index payloads) take the string path.
  struct Short { uint64_t hi, lo; uint32_t idx; };
  std::vector<Short> shorts;
  std::vector<std::pair<std::string, uint32_t>> longs;
  char buf[16];
  auto emit = [&](const char* p, size_t len, uint8_t ident,
                  uint32_t idx) {
    if (len + 1 <= 15) {
      buf[0] = (char)ident;
      memcpy(buf + 1, p, len);
      memset(buf + 1 + len, 0, 15 - 1 - len);
      uint64_t hi = 0, lo = 0;
      for (int k = 0; k < 8; k++) hi = (hi << 8) | (uint8_t)buf[k];
      for (int k = 8; k < 15; k++) lo = (lo << 8) | (uint8_t)buf[k];
      lo = (lo << 8) | (uint8_t)(len + 1);
      shorts.push_back({hi, lo, idx});
    } else {
      std::string t;
      t.reserve(len + 1);
      t.push_back((char)ident);
      t.append(p, len);
      longs.emplace_back(std::move(t), idx);
    }
  };
  std::string cur;
  for (uint32_t i = 0; i < n_vals; i++) {
    const char* s = (const char*)payload + offsets[i];
    size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    if (mode & 8) emit(s, len, ex_id, i);
    if ((mode & 2) && len >= 3)
      for (size_t j = 0; j + 3 <= len; j++) emit(s + j, 3, tri_id, i);
    if (mode & 5) {
      cur.clear();
      for (size_t j = 0; j <= len; j++) {
        if (j < len && word_byte((uint8_t)s[j])) {
          cur.push_back(lower((uint8_t)s[j]));
        } else if (!cur.empty()) {
          if (mode & 1) emit(cur.data(), cur.size(), term_id, i);
          if ((mode & 4) && !dgtok::is_stop(cur)) {
            std::string st = dgtok::porter(cur);
            if (!st.empty()) emit(st.data(), st.size(), ft_id, i);
          }
          cur.clear();
        }
      }
    }
  }
  std::sort(shorts.begin(), shorts.end(),
            [](const Short& a, const Short& b) {
              if (a.hi != b.hi) return a.hi < b.hi;
              if (a.lo != b.lo) return a.lo < b.lo;
              return a.idx < b.idx;
            });
  shorts.erase(std::unique(shorts.begin(), shorts.end(),
                           [](const Short& a, const Short& b) {
                             return a.hi == b.hi && a.lo == b.lo &&
                                    a.idx == b.idx;
                           }),
               shorts.end());
  std::sort(longs.begin(), longs.end());
  longs.erase(std::unique(longs.begin(), longs.end()), longs.end());

  uint64_t n_pairs = shorts.size() + longs.size();
  uint64_t n_toks = 0, payload_len = 0;
  for (size_t k = 0; k < shorts.size(); k++) {
    if (k == 0 || shorts[k].hi != shorts[k - 1].hi ||
        shorts[k].lo != shorts[k - 1].lo) {
      n_toks++;
      payload_len += shorts[k].lo & 0xff;
    }
  }
  for (size_t k = 0; k < longs.size(); k++) {
    if (k == 0 || longs[k].first != longs[k - 1].first) {
      n_toks++;
      payload_len += longs[k].first.size();
    }
  }
  uint8_t* tout = (uint8_t*)malloc(payload_len ? payload_len : 1);
  uint64_t* toffs = (uint64_t*)malloc((n_toks + 1) * sizeof(uint64_t));
  uint32_t* vidx = (uint32_t*)malloc(
      (n_pairs ? n_pairs : 1) * sizeof(uint32_t));
  uint64_t* bounds = (uint64_t*)malloc((n_toks + 1) * sizeof(uint64_t));
  if (!tout || !toffs || !vidx || !bounds) {
    free(tout); free(toffs); free(vidx); free(bounds);
    return -1;
  }
  uint64_t ti = 0, off = 0, pi = 0;
  toffs[0] = 0;
  for (size_t k = 0; k < shorts.size(); k++) {
    if (k == 0 || shorts[k].hi != shorts[k - 1].hi ||
        shorts[k].lo != shorts[k - 1].lo) {
      uint64_t tl = shorts[k].lo & 0xff;
      for (int b = 0; b < 8 && (uint64_t)b < tl; b++)
        tout[off + b] = (uint8_t)(shorts[k].hi >> (8 * (7 - b)));
      for (int b = 8; (uint64_t)b < tl; b++)
        tout[off + b] = (uint8_t)(shorts[k].lo >> (8 * (15 - b)));
      off += tl;
      bounds[ti] = pi;
      ti++;
      toffs[ti] = off;
    }
    vidx[pi++] = shorts[k].idx;
  }
  for (size_t k = 0; k < longs.size(); k++) {
    if (k == 0 || longs[k].first != longs[k - 1].first) {
      const std::string& t = longs[k].first;
      memcpy(tout + off, t.data(), t.size());
      off += t.size();
      bounds[ti] = pi;
      ti++;
      toffs[ti] = off;
    }
    vidx[pi++] = longs[k].second;
  }
  bounds[ti] = n_pairs;
  *tok_out = tout;
  *tok_len_out = payload_len;
  *tok_offs_out = toffs;
  *n_toks_out = n_toks;
  *val_idx_out = vidx;
  *n_pairs_out = n_pairs;
  *bounds_out = bounds;
  return 0;
}

// ---------------------------------------------------------------------------
// Batched RDF N-Quad parser for the bulk loader's map stage (ref
// chunker/rdf_parser.go:58 ParseRDFs; bulk/mapper.go:207 processNQuad).
// After the tokenizer went native, line parsing + per-quad python
// object churn became the 21M bulk load's wall — this parses the
// COMMON statement shape in one pass and returns columnar rows:
//
//   <uid> <pred|word> ( <uid> | "literal"(@lang|^^<dtype>)? ) (facets)? .
//
// one statement per line, uids as 0xHEX or decimal.  Anything else
// (blank nodes, xid iris, uid()/val() terms, multiple statements per
// line, graph labels) is returned as a fallback line span for the
// exact python grammar — bit-identical overall behavior.
//
// Output is ONE malloc'd blob (see layout below) so the ABI stays a
// single out-pointer; python decodes sections with numpy frombuffer.
// All fields are u64 for alignment simplicity; chunks are bounded by
// the caller so the 8-byte-per-field overhead stays in the tens of MB.

namespace dgrdf {

struct Tables {
  std::vector<std::string> items;
  std::map<std::string, uint64_t> ids;
  uint64_t intern(const char* p, size_t len) {
    std::string s(p, len);
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    uint64_t id = items.size();
    ids.emplace(std::move(s), id);
    items.push_back(std::string(p, len));
    return id;
  }
};

static inline bool pred_char(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c == '.' || c == '-' ||
         c == '~' || c == '/';
}

static inline bool lang_char(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c == '-';
}

// "0x..." hex or plain decimal, full span; false on anything python's
// int(ref, 0) would read differently (leading zeros, 0o/0b, signs).
static bool parse_uid(const char* p, size_t len, uint64_t* out) {
  if (len == 0) return false;
  uint64_t v = 0;
  if (len > 2 && p[0] == '0' && (p[1] == 'x' || p[1] == 'X')) {
    for (size_t i = 2; i < len; i++) {
      char c = p[i];
      uint64_t d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return false;
      if (v > (UINT64_MAX - d) / 16) return false;
      v = v * 16 + d;
    }
  } else {
    if (p[0] == '0' && len > 1) return false;  // int(x,0) rejects 010
    for (size_t i = 0; i < len; i++) {
      char c = p[i];
      if (c < '0' || c > '9') return false;
      uint64_t d = c - '0';
      if (v > (UINT64_MAX - d) / 10) return false;
      v = v * 10 + d;
    }
  }
  *out = v;
  return true;
}

}  // namespace dgrdf

extern "C" int dgt_rdf_parse(const uint8_t* text, uint64_t len,
                             uint8_t** blob_out, uint64_t* blob_len) {
  using dgrdf::parse_uid;
  using dgrdf::pred_char;
  const char* t = (const char*)text;
  // edge rows
  std::vector<uint64_t> e_subj, e_dst, e_pred, e_fs, e_fl;
  // value rows
  std::vector<uint64_t> v_subj, v_pred, v_ls, v_ll, v_flags, v_lang,
      v_dtype, v_fs, v_fl;
  // fallback line spans
  std::vector<uint64_t> fb_s, fb_l;
  dgrdf::Tables preds, langs, dtypes;

  uint64_t pos = 0;
  while (pos < len) {
    uint64_t eol = pos;
    while (eol < len && t[eol] != '\n') eol++;
    uint64_t s = pos, e = eol;
    pos = eol + 1;
    while (s < e && (t[s] == ' ' || t[s] == '\t' || t[s] == '\r')) s++;
    while (e > s && (t[e - 1] == ' ' || t[e - 1] == '\t' ||
                     t[e - 1] == '\r')) e--;
    if (s == e || t[s] == '#') continue;
    uint64_t fb_start = s, fb_len_ = e - s;
    const char* L = t;
    uint64_t i = s;
    bool ok = false;
    uint64_t subj = 0, dst = 0;
    uint64_t pred_id = 0;
    do {
      // subject: <uid>
      if (L[i] != '<') break;
      uint64_t j = i + 1;
      while (j < e && L[j] != '>') j++;
      if (j >= e || !parse_uid(L + i + 1, j - i - 1, &subj)) break;
      i = j + 1;
      while (i < e && (L[i] == ' ' || L[i] == '\t')) i++;
      // predicate: <iri> or bare word
      if (i < e && L[i] == '<') {
        j = i + 1;
        while (j < e && L[j] != '>') j++;
        if (j >= e || j == i + 1) break;
        pred_id = preds.intern(L + i + 1, j - i - 1);
        i = j + 1;
      } else {
        j = i;
        while (j < e && pred_char((uint8_t)L[j])) j++;
        if (j == i) break;
        // uid( / val( terms must take the python grammar
        if (j < e && L[j] == '(') break;
        pred_id = preds.intern(L + i, j - i);
        i = j;
      }
      while (i < e && (L[i] == ' ' || L[i] == '\t')) i++;
      if (i >= e) break;
      // object
      bool is_edge = false;
      uint64_t ls = 0, ll = 0, flags = 0, lang_id = UINT64_MAX,
               dt_id = UINT64_MAX;
      if (L[i] == '<') {
        j = i + 1;
        while (j < e && L[j] != '>') j++;
        if (j >= e || !parse_uid(L + i + 1, j - i - 1, &dst)) break;
        is_edge = true;
        i = j + 1;
      } else if (L[i] == '"') {
        j = i + 1;
        bool esc = false;
        while (j < e) {
          if (L[j] == '\\') {
            esc = true;
            j += 2;
            continue;
          }
          if (L[j] == '"') break;
          j++;
        }
        if (j >= e) break;
        ls = i + 1;
        ll = j - i - 1;
        flags = esc ? 1 : 0;
        i = j + 1;
        if (i < e && L[i] == '@') {
          j = i + 1;
          while (j < e && dgrdf::lang_char((uint8_t)L[j])) j++;
          if (j == i + 1) break;
          lang_id = langs.intern(L + i + 1, j - i - 1);
          i = j;
        } else if (i + 2 < e && L[i] == '^' && L[i + 1] == '^' &&
                   L[i + 2] == '<') {
          j = i + 3;
          while (j < e && L[j] != '>') j++;
          if (j >= e || j == i + 3) break;
          dt_id = dtypes.intern(L + i + 3, j - i - 3);
          i = j + 1;
        }
      } else {
        break;
      }
      while (i < e && (L[i] == ' ' || L[i] == '\t')) i++;
      // optional facets: span up to the FIRST ')' (the python
      // grammar's rest.index(')') — match it exactly)
      uint64_t fs = 0, fl = 0;
      if (i < e && L[i] == '(') {
        j = i + 1;
        while (j < e && L[j] != ')') j++;
        if (j >= e) break;
        fs = i + 1;
        fl = j - i - 1;
        i = j + 1;
        while (i < e && (L[i] == ' ' || L[i] == '\t')) i++;
      }
      if (i >= e || L[i] != '.') break;
      i++;
      while (i < e && (L[i] == ' ' || L[i] == '\t')) i++;
      if (i != e) break;  // several statements per line: python path
      if (is_edge) {
        e_subj.push_back(subj);
        e_pred.push_back(pred_id);
        e_dst.push_back(dst);
        e_fs.push_back(fs);
        e_fl.push_back(fl);
      } else {
        v_subj.push_back(subj);
        v_pred.push_back(pred_id);
        v_ls.push_back(ls);
        v_ll.push_back(ll);
        v_flags.push_back(flags);
        v_lang.push_back(lang_id);
        v_dtype.push_back(dt_id);
        v_fs.push_back(fs);
        v_fl.push_back(fl);
      }
      ok = true;
    } while (false);
    if (!ok) {
      fb_s.push_back(fb_start);
      fb_l.push_back(fb_len_);
    }
  }

  // ---- serialize blob: header of u64 counts, then u64 sections ----
  auto table_bytes = [](const dgrdf::Tables& tb) {
    uint64_t n = 0;
    for (auto& s : tb.items) n += s.size();
    return n;
  };
  uint64_t n_e = e_subj.size(), n_v = v_subj.size(), n_fb = fb_s.size();
  uint64_t n_p = preds.items.size(), n_l = langs.items.size(),
           n_d = dtypes.items.size();
  uint64_t pb = table_bytes(preds), lb = table_bytes(langs),
           db = table_bytes(dtypes);
  uint64_t total = 8 * (9  // header
                        + 5 * n_e + 9 * n_v + 2 * n_fb
                        + (n_p + 1) + (n_l + 1) + (n_d + 1))
                   + ((pb + 7) & ~7ull) + ((lb + 7) & ~7ull) +
                   ((db + 7) & ~7ull);
  uint8_t* blob = (uint8_t*)malloc(total ? total : 8);
  if (!blob) return -1;
  uint64_t* w = (uint64_t*)blob;
  *w++ = n_e; *w++ = n_v; *w++ = n_fb;
  *w++ = n_p; *w++ = n_l; *w++ = n_d;
  *w++ = pb; *w++ = lb; *w++ = db;
  auto put = [&](const std::vector<uint64_t>& v) {
    memcpy(w, v.data(), v.size() * 8);
    w += v.size();
  };
  put(e_subj); put(e_pred); put(e_dst); put(e_fs); put(e_fl);
  put(v_subj); put(v_pred); put(v_ls); put(v_ll); put(v_flags);
  put(v_lang); put(v_dtype); put(v_fs); put(v_fl);
  put(fb_s); put(fb_l);
  auto put_table = [&](const dgrdf::Tables& tb, uint64_t nbytes) {
    uint64_t off = 0;
    for (auto& s : tb.items) {
      *w++ = off;
      off += s.size();
    }
    *w++ = off;
    uint8_t* bp = (uint8_t*)w;
    for (auto& s : tb.items) {
      memcpy(bp, s.data(), s.size());
      bp += s.size();
    }
    w = (uint64_t*)((uint8_t*)w + ((nbytes + 7) & ~7ull));
  };
  put_table(preds, pb);
  put_table(langs, lb);
  put_table(dtypes, db);
  *blob_out = blob;
  *blob_len = total;
  return 0;
}
