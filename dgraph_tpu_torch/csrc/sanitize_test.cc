// Sanitizer harness for the native runtime (ASan + UBSan).
//
// The reference runs its Go race detector over the worker/posting
// layers (SURVEY §5.2); the C++ runtime's analogue is this standalone
// binary compiled with -fsanitize=address,undefined: it drives every
// extern "C" entry point — KV store (put/get/del/scan/snapshot/
// crash-reopen), WAL (append/replay/torn-tail), group-varint codec
// (encode/decode round-trips incl. adversarial truncations), and the
// levenshtein matcher — so leaks, overflows and UB surface in CI
// (tests/test_torch_native.py builds it beside csrc/native.cc), not in
// production.
//
// Exit code 0 = all assertions passed and the sanitizers were silent.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>

extern "C" {
void* dgt_kv_open(const char* dir, int sync);
int dgt_kv_put(void*, const uint8_t*, uint32_t, const uint8_t*, uint32_t);
int dgt_kv_del(void*, const uint8_t*, uint32_t);
int64_t dgt_kv_get(void*, const uint8_t*, uint32_t, uint8_t*, uint64_t);
uint64_t dgt_kv_count(void*);
int dgt_kv_flush(void*);
int dgt_kv_snapshot(void*);
void dgt_kv_close(void*);
void* dgt_kv_iter(void*, const uint8_t*, uint32_t);
void dgt_kv_set_memtable(void*, uint64_t);
int dgt_kv_iter_next(void*, uint8_t*, uint64_t, uint64_t*, uint8_t*,
                     uint64_t, uint64_t*);
void dgt_kv_iter_close(void*);
void* dgt_wal_open(const char* path, int sync);
int dgt_wal_append(void*, const uint8_t*, uint64_t);
int dgt_wal_flush(void*);
uint8_t* dgt_wal_replay(void*, uint64_t*, uint64_t*);
int dgt_wal_truncate(void*);
void dgt_wal_close(void*);
void dgt_free(void*);
int dgt_tokenize_batch(const uint8_t*, const uint64_t*, uint32_t,
                       uint32_t, uint8_t, uint8_t, uint8_t, uint8_t,
                       uint8_t**, uint64_t*, uint64_t**, uint64_t*,
                       uint32_t**, uint64_t*, uint64_t**);
int64_t dgt_gv_encode(const uint64_t*, uint64_t, uint8_t*);
int64_t dgt_gv_decode(const uint8_t*, uint64_t, uint64_t*);
uint64_t dgt_gv_count(const uint8_t*, uint64_t);
int32_t dgt_levenshtein(const uint8_t*, uint32_t, const uint8_t*,
                        uint32_t, int32_t);
}

static const uint8_t* B(const char* s) {
  return reinterpret_cast<const uint8_t*>(s);
}

static void test_kv(const std::string& dir) {
  void* kv = dgt_kv_open(dir.c_str(), 0);
  assert(kv);
  for (int i = 0; i < 200; i++) {
    char k[32], v[64];
    snprintf(k, sizeof k, "key/%04d", i);
    snprintf(v, sizeof v, "value-%d-%d", i, i * 7);
    assert(dgt_kv_put(kv, B(k), strlen(k), B(v), strlen(v)) == 0);
  }
  for (int i = 0; i < 200; i += 3) {
    char k[32];
    snprintf(k, sizeof k, "key/%04d", i);
    assert(dgt_kv_del(kv, B(k), strlen(k)) == 0);
  }
  uint8_t out[128];
  assert(dgt_kv_get(kv, B("key/0001"), 8, out, sizeof out) > 0);
  assert(dgt_kv_get(kv, B("key/0000"), 8, out, sizeof out) < 0);
  // scan with prefix
  void* it = dgt_kv_iter(kv, B("key/00"), 6);
  assert(it);
  // contract: returns 0 while an item is available (-1 at end);
  // passing buffers consumes the item
  uint64_t klen, vlen, seen = 0;
  uint8_t kbuf[64], vbuf[128];
  while (dgt_kv_iter_next(it, kbuf, sizeof kbuf, &klen, vbuf,
                          sizeof vbuf, &vlen) == 0)
    seen++;
  dgt_kv_iter_close(it);
  assert(seen > 0);
  assert(dgt_kv_snapshot(kv) == 0);
  uint64_t n = dgt_kv_count(kv);
  dgt_kv_close(kv);
  // crash-reopen: snapshot + wal replay must reproduce the state
  void* kv2 = dgt_kv_open(dir.c_str(), 0);
  assert(kv2);
  assert(dgt_kv_count(kv2) == n);
  assert(dgt_kv_get(kv2, B("key/0001"), 8, out, sizeof out) > 0);
  dgt_kv_close(kv2);
  printf("kv ok (%llu keys)\n", (unsigned long long)n);
}

// LSM shape under sanitizers: a tiny memtable forces many immutable
// runs; tombstone shadowing, cross-run scans, full compaction and
// reopen must all be clean of OOB/UB.
static void test_kv_lsm(const std::string& dir) {
  void* kv = dgt_kv_open(dir.c_str(), 0);
  assert(kv);
  dgt_kv_set_memtable(kv, 1400);
  for (int i = 0; i < 400; i++) {
    char k[32], v[96];
    snprintf(k, sizeof k, "lsm/%05d", i);
    snprintf(v, sizeof v, "payload-%d-%d-%d", i, i * 3, i * 11);
    assert(dgt_kv_put(kv, B(k), strlen(k), B(v), strlen(v)) == 0);
  }
  for (int i = 0; i < 400; i += 5) {
    char k[32];
    snprintf(k, sizeof k, "lsm/%05d", i);
    assert(dgt_kv_del(kv, B(k), strlen(k)) == 0);
  }
  uint8_t out[160];
  assert(dgt_kv_get(kv, B("lsm/00001"), 9, out, sizeof out) > 0);
  assert(dgt_kv_get(kv, B("lsm/00005"), 9, out, sizeof out) < 0);
  uint64_t live = dgt_kv_count(kv);
  assert(live == 400 - 80);
  // iterator pinned across a compaction: shared_ptr keeps old runs
  // mapped until the cursor drops them
  void* it = dgt_kv_iter(kv, B("lsm/001"), 7);
  assert(it);
  assert(dgt_kv_snapshot(kv) == 0);  // full compaction underneath
  uint64_t klen, vlen, seen = 0;
  uint8_t kbuf[64], vbuf[160];
  while (dgt_kv_iter_next(it, kbuf, sizeof kbuf, &klen, vbuf,
                          sizeof vbuf, &vlen) == 0)
    seen++;
  dgt_kv_iter_close(it);
  assert(seen == 80);  // lsm/00100..lsm/00199 minus every 5th
  assert(dgt_kv_count(kv) == live);
  dgt_kv_close(kv);
  void* kv2 = dgt_kv_open(dir.c_str(), 0);
  assert(kv2);
  assert(dgt_kv_count(kv2) == live);
  assert(dgt_kv_get(kv2, B("lsm/00399"), 9, out, sizeof out) > 0);
  dgt_kv_close(kv2);
  printf("kv lsm ok (%llu live)\n", (unsigned long long)live);
}

static void test_wal(const std::string& path) {
  void* w = dgt_wal_open(path.c_str(), 0);
  assert(w);
  for (int i = 0; i < 64; i++) {
    std::string rec(1 + i * 3, char('a' + i % 26));
    assert(dgt_wal_append(w, B(rec.c_str()), rec.size()) == 0);
  }
  dgt_wal_flush(w);
  dgt_wal_close(w);
  // torn tail: append garbage bytes directly, replay must stop clean
  FILE* f = fopen(path.c_str(), "ab");
  fwrite("\x13\x00\x00\x00GARBAGE", 1, 11, f);
  fclose(f);
  void* w2 = dgt_wal_open(path.c_str(), 0);
  uint64_t total = 0, count = 0;
  uint8_t* blob = dgt_wal_replay(w2, &total, &count);
  assert(count == 64);
  dgt_free(blob);
  assert(dgt_wal_truncate(w2) == 0);
  uint8_t* blob2 = dgt_wal_replay(w2, &total, &count);
  assert(count == 0);
  dgt_free(blob2);
  dgt_wal_close(w2);
  printf("wal ok\n");
}

static void test_codec() {
  std::mt19937_64 rng(7);
  for (int trial = 0; trial < 50; trial++) {
    size_t n = rng() % 300;
    std::vector<uint64_t> uids(n);
    uint64_t cur = 0;
    for (auto& u : uids) u = (cur += 1 + rng() % 5000);
    std::vector<uint8_t> buf(n * 10 + 16);
    int64_t len = dgt_gv_encode(uids.data(), n, buf.data());
    assert(len >= 0);
    assert(dgt_gv_count(buf.data(), len) == n);
    std::vector<uint64_t> back(n + 1);
    assert(dgt_gv_decode(buf.data(), len, back.data()) ==
           (int64_t)n);
    assert(memcmp(back.data(), uids.data(), n * 8) == 0);
    // adversarial truncation must fail clean, never read OOB
    for (int64_t cut = 0; cut < len && cut < 24; cut++)
      dgt_gv_decode(buf.data(), cut, back.data());
  }
  printf("codec ok\n");
}

static void test_match() {
  assert(dgt_levenshtein(B("kitten"), 6, B("sitting"), 7, 8) == 3);
  assert(dgt_levenshtein(B(""), 0, B("abc"), 3, 8) == 3);
  assert(dgt_levenshtein(B("same"), 4, B("same"), 4, 8) == 0);
  // max-distance cutoff path
  (void)dgt_levenshtein(B("aaaaaaaaaa"), 10, B("bbbbbbbbbb"), 10, 2);
  printf("match ok\n");
}

static void test_tokenize() {
  // mixed lengths: trigram windows, >15-byte exact tokens, empties,
  // NUL bytes — every output buffer walked end to end under ASan
  const char* vals[] = {"The Running Foxes", "", "ab",
                        "an exact value well over fifteen bytes",
                        "nul\0byte", "x"};
  size_t lens[] = {17, 0, 2, 38, 8, 1};
  std::vector<uint8_t> payload;
  std::vector<uint64_t> offs = {0};
  for (int i = 0; i < 6; i++) {
    payload.insert(payload.end(), (const uint8_t*)vals[i],
                   (const uint8_t*)vals[i] + lens[i]);
    offs.push_back(payload.size());
  }
  uint8_t* tok = nullptr; uint64_t tlen = 0, ntoks = 0, npairs = 0;
  uint64_t* toffs = nullptr; uint64_t* bounds = nullptr;
  uint32_t* vidx = nullptr;
  assert(dgt_tokenize_batch(payload.data(), offs.data(), 6, 15,
                            1, 5, 8, 2, &tok, &tlen, &toffs, &ntoks,
                            &vidx, &npairs, &bounds) == 0);
  assert(ntoks > 0 && npairs >= ntoks);
  uint64_t seen = 0;
  for (uint64_t t = 0; t < ntoks; t++) {
    assert(toffs[t] < toffs[t + 1] && toffs[t + 1] <= tlen);
    for (uint64_t j = toffs[t]; j < toffs[t + 1]; j++)
      (void)tok[j];
    assert(bounds[t] < bounds[t + 1] && bounds[t + 1] <= npairs);
    for (uint64_t p = bounds[t]; p < bounds[t + 1]; p++) {
      assert(vidx[p] < 6);
      seen++;
    }
  }
  assert(seen == npairs);
  dgt_free(tok); dgt_free(toffs); dgt_free(vidx); dgt_free(bounds);
  printf("tokenize ok\n");
}

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : "/tmp/dgt-sanitize";
  test_kv(dir + "/kv");
  test_kv_lsm(dir + "/kvlsm");
  test_wal(dir + "/test.wal");
  test_codec();
  test_match();
  test_tokenize();
  printf("sanitize_test: all ok\n");
  return 0;
}
