// Chunked record file format + asynchronous double-buffered reader.
//
// Capability parity with two reference subsystems, rebuilt for this runtime:
// - the RecordIO chunk files the Go master dispatches as tasks
//   (go/master/service.go:89,280 partitions datasets by chunk), and
// - the async double-buffered data pipeline of
//   gserver/dataproviders/DataProvider.h:249 (DoubleBuffer prefetch
//   thread hiding host IO behind device compute).
//
// Format: file = sequence of chunks.
//   chunk header: magic u32 "PTRC" | num_records u32 | payload_len u32 |
//                 crc32(payload) u32
//   payload: per record varint-free u32 length + bytes.
// Readers can seek chunk-by-chunk (header carries payload_len), enabling
// sharded reads (every k-th chunk) and task-queue dispatch by
// (path, chunk_index) without a central index file.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "common.h"

namespace {

constexpr uint32_t kChunkMagic = 0x50545243;  // "PTRC"

struct Writer {
  FILE* f = nullptr;
  std::string payload;
  uint32_t num_records = 0;
  int64_t max_chunk_bytes = 1 << 20;

  int flush_chunk() {
    if (num_records == 0) return 0;
    std::string hdr;
    pt::put<uint32_t>(&hdr, kChunkMagic);
    pt::put<uint32_t>(&hdr, num_records);
    pt::put<uint32_t>(&hdr, static_cast<uint32_t>(payload.size()));
    pt::put<uint32_t>(&hdr, pt::crc32(payload.data(), payload.size()));
    if (fwrite(hdr.data(), 1, hdr.size(), f) != hdr.size()) return -1;
    if (fwrite(payload.data(), 1, payload.size(), f) != payload.size())
      return -1;
    payload.clear();
    num_records = 0;
    return 0;
  }
};

// pt_recordio_next/peek_len sentinels (length >= 0 means a record, so an
// empty record is representable and does not terminate iteration)
constexpr int64_t kTooSmall = -1;
constexpr int64_t kReadError = -2;
constexpr int64_t kEof = -3;

struct Reader {
  // (path, chunk stride/offset) sharding
  std::vector<std::string> paths;
  int start_chunk = 0, step_chunk = 1;
  // bounded prefetch queue of decoded records
  std::deque<std::string> queue;
  size_t max_queued = 4096;
  std::mutex mu;
  std::condition_variable cv_can_push, cv_can_pop;
  std::thread worker;
  std::atomic<bool> done{false}, stop{false};
  std::string error;

  void run() {
    int64_t global_chunk = 0;
    for (const auto& path : paths) {
      FILE* f = fopen(path.c_str(), "rb");
      if (!f) {
        std::lock_guard<std::mutex> l(mu);
        error = "open failed: " + path;
        break;
      }
      // file size, to catch fseek-past-EOF on skipped chunks
      fseek(f, 0, SEEK_END);
      long fsize = ftell(f);
      fseek(f, 0, SEEK_SET);
      while (!stop.load()) {
        char hdr[16];
        size_t got = fread(hdr, 1, 16, f);
        if (got == 0) break;  // clean EOF
        if (got != 16) {
          std::lock_guard<std::mutex> l(mu);
          error = "truncated chunk header: " + path;
          break;
        }
        uint32_t magic, nrec, plen, crc;
        std::memcpy(&magic, hdr, 4);
        std::memcpy(&nrec, hdr + 4, 4);
        std::memcpy(&plen, hdr + 8, 4);
        std::memcpy(&crc, hdr + 12, 4);
        if (magic != kChunkMagic) {
          std::lock_guard<std::mutex> l(mu);
          error = "bad chunk magic: " + path;
          break;
        }
        bool mine = (global_chunk - start_chunk) % step_chunk == 0 &&
                    global_chunk >= start_chunk;
        global_chunk++;
        if (!mine) {  // skip payload without decoding
          // fseek past EOF "succeeds" on regular files — validate the
          // target so a truncated tail is an error for every shard, not
          // just the one that owns the chunk
          if (fseek(f, plen, SEEK_CUR) != 0 || ftell(f) > fsize) {
            std::lock_guard<std::mutex> l(mu);
            error = "truncated chunk payload (skipped): " + path;
            break;
          }
          continue;
        }
        std::string payload(plen, '\0');
        if (fread(payload.data(), 1, plen, f) != plen) {
          std::lock_guard<std::mutex> l(mu);
          error = "truncated chunk payload: " + path;
          break;
        }
        if (pt::crc32(payload.data(), payload.size()) != crc) {
          std::lock_guard<std::mutex> l(mu);
          error = "chunk crc mismatch: " + path;
          break;
        }
        const char* p = payload.data();
        const char* end = p + payload.size();
        for (uint32_t i = 0; i < nrec && !stop.load(); i++) {
          uint32_t rlen;
          if (!pt::get(&p, end, &rlen) ||
              end - p < static_cast<ptrdiff_t>(rlen)) {
            std::lock_guard<std::mutex> l(mu);
            error = "corrupt record in: " + path;
            break;
          }
          std::unique_lock<std::mutex> l(mu);
          cv_can_push.wait(
              l, [&] { return queue.size() < max_queued || stop.load(); });
          if (stop.load()) break;
          queue.emplace_back(p, rlen);
          p += rlen;
          cv_can_pop.notify_one();
        }
        {
          std::lock_guard<std::mutex> l(mu);
          if (!error.empty()) break;
        }
      }
      fclose(f);
      {
        std::lock_guard<std::mutex> l(mu);
        if (!error.empty()) break;
      }
      if (stop.load()) break;
    }
    {
      // set under mu: a consumer that just evaluated its wait predicate
      // (queue empty, done false) must not be able to block after this
      // store without seeing the notify (lost-wakeup)
      std::lock_guard<std::mutex> l(mu);
      done.store(true);
    }
    cv_can_pop.notify_all();
  }
};

}  // namespace

extern "C" {

// ---------------- writer ----------------
Writer* pt_recordio_writer_open(const char* path, int64_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  if (max_chunk_bytes > 0) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int pt_recordio_write(Writer* w, const char* data, int64_t len) {
  pt::put<uint32_t>(&w->payload, static_cast<uint32_t>(len));
  w->payload.append(data, static_cast<size_t>(len));
  w->num_records++;
  if (static_cast<int64_t>(w->payload.size()) >= w->max_chunk_bytes)
    return w->flush_chunk();
  return 0;
}

int pt_recordio_writer_close(Writer* w) {
  int rc = w->flush_chunk();
  fclose(w->f);
  delete w;
  return rc;
}

// ---------------- reader ----------------
Reader* pt_recordio_reader_open(const char** paths, int n_paths,
                                int start_chunk, int step_chunk,
                                int max_queued) {
  auto* r = new Reader();
  for (int i = 0; i < n_paths; i++) r->paths.emplace_back(paths[i]);
  r->start_chunk = start_chunk;
  r->step_chunk = step_chunk > 0 ? step_chunk : 1;
  if (max_queued > 0) r->max_queued = max_queued;
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Returns record length (>= 0, empty records are valid); -3 = end of
// data; -1 = caller buffer too small (call again with >=
// pt_recordio_peek_len bytes); -2 = read error.
int64_t pt_recordio_next(Reader* r, char* buf, int64_t cap) {
  std::unique_lock<std::mutex> l(r->mu);
  r->cv_can_pop.wait(l, [&] { return !r->queue.empty() || r->done.load(); });
  if (r->queue.empty()) return r->error.empty() ? kEof : kReadError;
  const std::string& rec = r->queue.front();
  if (static_cast<int64_t>(rec.size()) > cap) return kTooSmall;
  int64_t n = static_cast<int64_t>(rec.size());
  std::memcpy(buf, rec.data(), rec.size());
  r->queue.pop_front();
  r->cv_can_push.notify_one();
  return n;
}

int64_t pt_recordio_peek_len(Reader* r) {
  std::unique_lock<std::mutex> l(r->mu);
  r->cv_can_pop.wait(l, [&] { return !r->queue.empty() || r->done.load(); });
  if (r->queue.empty()) return r->error.empty() ? kEof : kReadError;
  return static_cast<int64_t>(r->queue.front().size());
}

const char* pt_recordio_error(Reader* r) {
  std::lock_guard<std::mutex> l(r->mu);
  return r->error.empty() ? nullptr : r->error.c_str();
}

void pt_recordio_reader_close(Reader* r) {
  {
    // set under mu so the worker can't block on a full queue between
    // evaluating its wait predicate and this store (lost-wakeup)
    std::lock_guard<std::mutex> l(r->mu);
    r->stop.store(true);
  }
  r->cv_can_push.notify_all();
  r->cv_can_pop.notify_all();
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

// Count chunks in a file by walking headers (for task partitioning).
int64_t pt_recordio_count_chunks(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  int64_t count = 0;
  for (;;) {
    char hdr[16];
    size_t got = fread(hdr, 1, 16, f);
    if (got == 0) break;
    if (got != 16) { count = -2; break; }
    uint32_t magic, plen;
    std::memcpy(&magic, hdr, 4);
    std::memcpy(&plen, hdr + 8, 4);
    if (magic != kChunkMagic) { count = -2; break; }
    // fseek past EOF "succeeds" on regular files — a truncated final
    // chunk must be a partition-time error, not N worker lease failures
    if (fseek(f, plen, SEEK_CUR) != 0 || ftell(f) > fsize) {
      count = -2;
      break;
    }
    count++;
  }
  fclose(f);
  return count;
}

}  // extern "C"
