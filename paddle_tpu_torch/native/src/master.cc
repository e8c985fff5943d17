// Elastic task-queue master (fault-tolerant input dispatch).
//
// Capability parity with the reference's Go master
// (go/master/service.go): todo/pending/done task queues over dataset
// chunks, lease timeouts that requeue lost tasks, a per-task failure cap
// that discards poison tasks, pass rotation (done -> todo), and
// CRC-protected snapshot/restore so a restarted master resumes where it
// left off (service.go:89,166,207,313-356,448). etcd is replaced by a
// snapshot file the coordinator host owns — rebuilt in C++ as a
// lock-protected in-process service callable from any trainer process.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace {

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Task {
  int64_t id = 0;
  std::string payload;
  int failures = 0;
};

struct Master {
  double lease_seconds = 60.0;
  int failure_max = 3;
  int64_t next_id = 1;
  int64_t next_lease = 1;  // lease ids are fresh per lease: a worker
                           // holding an expired lease cannot ack a task
                           // that was re-leased to someone else (the Go
                           // master's epoch check, service.go:410)
  std::deque<Task> todo;
  std::unordered_map<int64_t, std::pair<Task, double>> pending;  // lease -> (task, deadline)
  std::vector<Task> done;
  std::vector<Task> discarded;
  // save-model election (go/master/service.go:467-495): the granted
  // trainer holds the save slot until block_dur elapses; re-requests by
  // the same trainer are re-granted. Transient — not snapshotted.
  std::string saving_trainer;
  double saving_deadline = 0.0;
  std::mutex mu;

  void requeue_expired_locked() {
    double t = now_s();
    for (auto it = pending.begin(); it != pending.end();) {
      if (it->second.second <= t) {
        Task task = std::move(it->second.first);
        task.failures++;
        it = pending.erase(it);
        if (task.failures >= failure_max) {
          discarded.push_back(std::move(task));
        } else {
          todo.push_back(std::move(task));
        }
      } else {
        ++it;
      }
    }
  }
};

constexpr uint32_t kSnapMagic = 0x50544d53;  // "PTMS"

void put_task(std::string* buf, const Task& t) {
  pt::put<int64_t>(buf, t.id);
  pt::put<int32_t>(buf, t.failures);
  pt::put<uint32_t>(buf, static_cast<uint32_t>(t.payload.size()));
  buf->append(t.payload);
}

bool get_task(const char** p, const char* end, Task* t) {
  uint32_t plen;
  int32_t fails;
  if (!pt::get(p, end, &t->id)) return false;
  if (!pt::get(p, end, &fails)) return false;
  if (!pt::get(p, end, &plen)) return false;
  if (end - *p < static_cast<ptrdiff_t>(plen)) return false;
  t->failures = fails;
  t->payload.assign(*p, plen);
  *p += plen;
  return true;
}

}  // namespace

extern "C" {

Master* pt_master_create(double lease_seconds, int failure_max) {
  auto* m = new Master();
  if (lease_seconds >= 0) m->lease_seconds = lease_seconds;
  if (failure_max > 0) m->failure_max = failure_max;
  return m;
}

void pt_master_destroy(Master* m) { delete m; }

int64_t pt_master_add_task(Master* m, const char* payload, int64_t len) {
  std::lock_guard<std::mutex> l(m->mu);
  Task t;
  t.id = m->next_id++;
  t.payload.assign(payload, static_cast<size_t>(len));
  m->todo.push_back(std::move(t));
  return m->next_id - 1;
}

// Lease the next task. Returns payload length (>= 0; empty payloads are
// valid), -3 if no task is currently available, -1 if buf too small (the
// task is NOT leased; *task_id receives the required size so the caller
// can retry with a larger buffer instead of wedging the queue head).
// On success task_id receives the lease id to report done/failed against.
int64_t pt_master_get_task(Master* m, char* buf, int64_t cap,
                           int64_t* task_id) {
  std::lock_guard<std::mutex> l(m->mu);
  m->requeue_expired_locked();
  if (m->todo.empty()) return -3;
  Task& t = m->todo.front();
  if (static_cast<int64_t>(t.payload.size()) > cap) {
    *task_id = static_cast<int64_t>(t.payload.size());
    return -1;
  }
  int64_t n = static_cast<int64_t>(t.payload.size());
  std::memcpy(buf, t.payload.data(), t.payload.size());
  int64_t lease = m->next_lease++;
  *task_id = lease;
  m->pending[lease] = {std::move(t), now_s() + m->lease_seconds};
  m->todo.pop_front();
  return n;
}

int pt_master_task_done(Master* m, int64_t task_id) {
  std::lock_guard<std::mutex> l(m->mu);
  auto it = m->pending.find(task_id);
  if (it == m->pending.end()) return -1;  // lease lost (timed out)
  m->done.push_back(std::move(it->second.first));
  m->pending.erase(it);
  return 0;
}

int pt_master_task_failed(Master* m, int64_t task_id) {
  std::lock_guard<std::mutex> l(m->mu);
  auto it = m->pending.find(task_id);
  if (it == m->pending.end()) return -1;
  Task t = std::move(it->second.first);
  m->pending.erase(it);
  t.failures++;
  if (t.failures >= m->failure_max) {
    m->discarded.push_back(std::move(t));
  } else {
    m->todo.push_back(std::move(t));
  }
  return 0;
}

// All tasks finished this pass? (todo and pending empty)
int pt_master_pass_finished(Master* m) {
  std::lock_guard<std::mutex> l(m->mu);
  m->requeue_expired_locked();
  return m->todo.empty() && m->pending.empty() ? 1 : 0;
}

// Rotate done -> todo for the next pass (service.go's pass semantics).
int64_t pt_master_start_pass(Master* m) {
  std::lock_guard<std::mutex> l(m->mu);
  for (auto& t : m->done) {
    t.failures = 0;
    m->todo.push_back(std::move(t));
  }
  m->done.clear();
  return static_cast<int64_t>(m->todo.size());
}

int64_t pt_master_count(Master* m, int which) {
  std::lock_guard<std::mutex> l(m->mu);
  m->requeue_expired_locked();
  switch (which) {
    case 0: return static_cast<int64_t>(m->todo.size());
    case 1: return static_cast<int64_t>(m->pending.size());
    case 2: return static_cast<int64_t>(m->done.size());
    case 3: return static_cast<int64_t>(m->discarded.size());
    default: return -1;
  }
}

// Save-model election (go/master/service.go:467-495 RequestSaveModel):
// returns 1 if `trainer_id` should save (it becomes the saving trainer
// for `block_seconds`), 0 if another trainer holds the slot, -1 on empty
// trainer id.
int pt_master_request_save(Master* m, const char* trainer_id,
                           double block_seconds) {
  if (!trainer_id || !*trainer_id) return -1;
  std::lock_guard<std::mutex> l(m->mu);
  double t = now_s();
  bool need = m->saving_trainer.empty() || m->saving_deadline <= t ||
              m->saving_trainer == trainer_id;
  if (need) {
    m->saving_trainer = trainer_id;
    m->saving_deadline = t + block_seconds;
  }
  return need ? 1 : 0;
}

void pt_master_set_lease(Master* m, double lease_seconds) {
  std::lock_guard<std::mutex> l(m->mu);
  m->lease_seconds = lease_seconds;
}

// ---- snapshot / restore ----
// Pending tasks snapshot into todo (a restarted master re-issues them —
// same semantics as the Go master recovering from etcd).

int pt_master_snapshot(Master* m, const char* path) {
  std::lock_guard<std::mutex> l(m->mu);
  std::string buf;
  pt::put<uint32_t>(&buf, kSnapMagic);
  pt::put<uint32_t>(&buf, 1u);
  pt::put<int64_t>(&buf, m->next_id);
  pt::put<double>(&buf, m->lease_seconds);
  pt::put<int32_t>(&buf, m->failure_max);
  auto dump = [&buf](const auto& seq) {
    pt::put<uint32_t>(&buf, static_cast<uint32_t>(seq.size()));
    for (const auto& t : seq) put_task(&buf, t);
  };
  // todo + pending together: a pending lease does not survive restart
  pt::put<uint32_t>(&buf,
                    static_cast<uint32_t>(m->todo.size() + m->pending.size()));
  for (const auto& t : m->todo) put_task(&buf, t);
  for (const auto& kv : m->pending) put_task(&buf, kv.second.first);
  dump(m->done);
  dump(m->discarded);
  pt::put<uint32_t>(&buf, pt::crc32(buf.data(), buf.size()));
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  bool ok = fwrite(buf.data(), 1, buf.size(), f) == buf.size();
  ok = (fclose(f) == 0) && ok;
  if (!ok) return -1;
  return rename(tmp.c_str(), path) == 0 ? 0 : -1;
}

Master* pt_master_restore(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  std::string buf;
  char tmp[1 << 16];
  size_t got;
  while ((got = fread(tmp, 1, sizeof(tmp), f)) > 0) buf.append(tmp, got);
  fclose(f);
  if (buf.size() < 8) return nullptr;
  uint32_t crc_stored;
  std::memcpy(&crc_stored, buf.data() + buf.size() - 4, 4);
  if (pt::crc32(buf.data(), buf.size() - 4) != crc_stored) return nullptr;
  const char* p = buf.data();
  const char* end = buf.data() + buf.size() - 4;
  uint32_t magic, version;
  if (!pt::get(&p, end, &magic) || magic != kSnapMagic) return nullptr;
  if (!pt::get(&p, end, &version) || version != 1) return nullptr;
  auto* m = new Master();
  int32_t fmax;
  if (!pt::get(&p, end, &m->next_id) ||
      !pt::get(&p, end, &m->lease_seconds) || !pt::get(&p, end, &fmax)) {
    delete m;
    return nullptr;
  }
  m->failure_max = fmax;
  auto load = [&p, end](auto* out) -> bool {
    uint32_t n;
    if (!pt::get(&p, end, &n)) return false;
    for (uint32_t i = 0; i < n; i++) {
      Task t;
      if (!get_task(&p, end, &t)) return false;
      out->push_back(std::move(t));
    }
    return true;
  };
  if (!load(&m->todo) || !load(&m->done) || !load(&m->discarded)) {
    delete m;
    return nullptr;
  }
  return m;
}

}  // extern "C"
