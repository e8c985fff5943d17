// Networked elastic master: a TCP server over the task-queue master in
// master.cc, making the fault-tolerance capability available ACROSS
// processes and hosts — the counterpart of the reference's Go master RPC
// service (go/master/service.go:89-495; trainers connect via
// go/master/client.go / c/client.go). etcd is replaced by the snapshot
// file the serving host owns (periodic + on shutdown).
//
// Wire protocol (little-endian, length-prefixed):
//   request:  [u32 body_len][u8 op][body ...]
//   response: [u32 body_len][i64 status][body ...]
// Ops: 1 ADD_TASK(payload) -> status=task id
//      2 GET_TASK() -> status=payload len or -3 none; body=[i64 lease][payload]
//      3 TASK_DONE([i64 lease]) -> 0 / -1 lease lost
//      4 TASK_FAILED([i64 lease]) -> 0 / -1
//      5 PASS_FINISHED() -> 1 / 0
//      6 START_PASS() -> todo count
//      7 COUNT([i32 which]) -> count
//      8 SET_LEASE([f64 seconds]) -> 0
//      9 SNAPSHOT() -> 0 / -1 (uses the server's snapshot path)
//     10 REQUEST_SAVE([f64 block_s][trainer_id bytes]) -> 1 grant / 0 deny
//     11 PING() -> 0
//     12 SHUTDOWN() -> 0, then the server stops accepting and exits
//
// Threading: accept loop + thread per connection (a handful of trainer
// processes; the reference's Go side likewise serves net/rpc with a
// goroutine per conn). All master state is behind Master's own mutex.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

struct Master;  // opaque; we only use the extern "C" master API
extern "C" {
int64_t pt_master_add_task(Master*, const char*, int64_t);
int64_t pt_master_get_task(Master*, char*, int64_t, int64_t*);
int pt_master_task_done(Master*, int64_t);
int pt_master_task_failed(Master*, int64_t);
int pt_master_pass_finished(Master*);
int64_t pt_master_start_pass(Master*);
int64_t pt_master_count(Master*, int);
void pt_master_set_lease(Master*, double);
int pt_master_snapshot(Master*, const char*);
int pt_master_request_save(Master*, const char*, double);
}

namespace {

struct Server {
  Master* m = nullptr;
  int listen_fd = -1;
  int port = 0;
  std::string snapshot_path;
  double snapshot_every = 0.0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::thread snapshot_thread;
  // live connection sockets: stop() shuts them down so their threads'
  // blocking recv returns, then waits for active_conns to drain before
  // the Server is freed (no use-after-free on s->m / snapshot_path)
  std::mutex conns_mu;
  std::set<int> conn_fds;
  std::atomic<int> active_conns{0};
  bool listen_closed = false;  // guarded by conns_mu
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t got = recv(fd, p, n, 0);
    if (got <= 0) return false;
    p += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t put = send(fd, p, n, MSG_NOSIGNAL);
    if (put <= 0) return false;
    p += put;
    n -= static_cast<size_t>(put);
  }
  return true;
}

bool respond(int fd, int64_t status, const std::string& body) {
  uint32_t len = static_cast<uint32_t>(8 + body.size());
  std::string out;
  out.reserve(4 + len);
  out.append(reinterpret_cast<const char*>(&len), 4);
  out.append(reinterpret_cast<const char*>(&status), 8);
  out.append(body);
  return write_full(fd, out.data(), out.size());
}

template <typename T>
bool pop(const char** p, const char* end, T* v) {
  if (end - *p < static_cast<ptrdiff_t>(sizeof(T))) return false;
  std::memcpy(v, *p, sizeof(T));
  *p += sizeof(T);
  return true;
}

void handle_conn(Server* s, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<char> task_buf(1 << 20);
  for (;;) {
    uint32_t len;
    if (!read_full(fd, &len, 4)) break;
    if (len < 1 || len > (64u << 20)) break;  // corrupt/hostile frame
    std::string req(len, '\0');
    if (!read_full(fd, req.data(), len)) break;
    uint8_t op = static_cast<uint8_t>(req[0]);
    const char* p = req.data() + 1;
    const char* end = req.data() + req.size();
    bool ok = true;
    switch (op) {
      case 1:  // ADD_TASK
        ok = respond(fd, pt_master_add_task(s->m, p, end - p), "");
        break;
      case 2: {  // GET_TASK
        int64_t lease = 0;
        int64_t n;
        for (;;) {
          n = pt_master_get_task(s->m, task_buf.data(),
                                 static_cast<int64_t>(task_buf.size()),
                                 &lease);
          if (n == -1) {  // buffer too small; lease holds required size
            task_buf.resize(static_cast<size_t>(lease));
            continue;
          }
          break;
        }
        if (n < 0) {
          ok = respond(fd, n, "");
        } else {
          std::string body(reinterpret_cast<const char*>(&lease), 8);
          body.append(task_buf.data(), static_cast<size_t>(n));
          ok = respond(fd, n, body);
        }
        break;
      }
      case 3:
      case 4: {
        int64_t lease;
        if (!pop(&p, end, &lease)) {
          ok = respond(fd, -2, "");
          break;
        }
        int r = op == 3 ? pt_master_task_done(s->m, lease)
                        : pt_master_task_failed(s->m, lease);
        ok = respond(fd, r, "");
        break;
      }
      case 5:
        ok = respond(fd, pt_master_pass_finished(s->m), "");
        break;
      case 6:
        ok = respond(fd, pt_master_start_pass(s->m), "");
        break;
      case 7: {
        int32_t which;
        if (!pop(&p, end, &which)) {
          ok = respond(fd, -2, "");
          break;
        }
        ok = respond(fd, pt_master_count(s->m, which), "");
        break;
      }
      case 8: {
        double secs;
        if (!pop(&p, end, &secs)) {
          ok = respond(fd, -2, "");
          break;
        }
        pt_master_set_lease(s->m, secs);
        ok = respond(fd, 0, "");
        break;
      }
      case 9:
        ok = respond(fd,
                     s->snapshot_path.empty()
                         ? -2
                         : pt_master_snapshot(s->m, s->snapshot_path.c_str()),
                     "");
        break;
      case 10: {  // REQUEST_SAVE
        double block_s;
        if (!pop(&p, end, &block_s)) {
          ok = respond(fd, -2, "");
          break;
        }
        std::string trainer(p, end - p);
        ok = respond(fd, pt_master_request_save(s->m, trainer.c_str(), block_s),
                     "");
        break;
      }
      case 11:
        ok = respond(fd, 0, "");
        break;
      case 12:
        respond(fd, 0, "");
        s->stop.store(true);
        // unblock the accept loop; conn_main closes this socket.
        // listen_fd shutdown is guarded so it cannot race stop()'s
        // close() onto a recycled descriptor
        {
          std::lock_guard<std::mutex> g(s->conns_mu);
          if (!s->listen_closed) shutdown(s->listen_fd, SHUT_RDWR);
        }
        return;
      default:
        ok = respond(fd, -100, "");
    }
    if (!ok) break;
  }
}

// registers the connection, runs handle_conn, deregisters — the unit
// the detached per-connection threads execute. The socket is closed
// here under the registry lock so stop() can never shutdown() a
// recycled descriptor.
void conn_main(Server* s, int fd) {
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    s->conn_fds.insert(fd);
    // stop() may have swept conn_fds between our accept and this
    // registration — shut the socket down ourselves so recv returns
    if (s->stop.load()) shutdown(fd, SHUT_RDWR);
  }
  handle_conn(s, fd);
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    s->conn_fds.erase(fd);
    close(fd);
  }
  s->active_conns.fetch_sub(1);
}

}  // namespace

extern "C" {

// Start serving `m` on `port` (0 = ephemeral). Returns a Server handle,
// or nullptr on bind failure. `snapshot_path` (nullable) enables the
// SNAPSHOT op and, with snapshot_every_s > 0, periodic snapshots.
// The caller keeps ownership of `m` and must not destroy it until after
// pt_master_server_stop.
Server* pt_master_server_start(Master* m, int port, const char* snapshot_path,
                               double snapshot_every_s) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);

  auto* s = new Server();
  s->m = m;
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  if (snapshot_path) s->snapshot_path = snapshot_path;
  s->snapshot_every = snapshot_every_s;

  s->accept_thread = std::thread([s] {
    while (!s->stop.load()) {
      int cfd = accept(s->listen_fd, nullptr, nullptr);
      if (cfd < 0) {
        if (s->stop.load()) break;
        continue;
      }
      // detached but registered: stop() shuts the sockets down and
      // waits for the count to drain before freeing the Server
      s->active_conns.fetch_add(1);
      std::thread(conn_main, s, cfd).detach();
    }
  });
  if (!s->snapshot_path.empty() && snapshot_every_s > 0) {
    s->snapshot_thread = std::thread([s] {
      while (!s->stop.load()) {
        // sleep in 50 ms slices so stop is honored promptly
        for (double t = 0; t < s->snapshot_every && !s->stop.load();
             t += 0.05)
          std::this_thread::sleep_for(std::chrono::milliseconds(50));
        if (s->stop.load()) break;
        pt_master_snapshot(s->m, s->snapshot_path.c_str());
      }
    });
  }
  return s;
}

int pt_master_server_port(Server* s) { return s ? s->port : -1; }

int pt_master_server_stopped(Server* s) {
  return s && s->stop.load() ? 1 : 0;
}

// Stop accepting, join service threads, force open connections closed
// and wait for their threads to drain, snapshot one last time if
// configured. If a connection thread is wedged past the drain timeout
// the Server is intentionally leaked instead of freed under it.
void pt_master_server_stop(Server* s) {
  if (!s) return;
  s->stop.store(true);
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    shutdown(s->listen_fd, SHUT_RDWR);
    close(s->listen_fd);
    s->listen_closed = true;
  }
  if (s->accept_thread.joinable()) s->accept_thread.join();
  if (s->snapshot_thread.joinable()) s->snapshot_thread.join();
  {
    // unblock every connection thread's recv
    std::lock_guard<std::mutex> g(s->conns_mu);
    for (int fd : s->conn_fds) shutdown(fd, SHUT_RDWR);
  }
  for (int waited_ms = 0;
       s->active_conns.load() > 0 && waited_ms < 5000; waited_ms += 10)
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  if (!s->snapshot_path.empty())
    pt_master_snapshot(s->m, s->snapshot_path.c_str());
  if (s->active_conns.load() > 0) return;  // leak rather than UAF
  delete s;
}

}  // extern "C"
