// Native TCP message transport for cross-silo federated deployment (the
// PyTorch port's copy of neuroimagedisttraining_tpu/native/comm/
// tcp_comm.cpp, built by neuroimagedisttraining_torch/comm/tcp.py).
//
// Rebuild of the reference's native-underneath comm backends
// (fedml_core/distributed/communication/: mpi4py point-to-point with pickled
// payloads + 0.3s polling, gRPC unary JSON, MQTT pub/sub). Design deltas:
//   * one always-on listener thread per rank, blocking condvar queue —
//     no poll loops (the reference sleeps 0.3 s between queue checks,
//     mpi/com_manager.py:90-93)
//   * length-prefixed binary frames — no JSON/pickle in the hot path;
//     payload encoding is the caller's concern (the Python layer ships
//     flattened pytree leaves as raw bytes)
//   * cached outbound connections (the reference's gRPC backend reopens a
//     channel per send, grpc_comm_manager.py:45-55)
//
// C ABI (ctypes-friendly):
//   comm_init(rank, world, hosts, ports) -> handle
//   comm_send(handle, dest, buf, len)    -> 0 on success
//   comm_recv(handle, &buf, &len, timeout_s) -> 0 on message, 1 on timeout
//   comm_free_buf(buf), comm_finalize(handle)

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
};

struct Comm {
  int rank = -1;
  int world = 0;
  int listen_fd = -1;
  std::vector<std::string> hosts;
  std::vector<int> ports;
  std::vector<int> out_fds;  // cached outbound sockets, -1 = not connected
  std::mutex out_mu;

  std::deque<Frame> queue;
  std::mutex mu;
  std::condition_variable cv;
  bool stopping = false;
  int recv_waiters = 0;  // threads inside comm_recv; finalize drains them

  std::thread listener;
  std::vector<std::thread> readers;
  std::vector<int> reader_fds;
  std::mutex readers_mu;
};

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

void reader_loop(Comm* c, int fd) {
  for (;;) {
    uint32_t len_be = 0;
    if (!read_exact(fd, &len_be, 4)) break;
    uint32_t len = ntohl(len_be);
    Frame f;
    f.data.resize(len);
    if (len > 0 && !read_exact(fd, f.data.data(), len)) break;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      if (c->stopping) break;
      c->queue.push_back(std::move(f));
    }
    c->cv.notify_one();
  }
  // fd is closed by comm_finalize (closing here would race fd reuse
  // against finalize's shutdown() of the same descriptor number)
}

void listen_loop(Comm* c) {
  for (;;) {
    int fd = ::accept(c->listen_fd, nullptr, nullptr);
    if (fd < 0) break;  // listen_fd closed => shutting down
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::lock_guard<std::mutex> lk(c->readers_mu);
    if (c->stopping) {
      ::close(fd);
      break;
    }
    c->reader_fds.push_back(fd);
    c->readers.emplace_back(reader_loop, c, fd);
  }
}

int connect_to(const std::string& host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

}  // namespace

extern "C" {

void* comm_init(int rank, int world, const char** hosts, const int* ports) {
  auto* c = new Comm;
  c->rank = rank;
  c->world = world;
  for (int i = 0; i < world; ++i) {
    c->hosts.emplace_back(hosts[i]);
    c->ports.push_back(ports[i]);
    c->out_fds.push_back(-1);
  }
  c->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (c->listen_fd < 0) {
    delete c;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(c->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(ports[rank]));
  if (::bind(c->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(c->listen_fd, world + 8) != 0) {
    ::close(c->listen_fd);
    delete c;
    return nullptr;
  }
  c->listener = std::thread(listen_loop, c);
  return c;
}

int comm_send(void* handle, int dest, const uint8_t* buf, uint32_t len) {
  auto* c = static_cast<Comm*>(handle);
  if (!c || dest < 0 || dest >= c->world) return -1;
  std::lock_guard<std::mutex> lk(c->out_mu);
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (c->out_fds[dest] < 0) {
      // peers may start in any order: retry connect briefly
      for (int tries = 0; tries < 50 && c->out_fds[dest] < 0; ++tries) {
        c->out_fds[dest] = connect_to(c->hosts[dest], c->ports[dest]);
        if (c->out_fds[dest] < 0)
          std::this_thread::sleep_for(std::chrono::milliseconds(100));
      }
      if (c->out_fds[dest] < 0) return -2;
    }
    uint32_t len_be = htonl(len);
    if (write_exact(c->out_fds[dest], &len_be, 4) &&
        (len == 0 || write_exact(c->out_fds[dest], buf, len))) {
      return 0;
    }
    ::close(c->out_fds[dest]);  // stale cached socket: reconnect once
    c->out_fds[dest] = -1;
  }
  return -3;
}

int comm_recv(void* handle, uint8_t** buf_out, uint32_t* len_out,
              double timeout_s) {
  auto* c = static_cast<Comm*>(handle);
  if (!c) return -1;
  std::unique_lock<std::mutex> lk(c->mu);
  c->recv_waiters++;
  auto ready = [c] { return c->stopping || !c->queue.empty(); };
  bool timed_out = false;
  if (timeout_s < 0) {
    c->cv.wait(lk, ready);
  } else if (!c->cv.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), ready)) {
    timed_out = true;
  }
  c->recv_waiters--;
  // notify while holding the lock: after unlock this thread must not touch
  // *c again (a draining finalize may delete it the moment the lock drops)
  if (timed_out || c->queue.empty()) {
    bool stopping = c->stopping;
    c->cv.notify_all();  // wake a draining finalize to re-check waiters
    lk.unlock();
    return stopping ? -1 : 1;
  }
  Frame f = std::move(c->queue.front());
  c->queue.pop_front();
  c->cv.notify_all();
  lk.unlock();
  *len_out = static_cast<uint32_t>(f.data.size());
  *buf_out = static_cast<uint8_t*>(std::malloc(f.data.size()));
  if (*buf_out == nullptr && !f.data.empty()) return -1;
  std::memcpy(*buf_out, f.data.data(), f.data.size());
  return 0;
}

void comm_free_buf(uint8_t* buf) { std::free(buf); }

int comm_pending(void* handle) {
  auto* c = static_cast<Comm*>(handle);
  if (!c) return 0;
  std::lock_guard<std::mutex> lk(c->mu);
  return static_cast<int>(c->queue.size());
}

void comm_finalize(void* handle) {
  auto* c = static_cast<Comm*>(handle);
  if (!c) return;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->stopping = true;
  }
  c->cv.notify_all();
  {
    // drain threads still blocked in comm_recv before tearing down —
    // deleting the mutex/condvar under a live waiter is use-after-free
    std::unique_lock<std::mutex> lk(c->mu);
    c->cv.wait(lk, [c] { return c->recv_waiters == 0; });
  }
  ::shutdown(c->listen_fd, SHUT_RDWR);
  ::close(c->listen_fd);
  if (c->listener.joinable()) c->listener.join();
  {
    std::lock_guard<std::mutex> lk(c->out_mu);
    for (int& fd : c->out_fds) {
      if (fd >= 0) ::close(fd);
      fd = -1;
    }
  }
  {
    // unblock readers stuck in recv() on still-open inbound sockets
    std::lock_guard<std::mutex> lk(c->readers_mu);
    for (int fd : c->reader_fds) ::shutdown(fd, SHUT_RDWR);
    for (auto& t : c->readers)
      if (t.joinable()) t.join();
    for (int fd : c->reader_fds) ::close(fd);
  }
  delete c;
}

}  // extern "C"
