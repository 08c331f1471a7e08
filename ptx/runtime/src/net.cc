// TCP render farm: binary tile protocol, server + client.
//
// The reference farm (/root/reference/src/test.cpp:520-793) speaks a
// line-oriented ASCII protocol on port 12346: a 1-byte admission flag,
// an "x y size" request, and incremental "P x,y=r,g,b" pixel lines flushed
// once per second (test.cpp:375-391,709-714).  This is its native
// successor with the same *job semantics* — tile = unit of work, admission
// control at 2× hardware threads, stateless infinite retry with 1 s
// backoff on the client, incremental partial results while a tile renders
// — over a length-framed binary protocol carrying float row bands (no
// precision loss, ~50× fewer bytes, and each pixel is sent exactly once
// instead of the reference's wroteBuffer dedupe).
//
// The server's per-tile "render" is a host callback (the Python side runs
// the JAX render); the farm is pure orchestration, exactly the role
// the reference's pthread/TCP layer played around its C++ tracer.
//
// Frame layout (little-endian), protocol v2:
//   request:  magic 'PTXR' | u32 ver | u32 x0 y0 w h spp depth | u64 seed
//   response: u8 admit (1 ok / 0 busy), then a stream of frames
//     frame:  u32 kind | u32 a | u32 b
//       kind=1 rows:  a = row offset within tile, b = nrows,
//                     payload f32 data[nrows*w*3]
//       kind=0 done:  tile complete (all rows were streamed)
//       kind=2 error: a = status code, no payload

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "pool.h"

namespace {

constexpr uint32_t kMagic = 0x52585450;  // "PTXR"
constexpr uint32_t kVersion = 2;

constexpr uint32_t kFrameRows = 1;
constexpr uint32_t kFrameDone = 0;
constexpr uint32_t kFrameError = 2;

#pragma pack(push, 1)
struct TileRequest {
  uint32_t magic, version;
  uint32_t x0, y0, w, h, spp, depth;
  uint64_t seed;
};
struct FrameHeader {
  uint32_t kind, a, b;
};
#pragma pack(pop)

bool read_all(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

void set_io_timeout(int fd, int ms) {
  if (ms <= 0) return;
  timeval tv{};
  tv.tv_sec = ms / 1000;
  tv.tv_usec = (ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

}  // namespace

extern "C" {

// Streams one row band of the in-progress tile to the client; returns 0 on
// success, nonzero when the client is gone (the render may abort early).
typedef int (*ptx_emit_fn)(void* emit_ctx, uint32_t y_off, uint32_t nrows,
                           const float* data);

// Host render callback: renders the tile, pushing results through `emit`
// (once for the whole tile, or per row band for incremental streaming —
// the reference's 1 Hz partial-pixel flush, test.cpp:375-391).
// Returns 0 on success.
typedef int (*ptx_render_cb)(uint32_t x0, uint32_t y0, uint32_t w, uint32_t h,
                             uint32_t spp, uint32_t depth, uint64_t seed,
                             ptx_emit_fn emit, void* emit_ctx, void* user);

// Intra-tile progress observer: rows_done of rows_total received so far.
typedef void (*ptx_progress_fn)(void* ctx, uint32_t rows_done,
                                uint32_t rows_total);

struct ptx_server {
  int listen_fd = -1;
  std::thread accept_thread;
  std::atomic<bool> stopping{false};
  // queued + running connections — incremented at accept so admission
  // control sees work waiting in the pool queue, not only work already
  // holding a worker (the reference counts from dispatch, test.cpp:686-693,
  // because its pool is unbounded; ours queues)
  std::atomic<int> inflight{0};
  int max_inflight = 0;
  ptx_render_cb cb = nullptr;
  void* user = nullptr;
  ptxrt::Pool* pool = nullptr;
};

namespace {

struct EmitCtx {
  int fd;
  uint32_t w;
  uint32_t h;
  bool failed = false;
};

int emit_rows(void* ctx, uint32_t y_off, uint32_t nrows, const float* data) {
  auto* e = static_cast<EmitCtx*>(ctx);
  if (e->failed || y_off + nrows > e->h || nrows == 0) {
    e->failed = true;
    return 1;
  }
  FrameHeader fh{kFrameRows, y_off, nrows};
  if (!write_all(e->fd, &fh, sizeof(fh)) ||
      !write_all(e->fd, data,
                 static_cast<size_t>(nrows) * e->w * 3 * sizeof(float))) {
    e->failed = true;
    return 1;
  }
  return 0;
}

}  // namespace

static void serve_conn(ptx_server* s, int fd) {
  TileRequest req;
  bool ok = read_all(fd, &req, sizeof(req)) && req.magic == kMagic &&
            req.version == kVersion && req.w > 0 && req.h > 0 &&
            req.w <= 1u << 14 && req.h <= 1u << 14;
  // admission control: reference rejects when running >= 2x threads
  // (test.cpp:686-693); inflight counts this connection too, hence `>`
  int limit = s->max_inflight > 0 ? s->max_inflight : 2 * s->pool->width();
  if (!ok || s->inflight.load() > limit) {
    uint8_t admit = 0;
    write_all(fd, &admit, 1);
    ::close(fd);
    s->inflight.fetch_sub(1);
    return;
  }
  uint8_t admit = 1;
  if (!write_all(fd, &admit, 1)) {
    ::close(fd);
    s->inflight.fetch_sub(1);
    return;
  }
  EmitCtx ectx{fd, req.w, req.h};
  uint32_t status = static_cast<uint32_t>(
      s->cb(req.x0, req.y0, req.w, req.h, req.spp, req.depth, req.seed,
            emit_rows, &ectx, s->user));
  if (!ectx.failed) {
    FrameHeader fin{status == 0 ? kFrameDone : kFrameError, status, 0};
    write_all(fd, &fin, sizeof(fin));
  }
  ::close(fd);
  s->inflight.fetch_sub(1);
}

ptx_server* ptx_server_start(const char* bind_addr, int port,
                             ptx_render_cb cb, void* user, int threads,
                             int max_inflight) {
  auto* s = new ptx_server();
  s->cb = cb;
  s->user = user;
  s->max_inflight = max_inflight;
  s->pool = new ptxrt::Pool(threads);

  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s->pool;
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr =
      bind_addr && *bind_addr ? inet_addr(bind_addr) : INADDR_ANY;
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(s->listen_fd, 64) < 0) {
    ::close(s->listen_fd);
    delete s->pool;
    delete s;
    return nullptr;
  }
  s->accept_thread = std::thread([s] {
    while (!s->stopping.load()) {
      int fd = ::accept(s->listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (s->stopping.load()) break;
        continue;
      }
      set_io_timeout(fd, 120000);
      s->inflight.fetch_add(1);  // counted from accept: see ptx_server
      s->pool->submit([s, fd] { serve_conn(s, fd); });
    }
  });
  return s;
}

int ptx_server_port(ptx_server* s) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) <
      0)
    return -1;
  return ntohs(addr.sin_port);
}

void ptx_server_stop(ptx_server* s) {
  s->stopping.store(true);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  delete s->pool;  // drains in-flight tiles
  delete s;
}

// ---------------------------------------------------------------------------
// client
// ---------------------------------------------------------------------------

struct ptx_client {
  std::vector<std::string> hosts;
  std::vector<int> ports;
  std::atomic<uint32_t> rr{0};
  int retry_ms = 1000;   // reference: 1 s backoff (test.cpp:535)
  int max_attempts = 0;  // 0 = retry forever (reference semantics)
  // per-read stall bound: a server that stops streaming frames for this
  // long is treated as dead and the tile rotates to another server — the
  // failure path the reference reaches only on connect/parse errors
  int io_timeout_ms = 120000;
};

ptx_client* ptx_client_create(const char** hosts, const int* ports, int n,
                              int retry_ms, int max_attempts,
                              int io_timeout_ms) {
  auto* c = new ptx_client();
  for (int i = 0; i < n; ++i) {
    c->hosts.emplace_back(hosts[i]);
    c->ports.push_back(ports[i]);
  }
  if (retry_ms > 0) c->retry_ms = retry_ms;
  c->max_attempts = max_attempts;
  if (io_timeout_ms > 0) c->io_timeout_ms = io_timeout_ms;
  return c;
}

void ptx_client_destroy(ptx_client* c) { delete c; }

static int try_one(const std::string& host, int port, int io_timeout_ms,
                   const TileRequest& req, float* out,
                   ptx_progress_fn progress, void* pctx) {
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                    &res) != 0)
    return -1;
  int fd = -1;
  for (addrinfo* a = res; a; a = a->ai_next) {
    fd = ::socket(a->ai_family, a->ai_socktype, a->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, a->ai_addr, a->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd < 0) return -1;
  set_io_timeout(fd, io_timeout_ms);

  uint8_t admit = 0;
  if (!write_all(fd, &req, sizeof(req)) || !read_all(fd, &admit, 1) ||
      admit != 1) {
    ::close(fd);
    return -1;
  }

  // frame stream: rows land directly in `out`; every row must arrive
  // exactly once before the done frame (a reconnect after a partial stream
  // re-renders the whole tile — stateless retry, reference semantics)
  std::vector<uint8_t> got(req.h, 0);
  uint32_t rows_done = 0;
  int result = -1;
  for (;;) {
    FrameHeader fh;
    if (!read_all(fd, &fh, sizeof(fh))) break;
    if (fh.kind == kFrameRows) {
      if (fh.a + fh.b > req.h || fh.b == 0) break;
      float* dst = out + static_cast<size_t>(fh.a) * req.w * 3;
      if (!read_all(fd, dst,
                    static_cast<size_t>(fh.b) * req.w * 3 * sizeof(float)))
        break;
      bool fresh = true;
      for (uint32_t r = fh.a; r < fh.a + fh.b; ++r) {
        if (got[r]) fresh = false;
        got[r] = 1;
      }
      if (!fresh) break;  // duplicate rows: protocol violation
      rows_done += fh.b;
      if (progress) progress(pctx, rows_done, req.h);
    } else if (fh.kind == kFrameDone) {
      if (rows_done == req.h) result = 0;
      break;
    } else {
      break;  // error frame or garbage
    }
  }
  ::close(fd);
  return result;
}

// Blocking tile render with server rotation + retry; thread-safe.
// Returns 0 on success, -1 when max_attempts (if nonzero) is exhausted.
int ptx_client_render_tile(ptx_client* c, uint32_t x0, uint32_t y0,
                           uint32_t w, uint32_t h, uint32_t spp,
                           uint32_t depth, uint64_t seed, float* out,
                           ptx_progress_fn progress, void* pctx) {
  TileRequest req{kMagic, kVersion, x0, y0, w, h, spp, depth, seed};
  int attempts = 0;
  for (;;) {
    // round-robin start + sweep: better than the reference's random pick
    // (test.cpp:540) — no server is starved
    uint32_t start = c->rr.fetch_add(1);
    for (size_t i = 0; i < c->hosts.size(); ++i) {
      size_t idx = (start + i) % c->hosts.size();
      if (try_one(c->hosts[idx], c->ports[idx], c->io_timeout_ms, req, out,
                  progress, pctx) == 0)
        return 0;
    }
    if (c->max_attempts > 0 && ++attempts >= c->max_attempts) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(c->retry_ms));
  }
}

// ---------------------------------------------------------------------------
// plain pool C ABI
// ---------------------------------------------------------------------------

typedef void (*ptx_task_fn)(void* arg);

void* ptx_pool_create(int nthreads) { return new ptxrt::Pool(nthreads); }

void ptx_pool_submit(void* pool, ptx_task_fn fn, void* arg) {
  static_cast<ptxrt::Pool*>(pool)->submit([fn, arg] { fn(arg); });
}

void ptx_pool_wait(void* pool) { static_cast<ptxrt::Pool*>(pool)->wait_idle(); }

int ptx_pool_width(void* pool) {
  return static_cast<ptxrt::Pool*>(pool)->width();
}

void ptx_pool_destroy(void* pool) { delete static_cast<ptxrt::Pool*>(pool); }

}  // extern "C"
