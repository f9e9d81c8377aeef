// hetu-tpu parameter-server client (worker-side C++).
//
// TPU-native counterpart of the reference's KVWorker/PSAgent
// (ps-lite/include/ps/worker/PSAgent.h tensor registry + push/pull
// assembly, python_binding.cc:6-140 C ABI): a connection pool to the PS
// hosts, an async request thread pool with per-tensor pending counters
// (the ``Wait(node_id)`` / PSEvent contract, stream.py:67-81), and
// multi-server tensor placement (tensor id -> server, the Block-partition
// analogue of ps/partitioner.h).
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "ps_common.h"

namespace hetups {

static bool read_full(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

static bool write_full(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Conn {
  int fd = -1;
  bool ok() const { return fd >= 0; }
};

static int64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

static int env_ms(const char* name, int def) {
  const char* v = std::getenv(name);
  return v ? std::atoi(v) : def;
}

static void set_io_timeout(int fd, int ms) {
  timeval tv;
  tv.tv_sec = ms / 1000;
  tv.tv_usec = (ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
}

// connect with a bounded wait (a dead host must cost connect_ms, not the
// kernel's minutes-long SYN retry budget — reference ps-lite vans bound
// connects the same way)
static int dial(const std::string& host, int port, int connect_ms) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof portstr, "%d", port);
  if (::getaddrinfo(host.c_str(), portstr, &hints, &res) != 0) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  ::freeaddrinfo(res);
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return -1;
    }
    pollfd pfd{fd, POLLOUT, 0};
    if (::poll(&pfd, 1, connect_ms) != 1) {
      ::close(fd);
      return -1;
    }
    int err = 0;
    socklen_t elen = sizeof err;
    ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
    if (err != 0) {
      ::close(fd);
      return -1;
    }
  }
  ::fcntl(fd, F_SETFL, flags);
  int nd = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof nd);
  return fd;
}

class Client {
 public:
  static Client& Get() {
    static Client c;
    return c;
  }

  int init(const char* hosts_csv, const char* ports_csv, int rank,
           int nworkers) {
    std::lock_guard<std::mutex> l(init_mu_);
    if (!servers_.empty()) return 0;
    {
      std::lock_guard<std::mutex> ql(q_mu_);
      stopping_ = false;    // singleton may re-init after finalize()
    }
    rank_ = rank;
    nworkers_ = nworkers;
    // seq nonce: a restarted worker process must not reuse seqs the
    // server already recorded for this rank, or its first pushes would
    // be discarded as duplicates (reference ps-lite seeds timestamps
    // the same way); ms-clock << 20 leaves ~1M seqs per millisecond
    next_seq_.store(static_cast<uint64_t>(now_ms()) << 20);
    std::string hs(hosts_csv), ps(ports_csv);
    size_t hp = 0, pp = 0;
    while (hp < hs.size()) {
      size_t he = hs.find(',', hp);
      size_t pe = ps.find(',', pp);
      std::string host = hs.substr(
          hp, he == std::string::npos ? std::string::npos : he - hp);
      int port = std::atoi(
          ps.substr(pp, pe == std::string::npos ? std::string::npos
                                                : pe - pp)
              .c_str());
      servers_.push_back({host, port});
      if (he == std::string::npos) break;
      hp = he + 1;
      pp = pe + 1;
    }
    // optional backup replica per shard (HETU_PS_BACKUP_HOSTS/PORTS,
    // CSV parallel to the primary lists): on a dead primary the client
    // fails over and replays its acked-update window (ROADMAP item 2)
    const char* bh = std::getenv("HETU_PS_BACKUP_HOSTS");
    const char* bp = std::getenv("HETU_PS_BACKUP_PORTS");
    if (bh && bp && *bh) {
      std::string bhs(bh), bps(bp);
      size_t bhp = 0, bpp = 0;
      while (bhp < bhs.size() && backups_.size() < servers_.size()) {
        size_t he = bhs.find(',', bhp);
        size_t pe = bps.find(',', bpp);
        std::string host = bhs.substr(
            bhp, he == std::string::npos ? std::string::npos : he - bhp);
        int port = std::atoi(
            bps.substr(bpp, pe == std::string::npos ? std::string::npos
                                                    : pe - bpp)
                .c_str());
        backups_.push_back({host, port});
        if (he == std::string::npos) break;
        bhp = he + 1;
        bpp = pe + 1;
      }
      if (backups_.size() != servers_.size()) {
        std::fprintf(stderr,
                     "[hetu-ps] HETU_PS_BACKUP_HOSTS/PORTS do not match "
                     "the primary list (%zu vs %zu) — replication off\n",
                     backups_.size(), servers_.size());
        backups_.clear();
      }
    }
    active_.assign(servers_.size(), 0);
    window_.assign(servers_.size(), {});
    // must cover the server's acked-but-unforwarded window
    // (HETU_PS_REPL_LAG, default 128) or a failover can lose updates
    replay_cap_ = static_cast<size_t>(
        env_ms("HETU_PS_REPLAY_WINDOW", 256));
    // worker thread pool drains the async queue; joinable so finalize()
    // and the static destructor can stop them cleanly (a detached thread
    // blocked on q_cv_ at process exit deadlocks interpreter teardown)
    for (int i = 0; i < 4; ++i)
      threads_.emplace_back([this] { this->worker_loop(); });
    return static_cast<int>(servers_.size());
  }

  void stop_threads() {
    {
      std::lock_guard<std::mutex> l(q_mu_);
      stopping_ = true;
      q_cv_.notify_all();
    }
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    threads_.clear();
  }

  void finalize() {
    stop_threads();
    for (auto& kv : pool_)
      for (auto& c : kv.second)
        if (c.ok()) ::close(c.fd);
    pool_.clear();
    servers_.clear();
    backups_.clear();
    {
      std::lock_guard<std::mutex> l(act_mu_);
      active_.clear();
    }
    {
      std::lock_guard<std::mutex> l(win_mu_);
      window_.clear();
    }
    {
      std::lock_guard<std::mutex> l(parts_mu_);
      parts_.clear();
    }
  }

  ~Client() { stop_threads(); }

  int server_of(int32_t tensor_id) const {
    return servers_.empty() ? 0
                            : tensor_id % static_cast<int>(servers_.size());
  }

  // -- key-range partitioning (reference ps/partitioner.h Average/Block:
  // one tensor's row range is split across the server fleet; the client
  // splits each request by range and reassembles the responses) ---------
  struct Part {
    int64_t len = 0, width = 1;
    std::vector<int64_t> offsets;  // nparts+1 row boundaries
    std::vector<int> srv;          // server index per part
    int nparts() const { return static_cast<int>(srv.size()); }
    bool split() const { return srv.size() > 1; }
    bool synth = false;   // block mode: per-part server-side tensor ids
    // server-side id for part p: plain id for <=1 range per server
    // (average); block mode packs (id, part) into the NEGATIVE id space
    // so synthetic ids can never collide with another tensor's plain id
    // (node ids are an unbounded graph counter). Caps enforced below.
    int32_t pid(int32_t id, int p) const {
      if (!synth) return id;
      if (id >= (1 << 18) || p >= (1 << 12)) {
        std::fprintf(stderr,
                     "[hetu-ps] fatal: block partition id/part overflow "
                     "(id=%d part=%d)\n", id, p);
        std::abort();
      }
      return -((id << 12) | p) - 1;
    }
    int part_of(int64_t row) const {
      int lo = 0, hi = nparts() - 1;
      while (lo < hi) {
        int mid = (lo + hi + 1) / 2;
        if (row >= offsets[mid]) lo = mid; else hi = mid - 1;
      }
      return lo;
    }
    int64_t rows_of(int p) const { return offsets[p + 1] - offsets[p]; }
  };

  // Partitioners (reference ps-lite partitioner.h):
  //   Average (default) — rows spread evenly over every server (the
  //     trillion-parameter path — no single host needs the whole table).
  //   Block (HETU_PS_PARTITION=block) — fixed-size blocks of
  //     HETU_PS_BLOCK_SIZE elements assigned round-robin, the
  //     BytePS-style bounded-per-part scheme (partitioner.h:75-123):
  //     one huge tensor spreads load without any server owning a range
  //     proportional to tensor size.
  // Tensors smaller than the fleet stay whole on their hashed server.
  Part make_part(int32_t id, int64_t len, int64_t width) {
    Part p;
    p.len = len;
    p.width = width;
    int ns = static_cast<int>(servers_.size());
    if (ns <= 1 || len < ns) {
      p.offsets = {0, len};
      p.srv = {server_of(id)};
      return p;
    }
    const char* mode = std::getenv("HETU_PS_PARTITION");
    if (mode && std::strcmp(mode, "block") == 0) {
      const char* bs = std::getenv("HETU_PS_BLOCK_SIZE");
      int64_t block_elems = bs ? std::atoll(bs) : 1000000;
      int64_t block_rows = std::max<int64_t>(
          block_elems / std::max<int64_t>(width, 1), 1);
      int64_t off = 0;
      int s = server_of(id);     // stagger start by tensor
      p.offsets.push_back(0);
      while (off < len) {
        off = std::min(off + block_rows, len);
        p.offsets.push_back(off);
        p.srv.push_back(s);
        s = (s + 1) % ns;
      }
      p.synth = p.nparts() > 1;
      return p;
    }
    int64_t base = len / ns, rem = len % ns, off = 0;
    p.offsets.push_back(0);
    for (int s = 0; s < ns; ++s) {
      off += base + (s < rem ? 1 : 0);
      p.offsets.push_back(off);
      p.srv.push_back(s);
    }
    return p;
  }

  void register_part(int32_t id, const Part& p) {
    std::lock_guard<std::mutex> l(parts_mu_);
    parts_[id] = p;
  }

  Part part(int32_t id) {
    {
      std::lock_guard<std::mutex> l(parts_mu_);
      auto it = parts_.find(id);
      if (it != parts_.end()) return it->second;
    }
    if (servers_.size() > 1) {
      // Guessing whole-tensor placement for a tensor that might be
      // key-range partitioned across the fleet would silently read one
      // server's shard as the full tensor (ADVICE r2). Fail loudly:
      // callers must InitTensor (which registers the partition) first.
      std::fprintf(stderr,
                   "[hetu-ps] fatal: tensor %d used before InitTensor "
                   "with %zu servers — partition unknown; call "
                   "InitTensor in this process first\n",
                   id, servers_.size());
      std::abort();
    }
    // single server: whole-tensor placement is the only possibility
    Part p;
    p.offsets = {0, INT64_MAX};
    p.srv = {server_of(id)};
    return p;
  }

  int nservers() const { return static_cast<int>(servers_.size()); }

  // replicas per logical shard: 1 (unreplicated) or 2 (primary+backup)
  int nreplicas() const { return backups_.empty() ? 1 : 2; }

  int active_replica(int server) {
    std::lock_guard<std::mutex> l(act_mu_);
    return active_.empty() ? 0 : active_[server];
  }

  // mirror of the server's mutating_op set: the ops whose acked effect
  // must be replayed to the surviving replica after a failover
  static bool replicated_op(Op op) {
    return op == Op::kInitTensor || op == Op::kDensePush ||
           op == Op::kDDPushPull || op == Op::kSparsePush ||
           op == Op::kSDPushPull || op == Op::kSSPushPull ||
           op == Op::kPushEmbedding || op == Op::kPushSyncEmbedding ||
           op == Op::kParamSet || op == Op::kParamClear ||
           op == Op::kParamLoad || op == Op::kPushData ||
           op == Op::kStoreConfig;
  }

  // one transport attempt against one replica; true iff a framed
  // response arrived (*status then holds the server's verdict).
  // *delivered reports whether the request bytes were fully written —
  // the retry-budget re-arm point.
  bool attempt(int server, int replica, Op op, int32_t id,
               const std::vector<uint8_t>& payload, uint64_t seq,
               int io_ms, std::vector<uint8_t>* resp, int32_t* status,
               bool* delivered) {
    Conn c = take_conn(server, replica);
    if (!c.ok()) return false;
    set_io_timeout(c.fd, io_ms);
    MsgHeader h;
    h.op = static_cast<uint32_t>(op);
    h.tensor_id = id;
    h.payload_len = payload.size();
    h.worker = static_cast<uint32_t>(rank_);
    h.seq = seq;
    if (write_full(c.fd, &h, sizeof h) &&
        (payload.empty() ||
         write_full(c.fd, payload.data(), payload.size()))) {
      if (delivered) *delivered = true;
      MsgHeader rh;
      if (read_full(c.fd, &rh, sizeof rh) && rh.magic == h.magic) {
        std::vector<uint8_t> body(rh.payload_len);
        if (!rh.payload_len ||
            read_full(c.fd, body.data(), rh.payload_len)) {
          if (resp) *resp = std::move(body);
          give_conn(server, replica, c);
          *status = rh.status;
          return true;
        }
      }
    }
    // connection failed mid-request: never pool it
    ::close(c.fd);
    return false;
  }

  struct Acked {
    uint32_t op;
    int32_t id;
    uint64_t seq;
    std::vector<uint8_t> payload;
  };

  void record_acked(int server, Op op, int32_t id, uint64_t seq,
                    const std::vector<uint8_t>& payload) {
    std::lock_guard<std::mutex> l(win_mu_);
    auto& w = window_[server];
    w.push_back({static_cast<uint32_t>(op), id, seq, payload});
    while (w.size() > replay_cap_) w.pop_front();
  }

  // flip the active replica away from failed_rep (first failer wins;
  // latecomers see the flip already done and return) and replay the
  // acked-update window under the ORIGINAL (worker, seq) identities:
  // the survivor's dedup drops everything its primary already
  // forwarded, so the replay fills exactly the acked-but-unforwarded
  // gap (bounded by the primary's HETU_PS_REPL_LAG queue, which
  // HETU_PS_REPLAY_WINDOW must cover).
  void fail_over(int server, int failed_rep, int io_ms) {
    std::lock_guard<std::mutex> l(fo_mu_);
    int next;
    {
      std::lock_guard<std::mutex> a(act_mu_);
      if (active_[server] != failed_rep) return;
      next = (failed_rep + 1) % nreplicas();
      active_[server] = next;
    }
    drop_conns(server, failed_rep);
    std::deque<Acked> replay;
    {
      std::lock_guard<std::mutex> wl(win_mu_);
      replay = window_[server];
    }
    std::fprintf(stderr,
                 "[hetu-ps] server %d replica %d unreachable — failing "
                 "over to replica %d, replaying %zu acked updates\n",
                 server, failed_rep, next, replay.size());
    for (const auto& e : replay) {
      int32_t st = 0;
      attempt(server, next, static_cast<Op>(e.op), e.id, e.payload,
              e.seq, io_ms, nullptr, &st, nullptr);
    }
  }

  // synchronous RPC with timeout + reconnect-and-retry (reference
  // ps-lite resender.h / customer.h request tracking). Each request
  // carries a (worker, seq) identity; the server dedups mutating ops,
  // so a retry after a lost response is at-most-once. With a backup
  // replica set configured, a failed attempt flips the shard's active
  // replica and replays the acked-update window before retrying (the
  // retry itself keeps its original seq, so nothing applies twice).
  // Tunables:
  //   HETU_PS_TIMEOUT_MS          per-attempt I/O timeout (default 15s)
  //   HETU_PS_BARRIER_TIMEOUT_MS  barrier read timeout (default 600s —
  //                               a barrier legitimately blocks on the
  //                               slowest worker)
  //   HETU_PS_RETRY_MS            total retry budget (default 30s)
  //   HETU_PS_REPLAY_WINDOW       acked-update replay ring (default 256)
  // ``replica`` >= 0 pins the request to that replica with a single
  // bounded attempt (the shutdown sweep): a dead replica must not burn
  // the retry budget.
  int32_t call(int server, Op op, int32_t id, const Writer& req,
               std::vector<uint8_t>* resp, int replica = -1) {
    const uint64_t seq = next_seq_.fetch_add(1) + 1;
    const int io_ms = (op == Op::kBarrier)
                          ? env_ms("HETU_PS_BARRIER_TIMEOUT_MS", 600000)
                          : env_ms("HETU_PS_TIMEOUT_MS", 15000);
    const int retry_ms = env_ms("HETU_PS_RETRY_MS", 30000);
    if (replica >= 0) {
      int32_t st = -10;
      attempt(server, replica, op, id, req.buf, seq, io_ms, resp, &st,
              nullptr);
      return st;
    }
    int64_t deadline = now_ms() + retry_ms;
    int backoff_ms = 50;
    for (;;) {
      int rep = active_replica(server);
      int32_t st = 0;
      bool delivered = false;
      if (attempt(server, rep, op, id, req.buf, seq, io_ms, resp, &st,
                  &delivered)) {
        if (st == 0 && nreplicas() > 1 && replicated_op(op))
          record_acked(server, op, id, seq, req.buf);
        return st;
      }
      if (delivered) {
        // request delivered: the failure (if any) is fresh from here,
        // so re-arm the retry budget — otherwise a barrier that
        // legitimately blocked past the budget would get no retries
        deadline = now_ms() + retry_ms;
      }
      // dead replica: flip to the survivor and replay before the retry
      // lands there (a respawned-empty primary is never read — flips
      // are one-way until the new active fails too)
      if (nreplicas() > 1) fail_over(server, rep, io_ms);
      if (now_ms() + backoff_ms > deadline) {
        std::fprintf(stderr,
                     "[hetu-ps] request op=%u tensor=%d to server %d "
                     "failed after retry budget\n",
                     static_cast<uint32_t>(op), id, server);
        return -10;
      }
      ::usleep(static_cast<useconds_t>(backoff_ms) * 1000);
      backoff_ms = std::min(backoff_ms * 2, 1000);
    }
  }

  // async submit with per-tensor pending counter
  void submit(int32_t id, std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> l(pend_mu_);
      ++pending_[id];
    }
    std::lock_guard<std::mutex> l(q_mu_);
    queue_.emplace_back(id, std::move(fn));
    q_cv_.notify_one();
  }

  void wait(int32_t id) {
    std::unique_lock<std::mutex> l(pend_mu_);
    pend_cv_.wait(l, [&] { return pending_[id] == 0; });
  }

  void wait_all() {
    std::unique_lock<std::mutex> l(pend_mu_);
    pend_cv_.wait(l, [&] {
      for (auto& kv : pending_)
        if (kv.second) return false;
      return true;
    });
  }

  int rank() const { return rank_; }
  int nworkers() const { return nworkers_; }

 private:
  void worker_loop() {
    for (;;) {
      std::pair<int32_t, std::function<void()>> job;
      {
        std::unique_lock<std::mutex> l(q_mu_);
        q_cv_.wait(l, [&] { return stopping_ || !queue_.empty(); });
        if (stopping_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      job.second();
      {
        std::lock_guard<std::mutex> l(pend_mu_);
        if (--pending_[job.first] == 0) pend_cv_.notify_all();
      }
    }
  }

  // pool key folds in the replica: a pooled connection to the old
  // primary must never serve a request addressed to the backup
  Conn take_conn(int server, int replica) {
    if (servers_.empty()) return Conn{};
    {
      std::lock_guard<std::mutex> l(pool_mu_);
      auto& v = pool_[server * 2 + replica];
      if (!v.empty()) {
        Conn c = v.back();
        v.pop_back();
        return c;
      }
    }
    const auto& ep = (replica == 0 || backups_.empty())
                         ? servers_[server]
                         : backups_[server];
    Conn c;
    c.fd = dial(ep.first, ep.second,
                env_ms("HETU_PS_CONNECT_TIMEOUT_MS", 2000));
    return c;
  }

  void give_conn(int server, int replica, Conn c) {
    if (!c.ok()) return;
    std::lock_guard<std::mutex> l(pool_mu_);
    pool_[server * 2 + replica].push_back(c);
  }

  void drop_conns(int server, int replica) {
    std::lock_guard<std::mutex> l(pool_mu_);
    auto& v = pool_[server * 2 + replica];
    for (auto& c : v)
      if (c.ok()) ::close(c.fd);
    v.clear();
  }

  std::mutex init_mu_;
  std::unordered_map<int32_t, Part> parts_;
  std::mutex parts_mu_;
  std::vector<std::pair<std::string, int>> servers_;
  std::vector<std::pair<std::string, int>> backups_;
  std::vector<int> active_;            // per-server active replica
  std::mutex act_mu_;
  std::mutex fo_mu_;                   // serializes flip + replay
  std::vector<std::deque<Acked>> window_;  // per-server acked ring
  size_t replay_cap_ = 256;
  std::mutex win_mu_;
  std::unordered_map<int, std::vector<Conn>> pool_;
  std::mutex pool_mu_;

  std::deque<std::pair<int32_t, std::function<void()>>> queue_;
  std::mutex q_mu_;
  std::condition_variable q_cv_;
  bool stopping_ = false;
  std::vector<std::thread> threads_;

  std::unordered_map<int32_t, int> pending_;
  std::mutex pend_mu_;
  std::condition_variable pend_cv_;

  std::atomic<uint64_t> next_seq_{0};
  int rank_ = 0;
  int nworkers_ = 1;
};

}  // namespace hetups

// ---------------------------------------------------------------------------
// C ABI (ctypes) — mirrors the reference python_binding.cc surface
// ---------------------------------------------------------------------------

using hetups::Client;
using hetups::Op;
using hetups::Writer;

extern "C" {

int PSInit(const char* hosts_csv, const char* ports_csv, int rank,
           int nworkers) {
  return Client::Get().init(hosts_csv, ports_csv, rank, nworkers);
}

void PSFinalize() { Client::Get().finalize(); }

int PSRank() { return Client::Get().rank(); }
int PSNumWorkers() { return Client::Get().nworkers(); }

// Split sparse row ids by partition range: returns per-part local row ids
// plus each entry's position in the original request (for reassembly).
struct SparseRoute {
  std::vector<std::vector<int64_t>> idx;   // per-part local row ids
  std::vector<std::vector<size_t>> pos;    // per-part original positions
};

static SparseRoute route_sparse(const Client::Part& part, const int64_t* idx,
                                int64_t nidx) {
  SparseRoute r;
  r.idx.resize(part.nparts());
  r.pos.resize(part.nparts());
  for (int64_t j = 0; j < nidx; ++j) {
    int p = part.split() ? part.part_of(idx[j]) : 0;
    r.idx[p].push_back(idx[j] - part.offsets[p]);
    r.pos[p].push_back(static_cast<size_t>(j));
  }
  return r;
}

// gather the value rows for one part's routed positions
static std::vector<float> gather_rows(const std::vector<size_t>& pos,
                                      const float* vals, int64_t width) {
  std::vector<float> pv(pos.size() * width);
  for (size_t j = 0; j < pos.size(); ++j)
    std::memcpy(pv.data() + j * width, vals + pos[j] * width,
                width * sizeof(float));
  return pv;
}

// copy into out+off clamped to the caller's buffer; a too-small caller
// buffer must truncate, never wrap to a huge size_t
static void copy_clamped(float* out, int64_t off, const float* src,
                         size_t n, int64_t total) {
  int64_t room = total - off;
  if (room <= 0) return;
  std::memcpy(out + off, src,
              std::min<int64_t>(static_cast<int64_t>(n), room) *
                  sizeof(float));
}

// run fn(p) for every part concurrently (fan-out latency stays flat as
// the fleet grows); part 0 runs on the calling thread
static void for_parts(int nparts, const std::function<void(int)>& fn) {
  if (nparts <= 1) {
    if (nparts == 1) fn(0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nparts - 1);
  for (int p = 1; p < nparts; ++p) ts.emplace_back(fn, p);
  fn(0);
  for (auto& t : ts) t.join();
}

int InitTensor(int id, int ptype, int64_t len, int64_t width, int init_type,
               double init_a, double init_b, uint64_t seed, int otype,
               const float* lrs, int nlr) {
  auto& c = Client::Get();
  auto part = c.make_part(id, len, width);
  c.register_part(id, part);
  int rc_all = 0;
  for (int p = 0; p < part.nparts(); ++p) {
    Writer w;
    w.i32(ptype);
    w.i64(part.rows_of(p));   // each server owns only its row range
    w.i64(width);
    w.i32(init_type);
    w.f64(init_a);
    w.f64(init_b);
    w.u64(seed + 0x9E3779B9u * static_cast<uint64_t>(p));  // decorrelate
    w.i32(otype);
    w.floats(lrs, static_cast<size_t>(nlr));
    int rc = c.call(part.srv[p], Op::kInitTensor, part.pid(id, p), w, nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

int Pull(int id, float* out, int64_t len) {
  auto& c = Client::Get();
  auto part = c.part(id);
  std::vector<int> rcs(part.nparts(), 0);
  for_parts(part.nparts(), [&](int p) {
    std::vector<uint8_t> resp;
    Writer w;
    rcs[p] = c.call(part.srv[p], Op::kDensePull, part.pid(id, p), w, &resp);
    if (rcs[p] != 0) return;
    hetups::Reader rd(resp.data(), resp.size());
    size_t n;
    const float* src = rd.floats(&n);
    copy_clamped(out, part.offsets[p] * part.width, src, n, len);
  });
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

void Push(int id, const float* grad, int64_t len) {
  auto& c = Client::Get();
  auto part = c.part(id);
  std::vector<float> g(grad, grad + len);
  c.submit(id, [&c, id, part, g = std::move(g)] {
    for (int p = 0; p < part.nparts(); ++p) {
      int64_t off = part.offsets[p] * part.width;
      int64_t n = part.split() ? part.rows_of(p) * part.width
                               : static_cast<int64_t>(g.size());
      Writer w;
      w.floats(g.data() + off, static_cast<size_t>(n));
      c.call(part.srv[p], Op::kDensePush, part.pid(id, p), w, nullptr);
    }
  });
}

void DDPushPull(int id, const float* grad, float* out, int64_t len) {
  auto& c = Client::Get();
  auto part = c.part(id);
  std::vector<float> g(grad, grad + len);
  c.submit(id, [&c, id, part, g = std::move(g), out, len] {
    for (int p = 0; p < part.nparts(); ++p) {
      int64_t off = part.offsets[p] * part.width;
      int64_t n = part.split() ? part.rows_of(p) * part.width
                               : static_cast<int64_t>(g.size());
      Writer w;
      w.floats(g.data() + off, static_cast<size_t>(n));
      std::vector<uint8_t> resp;
      if (c.call(part.srv[p], Op::kDDPushPull, part.pid(id, p), w, &resp) == 0) {
        hetups::Reader rd(resp.data(), resp.size());
        size_t m;
        const float* src = rd.floats(&m);
        copy_clamped(out, off, src, m, len);
      }
    }
  });
}

void SparsePush(int id, const int64_t* idx, const float* vals, int64_t nidx,
                int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, idx, nidx);
  std::vector<float> vv(vals, vals + nidx * width);
  c.submit(id, [&c, id, part, route = std::move(route),
                vv = std::move(vv), width] {
    for (int p = 0; p < part.nparts(); ++p) {
      if (route.idx[p].empty()) continue;
      auto pv = gather_rows(route.pos[p], vv.data(), width);
      Writer w;
      w.longs(route.idx[p].data(), route.idx[p].size());
      w.floats(pv.data(), pv.size());
      c.call(part.srv[p], Op::kSparsePush, part.pid(id, p), w, nullptr);
    }
  });
}

int SparsePull(int id, const int64_t* idx, float* out, int64_t nidx,
               int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, idx, nidx);
  std::vector<int> rcs(part.nparts(), 0);
  for_parts(part.nparts(), [&](int p) {
    if (route.idx[p].empty()) return;
    Writer w;
    w.longs(route.idx[p].data(), route.idx[p].size());
    std::vector<uint8_t> resp;
    rcs[p] = c.call(part.srv[p], Op::kSparsePull, part.pid(id, p), w, &resp);
    if (rcs[p] != 0) return;
    hetups::Reader rd(resp.data(), resp.size());
    size_t n;
    const float* rows = rd.floats(&n);
    for (size_t j = 0; j < route.pos[p].size() && (j + 1) * width <= n;
         ++j)
      std::memcpy(out + route.pos[p][j] * width, rows + j * width,
                  width * sizeof(float));
  });
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

void SDPushPull(int id, const int64_t* idx, const float* vals, int64_t nidx,
                float* out, int64_t out_len, int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, idx, nidx);
  std::vector<float> vv(vals, vals + nidx * width);
  c.submit(id, [&c, id, part, route = std::move(route), vv = std::move(vv),
                out, out_len, width] {
    // every part answers with its dense shard (even index-empty ones)
    for (int p = 0; p < part.nparts(); ++p) {
      auto pv = gather_rows(route.pos[p], vv.data(), width);
      Writer w;
      w.longs(route.idx[p].data(), route.idx[p].size());
      w.floats(pv.data(), pv.size());
      std::vector<uint8_t> resp;
      if (c.call(part.srv[p], Op::kSDPushPull, part.pid(id, p), w, &resp) == 0) {
        hetups::Reader rd(resp.data(), resp.size());
        size_t m;
        const float* src = rd.floats(&m);
        int64_t off = part.split() ? part.offsets[p] * part.width : 0;
        copy_clamped(out, off, src, m, out_len);
      }
    }
  });
}

void SSPushPull(int id, const int64_t* in_idx, const float* vals,
                int64_t nin, const int64_t* out_idx, int64_t nout,
                float* out, int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto in_route = route_sparse(part, in_idx, nin);
  auto out_route = route_sparse(part, out_idx, nout);
  std::vector<float> vv(vals, vals + nin * width);
  c.submit(id, [&c, id, part, in_route = std::move(in_route),
                out_route = std::move(out_route), vv = std::move(vv),
                out, width] {
    for (int p = 0; p < part.nparts(); ++p) {
      if (in_route.idx[p].empty() && out_route.idx[p].empty()) continue;
      auto pv = gather_rows(in_route.pos[p], vv.data(), width);
      Writer w;
      w.longs(in_route.idx[p].data(), in_route.idx[p].size());
      w.floats(pv.data(), pv.size());
      w.longs(out_route.idx[p].data(), out_route.idx[p].size());
      std::vector<uint8_t> resp;
      if (c.call(part.srv[p], Op::kSSPushPull, part.pid(id, p), w, &resp) == 0) {
        hetups::Reader rd(resp.data(), resp.size());
        size_t n;
        const float* rows = rd.floats(&n);
        for (size_t j = 0;
             j < out_route.pos[p].size() && (j + 1) * width <= n; ++j)
          std::memcpy(out + out_route.pos[p][j] * width, rows + j * width,
                      width * sizeof(float));
      }
    }
  });
}

// bounded-staleness cache sync: for rows in idx whose server version is
// newer than ver[j]+bound, writes row data into out (at position j*width),
// updates ver[j]; returns number of refreshed rows.
int SyncEmbedding(int id, int64_t bound, const int64_t* idx, int64_t* ver,
                  int64_t nidx, float* out, int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, idx, nidx);
  std::vector<int> rcs(part.nparts(), 0);
  std::atomic<int> refreshed{0};
  for_parts(part.nparts(), [&](int p) {
    if (route.idx[p].empty()) return;
    std::vector<int64_t> pver(route.pos[p].size());
    for (size_t j = 0; j < route.pos[p].size(); ++j)
      pver[j] = ver[route.pos[p][j]];
    Writer w;
    w.i64(bound);
    w.longs(route.idx[p].data(), route.idx[p].size());
    w.longs(pver.data(), pver.size());
    std::vector<uint8_t> resp;
    rcs[p] = c.call(part.srv[p], Op::kSyncEmbedding, part.pid(id, p), w, &resp);
    if (rcs[p] != 0) return;
    hetups::Reader rd(resp.data(), resp.size());
    size_t npos, nver, nrows;
    const int64_t* pos = rd.longs(&npos);   // positions in THIS sub-request
    const int64_t* sver = rd.longs(&nver);
    const float* rows = rd.floats(&nrows);
    for (size_t j = 0; j < npos; ++j) {
      size_t orig = route.pos[p][pos[j]];
      ver[orig] = sver[j];
      std::memcpy(out + orig * width, rows + j * width,
                  width * sizeof(float));
    }
    refreshed += static_cast<int>(npos);
  });
  for (int rc : rcs)
    if (rc != 0) return rc < 0 ? rc : -rc;
  return refreshed.load();
}

// combined push + bounded-staleness sync (ROADMAP item 2): one round
// trip per shard instead of the cache's PushEmbedding + SyncEmbedding
// pair. Pushes (push_idx, grads, updates) and, in the same request,
// refreshes rows in sync_idx whose server version moved past
// ver[j] + bound (out/ver updated in place, SyncEmbedding's contract).
// Returns the number of refreshed rows, or <0 on error.
int PushSyncEmbedding(int id, int64_t bound, const int64_t* push_idx,
                      const float* grads, const int64_t* updates,
                      int64_t npush, const int64_t* sync_idx,
                      int64_t* ver, int64_t nsync, float* out,
                      int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto proute = route_sparse(part, push_idx, npush);
  auto sroute = route_sparse(part, sync_idx, nsync);
  std::vector<int> rcs(part.nparts(), 0);
  std::atomic<int> refreshed{0};
  for_parts(part.nparts(), [&](int p) {
    if (proute.idx[p].empty() && sroute.idx[p].empty()) return;
    auto pv = gather_rows(proute.pos[p], grads, width);
    std::vector<int64_t> pu(proute.pos[p].size());
    for (size_t j = 0; j < proute.pos[p].size(); ++j)
      pu[j] = updates[proute.pos[p][j]];
    std::vector<int64_t> pver(sroute.pos[p].size());
    for (size_t j = 0; j < sroute.pos[p].size(); ++j)
      pver[j] = ver[sroute.pos[p][j]];
    Writer w;
    w.i64(bound);
    w.longs(proute.idx[p].data(), proute.idx[p].size());
    w.floats(pv.data(), pv.size());
    w.longs(pu.data(), pu.size());
    w.longs(sroute.idx[p].data(), sroute.idx[p].size());
    w.longs(pver.data(), pver.size());
    std::vector<uint8_t> resp;
    rcs[p] = c.call(part.srv[p], Op::kPushSyncEmbedding,
                    part.pid(id, p), w, &resp);
    if (rcs[p] != 0) return;
    hetups::Reader rd(resp.data(), resp.size());
    size_t npos, nver, nrows;
    const int64_t* pos = rd.longs(&npos);   // positions in THIS sub-request
    const int64_t* sver = rd.longs(&nver);
    const float* rows = rd.floats(&nrows);
    for (size_t j = 0; j < npos; ++j) {
      size_t orig = sroute.pos[p][pos[j]];
      ver[orig] = sver[j];
      std::memcpy(out + orig * width, rows + j * width,
                  width * sizeof(float));
    }
    refreshed += static_cast<int>(npos);
  });
  for (int rc : rcs)
    if (rc != 0) return rc < 0 ? rc : -rc;
  return refreshed.load();
}

void PushEmbedding(int id, const int64_t* idx, const float* vals,
                   const int64_t* updates, int64_t nidx, int64_t width) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, idx, nidx);
  std::vector<float> vv(vals, vals + nidx * width);
  std::vector<int64_t> uv(updates, updates + nidx);
  c.submit(id, [&c, id, part, route = std::move(route), vv = std::move(vv),
                uv = std::move(uv), width] {
    for (int p = 0; p < part.nparts(); ++p) {
      if (route.idx[p].empty()) continue;
      auto pv = gather_rows(route.pos[p], vv.data(), width);
      std::vector<int64_t> pu(route.pos[p].size());
      for (size_t j = 0; j < route.pos[p].size(); ++j)
        pu[j] = uv[route.pos[p][j]];
      Writer w;
      w.longs(route.idx[p].data(), route.idx[p].size());
      w.floats(pv.data(), pv.size());
      w.longs(pu.data(), pu.size());
      c.call(part.srv[p], Op::kPushEmbedding, part.pid(id, p), w, nullptr);
    }
  });
}

void Wait(int id) { Client::Get().wait(id); }
void WaitAll() { Client::Get().wait_all(); }

void BarrierWorker() {
  auto& c = Client::Get();
  Writer w;
  c.call(0, Op::kBarrier, 0, w, nullptr);
}

int SetParam(int id, const float* vals, int64_t len) {
  auto& c = Client::Get();
  auto part = c.part(id);
  int rc_all = 0;
  for (int p = 0; p < part.nparts(); ++p) {
    int64_t off = part.offsets[p] * part.width;
    int64_t n = part.split() ? part.rows_of(p) * part.width : len;
    Writer w;
    w.floats(vals + off, static_cast<size_t>(n));
    int rc = c.call(part.srv[p], Op::kParamSet, part.pid(id, p), w, nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

int Clear(int id) {
  auto& c = Client::Get();
  auto part = c.part(id);
  int rc_all = 0;
  for (int p = 0; p < part.nparts(); ++p) {
    Writer w;
    int rc = c.call(part.srv[p], Op::kParamClear, part.pid(id, p), w, nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

// split tensors save/load one file per range: <path>.part<p>
static std::string part_path(const char* path, int p, bool split) {
  if (!split) return path;
  return std::string(path) + ".part" + std::to_string(p);
}

int SaveParam(int id, const char* path) {
  auto& c = Client::Get();
  auto part = c.part(id);
  int rc_all = 0;
  if (part.split()) {
    // manifest records the partition so a later load can detect a fleet
    // whose ranges no longer match the shard files (ADVICE r2: split
    // checkpoints were silently tied to the server count at save time)
    std::FILE* f = std::fopen((std::string(path) + ".manifest").c_str(),
                              "w");
    if (f) {
      std::fprintf(f, "nparts %d\noffsets", part.nparts());
      for (auto off : part.offsets) {
        std::fprintf(f, " %lld", static_cast<long long>(off));
      }
      std::fprintf(f, "\n");
      std::fclose(f);
    }
  }
  for (int p = 0; p < part.nparts(); ++p) {
    Writer w;
    w.str(part_path(path, p, part.split()).c_str());
    int rc = c.call(part.srv[p], Op::kParamSave, part.pid(id, p), w, nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

// read one server dump (len, width, row data); format written by the
// server's kParamSave handler
static bool read_dump(const std::string& path, int64_t* len,
                      int64_t* width, std::vector<float>* data) {
  std::FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  if (std::fread(len, sizeof *len, 1, f) != 1 ||
      std::fread(width, sizeof *width, 1, f) != 1) {
    std::fclose(f);
    return false;
  }
  size_t n = static_cast<size_t>(*len) * static_cast<size_t>(*width);
  data->resize(n);
  size_t got = std::fread(data->data(), sizeof(float), n, f);
  std::fclose(f);
  return got == n;
}

int LoadParam(int id, const char* path) {
  auto& c = Client::Get();
  auto part = c.part(id);
  // saved layout from the manifest; no manifest == one unsplit file
  int saved_nparts = 1;
  std::vector<long long> saved_offsets;
  std::FILE* f = std::fopen((std::string(path) + ".manifest").c_str(),
                            "r");
  if (f) {
    if (std::fscanf(f, "nparts %d", &saved_nparts) == 1 &&
        std::fscanf(f, " offsets") == 0) {
      for (int i = 0; i <= saved_nparts; ++i) {
        long long off = -1;
        if (std::fscanf(f, " %lld", &off) != 1) break;
        saved_offsets.push_back(off);
      }
    }
    std::fclose(f);
  }
  bool layout_matches = saved_nparts == part.nparts();
  if (layout_matches && !saved_offsets.empty()) {
    // offsets must match too: equal part counts with different ranges
    // (e.g. block size changed) would permute rows silently
    for (int i = 0; i <= saved_nparts; ++i)
      if (static_cast<size_t>(i) >= saved_offsets.size() ||
          saved_offsets[i] != static_cast<long long>(part.offsets[i]))
        layout_matches = false;
  }
  if (layout_matches) {
    int rc_all = 0;
    for (int p = 0; p < part.nparts(); ++p) {
      Writer w;
      w.str(part_path(path, p, part.split()).c_str());
      int rc =
          c.call(part.srv[p], Op::kParamLoad, part.pid(id, p), w, nullptr);
      if (rc != 0) rc_all = rc;
    }
    return rc_all;
  }
  // fleet-resize path (round-4 VERDICT #7; reference server dumps are
  // partition-independent, PSFHandle.h:357-395): the server count or
  // partitioner layout changed since save. Reassemble the full tensor
  // from the saved shard files (shared checkpoint filesystem), then
  // redistribute each current range via ParamSet.
  std::vector<float> full;
  int64_t width = 0;
  for (int p = 0; p < saved_nparts; ++p) {
    int64_t plen = 0, pwidth = 0;
    std::vector<float> pdata;
    if (!read_dump(part_path(path, p, saved_nparts > 1), &plen, &pwidth,
                   &pdata)) {
      std::fprintf(stderr,
                   "[hetu-ps] LoadParam(%d): cannot read saved shard %s "
                   "for fleet-resize reassembly\n",
                   id, part_path(path, p, saved_nparts > 1).c_str());
      return -22;
    }
    if (p == 0) width = pwidth;
    if (pwidth != width) return -23;
    full.insert(full.end(), pdata.begin(), pdata.end());
  }
  if (width != part.width &&
      !(part.nparts() == 1 && part.width == 1)) {
    std::fprintf(stderr,
                 "[hetu-ps] LoadParam(%d): checkpoint width %lld != "
                 "tensor width %lld\n", id,
                 static_cast<long long>(width),
                 static_cast<long long>(part.width));
    return -23;
  }
  int rc_all = 0;
  int64_t total_rows = static_cast<int64_t>(full.size()) /
                       std::max<int64_t>(width, 1);
  if (part.split() && part.offsets.back() > total_rows) {
    // a checkpoint smaller than the registered tensor must refuse, not
    // read past the reassembled buffer and install heap garbage
    std::fprintf(stderr,
                 "[hetu-ps] LoadParam(%d): checkpoint has %lld rows but "
                 "the registered tensor spans %lld — row count changed "
                 "since save\n", id,
                 static_cast<long long>(total_rows),
                 static_cast<long long>(part.offsets.back()));
    return -23;
  }
  for (int p = 0; p < part.nparts(); ++p) {
    int64_t row0 = part.split() ? part.offsets[p] : 0;
    int64_t rows = part.split() ? part.rows_of(p) : total_rows;
    Writer w;
    w.floats(full.data() + row0 * width,
             static_cast<size_t>(rows * width));
    int rc = c.call(part.srv[p], Op::kParamSet, part.pid(id, p), w,
                    nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

int PushData(int64_t key, const float* vals, int64_t n) {
  auto& c = Client::Get();
  Writer w;
  w.i64(key);
  w.floats(vals, static_cast<size_t>(n));
  return c.call(0, Op::kPushData, 0, w, nullptr);
}

int PullData(int64_t key, float* out, int64_t n) {
  auto& c = Client::Get();
  Writer w;
  w.i64(key);
  std::vector<uint8_t> resp;
  int rc = c.call(0, Op::kPullData, 0, w, &resp);
  if (rc != 0) return rc;
  hetups::Reader rd(resp.data(), resp.size());
  size_t m;
  const float* p = rd.floats(&m);
  std::memcpy(out, p, std::min<size_t>(m, n) * sizeof(float));
  return 0;
}

// convert one table to tiered (bounded DRAM pool over a disk spill
// file) + quantized row storage. dtype: 0=f32, 1=f16, 2=int8 (per-row
// maxabs scale, dequant-on-pull). dram_rows is the per-shard DRAM row
// budget (<0 = everything resident); hot ids (PR 9's measured hot-key
// skew) are pre-warmed into DRAM.
int StoreConfig(int id, int dtype, int64_t dram_rows,
                const char* spill_dir, const int64_t* hot,
                int64_t nhot) {
  auto& c = Client::Get();
  auto part = c.part(id);
  auto route = route_sparse(part, hot, nhot);
  int rc_all = 0;
  for (int p = 0; p < part.nparts(); ++p) {
    Writer w;
    w.i32(dtype);
    w.i64(dram_rows);
    w.str(spill_dir);
    w.longs(route.idx[p].data(), route.idx[p].size());
    int rc = c.call(part.srv[p], Op::kStoreConfig, part.pid(id, p), w,
                    nullptr);
    if (rc != 0) rc_all = rc;
  }
  return rc_all;
}

// aggregate tiered-store counters across one table's shards into
// out[6] = {dram_hits, spill_hits, spill_writes, dram_rows, row_bytes,
// repl_queue} — repl_queue sums each shard server's replication-
// forward backlog (fleet-wide lag signal; 0 unreplicated)
int StoreStats(int id, int64_t* out, int64_t n) {
  if (n < 6) return -1;
  auto& c = Client::Get();
  auto part = c.part(id);
  int64_t acc[6] = {0, 0, 0, 0, 0, 0};
  for (int p = 0; p < part.nparts(); ++p) {
    Writer w;
    std::vector<uint8_t> resp;
    int rc = c.call(part.srv[p], Op::kStoreStats, part.pid(id, p), w,
                    &resp);
    if (rc != 0) return rc;
    hetups::Reader rd(resp.data(), resp.size());
    acc[0] += static_cast<int64_t>(rd.u64());
    acc[1] += static_cast<int64_t>(rd.u64());
    acc[2] += static_cast<int64_t>(rd.u64());
    acc[3] += rd.i64();
    acc[4] = rd.i64();          // per-row bytes: identical on every shard
    acc[5] += rd.i64();
  }
  std::memcpy(out, acc, sizeof acc);
  return 0;
}

uint64_t GetLoads() {
  auto& c = Client::Get();
  uint64_t total = 0;
  for (int s = 0; s < std::max(1, c.nservers()); ++s) {
    Writer w;
    std::vector<uint8_t> resp;
    if (c.call(s, Op::kGetLoads, 0, w, &resp) != 0) continue;
    hetups::Reader rd(resp.data(), resp.size());
    total += rd.u64();
  }
  return total;
}

// replicas per logical shard (1 = unreplicated, 2 = primary + backup)
int PSNumReplicas() { return Client::Get().nreplicas(); }

void ShutdownServers() {
  auto& c = Client::Get();
  for (int s = 0; s < std::max(1, c.nservers()); ++s) {
    // sweep every replica with one bounded attempt each: a primary
    // that already died must not burn the retry budget or keep the
    // surviving replica set from being notified
    for (int r = 0; r < c.nreplicas(); ++r) {
      Writer w;
      c.call(s, Op::kShutdown, 0, w, nullptr, r);
    }
  }
}

}  // extern "C"
