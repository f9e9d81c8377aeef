// hetu-tpu parameter server (host-side C++).
//
// TPU-native equivalent of the reference's ps-lite server
// (ps-lite/include/ps/server/PSFHandle.h KVServerMatrixHandle +
// ps/server/optimizer.h server-side optimizers + PSFhandle_embedding.cc
// versioned cache tables): tensors live in host RAM behind per-tensor
// reader/writer locks, updates apply OpenMP-parallel, sparse tables keep
// per-row versions for the bounded-staleness embedding-cache protocol.
// Transport is plain TCP threads (the reference's ZMQ/P3/IBVerbs vans
// collapse to this on a TPU pod: workers talk to host PS over DCN).
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "ps_common.h"
#include "ps_store.h"

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

using version_t = int64_t;

struct Tensor {
  ParamKind kind = ParamKind::kParam;
  OptKind opt = OptKind::kNone;
  int64_t len = 0;    // rows (or flat length for dense)
  int64_t width = 1;  // row width for 2-D tables
  std::vector<float> data;
  std::vector<version_t> ver;       // per-row versions (cache tables)
  std::vector<float> lrs;           // [lr, momentum/beta1, beta2, eps...]
  // optimizer slots
  std::vector<float> m, v;
  int64_t step = 0;
  // tiered/quantized row storage (kStoreConfig): when set, ``data`` is
  // empty and every row lives in the DRAM pool or the spill file;
  // restricted to SGD/None optimizers (no m/v slot tiering)
  std::unique_ptr<TieredStore> store;
  mutable std::shared_mutex mu;

  int64_t nelem() const { return len * width; }
  float lr() const { return lrs.empty() ? 0.1f : lrs[0]; }

  // one row for the read paths: direct pointer for dense tables, a
  // dequantized copy in ``scratch`` (caller-sized to width) for tiered
  inline const float* row_src(int64_t row, float* scratch) const {
    if (!store) return data.data() + row * width;
    store->read_row(row, scratch);
    return scratch;
  }

  // materialized full-table view for the dense pull/save paths (tiered
  // tables pay one dequant sweep; dense tables alias ``data``)
  const float* dense_view(std::vector<float>& snap) const {
    if (!store) return data.data();
    snap.resize(nelem());
    for (int64_t r = 0; r < len; ++r)
      store->read_row(r, snap.data() + r * width);
    return snap.data();
  }

  void init_slots() {
    switch (opt) {
      case OptKind::kMomentum:
      case OptKind::kNesterov:
      case OptKind::kAdaGrad:
        m.assign(nelem(), 0.f);
        break;
      case OptKind::kAdam:
        m.assign(nelem(), 0.f);
        v.assign(nelem(), 0.f);
        break;
      default:
        break;
    }
  }

  // dense update over the full buffer (reference ApplyDense)
  void apply_dense(const float* g) {
    const int64_t n = nelem();
    const float a = lr();
    if (store) {
      // tiered: read-modify-write per row (SGD/None only, enforced at
      // kStoreConfig); the dequant/requant round trip is the quantized
      // storage contract, not an accident
      std::vector<float> buf(width);
      for (int64_t r = 0; r < len; ++r) {
        store->read_row(r, buf.data());
        const float* src = g + r * width;
        if (opt == OptKind::kSGD) {
          for (int64_t k = 0; k < width; ++k) buf[k] -= a * src[k];
        } else {
          for (int64_t k = 0; k < width; ++k) buf[k] += src[k];
        }
        store->write_row(r, buf.data());
      }
      return;
    }
    switch (opt) {
      case OptKind::kNone:
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) data[i] += g[i];
        break;
      case OptKind::kSGD:
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) data[i] -= a * g[i];
        break;
      case OptKind::kMomentum:
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) {
          m[i] = lrs[1] * m[i] - a * g[i];
          data[i] += m[i];
        }
        break;
      case OptKind::kNesterov:
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) {
          float vel = lrs[1] * m[i] - a * g[i];
          data[i] += lrs[1] * vel - a * g[i];
          m[i] = vel;
        }
        break;
      case OptKind::kAdaGrad:
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) {
          m[i] += g[i] * g[i];
          data[i] -= a * g[i] / (std::sqrt(m[i]) + lrs[1]);
        }
        break;
      case OptKind::kAdam: {
        ++step;
        const float b1 = lrs[1], b2 = lrs[2], eps = lrs[3];
        const float wd = lrs.size() > 4 ? lrs[4] : 0.f;  // AdamW decay
        const float bc1 = 1.f - std::pow(b1, static_cast<float>(step));
        const float bc2 = 1.f - std::pow(b2, static_cast<float>(step));
        const float scale = a * std::sqrt(bc2) / bc1;
#pragma omp parallel for
        for (int64_t i = 0; i < n; ++i) {
          m[i] = b1 * m[i] + (1 - b1) * g[i];
          v[i] = b2 * v[i] + (1 - b2) * g[i] * g[i];
          data[i] -= scale * m[i] / (std::sqrt(v[i]) + eps)
                     + a * wd * data[i];
        }
        break;
      }
    }
  }

  // one row's optimizer update from an (already aggregated) gradient
  inline void apply_row(int64_t row, const float* src, float a) {
    const int64_t w = width;
    if (store) {
      thread_local std::vector<float> buf;
      buf.resize(w);
      store->read_row(row, buf.data());
      if (opt == OptKind::kSGD) {
        for (int64_t k = 0; k < w; ++k) buf[k] -= a * src[k];
      } else {
        for (int64_t k = 0; k < w; ++k) buf[k] += src[k];
      }
      store->write_row(row, buf.data());
      return;
    }
    float* dst = data.data() + row * w;
    switch (opt) {
      case OptKind::kNone:
        for (int64_t k = 0; k < w; ++k) dst[k] += src[k];
        break;
      case OptKind::kSGD:
        for (int64_t k = 0; k < w; ++k) dst[k] -= a * src[k];
        break;
      case OptKind::kAdaGrad: {
        float* acc = m.data() + row * w;
        for (int64_t k = 0; k < w; ++k) {
          acc[k] += src[k] * src[k];
          dst[k] -= a * src[k] / (std::sqrt(acc[k]) + lrs[1]);
        }
        break;
      }
      case OptKind::kAdam: {
        // row-wise adam without global bias correction (matches the
        // reference's AdamOptimizer::ApplySparse per-row treatment)
        const float b1 = lrs[1], b2 = lrs[2], eps = lrs[3];
        float* mi = m.data() + row * w;
        float* vi = v.data() + row * w;
        for (int64_t k = 0; k < w; ++k) {
          mi[k] = b1 * mi[k] + (1 - b1) * src[k];
          vi[k] = b2 * vi[k] + (1 - b2) * src[k] * src[k];
          dst[k] -= a * mi[k] / (std::sqrt(vi[k]) + eps);
        }
        break;
      }
      default:  // Momentum variants fall back to SGD row update
        for (int64_t k = 0; k < w; ++k) dst[k] -= a * src[k];
    }
  }

  // sparse row update (reference ApplySparse/ApplyCache); bumps versions.
  // Duplicate row ids within one push are aggregated (summed) first so the
  // parallel apply touches each row exactly once — otherwise two omp
  // threads race on the same row's data/slots/version (lost updates).
  // Versions advance by occurrence count, matching the cache push path
  // (kPushEmbedding), so bounded-staleness accounting stays consistent.
  void apply_sparse(const int64_t* idx, size_t nidx, const float* g) {
    const int64_t w = width;
    const float a = lr();
    // cheap duplicate scan first: the common cache-drained push has all
    // unique ids, where we can apply straight from g with no copy
    std::unordered_map<int64_t, int64_t> occ;  // row -> occurrence count
    occ.reserve(nidx * 2);
    bool has_dup = false;
    for (size_t j = 0; j < nidx; ++j) {
      int64_t row = idx[j];
      if (row < 0 || row >= len) continue;
      if (++occ[row] > 1) has_dup = true;
    }
    if (!has_dup) {
      const int64_t n = static_cast<int64_t>(nidx);
#pragma omp parallel for
      for (int64_t j = 0; j < n; ++j) {
        int64_t row = idx[j];
        if (row < 0 || row >= len) continue;
        apply_row(row, g + j * w, a);
        if (!ver.empty()) ++ver[row];
      }
      return;
    }
    std::unordered_map<int64_t, size_t> slot;  // row -> index into uniq
    slot.reserve(occ.size() * 2);
    std::vector<int64_t> uniq_rows;
    std::vector<float> agg;  // aggregated gradients, uniq-major
    uniq_rows.reserve(occ.size());
    agg.reserve(occ.size() * w);
    for (size_t j = 0; j < nidx; ++j) {
      int64_t row = idx[j];
      if (row < 0 || row >= len) continue;
      const float* src = g + j * w;
      auto it = slot.find(row);
      if (it == slot.end()) {
        slot.emplace(row, uniq_rows.size());
        uniq_rows.push_back(row);
        agg.insert(agg.end(), src, src + w);
      } else {
        float* acc = agg.data() + it->second * w;
        for (int64_t k = 0; k < w; ++k) acc[k] += src[k];
      }
    }
    const int64_t nuniq = static_cast<int64_t>(uniq_rows.size());
#pragma omp parallel for
    for (int64_t j = 0; j < nuniq; ++j) {
      int64_t row = uniq_rows[j];
      apply_row(row, agg.data() + j * w, a);
      if (!ver.empty()) ver[row] += occ[row];
    }
  }

  void gather(const int64_t* idx, size_t nidx, float* out) const {
    const int64_t w = width;
    if (store) {
      // serial: TieredStore serializes on its own mutex anyway, and
      // read_row zero-fills out-of-range rows like the dense branch
      for (size_t j = 0; j < nidx; ++j)
        store->read_row(idx[j], out + j * w);
      return;
    }
#pragma omp parallel for
    for (size_t j = 0; j < nidx; ++j) {
      int64_t row = idx[j];
      if (row < 0 || row >= len) {
        std::memset(out + j * w, 0, w * sizeof(float));
      } else {
        std::memcpy(out + j * w, data.data() + row * w, w * sizeof(float));
      }
    }
  }
};

class Server {
 public:
  Server(int port, int nworkers) : port_(port), nworkers_(nworkers) {}

  int run() { return run_fd(-1); }

  // ``lfd >= 0``: an already-bound, already-listening socket inherited
  // from the launcher — the atomic port claim of ensure_server
  // (ps/server.py): whoever bind+listens it owns the port, so two
  // racing spawners can never both start a server. The re-listen below
  // is a harmless backlog update on that path.
  int run_fd(int lfd) {
    if (lfd < 0) {
      lfd = ::socket(AF_INET, SOCK_STREAM, 0);
      int one = 1;
      ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_addr.s_addr = htonl(INADDR_ANY);
      addr.sin_port = htons(static_cast<uint16_t>(port_));
      if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr),
                 sizeof addr) != 0) {
        std::perror("hetu-ps bind");
        return 1;
      }
    }
    if (::listen(lfd, 64) != 0) {
      std::perror("hetu-ps listen");
      return 1;
    }
    std::fprintf(stderr, "[hetu-ps] serving on :%d (%d workers)\n", port_,
                 nworkers_);
    // primary role: asynchronously forward acked mutations to the
    // shard's backup replica (ROADMAP item 2 failover)
    const char* bh = std::getenv("HETU_PS_MY_BACKUP_HOST");
    const char* bp = std::getenv("HETU_PS_MY_BACKUP_PORT");
    if (bh && bp && *bh && *bp) {
      backup_host_ = bh;
      backup_port_ = std::atoi(bp);
      const char* lag = std::getenv("HETU_PS_REPL_LAG");
      if (lag && *lag) repl_cap_ = static_cast<size_t>(std::atoi(lag));
      if (repl_cap_ < 1) repl_cap_ = 1;
      has_backup_ = true;
      repl_thread_ = std::thread(&Server::repl_loop, this);
      std::fprintf(stderr,
                   "[hetu-ps] replicating to backup %s:%d (lag %zu)\n",
                   backup_host_.c_str(), backup_port_, repl_cap_);
    }
    while (!stop_.load()) {
      int cfd = ::accept(lfd, nullptr, nullptr);
      if (cfd < 0) break;
      int nd = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof nd);
      std::thread(&Server::serve_conn, this, cfd).detach();
    }
    ::close(lfd);
    if (has_backup_) {
      {
        std::lock_guard<std::mutex> l(repl_mu_);
        repl_stop_.store(true);
      }
      repl_cv_.notify_all();
      repl_space_cv_.notify_all();
      repl_thread_.join();
    }
    return 0;
  }

 private:
  Tensor* get(int32_t id) {
    std::shared_lock<std::shared_mutex> l(store_mu_);
    auto it = store_.find(id);
    return it == store_.end() ? nullptr : it->second.get();
  }

  void serve_conn(int fd) {
    std::vector<uint8_t> payload;
    for (;;) {
      MsgHeader h;
      if (!read_full(fd, &h, sizeof h) || h.magic != 0x48505332) break;
      payload.resize(h.payload_len);
      if (h.payload_len && !read_full(fd, payload.data(), h.payload_len))
        break;
      Writer out;
      int32_t status = handle(static_cast<Op>(h.op), h.tensor_id,
                              payload, out, h.worker, h.seq);
      // forward acked mutations to the backup BEFORE acking the client
      // (blocking when the bounded queue is full): every update the
      // client saw acked is either applied on the backup already or in
      // this queue, so a client replay window >= the queue cap covers
      // all possible loss on primary death
      if (has_backup_ && status == 0 &&
          mutating_op(static_cast<Op>(h.op)))
        repl_enqueue(static_cast<Op>(h.op), h.tensor_id, h.worker,
                     h.seq, payload);
      MsgHeader rh;
      rh.op = h.op;
      rh.tensor_id = h.tensor_id;
      rh.status = status;
      rh.payload_len = out.buf.size();
      if (!write_full(fd, &rh, sizeof rh)) break;
      if (!out.buf.empty() &&
          !write_full(fd, out.buf.data(), out.buf.size()))
        break;
      if (static_cast<Op>(h.op) == Op::kShutdown) {
        stop_.store(true);
        // poke the accept loop
        int s = ::socket(AF_INET, SOCK_STREAM, 0);
        sockaddr_in a{};
        a.sin_family = AF_INET;
        a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
        a.sin_port = htons(static_cast<uint16_t>(port_));
        ::connect(s, reinterpret_cast<sockaddr*>(&a), sizeof a);
        ::close(s);
        break;
      }
    }
    ::close(fd);
  }

  // ------------------------------------------------------------------
  // primary -> backup replication (ROADMAP item 2): the ops whose
  // acked effect must survive a primary SIGKILL
  // ------------------------------------------------------------------
  // ==-chain, not a switch: analysis/wire.py treats `case Op::kX:`
  // labels as handler cases, and this helper is not one
  static bool mutating_op(Op op) {
    return op == Op::kInitTensor || op == Op::kDensePush ||
           op == Op::kDDPushPull || op == Op::kSparsePush ||
           op == Op::kSDPushPull || op == Op::kSSPushPull ||
           op == Op::kPushEmbedding || op == Op::kPushSyncEmbedding ||
           op == Op::kParamSet || op == Op::kParamClear ||
           op == Op::kParamLoad || op == Op::kPushData ||
           op == Op::kStoreConfig;
  }

  struct ReplItem {
    uint32_t op;
    int32_t id;
    uint32_t worker;
    uint64_t seq;
    std::vector<uint8_t> payload;
  };

  void repl_enqueue(Op op, int32_t id, uint32_t worker, uint64_t seq,
                    const std::vector<uint8_t>& payload) {
    std::unique_lock<std::mutex> l(repl_mu_);
    // blocking when full IS the bounded replication-lag window
    repl_space_cv_.wait(l, [&] {
      return repl_q_.size() < repl_cap_ || repl_stop_.load();
    });
    if (repl_stop_.load()) return;
    repl_q_.push_back(
        {static_cast<uint32_t>(op), id, worker, seq, payload});
    repl_cv_.notify_one();
  }

  int repl_dial() {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons(static_cast<uint16_t>(backup_port_));
    if (::inet_pton(AF_INET, backup_host_.c_str(), &a.sin_addr) != 1)
      a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (::connect(fd, reinterpret_cast<sockaddr*>(&a), sizeof a) != 0) {
      ::close(fd);
      return -1;
    }
    int nd = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof nd);
    return fd;
  }

  // relay one acked mutation: header carries the ORIGINAL (worker,
  // seq) identity so the backup's dedup covers client replays
  bool repl_send(int fd, const ReplItem& it) {
    MsgHeader h;
    h.op = static_cast<uint32_t>(Op::kReplForward);
    h.tensor_id = it.id;
    h.worker = it.worker;
    h.seq = it.seq;
    Writer w;
    w.u32(it.op);
    w.raw(it.payload.data(), it.payload.size());
    h.payload_len = w.buf.size();
    if (!write_full(fd, &h, sizeof h)) return false;
    if (!w.buf.empty() && !write_full(fd, w.buf.data(), w.buf.size()))
      return false;
    MsgHeader rh;
    if (!read_full(fd, &rh, sizeof rh) || rh.magic != 0x48505332)
      return false;
    std::vector<uint8_t> resp(rh.payload_len);
    if (rh.payload_len && !read_full(fd, resp.data(), rh.payload_len))
      return false;
    return true;
  }

  void repl_loop() {
    int fd = -1;
    for (;;) {
      ReplItem it;
      {
        std::unique_lock<std::mutex> l(repl_mu_);
        repl_cv_.wait(l, [&] {
          return !repl_q_.empty() || repl_stop_.load();
        });
        if (repl_q_.empty()) break;  // stopped and drained
        it = std::move(repl_q_.front());
        repl_q_.pop_front();
        repl_space_cv_.notify_one();
      }
      bool sent = false;
      for (int tries = 0; tries < 50 && !sent; ++tries) {
        if (fd < 0) fd = repl_dial();
        if (fd >= 0 && repl_send(fd, it)) {
          sent = true;
        } else {
          if (fd >= 0) ::close(fd);
          fd = -1;
          if (repl_stop_.load()) break;
          struct timespec ts {0, 100 * 1000 * 1000};
          ::nanosleep(&ts, nullptr);
        }
      }
      if (!sent && !repl_warned_) {
        repl_warned_ = true;
        std::fprintf(stderr,
                     "[hetu-ps] backup %s:%d unreachable; replication "
                     "degraded (client replay still covers failover)\n",
                     backup_host_.c_str(), backup_port_);
      }
    }
    if (fd >= 0) ::close(fd);
  }

  // at-most-once retry protection (reference ps-lite resender.h): a
  // client retries a request whose connection died after the server may
  // already have applied it; mutating ops are deduped on (worker, seq)
  // so the retry serves only the read part. Returns true if duplicate.
  bool check_and_record(uint32_t worker, uint64_t seq) {
    std::lock_guard<std::mutex> l(dedup_mu_);
    auto& d = dedup_[worker];
    if (d.seen.count(seq)) return true;
    d.seen.insert(seq);
    d.order.push_back(seq);
    if (d.order.size() > 65536) {
      d.seen.erase(d.order.front());
      d.order.pop_front();
    }
    return false;
  }

  int32_t handle(Op op, int32_t id, const std::vector<uint8_t>& payload,
                 Writer& out, uint32_t worker, uint64_t seq) {
    Reader rd(payload.data(), payload.size());
    switch (op) {
      case Op::kInitTensor: {
        auto t = std::make_unique<Tensor>();
        t->kind = static_cast<ParamKind>(rd.i32());
        t->len = rd.i64();
        t->width = rd.i64();
        InitKind ik = static_cast<InitKind>(rd.i32());
        double a = rd.f64(), b = rd.f64();
        uint64_t seed = rd.u64();
        t->opt = static_cast<OptKind>(rd.i32());
        size_t nlr;
        const float* lrp = rd.floats(&nlr);
        t->lrs.assign(lrp, lrp + nlr);
        t->data.resize(t->nelem());
        // on-server init (reference PSFHandle.h:277-342)
        std::mt19937_64 gen(seed ? seed : 0x9e3779b9);
        switch (ik) {
          case InitKind::kConstant:
            std::fill(t->data.begin(), t->data.end(),
                      static_cast<float>(a));
            break;
          case InitKind::kUniform: {
            std::uniform_real_distribution<float> d(
                static_cast<float>(a), static_cast<float>(b));
            for (auto& x : t->data) x = d(gen);
            break;
          }
          case InitKind::kNormal: {
            std::normal_distribution<float> d(static_cast<float>(a),
                                              static_cast<float>(b));
            for (auto& x : t->data) x = d(gen);
            break;
          }
          case InitKind::kTruncatedNormal: {
            std::normal_distribution<float> d(static_cast<float>(a),
                                              static_cast<float>(b));
            for (auto& x : t->data) {
              do {
                x = d(gen);
              } while (std::fabs(x - a) > 2 * b);
            }
            break;
          }
        }
        t->init_slots();
        if (t->kind == ParamKind::kCacheTable) t->ver.assign(t->len, 0);
        {
          std::unique_lock<std::shared_mutex> l(store_mu_);
          // idempotent across workers: first init wins (reference
          // PSFHandle ParamInit re-registration is a no-op)
          if (!store_.count(id)) store_[id] = std::move(t);
        }
        return 0;
      }
      case Op::kDensePull: {
        Tensor* t = get(id);
        if (!t) return -1;
        std::shared_lock<std::shared_mutex> l(t->mu);
        std::vector<float> snap;
        out.floats(t->dense_view(snap), t->nelem());
        return 0;
      }
      case Op::kDensePush:
      case Op::kDDPushPull: {
        Tensor* t = get(id);
        if (!t) return -1;
        size_t n;
        const float* g = rd.floats(&n);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (!dup && static_cast<int64_t>(n) == t->nelem())
          t->apply_dense(g);
        if (op == Op::kDDPushPull) {
          std::vector<float> snap;
          out.floats(t->dense_view(snap), t->nelem());
        }
        bytes_in_ += n * 4;
        return 0;
      }
      case Op::kSparsePull: {
        Tensor* t = get(id);
        if (!t) return -1;
        size_t nidx;
        const int64_t* idx = rd.longs(&nidx);
        std::shared_lock<std::shared_mutex> l(t->mu);
        out.i64(static_cast<int64_t>(nidx * t->width));
        size_t off = out.buf.size();
        out.buf.resize(off + nidx * t->width * sizeof(float));
        t->gather(idx, nidx,
                  reinterpret_cast<float*>(out.buf.data() + off));
        return 0;
      }
      case Op::kSparsePush: {
        Tensor* t = get(id);
        if (!t) return -1;
        size_t nidx, nval;
        const int64_t* idx = rd.longs(&nidx);
        const float* g = rd.floats(&nval);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (!dup) t->apply_sparse(idx, nidx, g);
        bytes_in_ += nval * 4;
        return 0;
      }
      case Op::kSDPushPull: {
        // push sparse grad rows, pull the full dense tensor
        Tensor* t = get(id);
        if (!t) return -1;
        size_t nidx, nval;
        const int64_t* idx = rd.longs(&nidx);
        const float* g = rd.floats(&nval);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (!dup) t->apply_sparse(idx, nidx, g);
        std::vector<float> snap;
        out.floats(t->dense_view(snap), t->nelem());
        return 0;
      }
      case Op::kSSPushPull: {
        // push grad rows at in-indices, pull rows at out-indices (the
        // prefetch pipeline: pull next batch's rows — reference
        // SSPushPull, PSFHandle.h:217-268)
        Tensor* t = get(id);
        if (!t) return -1;
        size_t nin, nval, nout;
        const int64_t* in_idx = rd.longs(&nin);
        const float* g = rd.floats(&nval);
        const int64_t* out_idx = rd.longs(&nout);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (!dup) t->apply_sparse(in_idx, nin, g);
        out.i64(static_cast<int64_t>(nout * t->width));
        size_t off = out.buf.size();
        out.buf.resize(off + nout * t->width * sizeof(float));
        t->gather(out_idx, nout,
                  reinterpret_cast<float*>(out.buf.data() + off));
        return 0;
      }
      case Op::kSyncEmbedding: {
        // bounded staleness: return only rows whose server version
        // exceeds the client's by more than `bound`
        // (reference hetu_client.cc:6-38 / PSFhandle_embedding.cc)
        Tensor* t = get(id);
        if (!t || t->ver.empty()) return -1;
        int64_t bound = rd.i64();
        size_t nidx, nver;
        const int64_t* idx = rd.longs(&nidx);
        const int64_t* cver = rd.longs(&nver);
        std::shared_lock<std::shared_mutex> l(t->mu);
        std::vector<int64_t> stale_pos, stale_ver;
        std::vector<float> rows;
        std::vector<float> scratch(t->width);
        for (size_t j = 0; j < nidx; ++j) {
          int64_t row = idx[j];
          if (row < 0 || row >= t->len) continue;
          if (t->ver[row] - cver[j] > bound) {
            stale_pos.push_back(static_cast<int64_t>(j));
            stale_ver.push_back(t->ver[row]);
            size_t o = rows.size();
            rows.resize(o + t->width);
            std::memcpy(rows.data() + o, t->row_src(row, scratch.data()),
                        t->width * sizeof(float));
          }
        }
        out.longs(stale_pos.data(), stale_pos.size());
        out.longs(stale_ver.data(), stale_ver.size());
        out.floats(rows.data(), rows.size());
        return 0;
      }
      case Op::kPushEmbedding: {
        Tensor* t = get(id);
        if (!t) return -1;
        size_t nidx, nval, nupd;
        const int64_t* idx = rd.longs(&nidx);
        const float* g = rd.floats(&nval);
        const int64_t* upd = rd.longs(&nupd);  // per-row update counts
        bool dup = check_and_record(worker, seq);
        if (dup) return 0;
        std::unique_lock<std::shared_mutex> l(t->mu);
        t->apply_sparse(idx, nidx, g);
        if (!t->ver.empty())
          for (size_t j = 0; j < nupd && j < nidx; ++j)
            if (idx[j] >= 0 && idx[j] < t->len)
              t->ver[idx[j]] += upd[j] - 1;  // apply_sparse added 1
        return 0;
      }
      case Op::kPushSyncEmbedding: {
        Tensor* t = get(id);
        if (!t || t->ver.empty()) return -1;
        int64_t bound = rd.i64();
        size_t npidx, nval, nupd, nsidx, nsver;
        const int64_t* pidx = rd.longs(&npidx);
        const float* g = rd.floats(&nval);
        const int64_t* upd = rd.longs(&nupd);
        const int64_t* sidx = rd.longs(&nsidx);
        const int64_t* sver = rd.longs(&nsver);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (!dup) {
          t->apply_sparse(pidx, npidx, g);
          for (size_t j = 0; j < nupd && j < npidx; ++j)
            if (pidx[j] >= 0 && pidx[j] < t->len)
              t->ver[pidx[j]] += upd[j] - 1;
        }
        std::vector<int64_t> stale_pos, stale_ver;
        std::vector<float> rows;
        std::vector<float> scratch(t->width);
        for (size_t j = 0; j < nsidx; ++j) {
          int64_t row = sidx[j];
          if (row < 0 || row >= t->len) continue;
          if (t->ver[row] - sver[j] > bound) {
            stale_pos.push_back(static_cast<int64_t>(j));
            stale_ver.push_back(t->ver[row]);
            size_t o = rows.size();
            rows.resize(o + t->width);
            std::memcpy(rows.data() + o, t->row_src(row, scratch.data()),
                        t->width * sizeof(float));
          }
        }
        out.longs(stale_pos.data(), stale_pos.size());
        out.longs(stale_ver.data(), stale_ver.size());
        out.floats(rows.data(), rows.size());
        return 0;
      }
      case Op::kParamSet: {
        Tensor* t = get(id);
        if (!t) return -1;
        size_t n;
        const float* p = rd.floats(&n);
        // overwrites need the dedup too: a post-failover REPLAY of an
        // old overwrite arriving after forwarded accumulating updates
        // would rewind the surviving replica (retries alone would not
        // care — re-overwriting is idempotent)
        bool dup = check_and_record(worker, seq);
        if (dup) return 0;
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (static_cast<int64_t>(n) != t->nelem()) return -3;
        if (t->store) {
          for (int64_t r = 0; r < t->len; ++r)
            t->store->write_row(r, p + r * t->width);
        } else {
          std::memcpy(t->data.data(), p, n * sizeof(float));
        }
        return 0;
      }
      case Op::kParamClear: {
        Tensor* t = get(id);
        if (!t) return -1;
        bool dup = check_and_record(worker, seq);
        if (dup) return 0;
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (t->store) {
          std::vector<float> z(t->width, 0.f);
          for (int64_t r = 0; r < t->len; ++r)
            t->store->write_row(r, z.data());
        } else {
          std::fill(t->data.begin(), t->data.end(), 0.f);
        }
        return 0;
      }
      case Op::kParamSave: {
        Tensor* t = get(id);
        if (!t) return -1;
        std::string path = rd.str();
        std::shared_lock<std::shared_mutex> l(t->mu);
        FILE* f = std::fopen(path.c_str(), "wb");
        if (!f) return -2;
        std::fwrite(&t->len, sizeof t->len, 1, f);
        std::fwrite(&t->width, sizeof t->width, 1, f);
        std::vector<float> snap;
        std::fwrite(t->dense_view(snap), sizeof(float),
                    static_cast<size_t>(t->nelem()), f);
        std::fclose(f);
        return 0;
      }
      case Op::kParamLoad: {
        Tensor* t = get(id);
        if (!t) return -1;
        std::string path = rd.str();
        bool dup = check_and_record(worker, seq);
        if (dup) return 0;
        std::unique_lock<std::shared_mutex> l(t->mu);
        FILE* f = std::fopen(path.c_str(), "rb");
        if (!f) return -2;
        int64_t len, width;
        if (std::fread(&len, sizeof len, 1, f) != 1 ||
            std::fread(&width, sizeof width, 1, f) != 1 ||
            len != t->len || width != t->width) {
          std::fclose(f);
          return -3;
        }
        if (t->store) {
          std::vector<float> tmp(t->nelem());
          size_t got = std::fread(tmp.data(), sizeof(float), tmp.size(),
                                  f);
          std::fclose(f);
          if (got != tmp.size()) return -3;
          for (int64_t r = 0; r < t->len; ++r)
            t->store->write_row(r, tmp.data() + r * t->width);
          return 0;
        }
        size_t got = std::fread(t->data.data(), sizeof(float),
                                t->data.size(), f);
        std::fclose(f);
        return got == t->data.size() ? 0 : -3;
      }
      case Op::kBarrier: {
        std::unique_lock<std::mutex> l(bar_mu_);
        // a retried barrier (first registration's response was lost)
        // must not count the worker twice: wait out the generation the
        // original registration joined, then succeed
        bool is_dup = false;
        int reg_gen = 0;
        {
          std::lock_guard<std::mutex> dl(dedup_mu_);
          auto& d = dedup_[worker];
          auto it = d.bar_gen.find(seq);
          if (it != d.bar_gen.end()) {
            is_dup = true;
            reg_gen = it->second;
          } else {
            d.bar_gen[seq] = bar_gen_;
            d.bar_order.push_back(seq);
            if (d.bar_order.size() > 1024) {
              // evict the OLDEST registration — live retries target
              // recent barriers, so insertion-order pruning never
              // drops an in-flight retry's dedup entry
              d.bar_gen.erase(d.bar_order.front());
              d.bar_order.pop_front();
            }
          }
        }
        if (is_dup) {
          bar_cv_.wait(l, [&] { return bar_gen_ != reg_gen; });
          return 0;
        }
        int gen = bar_gen_;
        if (++bar_count_ >= nworkers_) {
          bar_count_ = 0;
          ++bar_gen_;
          bar_cv_.notify_all();
        } else {
          bar_cv_.wait(l, [&] { return bar_gen_ != gen; });
        }
        return 0;
      }
      case Op::kPushData: {
        int64_t key = rd.i64();
        size_t n;
        const float* p = rd.floats(&n);
        bool dup = check_and_record(worker, seq);
        if (dup) return 0;
        std::unique_lock<std::shared_mutex> l(blob_mu_);
        blobs_[key].assign(p, p + n);
        return 0;
      }
      case Op::kPullData: {
        int64_t key = rd.i64();
        std::shared_lock<std::shared_mutex> l(blob_mu_);
        auto it = blobs_.find(key);
        if (it == blobs_.end()) return -1;
        out.floats(it->second.data(), it->second.size());
        return 0;
      }
      case Op::kGetLoads: {
        out.u64(bytes_in_.load());
        return 0;
      }
      case Op::kReplForward: {
        // relay from a primary: re-dispatch the wrapped op under its
        // ORIGINAL (worker, seq) identity, so this replica's dedup
        // covers the client's post-failover replay window exactly once
        if (payload.size() < sizeof(uint32_t)) return -3;
        uint32_t orig = rd.u32();
        std::vector<uint8_t> inner(payload.begin() + sizeof(uint32_t),
                                   payload.end());
        return handle(static_cast<Op>(orig), id, inner, out, worker,
                      seq);
      }
      case Op::kStoreConfig: {
        // convert an existing table to tiered/quantized row storage:
        // the spill file name folds in this server's port so primary
        // and backup replicas on one host never share a file
        Tensor* t = get(id);
        if (!t) return -1;
        int32_t dt = rd.i32();
        int64_t dram_rows = rd.i64();
        std::string dir = rd.str();
        size_t nhot;
        const int64_t* hot = rd.longs(&nhot);
        bool dup = check_and_record(worker, seq);
        std::unique_lock<std::shared_mutex> l(t->mu);
        if (dup) return 0;
        if (t->store) {
          // already tiered: re-pin only — reading promotes, so the
          // freshest measured-hot set ends resident in DRAM
          std::vector<float> tmp(t->width);
          for (size_t j = 0; j < nhot; ++j)
            if (hot[j] >= 0 && hot[j] < t->len)
              t->store->read_row(hot[j], tmp.data());
          return 0;
        }
        if (t->opt != OptKind::kSGD && t->opt != OptKind::kNone)
          return -4;  // slot-carrying optimizers are not tiered
        std::string path = dir + "/ps_spill_" + std::to_string(id) +
                           "_" + std::to_string(port_) + ".bin";
        auto st = std::make_unique<TieredStore>(
            t->len, t->width, static_cast<StoreDtype>(dt), dram_rows,
            path);
        if (!st->ok()) return -2;
        // migrate: cold rows stream through (and out of) the pool;
        // measured-hot ids (PR 9 skew telemetry) re-read LAST so they
        // end resident in DRAM
        for (int64_t r = 0; r < t->len; ++r)
          st->write_row(r, t->data.data() + r * t->width);
        std::vector<float> tmp(t->width);
        for (size_t j = 0; j < nhot; ++j)
          if (hot[j] >= 0 && hot[j] < t->len)
            st->read_row(hot[j], tmp.data());
        t->store = std::move(st);
        t->data.clear();
        t->data.shrink_to_fit();
        return 0;
      }
      case Op::kStoreStats: {
        Tensor* t = get(id);
        if (!t) return -1;
        // replication backlog sampled BEFORE taking t->mu: the repl
        // worker's repl_mu_ sections never take a tensor lock, and
        // keeping the two disjoint here preserves that (no new lock
        // order is introduced by this read-only stat)
        size_t repl_depth = 0;
        {
          std::lock_guard<std::mutex> rl(repl_mu_);
          repl_depth = repl_q_.size();
        }
        std::shared_lock<std::shared_mutex> l(t->mu);
        TieredStore::Stats s;
        if (t->store)
          s = t->store->stats();
        else
          s.row_bytes = t->width * 4;
        out.u64(s.dram_hits);
        out.u64(s.spill_hits);
        out.u64(s.spill_writes);
        out.i64(s.dram_rows);
        out.i64(s.row_bytes);
        out.i64(static_cast<int64_t>(repl_depth));
        return 0;
      }
      case Op::kShutdown:
        return 0;
    }
    return -100;
  }

  int port_;
  int nworkers_;
  std::atomic<bool> stop_{false};
  // replication state (primary role only)
  bool has_backup_ = false;
  bool repl_warned_ = false;
  std::string backup_host_;
  int backup_port_ = 0;
  std::deque<ReplItem> repl_q_;
  size_t repl_cap_ = 128;
  std::mutex repl_mu_;
  std::condition_variable repl_cv_, repl_space_cv_;
  std::atomic<bool> repl_stop_{false};
  std::thread repl_thread_;
  std::unordered_map<int32_t, std::unique_ptr<Tensor>> store_;
  std::shared_mutex store_mu_;
  std::unordered_map<int64_t, std::vector<float>> blobs_;
  std::shared_mutex blob_mu_;
  std::mutex bar_mu_;
  std::condition_variable bar_cv_;
  int bar_count_ = 0;
  int bar_gen_ = 0;
  // per-worker (seq) dedup for at-most-once mutating ops
  struct WorkerDedup {
    std::unordered_set<uint64_t> seen;
    std::deque<uint64_t> order;
    std::unordered_map<uint64_t, int> bar_gen;  // barrier seq -> gen
    std::deque<uint64_t> bar_order;             // insertion order
  };
  std::mutex dedup_mu_;
  std::unordered_map<uint32_t, WorkerDedup> dedup_;
  std::atomic<uint64_t> bytes_in_{0};
};

}  // namespace hetups

extern "C" int hetu_ps_run_server(int port, int nworkers) {
  hetups::Server s(port, nworkers);
  return s.run();
}

// launcher-claimed-socket form: serve on an inherited bound fd (the
// ensure_server startup-race fix); ``port`` is still needed for the
// shutdown self-connect poke.
extern "C" int hetu_ps_run_server_fd(int lfd, int port, int nworkers) {
  hetups::Server s(port, nworkers);
  return s.run_fd(lfd);
}
