// Client-side embedding cache with bounded staleness.
//
// TPU-native counterpart of the reference's hetu_cache
// (src/hetu_cache/include/{cache.h,embedding.h}, src/hetu_client.cc):
// cached rows carry (version, pending-update count, grad accumulator);
// lookups sync stale rows against the server under a pull bound; updates
// accumulate locally and push with their update counts so the server's
// row version advances by the number of folded gradients — the version
// algebra that gives bounded-staleness consistency across workers.
// Policies: LRU / LFU / LFUOpt (reference cache.h policy subclasses).
#include <cstdint>
#include <cstring>
#include <limits>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

// RPC helpers from ps_client.cc (same shared object)
extern "C" {
int SyncEmbedding(int id, int64_t bound, const int64_t* idx, int64_t* ver,
                  int64_t nidx, float* out, int64_t width);
void PushEmbedding(int id, const int64_t* idx, const float* vals,
                   const int64_t* updates, int64_t nidx, int64_t width);
int SparsePull(int id, const int64_t* idx, float* out, int64_t nidx,
               int64_t width);
void Wait(int id);
}

namespace hetucache {

constexpr int64_t kNeverSynced = std::numeric_limits<int64_t>::min() / 2;

struct Line {
  int64_t key;
  int64_t version = kNeverSynced;  // forces first sync to pull
  int64_t updates = 0;
  std::vector<float> data;
  std::vector<float> grad;
  // policy bookkeeping
  uint64_t freq = 0;
  std::list<int64_t>::iterator pos;   // LRU order / LFU bucket position
  uint64_t bucket = 0;                // LFU frequency bucket
};

enum Policy { kLRU = 0, kLFU = 1, kLFUOpt = 2 };

class EmbedCache {
 public:
  EmbedCache(int tid, int64_t limit, int64_t width, int policy,
             int64_t pull_bound, int64_t push_bound)
      : tid_(tid), limit_(limit), width_(width), policy_(policy),
        pull_bound_(pull_bound), push_bound_(push_bound) {}

  // Batched lookup: hits sync under the pull bound, misses pull
  // unconditionally (version = -inf), victims flush their gradients.
  void lookup(const int64_t* keys, int64_t n, float* out) {
    std::lock_guard<std::mutex> l(mu_);
    // Distinct lines for this batch hold shared ownership, so a line
    // evicted while later keys insert stays valid for this batch (the
    // reference keeps EmbeddingPT shared_ptrs for the same reason,
    // cache.h batchedLookup).
    std::unordered_map<int64_t, std::shared_ptr<Line>> batch;
    for (int64_t i = 0; i < n; ++i) {
      if (batch.count(keys[i])) { ++hits_; continue; }
      auto it = map_.find(keys[i]);
      if (it != map_.end()) {
        ++hits_;
        touch(it->second.get());
        batch[keys[i]] = it->second;
      } else {
        ++misses_;
        batch[keys[i]] = insert_line(keys[i]);
      }
    }
    sync_lines(batch);
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(out + i * width_, batch.at(keys[i])->data.data(),
                  width_ * sizeof(float));
  }

  // Accumulate gradients locally; rows past the push bound flush.
  void update(const int64_t* keys, const float* grads, int64_t n) {
    std::lock_guard<std::mutex> l(mu_);
    std::unordered_map<int64_t, std::shared_ptr<Line>> due;
    std::unordered_map<int64_t, std::shared_ptr<Line>> batch;
    for (int64_t i = 0; i < n; ++i) {
      std::shared_ptr<Line> ln;
      auto bit = batch.find(keys[i]);
      if (bit != batch.end()) {
        ln = bit->second;
      } else {
        auto it = map_.find(keys[i]);
        ln = (it == map_.end()) ? insert_line(keys[i]) : it->second;
        batch[keys[i]] = ln;
      }
      if (ln->grad.empty()) ln->grad.assign(width_, 0.f);
      const float* g = grads + i * width_;
      for (int64_t k = 0; k < width_; ++k) ln->grad[k] += g[k];
      ++ln->updates;
      if (ln->updates >= push_bound_) due[ln->key] = ln;
    }
    flush_lines_shared(due);
  }

  void flush() {
    std::lock_guard<std::mutex> l(mu_);
    std::unordered_map<int64_t, std::shared_ptr<Line>> due;
    for (auto& kv : map_)
      if (kv.second->updates > 0) due[kv.first] = kv.second;
    flush_lines_shared(due);
    Wait(tid_);
  }

  uint64_t perf(int what) const {
    switch (what) {
      case 0: return hits_;
      case 1: return misses_;
      case 2: return evicts_;
      case 3: return map_.size();
      case 4: return pushed_rows_;
      case 5: return pulled_rows_;
    }
    return 0;
  }

 private:
  void touch(Line* ln) {
    ++tick_;
    if (policy_ == kLRU) {
      lru_.splice(lru_.begin(), lru_, ln->pos);
    } else {
      // move to next frequency bucket
      lfu_[ln->bucket].erase(ln->pos);
      if (lfu_[ln->bucket].empty()) lfu_.erase(ln->bucket);
      ++ln->freq;
      ln->bucket = ln->freq;
      lfu_[ln->bucket].push_front(ln->key);
      ln->pos = lfu_[ln->bucket].begin();
    }
  }

  std::shared_ptr<Line> insert_line(int64_t key) {
    auto found = map_.find(key);
    if (found != map_.end()) return found->second;
    while (static_cast<int64_t>(map_.size()) >= limit_) evict_one();
    auto ln = std::make_shared<Line>();
    ln->key = key;
    ln->data.assign(width_, 0.f);
    if (policy_ == kLRU) {
      lru_.push_front(key);
      ln->pos = lru_.begin();
    } else {
      // LFU starts new lines at frequency 1; LFUOpt starts them at the
      // current minimum bucket so one-shot keys can't flush the working
      // set (the reference's LFUOpt refinement)
      uint64_t b = 1;
      if (policy_ == kLFUOpt && !lfu_.empty())
        b = lfu_.begin()->first;
      ln->freq = b;
      ln->bucket = b;
      lfu_[b].push_front(key);
      ln->pos = lfu_[b].begin();
    }
    map_[key] = ln;
    return ln;
  }

  void evict_one() {
    int64_t victim;
    if (policy_ == kLRU) {
      victim = lru_.back();
    } else {
      victim = lfu_.begin()->second.back();
    }
    std::shared_ptr<Line> ln = map_.at(victim);
    if (ln->updates > 0) {
      std::unordered_map<int64_t, std::shared_ptr<Line>> due{{victim, ln}};
      flush_lines_shared(due);
    }
    if (policy_ == kLRU) {
      lru_.pop_back();
    } else {
      lfu_.begin()->second.pop_back();
      if (lfu_.begin()->second.empty()) lfu_.erase(lfu_.begin());
    }
    map_.erase(victim);
    ++evicts_;
  }

  void sync_lines(std::unordered_map<int64_t, std::shared_ptr<Line>>& lines) {
    if (lines.empty()) return;
    std::vector<int64_t> keys, vers;
    std::vector<Line*> order;
    keys.reserve(lines.size());
    for (auto& kv : lines) {
      keys.push_back(kv.first);
      vers.push_back(kv.second->version);
      order.push_back(kv.second.get());
    }
    std::vector<float> rows(keys.size() * width_);
    // one RPC: rows whose server version exceeds ours by > pull_bound
    // come back refreshed (reference syncEmbedding, hetu_client.cc:6-38)
    int refreshed = SyncEmbedding(tid_, pull_bound_, keys.data(),
                                  vers.data(), keys.size(), rows.data(),
                                  width_);
    if (refreshed > 0) {
      for (size_t j = 0; j < order.size(); ++j) {
        if (vers[j] != order[j]->version) {
          order[j]->version = vers[j];
          std::memcpy(order[j]->data.data(), rows.data() + j * width_,
                      width_ * sizeof(float));
          ++pulled_rows_;
        }
      }
    }
  }

  void flush_lines_shared(
      std::unordered_map<int64_t, std::shared_ptr<Line>>& due) {
    if (due.empty()) return;
    std::vector<int64_t> keys, updates;
    std::vector<float> grads;
    for (auto& kv : due) {
      Line* ln = kv.second.get();
      keys.push_back(ln->key);
      updates.push_back(ln->updates);
      grads.insert(grads.end(), ln->grad.begin(), ln->grad.end());
      ln->updates = 0;
      std::fill(ln->grad.begin(), ln->grad.end(), 0.f);
    }
    PushEmbedding(tid_, keys.data(), grads.data(), updates.data(),
                  keys.size(), width_);
    pushed_rows_ += keys.size();
  }

  int tid_;
  int64_t limit_, width_;
  int policy_;
  int64_t pull_bound_, push_bound_;
  std::unordered_map<int64_t, std::shared_ptr<Line>> map_;
  std::list<int64_t> lru_;
  std::map<uint64_t, std::list<int64_t>> lfu_;
  uint64_t tick_ = 0;
  uint64_t hits_ = 0, misses_ = 0, evicts_ = 0;
  uint64_t pushed_rows_ = 0, pulled_rows_ = 0;
  std::mutex mu_;
};

static std::mutex g_mu;
static std::unordered_map<int, std::unique_ptr<EmbedCache>> g_caches;
static int g_next = 1;

}  // namespace hetucache

extern "C" {

int CacheCreate(int tid, int64_t limit, int64_t width, int policy,
                int64_t pull_bound, int64_t push_bound) {
  std::lock_guard<std::mutex> l(hetucache::g_mu);
  int h = hetucache::g_next++;
  hetucache::g_caches[h] = std::make_unique<hetucache::EmbedCache>(
      tid, limit, width, policy, pull_bound, push_bound);
  return h;
}

void CacheDestroy(int h) {
  std::lock_guard<std::mutex> l(hetucache::g_mu);
  hetucache::g_caches.erase(h);
}

void CacheLookup(int h, const int64_t* keys, int64_t n, float* out) {
  hetucache::g_caches.at(h)->lookup(keys, n, out);
}

void CacheUpdate(int h, const int64_t* keys, const float* grads,
                 int64_t n) {
  hetucache::g_caches.at(h)->update(keys, grads, n);
}

void CacheFlush(int h) { hetucache::g_caches.at(h)->flush(); }

uint64_t CachePerf(int h, int what) {
  return hetucache::g_caches.at(h)->perf(what);
}

}  // extern "C"
