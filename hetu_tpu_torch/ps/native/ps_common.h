// Wire protocol + shared types for the hetu-tpu host parameter server.
//
// TPU-native counterpart of the reference's ps-lite stack
// (ps-lite/include/ps/psf/PSFunc.h PsfType enum, ps/server/param.h,
// python_binding.cc C ABI): a typed-request key-value server holding
// dense parameters and 2-D embedding tables in host RAM, serving TPU
// hosts over TCP (localhost in tests, DCN between pod hosts). Framing is
// length-prefixed little-endian binary — no serializer dependency.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace hetups {

// Mirrors the reference PsfType coverage (PSFunc.h:14-34).
enum class Op : uint32_t {
  kInitTensor = 1,
  kDensePull = 2,
  kDensePush = 3,
  kDDPushPull = 4,
  kSparsePull = 5,
  kSparsePush = 6,
  kSDPushPull = 7,
  kSSPushPull = 8,
  kParamClear = 9,
  kParamSave = 10,
  kParamLoad = 11,
  kBarrier = 12,
  kSyncEmbedding = 13,     // bounded-staleness cache pull
  kPushEmbedding = 14,     // cache grad push (bumps versions)
  // combined push + stale-row pull: one round trip per shard instead of
  // the cache's PushEmbedding + SyncEmbedding pair (ROADMAP item 2)
  kPushSyncEmbedding = 15,
  kGetLoads = 16,
  kShutdown = 17,
  kPushData = 18,          // generic blob store (GNN graph shards)
  kPullData = 19,
  kParamSet = 20,          // overwrite values (initial upload; no optimizer)
  // primary->backup replication relay: header carries the ORIGINAL
  // (worker, seq) identity; payload = u32 original op + original
  // payload bytes, re-dispatched through handle() on the backup so the
  // backup's (worker, seq) dedup covers client replays after failover
  kReplForward = 21,
  kStoreConfig = 22,       // tiered/quantized row storage for one table
  kStoreStats = 23,        // DRAM/spill hit counters + row bytes
};

// reference ps/server/param.h:11-21
enum class ParamKind : int32_t { kParam = 0, kParam2D = 1, kCacheTable = 2 };

// reference ps/server/optimizer.h:15-22 (OptType)
enum class OptKind : int32_t {
  kSGD = 0,
  kMomentum = 1,
  kNesterov = 2,
  kAdaGrad = 3,
  kAdam = 4,
  kNone = 5,   // worker pre-scaled gradient; server just accumulates
};

// reference python/hetu/initializers.py init codes (on-server random init,
// PSFHandle.h:277-342)
enum class InitKind : int32_t {
  kConstant = 0,
  kUniform = 1,
  kNormal = 2,
  kTruncatedNormal = 3,
};

struct MsgHeader {
  uint32_t magic = 0x48505332;  // "HPS2" (v2: adds worker+seq)
  uint32_t op = 0;
  int32_t tensor_id = 0;
  int32_t status = 0;           // response: 0 ok
  uint64_t payload_len = 0;     // bytes after header
  // request identity for at-most-once retry semantics (reference
  // ps-lite resender.h tracks message signatures the same way): the
  // client retries a call whose connection died or timed out; the
  // server dedups mutating ops on (worker, seq) so a push whose
  // response was lost is not applied twice.
  uint32_t worker = 0;
  uint32_t reserved = 0;
  uint64_t seq = 0;
};

static_assert(sizeof(MsgHeader) == 40, "header layout");

// ---------------------------------------------------------------------------
// payload (de)serialization helpers
// ---------------------------------------------------------------------------

class Writer {
 public:
  void u32(uint32_t v) { raw(&v, sizeof v); }
  void i32(int32_t v) { raw(&v, sizeof v); }
  void i64(int64_t v) { raw(&v, sizeof v); }
  void u64(uint64_t v) { raw(&v, sizeof v); }
  void f32(float v) { raw(&v, sizeof v); }
  void f64(double v) { raw(&v, sizeof v); }
  void floats(const float* p, size_t n) {
    i64(static_cast<int64_t>(n));
    raw(p, n * sizeof(float));
  }
  void longs(const int64_t* p, size_t n) {
    i64(static_cast<int64_t>(n));
    raw(p, n * sizeof(int64_t));
  }
  void str(const std::string& s) {
    i64(static_cast<int64_t>(s.size()));
    raw(s.data(), s.size());
  }
  void raw(const void* p, size_t n) {
    size_t off = buf.size();
    buf.resize(off + n);
    std::memcpy(buf.data() + off, p, n);
  }
  std::vector<uint8_t> buf;
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  uint32_t u32() { return take<uint32_t>(); }
  int32_t i32() { return take<int32_t>(); }
  int64_t i64() { return take<int64_t>(); }
  uint64_t u64() { return take<uint64_t>(); }
  float f32() { return take<float>(); }
  double f64() { return take<double>(); }
  const float* floats(size_t* n) {
    *n = static_cast<size_t>(i64());
    const float* out = reinterpret_cast<const float*>(p_ + off_);
    off_ += *n * sizeof(float);
    return out;
  }
  const int64_t* longs(size_t* n) {
    *n = static_cast<size_t>(i64());
    const int64_t* out = reinterpret_cast<const int64_t*>(p_ + off_);
    off_ += *n * sizeof(int64_t);
    return out;
  }
  std::string str() {
    size_t n = static_cast<size_t>(i64());
    std::string s(reinterpret_cast<const char*>(p_ + off_), n);
    off_ += n;
    return s;
  }
  bool ok() const { return off_ <= n_; }

 private:
  template <typename T>
  T take() {
    T v;
    std::memcpy(&v, p_ + off_, sizeof v);
    off_ += sizeof v;
    return v;
  }
  const uint8_t* p_;
  size_t n_;
  size_t off_ = 0;
};

}  // namespace hetups
