// TieredStore: DRAM slot pool over an mmap'd sparse spill file with
// fp16/int8 row quantization. See ps_store.h for the contract. This
// translation unit carries no wire ops — the protocol surface stays in
// ps_server.cc / ps_client.cc where analysis/wire.py parses it.
#include "ps_store.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cmath>
#include <cstring>

namespace hetups {

// IEEE 754 binary16 conversion (round-to-nearest-even via the float
// intermediate; no <stdfloat> dependency)
static inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t mant = x & 0x007fffffu;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xffu) - 127 + 15;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7c00u);  // inf
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);          // -> 0
    mant |= 0x00800000u;                                        // hidden 1
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = (mant >> shift)
        + ((mant >> (shift - 1)) & 1u);                         // round
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  half += (mant >> 12) & 1u;                                    // round
  return static_cast<uint16_t>(sign | half);
}

static inline float f16_to_f32(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t mant = h & 0x3ffu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {                        // subnormal: normalize
      int e = -1;
      do {
        ++e;
        mant <<= 1;
      } while (!(mant & 0x400u));
      x = sign | ((112u - static_cast<uint32_t>(e)) << 23)
          | ((mant & 0x3ffu) << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7f800000u | (mant << 13);
  } else {
    x = sign | ((exp + 112u) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

int64_t TieredStore::elem_bytes() const {
  switch (dtype_) {
    case StoreDtype::kF16: return 2;
    case StoreDtype::kI8: return 1;
    default: return 4;
  }
}

TieredStore::TieredStore(int64_t rows, int64_t width, StoreDtype dtype,
                         int64_t dram_rows, const std::string& spill_path)
    : rows_(rows), width_(width), dtype_(dtype), path_(spill_path) {
  // uniform layout across dtypes: per-row f32 scale first (unused for
  // f32/f16 but keeps offsets dtype-independent), then quantized lanes
  stride_ = 4 + width_ * elem_bytes();
  dram_cap_ = dram_rows < 0 ? rows_ : dram_rows;
  if (dram_cap_ > rows_) dram_cap_ = rows_;
  fd_ = ::open(path_.c_str(), O_RDWR | O_CREAT, 0644);
  if (fd_ < 0) return;
  map_len_ = static_cast<size_t>(rows_) * static_cast<size_t>(stride_);
  if (::ftruncate(fd_, static_cast<off_t>(map_len_)) != 0) {
    ::close(fd_);
    fd_ = -1;
    return;
  }
  void* m = ::mmap(nullptr, map_len_, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd_, 0);
  if (m == MAP_FAILED) {
    ::close(fd_);
    fd_ = -1;
    return;
  }
  base_ = static_cast<uint8_t*>(m);
  pool_.assign(static_cast<size_t>(dram_cap_) * stride_, 0);
  slot_row_.assign(dram_cap_, -1);
  slot_ref_.assign(dram_cap_, 0);
  row_slot_.reserve(static_cast<size_t>(dram_cap_) * 2);
}

TieredStore::~TieredStore() {
  if (base_) ::munmap(base_, map_len_);
  if (fd_ >= 0) ::close(fd_);
  if (!path_.empty()) ::unlink(path_.c_str());
}

void TieredStore::encode(const float* vals, uint8_t* dst) const {
  float scale = 0.f;
  switch (dtype_) {
    case StoreDtype::kF32:
      std::memcpy(dst, &scale, 4);
      std::memcpy(dst + 4, vals, width_ * 4);
      break;
    case StoreDtype::kF16: {
      std::memcpy(dst, &scale, 4);
      uint16_t* q = reinterpret_cast<uint16_t*>(dst + 4);
      for (int64_t k = 0; k < width_; ++k) q[k] = f32_to_f16(vals[k]);
      break;
    }
    case StoreDtype::kI8: {
      float maxabs = 0.f;
      for (int64_t k = 0; k < width_; ++k) {
        float a = std::fabs(vals[k]);
        if (a > maxabs) maxabs = a;
      }
      scale = maxabs / 127.f;
      std::memcpy(dst, &scale, 4);
      int8_t* q = reinterpret_cast<int8_t*>(dst + 4);
      if (scale == 0.f) {
        std::memset(q, 0, width_);
      } else {
        for (int64_t k = 0; k < width_; ++k) {
          float r = std::nearbyint(vals[k] / scale);
          if (r > 127.f) r = 127.f;
          if (r < -127.f) r = -127.f;
          q[k] = static_cast<int8_t>(r);
        }
      }
      break;
    }
  }
}

void TieredStore::decode(const uint8_t* src, float* out) const {
  float scale;
  std::memcpy(&scale, src, 4);
  switch (dtype_) {
    case StoreDtype::kF32:
      std::memcpy(out, src + 4, width_ * 4);
      break;
    case StoreDtype::kF16: {
      const uint16_t* q = reinterpret_cast<const uint16_t*>(src + 4);
      for (int64_t k = 0; k < width_; ++k) out[k] = f16_to_f32(q[k]);
      break;
    }
    case StoreDtype::kI8: {
      const int8_t* q = reinterpret_cast<const int8_t*>(src + 4);
      for (int64_t k = 0; k < width_; ++k) out[k] = q[k] * scale;
      break;
    }
  }
}

int64_t TieredStore::ensure_slot(int64_t r) {
  auto it = row_slot_.find(r);
  if (it != row_slot_.end()) return it->second;
  if (dram_cap_ == 0) return -1;
  // free slot first, then CLOCK second-chance eviction
  int64_t victim = -1;
  for (int64_t scanned = 0; scanned < 2 * dram_cap_; ++scanned) {
    int64_t s = hand_;
    hand_ = (hand_ + 1) % dram_cap_;
    if (slot_row_[s] < 0) {
      victim = s;
      break;
    }
    if (slot_ref_[s]) {
      slot_ref_[s] = 0;
    } else {
      victim = s;
      break;
    }
  }
  if (victim < 0) victim = hand_;     // all referenced: take the hand
  int64_t old = slot_row_[victim];
  if (old >= 0) {
    // demote: the pool copy is the authoritative one — write it down
    std::memcpy(base_ + old * stride_, pool_.data() + victim * stride_,
                stride_);
    ++st_.spill_writes;
    row_slot_.erase(old);
  }
  slot_row_[victim] = r;
  row_slot_[r] = victim;
  return victim;
}

void TieredStore::read_row(int64_t r, float* out) {
  std::lock_guard<std::mutex> l(mu_);
  if (r < 0 || r >= rows_ || !base_) {
    std::memset(out, 0, width_ * 4);
    return;
  }
  auto it = row_slot_.find(r);
  if (it != row_slot_.end()) {
    ++st_.dram_hits;
    slot_ref_[it->second] = 1;
    decode(pool_.data() + it->second * stride_, out);
    return;
  }
  ++st_.spill_hits;
  decode(base_ + r * stride_, out);
  // promote: a touched cold row moves up (CLOCK victim moves down)
  int64_t s = ensure_slot(r);
  if (s >= 0) {
    std::memcpy(pool_.data() + s * stride_, base_ + r * stride_, stride_);
    slot_ref_[s] = 1;
  }
}

void TieredStore::write_row(int64_t r, const float* vals) {
  std::lock_guard<std::mutex> l(mu_);
  if (r < 0 || r >= rows_ || !base_) return;
  int64_t s = ensure_slot(r);
  if (s >= 0) {
    encode(vals, pool_.data() + s * stride_);
    slot_ref_[s] = 1;
  } else {
    encode(vals, base_ + r * stride_);
    ++st_.spill_writes;
  }
}

TieredStore::Stats TieredStore::stats() const {
  std::lock_guard<std::mutex> l(mu_);
  Stats s = st_;
  s.dram_rows = static_cast<int64_t>(row_slot_.size());
  s.row_bytes = stride_;
  return s;
}

}  // namespace hetups
