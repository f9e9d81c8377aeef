// Hierarchical row storage for one PS table: a bounded DRAM slot pool
// in front of an mmap'd sparse disk file (the cold tier), with optional
// fp16/int8 row quantization (per-row maxabs scale, dequant-on-read).
//
// ROADMAP item 2's capacity tier: a table whose quantized bytes exceed
// the configured DRAM budget still trains — cold rows live only in the
// spill file, hot rows are promoted into DRAM on access (CLOCK
// eviction writes the victim down). The reference's trillion-parameter
// claim needs exactly this shape: HBM device cache (ps/device_cache.py)
// -> host DRAM (this pool) -> disk (the mmap'd file).
//
// Thread safety: every public method takes the internal mutex; callers
// additionally hold the owning Tensor's lock, so the mutex only guards
// against concurrent access through two different Tensor ops.
#pragma once

#include <cstdint>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace hetups {

enum class StoreDtype : int32_t { kF32 = 0, kF16 = 1, kI8 = 2 };

class TieredStore {
 public:
  // ``spill_path`` is created sparse at rows * stride bytes; only
  // pages actually written consume disk.
  TieredStore(int64_t rows, int64_t width, StoreDtype dtype,
              int64_t dram_rows, const std::string& spill_path);
  ~TieredStore();

  bool ok() const { return base_ != nullptr; }

  // dequantize row ``r`` into out[width]; promotes a spilled row into
  // the DRAM pool (hot rows migrate up under a skewed id stream)
  void read_row(int64_t r, float* out);
  // quantize + store row ``r`` (DRAM if resident or a slot is free /
  // evictable, else straight to the spill file)
  void write_row(int64_t r, const float* vals);

  int64_t rows() const { return rows_; }
  int64_t width() const { return width_; }
  // quantized bytes per row including the per-row scale
  int64_t row_bytes() const { return stride_; }
  StoreDtype dtype() const { return dtype_; }

  struct Stats {
    uint64_t dram_hits = 0;
    uint64_t spill_hits = 0;
    uint64_t spill_writes = 0;
    int64_t dram_rows = 0;   // resident now
    int64_t row_bytes = 0;
  };
  Stats stats() const;

 private:
  int64_t elem_bytes() const;
  void encode(const float* vals, uint8_t* dst) const;
  void decode(const uint8_t* src, float* out) const;
  // returns the DRAM slot for ``r``, evicting a CLOCK victim to the
  // spill file if the pool is full; -1 when the pool has zero slots
  int64_t ensure_slot(int64_t r);

  int64_t rows_;
  int64_t width_;
  StoreDtype dtype_;
  int64_t stride_;                    // quantized row + f32 scale
  int64_t dram_cap_;                  // max resident rows

  // cold tier: mmap'd sparse file, offset r * stride_
  int fd_ = -1;
  uint8_t* base_ = nullptr;
  size_t map_len_ = 0;
  std::string path_;

  // hot tier: slot pool + CLOCK hand
  std::vector<uint8_t> pool_;         // dram_cap_ * stride_
  std::vector<int64_t> slot_row_;     // slot -> row (-1 free)
  std::vector<uint8_t> slot_ref_;     // CLOCK reference bits
  std::unordered_map<int64_t, int64_t> row_slot_;  // row -> slot
  int64_t hand_ = 0;

  mutable std::mutex mu_;
  mutable Stats st_;
};

}  // namespace hetups
