// CABAC arithmetic engine + context models for the hevc_tpu native entropy
// layer. Implements the normative ITU-T H.265 algorithms directly:
//   encoder: spec 9.3.4.3 (EncodeDecision/EncodeBypass/EncodeTerminate with
//            PutBit/bitsOutstanding carry resolution)
//   decoder: spec 9.3.4.3.2 and 9.3.2.2 initialization
// Parity (behavioral, re-derived from the spec): reference
// TEncBinCoderCABAC.cpp:187 (encodeBin) / TDecBinCoderCABAC.cpp — the
// reference uses a bytewise-buffered reformulation of the same normative
// algorithm; outputs are bit-identical.
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace hevctpu {

// ---- normative tables (spec 9.3.4.3.x) -----------------------------------
extern const uint8_t kRangeTabLps[64][4];   // Table 9-46
extern const uint8_t kTransIdxLps[64];      // Table 9-47
extern const int32_t kEntropyBits[128];     // 15-bit fractional bits/state

struct ContextModel {
  uint8_t state;  // pStateIdx
  uint8_t mps;    // valMps
  // spec 9.3.2.2 context variable initialization
  void init(int qp, int init_value) {
    int slope = (init_value >> 4) * 5 - 45;
    int offset = ((init_value & 15) << 3) - 16;
    int q = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
    int pre = ((slope * q) >> 4) + offset;
    pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
    if (pre <= 63) { mps = 0; state = 63 - pre; }
    else           { mps = 1; state = pre - 64; }
  }
};

// ---- bit sink: plain RBSP bytes (emulation prevention added at NAL pack) --
class BitWriter {
 public:
  std::vector<uint8_t> bytes;
  uint32_t held = 0;
  int held_bits = 0;
  void put_bit(int b) {
    held = (held << 1) | (b & 1);
    if (++held_bits == 8) { bytes.push_back((uint8_t)held); held = 0; held_bits = 0; }
  }
  void put_bits(uint32_t v, int n) { for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1); }
  bool aligned() const { return held_bits == 0; }
  size_t bit_count() const { return bytes.size() * 8 + held_bits; }
};

// Optional bin trace for debugging against the reference decoder's
// DEBUG_CABAC_BINS output (set via hevc_set_trace()).
extern FILE* g_bin_trace;
extern long g_bin_counter;

// ---- arithmetic encoder (spec 9.3.4.3) ------------------------------------
class CabacEncoder {
 public:
  explicit CabacEncoder(BitWriter* bw) : bw_(bw) { start(); }
  void start() { low_ = 0; range_ = 510; bits_outstanding_ = 0; first_bit_ = true; }

  void encode_bin(ContextModel& ctx, int bin) {
    uint32_t start_range = range_;
    uint32_t lps = kRangeTabLps[ctx.state][(range_ >> 6) & 3];
    range_ -= lps;
    if (bin != ctx.mps) {
      low_ += range_;
      range_ = lps;
      if (ctx.state == 0) ctx.mps = 1 - ctx.mps;
      ctx.state = kTransIdxLps[ctx.state];
    } else {
      if (ctx.state < 62) ctx.state++;
    }
    renorm();
    if (g_bin_trace)
      fprintf(g_bin_trace, "%ld: coding bin value %d, range = [%u->%u]\n",
              g_bin_counter++, bin, start_range, range_);
  }

  void encode_bypass(int bin) {
    if (g_bin_trace) fprintf(g_bin_trace, "ep bin %d\n", bin);
    low_ <<= 1;
    if (bin) low_ += range_;
    if (low_ >= 1024) { put_bit(1); low_ -= 1024; }
    else if (low_ < 512) put_bit(0);
    else { low_ -= 512; bits_outstanding_++; }
  }

  void encode_bypass_bins(uint32_t pattern, int n) {
    for (int i = n - 1; i >= 0; --i) encode_bypass((pattern >> i) & 1);
  }

  // RExt CABAC bypass alignment (reference TEncBinCABAC::align): snap
  // the range to 256 so subsequent bypass bins map 1:1 onto bits
  void align() { range_ = 256; }

  void encode_terminate(int bin) {
    range_ -= 2;
    if (bin) { low_ += range_; flush(); }
    else renorm();
  }

  // EncodeFlush (9.3.4.3.5): called by encode_terminate(1) at slice end.
  // The spec's final `((low >> 7) & 3) | 1` forces its last bit to 1 —
  // that bit IS the rbsp_stop_one_bit, which the syntax layer writes via
  // finish_rbsp(); emitting it here too would shift the stop pattern
  // (verified byte-exact against the reference engine).
  void flush() {
    range_ = 2;
    renorm();
    put_bit((low_ >> 9) & 1);
    put_bit((low_ >> 8) & 1);
  }

 private:
  void renorm() {
    while (range_ < 256) {
      if (low_ >= 512) { put_bit(1); low_ -= 512; }
      else if (low_ < 256) put_bit(0);
      else { low_ -= 256; bits_outstanding_++; }
      range_ <<= 1;
      low_ <<= 1;
    }
  }
  void put_bit(int b) {
    if (first_bit_) first_bit_ = false;
    else bw_->put_bit(b);
    while (bits_outstanding_ > 0) { bw_->put_bit(1 - b); bits_outstanding_--; }
  }
  BitWriter* bw_;
  uint32_t low_, range_;
  int bits_outstanding_;
  bool first_bit_;
};

// ---- bit source -----------------------------------------------------------
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  int read_bit() {
    if (pos_ >= size_ * 8) return 0;  // past-end: zeros (spec-tolerant)
    int b = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    pos_++;
    return b;
  }
  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }
  size_t pos_ = 0;
  const uint8_t* data_;
  size_t size_;
};

// ---- arithmetic decoder (spec 9.3.4.3.2) ----------------------------------
class CabacDecoder {
 public:
  explicit CabacDecoder(BitReader* br) : br_(br) {
    range_ = 510;
    offset_ = br_->read_bits(9);
  }
  int decode_bin(ContextModel& ctx) {
    uint32_t start_range = range_;
    uint32_t lps = kRangeTabLps[ctx.state][(range_ >> 6) & 3];
    range_ -= lps;
    int bin;
    if (offset_ >= range_) {
      bin = 1 - ctx.mps;
      offset_ -= range_;
      range_ = lps;
      if (ctx.state == 0) ctx.mps = 1 - ctx.mps;
      ctx.state = kTransIdxLps[ctx.state];
    } else {
      bin = ctx.mps;
      if (ctx.state < 62) ctx.state++;
    }
    while (range_ < 256) { range_ <<= 1; offset_ = (offset_ << 1) | br_->read_bit(); }
    if (g_bin_trace)
      fprintf(g_bin_trace, "%ld: coding bin value %d, range = [%u->%u]\n",
              g_bin_counter++, bin, start_range, range_);
    return bin;
  }
  int decode_bypass() {
    offset_ = (offset_ << 1) | br_->read_bit();
    if (offset_ >= range_) { offset_ -= range_; return 1; }
    return 0;
  }
  // cabac_bypass_alignment (spec 9.3.4.3.4, high-throughput RExt):
  // ivlCurrRange is forced to 256 so subsequent bypass bins read raw
  // bits (the aligned-bypass fast path)
  void align() { range_ = 256; }
  uint32_t decode_bypass_bins(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | decode_bypass();
    return v;
  }
  int decode_terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    while (range_ < 256) { range_ <<= 1; offset_ = (offset_ << 1) | br_->read_bit(); }
    return 0;
  }
  // WPP: re-initialize at a byte-aligned substream boundary (spec 9.3.1)
  void restart_at(size_t byte_pos) {
    br_->pos_ = byte_pos * 8;
    range_ = 510;
    offset_ = br_->read_bits(9);
  }
  // I_PCM (spec 7.3.8.7 / 9.3.1): after decode_terminate()==1 on
  // pcm_flag this reader sits exactly one bit past the stop bit; skip
  // the alignment zeros, read raw sample codes, then re-init.
  void align_to_byte() { br_->pos_ = (br_->pos_ + 7) & ~(size_t)7; }
  uint32_t read_raw(int n) { return br_->read_bits(n); }
  void restart_here() {
    range_ = 510;
    offset_ = br_->read_bits(9);
  }

 private:
  BitReader* br_;
  uint32_t range_, offset_;
};

}  // namespace hevctpu
