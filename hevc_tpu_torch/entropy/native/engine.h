// Native per-CTU encode engine: mode decision + spec-exact reconstruction.
//
// Parity: this is the C++ twin of the Python decision/recon loops in
// hevc_tpu/encoder/intra_frame.py (_encode_cu) and inter_frame.py
// (_encode_cu_p) — reference TEncCu::xCompressCU (TEncCu.cpp:357),
// TEncSearch::predInterSearch (TEncSearch.cpp:2919) and
// xPatternSearchFracDIF (:4294). Integer full-pel motion comes from the
// TPU-batched search (hevc_tpu/ops/me.py); everything sequential
// (prediction from reconstructed neighbours, transforms, fractional
// refinement) runs here at native speed. The engine publishes decisions
// into the SliceEncoder's picture maps so merge/AMVP derivation stays in
// one implementation, and fills the per-CTU decision buffers the existing
// CABAC syntax writer consumes unchanged.
#pragma once
#include <atomic>
#include <cstdint>
#include <ctime>
#include <memory>
#include <mutex>
#include <vector>
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

#include "dsp.h"
#include "syntax.h"

namespace hevctpu {

// ---- The engine's trace counters ------------------------------------------
// Switched at run time (hevc_engine_trace, api.cpp) and read back by
// hevc_engine_trace_stats. While on, every thread that encodes CTUs sums
// the wall time of its encode_ctu calls (busy) into disjoint RD stages —
// the innermost open Stage owns the time, what no Stage claims goes to
// kOther — and the time it waits on the CTU row above. The sums live in
// thread-local storage and reach the frame's totals once, when the
// thread's Worker ends. Times are TSC ticks, scaled to nanoseconds per
// frame against CLOCK_MONOTONIC (Frame). Off, a scope costs one branch.
namespace trace {
enum StageId { kIntra, kMerge, kInterSearch, kResidual, kOther, kStages };
struct Sums {
  long long stage[kStages];
  long long busy, wait;
};
struct Thread {
  bool on = false;
  int cur = kOther;
  long long last = 0;
  Sums s = {};
};
extern std::atomic<bool> g_on;
extern thread_local Thread tl;
// process-wide totals (ns, and a count of traced frames), in this order
enum Total { kBusy, kWait, kThreadWall, kStage0, kFrames = kStage0 + kStages,
             kTotals };
void totals(long long* out);

inline long long ticks() {
#if defined(__x86_64__)
  return (long long)__rdtsc();
#else
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1000000000ll + t.tv_nsec;
#endif
}
inline Thread* active() {
  if (!g_on.load(std::memory_order_relaxed)) return nullptr;
  Thread& t = tl;
  return t.on ? &t : nullptr;
}

// Time from here to the end of the scope (or to the next `to`) belongs to
// the stage given, less what Stages opened inside it take.
class Stage {
 public:
  explicit Stage(int s) : t_(active()) {
    if (!t_) return;
    prev_ = t_->cur;
    if (s != prev_) go(s);
  }
  void to(int s) {
    if (t_ && s != t_->cur) go(s);
  }
  ~Stage() {
    if (t_ && t_->cur != prev_) go(prev_);
  }
  Stage(const Stage&) = delete;
  Stage& operator=(const Stage&) = delete;

 private:
  void go(int s) {
    long long now = ticks();
    t_->s.stage[t_->cur] += now - t_->last;
    t_->last = now;
    t_->cur = s;
  }
  Thread* t_;
  int prev_ = kOther;
};

// encode_ctu's scope: busy time, which the stages split exactly.
class Ctu {
 public:
  Ctu() : t_(active()) {
    if (!t_) return;
    t0_ = t_->last = ticks();
    t_->cur = kOther;
  }
  ~Ctu() {
    if (!t_) return;
    long long now = ticks();
    t_->s.stage[t_->cur] += now - t_->last;
    t_->s.busy += now - t0_;
  }

 private:
  Thread* t_;
  long long t0_ = 0;
};

// A wait on the row above, from the first failed check until it passes.
class Wait {
 public:
  Wait() : t_(active()), t0_(t_ ? ticks() : 0) {}
  ~Wait() {
    if (t_) t_->s.wait += ticks() - t0_;
  }

 private:
  Thread* t_;
  long long t0_;
};

// One engine frame call: the switch as it stood at the call's start, its
// clock, and the sum of its threads' counters, added to the process-wide
// totals when it ends.
class Frame {
 public:
  explicit Frame(int nthreads);
  ~Frame();
  bool on() const { return on_; }
  void add(const Sums& s);

 private:
  bool on_;
  int nthreads_;
  timespec w0_;
  long long t0_ = 0;
  Sums sum_ = {};
  std::mutex mu_;
};

// A thread's part of a frame: counts while it lives, hands its sums to the
// frame once at its end.
class Worker {
 public:
  explicit Worker(Frame& f) : f_(f) {
    tl = Thread();
    tl.on = f.on();
  }
  ~Worker() {
    if (tl.on) f_.add(tl.s);
    tl.on = false;
  }

 private:
  Frame& f_;
};
}  // namespace trace

struct EngineParams {
  int32_t pad;               // reference plane padding (samples)
  int32_t cu_depth_target;   // uniform CU depth (1 = 32x32)
  int32_t strong_smoothing;  // SPS strong_intra_smoothing_enabled_flag
  int32_t is_b;              // B slice (list-1 present)
  double sqrt_lam;           // sqrt(lambda) for SATD mode costs
};

// Device intra prescreen for one block size: top-k candidate modes and
// best SATD+lambda*bits screen cost per aligned block (the batched
// 35-mode predict+SATD kernel in hevc_tpu/ops/intra.py — reference
// TEncSearch::estIntraPredLumaQT's candidate list, TEncSearch.cpp:2184,
// computed for the whole frame in one launch from original-pixel
// reference samples).
struct IntraHints {
  const uint8_t* cands = nullptr;  // [ny * nx * k] modes, best first
  const int64_t* costs = nullptr;  // [ny * nx] best screen cost
  int32_t k = 0, ny = 0, nx = 0;
};

class CtuEngine {
 public:
  // ref0/ref1: per-list reference plane pointers, ref0[r * 3 + comp]
  // (reference TEncSearch predInterSearch's per-refIdx loop,
  // TEncSearch.cpp:3027). me_mvx/me_mvy: per-list-0-ref integer-MV grids
  // from the device search (me_mvx[r] is an [me_ny * me_nx] grid).
  CtuEngine(const SliceParams& sp, const EngineParams& ep,
            SliceEncoder* senc, const pel_t* orig[3], pel_t* recon[3],
            const pel_t* const* ref0, int nref0,
            const pel_t* const* ref1, int nref1,
            const int32_t* const* me_mvx, const int32_t* const* me_mvy,
            int me_nx, int me_ny,
            const int32_t* const* me16_mvx = nullptr,
            const int32_t* const* me16_mvy = nullptr, int me16_nx = 0,
            int me16_ny = 0,
            const int32_t* const* me1_mvx = nullptr,
            const int32_t* const* me1_mvy = nullptr);
  void encode_ctu(int cx, int cy, const MutCtuData& d);
  // install the device prescreen for blocks of size 1<<log2 (pointers
  // must stay alive for the engine lifetime; caller owns them)
  void set_intra_hints(int log2, const uint8_t* cands, int k,
                       const int64_t* costs, int ny, int nx);
  // install explicit (file-read) scaling matrices (reference
  // TComScalingList / TAppEncCfg "ScalingList"=2): blob is the packed
  // full-resolution table — sizes {4,8,16,32} x 6 lists
  // (intra Y/Cb/Cr, inter Y/Cb/Cr) x n*n raster coefficients, DC
  // already substituted, 8160 int32 total. Copied.
  void set_scaling(const int32_t* blob);

 private:
  // dequant matrix for a TB: explicit table when installed, else the
  // spec defaults (Table 7-5/7-6), else null (flat)
  const int32_t* scaling_matrix(int n, int c_idx, bool intra) const {
    if (!sp_.scaling_lists) return nullptr;
    if (custom_scaling_.empty())
      return dsp::default_scaling_matrix(n, intra);
    static const int off[4] = {0, 96, 480, 2016};  // cumulative 6*n*n
    int lg = 2;
    while ((1 << lg) < n) ++lg;
    return custom_scaling_.data() + off[lg - 2] +
           ((intra ? 0 : 3) + c_idx) * n * n;
  }
  std::vector<int32_t> custom_scaling_;
  // RDOQ dispatch: context-exact rdoq_quant (default) or the legacy
  // calibrated heuristic (HEVC_TPU_RDOQ=lite)
  int rdoq_run(int32_t* lev, const int32_t* coef, int n, int qp, int nz,
               int c_idx, int scan_idx, double lam, const int32_t* smat);
  // coefficients -> levels; exact RDOQ quantizes directly (no plain
  // dsp::quant pre-pass), other modes run plain quant (+rdoq_adjust)
  int quant_levels(const int32_t* coef, int n, int qp, bool intra,
                   int32_t* lev, const int32_t* smat, int c_idx,
                   int scan_idx, double lam, bool rdoq_enabled);
  ContextSet est_ctx_;   // context states for bit estimation
  bool rdoq_exact_ = true;
  double tusplit_margin_ = 0.95;  // device-cost TU-split gate (0 = off)
  double cusplit_band_ = 0.05;    // intra CU-split gate margin (0 = off)
  // decisive-split device margin. Defaults OFF (1.0): prescreen SATD
  // margins measure pre-quantization prediction gains, which the
  // quantizer discards on smooth content — the exact split trial both
  // codes better (-8.6%% bits on the synthetic intra clip, +3 dB chroma
  // on natural content) and runs faster than committing to a split
  // early. HEVC_TPU_CUSPLIT_DEC restores a decisive margin for tuning.
  double cusplit_dec_ = 1.0;
  // Shadow entropy coder: replays each committed CTU so est_ctx_ always
  // holds the TRUE CABAC states the real coding pass will have at the
  // next CTU (the reference refreshes its RDOQ estBits tables from its
  // interleaved coder; our decision pass runs ahead of entropy coding,
  // so we reproduce the states by re-coding what has been decided).
  // Only active when CTUs are processed sequentially in coding order.
  std::unique_ptr<SliceEncoder> est_enc_;
 public:
  void set_sequential(bool s) { sequential_ = s; }
 private:
  bool sequential_ = false;
  // per-CU quantization state under sub-CTU quantization groups
  // (diff_cu_qp_delta_depth > 0): samples the per-QG target map
  void set_cu_qp(int x0, int y0);
  // codes + commits one intra CU; returns its exact RD cost J =
  // pixel SSE (chroma weighted) + lambda * bits (TB rate + mode
  // signalling) — the quantity the CU-split trial compares
  double encode_cu_intra(int x0, int y0, int log2, const MutCtuData& d,
                         int ctu_x0, int ctu_y0);
  // CU-region snapshot for the exact split trial (recon, coefficient
  // and per-4x4 decision maps, mode_map); maps-side cu_depth is
  // restored by re-publishing the winner
  struct CuSnap {
    std::vector<pel_t> ry, rcb, rcr;
    std::vector<int16_t> cy, ccb, ccr;
    std::vector<int8_t> acb, acr;
    std::vector<uint8_t> m4;   // packed per-4x4 u8 decision maps + mode_map
    std::vector<int8_t> m8;    // packed per-4x4 i8 maps (ref idx)
    std::vector<int16_t> m16;  // packed per-4x4 i16 maps (mv/mvd)
    std::vector<uint8_t> pm4;  // published PicMaps u8 region
    std::vector<int8_t> pm8;   // published PicMaps i8 region
    std::vector<int16_t> pm16; // published PicMaps i16 region
  };
  void cu_take(int x0, int y0, int n, const MutCtuData& d, int ctu_x0,
               int ctu_y0, CuSnap& s) const;
  void cu_put(int x0, int y0, int n, const MutCtuData& d, int ctu_x0,
              int ctu_y0, const CuSnap& s);
  // SATD+lambda*bits screen of the best intra mode at (x0,y0,log2) from the
  // current recon state, without committing anything
  int64_t intra_screen_cost(int x0, int y0, int log2);
  // prescreen-restricted candidate mode list (all 35 without hints)
  int intra_try_list(int x0, int y0, int log2, const int cand[3],
                     int* modes_try) const;
  // recursive RD-ish intra CU decision: code at this depth or split.
  // whole_hint (>= 0): this block's screen cost already computed by the
  // parent's quadrant loop — the recon state is unchanged since, so it
  // is reused instead of recomputed.
  double intra_cu_decide(int x0, int y0, int log2, const MutCtuData& d,
                         int ctu_x0, int ctu_y0, int64_t whole_hint = -1);
  // codes + commits one inter CU (or its exact-trial split); returns
  // the committed subtree's exact J (SSE + lambda * bits)
  double encode_cu_inter(int x0, int y0, int log2, const MutCtuData& d,
                         int ctu_x0, int ctu_y0);
  // 64x64 inter decision: code the whole CTU as one CU (merge/skip or a
  // derived-MV AMVP) when its screen cost beats the four-quadrant sum;
  // returns false to fall through to the per-32x32 path
  bool ts_trial(const int32_t* resi, int qp, bool intra, double lam_sq,
                const int32_t* smat, int scan_idx, int c_idx, int32_t* lev,
                int32_t* rres, int* nz, uint8_t* rext_slot = nullptr,
                int rext_shift = 0);
  bool inter_cu64_try(int x0, int y0, const MutCtuData& d, int ctu_x0,
                      int ctu_y0);
  int64_t quad_screen_satd(int qx, int qy, int hn, int qmx, int qmy,
                           int32_t* pred);
  // availability-aware combined reference vector on a working recon plane
  void build_refs(const pel_t* plane, int pw, int ph, int stride, int x0,
                  int y0, int n, int lx0, int ly0, int sxy, int32_t* f);
  void mpm(int x0, int y0, int cand[3]) const;
  int mode_bits(int mode, const int cand[3]) const;
  void publish(int x0, int y0, int log2, bool is_intra, int skip, int mvx,
               int mvy, int ref, int mvx1, int mvy1, int ref1);
  void unpublish_rect(int x0, int y0, int w, int h);
  void publish_rect(int x0, int y0, int w, int h, const MotionInfo& mi,
                    int skip);
  int64_t lam_bits(double bits) const;

  SliceParams sp_;
  EngineParams ep_;
  SliceEncoder* senc_;
  const pel_t* orig_[3];
  pel_t* recon_[3];
  int nref_[2] = {0, 0};
  const pel_t* refs_[2][16][3] = {};
  // reference plane for (list, ref_idx, comp); out-of-range refs clamp to
  // 0 so stale map values can never read wild pointers
  const pel_t* rp(int l, int r, int c) const {
    return refs_[l][(r >= 0 && r < nref_[l]) ? r : 0][c];
  }
  // truncated-unary ref_idx bin count (spec 9.3.3.2, cMax = nref-1)
  static int ref_bits(int r, int nref) {
    return nref <= 1 ? 0 : (r + 1 < nref ? r + 1 : nref - 1);
  }
  const int32_t* me_mvx_[16] = {};
  const int32_t* me_mvy_[16] = {};
  int me_nx_ = 0, me_ny_ = 0;
  const int32_t* me16_mvx_[16] = {};
  const int32_t* me16_mvy_[16] = {};
  int me16_nx_ = 0, me16_ny_ = 0;
  // list-1 integer-MV grids (B slices; 32-grid only)
  const int32_t* me1_mvx_[16] = {};
  const int32_t* me1_mvy_[16] = {};
  // integer-pel device-search MV of list-0 ref r for an aligned block
  bool me_lookup(int x0, int y0, int n, int r, int* mvx, int* mvy) const;
  bool me1_lookup(int x0, int y0, int n, int r, int* mvx, int* mvy) const;

 public:
  // Device fractional-refine tables (ops/me_mxu _satd_box /
  // _refine_from_box): per grid block, the packed quarter-pel offset
  // (qy+3)*7+(qx+3) of the host's exact half->quarter refinement around
  // the integer MV, and the 3x3 half-pel SATD screen minimum. level:
  // 0 = list-0 32-grid, 1 = list-0 16-grid, 2 = list-1 32-grid.
  // Pointers owned by the caller, alive for the engine lifetime.
  void set_refine(int level, int ref, const int32_t* off,
                  const int32_t* half_min);

 private:
  // refined quarter-pel MV for an aligned block (device table); falls
  // back to false when no table covers (x0, y0, n, list, r)
  bool refine_lookup(int list, int x0, int y0, int n, int r, int* mvx,
                     int* mvy) const;
  // 3x3-half screen minimum for the block whose integer grid MV is
  // (qmx, qmy) quarter-pel; -1 when unavailable
  int64_t half_screen_lookup(int x0, int y0, int n, int qmx,
                             int qmy) const;
  const int32_t* rf_off_[3][16] = {};
  const int32_t* rf_half_[3][16] = {};

 public:
  // ---- reference-GPU-mode ME reproduction (cfg GPUModeME) ----
  // Computes, once per full 64x64 CTU, the flat 593-partition
  // full-search MV/SAD tables the OpenCL fork computes at the 2Nx2N
  // AMVP predictor, then serves every sub-PU integer MV from them
  // (reference TEncSearch.cpp:3743-3770, TEncOpenCL.cpp:240-362,
  // cl/sad.cl calcSAD_AMP/compareSAD; semantics modelled + documented
  // in hevc_tpu/ops/me_gpu_mode.py). Boundary CTUs (no 64x64 2Nx2N PU
  // — the reference's compute guard never fires there either) fall
  // back to the device-grid lookups.
  void gpu_mode_compute(int ctu_x0, int ctu_y0);
  // read back the current thread's tables (test introspection)
  static void gpu_tables(int list, int ref, int16_t* mvx, int16_t* mvy,
                         uint32_t* sad);

 private:
  bool gpu_lookup(int l, int r, int x0, int y0, int w, int h, int* mvx,
                  int* mvy) const;
  static thread_local int gpu_tab_x_, gpu_tab_y_;  // tables' CTU (-1 none)
  static thread_local int16_t gpu_mv_[2][16][593][2];
  static thread_local uint32_t gpu_sad_[2][16][593];
  // chroma QP: the 4:2:0 mapping table, or Min(qp, 51) otherwise
  // (spec 8.6.1 ChromaArrayType rule)
  int chroma_qp_of(int qp) const;
  IntraHints ih_[7] = {};  // indexed by log2 (2..6)
  int w_, h_, ctu_, bd_;
  int csx_ = 1;   // chroma subsampling shift (1 = 4:2:0, 0 = 4:4:4)
  // Per-CTU quantization state. One engine is shared by the wavefront
  // worker threads, so these are thread-local; encode_ctu() sets them
  // unconditionally on entry (cu_dqp makes them vary per CTU).
  static thread_local int qp_y_, qp_c_[2];
  static thread_local double sqrt_lam_;
  // inter TB level scratch: per thread for the same reason (a shared
  // buffer let one wavefront row overwrite another's levels between
  // quantization and copy-out; the CU then kept a nonzero count with
  // all-zero levels and tripped residual()'s last_pos assertion)
  static thread_local int32_t lev_tmp_[32 * 32];
  std::vector<uint8_t> mode_map_;  // per-4x4 intra mode, inter blocks -> DC
};

}  // namespace hevctpu
