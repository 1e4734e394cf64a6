// C ABI for the hevc_tpu native entropy layer (loaded via ctypes).
#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "dsp.h"
#include "engine.h"
#include "syntax.h"

using namespace hevctpu;

namespace hevctpu {
FILE* g_bin_trace = nullptr;
long g_bin_counter = 0;
}

extern "C" {

void hevc_set_trace(const char* path) {
  if (hevctpu::g_bin_trace) fclose(hevctpu::g_bin_trace);
  hevctpu::g_bin_trace = path ? fopen(path, "w") : nullptr;
  hevctpu::g_bin_counter = 0;
}

void hevc_trace_note(const char* s) {
  if (hevctpu::g_bin_trace) fprintf(hevctpu::g_bin_trace, "# %s\n", s);
}

// sample-type width of this build (16 = default, 32 = -DHEVC_PEL32 high-
// bit-depth build); the Python loader asserts it matches the dtype it
// will pass (reference dual-build: make all vs make all_highbitdepth)
int hevc_pel_bits() { return (int)sizeof(hevctpu::pel_t) * 8; }

// exact integer SSE between two sample planes (PSNR support: the
// float64 BLAS-dot path costs ~200 ms/frame at 1080p on slow hosts;
// this int64 accumulation vectorizes with the host ISA)
long long hevc_plane_sse(const pel_t* a, const pel_t* b, long n) {
  long long s = 0;
  for (long i = 0; i < n; ++i) {
    int d = (int)a[i] - (int)b[i];
    s += (long long)d * d;
  }
  return s;
}

// Edge-replicated reference-plane padding (reference TComPicYuv margin
// extension, TComPicYuv.cpp extendPicBorder). memcpy-based rows: the
// numpy broadcast pad this replaces cost ~12 ms per 1080p plane on
// single-vCPU hosts; this runs at copy bandwidth (~1 ms).
void hevc_pad_plane(const pel_t* src, int h, int w, int pad, pel_t* dst) {
  const int W = w + 2 * pad;
  for (int i = 0; i < h; ++i) {
    pel_t* row = dst + (long)(pad + i) * W;
    std::memcpy(row + pad, src + (long)i * w, sizeof(pel_t) * w);
    const pel_t l = row[pad], r = row[pad + w - 1];
    for (int j = 0; j < pad; ++j) {
      row[j] = l;
      row[pad + w + j] = r;
    }
  }
  const pel_t* top = dst + (long)pad * W;
  const pel_t* bot = dst + (long)(pad + h - 1) * W;
  for (int i = 0; i < pad; ++i) {
    std::memcpy(dst + (long)i * W, top, sizeof(pel_t) * W);
    std::memcpy(dst + (long)(pad + h + i) * W, bot, sizeof(pel_t) * W);
  }
}

// The engine's trace counters (engine.h, namespace trace): switched on or
// off for the frame calls that start after this call.
void hevc_engine_trace(int on) { hevctpu::trace::g_on.store(on != 0); }

// Their process-wide totals, trace::kTotals of them in trace::Total order:
// ns of busy, wait, threads x wall, intra, merge, inter search, residual,
// other; then the number of traced frame calls.
int hevc_engine_trace_stats(long long* out, int n) {
  if (n < hevctpu::trace::kTotals) return -1;
  hevctpu::trace::totals(out);
  return hevctpu::trace::kTotals;
}

// Always-on frame-drive telemetry: wall vs process-CPU ns accumulated per
// hevc_engine_frame[_order] call (two clock_gettime pairs per frame —
// negligible). Lets the benchmark artifact separate real engine compute
// from scheduler starvation / wavefront coordination on shared hosts.
namespace {
std::atomic<long long> g_frame_wall_ns{0}, g_frame_cpu_ns{0};
struct FrameClock {
  timespec w0, c0;
  FrameClock() {
    clock_gettime(CLOCK_MONOTONIC, &w0);
    clock_gettime(CLOCK_PROCESS_CPUTIME_ID, &c0);
  }
  ~FrameClock() {
    timespec w1, c1;
    clock_gettime(CLOCK_MONOTONIC, &w1);
    clock_gettime(CLOCK_PROCESS_CPUTIME_ID, &c1);
    g_frame_wall_ns += (w1.tv_sec - w0.tv_sec) * 1000000000ll +
                       (w1.tv_nsec - w0.tv_nsec);
    g_frame_cpu_ns += (c1.tv_sec - c0.tv_sec) * 1000000000ll +
                      (c1.tv_nsec - c0.tv_nsec);
  }
};
}  // namespace
void hevc_engine_frame_stats(long long* wall_cpu_ns) {
  wall_cpu_ns[0] = g_frame_wall_ns.load();
  wall_cpu_ns[1] = g_frame_cpu_ns.load();
}


// ---- slice-data encoder ----------------------------------------------------
void* hevc_enc_create(const SliceParams* sp) { return new SliceEncoder(*sp); }
void hevc_enc_destroy(void* h) { delete (SliceEncoder*)h; }
void hevc_enc_begin_slice(void* h) { ((SliceEncoder*)h)->begin_slice(); }

void hevc_enc_ctu(void* h, int ctu_x, int ctu_y,
                  const uint8_t* cu_depth, const uint8_t* nxn_flag,
                  const uint8_t* luma_mode, const uint8_t* chroma_mode,
                  const uint8_t* tu_depth, const int16_t* coeff_y,
                  const int16_t* coeff_cb, const int16_t* coeff_cr,
                  const uint8_t* pred_mode, const uint8_t* skip_flag,
                  const uint8_t* merge_flag, const uint8_t* merge_idx,
                  const uint8_t* mvp_flag, const int8_t* ref_idx,
                  const int16_t* mvd_x, const int16_t* mvd_y,
                  const int16_t* mv_x, const int16_t* mv_y,
                  const uint8_t* mvp_flag1, const int8_t* ref_idx1,
                  const int16_t* mvd_x1, const int16_t* mvd_y1,
                  const int16_t* mv_x1, const int16_t* mv_y1,
                  const int32_t* sao, const uint8_t* rext,
                  int end_of_slice) {
  CtuData d{cu_depth, nxn_flag, luma_mode, chroma_mode, tu_depth,
            coeff_y, coeff_cb, coeff_cr, pred_mode, skip_flag, merge_flag,
            merge_idx, mvp_flag, ref_idx, mvd_x, mvd_y, mv_x, mv_y,
            mvp_flag1, ref_idx1, mvd_x1, mvd_y1, mv_x1, mv_y1, sao,
            rext, nullptr, nullptr};
  ((SliceEncoder*)h)->encode_ctu(ctu_x, ctu_y, d, end_of_slice);
}

// Incremental publication of one decided CU's motion into the encoder's
// picture maps, so Python can query merge/AMVP candidates for subsequent
// CUs from the single native derivation implementation.
void hevc_enc_publish_cu(void* h, int x0, int y0, int log2, int is_intra,
                         int skip, int mv_x, int mv_y, int ref_idx,
                         int mv_x1, int mv_y1, int ref_idx1) {
  PicMaps& m = ((SliceEncoder*)h)->maps();
  int b = 1 << (log2 - 2);
  for (int yy = 0; yy < b; ++yy)
    for (int xx = 0; xx < b; ++xx) {
      size_t pi = (size_t)((y0 >> 2) + yy) * m.stride + (x0 >> 2) + xx;
      m.pred_mode[pi] = is_intra ? 1 : 0;
      m.skip_flag[pi] = skip;
      m.mv_x[0][pi] = (int16_t)mv_x;
      m.mv_y[0][pi] = (int16_t)mv_y;
      m.ref_idx[0][pi] = (int8_t)(is_intra ? -1 : ref_idx);
      m.mv_x[1][pi] = (int16_t)mv_x1;
      m.mv_y[1][pi] = (int16_t)mv_y1;
      m.ref_idx[1][pi] = (int8_t)(is_intra ? -1 : ref_idx1);
      m.cu_depth[pi] = (uint8_t)(m.sp.max_cb_log2 - log2);
    }
}

int hevc_enc_merge_cands(void* h, int x0, int y0, int size,
                         int16_t* out_mv /*5*4: l0x,l0y,l1x,l1y*/,
                         int8_t* out_ref /*5*2*/) {
  MotionInfo c[5];
  int n = ((SliceEncoder*)h)->maps().merge_candidates(x0, y0, size, size, c);
  for (int i = 0; i < n; ++i) {
    out_mv[4 * i] = c[i].mvx[0];
    out_mv[4 * i + 1] = c[i].mvy[0];
    out_mv[4 * i + 2] = c[i].mvx[1];
    out_mv[4 * i + 3] = c[i].mvy[1];
    out_ref[2 * i] = c[i].ref[0];
    out_ref[2 * i + 1] = c[i].ref[1];
  }
  return n;
}

void hevc_enc_amvp(void* h, int x0, int y0, int size, int list, int ref,
                   int16_t* out_mv /*2*2*/) {
  ((SliceEncoder*)h)->maps().amvp_candidates(x0, y0, size, size, list, ref,
                                             out_mv);
}

// WPP: per-row substream byte sizes (valid after finish); returns count.
int hevc_enc_substreams(void* h, int32_t* out, int cap) {
  const std::vector<int32_t>& v = ((SliceEncoder*)h)->substream_sizes();
  int n = (int)v.size();
  for (int i = 0; i < n && i < cap; ++i) out[i] = v[i];
  return n;
}

void hevc_enc_set_col(void* h, const int16_t* mx0, const int16_t* my0,
                      const int32_t* rp0, const int16_t* mx1,
                      const int16_t* my1, const int32_t* rp1, int stride,
                      int rows, int poc) {
  ((SliceEncoder*)h)->maps().set_col(mx0, my0, rp0, mx1, my1, rp1, stride,
                                     rows, poc);
}

void* hevc_dec_maps(void* h);  // fwd

void hevc_dec_set_col(void* h, const int16_t* mx0, const int16_t* my0,
                      const int32_t* rp0, const int16_t* mx1,
                      const int16_t* my1, const int32_t* rp1, int stride,
                      int rows, int poc) {
  ((SliceDecoder*)h)->maps().set_col(mx0, my0, rp0, mx1, my1, rp1, stride,
                                     rows, poc);
}

void hevc_dec_set_entry(void* h, const int32_t* off, int n) {
  ((SliceDecoder*)h)->set_entry_points(off, n);
}

// Returns the finished slice-data RBSP (with rbsp trailing bits) length;
// copies into `out` if non-null.
long hevc_enc_get(void* h, uint8_t* out, long cap) {
  const std::vector<uint8_t>& b = ((SliceEncoder*)h)->finish_rbsp();
  if (out && (long)b.size() <= cap) std::memcpy(out, b.data(), b.size());
  return (long)b.size();
}
// flushed-payload byte count so far (dependent-segment byte budgeting)
long hevc_enc_pos(void* h) {
  return (long)((SliceEncoder*)h)->bytes().size();
}
// deferred end_of_slice_segment_flag (paired with encode_ctu(..., -1))
void hevc_enc_end_flag(void* h, int flag) {
  ((SliceEncoder*)h)->write_end_flag(flag);
}
// close a dependent slice segment: align, restart the engine with the
// context models retained; returns the segment boundary byte offset
long hevc_enc_segment_cut(void* h) {
  return (long)((SliceEncoder*)h)->segment_cut();
}

// ---- slice-data decoder ----------------------------------------------------
void* hevc_dec_create(const SliceParams* sp, const uint8_t* data, long size) {
  return new SliceDecoder(*sp, data, (size_t)size);
}
void hevc_dec_destroy(void* h) { delete (SliceDecoder*)h; }
// dependent slice segment: continue an open decoder on new segment data
void hevc_dec_reseat(void* h, const uint8_t* data, long size) {
  ((SliceDecoder*)h)->reseat(data, (size_t)size);
}
// per-syntax-element bit statistics (reference TComCodingStatistics /
// RExt__DECODER_DEBUG_BIT_STATISTICS analyser output)
void hevc_dec_enable_stats(void* h) { ((SliceDecoder*)h)->enable_stats(); }
long hevc_dec_stat_bits(void* h, uint64_t* out) {
  const uint64_t* b = ((SliceDecoder*)h)->stat_bits();
  for (int i = 0; i < ST_N; ++i) out[i] = b[i];
  return ST_N;
}

int hevc_dec_ctu(void* h, int ctu_x, int ctu_y, uint8_t* cu_depth,
                 uint8_t* nxn_flag, uint8_t* luma_mode, uint8_t* chroma_mode,
                 uint8_t* tu_depth, int16_t* coeff_y, int16_t* coeff_cb,
                 int16_t* coeff_cr, uint8_t* pred_mode, uint8_t* skip_flag,
                 uint8_t* merge_flag, uint8_t* merge_idx, uint8_t* mvp_flag,
                 int8_t* ref_idx, int16_t* mvd_x, int16_t* mvd_y,
                 int16_t* mv_x, int16_t* mv_y, uint8_t* mvp_flag1,
                 int8_t* ref_idx1, int16_t* mvd_x1, int16_t* mvd_y1,
                 int16_t* mv_x1, int16_t* mv_y1, int32_t* sao,
                 uint8_t* rext, int8_t* ccp_cb, int8_t* ccp_cr) {
  MutCtuData d{cu_depth, nxn_flag, luma_mode, chroma_mode, tu_depth,
               coeff_y, coeff_cb, coeff_cr, pred_mode, skip_flag, merge_flag,
               merge_idx, mvp_flag, ref_idx, mvd_x, mvd_y, mv_x, mv_y,
               mvp_flag1, ref_idx1, mvd_x1, mvd_y1, mv_x1, mv_y1, sao,
               rext, ccp_cb, ccp_cr};
  return ((SliceDecoder*)h)->decode_ctu(ctu_x, ctu_y, d);
}

}  // extern "C"

// ---- native CU engine ------------------------------------------------------

extern "C" {

// ref0/ref1: flattened per-list reference plane pointer arrays
// (ref0[r * 3 + comp], nref0 references); me grids are per-list-0-ref
// pointer arrays ([nref0] each an [me_ny * me_nx] int32 grid, or null).
void* hevc_engine_create(const SliceParams* sp, const EngineParams* ep,
                         void* senc,
                         const pel_t* oy, const pel_t* ocb,
                         const pel_t* ocr, pel_t* ry, pel_t* rcb,
                         pel_t* rcr,
                         const pel_t* const* ref0, int nref0,
                         const pel_t* const* ref1, int nref1,
                         const int32_t* const* me_mvx,
                         const int32_t* const* me_mvy, int me_nx, int me_ny,
                         const int32_t* const* me16_mvx,
                         const int32_t* const* me16_mvy, int me16_nx,
                         int me16_ny,
                         const int32_t* const* me1_mvx,
                         const int32_t* const* me1_mvy) {
  const pel_t* orig[3] = {oy, ocb, ocr};
  pel_t* recon[3] = {ry, rcb, rcr};
  return new CtuEngine(*sp, *ep, (SliceEncoder*)senc, orig, recon, ref0,
                       nref0, ref1, nref1, me_mvx, me_mvy, me_nx, me_ny,
                       me16_mvx, me16_mvy, me16_nx, me16_ny, me1_mvx,
                       me1_mvy);
}

void hevc_engine_destroy(void* h) { delete (CtuEngine*)h; }

// device intra prescreen (top-k candidate modes + screen costs) for
// blocks of size 1<<log2; buffers owned by the caller, alive for the
// engine lifetime
// explicit (file-read) scaling matrices: packed {4,8,16,32} x 6 lists
// x n*n full-resolution table, 8160 int32 (see CtuEngine::set_scaling)
void hevc_engine_set_scaling(void* h, const int32_t* blob) {
  ((CtuEngine*)h)->set_scaling(blob);
}

void hevc_engine_set_intra_hints(void* h, int log2, const uint8_t* cands,
                                 int k, const int64_t* costs, int ny,
                                 int nx) {
  ((CtuEngine*)h)->set_intra_hints(log2, cands, k, costs, ny, nx);
}

// device fractional-refine tables (level 0/1/2 = l0-32/l0-16/l1-32;
// see CtuEngine::set_refine)
void hevc_engine_set_refine(void* h, int level, int ref,
                            const int32_t* off, const int32_t* half_min) {
  ((CtuEngine*)h)->set_refine(level, ref, off, half_min);
}

// reference-GPU-mode ME table readback (this thread's last computed CTU;
// test introspection — tests/test_me_gpu_mode.py compares against the
// Python scalar model of TEncOpenCL/cl-sad semantics)
void hevc_engine_gpu_tables(int list, int ref, int16_t* mvx, int16_t* mvy,
                            uint32_t* sad) {
  CtuEngine::gpu_tables(list, ref, mvx, mvy, sad);
}

void hevc_engine_ctu(void* h, int cx, int cy, uint8_t* cu_depth,
                     uint8_t* nxn_flag, uint8_t* luma_mode,
                     uint8_t* chroma_mode, uint8_t* tu_depth,
                     int16_t* coeff_y, int16_t* coeff_cb, int16_t* coeff_cr,
                     uint8_t* pred_mode, uint8_t* skip_flag,
                     uint8_t* merge_flag, uint8_t* merge_idx,
                     uint8_t* mvp_flag, int8_t* ref_idx, int16_t* mvd_x,
                     int16_t* mvd_y, int16_t* mv_x, int16_t* mv_y,
                     uint8_t* mvp_flag1, int8_t* ref_idx1, int16_t* mvd_x1,
                     int16_t* mvd_y1, int16_t* mv_x1, int16_t* mv_y1,
                     int32_t* sao) {
  MutCtuData d{cu_depth, nxn_flag, luma_mode, chroma_mode, tu_depth,
               coeff_y, coeff_cb, coeff_cr, pred_mode, skip_flag, merge_flag,
               merge_idx, mvp_flag, ref_idx, mvd_x, mvd_y, mv_x, mv_y,
               mvp_flag1, ref_idx1, mvd_x1, mvd_y1, mv_x1, mv_y1, sao,
            nullptr, nullptr, nullptr};
  ((CtuEngine*)h)->encode_ctu(cx, cy, d);
}

}  // extern "C"

// ---- whole-frame drivers (stacked per-CTU buffers, one call per frame) ----
namespace {
struct StackedMaps {
  uint8_t *cu_depth, *nxn_flag, *luma_mode, *chroma_mode, *tu_depth;
  int16_t *coeff_y, *coeff_cb, *coeff_cr;
  uint8_t *pred_mode, *skip_flag, *merge_flag, *merge_idx, *mvp_flag;
  int8_t* ref_idx;
  int16_t *mvd_x, *mvd_y, *mv_x, *mv_y;
  uint8_t* mvp_flag1;
  int8_t* ref_idx1;
  int16_t *mvd_x1, *mvd_y1, *mv_x1, *mv_y1;
  int32_t* sao;
  uint8_t* rext;
  int8_t *ccp_cb, *ccp_cr;
  int ctu, cfmt;
  MutCtuData at(size_t i) const {
    size_t m = (size_t)(ctu / 4) * (ctu / 4);
    size_t cy = (size_t)ctu * ctu;
    // 4:2:0 quarter-size, 4:2:2 half-size (horizontal subsampling only),
    // 4:4:4 full-size chroma planes
    size_t cc = cfmt == 3 ? cy : (cfmt == 2 ? cy / 2 : cy / 4);
    return MutCtuData{
        cu_depth + i * m, nxn_flag + i * m, luma_mode + i * m,
        chroma_mode + i * m, tu_depth + i * m, coeff_y + i * cy,
        coeff_cb + i * cc, coeff_cr + i * cc, pred_mode + i * m,
        skip_flag + i * m, merge_flag + i * m, merge_idx + i * m,
        mvp_flag + i * m, ref_idx + i * m, mvd_x + i * m, mvd_y + i * m,
        mv_x + i * m, mv_y + i * m, mvp_flag1 + i * m, ref_idx1 + i * m,
        mvd_x1 + i * m, mvd_y1 + i * m, mv_x1 + i * m, mv_y1 + i * m,
        sao + i * 20, rext ? rext + i * m : nullptr,
        ccp_cb ? ccp_cb + i * m : nullptr,
        ccp_cr ? ccp_cr + i * m : nullptr};
  }
};
}  // namespace

#define STACKED_ARGS                                                        \
  uint8_t *cu_depth, uint8_t *nxn_flag, uint8_t *luma_mode,                 \
      uint8_t *chroma_mode, uint8_t *tu_depth, int16_t *coeff_y,            \
      int16_t *coeff_cb, int16_t *coeff_cr, uint8_t *pred_mode,             \
      uint8_t *skip_flag, uint8_t *merge_flag, uint8_t *merge_idx,          \
      uint8_t *mvp_flag, int8_t *ref_idx, int16_t *mvd_x, int16_t *mvd_y,   \
      int16_t *mv_x, int16_t *mv_y, uint8_t *mvp_flag1, int8_t *ref_idx1,   \
      int16_t *mvd_x1, int16_t *mvd_y1, int16_t *mv_x1, int16_t *mv_y1,     \
      int32_t *sao, uint8_t *rext, int8_t *ccp_cb, int8_t *ccp_cr

#define STACKED_INIT(CTU, CFMT)                                             \
  StackedMaps sm{cu_depth, nxn_flag, luma_mode, chroma_mode, tu_depth,      \
                 coeff_y, coeff_cb, coeff_cr, pred_mode, skip_flag,         \
                 merge_flag, merge_idx, mvp_flag, ref_idx, mvd_x, mvd_y,    \
                 mv_x, mv_y, mvp_flag1, ref_idx1, mvd_x1, mvd_y1, mv_x1,    \
                 mv_y1, sao, rext, ccp_cb, ccp_cr, CTU, CFMT}

// Wavefront-parallel frame drive: CTU (x, y) may start once row y-1 has
// finished CTU x+1 (its decisions/recon cover the left, above and
// above-right neighbourhood every tool reads). Decisions and recon writes
// land in disjoint regions, so the lag-2 wavefront is race-free — the
// same dependency structure the reference exploits for WPP
// (TEncSlice.cpp:744). Thread count from HEVC_TPU_THREADS (default:
// hardware concurrency, capped by row count).
extern "C" void hevc_engine_frame(void* eng, int ctus_w, int ctus_h,
                                  int ctu_size, int cfmt, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  FrameClock _fc;
  int nthreads = 0;
  bool explicit_threads = false;
  if (const char* e = getenv("HEVC_TPU_THREADS")) {
    nthreads = atoi(e);
    explicit_threads = nthreads > 0;
  }
  if (nthreads <= 0)
    nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, ctus_h));
  // Auto mode only: small frames don't amortize thread spawn + wavefront
  // coordination (a 416x240 frame is 4 CTU rows — the lag-2 ramp leaves
  // ~2x usable parallelism at best), and the sequential path's exact
  // shadow-context RD estimates are worth more there. An explicit
  // HEVC_TPU_THREADS is always honoured (tests and tuning rely on it).
  bool wavefront = !(nthreads == 1 || ctus_h == 1 ||
                     (!explicit_threads && ctus_h < 6));
  hevctpu::trace::Frame trace_frame(wavefront ? nthreads : 1);
  if (!wavefront) {
    hevctpu::trace::Worker tw(trace_frame);
    ((CtuEngine*)eng)->set_sequential(true);
    for (int cy = 0; cy < ctus_h; ++cy)
      for (int cx = 0; cx < ctus_w; ++cx)
        ((CtuEngine*)eng)->encode_ctu(cx, cy,
                                      sm.at((size_t)cy * ctus_w + cx));
    return;
  }
  std::vector<std::atomic<int>> done(ctus_h);  // CTUs finished per row
  for (auto& a : done) a.store(0);
  std::atomic<int> next_row{0};
  auto worker = [&]() {
    hevctpu::trace::Worker tw(trace_frame);
    for (;;) {
      int cy = next_row.fetch_add(1);
      if (cy >= ctus_h) return;
      for (int cx = 0; cx < ctus_w; ++cx) {
        if (cy > 0) {
          int need = std::min(cx + 2, ctus_w);
          int got = done[cy - 1].load(std::memory_order_acquire);
          if (got < need) {
            hevctpu::trace::Wait tw_wait;
            // bounded spin, then futex sleep (atomic::wait) — yield-spin
            // burns a vCPU and degrades badly on oversubscribed hosts
            int spins = 0;
            while (got < need) {
              if (++spins < 64) {
                std::this_thread::yield();
              } else {
                done[cy - 1].wait(got, std::memory_order_acquire);
              }
              got = done[cy - 1].load(std::memory_order_acquire);
            }
          }
        }
        ((CtuEngine*)eng)->encode_ctu(cx, cy,
                                      sm.at((size_t)cy * ctus_w + cx));
        done[cy].store(cx + 1, std::memory_order_release);
        done[cy].notify_all();
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// tile-scan (or any explicit) CTU order variants: the stacked buffers
// stay raster-indexed; `cxs/cys` give the processing sequence
extern "C" void hevc_engine_frame_order(void* eng, int nctu, const int32_t* cxs,
                             const int32_t* cys, int ctus_w, int ctu_size,
                             int cfmt, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  FrameClock _fc;
  hevctpu::trace::Frame trace_frame(1);
  hevctpu::trace::Worker tw(trace_frame);
  ((CtuEngine*)eng)->set_sequential(true);
  for (int i = 0; i < nctu; ++i)
    ((CtuEngine*)eng)->encode_ctu(cxs[i], cys[i],
                                  sm.at((size_t)cys[i] * ctus_w + cxs[i]));
}

extern "C" void hevc_enc_frame_order(void* senc, int nctu, const int32_t* cxs,
                          const int32_t* cys, int ctus_w, int ctu_size,
                          int cfmt, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  for (int i = 0; i < nctu; ++i) {
    MutCtuData md = sm.at((size_t)cys[i] * ctus_w + cxs[i]);
    CtuData d{md.cu_depth, md.nxn_flag, md.luma_mode, md.chroma_mode,
              md.tu_depth, md.coeff_y, md.coeff_cb, md.coeff_cr,
              md.pred_mode, md.skip_flag, md.merge_flag, md.merge_idx,
              md.mvp_flag, md.ref_idx, md.mvd_x, md.mvd_y, md.mv_x,
              md.mv_y, md.mvp_flag1, md.ref_idx1, md.mvd_x1, md.mvd_y1,
              md.mv_x1, md.mv_y1, md.sao, md.rext, md.ccp_cb, md.ccp_cr};
    ((SliceEncoder*)senc)->encode_ctu(cxs[i], cys[i], d, i == nctu - 1);
  }
}

// SliceMode 2 (reference TEncSlice::compressSlice slice-byte-limit
// termination): code CTUs in order until the flushed slice payload
// reaches `byte_budget` after a CTU — that CTU becomes the last one of
// the slice (the budget is a soft bound: the crossing CTU is included,
// as in the reference). Returns the number of CTUs coded.
extern "C" long hevc_enc_frame_order_budget(
    void* senc, int nctu, const int32_t* cxs, const int32_t* cys,
    int ctus_w, int ctu_size, int cfmt, long byte_budget, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  SliceEncoder* e = (SliceEncoder*)senc;
  long coded = 0;
  for (int i = 0; i < nctu; ++i) {
    MutCtuData md = sm.at((size_t)cys[i] * ctus_w + cxs[i]);
    CtuData d{md.cu_depth, md.nxn_flag, md.luma_mode, md.chroma_mode,
              md.tu_depth, md.coeff_y, md.coeff_cb, md.coeff_cr,
              md.pred_mode, md.skip_flag, md.merge_flag, md.merge_idx,
              md.mvp_flag, md.ref_idx, md.mvd_x, md.mvd_y, md.mv_x,
              md.mv_y, md.mvp_flag1, md.ref_idx1, md.mvd_x1, md.mvd_y1,
              md.mv_x1, md.mv_y1, md.sao, md.rext, md.ccp_cb, md.ccp_cr};
    e->encode_ctu(cxs[i], cys[i], d, -1);
    ++coded;
    int last = (i == nctu - 1) ||
               ((long)e->bytes().size() >= byte_budget);
    e->write_end_flag(last);
    if (last) break;
  }
  return coded;
}

// Dependent slice segments (SliceSegmentMode 1: max CTUs per segment,
// 2: max bytes per segment — reference TAppEncCfg.cpp:852): encode the
// whole slice in one pass, terminating and cutting a segment whenever
// the limit trips; the CABAC contexts continue across segments. Fills
// seg_ctus[] (CTUs per segment) and seg_marks[] (cumulative payload
// byte offset at each cut; the final segment ends at finish_rbsp).
// Returns the segment count.
extern "C" long hevc_enc_frame_order_segments(
    void* senc, int nctu, const int32_t* cxs, const int32_t* cys,
    int ctus_w, int ctu_size, int cfmt, int seg_mode, long seg_arg,
    int32_t* seg_ctus, int64_t* seg_marks, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  SliceEncoder* e = (SliceEncoder*)senc;
  long nseg = 0;
  long seg_start_bytes = 0;
  int in_seg = 0;
  for (int i = 0; i < nctu; ++i) {
    MutCtuData md = sm.at((size_t)cys[i] * ctus_w + cxs[i]);
    CtuData d{md.cu_depth, md.nxn_flag, md.luma_mode, md.chroma_mode,
              md.tu_depth, md.coeff_y, md.coeff_cb, md.coeff_cr,
              md.pred_mode, md.skip_flag, md.merge_flag, md.merge_idx,
              md.mvp_flag, md.ref_idx, md.mvd_x, md.mvd_y, md.mv_x,
              md.mv_y, md.mvp_flag1, md.ref_idx1, md.mvd_x1, md.mvd_y1,
              md.mv_x1, md.mv_y1, md.sao, md.rext, md.ccp_cb, md.ccp_cr};
    e->encode_ctu(cxs[i], cys[i], d, -1);
    ++in_seg;
    int last = i == nctu - 1;
    int end = last ||
              (seg_mode == 1 && in_seg >= seg_arg) ||
              (seg_mode == 2 &&
               (long)e->bytes().size() - seg_start_bytes >= seg_arg);
    e->write_end_flag(end);
    if (end) {
      seg_ctus[nseg] = in_seg;
      seg_marks[nseg] = last ? -1 : (int64_t)e->segment_cut();
      ++nseg;
      seg_start_bytes = (long)e->bytes().size();
      in_seg = 0;
    }
  }
  return nseg;
}

// SliceSegmentMode 3 (reference TEncSlice
// xDetermineStartAndBoundingCtuTsAddr FIXED_NUMBER_OF_TILES): encode
// `order` (tile scan) as one slice cut into dependent segments at the
// cumulative CTU counts in `bounds` (each a tile-group end). Every
// segment's last CTU codes end_of_slice_segment_flag=1 + flush; the
// next tile then starts a fresh CABAC engine without re-closing the
// already-flushed substream (reset_tile_state). Returns the marks like
// hevc_enc_frame_order_segments.
extern "C" long hevc_enc_frame_order_tileseg(
    void* senc, int nctu, const int32_t* cxs, const int32_t* cys,
    int ctus_w, int ctu_size, int cfmt, int nbounds, const int32_t* bounds,
    int64_t* seg_marks, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  SliceEncoder* e = (SliceEncoder*)senc;
  long nseg = 0;
  int bi = 0;
  for (int i = 0; i < nctu; ++i) {
    MutCtuData md = sm.at((size_t)cys[i] * ctus_w + cxs[i]);
    CtuData d{md.cu_depth, md.nxn_flag, md.luma_mode, md.chroma_mode,
              md.tu_depth, md.coeff_y, md.coeff_cb, md.coeff_cr,
              md.pred_mode, md.skip_flag, md.merge_flag, md.merge_idx,
              md.mvp_flag, md.ref_idx, md.mvd_x, md.mvd_y, md.mv_x,
              md.mv_y, md.mvp_flag1, md.ref_idx1, md.mvd_x1, md.mvd_y1,
              md.mv_x1, md.mv_y1, md.sao, md.rext, md.ccp_cb, md.ccp_cr};
    e->encode_ctu(cxs[i], cys[i], d, -1);
    int last = i == nctu - 1;
    int end = last || (bi < nbounds && i + 1 == bounds[bi]);
    e->write_end_flag(end);
    if (end) {
      seg_marks[nseg] = last ? -1 : (int64_t)e->segment_cut();
      if (!last) e->reset_tile_state();
      ++nseg;
      ++bi;
    }
  }
  return nseg;
}

extern "C" void hevc_enc_frame(void* senc, int ctus_w, int ctus_h,
                               int ctu_size, int cfmt, STACKED_ARGS) {
  STACKED_INIT(ctu_size, cfmt);
  for (int cy = 0; cy < ctus_h; ++cy)
    for (int cx = 0; cx < ctus_w; ++cx) {
      size_t i = (size_t)cy * ctus_w + cx;
      MutCtuData md = sm.at(i);
      CtuData d{md.cu_depth, md.nxn_flag, md.luma_mode, md.chroma_mode,
                md.tu_depth, md.coeff_y, md.coeff_cb, md.coeff_cr,
                md.pred_mode, md.skip_flag, md.merge_flag, md.merge_idx,
                md.mvp_flag, md.ref_idx, md.mvd_x, md.mvd_y, md.mv_x,
                md.mv_y, md.mvp_flag1, md.ref_idx1, md.mvd_x1, md.mvd_y1,
                md.mv_x1, md.mv_y1, md.sao, md.rext, md.ccp_cb, md.ccp_cr};
      int last = (cy == ctus_h - 1) && (cx == ctus_w - 1);
      ((SliceEncoder*)senc)->encode_ctu(cx, cy, d, last);
    }
}

// ---- cu_qp_delta per-CTU QP exports (spec 8.6.1 qPY chain) -----------------
extern "C" {
// Copies the per-CTU predicted and final (carried) luma QPs recorded in
// encode order during the last slice; returns the CTU count.
long hevc_enc_ctu_qps(void* h, int8_t* pred, int8_t* fin) {
  SliceEncoder* e = (SliceEncoder*)h;
  for (size_t i = 0; i < e->ctu_qp_pred.size(); ++i) {
    pred[i] = e->ctu_qp_pred[i];
    fin[i] = e->ctu_qp_final[i];
  }
  return (long)e->ctu_qp_pred.size();
}
long hevc_dec_ctu_qps(void* h, int8_t* pred, int8_t* fin) {
  SliceDecoder* d = (SliceDecoder*)h;
  for (size_t i = 0; i < d->ctu_qp_pred.size(); ++i) {
    pred[i] = d->ctu_qp_pred[i];
    fin[i] = d->ctu_qp_final[i];
  }
  return (long)d->ctu_qp_pred.size();
}
// Copies the per-4x4 luma QP map of the most recently decoded CTU
// ((ctu/4)^2 entries) — sub-CTU quantization groups make QP vary inside
// a CTU (diff_cu_qp_delta_depth > 0), so dequant and deblock need the
// full-resolution map, not just the per-CTU value.
long hevc_dec_ctu_qp4(void* h, int8_t* out) {
  SliceDecoder* d = (SliceDecoder*)h;
  long n = (long)d->qp4_size();
  const int8_t* m = d->qp4_data();
  for (long i = 0; i < n; ++i) out[i] = m[i];
  return n;
}
}  // extern "C"
