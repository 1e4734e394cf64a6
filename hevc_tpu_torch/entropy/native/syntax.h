// Slice-data syntax codec (CU quadtree + intra modes + transform tree +
// residual coding) for the hevc_tpu native entropy layer.
//
// Parity: reference TEncSbac.cpp (encoder side; codeCoeffNxN:1181),
// TDecSbac.cpp (decoder side), TComTrQuant context derivations — all
// re-derived from ITU-T H.265 sections 7.3.8 (syntax), 9.3.3 (binarization)
// and 9.3.4.2 (context derivation).
//
// Data model: the Python orchestrator exchanges per-4x4-block decision maps
// (raster within CTU) + CTU-resolution coefficient planes; this layer owns
// picture-level maps so cross-CTU neighbour context (split depth, intra MPM)
// works without callbacks.
#pragma once
#include <cstdint>
#include <vector>

#include "cabac.h"

namespace hevctpu {

struct SliceParams {
  int32_t pic_w, pic_h;
  int32_t ctu_size;        // 64
  int32_t qp;
  int32_t slice_type;      // 0=B 1=P 2=I
  int32_t max_tu_depth_intra;
  int32_t max_tu_depth_inter;
  int32_t chroma_format;   // 1 = 4:2:0
  int32_t sign_hiding;
  int32_t transform_skip_enabled;
  int32_t min_cb_log2;     // 3
  int32_t max_cb_log2;     // 6 (== log2 ctu_size)
  int32_t min_tb_log2;     // 2
  int32_t max_tb_log2;     // 5
  int32_t max_merge_cand;  // MaxNumMergeCand (5)
  int32_t num_ref_l0;      // active references in list 0
  int32_t num_ref_l1;      // active references in list 1 (B slices)
  int32_t mvd_l1_zero;     // slice mvd_l1_zero_flag
  int32_t ref_poc_l0[16];  // POCs of the list-0 references
  int32_t ref_poc_l1[16];
  int32_t sao_luma;        // slice_sao_luma_flag
  int32_t sao_chroma;      // slice_sao_chroma_flag
  int32_t bit_depth;       // for the sao_offset_abs cMax
  int32_t cur_poc;         // current picture POC (AMVP scaling)
  int32_t wpp;             // entropy_coding_sync_enabled_flag (WPP)
  int32_t tile_cols;       // tiles: uniform grid (0/1 = no tiles)
  int32_t tile_rows;
  int32_t amp;             // SPS amp_enabled_flag (part_mode binarization)
  int32_t scaling_lists;   // SPS scaling_list_enabled (default matrices)
  // explicit weighted prediction (P slices, per list-0 reference):
  // spec 8.5.3.3.4.3 / 7.3.6.3 pred_weight_table (reference
  // WeightPredAnalysis per-ref fits). Unweighted refs carry the
  // identity set (w = 1<<denom, o = 0) — numerically identical to the
  // unweighted interpolation rounding for power-of-two weights.
  int32_t wp_on;
  int32_t wp_denom;        // luma_log2_weight_denom
  int32_t wp_w[16], wp_o[16];      // per-ref luma weight / offset
  int32_t wp_cdenom;       // chroma log2 weight denom
  int32_t wp_cw[32], wp_co[32];    // per-ref chroma, [ref*2 + comp-1]
  // list-1 explicit weights (B slices, PPS weighted_bipred_flag). Only
  // read when wp_on; identity sets for unweighted refs, like list 0.
  int32_t wp_w1[16], wp_o1[16];
  int32_t wp_cw1[32], wp_co1[32];
  int32_t cu_dqp;          // PPS cu_qp_delta_enabled
  const int8_t* ctu_qps;   // per-quantization-group target QP, raster over
                           // the ceil(pic/qg_size) grid with qg_size =
                           // ctu >> dqp_depth (encoder; may be null; equals
                           // a per-CTU map when dqp_depth == 0)
  int32_t pcm;             // SPS pcm_enabled (8x8 I_PCM CUs, sample depth
                           // = bit_depth, loop filter on)
  int32_t cabac_init;      // slice cabac_init_flag (spec 9.3.2.2: swaps
                           // the P and B context-init tables)
  int32_t col_from_l0;     // slice collocated_from_l0_flag (TMVP list
                           // selection for bi collocated blocks,
                           // spec 8.5.3.2.9)
  int32_t slice_start_ctu; // scan-order CTU address of the slice segment
                           // start (multi-slice pictures; SAO merge and
                           // prediction never cross slice boundaries)
  // ---- range extensions (spec 7.4.3.2.2 sps_range_extension /
  // 7.4.3.3.2 pps_range_extension; reference TComSlice.h SPSRExt/PPSRExt)
  int32_t ts_rotation;     // transform_skip_rotation_enabled_flag
  int32_t ts_context;      // transform_skip_context_enabled_flag
  int32_t implicit_rdpcm;  // implicit_rdpcm_enabled_flag
  int32_t explicit_rdpcm;  // explicit_rdpcm_enabled_flag
  int32_t persistent_rice; // persistent_rice_adaptation_enabled_flag
  int32_t bypass_align;    // cabac_bypass_alignment_enabled_flag
  int32_t ccp;             // PPS cross_component_prediction_enabled_flag
  int32_t ts_max_log2;     // PPS log2_max_transform_skip_block_size (2..5)
  int32_t dqp_depth;       // PPS diff_cu_qp_delta_depth: quantization
                           // groups of size ctu >> dqp_depth (spec 7.4.3.3,
                           // reference TComPPS::getMaxCuDQPDepth)
  int32_t tq_bypass;       // PPS transquant_bypass_enabled_flag (lossless
                           // CUs; cu_transquant_bypass_flag per CU)
  int32_t cqp_off[2];      // pps_cb/cr_qp_offset (+ slice offsets folded
                           // in by the caller; spec 8.6.1 qPiCb/qPiCr)
  // encoder-side search controls (no bitstream syntax; zero-init keeps the
  // HM defaults RDOQ=1 / RDOQTS=1, reference TAppEncCfg.cpp:814-815)
  int32_t rdoq_off;        // 1 disables rate-distortion optimized quant
  int32_t rdoq_ts_off;     // 1 disables RDOQ on transform-skip TUs
  int32_t cip;             // PPS constrained_intra_pred_flag: intra
                           // reference samples from inter-coded
                           // neighbours are substituted (spec 8.4.4.2.2;
                           // reference TComPattern fillReferenceSamples
                           // constrained branch)
  int32_t log2_par_merge;  // PPS Log2ParallelMergeLevel (absolute; <= 2
                           // or 0 = off): merge estimation regions,
                           // spec 6.4.2 + 8.5.3.2.3 singleMCLFlag
  // encoder-side: reference-GPU-mode ME reproduction (cfg GPUModeME —
  // the MCV-Univalle fork's OpenCL search semantics; no bitstream
  // syntax). gpu_sr = SearchRange for the per-CTU full-search window.
  int32_t gpu_mode_me;
  int32_t gpu_sr;
};

// Context model set: one instance per slice (later: per WPP row state).
struct ContextSet {
  ContextModel split_cu[3];
  ContextModel tq_bypass[1];
  ContextModel skip_flag[3];
  ContextModel merge_flag[1];
  ContextModel merge_idx[1];
  ContextModel part_size[4];
  ContextModel pred_mode[1];
  ContextModel intra_luma[1];
  ContextModel intra_chroma[2];
  ContextModel inter_dir[5];
  ContextModel mvd[2];
  ContextModel ref_idx[2];
  ContextModel dqp[3];
  ContextModel cbf_luma[5];
  ContextModel cbf_chroma[5];
  ContextModel qt_root_cbf[1];
  ContextModel last_x[30];  // 15 luma + 15 chroma
  ContextModel last_y[30];
  ContextModel sig_cg[4];   // 2 luma + 2 chroma
  ContextModel sig[44];     // 28 luma + 16 chroma
  ContextModel one[24];     // 16 luma + 8 chroma
  ContextModel abs_[6];     // 4 luma + 2 chroma
  ContextModel mvp_idx[1];
  ContextModel sao_merge[1];
  ContextModel sao_type[1];
  ContextModel trans_subdiv[3];
  ContextModel transform_skip[2];
  // range extensions (reference ContextTables.h RExt rows)
  ContextModel explicit_rdpcm_flag[2];  // [channel]
  ContextModel explicit_rdpcm_dir[2];
  ContextModel ccp[10];                 // cross_comp_pred: 5 Cb + 5 Cr
  // persistent Golomb-Rice adaptation statistics (reference
  // m_golombRiceAdaptationStatistics; rides WPP context save/load):
  // [chroma/luma << 1 | transformed/skipped]
  uint32_t rice_stat[4];
  void init(int slice_type, int qp);
};

// Transform-skip flags ride in the spare high bits of the tu_depth map at
// the TB origin position (depth itself stays in the low bits): readers of
// the depth must mask with TU_DEPTH_MASK.
enum : uint8_t { TU_DEPTH_MASK = 0x7, TS_Y = 0x10, TS_CB = 0x20,
                 TS_CR = 0x40, PCM_FLAG = 0x80 };
inline uint8_t ts_bit_of(int c_idx) {
  return c_idx == 0 ? TS_Y : (c_idx == 1 ? TS_CB : TS_CR);
}

// Per-CTU data exchanged with Python (all maps are 16x16 = per-4x4 raster).
// Inter fields are ignored for I slices.
struct CtuData {
  const uint8_t* cu_depth;      // quadtree depth 0..3 of the covering CU
  const uint8_t* nxn_flag;      // 1 if the (8x8) CU uses NxN partitioning
  const uint8_t* luma_mode;     // intra luma mode 0..34 of the covering PU
  const uint8_t* chroma_mode;   // intra chroma mode 0..34 of the covering CU
  const uint8_t* tu_depth;      // transform depth relative to the CU
  const int16_t* coeff_y;       // [ctu*ctu] raster
  const int16_t* coeff_cb;      // [ctu/2*ctu/2]
  const int16_t* coeff_cr;
  const uint8_t* pred_mode;     // 1 = intra, 0 = inter
  const uint8_t* skip_flag;     // 1 = skip (merge, no residual)
  const uint8_t* merge_flag;    // 1 = merge PU (incl. skip)
  const uint8_t* merge_idx;
  const uint8_t* mvp_flag;      // AMVP candidate selector (list 0)
  const int8_t* ref_idx;        // L0 reference index (-1: not used / intra)
  const int16_t* mvd_x;         // MVD in quarter-pel (AMVP PUs, list 0)
  const int16_t* mvd_y;
  const int16_t* mv_x;          // final MV in quarter-pel (list 0)
  const int16_t* mv_y;
  // list-1 fields (B slices; null for P/I)
  const uint8_t* mvp_flag1;
  const int8_t* ref_idx1;
  const int16_t* mvd_x1;
  const int16_t* mvd_y1;
  const int16_t* mv_x1;
  const int16_t* mv_y1;
  // SAO parameters, layout (int32[20]):
  //  [0] type_luma (0 off / 1 band / 2 edge)   [1] type_chroma
  //  [2] eo_class_luma  [3] eo_class_chroma
  //  [4] band_pos_luma  [5] band_pos_cb  [6] band_pos_cr  [7] merge flags
  //  [8..11] signed offsets luma  [12..15] cb  [16..19] cr
  const int32_t* sao;
  // range extensions (per-4x4 at the TB origin; null when not present):
  // rext bits: 0x01 Y-RDPCM on, 0x02 Y dir (1 = vertical), 0x04/0x08 Cb,
  // 0x10/0x20 Cr. ccp_cb/ccp_cr: cross-component alpha (-8..8).
  const uint8_t* rext;
  const int8_t* ccp_cb;
  const int8_t* ccp_cr;
};

struct MutCtuData {  // decoder-side (written)
  uint8_t* cu_depth;
  uint8_t* nxn_flag;
  uint8_t* luma_mode;
  uint8_t* chroma_mode;
  uint8_t* tu_depth;
  int16_t* coeff_y;
  int16_t* coeff_cb;
  int16_t* coeff_cr;
  uint8_t* pred_mode;
  uint8_t* skip_flag;
  uint8_t* merge_flag;
  uint8_t* merge_idx;
  uint8_t* mvp_flag;
  int8_t* ref_idx;
  int16_t* mvd_x;
  int16_t* mvd_y;
  int16_t* mv_x;
  int16_t* mv_y;
  uint8_t* mvp_flag1;
  int8_t* ref_idx1;
  int16_t* mvd_x1;
  int16_t* mvd_y1;
  int16_t* mv_x1;
  int16_t* mv_y1;
  int32_t* sao;
  uint8_t* rext;
  int8_t* ccp_cb;
  int8_t* ccp_cr;
};

// Inter PU geometry for part codes stored in the nxn_flag map:
// 0=2Nx2N, 2=2NxN, 3=Nx2N, 4=2NxnU, 5=2NxnD, 6=nLx2N, 7=nRx2N
// (1 = intra NxN). Returns the PU rectangle offset/size within an n-CU.
inline void pu_rect(int part, int pu, int n, int* ox, int* oy, int* pw,
                    int* ph) {
  *ox = 0; *oy = 0; *pw = n; *ph = n;
  int q = n >> 2;
  switch (part) {
    case 2: *ph = n >> 1; *oy = pu * *ph; break;
    case 3: *pw = n >> 1; *ox = pu * *pw; break;
    case 4: *ph = pu ? n - q : q; *oy = pu ? q : 0; break;       // 2NxnU
    case 5: *ph = pu ? q : n - q; *oy = pu ? n - q : 0; break;   // 2NxnD
    case 6: *pw = pu ? n - q : q; *ox = pu ? q : 0; break;       // nLx2N
    case 7: *pw = pu ? q : n - q; *ox = pu ? n - q : 0; break;   // nRx2N
    default: break;
  }
}
inline bool part_hor(int part) {  // horizontal split (PUs stacked)
  return part == 2 || part == 4 || part == 5;
}
inline bool part_ver(int part) {
  return part == 3 || part == 6 || part == 7;
}

// Picture-level per-4x4 state shared by encoder and decoder walkers.
struct MotionInfo {
  // two-list motion: list entries valid when ref[l] >= 0
  int16_t mvx[2] = {0, 0}, mvy[2] = {0, 0};
  int8_t ref[2] = {-1, -1};
  bool operator==(const MotionInfo& o) const {
    for (int l = 0; l < 2; ++l) {
      if ((ref[l] < 0) != (o.ref[l] < 0)) return false;
      if (ref[l] >= 0 && (mvx[l] != o.mvx[l] || mvy[l] != o.mvy[l] ||
                          ref[l] != o.ref[l]))
        return false;
    }
    return true;
  }
  int dir() const { return (ref[0] >= 0 ? 1 : 0) | (ref[1] >= 0 ? 2 : 0); }
};

class PicMaps {
 public:
  void init(const SliceParams& sp);
  int stride = 0, rows = 0;
  std::vector<uint8_t> cu_depth, luma_mode, nxn_flag, pred_mode, skip_flag;
  std::vector<int16_t> mv_x[2], mv_y[2];
  std::vector<int8_t> ref_idx[2];
  SliceParams sp;

  // collocated-picture motion for TMVP (null = disabled); per-4x4 raster
  // fields of the collocated reference, list-separated; refpoc uses
  // INT32_MIN as the "unused" sentinel (spec 8.5.3.2.8/9)
  const int16_t* col_mvx[2] = {nullptr, nullptr};
  const int16_t* col_mvy[2] = {nullptr, nullptr};
  const int32_t* col_refpoc[2] = {nullptr, nullptr};
  int32_t col_poc = 0;
  int col_stride = 0, col_rows = 0;
  void set_col(const int16_t* mx0, const int16_t* my0, const int32_t* rp0,
               const int16_t* mx1, const int16_t* my1, const int32_t* rp1,
               int stride_, int rows_, int32_t poc) {
    col_mvx[0] = mx0; col_mvy[0] = my0; col_refpoc[0] = rp0;
    col_mvx[1] = mx1; col_mvy[1] = my1; col_refpoc[1] = rp1;
    col_stride = stride_; col_rows = rows_; col_poc = poc;
  }
  // spec 8.5.3.2.8 temporal candidate for target list (refIdx 0)
  bool temporal_mv(int x0, int y0, int w, int h, int list, int ref,
                   int16_t* omx,
                   int16_t* omy) const;

  int idx(int x, int y) const { return (y >> 2) * stride + (x >> 2); }
  // coding-order availability (z-scan rule, spec 6.4.1)
  bool available(int x, int y, int cur_x, int cur_y) const;
  // inter motion of the min-block containing (x,y) if available & inter
  bool motion_at(int x, int y, int cur_x, int cur_y, MotionInfo* out) const;
  // spec 8.5.3.2.3 spatial merge candidates (+ temporal + zero fill);
  // part/pu select the second-PU exclusions of 2NxN (B1) / Nx2N (A1)
  int merge_candidates(int x0, int y0, int w, int h, MotionInfo out[5],
                       int part = 0, int pu = 0) const;
  // PB availability (spec 6.4.2): positions inside the current CU are
  // available iff they lie in an earlier PU (the z-scan rule of 6.4.1
  // applies only outside the CU); (cx0,cy0,cn) is the CU rectangle and
  // (px0,py0) the current PU origin
  bool pb_available(int x, int y, int px0, int py0, int cx0, int cy0,
                    int cn, int part, int pu) const;
  bool motion_at_pu(int x, int y, int px0, int py0, int cx0, int cy0,
                    int cn, int part, int pu, MotionInfo* out) const;
  // spec 8.5.3.2.6 AMVP: two predictor MVs for (list, ref_idx);
  // (cx0,cy0,cn,part,pu) give the PU context for 6.4.2 availability
  // (defaults describe a 2Nx2N PU == CU)
  void amvp_candidates(int x0, int y0, int w, int h, int list, int ref,
                       int16_t out_mv[4], int cx0 = -1, int cy0 = -1,
                       int cn = 0, int part = 0, int pu = 0) const;
};

class SliceEncoder {
 public:
  explicit SliceEncoder(const SliceParams& sp);
  void begin_slice();
  void encode_ctu(int ctu_x, int ctu_y, const CtuData& d, int end_of_slice);
  // SliceMode 2 (reference TEncSlice.cpp slice-byte-limit termination):
  // encode_ctu(..., -1) defers the end_of_slice_segment_flag; once the
  // budget decision is known the caller writes it here.
  void write_end_flag(int flag) { cabac_.encode_terminate(flag); }
  const std::vector<uint8_t>& bytes() const { return bw_.bytes; }
  // Byte-align the finished slice data and return the RBSP bytes. The
  // final '1' of the CABAC EncodeFlush (9.3.4.3.5) already serves as the
  // rbsp_stop_one_bit, so only zero padding is appended here.
  const std::vector<uint8_t>& finish_rbsp() {
    if (!finished_) {
      bw_.put_bit(1);
      while (!bw_.aligned()) bw_.put_bit(0);
      sub_sizes_.push_back((int32_t)(bw_.bytes.size() - sub_start_));
      sub_start_ = bw_.bytes.size();
      finished_ = true;
    }
    return bw_.bytes;
  }
  // Dependent slice segments (spec 7.3.6.1): after encode_terminate(1)
  // flushed the engine for the segment's last CTU, align the payload
  // (the flush's final '1' is the rbsp_stop_one_bit) and restart the
  // arithmetic engine KEEPING the context models — the byte offset
  // returned marks the segment boundary within bytes().
  size_t segment_cut() {
    bw_.put_bit(1);
    while (!bw_.aligned()) bw_.put_bit(0);
    sub_sizes_.push_back((int32_t)(bw_.bytes.size() - sub_start_));
    sub_start_ = bw_.bytes.size();
    cabac_.start();
    return bw_.bytes.size();
  }
  // SliceSegmentMode 3 (tile-aligned dependent segments): after a
  // segment_cut at a tile boundary the NEXT tile must not re-close the
  // previous one — forget the tile so encode_ctu only re-inits contexts
  void reset_tile_state() { cur_tile_ = -1; }
  PicMaps& maps() { return maps_; }
  // slice-init context states (RD bit estimation; the engine snapshots
  // these for rdoq_quant / counter-based mode costs)
  const ContextSet& contexts() const { return ctx_; }
  // WPP: byte sizes of the coded substreams (one per CTU row)
  const std::vector<int32_t>& substream_sizes() const { return sub_sizes_; }

 private:
  void cu_tree(int x0, int y0, int log2, int depth);
  void code_cu(int x0, int y0, int log2);
  void code_intra_cu(int x0, int y0, int log2);
  void code_inter_cu(int x0, int y0, int log2, bool skip);
  void code_merge_idx(int v);
  void code_mvd(int vx, int vy);
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk_idx, bool intra_split, int par_cb, int par_cr,
                      bool is_intra, int par_cb2 = 0, int par_cr2 = 0);
  void residual(int x0, int y0, int log2, int c_idx);
  void code_intra_luma_modes(int x0, int y0, int log2, bool nxn);
  void code_intra_chroma_mode(int x0, int y0);
  void code_sao(int ctu_x, int ctu_y);

  SliceParams sp_;
  PicMaps maps_;
  ContextSet ctx_;
  ContextSet wpp_saved_;     // context snapshot after CTU 1 of each row
  bool wpp_saved_valid_ = false;
  int cur_tile_ = -1;
  std::vector<int32_t> sub_sizes_;
  size_t sub_start_ = 0;
  BitWriter bw_;
  CabacEncoder cabac_;
  const CtuData* cur_ = nullptr;
  // cu_qp_delta state (spec 8.6.1 qPY_PRED chain over quantization
  // groups of size ctu >> dqp_depth; the exact mirror of the decoder's
  // model: last_qp_ is qPY_PREV, qg_ref_ the left/above-averaged
  // prediction of the current QG, qp4_ the per-4x4 luma QP of the
  // current CTU; dqp_target_ is the QG's intended QP from the per-QG
  // map, signalled at the first TU with any cbf)
  int dqp_target_ = 0, dqp_carried_ = 0;
  int last_qp_ = 0, qg_ref_ = 0;
  std::vector<int8_t> qp4_;
  bool dqp_coded_ = false, dqp_first_ = true;
  void qg_start(int x0, int y0);
  void code_ccp(int x0, int y0, int comp, int is_intra);
 public:
  std::vector<int8_t> ctu_qp_pred, ctu_qp_final;  // per-CTU, encode order
 private:
  int ctu_x0_ = 0, ctu_y0_ = 0;
  bool finished_ = false;
};

// Per-syntax-element bit accounting categories (reference
// TComCodingStatistics / RExt__DECODER_DEBUG_BIT_STATISTICS): each
// parsed element attributes the arithmetic-decoder bit consumption
// since the previous element to its category.
enum StatCat {
  ST_SPLIT_CU = 0, ST_SKIP, ST_MERGE_FLAG, ST_MERGE_IDX, ST_PART_SIZE,
  ST_PRED_MODE, ST_INTRA_LUMA, ST_INTRA_CHROMA, ST_INTER_DIR, ST_REF_IDX,
  ST_MVD, ST_MVP_IDX, ST_TRANSFORM_TREE, ST_DQP, ST_TS_FLAG,
  ST_LAST_POS, ST_SIG_MAP, ST_COEFF_LEVEL, ST_SIGN, ST_SAO, ST_PCM,
  ST_OTHER, ST_N
};

class SliceDecoder {
 public:
  SliceDecoder(const SliceParams& sp, const uint8_t* data, size_t size);
  void enable_stats() { stats_on_ = true; }
  const uint64_t* stat_bits() { stat(ST_OTHER); return stat_bits_; }
  void begin_slice();
  // returns end_of_slice flag
  int decode_ctu(int ctu_x, int ctu_y, const MutCtuData& d);
  // Dependent slice segment (spec 7.3.6.1): re-seat the bit reader and
  // arithmetic engine on the next segment's slice data while KEEPING the
  // context models, neighbour maps, SAO merge state and dQP chain — the
  // in-picture prediction and CABAC state continue across dependent
  // segments of one slice (spec 9.3.1 TableStateIdxDs).
  void reseat(const uint8_t* data, size_t size);

 private:
  void cu_tree(int x0, int y0, int log2, int depth);
  void parse_cu(int x0, int y0, int log2);
  void parse_intra_cu(int x0, int y0, int log2);
  void parse_inter_cu(int x0, int y0, int log2, bool skip);
  int parse_merge_idx();
  void parse_mvd(int* vx, int* vy);
  void publish_motion(int x0, int y0, int log2, const MotionInfo& mi,
                      int merge_f, int merge_i, int mvp_f, int mvd_x,
                      int mvd_y, int skip);
  void publish_motion_rect(int x0, int y0, int w, int h,
                           const MotionInfo& mi, int merge_f, int merge_i,
                           int mvp_f, int mvd_x, int mvd_y, int skip);
  void parse_pu(int px, int py, int pw, int ph, int log2, int part);
  void qg_start(int x0, int y0);
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk_idx, bool intra_split, int par_cb, int par_cr,
                      bool is_intra, int par_cb2 = 0, int par_cr2 = 0);
  void residual(int x0, int y0, int log2, int c_idx);
  void fill(uint8_t* map, int x0, int y0, int log2, uint8_t v);
  void fill16(int16_t* map, int x0, int y0, int log2, int16_t v);
  void parse_sao(int ctu_x, int ctu_y, int32_t* out);
  std::vector<int32_t> sao_store_;  // per-CTU params for merge derivation

  SliceParams sp_;
  PicMaps maps_;
  std::vector<uint8_t> tu_depth_map_, chroma_mode_map_;
  ContextSet ctx_;
  ContextSet wpp_saved_;
  bool wpp_saved_valid_ = false;
  int cur_tile_ = -1;
  bool seg_fresh_ = false;  // first CTU after a dependent-segment reseat
  // per-syntax-element bit stats (reference TComCodingStatistics)
  bool stats_on_ = false;
  uint64_t stat_bits_[ST_N] = {};
  size_t stat_mark_ = 0;
  int stat_cat_ = ST_OTHER;
  inline void stat(int cat) {
    if (!stats_on_) return;
    stat_bits_[stat_cat_] += br_.pos_ - stat_mark_;
    stat_mark_ = br_.pos_;
    stat_cat_ = cat;
  }
  std::vector<int32_t> sub_offsets_;   // substream start offsets (bytes)
  int next_sub_ = 1;
  BitReader br_;
  CabacDecoder cabac_;
  const MutCtuData* cur_ = nullptr;
  // Quantization-group dQP state (spec 8.6.1; reference TDecCu
  // xDecodeCU QG resets + TComDataCU::getRefQP/getLastCodedQP):
  // last_qp_ is the QP of the last finished CU in decoding order,
  // qg_ref_ the left/above-averaged prediction of the current QG,
  // qp4_ the per-4x4 luma QP of the current CTU.
  int dqp_target_ = 0, dqp_carried_ = 0;
  int last_qp_ = 0, qg_ref_ = 0;
  std::vector<int8_t> qp4_;
  bool dqp_coded_ = false, dqp_first_ = true;
 public:
  std::vector<int8_t> ctu_qp_pred, ctu_qp_final;
  size_t qp4_size() const { return qp4_.size(); }
  const int8_t* qp4_data() const { return qp4_.data(); }
 private:
  int ctu_x0_ = 0, ctu_y0_ = 0;

 public:
  void set_entry_points(const int32_t* off, int n) {
    sub_offsets_.assign(off, off + n);
  }
  PicMaps& maps() { return maps_; }
  // slice-init context states (RD bit estimation; the engine snapshots
  // these for rdoq_quant / counter-based mode costs)
  const ContextSet& contexts() const { return ctx_; }
};

// The rates exact RDOQ reads, in 1/32768 bit (kEntropyBits), built once
// from one set of context states: both bins of each sig, gt1 (one), gt2
// (abs_) and coded-subblock (sig_cg) context, and, per component class
// ([0] luma, [1] chroma) and TB size ([log2 - 2]), the last position's
// prefix and suffix bits of each x and each y coordinate.
struct RdoqRates {
  int32_t sig[44][2];
  int32_t one[24][2];
  int32_t abs_[6][2];
  int32_t sig_cg[4][2];
  int32_t last_x[2][4][32];
  int32_t last_y[2][4][32];
  void build(const ContextSet& cs);
};

// Exact rate-distortion-optimized quantization (reference
// TComTrQuant::xRateDistOptQuant, TComTrQuant.cpp:2129): per-coefficient
// level choice, coefficient-group zeroing and last-position selection by
// D + lambda*R with context-exact fractional-bit rates read from `rt`.
// coef: forward-transform coefficients (raster); lev: output levels
// (raster); log2 2..5. Returns the number of nonzero levels (0 = code no
// residual).
int rdoq_quant(const RdoqRates& rt, const int32_t* coef, int32_t* lev,
               int log2, int c_idx, int scan_idx, int qp, int bd,
               double lambda, const int32_t* smat);

// Context-exact fractional-bit rate of one bin (kEntropyBits — the
// reference TEncBinCABACCounter / ContextModel::getEntropyBits cost).
double ctx_rate(const ContextModel& c, int bin);

// CABAC-counter rate of a coded transform block: exact fractional bits
// the residual writer would spend coding `lev` (raster, `stride` between
// rows) on a copy of the context states `cs` — last position, CG flags,
// sig/gt1/gt2, sign (incl. hiding) and Golomb-Rice remaining, mirroring
// SliceEncoder::residual. Reference TEncBinCoderCABACCounter semantics:
// states evolve along the count. Returns 0 for an all-zero block.
double tb_rate_bits(const ContextSet& cs, const int32_t* lev, int stride,
                    int log2, int c_idx, int scan_idx, int sign_hiding);

}  // namespace hevctpu
