// Implementation of the slice-data syntax codec. See syntax.h.
#include "syntax.h"

#include <algorithm>
#include <cassert>
#include <cstring>

namespace hevctpu {

// ===========================================================================
// Context initialization values (ITU-T H.265 Tables 9-5..9-32), rows indexed
// by slice type in {B=0, P=1, I=2} (initType 2/1/0 without cabac_init_flag).
// ===========================================================================
namespace {
constexpr uint8_t CNU = 154;

// spec 9.3.2.2: cabac_init_flag swaps the P and B initialization tables
// (reference TDecSbac::resetEntropy initType selection)
inline int ctx_init_type(const SliceParams& sp) {
  if (sp.cabac_init && sp.slice_type != 2) return 1 - sp.slice_type;
  return sp.slice_type;
}

const uint8_t IV_SPLIT[3][3] = {{107,139,126},{107,139,126},{139,141,157}};
const uint8_t IV_TQB[3][1] = {{154},{154},{154}};
const uint8_t IV_SKIP[3][3] = {{197,185,201},{197,185,201},{CNU,CNU,CNU}};
const uint8_t IV_MERGE_F[3][1] = {{154},{110},{CNU}};
const uint8_t IV_MERGE_I[3][1] = {{137},{122},{CNU}};
const uint8_t IV_PART[3][4] = {{154,139,154,154},{154,139,154,154},{184,CNU,CNU,CNU}};
const uint8_t IV_PREDM[3][1] = {{134},{149},{CNU}};
const uint8_t IV_ILUMA[3][1] = {{183},{154},{184}};
const uint8_t IV_ICHROMA[3][2] = {{152,139},{152,139},{63,139}};
const uint8_t IV_INTERDIR[3][5] = {{95,79,63,31,31},{95,79,63,31,31},{CNU,CNU,CNU,CNU,CNU}};
const uint8_t IV_MVD[3][2] = {{169,198},{140,198},{CNU,CNU}};
const uint8_t IV_REF[3][2] = {{153,153},{153,153},{CNU,CNU}};
const uint8_t IV_DQP[3][3] = {{154,154,154},{154,154,154},{154,154,154}};
const uint8_t IV_CBF_L[3][5] = {{153,111,CNU,CNU,CNU},{153,111,CNU,CNU,CNU},{111,141,CNU,CNU,CNU}};
const uint8_t IV_CBF_C[3][5] = {{149,92,167,154,154},{149,107,167,154,154},{94,138,182,154,154}};
const uint8_t IV_ROOTCBF[3][1] = {{79},{79},{CNU}};
const uint8_t IV_LAST[3][30] = {
  {125,110,124,110, 95, 94,125,111,111, 79,125,126,111,111, 79,
   108,123, 93,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU},
  {125,110, 94,110, 95, 79,125,111,110, 78,110,111,111, 95, 94,
   108,123,108,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU},
  {110,110,124,125,140,153,125,127,140,109,111,143,127,111, 79,
   108,123, 63,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU,CNU}};
const uint8_t IV_SIGCG[3][4] = {{121,140,61,154},{121,140,61,154},{91,171,134,141}};
const uint8_t IV_SIG[3][44] = {
  {170,154,139,153,139,123,123, 63,124,166,183,140,136,153,154,166,
   183,140,136,153,154,166,183,140,136,153,154,140,
   170,153,138,138,122,121,122,121,167,151,183,140,151,183,140,140},
  {155,154,139,153,139,123,123, 63,153,166,183,140,136,153,154,166,
   183,140,136,153,154,166,183,140,136,153,154,140,
   170,153,123,123,107,121,107,121,167,151,183,140,151,183,140,140},
  {111,111,125,110,110, 94,124,108,124,107,125,141,179,153,125,107,
   125,141,179,153,125,107,125,141,179,153,125,141,
   140,139,182,182,152,136,152,136,153,136,139,111,136,139,111,111}};
const uint8_t IV_ONE[3][24] = {
  {154,196,167,167,154,152,167,182,182,134,149,136,153,121,136,122,
   169,208,166,167,154,152,167,182},
  {154,196,196,167,154,152,167,182,182,134,149,136,153,121,136,137,
   169,194,166,167,154,167,137,182},
  {140, 92,137,138,140,152,138,139,153, 74,149, 92,139,107,122,152,
   140,179,166,182,140,227,122,197}};
const uint8_t IV_ABS[3][6] = {
  {107,167, 91,107,107,167},{107,167, 91,122,107,167},
  {138,153,136,167,152,152}};
const uint8_t IV_MVP[3][1] = {{168},{168},{CNU}};
const uint8_t IV_SAOM[3][1] = {{153},{153},{153}};
const uint8_t IV_SAOT[3][1] = {{160},{185},{200}};
const uint8_t IV_TSUB[3][3] = {{224,167,122},{124,138, 94},{153,138,138}};
const uint8_t IV_TSKIP[3][2] = {{139,139},{139,139},{139,139}};
// range extensions (spec 9.3.2.2 / reference ContextTables.h RExt rows)
const uint8_t IV_ERDPCM_F[3][2] = {{139,139},{139,139},{154,154}};
const uint8_t IV_ERDPCM_D[3][2] = {{139,139},{139,139},{154,154}};
const uint8_t IV_CCP[3][10] = {
    {154,154,154,154,154,154,154,154,154,154},
    {154,154,154,154,154,154,154,154,154,154},
    {154,154,154,154,154,154,154,154,154,154}};

template <size_t N>
void init_arr(ContextModel (&arr)[N], const uint8_t (&iv)[3][N], int st, int qp) {
  for (size_t i = 0; i < N; ++i) arr[i].init(qp, iv[st][i]);
}

// --- scan tables -----------------------------------------------------------
// scan position -> raster offset within the TU, DC first. Index [log2-2][scan].
struct ScanTables {
  std::vector<uint16_t> t[4][3];
  ScanTables() {
    for (int lg = 2; lg <= 5; ++lg)
      for (int s = 0; s < 3; ++s) t[lg - 2][s] = build(1 << lg, s);
  }
  static std::vector<std::pair<int,int>> order(int n, int s) {
    std::vector<std::pair<int,int>> o;  // (x, y)
    if (s == 1) {  // horizontal
      for (int y = 0; y < n; ++y) for (int x = 0; x < n; ++x) o.push_back({x, y});
    } else if (s == 2) {  // vertical
      for (int x = 0; x < n; ++x) for (int y = 0; y < n; ++y) o.push_back({x, y});
    } else {  // up-right diagonal
      int x = 0, y = 0;
      while ((int)o.size() < n * n) {
        while (y >= 0) {
          if (x < n && y < n) o.push_back({x, y});
          --y; ++x;
        }
        y = x; x = 0;
      }
    }
    return o;
  }
  static std::vector<uint16_t> build(int n, int s) {
    std::vector<uint16_t> out;
    if (n == 4) {
      for (auto& p : order(4, s)) out.push_back(p.second * 4 + p.first);
      return out;
    }
    auto sb = order(n / 4, s);
    auto in = order(4, s);
    for (auto& b : sb)
      for (auto& c : in)
        out.push_back((b.second * 4 + c.second) * n + b.first * 4 + c.first);
    return out;
  }
};
const ScanTables g_scans;

// Inverse subblock maps: (ys * sb_w + xs) -> scan-order subblock index,
// per (log2, scan). RDOQ's coded-subblock-flag neighbour lookups use
// these for O(1) access (spec 7.3.8.11 coded_sub_block_flag context).
struct SbInvTables {
  std::vector<uint8_t> t[4][3];
  SbInvTables() {
    for (int lg = 2; lg <= 5; ++lg)
      for (int s = 0; s < 3; ++s) {
        int n = 1 << lg;
        int sbw = std::max(1, n >> 2);
        auto& v = t[lg - 2][s];
        v.resize((size_t)sbw * sbw);
        const auto& scan = g_scans.t[lg - 2][s];
        for (int i = 0; i < sbw * sbw; ++i) {
          int r = scan[i * 16 < n * n ? i * 16 : 0];
          v[((r / n) >> 2) * sbw + ((r % n) >> 2)] = (uint8_t)i;
        }
      }
  }
};
const SbInvTables g_sbinv;

const uint8_t kCtxMap4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
const uint8_t kGroupIdx[32] = {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,
                               8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};
const uint8_t kMinInGroup[10] = {0,1,2,3,4,6,8,12,16,24};

// spec 9.3.4.2.5 sig_coeff_flag ctxInc (relative within component class)
int sig_ctx_inc(int log2, int scan_idx, int xc, int yc,
                int csbf_right, int csbf_below, bool luma) {
  if (log2 == 2) return kCtxMap4x4[(yc << 2) + xc];
  if ((xc | yc) == 0) return 0;
  int xs = xc >> 2, ys = yc >> 2, xp = xc & 3, yp = yc & 3;
  int prev = csbf_right + 2 * csbf_below;
  int s;
  switch (prev) {
    case 0: s = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0; break;
    case 1: s = (yp == 0) ? 2 : (yp == 1) ? 1 : 0; break;
    case 2: s = (xp == 0) ? 2 : (xp == 1) ? 1 : 0; break;
    default: s = 2; break;
  }
  if (luma) {
    if (xs | ys) s += 3;
    s += (log2 == 3) ? ((scan_idx == 0) ? 9 : 15) : 21;
  } else {
    s += (log2 == 3) ? 9 : 12;
  }
  return s;
}

// spec 8.4.2 luma MPM candidate list
void mpm_list(const PicMaps& m, int x0, int y0, int cand[3]) {
  const int ctu = m.sp.ctu_size;
  int a = 1, b = 1;  // DC default
  if (m.available(x0 - 1, y0, x0, y0)) a = m.luma_mode[m.idx(x0 - 1, y0)];
  if (m.available(x0, y0 - 1, x0, y0) && (y0 % ctu) != 0)
    b = m.luma_mode[m.idx(x0, y0 - 1)];
  if (a == b) {
    if (a < 2) { cand[0] = 0; cand[1] = 1; cand[2] = 26; }
    else {
      cand[0] = a;
      cand[1] = 2 + ((a + 29) % 32);
      cand[2] = 2 + ((a - 2 + 1) % 32);
    }
  } else {
    cand[0] = a; cand[1] = b;
    cand[2] = (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 26);
  }
}

// chroma candidate modes (spec 7.4.9.6 / 8.4.3): index 0..3 -> mode,
// with 34 substitution when colliding with the luma mode; index 4 = DM.
int chroma_cand(int idx, int luma_mode) {
  static const int base[4] = {0, 26, 10, 1};
  if (idx == 4) return luma_mode;
  int m = base[idx];
  return (m == luma_mode) ? 34 : m;
}

int chroma_mode_to_idx(int mode, int luma_mode) {
  if (mode == luma_mode) return 4;  // DM
  for (int i = 0; i < 4; ++i)
    if (chroma_cand(i, luma_mode) == mode) return i;
  return 4;  // fallback (mode must equal one of the candidates)
}

// 4:2:2 chroma intra angle remapping (spec Table 8-3: IntraPredModeC is
// remapped because the chroma sample grid is stretched vertically;
// numerically identical to ITU-T H.265 Table 8-3 constants).
const uint8_t CHROMA_422_ANGLE_MAP[35] = {
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31};

int mode_scan_idx(int log2, int c_idx, int pred_mode, bool c444) {
  // spec 7.4.9.11: mode-dependent coefficient scan for small intra TUs;
  // chroma 8x8 qualifies when ChromaArrayType == 3 (4:4:4)
  bool mdcs = (c_idx == 0 || c444) ? (log2 == 2 || log2 == 3) : (log2 == 2);
  if (!mdcs) return 0;
  if (pred_mode >= 6 && pred_mode <= 14) return 2;   // near-horizontal: ver scan
  if (pred_mode >= 22 && pred_mode <= 30) return 1;  // near-vertical: hor scan
  return 0;
}

}  // namespace

void ContextSet::init(int st, int qp) {
  init_arr(split_cu, IV_SPLIT, st, qp);
  init_arr(tq_bypass, IV_TQB, st, qp);
  init_arr(skip_flag, IV_SKIP, st, qp);
  init_arr(merge_flag, IV_MERGE_F, st, qp);
  init_arr(merge_idx, IV_MERGE_I, st, qp);
  init_arr(part_size, IV_PART, st, qp);
  init_arr(pred_mode, IV_PREDM, st, qp);
  init_arr(intra_luma, IV_ILUMA, st, qp);
  init_arr(intra_chroma, IV_ICHROMA, st, qp);
  init_arr(inter_dir, IV_INTERDIR, st, qp);
  init_arr(mvd, IV_MVD, st, qp);
  init_arr(ref_idx, IV_REF, st, qp);
  init_arr(dqp, IV_DQP, st, qp);
  init_arr(cbf_luma, IV_CBF_L, st, qp);
  init_arr(cbf_chroma, IV_CBF_C, st, qp);
  init_arr(qt_root_cbf, IV_ROOTCBF, st, qp);
  init_arr(last_x, IV_LAST, st, qp);
  init_arr(last_y, IV_LAST, st, qp);
  init_arr(sig_cg, IV_SIGCG, st, qp);
  init_arr(sig, IV_SIG, st, qp);
  init_arr(one, IV_ONE, st, qp);
  init_arr(abs_, IV_ABS, st, qp);
  init_arr(mvp_idx, IV_MVP, st, qp);
  init_arr(sao_merge, IV_SAOM, st, qp);
  init_arr(sao_type, IV_SAOT, st, qp);
  init_arr(trans_subdiv, IV_TSUB, st, qp);
  init_arr(transform_skip, IV_TSKIP, st, qp);
  init_arr(explicit_rdpcm_flag, IV_ERDPCM_F, st, qp);
  init_arr(explicit_rdpcm_dir, IV_ERDPCM_D, st, qp);
  init_arr(ccp, IV_CCP, st, qp);
  rice_stat[0] = rice_stat[1] = rice_stat[2] = rice_stat[3] = 0;
}

// ===========================================================================
// PicMaps
// ===========================================================================
void PicMaps::init(const SliceParams& p) {
  sp = p;
  int ctus_w = (p.pic_w + p.ctu_size - 1) / p.ctu_size;
  int ctus_h = (p.pic_h + p.ctu_size - 1) / p.ctu_size;
  stride = ctus_w * p.ctu_size / 4;
  rows = ctus_h * p.ctu_size / 4;
  size_t n = (size_t)stride * rows;
  cu_depth.assign(n, 0);
  luma_mode.assign(n, 1);
  nxn_flag.assign(n, 0);
  pred_mode.assign(n, 1);   // default intra
  skip_flag.assign(n, 0);
  for (int l = 0; l < 2; ++l) {
    mv_x[l].assign(n, 0);
    mv_y[l].assign(n, 0);
    ref_idx[l].assign(n, -1);
  }
}

bool PicMaps::motion_at(int x, int y, int cx, int cy, MotionInfo* out) const {
  if (!available(x, y, cx, cy)) return false;
  int i = idx(x, y);
  if (pred_mode[i] != 0) return false;  // intra neighbour
  for (int l = 0; l < 2; ++l) {
    out->mvx[l] = mv_x[l][i];
    out->mvy[l] = mv_y[l][i];
    out->ref[l] = ref_idx[l][i];
  }
  return true;
}

// spec 8.5.3.2.3: spatial merge candidates A1,B1,B0,A0,(B2) with pairwise
// redundancy pruning, then zero-MV fill (no TMVP: sps_temporal_mvp off).
static int16_t scale_mv(int mv, int td, int tb);

// spec 8.5.3.2.8 (collocated position + availability) and 8.5.3.2.9
// (col MV selection + POC-distance scaling). The per-4x4 col field reads
// the 16x16-snapped position, matching the reference's motion compression
// (stored MV = top-left 4x4 of each 16x16 region).
bool PicMaps::temporal_mv(int x0, int y0, int w, int h, int list, int ref,
                          int16_t* omx, int16_t* omy) const {
  if (!col_mvx[0]) return false;
  int ctb_log2 = sp.max_cb_log2;
  for (int attempt = 0; attempt < 2; ++attempt) {
    int px, py;
    if (attempt == 0) {  // C0: bottom-right, same CTU row, inside picture
      int xbr = x0 + w, ybr = y0 + h;
      if ((y0 >> ctb_log2) != (ybr >> ctb_log2)) continue;
      if (ybr >= sp.pic_h || xbr >= sp.pic_w) continue;
      px = (xbr >> 4) << 4;
      py = (ybr >> 4) << 4;
    } else {  // C1: centre
      px = ((x0 + w / 2) >> 4) << 4;
      py = ((y0 + h / 2) >> 4) << 4;
    }
    int bx = px >> 2, bry = py >> 2;
    if (bx >= col_stride || bry >= col_rows) continue;
    size_t i = (size_t)bry * col_stride + bx;
    bool l0 = col_refpoc[0][i] != INT32_MIN;
    bool l1 = col_refpoc[1] && col_refpoc[1][i] != INT32_MIN;
    if (!l0 && !l1) continue;  // intra collocated block
    // list selection (spec 8.5.3.2.9): single-list blocks use that
    // list; bi blocks use the target list when no reference follows the
    // current picture (NoBackwardPredFlag), else list N where
    // N == collocated_from_l0_flag
    int use;
    if (l0 && l1) {
      bool no_backward = true;
      for (int r = 0; r < sp.num_ref_l0 && no_backward; ++r)
        if (sp.ref_poc_l0[r] > sp.cur_poc) no_backward = false;
      for (int r = 0; r < sp.num_ref_l1 && no_backward; ++r)
        if (sp.ref_poc_l1[r] > sp.cur_poc) no_backward = false;
      use = no_backward ? list : (sp.col_from_l0 ? 1 : 0);
    } else {
      use = l0 ? 0 : 1;
    }
    int target_poc = list == 0 ? sp.ref_poc_l0[ref] : sp.ref_poc_l1[ref];
    int td = col_poc - col_refpoc[use][i];
    int tb = sp.cur_poc - target_poc;
    int16_t mx = col_mvx[use][i], my = col_mvy[use][i];
    if (td == tb || td == 0) {
      *omx = mx;
      *omy = my;
    } else {
      *omx = scale_mv(mx, td, tb);
      *omy = scale_mv(my, td, tb);
    }
    return true;
  }
  return false;
}

bool PicMaps::pb_available(int x, int y, int px0, int py0, int cx0,
                           int cy0, int cn, int part, int pu) const {
  if (x < 0 || y < 0 || x >= sp.pic_w || y >= sp.pic_h) return false;
  if (cn > 0 && x >= cx0 && x < cx0 + cn && y >= cy0 && y < cy0 + cn) {
    // same coding block (spec 6.4.2): available iff in an earlier PU
    if (pu == 0) return false;
    int ox, oy, pw0, ph0;
    pu_rect(part, 0, cn, &ox, &oy, &pw0, &ph0);
    if (part_hor(part)) return y < cy0 + ph0;    // PU0 = top strip
    if (part_ver(part)) return x < cx0 + pw0;    // PU0 = left strip
    return false;
  }
  return available(x, y, px0, py0);
}

bool PicMaps::motion_at_pu(int x, int y, int px0, int py0, int cx0,
                           int cy0, int cn, int part, int pu,
                           MotionInfo* out) const {
  if (!pb_available(x, y, px0, py0, cx0, cy0, cn, part, pu)) return false;
  size_t i = idx(x, y);
  if (pred_mode[i] != 0) return false;
  out->mvx[0] = mv_x[0][i];
  out->mvy[0] = mv_y[0][i];
  out->ref[0] = ref_idx[0][i];
  out->mvx[1] = mv_x[1][i];
  out->mvy[1] = mv_y[1][i];
  out->ref[1] = ref_idx[1][i];
  return true;
}

int PicMaps::merge_candidates(int x0, int y0, int w, int h,
                              MotionInfo out[5], int part, int pu) const {
  int n = 0;
  MotionInfo a1, b1, b0, a0, b2;
  // current CU rectangle for 6.4.2 same-CB availability
  int cn = part == 0 ? 0 : (part_hor(part) ? w : h);
  int ox_, oy_, pw_, ph_;
  pu_rect(part, pu, cn > 0 ? cn : 1, &ox_, &oy_, &pw_, &ph_);
  int cx0 = x0 - ox_;
  int cy0 = y0 - oy_;
  // parallel merge estimation (PPS Log2ParallelMergeLevel > 2):
  // 8.5.3.2.3 singleMCLFlag — 8x8 CUs derive ONE merge list for the
  // whole CU regardless of partitioning (all PUs share it)
  const int plevel = sp.log2_par_merge > 2 ? sp.log2_par_merge : 0;
  if (plevel) {
    int cb = part == 0 ? w : cn;
    if (cb == 8 && part != 0) {
      x0 = cx0; y0 = cy0; w = h = 8; part = 0; pu = 0; cn = 0;
    }
  }
  auto mat = [&](int x, int y, MotionInfo* mi) {
    // spec 6.4.2 merge-estimation-region rule: a neighbour inside the
    // same (1 << plevel)-aligned region as the current PB is not
    // available for merge derivation
    if (plevel && (x >> plevel) == (x0 >> plevel) &&
        (y >> plevel) == (y0 >> plevel))
      return false;
    return motion_at_pu(x, y, x0, y0, cx0, cy0, cn, part, pu, mi);
  };
  // second-PU exclusions (spec 8.5.3.2.3): A1 for Nx2N PU1, B1 for
  // 2NxN PU1 (they would duplicate the first PU's motion)
  bool excl_a1 = part_ver(part) && pu == 1;
  bool excl_b1 = part_hor(part) && pu == 1;
  bool ha1 = !excl_a1 && mat(x0 - 1, y0 + h - 1, &a1);
  if (ha1) out[n++] = a1;
  bool hb1 = !excl_b1 && mat(x0 + w - 1, y0 - 1, &b1);
  if (hb1 && !(ha1 && b1 == a1)) out[n++] = b1;
  bool hb0 = mat(x0 + w, y0 - 1, &b0);
  if (hb0 && !(hb1 && b0 == b1)) out[n++] = b0;
  bool ha0 = mat(x0 - 1, y0 + h, &a0);
  if (ha0 && !(ha1 && a0 == a1)) out[n++] = a0;
  if (n < 4) {
    bool hb2 = mat(x0 - 1, y0 - 1, &b2);
    if (hb2 && !(ha1 && b2 == a1) && !(hb1 && b2 == b1)) out[n++] = b2;
  }
  bool is_b = sp.slice_type == 0;
  // temporal merging candidate (spec 8.5.3.2.1 step after B2; refIdx 0,
  // not pruned against the spatial candidates)
  if (col_mvx[0] && n < sp.max_merge_cand) {
    MotionInfo t;
    int16_t mx, my;
    bool got0 = temporal_mv(x0, y0, w, h, 0, 0, &mx, &my);
    if (got0) {
      t.mvx[0] = mx;
      t.mvy[0] = my;
      t.ref[0] = 0;
    }
    bool got1 = false;
    if (is_b && sp.num_ref_l1 > 0) {
      got1 = temporal_mv(x0, y0, w, h, 1, 0, &mx, &my);
      if (got1) {
        t.mvx[1] = mx;
        t.mvy[1] = my;
        t.ref[1] = 0;
      }
    }
    if (got0 || got1) out[n++] = t;
  }
  // B slices: combined bi-predictive candidates (spec 8.5.3.2.4)
  if (is_b && n > 1 && n < sp.max_merge_cand) {
    static const int l0i[12] = {0,1,0,2,1,2,0,3,1,3,2,3};
    static const int l1i[12] = {1,0,2,0,2,1,3,0,3,1,3,2};
    int orig = n;
    for (int k = 0; k < 12 && n < sp.max_merge_cand; ++k) {
      if (l0i[k] >= orig || l1i[k] >= orig) continue;
      const MotionInfo& a = out[l0i[k]];
      const MotionInfo& b = out[l1i[k]];
      if (a.ref[0] < 0 || b.ref[1] < 0) continue;
      // valid if different picture or different MV
      if (sp.ref_poc_l0[a.ref[0]] == sp.ref_poc_l1[b.ref[1]] &&
          a.mvx[0] == b.mvx[1] && a.mvy[0] == b.mvy[1])
        continue;
      MotionInfo c;
      c.mvx[0] = a.mvx[0]; c.mvy[0] = a.mvy[0]; c.ref[0] = a.ref[0];
      c.mvx[1] = b.mvx[1]; c.mvy[1] = b.mvy[1]; c.ref[1] = b.ref[1];
      out[n++] = c;
    }
  }
  // zero-MV fill (spec 8.5.3.2.5): numRefIdx = min over BOTH lists in B
  // slices, and once zeroIdx >= numRefIdx both refs clamp to 0 (HM
  // TComDataCU::getInterMergeCandidates zero-candidate loop)
  int zr = 0;
  int num_ref_z = is_b ? std::min(sp.num_ref_l0, sp.num_ref_l1)
                       : sp.num_ref_l0;
  while (n < sp.max_merge_cand) {
    MotionInfo z;
    int8_t r = (int8_t)((zr < num_ref_z) ? zr : 0);
    z.mvx[0] = z.mvy[0] = 0;
    z.ref[0] = r;
    if (is_b) {
      z.mvx[1] = z.mvy[1] = 0;
      z.ref[1] = r;
    }
    out[n++] = z;
    zr++;
  }
  // small-PU bi-pred restriction (spec 8.5.3.2.3 last step; reference
  // TDecEntropy/TEncSearch after getInterMergeCandidates): 8x4 and 4x8
  // prediction units use list 0 only — bi candidates are converted
  if (w + h == 12) {
    for (int i = 0; i < n; ++i)
      if (out[i].ref[0] >= 0 && out[i].ref[1] >= 0) out[i].ref[1] = -1;
  }
  // the list is truncated at MaxNumMergeCand (spec 8.5.3.2.1
  // numMergeCand; the spatial step alone can gather more)
  return std::min(n, sp.max_merge_cand);
}

// spec 8.5.3.2.6/8.5.3.2.7: AMVP spatial candidates with POC scaling.
// A from A0/A1 (unscaled same-picture pass, then scaled pass); B from
// B0/B1/B2 unscaled; when neither A position exists at all
// (isScaledFlag == 0), A takes B's value and B is re-derived scaled.
static int16_t scale_mv(int mv, int td, int tb) {
  td = td < -128 ? -128 : (td > 127 ? 127 : td);
  tb = tb < -128 ? -128 : (tb > 127 ? 127 : tb);
  if (td == 0) return (int16_t)mv;
  int tx = (16384 + (td >= 0 ? td : -td) / 2) / td;
  int dist = (tb * tx + 32) >> 6;
  dist = dist < -4096 ? -4096 : (dist > 4095 ? 4095 : dist);
  int v = dist * mv;
  int av = ((v >= 0 ? v : -v) + 127) >> 8;
  v = v >= 0 ? av : -av;
  return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

void PicMaps::amvp_candidates(int x0, int y0, int w, int h, int list,
                              int ref, int16_t out_mv[4], int cx0, int cy0,
                              int cn, int part, int pu) const {
  if (cx0 < 0) { cx0 = x0; cy0 = y0; cn = 0; }
  int target_poc = (list == 0) ? sp.ref_poc_l0[ref] : sp.ref_poc_l1[ref];
  auto ref_poc = [&](int l, int r) {
    return (l == 0) ? sp.ref_poc_l0[r] : sp.ref_poc_l1[r];
  };
  auto same_ref_mv = [&](const MotionInfo& mi, int16_t* ox, int16_t* oy) {
    const int order[2] = {list, 1 - list};
    for (int l : order) {
      if (mi.ref[l] < 0) continue;
      if (ref_poc(l, mi.ref[l]) == target_poc) {
        *ox = mi.mvx[l];
        *oy = mi.mvy[l];
        return true;
      }
    }
    return false;
  };
  auto scaled_mv = [&](const MotionInfo& mi, int16_t* ox, int16_t* oy) {
    const int order[2] = {list, 1 - list};
    for (int l : order) {
      if (mi.ref[l] < 0) continue;
      int npoc = ref_poc(l, mi.ref[l]);
      *ox = scale_mv(mi.mvx[l], sp.cur_poc - npoc, sp.cur_poc - target_poc);
      *oy = scale_mv(mi.mvy[l], sp.cur_poc - npoc, sp.cur_poc - target_poc);
      return true;
    }
    return false;
  };
  const int apos[2][2] = {{x0 - 1, y0 + h}, {x0 - 1, y0 + h - 1}};
  const int bpos[3][2] = {{x0 + w, y0 - 1}, {x0 + w - 1, y0 - 1},
                          {x0 - 1, y0 - 1}};
  int16_t ax = 0, ay = 0, bx = 0, by = 0;
  bool has_a = false, has_b = false;
  MotionInfo mi;
  bool a_exists = false;  // isScaledFlagLX: any inter neighbour at A0/A1
  for (auto& p : apos)
    if (motion_at_pu(p[0], p[1], x0, y0, cx0, cy0, cn, part, pu, &mi)) {
      a_exists = true;
      if (!has_a && same_ref_mv(mi, &ax, &ay)) has_a = true;
    }
  if (a_exists && !has_a)
    for (auto& p : apos)
      if (motion_at_pu(p[0], p[1], x0, y0, cx0, cy0, cn, part, pu, &mi) && scaled_mv(mi, &ax, &ay)) {
        has_a = true; break;
      }
  for (auto& p : bpos)
    if (motion_at_pu(p[0], p[1], x0, y0, cx0, cy0, cn, part, pu, &mi) && same_ref_mv(mi, &bx, &by)) {
      has_b = true; break;
    }
  if (!a_exists) {
    // promote B to A, then re-derive B with scaling (spec 8.5.3.2.6)
    if (has_b) { ax = bx; ay = by; has_a = true; }
    has_b = false;
    for (auto& p : bpos)
      if (motion_at_pu(p[0], p[1], x0, y0, cx0, cy0, cn, part, pu, &mi) && scaled_mv(mi, &bx, &by)) {
        has_b = true; break;
      }
  }
  int n = 0;
  int16_t cand[2][2] = {{0, 0}, {0, 0}};
  if (has_a) { cand[n][0] = ax; cand[n][1] = ay; n++; }
  if (has_b && !(has_a && bx == ax && by == ay)) {
    cand[n][0] = bx; cand[n][1] = by; n++;
  }
  if (n < 2 && col_mvx[0]) {
    // temporal predictor (spec 8.5.3.2.6: appended when fewer than two
    // distinct spatial candidates; not pruned against them)
    int16_t tx2, ty2;
    if (temporal_mv(x0, y0, w, h, list, ref, &tx2, &ty2)) {
      cand[n][0] = tx2;
      cand[n][1] = ty2;
      n++;
    }
  }
  out_mv[0] = cand[0][0];
  out_mv[1] = cand[0][1];
  out_mv[2] = cand[1][0];
  out_mv[3] = cand[1][1];
}

// uniform tile geometry (spec 6.5.1): column/row boundaries in CTUs
static int tile_edge(int n_ctus, int n_tiles, int i) {
  return (i * n_ctus) / n_tiles;   // uniform_spacing_flag derivation
}

int tile_id_of(const SliceParams& sp, int ctu_x, int ctu_y) {
  int tc = sp.tile_cols > 1 ? sp.tile_cols : 1;
  int tr = sp.tile_rows > 1 ? sp.tile_rows : 1;
  if (tc == 1 && tr == 1) return 0;
  int cw = (sp.pic_w + sp.ctu_size - 1) / sp.ctu_size;
  int ch = (sp.pic_h + sp.ctu_size - 1) / sp.ctu_size;
  int col = 0, row = 0;
  for (int i = 1; i < tc; ++i)
    if (ctu_x >= tile_edge(cw, tc, i)) col = i;
  for (int i = 1; i < tr; ++i)
    if (ctu_y >= tile_edge(ch, tr, i)) row = i;
  return row * tc + col;
}

// tile-scan rank of a CTU (CTUs ordered tile by tile, raster inside each)
int tile_scan_rank(const SliceParams& sp, int ctu_x, int ctu_y) {
  int tc = sp.tile_cols > 1 ? sp.tile_cols : 1;
  int tr = sp.tile_rows > 1 ? sp.tile_rows : 1;
  int cw = (sp.pic_w + sp.ctu_size - 1) / sp.ctu_size;
  int ch = (sp.pic_h + sp.ctu_size - 1) / sp.ctu_size;
  if (tc == 1 && tr == 1) return ctu_y * cw + ctu_x;
  int rank = 0;
  int tid = tile_id_of(sp, ctu_x, ctu_y);
  for (int row = 0; row < tr; ++row) {
    int y0 = tile_edge(ch, tr, row);
    int y1 = row + 1 < tr ? tile_edge(ch, tr, row + 1) : ch;
    for (int col = 0; col < tc; ++col) {
      int x0 = tile_edge(cw, tc, col);
      int x1 = col + 1 < tc ? tile_edge(cw, tc, col + 1) : cw;
      int t = row * tc + col;
      if (t < tid) {
        rank += (x1 - x0) * (y1 - y0);
      } else if (t == tid) {
        rank += (ctu_y - y0) * (x1 - x0) + (ctu_x - x0);
        return rank;
      }
    }
  }
  return rank;
}

static inline uint32_t part1by1(uint32_t v) {
  v &= 0xFFFF;
  v = (v | (v << 8)) & 0x00FF00FF;
  v = (v | (v << 4)) & 0x0F0F0F0F;
  v = (v | (v << 2)) & 0x33333333;
  v = (v | (v << 1)) & 0x55555555;
  return v;
}

bool PicMaps::available(int x, int y, int cx, int cy) const {
  if (x < 0 || y < 0 || x >= sp.pic_w || y >= sp.pic_h) return false;
  bool tiles = sp.tile_cols > 1 || sp.tile_rows > 1;
  if (tiles &&
      tile_id_of(sp, x / sp.ctu_size, y / sp.ctu_size) !=
          tile_id_of(sp, cx / sp.ctu_size, cy / sp.ctu_size))
    return false;  // prediction never crosses a tile boundary (spec 6.4.1)
  int ctus_w = (sp.pic_w + sp.ctu_size - 1) / sp.ctu_size;
  // prediction/context availability never reaches back across the start
  // of the current slice segment (spec 6.4.1 — both CTUs must belong to
  // the same slice)
  if ((y / sp.ctu_size) * ctus_w + (x / sp.ctu_size) < sp.slice_start_ctu)
    return false;
  auto key = [&](int px, int py) -> uint64_t {
    uint64_t ctu = tiles
        ? (uint64_t)tile_scan_rank(sp, px / sp.ctu_size, py / sp.ctu_size)
        : (uint64_t)(py / sp.ctu_size) * ctus_w + px / sp.ctu_size;
    uint32_t bx = (px % sp.ctu_size) >> 2, by = (py % sp.ctu_size) >> 2;
    return (ctu << 16) | part1by1(bx) | (part1by1(by) << 1);
  };
  return key(x, y) < key(cx, cy);
}

// ===========================================================================
// Residual coding — shared small helpers
// ===========================================================================
namespace {

struct SigCoeff { int pos; int16_t val; };  // pos = scan index

// collect per-subblock state from a TU block
struct TuBlock {
  int16_t c[32 * 32];
  int n, log2;
  int16_t at(int pos_raster) const { return c[pos_raster]; }
};

}  // namespace

// ===========================================================================
// SliceEncoder
// ===========================================================================
SliceEncoder::SliceEncoder(const SliceParams& sp) : sp_(sp), cabac_(&bw_) {
  maps_.init(sp);
  begin_slice();
}

void SliceEncoder::begin_slice() {
  dqp_first_ = true;
  dqp_coded_ = false;
  ctu_qp_pred.clear();
  ctu_qp_final.clear();
  ctx_.init(ctx_init_type(sp_), sp_.qp);
  bw_ = BitWriter();
  cabac_ = CabacEncoder(&bw_);
  finished_ = false;
}

void SliceEncoder::encode_ctu(int cx, int cy, const CtuData& d,
                              int end_of_slice) {
  cur_ = &d;
  ctu_x0_ = cx * sp_.ctu_size;
  ctu_y0_ = cy * sp_.ctu_size;
  int ctus_w_pic = (sp_.pic_w + sp_.ctu_size - 1) / sp_.ctu_size;
  if (sp_.tile_cols > 1 || sp_.tile_rows > 1) {
    int tid = tile_id_of(sp_, cx, cy);
    if (tid != cur_tile_) {
      if (cur_tile_ >= 0) {
        // close the previous tile's substream: end_of_subset_one_bit +
        // byte alignment (spec 7.3.8.1)
        cabac_.encode_terminate(1);
        bw_.put_bit(1);
        while (!bw_.aligned()) bw_.put_bit(0);
        sub_sizes_.push_back((int32_t)(bw_.bytes.size() - sub_start_));
        sub_start_ = bw_.bytes.size();
        cabac_.start();
      }
      ctx_.init(ctx_init_type(sp_), sp_.qp);
      cur_tile_ = tid;
      dqp_first_ = true;  // qPY_PREV resets at tile start (spec 8.6.1)
    }
  }
  if (sp_.wpp && cx == 0 && cy > 0) {
    dqp_first_ = true;  // qPY_PREV resets per CTB row under WPP
    // new CTU row: contexts from the snapshot taken after CTU 1 of the
    // row above (spec 9.3.1 entropy_coding_sync), fresh engine state
    if (wpp_saved_valid_)
      ctx_ = wpp_saved_;
    else
      ctx_.init(ctx_init_type(sp_), sp_.qp);
    cabac_.start();
  }
  // publish this CTU's maps so in-CTU and cross-CTU neighbour lookups work
  // (availability guards reads of not-yet-coded blocks).
  int bw4 = sp_.ctu_size / 4;
  for (int by = 0; by < bw4; ++by) {
    int py = (ctu_y0_ >> 2) + by;
    if (py >= maps_.rows) break;
    for (int bx = 0; bx < bw4; ++bx) {
      int px = (ctu_x0_ >> 2) + bx;
      if (px >= maps_.stride) break;
      size_t pi = (size_t)py * maps_.stride + px;
      size_t li = (size_t)by * bw4 + bx;
      maps_.cu_depth[pi] = d.cu_depth[li];
      maps_.luma_mode[pi] = d.luma_mode[li];
      maps_.nxn_flag[pi] = d.nxn_flag[li];
      if (sp_.slice_type != 2 && d.pred_mode) {
        maps_.pred_mode[pi] = d.pred_mode[li];
        maps_.skip_flag[pi] = d.skip_flag[li];
        maps_.mv_x[0][pi] = d.mv_x[li];
        maps_.mv_y[0][pi] = d.mv_y[li];
        maps_.ref_idx[0][pi] = d.ref_idx[li];
        if (d.mv_x1) {
          maps_.mv_x[1][pi] = d.mv_x1[li];
          maps_.mv_y[1][pi] = d.mv_y1[li];
          maps_.ref_idx[1][pi] = d.ref_idx1[li];
        }
      }
    }
  }
  if (sp_.cu_dqp) {
    // CTU-start quantization state (decoder mirror): qPY_PREV carries
    // across CTUs, resetting at slice/tile/WPP-row starts; the per-4x4
    // QP plane seeds to it so QG-origin neighbour reads are defined
    last_qp_ = dqp_first_ ? sp_.qp : dqp_carried_;
    dqp_first_ = false;
    qp4_.assign((size_t)bw4 * bw4, (int8_t)last_qp_);
    qg_ref_ = last_qp_;
    dqp_target_ = last_qp_;
    dqp_coded_ = false;
    ctu_qp_pred.push_back((int8_t)last_qp_);
  }
  if (sp_.sao_luma || sp_.sao_chroma) code_sao(cx, cy);
  cu_tree(ctu_x0_, ctu_y0_, sp_.max_cb_log2, 0);
  if (sp_.cu_dqp) {
    dqp_carried_ = last_qp_;
    ctu_qp_final.push_back((int8_t)dqp_carried_);
  }
  if (sp_.wpp && cx == 1) {
    wpp_saved_ = ctx_;
    wpp_saved_valid_ = true;
  }
  if (end_of_slice < 0) {
    // end_of_slice_segment_flag deferred (SliceMode 2 byte budget):
    // the caller inspects bytes() and writes it via write_end_flag().
    cur_ = nullptr;
    return;
  }
  cabac_.encode_terminate(end_of_slice);
  if (sp_.wpp && cx == ctus_w_pic - 1 && !end_of_slice) {
    // end_of_subset_one_bit + byte_alignment (spec 7.3.8.1): the flush
    // leaves its forced final '1' to the alignment bit written below
    cabac_.encode_terminate(1);
    bw_.put_bit(1);
    while (!bw_.aligned()) bw_.put_bit(0);
    sub_sizes_.push_back((int32_t)(bw_.bytes.size() - sub_start_));
    sub_start_ = bw_.bytes.size();
    cabac_.start();
  }
  cur_ = nullptr;
}

static int map_at(const uint8_t* m, int bw4, int lx, int ly) {
  return m[(ly >> 2) * bw4 + (lx >> 2)];
}

void SliceEncoder::cu_tree(int x0, int y0, int log2, int depth) {
  if (x0 >= sp_.pic_w || y0 >= sp_.pic_h) return;
  int size = 1 << log2;
  bool boundary = (x0 + size > sp_.pic_w) || (y0 + size > sp_.pic_h);
  int bw4 = sp_.ctu_size / 4;
  int target = map_at(cur_->cu_depth, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  bool split = boundary || (depth < target);
  if (log2 > sp_.min_cb_log2) {
    if (!boundary) {
      int ctxi = 0;
      if (maps_.available(x0 - 1, y0, x0, y0) &&
          maps_.cu_depth[maps_.idx(x0 - 1, y0)] > depth) ctxi++;
      if (maps_.available(x0, y0 - 1, x0, y0) &&
          maps_.cu_depth[maps_.idx(x0, y0 - 1)] > depth) ctxi++;
      cabac_.encode_bin(ctx_.split_cu[ctxi], split ? 1 : 0);
    }
  } else {
    split = false;
  }
  // Quantization-group boundaries exactly as the decoder derives them
  // (spec 7.3.8.4 IsCuQpDeltaCoded resets; reference TEncCu::xEncodeCU /
  // TDecCu::xDecodeCU): a new QG starts at a split node of exactly QG
  // size, or at a leaf CU of >= QG size.
  int qg_log2 = sp_.max_cb_log2 - sp_.dqp_depth;
  if (split) {
    if (sp_.cu_dqp && log2 == qg_log2) qg_start(x0, y0);
    int h = size >> 1;
    cu_tree(x0, y0, log2 - 1, depth + 1);
    cu_tree(x0 + h, y0, log2 - 1, depth + 1);
    cu_tree(x0, y0 + h, log2 - 1, depth + 1);
    cu_tree(x0 + h, y0 + h, log2 - 1, depth + 1);
    return;
  }
  if (sp_.cu_dqp && log2 >= qg_log2) qg_start(x0, y0);
  code_cu(x0, y0, log2);
  if (sp_.cu_dqp) {
    // CU finish (decoder xFinishDecodeCU mirror): the CU's decoded QP
    // is the signalled target once a delta was coded in this QG, else
    // the QG prediction; qPY_PREV advances to it
    int q = dqp_coded_ ? dqp_target_ : qg_ref_;
    int bw4 = sp_.ctu_size / 4;
    int n = 1 << (log2 - 2);
    int qx = (x0 - ctu_x0_) >> 2, qy = (y0 - ctu_y0_) >> 2;
    for (int yy = 0; yy < n; ++yy)
      std::fill(&qp4_[(size_t)(qy + yy) * bw4 + qx],
                &qp4_[(size_t)(qy + yy) * bw4 + qx + n], (int8_t)q);
    last_qp_ = q;
  }
}

void SliceEncoder::qg_start(int x0, int y0) {
  // New quantization group: reset the coded flag, derive qPY_PRED from
  // the left/above 4x4 neighbours of the QG origin within this CTB
  // (spec 8.6.1; reference TComDataCU::getRefQP), and fetch the QG's
  // intended QP from the per-QG target map.
  dqp_coded_ = false;
  int bw4 = sp_.ctu_size / 4;
  int qx = (x0 - ctu_x0_) >> 2, qy = (y0 - ctu_y0_) >> 2;
  int l = qx > 0 ? qp4_[(size_t)qy * bw4 + qx - 1] : last_qp_;
  int a = qy > 0 ? qp4_[(size_t)(qy - 1) * bw4 + qx] : last_qp_;
  qg_ref_ = (l + a + 1) >> 1;
  if (sp_.ctu_qps) {
    int qg = sp_.ctu_size >> sp_.dqp_depth;
    int qgs_w = (sp_.pic_w + qg - 1) / qg;
    dqp_target_ = sp_.ctu_qps[(size_t)(y0 / qg) * qgs_w + (x0 / qg)];
  } else {
    dqp_target_ = sp_.qp;
  }
}

void SliceEncoder::code_cu(int x0, int y0, int log2) {
  if (g_bin_trace) fprintf(g_bin_trace, "# CU %d %d log2=%d\n", x0, y0, log2);
  int bw4 = sp_.ctu_size / 4;
  // cu_transquant_bypass_flag (spec 7.3.8.5). The encoder's only
  // bypass mode is force-all (CUTransquantBypassFlagForce): every CU
  // codes 1 (reference TEncCu setting getCUTransquantBypassFlagForce).
  if (sp_.tq_bypass) cabac_.encode_bin(ctx_.tq_bypass[0], 1);
  if (sp_.slice_type != 2) {
    int skip = map_at(cur_->skip_flag, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
    int ctxi = 0;
    if (maps_.available(x0 - 1, y0, x0, y0) &&
        maps_.skip_flag[maps_.idx(x0 - 1, y0)]) ctxi++;
    if (maps_.available(x0, y0 - 1, x0, y0) &&
        maps_.skip_flag[maps_.idx(x0, y0 - 1)]) ctxi++;
    cabac_.encode_bin(ctx_.skip_flag[ctxi], skip);
    if (skip) {
      code_inter_cu(x0, y0, log2, true);
      return;
    }
    int intra = map_at(cur_->pred_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
    cabac_.encode_bin(ctx_.pred_mode[0], intra);  // 1 = MODE_INTRA
    if (!intra) {
      code_inter_cu(x0, y0, log2, false);
      return;
    }
  }
  code_intra_cu(x0, y0, log2);
}

void SliceEncoder::code_intra_cu(int x0, int y0, int log2) {
  int bw4 = sp_.ctu_size / 4;
  bool nxn = log2 == sp_.min_cb_log2 &&
             map_at(cur_->nxn_flag, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  if (log2 == sp_.min_cb_log2) {
    cabac_.encode_bin(ctx_.part_size[0], nxn ? 0 : 1);
  }
  // pcm_flag (spec 7.3.8.5/7.3.8.7; reference TEncSbac::codeIPCMInfo):
  // terminate-coded; on 1 the arithmetic coder flushes (stop bit + byte
  // alignment), raw sample codes follow, then the engine restarts with
  // contexts retained. 8x8 I_PCM only; samples ride the coeff planes.
  if (sp_.pcm && log2 >= 3 && log2 <= 5 && !nxn) {
    int pcm = (map_at(cur_->tu_depth, bw4, x0 - ctu_x0_, y0 - ctu_y0_) &
               PCM_FLAG) ? 1 : 0;
    cabac_.encode_terminate(pcm);
    if (pcm) {
      bw_.put_bit(1);
      while (!bw_.aligned()) bw_.put_bit(0);
      int n = 1 << log2, cn = n >> 1;
      int lx = x0 - ctu_x0_, ly = y0 - ctu_y0_;
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          bw_.put_bits(
              (uint32_t)cur_->coeff_y[(ly + i) * sp_.ctu_size + lx + j],
              sp_.bit_depth);
      int cctu = sp_.ctu_size >> 1;
      for (int c = 0; sp_.chroma_format != 0 && c < 2; ++c) {
        const int16_t* cp = c == 0 ? cur_->coeff_cb : cur_->coeff_cr;
        for (int i = 0; i < cn; ++i)
          for (int j = 0; j < cn; ++j)
            bw_.put_bits(
                (uint32_t)cp[((ly >> 1) + i) * cctu + (lx >> 1) + j],
                sp_.bit_depth);
      }
      cabac_.start();
      return;
    }
  }
  code_intra_luma_modes(x0, y0, log2, nxn);
  // 4:4:4 NxN: one intra_chroma_pred_mode per partition (spec 7.3.8.5);
  // monochrome (ChromaArrayType 0) codes no chroma mode at all
  if (sp_.chroma_format == 3 && nxn) {
    int half = 1 << (log2 - 1);
    for (int i = 0; i < 4; ++i)
      code_intra_chroma_mode(x0 + (i & 1) * half, y0 + (i >> 1) * half);
  } else if (sp_.chroma_format != 0) {
    code_intra_chroma_mode(x0, y0);
  }
  transform_tree(x0, y0, x0, y0, log2, 0, 0, nxn, 1, 1, true);
}

void SliceEncoder::code_merge_idx(int v) {
  // TR binarization, cMax = MaxNumMergeCand-1: first bin context-coded,
  // remaining bins bypass (spec 9.3.3.x / Table 9-37).
  int cmax = sp_.max_merge_cand - 1;
  if (cmax == 0) return;
  cabac_.encode_bin(ctx_.merge_idx[0], v > 0);
  if (v > 0) {
    for (int k = 1; k < v; ++k) cabac_.encode_bypass(1);
    if (v < cmax) cabac_.encode_bypass(0);
  }
}

void SliceEncoder::code_mvd(int vx, int vy) {
  // spec 7.3.8.9 mvd_coding
  int g0x = vx != 0, g0y = vy != 0;
  cabac_.encode_bin(ctx_.mvd[0], g0x);
  cabac_.encode_bin(ctx_.mvd[0], g0y);
  int ax = vx < 0 ? -vx : vx, ay = vy < 0 ? -vy : vy;
  if (g0x) cabac_.encode_bin(ctx_.mvd[1], ax > 1);
  if (g0y) cabac_.encode_bin(ctx_.mvd[1], ay > 1);
  auto eg1 = [&](int v) {  // exp-golomb order 1, bypass
    int k = 1;
    while (v >= (1 << k)) {
      cabac_.encode_bypass(1);
      v -= 1 << k;
      k++;
    }
    cabac_.encode_bypass(0);
    cabac_.encode_bypass_bins((uint32_t)v, k);
  };
  if (g0x) {
    if (ax > 1) eg1(ax - 2);
    cabac_.encode_bypass(vx < 0);
  }
  if (g0y) {
    if (ay > 1) eg1(ay - 2);
    cabac_.encode_bypass(vy < 0);
  }
}

void SliceEncoder::code_inter_cu(int x0, int y0, int log2, bool skip) {
  int bw4 = sp_.ctu_size / 4;
  int lx = x0 - ctu_x0_, ly = y0 - ctu_y0_;
  int merge_i = map_at(cur_->merge_idx, bw4, lx, ly);
  if (skip) {  // PU = whole CU, merge, no residual
    code_merge_idx(merge_i);
    return;
  }
  // part_mode (spec 9.3.3.7): with SPS AMP enabled at this depth the
  // rectangular codes carry an extra ctx-3 bin and the asymmetric modes
  // one more bypass bin; part codes per pu_rect() in the nxn_flag map
  int part = map_at(cur_->nxn_flag, bw4, lx, ly);
  bool amp_bins = sp_.amp && log2 > sp_.min_cb_log2;  // HM codePartSize: uiDepth < log2DiffMaxMin (64x64 CUs included)
  cabac_.encode_bin(ctx_.part_size[0], part == 0);
  if (part != 0) {
    cabac_.encode_bin(ctx_.part_size[1], part_hor(part));
    if (amp_bins) {
      bool plain = part == 2 || part == 3;
      cabac_.encode_bin(ctx_.part_size[3], plain);
      if (!plain) cabac_.encode_bypass(part == 5 || part == 7);
    }
  }
  int n = 1 << log2;
  int npu = part == 0 ? 1 : 2;
  int any_merge_f = 1;
  for (int pu = 0; pu < npu; ++pu) {
    int ox, oy, pw, ph;
    pu_rect(part, pu, n, &ox, &oy, &pw, &ph);
    int px = x0 + ox, py = y0 + oy;
    int plx = px - ctu_x0_, ply = py - ctu_y0_;
    int pli = (ply >> 2) * bw4 + (plx >> 2);
    int merge_f = map_at(cur_->merge_flag, bw4, plx, ply);
    int pu_merge_i = map_at(cur_->merge_idx, bw4, plx, ply);
    if (!merge_f) any_merge_f = 0;
    cabac_.encode_bin(ctx_.merge_flag[0], merge_f);
    if (merge_f) {
      code_merge_idx(pu_merge_i);
      continue;
    }
    bool is_b = sp_.slice_type == 0;
    int ref0 = cur_->ref_idx[pli];
    int ref1 = cur_->mvd_x1 ? cur_->ref_idx1[pli] : -1;
    int idc = (ref0 >= 0 ? 1 : 0) | (ref1 >= 0 ? 2 : 0);  // 1=L0 2=L1 3=bi
    if (is_b) {
      // inter_pred_idc (spec 9.3.3.10): bin0 ctx = CtDepth; '1' = BI,
      // else bin1 (ctx 4): 0 = L0, 1 = L1. PUs of an 8x8 CU other than
      // 2Nx2N cannot be bi — bin0 is skipped (reference TEncSbac
      // codeInterDir: partSize == 2Nx2N || height != 8)
      int depth = sp_.max_cb_log2 - log2;
      if (part == 0 || log2 > 3)
        cabac_.encode_bin(ctx_.inter_dir[depth], idc == 3);
      if (idc != 3) cabac_.encode_bin(ctx_.inter_dir[4], idc == 2);
    }
    auto code_ref = [&](int r, int num_ref) {
      // TR binarization; only bins 0 and 1 are context-coded, the rest
      // bypass (reference TEncSbac codeRefFrmIdx / spec 9.3.4.2.1)
      if (num_ref <= 1) return;
      int cmax = num_ref - 1;
      cabac_.encode_bin(ctx_.ref_idx[0], r > 0);
      if (r > 0) {
        for (int k = 1; k < r && k < cmax; ++k) {
          if (k == 1) cabac_.encode_bin(ctx_.ref_idx[1], 1);
          else cabac_.encode_bypass(1);
        }
        if (r < cmax) {
          if (r == 1) cabac_.encode_bin(ctx_.ref_idx[1], 0);
          else cabac_.encode_bypass(0);
        }
      }
    };
    if (idc & 1) {
      code_ref(ref0, sp_.num_ref_l0);
      code_mvd(cur_->mvd_x[pli], cur_->mvd_y[pli]);
      cabac_.encode_bin(ctx_.mvp_idx[0],
                        map_at(cur_->mvp_flag, bw4, plx, ply));
    }
    if (idc & 2) {
      code_ref(ref1, sp_.num_ref_l1);
      if (!(sp_.mvd_l1_zero && idc == 3))
        code_mvd(cur_->mvd_x1[pli], cur_->mvd_y1[pli]);
      cabac_.encode_bin(ctx_.mvp_idx[0],
                        map_at(cur_->mvp_flag1, bw4, plx, ply));
    }
  }
  int merge_f = part == 0 ? any_merge_f : 0;  // rqt_root rule below
  // rqt_root_cbf (not coded for 2Nx2N merge: inferred 1)
  auto any_nz = [&](const int16_t* plane, int pw, int px, int py, int n) {
    for (int yy = 0; yy < n; ++yy)
      for (int xx = 0; xx < n; ++xx)
        if (plane[(py + yy) * pw + px + xx]) return 1;
    return 0;
  };
  // chroma planes are (ctu >> csy) rows x (ctu >> csx) cols (4:2:2 is
  // full height); the root-cbf scan must cover the whole chroma block
  int rcsx = (sp_.chroma_format == 3) ? 0 : 1;
  int rcsy = (sp_.chroma_format == 1) ? 1 : 0;
  auto any_nz_rect = [&](const int16_t* plane, int pw, int px, int py,
                         int nw, int nh) {
    for (int yy = 0; yy < nh; ++yy)
      for (int xx = 0; xx < nw; ++xx)
        if (plane[(py + yy) * pw + px + xx]) return 1;
    return 0;
  };
  int has_resid = any_nz(cur_->coeff_y, sp_.ctu_size, lx, ly, n)
      || (sp_.chroma_format != 0
          && (any_nz_rect(cur_->coeff_cb, sp_.ctu_size >> rcsx, lx >> rcsx,
                          ly >> rcsy, n >> rcsx, n >> rcsy)
              || any_nz_rect(cur_->coeff_cr, sp_.ctu_size >> rcsx,
                             lx >> rcsx, ly >> rcsy, n >> rcsx,
                             n >> rcsy)));
  if (!merge_f) {
    cabac_.encode_bin(ctx_.qt_root_cbf[0], has_resid);
  }
  if (has_resid || merge_f) {
    transform_tree(x0, y0, x0, y0, log2, 0, 0, false, 1, 1, false);
  }
}

void SliceEncoder::code_intra_luma_modes(int x0, int y0, int log2, bool nxn) {
  int bw4 = sp_.ctu_size / 4;
  int npart = nxn ? 4 : 1;
  int half = 1 << (log2 - 1);
  int px[4], py[4], mode[4], cand[4][3], mpm_idx[4];
  for (int i = 0; i < npart; ++i) {
    px[i] = x0 + (i & 1) * half;
    py[i] = y0 + (i >> 1) * half;
    mode[i] = map_at(cur_->luma_mode, bw4, px[i] - ctu_x0_, py[i] - ctu_y0_);
    mpm_list(maps_, px[i], py[i], cand[i]);
    mpm_idx[i] = -1;
    for (int k = 0; k < 3; ++k)
      if (cand[i][k] == mode[i]) { mpm_idx[i] = k; break; }
    cabac_.encode_bin(ctx_.intra_luma[0], mpm_idx[i] >= 0 ? 1 : 0);
  }
  for (int i = 0; i < npart; ++i) {
    if (mpm_idx[i] >= 0) {
      // mpm_idx: truncated unary, bypass
      cabac_.encode_bypass(mpm_idx[i] > 0 ? 1 : 0);
      if (mpm_idx[i] > 0) cabac_.encode_bypass(mpm_idx[i] > 1 ? 1 : 0);
    } else {
      int c[3] = {cand[i][0], cand[i][1], cand[i][2]};
      std::sort(c, c + 3);
      int rem = mode[i];
      for (int k = 2; k >= 0; --k)
        if (rem > c[k]) rem--;
      cabac_.encode_bypass_bins(rem, 5);
    }
  }
}

void SliceEncoder::code_intra_chroma_mode(int x0, int y0) {
  int bw4 = sp_.ctu_size / 4;
  int cmode = map_at(cur_->chroma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  int lmode = map_at(cur_->luma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  int idx = chroma_mode_to_idx(cmode, lmode);
  if (idx == 4) {
    cabac_.encode_bin(ctx_.intra_chroma[0], 0);
  } else {
    cabac_.encode_bin(ctx_.intra_chroma[0], 1);
    cabac_.encode_bypass_bins(idx, 2);
  }
}

void SliceEncoder::transform_tree(int x0, int y0, int xb, int yb, int log2,
                                  int depth, int blk_idx, bool intra_split,
                                  int par_cb, int par_cr, bool is_intra,
                                  int par_cb2, int par_cr2) {
  int bw4 = sp_.ctu_size / 4;
  int max_depth = is_intra ? sp_.max_tu_depth_intra + (intra_split ? 1 : 0)
                           : sp_.max_tu_depth_inter;
  bool explicit_split =
      log2 <= sp_.max_tb_log2 && log2 > sp_.min_tb_log2 &&
      depth < max_depth && !(intra_split && depth == 0);
  bool split;
  if (log2 > sp_.max_tb_log2) split = true;
  else if (intra_split && depth == 0) split = true;
  else if (explicit_split)
    split = (map_at(cur_->tu_depth, bw4, x0 - ctu_x0_, y0 - ctu_y0_) &
             TU_DEPTH_MASK) > depth;
  else split = false;
  if (explicit_split)
    cabac_.encode_bin(ctx_.trans_subdiv[5 - log2], split ? 1 : 0);

  auto any_nz = [&](const int16_t* plane, int pw, int px, int py, int n,
                    int nh) {
    for (int yy = 0; yy < nh; ++yy)
      for (int xx = 0; xx < n; ++xx)
        if (plane[(py + yy) * pw + px + xx]) return 1;
    return 0;
  };
  int cs = (sp_.chroma_format == 3) ? 0 : 1;  // chroma coord shift (x)
  bool c422 = sp_.chroma_format == 2;
  bool mono = sp_.chroma_format == 0;  // ChromaArrayType 0: no chroma
                                       // cbf/residual syntax (7.3.8.8)
  int c_stride = sp_.ctu_size >> cs;
  int cbf_cb = 0, cbf_cr = 0, cbf_cb2 = 0, cbf_cr2 = 0;
  if (!mono && (log2 > 2 || cs == 0)) {
    // 4:2:2 chroma planes are full height (no vertical subsampling):
    // each luma TB carries two square sub-TBs stacked vertically, each
    // with its own cbf (spec 7.3.8.8; mirrors the decoder path above).
    // When the second flag is NOT coded (split node above 8x8) the
    // first flag covers the node's WHOLE chroma subtree.
    int cpx = (x0 - ctu_x0_) >> cs;
    int cpy = c422 ? (y0 - ctu_y0_) : ((y0 - ctu_y0_) >> cs);
    int cn = 1 << (log2 - cs);
    bool two_flags = c422 && (!split || log2 == 3);
    int span1 = (c422 && !two_flags) ? 2 * cn : cn;
    if (depth == 0 || par_cb) {
      cbf_cb = any_nz(cur_->coeff_cb, c_stride, cpx, cpy, cn, span1);
      cabac_.encode_bin(ctx_.cbf_chroma[depth], cbf_cb);
      if (two_flags) {
        cbf_cb2 = any_nz(cur_->coeff_cb, c_stride, cpx, cpy + cn, cn, cn);
        cabac_.encode_bin(ctx_.cbf_chroma[depth], cbf_cb2);
      }
    }
    if (depth == 0 || par_cr) {
      cbf_cr = any_nz(cur_->coeff_cr, c_stride, cpx, cpy, cn, span1);
      cabac_.encode_bin(ctx_.cbf_chroma[depth], cbf_cr);
      if (two_flags) {
        cbf_cr2 = any_nz(cur_->coeff_cr, c_stride, cpx, cpy + cn, cn, cn);
        cabac_.encode_bin(ctx_.cbf_chroma[depth], cbf_cr2);
      }
    }
  } else if (!mono) {
    cbf_cb = par_cb;
    cbf_cr = par_cr;
    cbf_cb2 = par_cb2;
    cbf_cr2 = par_cr2;
  }

  if (split) {
    int h = 1 << (log2 - 1);
    transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    return;
  }

  // leaf: cbf_luma coded unless inter depth-0 with no chroma cbf (then
  // inferred 1, spec 7.3.8.8)
  if (g_bin_trace) fprintf(g_bin_trace, "# TULEAF %d %d log2=%d cb=%d cr=%d\n", x0, y0, log2, cbf_cb, cbf_cr);
  int n = 1 << log2;
  int cbf_y = any_nz(cur_->coeff_y, sp_.ctu_size, x0 - ctu_x0_, y0 - ctu_y0_, n, n);
  if (is_intra || depth != 0 || cbf_cb || cbf_cr || cbf_cb2 || cbf_cr2)
    cabac_.encode_bin(ctx_.cbf_luma[depth == 0 ? 1 : 0], cbf_y);
  else
    cbf_y = 1;  // inferred (encoder guarantees nonzero luma here)

  // cu_qp_delta_abs/sign, once per quantization group at the first TU
  // with any cbf (spec 7.3.8.10; reference TEncSbac::codeDeltaQP: TU
  // prefix cMax 5 with ctx 0 then 1, EG0 suffix, bypass sign)
  if (sp_.cu_dqp && !dqp_coded_ &&
      (cbf_y || cbf_cb || cbf_cr || cbf_cb2 || cbf_cr2)) {
    int delta = dqp_target_ - qg_ref_;
    int a = delta < 0 ? -delta : delta;
    int pre = a < 5 ? a : 5;
    for (int b = 0; b < pre; ++b) cabac_.encode_bin(ctx_.dqp[b ? 1 : 0], 1);
    if (pre < 5) cabac_.encode_bin(ctx_.dqp[pre ? 1 : 0], 0);
    if (a >= 5) {  // EG0 suffix
      int v = a - 5, k = 0;
      while (v >= (1 << (k + 1)) - 1) ++k;  // v+1 in [2^k, 2^(k+1))
      int base = (1 << k) - 1;
      for (int b = 0; b < k; ++b) cabac_.encode_bypass(1);
      cabac_.encode_bypass(0);
      for (int b = k - 1; b >= 0; --b)
        cabac_.encode_bypass(((v - base) >> b) & 1);
    }
    if (a) cabac_.encode_bypass(delta < 0 ? 1 : 0);
    dqp_coded_ = true;
  }

  if (cbf_y) residual(x0, y0, log2, 0);
  if (mono) {
  } else if (log2 > 2 || cs == 0) {
    if (sp_.ccp && cbf_y && cs == 0) code_ccp(x0, y0, 1, is_intra);
    if (cbf_cb) residual(x0, y0, log2 - cs, 1);
    if (c422 && cbf_cb2) residual(x0, y0 + (1 << (log2 - 1)), log2 - 1, 1);
    if (sp_.ccp && cbf_y && cs == 0) code_ccp(x0, y0, 2, is_intra);
    if (cbf_cr) residual(x0, y0, log2 - cs, 2);
    if (c422 && cbf_cr2) residual(x0, y0 + (1 << (log2 - 1)), log2 - 1, 2);
  } else if (blk_idx == 3) {
    if (par_cb) residual(xb, yb, 2, 1);
    if (c422 && par_cb2) residual(xb, yb + 4, 2, 1);
    if (par_cr) residual(xb, yb, 2, 2);
    if (c422 && par_cr2) residual(xb, yb + 4, 2, 2);
  }
}

void SliceEncoder::code_ccp(int x0, int y0, int comp, int is_intra) {
  // cross-component prediction alpha (spec 7.3.8.12; exact mirror of
  // SliceDecoder::parse_ccp / reference TEncSbac::
  // codeCrossComponentPrediction): coded when the luma TB has
  // coefficients and the CU is inter or intra with DM chroma
  int bw4 = sp_.ctu_size / 4;
  if (is_intra) {
    int lm = map_at(cur_->luma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
    int cm = map_at(cur_->chroma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
    if (lm != cm) return;  // not DM chroma: no alpha coded
  }
  int alpha = 0;
  const int8_t* m = comp == 1 ? cur_->ccp_cb : cur_->ccp_cr;
  if (m)
    alpha = m[((y0 - ctu_y0_) >> 2) * bw4 + ((x0 - ctu_x0_) >> 2)];
  ContextModel* pc = ctx_.ccp + (comp == 2 ? 5 : 0);
  if (!alpha) {
    cabac_.encode_bin(pc[0], 0);  // log2_res_scale_abs_plus1 == 0
    return;
  }
  cabac_.encode_bin(pc[0], 1);
  int a = alpha < 0 ? -alpha : alpha;
  int sym = a == 1 ? 0 : (a == 2 ? 1 : (a == 4 ? 2 : 3));
  cabac_.encode_bin(pc[1], sym ? 1 : 0);
  if (sym) {
    cabac_.encode_bin(pc[2], sym > 1 ? 1 : 0);
    if (sym > 1) cabac_.encode_bin(pc[3], sym > 2 ? 1 : 0);
  }
  cabac_.encode_bin(pc[4], alpha < 0 ? 1 : 0);  // res_scale_sign_flag
}

void SliceEncoder::residual(int x0, int y0, int log2, int c_idx) {
  if (g_bin_trace) fprintf(g_bin_trace, "# RES %d %d log2=%d c=%d\n", x0, y0, log2, c_idx);
  int bw4 = sp_.ctu_size / 4;
  bool luma = c_idx == 0;
  int n = 1 << log2;
  const int16_t* plane;
  int pw, px, py;
  if (luma) {
    plane = cur_->coeff_y; pw = sp_.ctu_size;
    px = x0 - ctu_x0_; py = y0 - ctu_y0_;
  } else {
    // chroma coeff planes are (ctu >> csy) rows x (ctu >> csx) cols;
    // 4:2:2 subsamples horizontally only (SubWidthC=2, SubHeightC=1)
    int csx = (sp_.chroma_format == 3) ? 0 : 1;
    int csy = (sp_.chroma_format == 1) ? 1 : 0;
    plane = (c_idx == 1) ? cur_->coeff_cb : cur_->coeff_cr;
    pw = sp_.ctu_size >> csx;
    px = (x0 - ctu_x0_) >> csx; py = (y0 - ctu_y0_) >> csy;
  }
  // mode-dependent scan applies to intra blocks only (7.4.9.11)
  bool blk_intra = sp_.slice_type == 2 ||
      map_at(cur_->pred_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_) == 1;
  int pred_mode = luma
      ? map_at(cur_->luma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_)
      : map_at(cur_->chroma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  // the encoder maps keep the CODED chroma mode (signalling needs it);
  // 4:2:2 scan selection uses the Table 8-3 remapped direction
  if (!luma && sp_.chroma_format == 2)
    pred_mode = CHROMA_422_ANGLE_MAP[pred_mode];
  int scan_idx = blk_intra ? mode_scan_idx(log2, c_idx, pred_mode,
                                           sp_.chroma_format == 3) : 0;
  const auto& scan = g_scans.t[log2 - 2][scan_idx];

  // transform_skip_flag (spec 7.3.8.11, first element of residual_coding;
  // reference TEncSbac::codeTransformSkipFlags, 2 contexts luma/chroma).
  // cu_transquant_bypass blocks (force-all lossless mode) carry no
  // transform_skip_flag and never hide signs (spec 7.3.8.11/7.4.9.11).
  bool tqb = sp_.tq_bypass != 0;
  bool ts = false;
  bool no_sbh = tqb;
  if (sp_.transform_skip_enabled && log2 == 2 && !tqb) {
    ts = (map_at(cur_->tu_depth, bw4, x0 - ctu_x0_, y0 - ctu_y0_) &
          ts_bit_of(c_idx)) != 0;
    cabac_.encode_bin(ctx_.transform_skip[luma ? 0 : 1], ts ? 1 : 0);
  }
  // explicit RDPCM on inter TS/bypass TBs (range extensions; decoder
  // mirror at SliceDecoder::residual): flag + direction from the rext
  // decision bits at the TB origin (0x01/0x02 Y, 0x04/0x08 Cb,
  // 0x10/0x20 Cr; dir bit 1 = vertical)
  if ((ts || tqb) && sp_.explicit_rdpcm && !blk_intra) {
    int ch = luma ? 0 : 1;
    int shift = luma ? 0 : (c_idx == 1 ? 2 : 4);
    int bits = cur_->rext
        ? (map_at(cur_->rext, bw4, x0 - ctu_x0_, y0 - ctu_y0_) >> shift)
        : 0;
    int on = bits & 1;
    cabac_.encode_bin(ctx_.explicit_rdpcm_flag[ch], on);
    if (on) {
      cabac_.encode_bin(ctx_.explicit_rdpcm_dir[ch], (bits >> 1) & 1);
      no_sbh = true;
    }
  }

  // last significant position
  int last_pos = -1;
  for (int i = n * n - 1; i >= 0; --i)
    if (plane[(py + scan[i] / n) * pw + px + scan[i] % n]) { last_pos = i; break; }
  assert(last_pos >= 0);
  int lx = scan[last_pos] % n, ly = scan[last_pos] / n;
  if (scan_idx == 2) std::swap(lx, ly);

  ContextModel* lastx = luma ? ctx_.last_x : ctx_.last_x + 15;
  ContextModel* lasty = luma ? ctx_.last_y : ctx_.last_y + 15;
  int ctx_offset = luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
  int ctx_shift = luma ? (log2 + 1) >> 2 : log2 - 2;
  int cmax = (log2 << 1) - 1;
  int gx = kGroupIdx[lx], gy = kGroupIdx[ly];
  for (int b = 0; b < gx; ++b)
    cabac_.encode_bin(lastx[ctx_offset + (b >> ctx_shift)], 1);
  if (gx < cmax) cabac_.encode_bin(lastx[ctx_offset + (gx >> ctx_shift)], 0);
  for (int b = 0; b < gy; ++b)
    cabac_.encode_bin(lasty[ctx_offset + (b >> ctx_shift)], 1);
  if (gy < cmax) cabac_.encode_bin(lasty[ctx_offset + (gy >> ctx_shift)], 0);
  if (gx > 3) cabac_.encode_bypass_bins(lx - kMinInGroup[gx], (gx >> 1) - 1);
  if (gy > 3) cabac_.encode_bypass_bins(ly - kMinInGroup[gy], (gy >> 1) - 1);

  // sub-block loop
  int nsb = 1 << (2 * (log2 - 2));
  int sb_w = n >> 2;
  std::vector<uint8_t> csbf(nsb, 0);
  auto sb_of = [&](int i) {  // subblock scan index -> (xS, yS)
    int r = scan[i * 16];  // first inner pos of subblock i
    return std::make_pair((r % n) >> 2, (r / n) >> 2);
  };
  for (int i = 0; i < nsb; ++i) {
    for (int k = 0; k < 16; ++k) {
      int r = scan[i * 16 + k];
      if (plane[(py + r / n) * pw + px + r % n]) { csbf[i] = 1; break; }
    }
  }
  int last_sb = last_pos >> 4;
  // coded_sub_block_flag is inferred 1 for the DC sub-block and the one
  // containing the last coefficient: both are always processed.
  csbf[0] = 1;
  csbf[last_sb] = 1;
  if (g_bin_trace) fprintf(g_bin_trace, "# lastpos %d (x=%d y=%d) lastsb %d\n", last_pos, lx, ly, last_sb);
  auto csbf_at = [&](int xs, int ys) -> int {
    if (xs >= sb_w || ys >= sb_w) return 0;
    // find subblock scan index for (xs,ys): search (small n)
    for (int i = 0; i < nsb; ++i) {
      auto p = sb_of(i);
      if (p.first == xs && p.second == ys) return csbf[i];
    }
    return 0;
  };
  int c1 = 1;
  for (int i = last_sb; i >= 0; --i) {
    auto sbp = sb_of(i);
    int xs = sbp.first, ys = sbp.second;
    int right = csbf_at(xs + 1, ys), below = csbf_at(xs, ys + 1);
    if (i < last_sb && i > 0) {
      int ctxi = (right || below) ? 1 : 0;
      cabac_.encode_bin(ctx_.sig_cg[(luma ? 0 : 2) + ctxi], csbf[i]);
    }
    if (!csbf[i]) continue;

    int infer_dc = (i < last_sb && i > 0) ? 1 : 0;
    SigCoeff coeffs[16];
    int num = 0;
    int start = (i == last_sb) ? (last_pos & 15) : 15;
    if (i == last_sb) {  // the last coeff itself: sig inferred
      int r = scan[last_pos];
      coeffs[num++] = {last_pos, plane[(py + r / n) * pw + px + r % n]};
    }
    for (int k = start - (i == last_sb ? 1 : 0); k >= 0; --k) {
      int pos = i * 16 + k;
      int r = scan[pos];
      int16_t v = plane[(py + r / n) * pw + px + r % n];
      int sig = v != 0;
      if (k > 0 || !infer_dc) {
        int xc = r % n, yc = r / n;
        int sctx = (sp_.ts_context && (ts || tqb))
                       ? (luma ? 27 : 15)
                       : sig_ctx_inc(log2, scan_idx, xc, yc, right, below,
                                     luma);
        cabac_.encode_bin(ctx_.sig[(luma ? 0 : 28) + sctx], sig);
        if (sig) infer_dc = 0;
      }
      if (sig) coeffs[num++] = {pos, v};
    }

    if (num == 0) continue;  // inferred-coded DC sub-block with no coeffs
    if (g_bin_trace) fprintf(g_bin_trace, "# sb %d num %d -> gt1\n", i, num);

    // greater1 / greater2
    int ctx_set = (i > 0 && luma) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int first_gt1 = -1;
    int gt1v[16] = {0};
    int num_c1 = std::min(num, 8);
    for (int k = 0; k < num_c1; ++k) {
      int gt1 = std::abs(coeffs[k].val) > 1;
      gt1v[k] = gt1;
      cabac_.encode_bin(ctx_.one[(luma ? 0 : 16) + 4 * ctx_set + c1], gt1);
      if (gt1) { c1 = 0; if (first_gt1 < 0) first_gt1 = k; }
      else if (c1 < 3 && c1 > 0) c1++;
    }
    int gt2 = 0;
    if (first_gt1 >= 0) {
      gt2 = std::abs(coeffs[first_gt1].val) > 2;
      cabac_.encode_bin(ctx_.abs_[(luma ? 0 : 4) + ctx_set], gt2);
    }
    // RExt CABAC bypass alignment: snap the range to 256 before the
    // CG's bypass run when escape data is present (mirror of the
    // decoder / reference escapeDataPresentInGroup)
    if (sp_.bypass_align) {
      bool escape = num > 8 || gt2 != 0;
      for (int k = 0; k < num_c1 && !escape; ++k)
        if (gt1v[k] && k != first_gt1) escape = true;
      if (escape) cabac_.align();
    }

    // signs (with optional sign-data hiding)
    if (g_bin_trace) fprintf(g_bin_trace, "# sb %d signs\n", i);
    int first_nz_k = coeffs[num - 1].pos & 15;  // lowest scan pos in sb
    int last_nz_k = coeffs[0].pos & 15;
    bool hide = sp_.sign_hiding && !no_sbh &&
                (last_nz_k - first_nz_k > 3);
    for (int k = 0; k < num; ++k) {
      if (hide && k == num - 1) break;  // hidden sign: parity conveys it
      cabac_.encode_bypass(coeffs[k].val < 0 ? 1 : 0);
    }

    // remaining levels; persistent Golomb-Rice adaptation (RExt) mirrors
    // the decoder: per-class statistic seeds the CG's rice parameter,
    // the first escape value updates it, in-CG increment uncapped
    if (g_bin_trace) fprintf(g_bin_trace, "# sb %d remaining\n", i);
    int stat_idx = (luma ? 2 : 0) + ((ts || tqb) ? 1 : 0);
    int first_coeff2 = 1;
    int rice = sp_.persistent_rice ? (int)(ctx_.rice_stat[stat_idx] >> 2)
                                   : 0;
    bool update_stat = sp_.persistent_rice != 0;
    for (int k = 0; k < num; ++k) {
      int av = std::abs(coeffs[k].val);
      int base = (k < 8) ? (2 + first_coeff2) : 1;
      if (av >= base) {
        int rem = av - base;
        // coeff_abs_level_remaining binarization (spec 9.3.3.9)
        if (rem < (3 << rice)) {
          int len = rem >> rice;
          cabac_.encode_bypass_bins((1u << (len + 1)) - 2, len + 1);
          cabac_.encode_bypass_bins(rem & ((1 << rice) - 1), rice);
        } else {
          int len = rice;
          int val = rem - (3 << rice);
          while (val >= (1 << len)) { val -= 1 << len; len++; }
          int ones = 3 + len + 1 - rice;
          cabac_.encode_bypass_bins((1u << ones) - 2, ones);
          cabac_.encode_bypass_bins(val, len);
        }
        if (av > (3 << rice))
          rice = sp_.persistent_rice ? rice + 1 : std::min(rice + 1, 4);
        if (update_stat) {
          int init_rice = (int)(ctx_.rice_stat[stat_idx] >> 2);
          if (rem >= (3 << init_rice))
            ctx_.rice_stat[stat_idx]++;
          else if (2 * rem < (1 << init_rice) &&
                   ctx_.rice_stat[stat_idx] > 0)
            ctx_.rice_stat[stat_idx]--;
          update_stat = false;
        }
      }
      if (av >= 2) first_coeff2 = 0;
    }
  }
}


// ===========================================================================
// Exact RDOQ (reference TComTrQuant::xRateDistOptQuant:2129, re-derived).
// Rates are context-exact fractional bits read from kEntropyBits on the
// supplied (slice-init) context states; the gt1/gt2 context counters, the
// Golomb-Rice parameter and the coefficient-group flags evolve along the
// scan exactly as the residual writer above codes them.
// ===========================================================================
namespace {

inline double ctx_bits(const ContextModel& c, int bin) {
  return kEntropyBits[(((int)c.state << 1) | c.mps) ^ bin] / 32768.0;
}

// coeff_abs_level_remaining EP bits (mirror of the writer, spec 9.3.3.9)
inline int eg_rice_bits(int rem, int rice) {
  if (rem < (3 << rice)) return (rem >> rice) + 1 + rice;
  int len = rice;
  int val = rem - (3 << rice);
  while (val >= (1 << len)) { val -= 1 << len; ++len; }
  return (3 + len + 1 - rice) + len;
}

// rate in bits of coding |level| > 0 given the gt1/gt2 context models and
// the in-group counters (k = number of earlier nonzero coeffs in the CG,
// c2done = a gt2 flag was already coded in this CG)
inline double level_rate(int level, const ContextModel& one_ctx,
                         const ContextModel& abs_ctx, int k, bool c2done,
                         int rice) {
  double r = 1.0;  // sign (EP; SBH recovers most of it later)
  if (k < 8) {
    int base = c2done ? 2 : 3;
    if (level >= base) {
      r += ctx_bits(one_ctx, 1);
      if (!c2done) r += ctx_bits(abs_ctx, 1);
      r += eg_rice_bits(level - base, rice);
    } else if (level == 1) {
      r += ctx_bits(one_ctx, 0);
    } else {  // level == 2, a gt2 flag still available
      r += ctx_bits(one_ctx, 1) + ctx_bits(abs_ctx, 0);
    }
  } else {
    r += eg_rice_bits(level - 1, rice);
  }
  return r;
}

}  // namespace

int rdoq_quant(const ContextSet& cs, const int32_t* coef, int32_t* lev,
               int log2, int c_idx, int scan_idx, int qp, int bd,
               double lambda, const int32_t* smat) {
  const int n = 1 << log2;
  const bool luma = c_idx == 0;
  const auto& scan = g_scans.t[log2 - 2][scan_idx];
  const int qpp = qp + 6 * (bd - 8);
  const int tshift = 15 - bd - log2;
  const int qbits = 14 + qpp / 6 + tshift;
  static const int32_t kQScale[6] = {26214, 23302, 20560, 18396, 16384,
                                     14564};
  static const int32_t kIQScale[6] = {40, 45, 51, 57, 64, 72};
  const int64_t qscale = kQScale[qpp % 6];
  const int bd_shift = bd + log2 - 5;
  const int64_t iqs = (int64_t)kIQScale[qpp % 6] << (qpp / 6);
  const int64_t iround = 1ll << (bd_shift - 1);
  const double dscale = tshift >= 0 ? 1.0 / (double)(1ll << (2 * tshift))
                                    : (double)(1ll << (-2 * tshift));
  auto deq = [&](int64_t l, int r) {
    int64_t mi = smat ? smat[r] : 16;
    int64_t c = (l * mi * iqs + iround) >> bd_shift;
    return std::min<int64_t>(32767, std::max<int64_t>(-32768, c));
  };
  auto dist_of = [&](int64_t e) { return (double)e * (double)e * dscale; };

  const int nn = n * n;
  std::fill(lev, lev + nn, 0);
  // per-position max candidate level (half-offset rounding, like the
  // reference RDOQ's lLevelDouble path)
  int maxlev[1024];
  int last_scan = -1;
  if (!smat) {
    // uniform scale: the smallest |coef| that quantizes to a nonzero
    // level is a constant, so the last candidate position falls out of
    // a compare-only backward scan; the multiply-quant then runs only
    // over the live prefix (most TBs are sparse)
    int64_t cmin = ((1ll << (qbits - 1)) + qscale - 1) / qscale;
    for (int i = nn - 1; i >= 0; --i)
      if (std::abs((int64_t)coef[scan[i]]) >= cmin) { last_scan = i; break; }
    if (last_scan < 0) return 0;
    for (int i = 0; i <= last_scan; ++i) {
      int64_t c = std::abs((int64_t)coef[scan[i]]);
      maxlev[i] = (int)std::min<int64_t>(
          32767, (c * qscale + (1ll << (qbits - 1))) >> qbits);
    }
  } else {
    for (int i = 0; i < nn; ++i) {
      int r = scan[i];
      int64_t c = std::abs((int64_t)coef[r]);
      int64_t sc = (qscale * 16) / std::max(1, (int)smat[r]);
      int64_t l = (c * sc + (1ll << (qbits - 1))) >> qbits;
      maxlev[i] = (int)std::min<int64_t>(32767, l);
      if (maxlev[i]) last_scan = i;
    }
    if (last_scan < 0) return 0;
  }

  const int last_sb = last_scan >> 4;
  const int sb_w = n >> 2;
  uint8_t csbf[64] = {0};
  auto sb_xy = [&](int sb) {
    int r = scan[sb * 16];
    return std::make_pair((r % n) >> 2, (r / n) >> 2);
  };
  // O(1) coded-subblock-flag lookup via the static (xs, ys) -> scan
  // index inverse (the old linear scan re-derived every subblock's
  // coordinates per query — quadratic in subblock count per TB)
  const uint8_t* sbinv = g_sbinv.t[log2 - 2][scan_idx].data();
  auto csbf_at = [&](int xs, int ys) -> int {
    if (xs >= sb_w || ys >= sb_w || xs < 0 || ys < 0) return 0;
    return csbf[sbinv[ys * sb_w + xs]];
  };

  double cost_coeff[1024], cost_sig[1024], cost_zero[1024];
  double block_uncoded = 0;
  for (int i = 0; i <= last_scan; ++i) {
    int64_t c = std::abs((int64_t)coef[scan[i]]);
    cost_zero[i] = dist_of(c);
    cost_coeff[i] = cost_zero[i];
    cost_sig[i] = 0;
    block_uncoded += cost_zero[i];
  }

  const ContextModel* one_base = cs.one + (luma ? 0 : 16);
  const ContextModel* abs_base = cs.abs_ + (luma ? 0 : 4);
  const ContextModel* sig_base = cs.sig + (luma ? 0 : 28);
  const ContextModel* cg_base = cs.sig_cg + (luma ? 0 : 2);

  bool found_last = false;
  int c1 = 1;
  double total = 0;  // cost of coded decisions (positions <= actual last)

  for (int sb = last_sb; sb >= 0; --sb) {
    auto sp = sb_xy(sb);
    int right = csbf_at(sp.first + 1, sp.second);
    int below = csbf_at(sp.first, sp.second + 1);
    int ctx_set = (sb > 0 && luma) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int k = 0;          // nonzero coefficients decided in this CG
    bool c2done = false;
    int rice = 0;
    double cg_cost = 0, cg_zero = 0;
    int cg_nz = 0;
    int top = (sb == last_sb) ? (last_scan & 15) : 15;
    for (int kk = top; kk >= 0; --kk) {
      int i = sb * 16 + kk;
      int r = scan[i];
      int xc = r % n, yc = r / n;
      int64_t c = std::abs((int64_t)coef[r]);
      int sctx = sig_ctx_inc(log2, scan_idx, xc, yc, right, below, luma);
      double sig0 = lambda * ctx_bits(sig_base[sctx], 0);
      double sig1 = lambda * ctx_bits(sig_base[sctx], 1);
      int ml = maxlev[i];
      if (!found_last) {
        if (ml == 0) { total += cost_zero[i]; cg_zero += cost_zero[i];
                       cg_cost += cost_zero[i]; continue; }
        // candidate last coefficient: no sig bit
        double best = cost_zero[i];
        int best_l = 0;
        for (int l = ml; l >= ml - 1 && l > 0; --l) {
          double cost = dist_of(c - deq(l, r)) +
                        lambda * level_rate(l, one_base[4 * ctx_set + c1],
                                            abs_base[ctx_set], k, c2done,
                                            rice);
          if (cost < best) { best = cost; best_l = l; }
        }
        if (best_l == 0) { total += cost_zero[i]; cg_zero += cost_zero[i];
                           cg_cost += cost_zero[i]; continue; }
        found_last = true;
        lev[r] = coef[r] < 0 ? -best_l : best_l;
        cost_coeff[i] = best;
        cost_sig[i] = 0;
      } else {
        double best = cost_zero[i] + sig0;
        int best_l = 0;
        for (int l = ml; l >= ml - 1 && l > 0; --l) {
          double cost = dist_of(c - deq(l, r)) + sig1 +
                        lambda * level_rate(l, one_base[4 * ctx_set + c1],
                                            abs_base[ctx_set], k, c2done,
                                            rice);
          if (cost < best) { best = cost; best_l = l; }
        }
        lev[r] = coef[r] < 0 ? -best_l : best_l;
        cost_coeff[i] = best;
        cost_sig[i] = best_l ? sig1 : sig0;
      }
      int al = std::abs(lev[r]);
      if (al) {
        ++cg_nz;
        // evolve gt1 context, gt2 availability and the rice parameter
        // exactly like the residual writer above
        if (k < 8) {
          if (al > 1) c1 = 0;
          else if (c1 < 3 && c1 > 0) c1++;
        }
        int base = (k < 8) ? (c2done ? 2 : 3) : 1;
        if (al >= base && al > (3 << rice)) rice = std::min(rice + 1, 4);
        if (al >= 2) c2done = true;
        ++k;
      }
      cg_cost += cost_coeff[i];
      cg_zero += cost_zero[i];
      total += cost_coeff[i];
    }
    csbf[sb] = cg_nz > 0;
    // coefficient-group zeroing (signalled CGs only)
    if (sb > 0 && sb < last_sb) {
      double bits1 = lambda * ctx_bits(cg_base[(right || below) ? 1 : 0], 1);
      double bits0 = lambda * ctx_bits(cg_base[(right || below) ? 1 : 0], 0);
      if (cg_nz == 0) {
        total += bits0;
      } else if (cg_zero + bits0 < cg_cost + bits1) {
        for (int kk = 15; kk >= 0; --kk) {
          int i = sb * 16 + kk;
          lev[scan[i]] = 0;
          total += cost_zero[i] - cost_coeff[i];
          cost_coeff[i] = cost_zero[i];
          cost_sig[i] = 0;
        }
        csbf[sb] = 0;
        total += bits0;
      } else {
        total += bits1;
      }
    }
  }

  // last-position sweep: pick the nonzero position whose selection as the
  // last coefficient minimises total cost (positions above it become
  // uncoded zeros); compare against coding nothing at all.
  auto last_bits = [&](int pos) {
    int lx = pos % n, ly = pos / n;
    if (scan_idx == 2) std::swap(lx, ly);
    const ContextModel* lastx = luma ? cs.last_x : cs.last_x + 15;
    const ContextModel* lasty = luma ? cs.last_y : cs.last_y + 15;
    int ctx_offset = luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
    int ctx_shift = luma ? (log2 + 1) >> 2 : log2 - 2;
    int cmax = (log2 << 1) - 1;
    int gx = kGroupIdx[lx], gy = kGroupIdx[ly];
    double b = 0;
    for (int bb = 0; bb < gx; ++bb)
      b += ctx_bits(lastx[ctx_offset + (bb >> ctx_shift)], 1);
    if (gx < cmax) b += ctx_bits(lastx[ctx_offset + (gx >> ctx_shift)], 0);
    for (int bb = 0; bb < gy; ++bb)
      b += ctx_bits(lasty[ctx_offset + (bb >> ctx_shift)], 1);
    if (gy < cmax) b += ctx_bits(lasty[ctx_offset + (gy >> ctx_shift)], 0);
    if (gx > 3) b += (gx >> 1) - 1;
    if (gy > 3) b += (gy >> 1) - 1;
    return b;
  };

  double best = block_uncoded;        // cbf = 0
  int best_last = -1;
  double base = total;
  for (int i = last_scan; i >= 0; --i) {
    int r = scan[i];
    if (lev[r]) {
      double cand = base - cost_sig[i] + lambda * last_bits(r);
      if (cand < best) { best = cand; best_last = i; }
      base += cost_zero[i] - cost_coeff[i];
    } else {
      base -= cost_sig[i];
      base += cost_zero[i] - cost_coeff[i];
    }
  }
  if (best_last < 0) { std::fill(lev, lev + nn, 0); return 0; }
  int nz = 0;
  for (int i = 0; i <= last_scan; ++i) {
    int r = scan[i];
    if (i > best_last) lev[r] = 0;
    if (lev[r]) ++nz;
  }
  return nz;
}

double ctx_rate(const ContextModel& c, int bin) {
  return kEntropyBits[(((int)c.state << 1) | c.mps) ^ bin] / 32768.0;
}

namespace {
// counting twin of CabacEncoder::encode_bin: accumulates the fractional
// bits AND evolves the context state (TEncBinCABACCounter semantics)
struct RateCounter {
  double bits = 0;
  void bin(ContextModel& c, int b) {
    bits += kEntropyBits[(((int)c.state << 1) | c.mps) ^ b] / 32768.0;
    if (b != c.mps) {
      if (c.state == 0) c.mps = 1 - c.mps;
      c.state = kTransIdxLps[c.state];
    } else if (c.state < 62) {
      c.state++;
    }
  }
  void ep(int n) { bits += n; }
};
}  // namespace

double tb_rate_bits(const ContextSet& cs_in, const int32_t* lev, int stride,
                    int log2, int c_idx, int scan_idx, int sign_hiding) {
  ContextSet ctx = cs_in;
  RateCounter rc;
  const bool luma = c_idx == 0;
  const int n = 1 << log2;
  const auto& scan = g_scans.t[log2 - 2][scan_idx];
  auto at = [&](int r) { return lev[(r / n) * stride + (r % n)]; };

  int last_pos = -1;
  for (int i = n * n - 1; i >= 0; --i)
    if (at(scan[i])) { last_pos = i; break; }
  if (last_pos < 0) return 0.0;
  int lx = scan[last_pos] % n, ly = scan[last_pos] / n;
  if (scan_idx == 2) std::swap(lx, ly);

  ContextModel* lastx = luma ? ctx.last_x : ctx.last_x + 15;
  ContextModel* lasty = luma ? ctx.last_y : ctx.last_y + 15;
  int ctx_offset = luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
  int ctx_shift = luma ? (log2 + 1) >> 2 : log2 - 2;
  int cmax = (log2 << 1) - 1;
  int gx = kGroupIdx[lx], gy = kGroupIdx[ly];
  for (int b = 0; b < gx; ++b)
    rc.bin(lastx[ctx_offset + (b >> ctx_shift)], 1);
  if (gx < cmax) rc.bin(lastx[ctx_offset + (gx >> ctx_shift)], 0);
  for (int b = 0; b < gy; ++b)
    rc.bin(lasty[ctx_offset + (b >> ctx_shift)], 1);
  if (gy < cmax) rc.bin(lasty[ctx_offset + (gy >> ctx_shift)], 0);
  if (gx > 3) rc.ep((gx >> 1) - 1);
  if (gy > 3) rc.ep((gy >> 1) - 1);

  int nsb = 1 << (2 * (log2 - 2));
  int sb_w = n >> 2;
  uint8_t csbf[64] = {0};
  auto sb_of = [&](int i) {
    int r = scan[i * 16];
    return std::make_pair((r % n) >> 2, (r / n) >> 2);
  };
  for (int i = 0; i < nsb; ++i)
    for (int k = 0; k < 16; ++k)
      if (at(scan[i * 16 + k])) { csbf[i] = 1; break; }
  int last_sb = last_pos >> 4;
  csbf[0] = 1;
  csbf[last_sb] = 1;
  auto csbf_at = [&](int xs, int ys) -> int {
    if (xs >= sb_w || ys >= sb_w) return 0;
    for (int i = 0; i < nsb; ++i) {
      auto p = sb_of(i);
      if (p.first == xs && p.second == ys) return csbf[i];
    }
    return 0;
  };
  struct SC { int pos; int32_t val; };
  int c1 = 1;
  for (int i = last_sb; i >= 0; --i) {
    auto sbp = sb_of(i);
    int xs = sbp.first, ys = sbp.second;
    int right = csbf_at(xs + 1, ys), below = csbf_at(xs, ys + 1);
    if (i < last_sb && i > 0)
      rc.bin(ctx.sig_cg[(luma ? 0 : 2) + ((right || below) ? 1 : 0)],
             csbf[i]);
    if (!csbf[i]) continue;

    int infer_dc = (i < last_sb && i > 0) ? 1 : 0;
    SC coeffs[16];
    int num = 0;
    int start = (i == last_sb) ? (last_pos & 15) : 15;
    if (i == last_sb) coeffs[num++] = {last_pos, at(scan[last_pos])};
    for (int k = start - (i == last_sb ? 1 : 0); k >= 0; --k) {
      int pos = i * 16 + k;
      int r = scan[pos];
      int32_t v = at(r);
      int sig = v != 0;
      if (k > 0 || !infer_dc) {
        int xc = r % n, yc = r / n;
        int sctx = sig_ctx_inc(log2, scan_idx, xc, yc, right, below,
                               luma);
        rc.bin(ctx.sig[(luma ? 0 : 28) + sctx], sig);
        if (sig) infer_dc = 0;
      }
      if (sig) coeffs[num++] = {pos, v};
    }
    if (num == 0) continue;

    int ctx_set = (i > 0 && luma) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int first_gt1 = -1;
    int num_c1 = std::min(num, 8);
    for (int k = 0; k < num_c1; ++k) {
      int gt1 = std::abs(coeffs[k].val) > 1;
      rc.bin(ctx.one[(luma ? 0 : 16) + 4 * ctx_set + c1], gt1);
      if (gt1) { c1 = 0; if (first_gt1 < 0) first_gt1 = k; }
      else if (c1 < 3 && c1 > 0) c1++;
    }
    if (first_gt1 >= 0)
      rc.bin(ctx.abs_[(luma ? 0 : 4) + ctx_set],
             std::abs(coeffs[first_gt1].val) > 2);

    int first_nz_k = coeffs[num - 1].pos & 15;
    int last_nz_k = coeffs[0].pos & 15;
    bool hide = sign_hiding && (last_nz_k - first_nz_k > 3);
    rc.ep(hide ? num - 1 : num);

    int first_coeff2 = 1, rice = 0;
    for (int k = 0; k < num; ++k) {
      int av = std::abs(coeffs[k].val);
      int base = (k < 8) ? (2 + first_coeff2) : 1;
      if (av >= base) {
        int rem = av - base;
        if (rem < (3 << rice)) {
          rc.ep((rem >> rice) + 1 + rice);
        } else {
          int len = rice;
          int val = rem - (3 << rice);
          while (val >= (1 << len)) { val -= 1 << len; len++; }
          rc.ep((3 + len + 1 - rice) + len);
        }
        if (av > (3 << rice)) rice = std::min(rice + 1, 4);
      }
      if (av >= 2) first_coeff2 = 0;
    }
  }
  return rc.bits;
}

// ===========================================================================
// SliceDecoder
// ===========================================================================
SliceDecoder::SliceDecoder(const SliceParams& sp, const uint8_t* data,
                           size_t size)
    : sp_(sp), br_(data, size), cabac_(&br_) {
  maps_.init(sp);
  ctx_.init(ctx_init_type(sp_), sp_.qp);
}

void SliceDecoder::begin_slice() {}

void SliceDecoder::reseat(const uint8_t* data, size_t size) {
  br_ = BitReader(data, size);
  cabac_ = CabacDecoder(&br_);
  // per-segment substream bookkeeping (tiles/WPP entry points) restarts
  sub_offsets_.clear();
  next_sub_ = 1;
  // a tile starting at this segment has no end_of_subset_one_bit to
  // consume and the engine is already seated at the segment start
  seg_fresh_ = true;
  stat_mark_ = 0;  // bit accounting restarts with the new buffer
}

void SliceDecoder::fill(uint8_t* map, int x0, int y0, int log2, uint8_t v) {
  int bw4 = sp_.ctu_size / 4;
  int b = 1 << (log2 - 2);
  int bx = (x0 - ctu_x0_) >> 2, by = (y0 - ctu_y0_) >> 2;
  for (int yy = 0; yy < b; ++yy)
    for (int xx = 0; xx < b; ++xx)
      map[(by + yy) * bw4 + bx + xx] = v;
}

void SliceDecoder::fill16(int16_t* map, int x0, int y0, int log2, int16_t v) {
  int bw4 = sp_.ctu_size / 4;
  int b = 1 << (log2 - 2);
  int bx = (x0 - ctu_x0_) >> 2, by = (y0 - ctu_y0_) >> 2;
  for (int yy = 0; yy < b; ++yy)
    for (int xx = 0; xx < b; ++xx)
      map[(by + yy) * bw4 + bx + xx] = v;
}

int SliceDecoder::decode_ctu(int cx, int cy, const MutCtuData& d) {
  if (g_bin_trace) fprintf(g_bin_trace, "# CTU %d %d\n", cx, cy);
  cur_ = &d;
  ctu_x0_ = cx * sp_.ctu_size;
  ctu_y0_ = cy * sp_.ctu_size;
  int ctus_w_pic = (sp_.pic_w + sp_.ctu_size - 1) / sp_.ctu_size;
  if (sp_.tile_cols > 1 || sp_.tile_rows > 1) {
    int tid = tile_id_of(sp_, cx, cy);
    if (tid != cur_tile_) {
      if (cur_tile_ >= 0 && !seg_fresh_) {
        cabac_.decode_terminate();  // end_of_subset_one_bit of prev tile
        if ((size_t)(next_sub_ - 1) < sub_offsets_.size())
          cabac_.restart_at((size_t)sub_offsets_[next_sub_ - 1]);
        ++next_sub_;
      }
      ctx_.init(ctx_init_type(sp_), sp_.qp);
      cur_tile_ = tid;
      dqp_first_ = true;  // qPY_PREV resets at tile start (spec 8.6.1)
    }
  }
  seg_fresh_ = false;
  if (sp_.wpp && cx == 0 && cy > 0) {
    dqp_first_ = true;  // qPY_PREV resets per CTB row under WPP
    if (wpp_saved_valid_)
      ctx_ = wpp_saved_;
    else
      ctx_.init(ctx_init_type(sp_), sp_.qp);
    if ((size_t)(next_sub_ - 1) < sub_offsets_.size())
      cabac_.restart_at((size_t)sub_offsets_[next_sub_ - 1]);
    ++next_sub_;
  }
  int bw4 = sp_.ctu_size / 4;
  std::memset(d.cu_depth, 0, bw4 * bw4);
  std::memset(d.nxn_flag, 0, bw4 * bw4);
  std::memset(d.luma_mode, 1, bw4 * bw4);
  std::memset(d.chroma_mode, 1, bw4 * bw4);
  std::memset(d.tu_depth, 0, bw4 * bw4);
  std::memset(d.pred_mode, 1, bw4 * bw4);
  std::memset(d.skip_flag, 0, bw4 * bw4);
  std::memset(d.merge_flag, 0, bw4 * bw4);
  std::memset(d.merge_idx, 0, bw4 * bw4);
  std::memset(d.mvp_flag, 0, bw4 * bw4);
  std::memset(d.ref_idx, 0xFF, bw4 * bw4);  // -1
  std::memset(d.mvd_x, 0, sizeof(int16_t) * bw4 * bw4);
  std::memset(d.mvd_y, 0, sizeof(int16_t) * bw4 * bw4);
  std::memset(d.mv_x, 0, sizeof(int16_t) * bw4 * bw4);
  std::memset(d.mv_y, 0, sizeof(int16_t) * bw4 * bw4);
  if (d.mv_x1) {
    std::memset(d.mvp_flag1, 0, bw4 * bw4);
    std::memset(d.ref_idx1, 0xFF, bw4 * bw4);
    std::memset(d.mvd_x1, 0, sizeof(int16_t) * bw4 * bw4);
    std::memset(d.mvd_y1, 0, sizeof(int16_t) * bw4 * bw4);
    std::memset(d.mv_x1, 0, sizeof(int16_t) * bw4 * bw4);
    std::memset(d.mv_y1, 0, sizeof(int16_t) * bw4 * bw4);
  }
  std::memset(d.coeff_y, 0, sizeof(int16_t) * sp_.ctu_size * sp_.ctu_size);
  std::memset(d.coeff_cb, 0, sizeof(int16_t) * (sp_.ctu_size / 2) * (sp_.ctu_size / 2));
  std::memset(d.coeff_cr, 0, sizeof(int16_t) * (sp_.ctu_size / 2) * (sp_.ctu_size / 2));
  if (sp_.sao_luma || sp_.sao_chroma) parse_sao(cx, cy, d.sao);
  else if (d.sao) std::fill(d.sao, d.sao + 20, 0);
  if (sp_.cu_dqp) {
    last_qp_ = dqp_first_ ? sp_.qp : dqp_carried_;
    dqp_first_ = false;
    int bw4 = sp_.ctu_size / 4;
    qp4_.assign((size_t)bw4 * bw4, (int8_t)last_qp_);
    qg_ref_ = last_qp_;
    dqp_target_ = last_qp_;
    dqp_coded_ = false;
    ctu_qp_pred.push_back((int8_t)last_qp_);
  }
  cu_tree(ctu_x0_, ctu_y0_, sp_.max_cb_log2, 0);
  if (sp_.cu_dqp) {
    dqp_carried_ = last_qp_;
    ctu_qp_final.push_back((int8_t)dqp_carried_);
  }
  if (sp_.wpp && cx == 1) {
    // snapshot after the second CTB of the row is decoded (spec 9.3.1),
    // mirroring the encoder's save point
    wpp_saved_ = ctx_;
    wpp_saved_valid_ = true;
  }
  int eos = cabac_.decode_terminate();
  if (sp_.wpp && cx == ctus_w_pic - 1 && !eos)
    cabac_.decode_terminate();  // end_of_subset_one_bit; the engine is
                                // re-seated at the next entry point on the
                                // following row's first CTU
  cur_ = nullptr;
  return eos;
}

void SliceDecoder::cu_tree(int x0, int y0, int log2, int depth) {
  if (x0 >= sp_.pic_w || y0 >= sp_.pic_h) return;
  int size = 1 << log2;
  bool boundary = (x0 + size > sp_.pic_w) || (y0 + size > sp_.pic_h);
  bool split = false;
  if (log2 > sp_.min_cb_log2) {
    if (boundary) {
      split = true;
    } else {
      int ctxi = 0;
      if (maps_.available(x0 - 1, y0, x0, y0) &&
          maps_.cu_depth[maps_.idx(x0 - 1, y0)] > depth) ctxi++;
      if (maps_.available(x0, y0 - 1, x0, y0) &&
          maps_.cu_depth[maps_.idx(x0, y0 - 1)] > depth) ctxi++;
      stat(ST_SPLIT_CU);
      split = cabac_.decode_bin(ctx_.split_cu[ctxi]);
    }
  }
  // Quantization-group boundary (spec 7.3.8.4 coding_quadtree resets of
  // IsCuQpDeltaCoded; reference TDecCu::xDecodeCU): a new QG starts at a
  // split node of exactly QG size, or at a leaf CU of >= QG size.
  int qg_log2 = sp_.max_cb_log2 - sp_.dqp_depth;
  if (split) {
    if (sp_.cu_dqp && log2 == qg_log2) qg_start(x0, y0);
    int h = size >> 1;
    cu_tree(x0, y0, log2 - 1, depth + 1);
    cu_tree(x0 + h, y0, log2 - 1, depth + 1);
    cu_tree(x0, y0 + h, log2 - 1, depth + 1);
    cu_tree(x0 + h, y0 + h, log2 - 1, depth + 1);
    return;
  }
  if (sp_.cu_dqp && log2 >= qg_log2) qg_start(x0, y0);
  parse_cu(x0, y0, log2);
  if (sp_.cu_dqp) {
    // CU finish (reference TDecCu::xFinishDecodeCU): every 4x4 of the
    // CU gets the coded QP once a dqp was parsed in this QG, else the
    // QG prediction; qPY_PREV advances to this CU's QP
    int q = dqp_coded_ ? dqp_target_ : qg_ref_;
    int bw4 = sp_.ctu_size / 4;
    int n = 1 << (log2 - 2);
    int qx = (x0 - ctu_x0_) >> 2, qy = (y0 - ctu_y0_) >> 2;
    for (int yy = 0; yy < n; ++yy)
      std::fill(&qp4_[(size_t)(qy + yy) * bw4 + qx],
                &qp4_[(size_t)(qy + yy) * bw4 + qx + n], (int8_t)q);
    last_qp_ = q;
  }
}

void SliceDecoder::qg_start(int x0, int y0) {
  // New quantization group: reset the coded flag and derive qPY_PRED
  // from the left/above 4x4 neighbours of the QG origin within this CTB
  // (falling back to the last coded QP, spec 8.6.1; reference
  // TComDataCU::getRefQP/getQpMinCuLeft/getQpMinCuAbove).
  dqp_coded_ = false;
  int bw4 = sp_.ctu_size / 4;
  int qx = (x0 - ctu_x0_) >> 2, qy = (y0 - ctu_y0_) >> 2;
  int l = qx > 0 ? qp4_[(size_t)qy * bw4 + qx - 1] : last_qp_;
  int a = qy > 0 ? qp4_[(size_t)(qy - 1) * bw4 + qx] : last_qp_;
  qg_ref_ = (l + a + 1) >> 1;
  dqp_target_ = qg_ref_;
}

void SliceDecoder::publish_motion(int x0, int y0, int log2,
                                  const MotionInfo& mi, int merge_f,
                                  int merge_i, int mvp_f, int mvd_x,
                                  int mvd_y, int skip) {
  fill(cur_->pred_mode, x0, y0, log2, 0);
  fill(cur_->skip_flag, x0, y0, log2, skip);
  fill(cur_->merge_flag, x0, y0, log2, merge_f);
  fill(cur_->merge_idx, x0, y0, log2, merge_i);
  fill(cur_->mvp_flag, x0, y0, log2, mvp_f);
  fill((uint8_t*)cur_->ref_idx, x0, y0, log2, (uint8_t)mi.ref[0]);
  fill16(cur_->mvd_x, x0, y0, log2, (int16_t)mvd_x);
  fill16(cur_->mvd_y, x0, y0, log2, (int16_t)mvd_y);
  fill16(cur_->mv_x, x0, y0, log2, mi.mvx[0]);
  fill16(cur_->mv_y, x0, y0, log2, mi.mvy[0]);
  if (cur_->mv_x1) {
    fill((uint8_t*)cur_->ref_idx1, x0, y0, log2, (uint8_t)mi.ref[1]);
    fill16(cur_->mv_x1, x0, y0, log2, mi.mvx[1]);
    fill16(cur_->mv_y1, x0, y0, log2, mi.mvy[1]);
  }
  int b = 1 << (log2 - 2);
  for (int yy = 0; yy < b; ++yy)
    for (int xx = 0; xx < b; ++xx) {
      size_t pi = ((y0 >> 2) + yy) * maps_.stride + (x0 >> 2) + xx;
      maps_.pred_mode[pi] = 0;
      maps_.skip_flag[pi] = skip;
      for (int l = 0; l < 2; ++l) {
        maps_.mv_x[l][pi] = mi.mvx[l];
        maps_.mv_y[l][pi] = mi.mvy[l];
        maps_.ref_idx[l][pi] = mi.ref[l];
      }
    }
}

int SliceDecoder::parse_merge_idx() {
  stat(ST_MERGE_IDX);
  int cmax = sp_.max_merge_cand - 1;
  if (cmax == 0) return 0;
  if (!cabac_.decode_bin(ctx_.merge_idx[0])) return 0;
  int v = 1;
  while (v < cmax && cabac_.decode_bypass()) v++;
  return v;
}

void SliceDecoder::parse_mvd(int* vx, int* vy) {
  stat(ST_MVD);
  if (g_bin_trace) fprintf(g_bin_trace, "# mvd\n");
  int g0x = cabac_.decode_bin(ctx_.mvd[0]);
  int g0y = cabac_.decode_bin(ctx_.mvd[0]);
  int g1x = g0x ? cabac_.decode_bin(ctx_.mvd[1]) : 0;
  int g1y = g0y ? cabac_.decode_bin(ctx_.mvd[1]) : 0;
  auto eg1 = [&]() {
    int k = 1, v = 0;
    while (cabac_.decode_bypass()) {
      v += 1 << k;
      k++;
    }
    return v + (int)cabac_.decode_bypass_bins(k);
  };
  int ax = 0, ay = 0;
  if (g0x) {
    ax = g1x ? 2 + eg1() : 1;
    if (cabac_.decode_bypass()) ax = -ax;
  }
  if (g0y) {
    ay = g1y ? 2 + eg1() : 1;
    if (cabac_.decode_bypass()) ay = -ay;
  }
  *vx = ax;
  *vy = ay;
}

void SliceDecoder::parse_inter_cu(int x0, int y0, int log2, bool skip) {
  if (g_bin_trace) fprintf(g_bin_trace, "# PCU %d %d log2=%d\n", x0, y0, log2);
  int n = 1 << log2;
  MotionInfo mi;
  if (skip) {
    int mi_idx = parse_merge_idx();
    MotionInfo cands[5];
    maps_.merge_candidates(x0, y0, n, n, cands);
    mi = cands[mi_idx];
    publish_motion(x0, y0, log2, mi, 1, mi_idx, 0, 0, 0, 1);
    return;
  }
  // part_mode (spec 9.3.3.7, incl. AMP binarization)
  int part = 0;
  bool amp_bins = sp_.amp && log2 > sp_.min_cb_log2;  // HM codePartSize: uiDepth < log2DiffMaxMin (64x64 CUs included)
  if (g_bin_trace) fprintf(g_bin_trace, "# part\n");
  stat(ST_PART_SIZE);
  if (!cabac_.decode_bin(ctx_.part_size[0])) {
    bool hor = cabac_.decode_bin(ctx_.part_size[1]);
    if (amp_bins && !cabac_.decode_bin(ctx_.part_size[3])) {
      int second = cabac_.decode_bypass();
      part = hor ? (second ? 5 : 4) : (second ? 7 : 6);
    } else {
      part = hor ? 2 : 3;
    }
  }
  fill(cur_->nxn_flag, x0, y0, log2, (uint8_t)part);
  int npu = part == 0 ? 1 : 2;
  int cu_merge = 1;
  for (int pu = 0; pu < npu; ++pu) {
    int ox, oy, pw, ph;
    pu_rect(part, pu, n, &ox, &oy, &pw, &ph);
    int px = x0 + ox, py = y0 + oy;
    {if (g_bin_trace) fprintf(g_bin_trace, "# pu%d mrgf\n", pu);}
    stat(ST_MERGE_FLAG);
    int merge_f = cabac_.decode_bin(ctx_.merge_flag[0]);
    if (!merge_f) cu_merge = 0;
    int merge_i = 0, mvp_f = 0, mvdx = 0, mvdy = 0;
    MotionInfo pmi;
    if (merge_f) {
      merge_i = parse_merge_idx();
      MotionInfo cands[5];
      maps_.merge_candidates(px, py, pw, ph, cands, part, pu);
      pmi = cands[merge_i];
    } else {
      bool is_b = sp_.slice_type == 0;
      int idc = 1;
      if (is_b) {
        int depth = sp_.max_cb_log2 - log2;
        stat(ST_INTER_DIR);
        int bi = (part == 0 || log2 > 3)
                     ? cabac_.decode_bin(ctx_.inter_dir[depth]) : 0;
        if (bi) idc = 3;
        else idc = cabac_.decode_bin(ctx_.inter_dir[4]) ? 2 : 1;
      }
      auto parse_ref = [&](int num_ref) {
        {if (g_bin_trace) fprintf(g_bin_trace, "# ref nr=%d\n", num_ref);}
        stat(ST_REF_IDX);
        int r = 0;
        if (num_ref > 1 && cabac_.decode_bin(ctx_.ref_idx[0])) {
          r = 1;
          int cmax = num_ref - 1;
          // bin 1 context-coded, bins >= 2 bypass (spec 9.3.4.2.1)
          if (r < cmax && cabac_.decode_bin(ctx_.ref_idx[1])) {
            r = 2;
            while (r < cmax && cabac_.decode_bypass()) r++;
          }
        }
        return r;
      };
      if (idc & 1) {
        int r = parse_ref(sp_.num_ref_l0);
        parse_mvd(&mvdx, &mvdy);
        stat(ST_MVP_IDX);
        mvp_f = cabac_.decode_bin(ctx_.mvp_idx[0]);
        int16_t amvp[4];
        maps_.amvp_candidates(px, py, pw, ph, 0, r, amvp, x0, y0, n, part,
                              pu);
        if (g_bin_trace)
          fprintf(g_bin_trace,
                  "# amvp0 pu(%d,%d %dx%d) r=%d cands (%d,%d)(%d,%d) "
                  "mvpf=%d mvd=(%d,%d)\n", px, py, pw, ph, r, amvp[0],
                  amvp[1], amvp[2], amvp[3], mvp_f, mvdx, mvdy);
        pmi.mvx[0] = (int16_t)(amvp[2 * mvp_f] + mvdx);
        pmi.mvy[0] = (int16_t)(amvp[2 * mvp_f + 1] + mvdy);
        pmi.ref[0] = (int8_t)r;
      }
      if (idc & 2) {
        int r = parse_ref(sp_.num_ref_l1);
        int m1x = 0, m1y = 0;
        if (!(sp_.mvd_l1_zero && idc == 3)) parse_mvd(&m1x, &m1y);
        stat(ST_MVP_IDX);
        int mvp_f1 = cabac_.decode_bin(ctx_.mvp_idx[0]);
        int16_t amvp[4];
        maps_.amvp_candidates(px, py, pw, ph, 1, r, amvp, x0, y0, n, part,
                              pu);
        pmi.mvx[1] = (int16_t)(amvp[2 * mvp_f1] + m1x);
        pmi.mvy[1] = (int16_t)(amvp[2 * mvp_f1 + 1] + m1y);
        pmi.ref[1] = (int8_t)r;
        if (cur_->mvp_flag1) {
          int b4w = pw >> 2, b4h = ph >> 2, bw4l = sp_.ctu_size / 4;
          for (int yy = 0; yy < b4h; ++yy)
            for (int xx = 0; xx < b4w; ++xx) {
              size_t liq = (size_t)(((py - ctu_y0_) >> 2) + yy) * bw4l +
                           ((px - ctu_x0_) >> 2) + xx;
              cur_->mvp_flag1[liq] = (uint8_t)mvp_f1;
              cur_->mvd_x1[liq] = (int16_t)m1x;
              cur_->mvd_y1[liq] = (int16_t)m1y;
            }
        }
      }
    }
    if (g_bin_trace)
      fprintf(g_bin_trace,
              "# PU (%d,%d %dx%d) part=%d mrg=%d idx=%d "
              "mv0=(%d,%d r%d) mv1=(%d,%d r%d)\n",
              px, py, pw, ph, part, merge_f, merge_i, pmi.mvx[0],
              pmi.mvy[0], pmi.ref[0], pmi.mvx[1], pmi.mvy[1], pmi.ref[1]);
    publish_motion_rect(px, py, pw, ph, pmi, merge_f, merge_i, mvp_f, mvdx,
                        mvdy, 0);
    if (pu == 0) mi = pmi;
  }
  // rqt_root_cbf coded unless a 2Nx2N merge PU (spec 7.3.8.5)
  int merge_2nx2n = part == 0 && cu_merge;
  int root = 1;
  if (!merge_2nx2n) {
    if (g_bin_trace) fprintf(g_bin_trace, "# rqt_root\n");
    root = cabac_.decode_bin(ctx_.qt_root_cbf[0]);
  }
  if (root) transform_tree(x0, y0, x0, y0, log2, 0, 0, false, 1, 1, false);
}

void SliceDecoder::publish_motion_rect(int x0, int y0, int w, int h,
                                       const MotionInfo& mi, int merge_f,
                                       int merge_i, int mvp_f, int mvd_x,
                                       int mvd_y, int skip) {
  int bw4 = sp_.ctu_size / 4;
  int b4w = w >> 2, b4h = h >> 2;
  for (int yy = 0; yy < b4h; ++yy)
    for (int xx = 0; xx < b4w; ++xx) {
      size_t li = (size_t)(((y0 - ctu_y0_) >> 2) + yy) * bw4 +
                  ((x0 - ctu_x0_) >> 2) + xx;
      cur_->pred_mode[li] = 0;
      cur_->skip_flag[li] = (uint8_t)skip;
      cur_->merge_flag[li] = (uint8_t)merge_f;
      cur_->merge_idx[li] = (uint8_t)merge_i;
      cur_->mvp_flag[li] = (uint8_t)mvp_f;
      cur_->ref_idx[li] = mi.ref[0];
      cur_->mvd_x[li] = (int16_t)mvd_x;
      cur_->mvd_y[li] = (int16_t)mvd_y;
      cur_->mv_x[li] = mi.mvx[0];
      cur_->mv_y[li] = mi.mvy[0];
      if (cur_->mv_x1) {
        cur_->ref_idx1[li] = mi.ref[1];
        cur_->mv_x1[li] = mi.mvx[1];
        cur_->mv_y1[li] = mi.mvy[1];
      }
      size_t pi = (size_t)(((y0 >> 2) + yy)) * maps_.stride +
                  (x0 >> 2) + xx;
      maps_.pred_mode[pi] = 0;
      maps_.skip_flag[pi] = (uint8_t)skip;
      for (int l = 0; l < 2; ++l) {
        maps_.mv_x[l][pi] = mi.mvx[l];
        maps_.mv_y[l][pi] = mi.mvy[l];
        maps_.ref_idx[l][pi] = mi.ref[l];
      }
    }
}

void SliceDecoder::parse_cu(int x0, int y0, int log2) {
  int depth = sp_.max_cb_log2 - log2;
  fill(cur_->cu_depth, x0, y0, log2, depth);
  // cu_transquant_bypass_flag (spec 7.3.8.5, first element of the CU;
  // reference TDecSbac::parseCUTransquantBypassFlag). The flag rides
  // bit 0x40 of the rext map for the reconstruction stage.
  if (sp_.tq_bypass) {
    stat(ST_OTHER);
    if (cabac_.decode_bin(ctx_.tq_bypass[0]) && cur_->rext) {
      int bw4 = sp_.ctu_size / 4;
      int b = 1 << (log2 - 2);
      int bx = (x0 - ctu_x0_) >> 2, by = (y0 - ctu_y0_) >> 2;
      for (int yy = 0; yy < b; ++yy)
        for (int xx = 0; xx < b; ++xx)
          cur_->rext[(by + yy) * bw4 + bx + xx] |= 0x40;
    }
  }
  // publish depth to picture maps
  int b = 1 << (log2 - 2);
  for (int yy = 0; yy < b; ++yy)
    for (int xx = 0; xx < b; ++xx)
      maps_.cu_depth[((y0 >> 2) + yy) * maps_.stride + (x0 >> 2) + xx] = depth;

  if (sp_.slice_type != 2) {
    int ctxi = 0;
    if (maps_.available(x0 - 1, y0, x0, y0) &&
        maps_.skip_flag[maps_.idx(x0 - 1, y0)]) ctxi++;
    if (maps_.available(x0, y0 - 1, x0, y0) &&
        maps_.skip_flag[maps_.idx(x0, y0 - 1)]) ctxi++;
    stat(ST_SKIP);
    int skip = cabac_.decode_bin(ctx_.skip_flag[ctxi]);
    if (skip) {
      parse_inter_cu(x0, y0, log2, true);
      return;
    }
    stat(ST_PRED_MODE);
    int intra = cabac_.decode_bin(ctx_.pred_mode[0]);
    if (!intra) {
      parse_inter_cu(x0, y0, log2, false);
      return;
    }
  }
  parse_intra_cu(x0, y0, log2);
}

void SliceDecoder::parse_intra_cu(int x0, int y0, int log2) {
  if (g_bin_trace) fprintf(g_bin_trace, "# ICU %d %d log2=%d\n", x0, y0, log2);
  bool nxn = false;
  if (log2 == sp_.min_cb_log2)
    nxn = cabac_.decode_bin(ctx_.part_size[0]) == 0;
  fill(cur_->nxn_flag, x0, y0, log2, nxn ? 1 : 0);

  // pcm_flag (spec 7.3.8.5/9.3.1; reference TDecSbac::parseIPCMInfo):
  // after the terminate bin reads 1 this bit-exact reader sits one bit
  // past the stop bit — align, read raw samples, re-init the engine.
  if (sp_.pcm && log2 >= 3 && log2 <= 5 && !nxn) {
    if (cabac_.decode_terminate()) {
      cabac_.align_to_byte();
      stat(ST_PCM);
      int bw4 = sp_.ctu_size / 4;
      int csx = (sp_.chroma_format == 3) ? 0 : 1;
      int csy = (sp_.chroma_format == 1) ? 1 : 0;
      int n = 1 << log2, cnx = n >> csx, cny = n >> csy;
      int lx = x0 - ctu_x0_, ly = y0 - ctu_y0_;
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          cur_->coeff_y[(ly + i) * sp_.ctu_size + lx + j] =
              (int16_t)cabac_.read_raw(sp_.bit_depth);
      int cctu = sp_.ctu_size >> csx;
      for (int c = 0; sp_.chroma_format != 0 && c < 2; ++c) {
        int16_t* cp = c == 0 ? cur_->coeff_cb : cur_->coeff_cr;
        for (int i = 0; i < cny; ++i)
          for (int j = 0; j < cnx; ++j)
            cp[((ly >> csy) + i) * cctu + (lx >> csx) + j] =
                (int16_t)cabac_.read_raw(sp_.bit_depth);
      }
      cabac_.restart_here();
      cur_->tu_depth[(ly >> 2) * bw4 + (lx >> 2)] |= PCM_FLAG;
      // intra DC direction for neighbour MPM/chroma derivation
      // (reference sets I_PCM intra dir to DC)
      fill(cur_->luma_mode, x0, y0, log2, 1);
      fill(cur_->chroma_mode, x0, y0, log2, 1);
      int pb = 1 << (log2 - 2);
      for (int yy = 0; yy < pb; ++yy)
        for (int xx = 0; xx < pb; ++xx)
          maps_.luma_mode[((y0 >> 2) + yy) * maps_.stride + (x0 >> 2) + xx] =
              1;
      return;
    }
  }

  // luma modes
  int npart = nxn ? 4 : 1;
  int half = 1 << (log2 - 1);
  int prev_flag[4], mode[4];
  stat(ST_INTRA_LUMA);
  for (int i = 0; i < npart; ++i)
    prev_flag[i] = cabac_.decode_bin(ctx_.intra_luma[0]);
  for (int i = 0; i < npart; ++i) {
    int px = x0 + (i & 1) * half, py = y0 + (i >> 1) * half;
    int cand[3];
    mpm_list(maps_, px, py, cand);
    if (prev_flag[i]) {
      int idx = 0;
      if (cabac_.decode_bypass()) idx = cabac_.decode_bypass() ? 2 : 1;
      mode[i] = cand[idx];
    } else {
      int rem = cabac_.decode_bypass_bins(5);
      int c[3] = {cand[0], cand[1], cand[2]};
      std::sort(c, c + 3);
      for (int k = 0; k < 3; ++k)
        if (rem >= c[k]) rem++;
      mode[i] = rem;
    }
    int plog2 = nxn ? log2 - 1 : log2;
    fill(cur_->luma_mode, px, py, plog2, mode[i]);
    int pb = 1 << (plog2 - 2);
    for (int yy = 0; yy < pb; ++yy)
      for (int xx = 0; xx < pb; ++xx)
        maps_.luma_mode[((py >> 2) + yy) * maps_.stride + (px >> 2) + xx] =
            mode[i];
  }
  // chroma mode (4:4:4 NxN: one per partition, spec 7.3.8.5);
  // monochrome streams carry no intra_chroma_pred_mode
  int cparts = sp_.chroma_format == 0 ? 0
               : ((sp_.chroma_format == 3 && nxn) ? 4 : 1);
  stat(ST_INTRA_CHROMA);
  for (int i = 0; i < cparts; ++i) {
    int cmode;
    if (cabac_.decode_bin(ctx_.intra_chroma[0]) == 0) {
      cmode = chroma_cand(4, mode[i]);
    } else {
      cmode = chroma_cand(cabac_.decode_bypass_bins(2), mode[i]);
    }
    // 4:2:2 stores the REMAPPED mode (spec Table 8-3) — both the
    // residual scan choice (7.4.9.11) and prediction use it
    // (reference TDecSbac.cpp:1337, TDecCu.cpp:500)
    if (sp_.chroma_format == 2) cmode = CHROMA_422_ANGLE_MAP[cmode];
    if (cparts == 4)
      fill(cur_->chroma_mode, x0 + (i & 1) * half, y0 + (i >> 1) * half,
           log2 - 1, cmode);
    else
      fill(cur_->chroma_mode, x0, y0, log2, cmode);
  }

  transform_tree(x0, y0, x0, y0, log2, 0, 0, nxn, 1, 1, true);
}

void SliceDecoder::transform_tree(int x0, int y0, int xb, int yb, int log2,
                                  int depth, int blk_idx, bool intra_split,
                                  int par_cb, int par_cr, bool is_intra,
                                  int par_cb2, int par_cr2) {
  stat(ST_TRANSFORM_TREE);
  if (g_bin_trace)
    fprintf(g_bin_trace, "# TT %d %d log2=%d d=%d pcb=%d pcr=%d\n", x0, y0,
            log2, depth, par_cb, par_cr);
  int max_depth = is_intra ? sp_.max_tu_depth_intra + (intra_split ? 1 : 0)
                           : sp_.max_tu_depth_inter;
  bool explicit_split =
      log2 <= sp_.max_tb_log2 && log2 > sp_.min_tb_log2 &&
      depth < max_depth && !(intra_split && depth == 0);
  bool split;
  if (log2 > sp_.max_tb_log2) split = true;
  else if (intra_split && depth == 0) split = true;
  else if (explicit_split) {
    if (g_bin_trace) fprintf(g_bin_trace, "# tsplit\n");
    split = cabac_.decode_bin(ctx_.trans_subdiv[5 - log2]);
  }
  else split = false;

  int cs = (sp_.chroma_format == 3) ? 0 : 1;
  // 4:2:2: a luma TB carries TWO square chroma sub-TBs stacked
  // vertically, each with its own cbf (spec 7.3.8.8: the second flag at
  // [x0][y0 + (1 << (log2TrafoSize - 1))] is coded when the node does
  // not split, or at log2TrafoSize == 3 where children cannot carry
  // chroma; reference TComTU two-sub-TU iteration).
  bool c422 = sp_.chroma_format == 2;
  bool mono = sp_.chroma_format == 0;
  int cbf_cb = 0, cbf_cr = 0, cbf_cb2 = 0, cbf_cr2 = 0;
  if (!mono && (log2 > 2 || cs == 0)) {
    if (depth == 0 || par_cb) {
      if (g_bin_trace) fprintf(g_bin_trace, "# cbfCb d=%d\n", depth);
      cbf_cb = cabac_.decode_bin(ctx_.cbf_chroma[depth]);
      if (c422 && (!split || log2 == 3))
        cbf_cb2 = cabac_.decode_bin(ctx_.cbf_chroma[depth]);
    }
    if (depth == 0 || par_cr) {
      if (g_bin_trace) fprintf(g_bin_trace, "# cbfCr d=%d\n", depth);
      cbf_cr = cabac_.decode_bin(ctx_.cbf_chroma[depth]);
      if (c422 && (!split || log2 == 3))
        cbf_cr2 = cabac_.decode_bin(ctx_.cbf_chroma[depth]);
    }
  } else if (!mono) {
    cbf_cb = par_cb;
    cbf_cr = par_cr;
    cbf_cb2 = par_cb2;
    cbf_cr2 = par_cr2;
  }

  if (split) {
    int h = 1 << (log2 - 1);
    transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, intra_split, cbf_cb, cbf_cr, is_intra, cbf_cb2, cbf_cr2);
    return;
  }

  fill(cur_->tu_depth, x0, y0, log2, depth);
  int cbf_y = 1;  // inferred for inter depth-0 with no chroma cbf
  if (is_intra || depth != 0 || cbf_cb || cbf_cr || cbf_cb2 || cbf_cr2) {
    if (g_bin_trace) fprintf(g_bin_trace, "# cbfY d=%d\n", depth);
    cbf_y = cabac_.decode_bin(ctx_.cbf_luma[depth == 0 ? 1 : 0]);
  }
  // cu_qp_delta (spec 7.3.8.10/9.3.3.8): TU prefix cMax 5 (ctx 0 then 1),
  // EG0 suffix, bypass sign; QpY wraps per 8.6.1
  if (sp_.cu_dqp && !dqp_coded_ &&
      (cbf_y || cbf_cb || cbf_cr || cbf_cb2 || cbf_cr2)) {
    stat(ST_DQP);
    int a = 0;
    while (a < 5 && cabac_.decode_bin(ctx_.dqp[a ? 1 : 0])) ++a;
    if (a == 5) {
      int k = 0;
      while (cabac_.decode_bypass()) ++k;
      int v = (1 << k) - 1;
      for (int b = 0; b < k; ++b) v += cabac_.decode_bypass() << (k - 1 - b);
      a = 5 + v;
    }
    int delta = a;
    if (a && cabac_.decode_bypass()) delta = -a;
    int qbd = 6 * (sp_.bit_depth - 8);
    dqp_target_ = ((qg_ref_ + delta + 52 + 2 * qbd) % (52 + qbd)) - qbd;
    dqp_coded_ = true;
  }
  if (cbf_y) residual(x0, y0, log2, 0);
  // cross-component prediction (spec 7.3.8.12, 4:4:4 only): one alpha
  // per chroma component, parsed when the luma TB has coefficients and
  // the CU is inter or intra with DM chroma (reference TDecSbac
  // parseCrossComponentPrediction)
  auto parse_ccp = [&](int comp) -> int {
    if (!sp_.ccp || !cbf_y || cs != 0) return 0;
    bool cu_intra = is_intra;
    if (cu_intra) {
      int lm = map_at(cur_->luma_mode, sp_.ctu_size / 4, x0 - ctu_x0_,
                      y0 - ctu_y0_);
      int cm = map_at(cur_->chroma_mode, sp_.ctu_size / 4, x0 - ctu_x0_,
                      y0 - ctu_y0_);
      if (lm != cm) return 0;  // not DM chroma
    }
    ContextModel* pc = ctx_.ccp + (comp == 2 ? 5 : 0);
    if (!cabac_.decode_bin(pc[0])) return 0;
    int symbol = cabac_.decode_bin(pc[1]);
    if (symbol) {
      // unary max 2: first bin ctx pc[2], further bins pc[3]
      int u = 0;
      if (cabac_.decode_bin(pc[2])) {
        u = 1;
        if (cabac_.decode_bin(pc[3])) u = 2;
      }
      symbol = u + 1;
    }
    int alpha = 1 << symbol;
    if (cabac_.decode_bin(pc[4])) alpha = -alpha;
    int bw4l = sp_.ctu_size / 4;
    int8_t* m = comp == 1 ? cur_->ccp_cb : cur_->ccp_cr;
    if (m)
      m[((y0 - ctu_y0_) >> 2) * bw4l + ((x0 - ctu_x0_) >> 2)] =
          (int8_t)alpha;
    return alpha;
  };
  if (mono) {
  } else if (log2 > 2 || cs == 0) {
    parse_ccp(1);
    if (cbf_cb) residual(x0, y0, log2 - cs, 1);
    if (c422 && cbf_cb2) residual(x0, y0 + (1 << (log2 - 1)), log2 - 1, 1);
    parse_ccp(2);
    if (cbf_cr) residual(x0, y0, log2 - cs, 2);
    if (c422 && cbf_cr2) residual(x0, y0 + (1 << (log2 - 1)), log2 - 1, 2);
  } else if (blk_idx == 3) {
    if (par_cb) residual(xb, yb, 2, 1);
    if (c422 && par_cb2) residual(xb, yb + 4, 2, 1);
    if (par_cr) residual(xb, yb, 2, 2);
    if (c422 && par_cr2) residual(xb, yb + 4, 2, 2);
  }
}

void SliceDecoder::residual(int x0, int y0, int log2, int c_idx) {
  if (g_bin_trace) fprintf(g_bin_trace, "# RES %d %d log2=%d c=%d\n", x0, y0, log2, c_idx);
  int bw4 = sp_.ctu_size / 4;
  bool luma = c_idx == 0;
  int n = 1 << log2;
  int16_t* plane;
  int pw, px, py;
  if (luma) {
    plane = cur_->coeff_y; pw = sp_.ctu_size;
    px = x0 - ctu_x0_; py = y0 - ctu_y0_;
  } else {
    // chroma coeff planes are (ctu >> csy) rows x (ctu >> csx) cols;
    // 4:2:2 subsamples horizontally only (SubWidthC=2, SubHeightC=1)
    int csx = (sp_.chroma_format == 3) ? 0 : 1;
    int csy = (sp_.chroma_format == 1) ? 1 : 0;
    plane = (c_idx == 1) ? cur_->coeff_cb : cur_->coeff_cr;
    pw = sp_.ctu_size >> csx;
    px = (x0 - ctu_x0_) >> csx; py = (y0 - ctu_y0_) >> csy;
  }
  // mode-dependent scan applies to intra blocks only (7.4.9.11)
  bool blk_intra = sp_.slice_type == 2 ||
      map_at(cur_->pred_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_) == 1;
  int pred_mode = luma
      ? map_at(cur_->luma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_)
      : map_at(cur_->chroma_mode, bw4, x0 - ctu_x0_, y0 - ctu_y0_);
  int scan_idx = blk_intra ? mode_scan_idx(log2, c_idx, pred_mode,
                                           sp_.chroma_format == 3) : 0;
  const auto& scan = g_scans.t[log2 - 2][scan_idx];

  int ts_max = sp_.ts_max_log2 ? sp_.ts_max_log2 : 2;
  // cu_transquant_bypass CU (lossless): no transform_skip_flag, no sign
  // hiding, residual passes through untouched (spec 7.3.8.11 / 8.6.4.1)
  bool tqb = sp_.tq_bypass && cur_->rext &&
      (cur_->rext[((y0 - ctu_y0_) >> 2) * bw4 + ((x0 - ctu_x0_) >> 2)]
       & 0x40);
  bool ts = false;
  if (sp_.transform_skip_enabled && log2 <= ts_max && !tqb) {
    stat(ST_TS_FLAG);
    if (cabac_.decode_bin(ctx_.transform_skip[luma ? 0 : 1])) {
      ts = true;
      cur_->tu_depth[((y0 - ctu_y0_) >> 2) * bw4 + ((x0 - ctu_x0_) >> 2)] |=
          ts_bit_of(c_idx);
    }
  }
  // RDPCM (range extensions): explicit on inter TS TBs (parsed), implicit
  // on intra TS TBs with horizontal/vertical prediction (derived). Both
  // disable sign-data hiding for the TB (reference TDecSbac
  // parseCoeffNxN beValid handling).
  bool no_sbh = tqb;
  if ((ts || tqb) && sp_.explicit_rdpcm && !blk_intra) {
    int ch = luma ? 0 : 1;
    if (cabac_.decode_bin(ctx_.explicit_rdpcm_flag[ch])) {
      int dir = cabac_.decode_bin(ctx_.explicit_rdpcm_dir[ch]);
      no_sbh = true;
      if (cur_->rext) {
        int shift = luma ? 0 : (c_idx == 1 ? 2 : 4);
        cur_->rext[((y0 - ctu_y0_) >> 2) * bw4 + ((x0 - ctu_x0_) >> 2)] |=
            (uint8_t)((1 | (dir << 1)) << shift);
      }
    }
  }
  if ((ts || tqb) && sp_.implicit_rdpcm && blk_intra &&
      (pred_mode == 10 || pred_mode == 26))
    no_sbh = true;

  // last significant position
  stat(ST_LAST_POS);
  ContextModel* lastx = luma ? ctx_.last_x : ctx_.last_x + 15;
  ContextModel* lasty = luma ? ctx_.last_y : ctx_.last_y + 15;
  int ctx_offset = luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
  int ctx_shift = luma ? (log2 + 1) >> 2 : log2 - 2;
  int cmax = (log2 << 1) - 1;
  int gx = 0, gy = 0;
  while (gx < cmax && cabac_.decode_bin(lastx[ctx_offset + (gx >> ctx_shift)]))
    gx++;
  while (gy < cmax && cabac_.decode_bin(lasty[ctx_offset + (gy >> ctx_shift)]))
    gy++;
  int lx = gx, ly = gy;
  if (gx > 3) lx = kMinInGroup[gx] + cabac_.decode_bypass_bins((gx >> 1) - 1);
  if (gy > 3) ly = kMinInGroup[gy] + cabac_.decode_bypass_bins((gy >> 1) - 1);
  if (scan_idx == 2) std::swap(lx, ly);

  // find last scan pos
  int last_pos = -1;
  for (int i = n * n - 1; i >= 0; --i)
    if (scan[i] % n == lx && scan[i] / n == ly) { last_pos = i; break; }

  int nsb = 1 << (2 * (log2 - 2));
  int sb_w = n >> 2;
  std::vector<uint8_t> csbf(nsb, 0);
  auto sb_of = [&](int i) {
    int r = scan[i * 16];
    return std::make_pair((r % n) >> 2, (r / n) >> 2);
  };
  auto csbf_at = [&](int xs, int ys) -> int {
    if (xs >= sb_w || ys >= sb_w) return 0;
    for (int i = 0; i < nsb; ++i) {
      auto p = sb_of(i);
      if (p.first == xs && p.second == ys) return csbf[i];
    }
    return 0;
  };

  int last_sb = last_pos >> 4;
  csbf[last_sb] = 1;
  csbf[0] = 1;
  int c1 = 1;
  stat(ST_SIG_MAP);
  for (int i = last_sb; i >= 0; --i) {
    auto sbp = sb_of(i);
    int xs = sbp.first, ys = sbp.second;
    int right = csbf_at(xs + 1, ys), below = csbf_at(xs, ys + 1);
    if (i < last_sb && i > 0) {
      int ctxi = (right || below) ? 1 : 0;
      if (g_bin_trace) fprintf(g_bin_trace, "# csbf i=%d ctx=%d\n", i, ctxi);
      csbf[i] = cabac_.decode_bin(ctx_.sig_cg[(luma ? 0 : 2) + ctxi]);
    }
    if (!csbf[i]) continue;

    int infer_dc = (i < last_sb && i > 0) ? 1 : 0;
    int sig_pos[16], num = 0;
    int start = (i == last_sb) ? (last_pos & 15) : 15;
    if (i == last_sb) sig_pos[num++] = last_pos;
    for (int k = start - (i == last_sb ? 1 : 0); k >= 0; --k) {
      int pos = i * 16 + k;
      int r = scan[pos];
      int sig;
      if (k > 0 || !infer_dc) {
        int xc = r % n, yc = r / n;
        int sctx = (sp_.ts_context && (ts || tqb))
                       ? (luma ? 27 : 15)
                       : sig_ctx_inc(log2, scan_idx, xc, yc, right, below,
                                     luma);
        if (g_bin_trace)
          fprintf(g_bin_trace, "# sig k=%d xy=%d,%d sctx=%d\n", k, xc, yc,
                  sctx);
        sig = cabac_.decode_bin(ctx_.sig[(luma ? 0 : 28) + sctx]);
        if (sig) infer_dc = 0;
      } else {
        sig = 1;  // inferred DC significance
      }
      if (sig) sig_pos[num++] = pos;
    }

    if (num == 0) continue;  // inferred-coded DC sub-block with no coeffs

    stat(ST_COEFF_LEVEL);
    int ctx_set = (i > 0 && luma) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int gt1[16] = {0}, first_gt1 = -1;
    int num_c1 = std::min(num, 8);
    for (int k = 0; k < num_c1; ++k) {
      if (g_bin_trace)
        fprintf(g_bin_trace, "# gt1 k=%d set=%d c1=%d\n", k, ctx_set, c1);
      gt1[k] = cabac_.decode_bin(ctx_.one[(luma ? 0 : 16) + 4 * ctx_set + c1]);
      if (gt1[k]) { c1 = 0; if (first_gt1 < 0) first_gt1 = k; }
      else if (c1 < 3 && c1 > 0) c1++;
    }
    int gt2 = 0;
    if (first_gt1 >= 0)
      gt2 = cabac_.decode_bin(ctx_.abs_[(luma ? 0 : 4) + ctx_set]);

    // escape data present in this CG? (2nd+ gt1, any gt2, or >8 coeffs
    // -- reference escapeDataPresentInGroup); with RExt CABAC bypass
    // alignment the decoder range snaps to 256 before the bypass run
    if (sp_.bypass_align) {
      bool escape = num > 8 || gt2 != 0;
      for (int k = 0; k < num_c1 && !escape; ++k)
        if (gt1[k] && k != first_gt1) escape = true;
      if (escape) cabac_.align();
    }
    int first_nz_k = sig_pos[num - 1] & 15;
    int last_nz_k = sig_pos[0] & 15;
    bool hide = sp_.sign_hiding && !no_sbh &&
                (last_nz_k - first_nz_k > 3);
    int sign[16] = {0};
    stat(ST_SIGN);
    for (int k = 0; k < num; ++k) {
      if (hide && k == num - 1) break;
      sign[k] = cabac_.decode_bypass();
    }

    // levels: inverse of the coeff_abs_level_remaining binarization
    stat(ST_COEFF_LEVEL);
    auto read_remaining = [&](int rice) -> int {
      int p = 0;
      while (cabac_.decode_bypass()) p++;
      if (p < 3) return (p << rice) | (int)cabac_.decode_bypass_bins(rice);
      int eg_len = p - 3 + rice;
      return (3 << rice) + (1 << eg_len) - (1 << rice)
             + (int)cabac_.decode_bypass_bins(eg_len);
    };
    int level[16];
    // persistent Golomb-Rice adaptation (RExt): the CG's initial rice
    // parameter comes from the per-class statistic, the statistic is
    // updated by the FIRST escape value of the CG, and the in-CG rice
    // increment is uncapped (reference parseCoeffNxN adaptation path)
    int stat_idx = (luma ? 2 : 0) + ((ts || tqb) ? 1 : 0);
    int first_coeff2 = 1;
    int rice = sp_.persistent_rice ? (int)(ctx_.rice_stat[stat_idx] >> 2)
                                   : 0;
    bool update_stat = sp_.persistent_rice != 0;
    long sum_abs = 0;
    for (int k = 0; k < num; ++k) {
      int flags_val, base_level;
      if (k < 8) {
        flags_val = 1 + gt1[k] + (k == first_gt1 ? gt2 : 0);
        base_level = 2 + first_coeff2;
      } else {
        flags_val = 1;
        base_level = 1;
      }
      int av = flags_val;
      if (flags_val == base_level) {  // flags saturated -> remaining present
        int rem = read_remaining(rice);
        av += rem;
        if (av > (3 << rice))
          rice = sp_.persistent_rice ? rice + 1 : std::min(rice + 1, 4);
        if (update_stat) {
          int init_rice = (int)(ctx_.rice_stat[stat_idx] >> 2);
          if (rem >= (3 << init_rice))
            ctx_.rice_stat[stat_idx]++;
          else if (2 * rem < (1 << init_rice) &&
                   ctx_.rice_stat[stat_idx] > 0)
            ctx_.rice_stat[stat_idx]--;
          update_stat = false;
        }
      }
      level[k] = av;
      if (av >= 2) first_coeff2 = 0;
      sum_abs += av;
    }
    for (int k = 0; k < num; ++k) {
      int s = sign[k];
      if (hide && k == num - 1) s = (sum_abs & 1);
      int r = scan[sig_pos[k]];
      plane[(py + r / n) * pw + px + r % n] = s ? -level[k] : level[k];
    }
  }
}

// ---------------------------------------------------------------------------
// SAO syntax (spec 7.3.8.3). Parity: reference TEncSbac codeSAOBlkParam /
// TDecSbac parseSAOBlkParam.
// ---------------------------------------------------------------------------
void SliceEncoder::code_sao(int cx, int cy) {
  const int32_t* p = cur_->sao;
  int cmax_off = (1 << (std::min(sp_.bit_depth, 10) - 5)) - 1;
  // merge flags: p[7] = 1 merge-left, 2 merge-up (parameters already
  // resolved into p by the estimator; only the flag is signalled).
  // Candidates must lie in the same tile (spec 7.4.9.3).
  int merge = p[7];
  int tid = tile_id_of(sp_, cx, cy);
  int ctus_w = (sp_.pic_w + sp_.ctu_size - 1) / sp_.ctu_size;
  // spec 7.3.8.3: the merge flags are present only when the candidate CTU
  // is in the same slice segment AND tile
  auto in_slice = [&](int ox, int oy) {
    return oy * ctus_w + ox >= sp_.slice_start_ctu;
  };
  if (cx > 0 && tile_id_of(sp_, cx - 1, cy) == tid && in_slice(cx - 1, cy)) {
    cabac_.encode_bin(ctx_.sao_merge[0], merge == 1);
    if (merge == 1) return;
  }
  if (cy > 0 && tile_id_of(sp_, cx, cy - 1) == tid && in_slice(cx, cy - 1)) {
    cabac_.encode_bin(ctx_.sao_merge[0], merge == 2);
    if (merge == 2) return;
  }
  auto code_type = [&](int t) {
    cabac_.encode_bin(ctx_.sao_type[0], t != 0);
    if (t != 0) cabac_.encode_bypass(t == 2 ? 1 : 0);
  };
  auto code_offsets = [&](int t, const int32_t* off, int band_pos,
                          int eo_class, bool code_eo) {
    if (t == 0) return;
    for (int i = 0; i < 4; ++i) {
      int a = off[i] < 0 ? -off[i] : off[i];
      for (int k = 0; k < a; ++k) cabac_.encode_bypass(1);
      if (a < cmax_off) cabac_.encode_bypass(0);
    }
    if (t == 1) {  // band: signs for nonzero offsets + band position
      for (int i = 0; i < 4; ++i)
        if (off[i] != 0) cabac_.encode_bypass(off[i] < 0 ? 1 : 0);
      cabac_.encode_bypass_bins((uint32_t)band_pos, 5);
    } else if (code_eo) {
      cabac_.encode_bypass_bins((uint32_t)eo_class, 2);
    }
  };
  if (sp_.sao_luma) {
    code_type(p[0]);
    code_offsets(p[0], p + 8, p[4], p[2], true);
  }
  if (sp_.sao_chroma) {
    code_type(p[1]);
    code_offsets(p[1], p + 12, p[5], p[3], true);
    // cr: type/eo inherited, own offsets + band position, no eo bits
    code_offsets(p[1], p + 16, p[6], p[3], false);
  }
}

void SliceDecoder::parse_sao(int cx, int cy, int32_t* out) {
  stat(ST_SAO);
  int ctus_w = (sp_.pic_w + sp_.ctu_size - 1) / sp_.ctu_size;
  if (sao_store_.empty())
    sao_store_.assign((size_t)ctus_w *
                          ((sp_.pic_h + sp_.ctu_size - 1) / sp_.ctu_size) * 20,
                      0);
  int cmax_off = (1 << (std::min(sp_.bit_depth, 10) - 5)) - 1;
  std::fill(out, out + 20, 0);
  int tid_sao = tile_id_of(sp_, cx, cy);
  // merge candidates must be in the same tile AND slice (spec 7.4.9.3)
  int left_ok = cx > 0 && tile_id_of(sp_, cx - 1, cy) == tid_sao &&
                cy * ctus_w + cx - 1 >= sp_.slice_start_ctu;
  int up_ok = cy > 0 && tile_id_of(sp_, cx, cy - 1) == tid_sao &&
              (cy - 1) * ctus_w + cx >= sp_.slice_start_ctu;
  int merge_left = left_ok ? cabac_.decode_bin(ctx_.sao_merge[0]) : 0;
  int merge_up = (!merge_left && up_ok)
                     ? cabac_.decode_bin(ctx_.sao_merge[0]) : 0;
  int idx = cy * ctus_w + cx;
  if (merge_left || merge_up) {
    int src = merge_left ? idx - 1 : idx - ctus_w;
    std::copy(&sao_store_[src * 20], &sao_store_[src * 20 + 20], out);
    out[7] = merge_left ? 1 : 2;
    std::copy(out, out + 20, &sao_store_[idx * 20]);
    return;
  }
  auto parse_type = [&]() {
    if (!cabac_.decode_bin(ctx_.sao_type[0])) return 0;
    return cabac_.decode_bypass() ? 2 : 1;
  };
  auto parse_offsets = [&](int t, int32_t* off, int32_t* band_pos,
                           int32_t* eo_class, bool has_eo) {
    if (t == 0) return;
    int absv[4];
    for (int i = 0; i < 4; ++i) {
      int a = 0;
      while (a < cmax_off && cabac_.decode_bypass()) a++;
      absv[i] = a;
    }
    if (t == 1) {
      for (int i = 0; i < 4; ++i) {
        int sign = absv[i] ? (int)cabac_.decode_bypass() : 0;
        off[i] = sign ? -absv[i] : absv[i];
      }
      *band_pos = (int32_t)cabac_.decode_bypass_bins(5);
    } else {
      // edge: inferred signs (+ + - -)
      off[0] = absv[0];
      off[1] = absv[1];
      off[2] = -absv[2];
      off[3] = -absv[3];
      if (has_eo) *eo_class = (int32_t)cabac_.decode_bypass_bins(2);
    }
  };
  if (sp_.sao_luma) {
    out[0] = parse_type();
    parse_offsets(out[0], out + 8, out + 4, out + 2, true);
  }
  if (sp_.sao_chroma) {
    out[1] = parse_type();
    parse_offsets(out[1], out + 12, out + 5, out + 3, true);
    int32_t dummy_eo = out[3];
    parse_offsets(out[1], out + 16, out + 6, &dummy_eo, false);
  }
  std::copy(out, out + 20, &sao_store_[idx * 20]);
}

}  // namespace hevctpu
