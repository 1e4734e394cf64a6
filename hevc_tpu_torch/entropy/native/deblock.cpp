// Native deblocking filter (spec 8.7.2) — exact twin of the verified
// numpy implementation in hevc_tpu/ops/deblock.py (same map derivation,
// same edge loops, same integer arithmetic), for the per-frame hot path:
// the Python pass costs ~140 ms at 1080p, this one ~5 ms.
//
// Parity: reference TComLoopFilter.{h,cpp} (loopFilterPic:130, boundary
// strength :417, luma/chroma edge filters :560,679). Like the numpy twin
// (and unlike the reference's CU-by-CU walk), all vertical edges are
// filtered in one pass, then all horizontal edges — equivalent because
// HEVC's 8-sample edge spacing makes same-direction edges independent.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "dsp.h"

namespace {
using hevctpu::pel_t;

const int32_t kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8,
    9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
const int32_t kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36,
    38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
// spec Table 8-10 QpC mapping for 4:2:0 (same values as core/tables.py
// CHROMA_QP_MAP_420 and engine.cpp kChromaQp420)
const int32_t kQpC420[58] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
    31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51};

constexpr int32_t NO_POC = -1000000;

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Maps {
  int h4, w4;
  std::vector<uint8_t> edge_v, edge_h, tue_v, tue_h, is_intra, nz;
  std::vector<int32_t> mvx0, mvy0, poc0, mvx1, mvy1, poc1;
  std::vector<int32_t> bs_v, bs_h;
  explicit Maps(int h4_, int w4_) : h4(h4_), w4(w4_) {
    size_t n = (size_t)h4 * w4;
    edge_v.assign(n, 0); edge_h.assign(n, 0);
    tue_v.assign(n, 0); tue_h.assign(n, 0);
    is_intra.assign(n, 0); nz.assign(n, 0);
    mvx0.assign(n, 0); mvy0.assign(n, 0); poc0.assign(n, NO_POC);
    mvx1.assign(n, 0); mvy1.assign(n, 0); poc1.assign(n, NO_POC);
    bs_v.assign(n, 0); bs_h.assign(n, 0);
  }
  size_t at(int r, int c) const { return (size_t)r * w4 + c; }
};

struct CtuMaps {
  const uint8_t *cu_depth, *nxn, *tu_depth, *pred_mode;
  const int16_t* coeff_y;
  const int8_t* ref_idx; const int16_t *mv_x, *mv_y;
  const int8_t* ref_idx1; const int16_t *mv_x1, *mv_y1;
  int n4, ctu;
};

// CU leaf walk — mirrors encoder/quadtree.py cu_leaves / engine.cpp
// encode_ctu Rec::walk (implicit boundary splits, per-4x4 target depth)
template <typename F>
void walk_cu(const CtuMaps& cm, int ctu_x0, int ctu_y0, int pic_w,
             int pic_h, int x0, int y0, int log2, int depth,
             int min_cb_log2, F&& leaf) {
  if (x0 >= pic_w || y0 >= pic_h) return;
  int size = 1 << log2;
  bool boundary = (x0 + size > pic_w) || (y0 + size > pic_h);
  int target = cm.cu_depth[((y0 - ctu_y0) >> 2) * cm.n4 +
                           ((x0 - ctu_x0) >> 2)];
  bool split = (boundary || depth < target) && log2 > min_cb_log2;
  if (split) {
    int h = size >> 1;
    walk_cu(cm, ctu_x0, ctu_y0, pic_w, pic_h, x0, y0, log2 - 1, depth + 1,
            min_cb_log2, leaf);
    walk_cu(cm, ctu_x0, ctu_y0, pic_w, pic_h, x0 + h, y0, log2 - 1,
            depth + 1, min_cb_log2, leaf);
    walk_cu(cm, ctu_x0, ctu_y0, pic_w, pic_h, x0, y0 + h, log2 - 1,
            depth + 1, min_cb_log2, leaf);
    walk_cu(cm, ctu_x0, ctu_y0, pic_w, pic_h, x0 + h, y0 + h, log2 - 1,
            depth + 1, min_cb_log2, leaf);
    return;
  }
  leaf(x0, y0, log2);
}

// TU leaf walk — mirrors encoder/quadtree.py tu_leaves
template <typename F>
void walk_tu(const CtuMaps& cm, int ctu_x0, int ctu_y0, int x0, int y0,
             int log2, int depth, int maxd, bool intra_split, F&& leaf) {
  constexpr int kMinTb = 2, kMaxTb = 5;
  bool split;
  bool explicit_ = (log2 <= kMaxTb && log2 > kMinTb && depth < maxd &&
                    !(intra_split && depth == 0));
  if (log2 > kMaxTb || (intra_split && depth == 0)) {
    split = true;
  } else if (explicit_) {
    split = (cm.tu_depth[((y0 - ctu_y0) >> 2) * cm.n4 +
                         ((x0 - ctu_x0) >> 2)] & 0x7) > depth;
  } else {
    split = false;
  }
  if (split) {
    int h = 1 << (log2 - 1);
    walk_tu(cm, ctu_x0, ctu_y0, x0, y0, log2 - 1, depth + 1, maxd,
            intra_split, leaf);
    walk_tu(cm, ctu_x0, ctu_y0, x0 + h, y0, log2 - 1, depth + 1, maxd,
            intra_split, leaf);
    walk_tu(cm, ctu_x0, ctu_y0, x0, y0 + h, log2 - 1, depth + 1, maxd,
            intra_split, leaf);
    walk_tu(cm, ctu_x0, ctu_y0, x0 + h, y0 + h, log2 - 1, depth + 1, maxd,
            intra_split, leaf);
    return;
  }
  leaf(x0, y0, log2);
}

void build_maps(Maps& m, int w, int h, int ctu, int ctus_w, int nctu,
                int min_cb_log2, int max_tu_intra, int max_tu_inter,
                const int32_t* ref_pocs0, int nref0,
                const int32_t* ref_pocs1, int nref1,
                const CtuMaps* ctus) {
  for (int i = 0; i < nctu; ++i) {
    const CtuMaps& cm = ctus[i];
    int cy = i / ctus_w, cx = i % ctus_w;
    int x0c = cx * ctu, y0c = cy * ctu;
    int bx0 = x0c >> 2, by0 = y0c >> 2;
    int h4c = std::min(cm.n4, m.h4 - by0);
    int w4c = std::min(cm.n4, m.w4 - bx0);
    for (int r = 0; r < h4c; ++r)
      for (int c = 0; c < w4c; ++c) {
        size_t gi = m.at(by0 + r, bx0 + c);
        size_t li = (size_t)r * cm.n4 + c;
        bool intra = cm.pred_mode[li] == 1;
        m.is_intra[gi] = intra;
        m.mvx0[gi] = cm.mv_x[li];
        m.mvy0[gi] = cm.mv_y[li];
        m.mvx1[gi] = cm.mv_x1[li];
        m.mvy1[gi] = cm.mv_y1[li];
        int r0 = cm.ref_idx[li], r1 = cm.ref_idx1[li];
        m.poc0[gi] = (!intra && r0 >= 0 && r0 < nref0) ? ref_pocs0[r0]
                                                       : NO_POC;
        m.poc1[gi] = (!intra && r1 >= 0 && r1 < nref1) ? ref_pocs1[r1]
                                                       : NO_POC;
      }
    walk_cu(cm, x0c, y0c, w, h, x0c, y0c,
            31 - __builtin_clz((unsigned)ctu), 0, min_cb_log2,
            [&](int x0, int y0, int log2) {
      size_t li = (size_t)((y0 - y0c) >> 2) * cm.n4 + ((x0 - x0c) >> 2);
      bool intra = cm.pred_mode[li] == 1;
      int nxn = cm.nxn[li];
      int maxd = intra ? max_tu_intra : max_tu_inter;
      int size = 1 << log2;
      int r_end = std::min((y0 + size) >> 2, m.h4);
      int c_end = std::min((x0 + size) >> 2, m.w4);
      for (int r = y0 >> 2; r < r_end; ++r) {
        m.edge_v[m.at(r, x0 >> 2)] = 1;
        m.tue_v[m.at(r, x0 >> 2)] = 1;
      }
      for (int c = x0 >> 2; c < c_end; ++c) {
        m.edge_h[m.at(y0 >> 2, c)] = 1;
        m.tue_h[m.at(y0 >> 2, c)] = 1;
      }
      if (!intra && nxn >= 2 && nxn <= 7) {
        // interior PU boundary of rect/AMP partitions (spec 8.7.2.2)
        static const int kNum[8] = {0, 0, 2, 2, 1, 3, 1, 3};  // quarters
        int off = (size * kNum[nxn]) >> 2;
        if (nxn == 2 || nxn == 4 || nxn == 5) {
          int rr = (y0 + off) >> 2;
          if (rr < m.h4)
            for (int c = x0 >> 2; c < c_end; ++c) m.edge_h[m.at(rr, c)] = 1;
        } else {
          int cc = (x0 + off) >> 2;
          if (cc < m.w4)
            for (int r = y0 >> 2; r < r_end; ++r) m.edge_v[m.at(r, cc)] = 1;
        }
      }
      walk_tu(cm, x0c, y0c, x0, y0, log2, 0, maxd, intra && nxn,
              [&](int tx, int ty, int tlog2) {
        int ts = 1 << tlog2;
        int tr_end = std::min((ty + ts) >> 2, m.h4);
        int tc_end = std::min((tx + ts) >> 2, m.w4);
        for (int r = ty >> 2; r < tr_end; ++r) {
          m.edge_v[m.at(r, tx >> 2)] = 1;
          m.tue_v[m.at(r, tx >> 2)] = 1;
        }
        for (int c = tx >> 2; c < tc_end; ++c) {
          m.edge_h[m.at(ty >> 2, c)] = 1;
          m.tue_h[m.at(ty >> 2, c)] = 1;
        }
        bool any = false;
        for (int yy = ty - y0c; yy < ty - y0c + ts && !any; ++yy)
          for (int xx = tx - x0c; xx < tx - x0c + ts; ++xx)
            if (cm.coeff_y[(size_t)yy * cm.ctu + xx]) { any = true; break; }
        if (any)
          for (int r = ty >> 2; r < tr_end; ++r)
            for (int c = tx >> 2; c < tc_end; ++c) m.nz[m.at(r, c)] = 1;
      });
    });
  }
  // picture boundaries are never filtered
  for (int r = 0; r < m.h4; ++r) { m.edge_v[m.at(r, 0)] = 0;
                                   m.tue_v[m.at(r, 0)] = 0; }
  for (int c = 0; c < m.w4; ++c) { m.edge_h[m.at(0, c)] = 0;
                                   m.tue_h[m.at(0, c)] = 0; }
}

// BS per 4x4 block edge (spec 8.7.2.4); P = neighbour block, Q = this
// block. Exact twin of hevc_tpu/ops/deblock.py _boundary_strength.
void boundary_strength(Maps& m, bool vertical) {
  std::vector<int32_t>& bs = vertical ? m.bs_v : m.bs_h;
  const std::vector<uint8_t>& edge = vertical ? m.edge_v : m.edge_h;
  const std::vector<uint8_t>& tue = vertical ? m.tue_v : m.tue_h;
  int r0 = vertical ? 0 : 1, c0 = vertical ? 1 : 0;
  for (int r = r0; r < m.h4; ++r)
    for (int c = c0; c < m.w4; ++c) {
      size_t q = m.at(r, c);
      if (!edge[q]) { bs[q] = 0; continue; }
      size_t p = vertical ? m.at(r, c - 1) : m.at(r - 1, c);
      if (m.is_intra[p] || m.is_intra[q]) { bs[q] = 2; continue; }
      bool nzpq = m.nz[p] || m.nz[q];
      // motion-based condition
      auto side = [&](size_t s, int32_t* o) {
        bool v0 = m.poc0[s] != NO_POC, v1 = m.poc1[s] != NO_POC;
        o[0] = (int)v0 + (int)v1;
        o[1] = v0 ? m.mvx0[s] : m.mvx1[s];
        o[2] = v0 ? m.mvy0[s] : m.mvy1[s];
        o[3] = v0 ? m.poc0[s] : m.poc1[s];
        o[4] = m.mvx0[s]; o[5] = m.mvy0[s]; o[6] = m.poc0[s];
        o[7] = m.mvx1[s]; o[8] = m.mvy1[s]; o[9] = m.poc1[s];
      };
      int32_t P[10], Q[10];
      side(p, P); side(q, Q);
      bool motion_bad;
      if (P[0] != Q[0]) {
        motion_bad = true;
      } else if (P[0] == 2) {
        bool straight = P[6] == Q[6] && P[9] == Q[9];
        bool cross = P[6] == Q[9] && P[9] == Q[6];
        bool st_ok = std::abs(P[4] - Q[4]) < 4 && std::abs(P[5] - Q[5]) < 4 &&
                     std::abs(P[7] - Q[7]) < 4 && std::abs(P[8] - Q[8]) < 4;
        bool cr_ok = std::abs(P[4] - Q[7]) < 4 && std::abs(P[5] - Q[8]) < 4 &&
                     std::abs(P[7] - Q[4]) < 4 && std::abs(P[8] - Q[5]) < 4;
        bool same_pic = P[6] == P[9];
        bool bi_ok = (same_pic && straight)
                         ? (st_ok || cr_ok)
                         : ((straight && st_ok) ||
                            (cross && !straight && cr_ok));
        motion_bad = !(straight || cross) || !bi_ok;
      } else {
        motion_bad = P[3] != Q[3] || std::abs(P[1] - Q[1]) >= 4 ||
                     std::abs(P[2] - Q[2]) >= 4;
      }
      bs[q] = ((nzpq && tue[q]) || motion_bad) ? 1 : 0;
    }
  // the first row/column carries no edge
  if (vertical)
    for (int r = 0; r < m.h4; ++r) bs[m.at(r, 0)] = 0;
  else
    for (int c = 0; c < m.w4; ++c) bs[m.at(0, c)] = 0;
}

// Filter all luma edges of one direction. `sa` strides along the edge
// (line direction), `sb` across it; for vertical edges sa = plane
// stride, sb = 1 — for horizontal the roles swap (same trick as the
// numpy twin's transpose). `ea` = segment count along, `eb` = samples
// across. bs_at(seg4, edge4) resolves the BS grid in plane orientation.
template <typename BsF, typename QpF>
void filter_luma_dir(pel_t* plane, int ea, int eb, long sa, long sb,
                     int qp_scalar, int bd, int beta_off, int tc_off,
                     BsF&& bs_at, QpF&& qp_at, bool has_qp_map) {
  int scale = 1 << (bd - 8);
  int maxv = (1 << bd) - 1;
  int nxe = eb > 8 ? (eb - 9) / 8 + 1 : 0;
  for (int e = 0; e < nxe; ++e) {
    int x = (e + 1) * 8;
    for (int ys = 0; ys + 4 <= ea; ys += 4) {
      int bsv = bs_at(ys >> 2, x >> 2);
      if (bsv <= 0) continue;
      int qp = has_qp_map
                   ? ((qp_at(ys >> 2, (x >> 2) - 1) +
                       qp_at(ys >> 2, x >> 2) + 1) >> 1)
                   : qp_scalar;
      long beta = (long)kBeta[clampi(qp + (beta_off << 1), 0, 51)] * scale;
      long tc = (long)kTc[clampi(qp + 2 * (bsv - 1) + (tc_off << 1), 0,
                                 53)] * scale;
      pel_t* base = plane + (long)ys * sa + (long)x * sb;
      // p3..q3 for the 4 lines
      long p[4][4], q[4][4];
      for (int l = 0; l < 4; ++l)
        for (int k = 0; k < 4; ++k) {
          p[l][k] = base[l * sa + (long)(-1 - k) * sb];
          q[l][k] = base[l * sa + (long)k * sb];
        }
      auto dpf = [&](int l) {
        return std::abs(p[l][2] - 2 * p[l][1] + p[l][0]);
      };
      auto dqf = [&](int l) {
        return std::abs(q[l][2] - 2 * q[l][1] + q[l][0]);
      };
      long dp0 = dpf(0), dp3 = dpf(3), dq0 = dqf(0), dq3 = dqf(3);
      long d = dp0 + dq0 + dp3 + dq3;
      if (d >= beta) continue;
      auto sdec = [&](int l) {
        return 2 * (dpf(l) + dqf(l)) < (beta >> 2) &&
               std::abs(p[l][3] - p[l][0]) + std::abs(q[l][0] - q[l][3]) <
                   (beta >> 3) &&
               std::abs(p[l][0] - q[l][0]) < ((5 * tc + 1) >> 1);
      };
      bool strong = sdec(0) && sdec(3);
      for (int l = 0; l < 4; ++l) {
        long p0 = p[l][0], p1 = p[l][1], p2 = p[l][2], p3 = p[l][3];
        long q0 = q[l][0], q1 = q[l][1], q2 = q[l][2], q3 = q[l][3];
        if (strong) {
          long t2 = 2 * tc;
          base[l * sa - 1 * sb] = (pel_t)std::clamp(
              (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - t2,
              p0 + t2);
          base[l * sa - 2 * sb] = (pel_t)std::clamp(
              (p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2);
          base[l * sa - 3 * sb] = (pel_t)std::clamp(
              (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2, p2 + t2);
          base[l * sa + 0 * sb] = (pel_t)std::clamp(
              (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - t2,
              q0 + t2);
          base[l * sa + 1 * sb] = (pel_t)std::clamp(
              (p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2);
          base[l * sa + 2 * sb] = (pel_t)std::clamp(
              (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2, q2 + t2);
        } else {
          long delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
          if (std::abs(delta) >= tc * 10) continue;
          long dlt = std::clamp(delta, -tc, tc);
          base[l * sa - 1 * sb] =
              (pel_t)std::clamp(p0 + dlt, 0l, (long)maxv);
          base[l * sa + 0 * sb] =
              (pel_t)std::clamp(q0 - dlt, 0l, (long)maxv);
          long side_thr = (beta + (beta >> 1)) >> 3;
          long tch = tc >> 1;
          if (dp0 + dp3 < side_thr) {
            long dp1v = std::clamp((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                   -tch, tch);
            base[l * sa - 2 * sb] =
                (pel_t)std::clamp(p1 + dp1v, 0l, (long)maxv);
          }
          if (dq0 + dq3 < side_thr) {
            long dq1v = std::clamp((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                   -tch, tch);
            base[l * sa + 1 * sb] =
                (pel_t)std::clamp(q1 + dq1v, 0l, (long)maxv);
          }
        }
      }
    }
  }
}

// Chroma edges: 8-chroma-sample grid, BS==2 only (spec 8.7.2.5.5).
// eshift: subsampling shift perpendicular to the edge; lshift: along it.
template <typename BsF, typename QpF>
void filter_chroma_dir(pel_t* plane, int ea, int eb, long sa, long sb,
                       int qp_c_scalar, int bd, int tc_off, int eshift,
                       int lshift, int qp_off, int cfmt, BsF&& bs_at,
                       QpF&& qp_at, bool has_qp_map) {
  int scale = 1 << (bd - 8);
  int maxv = (1 << bd) - 1;
  int rows_per = 4 >> lshift;  // chroma lines per luma 4-row segment
  int nxe = eb > 8 ? (eb - 9) / 8 + 1 : 0;
  int step = 2 << eshift;
  for (int e = 0; e < nxe; ++e) {
    int cx = (e + 1) * 8;             // chroma column of the edge
    int bcol = (e + 1) * step;        // BS grid column
    for (int seg = 0; seg * rows_per < ea; ++seg) {
      if (bs_at(seg, bcol) != 2) continue;
      int ys = seg * rows_per;
      if (ys + rows_per > ea) break;
      int qpc;
      if (has_qp_map) {
        int lx = cx << eshift;        // luma column of the edge
        int qpl = ((qp_at(seg, (lx >> 2) - 1) + qp_at(seg, lx >> 2) + 1) >>
                   1) + qp_off;
        qpc = cfmt == 1 ? (int)kQpC420[clampi(qpl, 0, 57)]
                        : clampi(qpl, 0, 51);
      } else {
        qpc = qp_c_scalar;
      }
      long tc = (long)kTc[clampi(qpc + 2 + (tc_off << 1), 0, 53)] * scale;
      pel_t* base = plane + (long)ys * sa + (long)cx * sb;
      for (int l = 0; l < rows_per; ++l) {
        long p1 = base[l * sa - 2 * sb], p0 = base[l * sa - 1 * sb];
        long q0 = base[l * sa + 0 * sb], q1 = base[l * sa + 1 * sb];
        long delta =
            std::clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc);
        base[l * sa - 1 * sb] =
            (pel_t)std::clamp(p0 + delta, 0l, (long)maxv);
        base[l * sa + 0 * sb] =
            (pel_t)std::clamp(q0 - delta, 0l, (long)maxv);
      }
    }
  }
}

}  // namespace

// One-call frame deblock: derives the edge/BS maps from the stacked
// per-CTU decision maps (same layout the engine/entropy frame drives
// use) and filters all three planes in place. qp_map: per-4x4 luma QP
// over the whole picture (int32, h4*w4) or NULL for a constant slice QP.
extern "C" void hevc_deblock_frame(
    pel_t* y, pel_t* cb, pel_t* cr, int w, int h, int bd, int cfmt,
    int qp, int beta_off, int tc_off, const int32_t* qp_map,
    int cb_qp_off, int cr_qp_off, int ctus_w, int nctu, int ctu_size,
    int min_cb_log2, int max_tu_intra, int max_tu_inter,
    const int32_t* ref_pocs0, int nref0, const int32_t* ref_pocs1,
    int nref1, const uint8_t* cu_depth, const uint8_t* nxn_flag,
    const uint8_t* tu_depth, const uint8_t* pred_mode,
    const int16_t* coeff_y, const int8_t* ref_idx, const int16_t* mv_x,
    const int16_t* mv_y, const int8_t* ref_idx1, const int16_t* mv_x1,
    const int16_t* mv_y1) {
  int h4 = (h + 3) >> 2, w4 = (w + 3) >> 2;
  int n4 = ctu_size >> 2;
  Maps m(h4, w4);
  std::vector<CtuMaps> ctus((size_t)nctu);
  size_t msz = (size_t)n4 * n4, csz = (size_t)ctu_size * ctu_size;
  for (int i = 0; i < nctu; ++i)
    ctus[i] = CtuMaps{cu_depth + i * msz, nxn_flag + i * msz,
                      tu_depth + i * msz, pred_mode + i * msz,
                      coeff_y + i * csz, ref_idx + i * msz,
                      mv_x + i * msz, mv_y + i * msz, ref_idx1 + i * msz,
                      mv_x1 + i * msz, mv_y1 + i * msz, n4, ctu_size};
  build_maps(m, w, h, ctu_size, ctus_w, nctu, min_cb_log2, max_tu_intra,
             max_tu_inter, ref_pocs0, nref0, ref_pocs1, nref1,
             ctus.data());
  boundary_strength(m, true);
  boundary_strength(m, false);

  // chroma QP for the scalar path (spec 8.7.2.5.3 + Table 8-10)
  auto cqp = [&](int off) {
    int v = clampi(qp + off, 0, 57);
    return cfmt == 1 ? (int)kQpC420[v] : std::min(v, 51);
  };
  int qp_cb = cqp(cb_qp_off), qp_cr = cqp(cr_qp_off);
  int csx = cfmt == 3 ? 0 : 1;
  int csy = cfmt == 1 ? 1 : 0;
  int cw = w >> csx, ch = h >> csy;
  bool has_map = qp_map != nullptr;
  auto qmap = [&](int r, int c) { return qp_map[(size_t)r * w4 + c]; };
  auto qmap_t = [&](int r, int c) { return qp_map[(size_t)c * w4 + r]; };
  auto bsv = [&](int r, int c) { return m.bs_v[m.at(r, c)]; };
  auto bsh_t = [&](int r, int c) { return m.bs_h[m.at(c, r)]; };

  // vertical edges first (normative order), then horizontal
  filter_luma_dir(y, h, w, (long)w, 1l, qp, bd, beta_off, tc_off, bsv,
                  qmap, has_map);
  if (cfmt > 0 && cb) {
    filter_chroma_dir(cb, ch, cw, (long)cw, 1l, qp_cb, bd, tc_off, csx,
                      csy, cb_qp_off, cfmt, bsv, qmap, has_map);
    filter_chroma_dir(cr, ch, cw, (long)cw, 1l, qp_cr, bd, tc_off, csx,
                      csy, cr_qp_off, cfmt, bsv, qmap, has_map);
  }
  filter_luma_dir(y, w, h, 1l, (long)w, qp, bd, beta_off, tc_off, bsh_t,
                  qmap_t, has_map);
  if (cfmt > 0 && cb) {
    filter_chroma_dir(cb, cw, ch, 1l, (long)cw, qp_cb, bd, tc_off, csy,
                      csx, cb_qp_off, cfmt, bsh_t, qmap_t, has_map);
    filter_chroma_dir(cr, cw, ch, 1l, (long)cw, qp_cr, bd, tc_off, csy,
                      csx, cr_qp_off, cfmt, bsh_t, qmap_t, has_map);
  }
}
