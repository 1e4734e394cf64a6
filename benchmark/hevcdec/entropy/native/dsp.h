// Spec-exact signal processing for the native CU engine: core transforms,
// quantization, motion-compensation interpolation, intra prediction, SATD.
//
// Parity: reference TComTrQuant.cpp (xQuant:1126 / xDeQuant:1314, partial
// butterflies :441-900 — realised here as integer matrix products),
// TComInterpolationFilter.cpp:57-392, TComPrediction.cpp predIntraAng,
// TComRdCost.cpp xCalcHADs8x8. All routines are the C++ twins of the
// verified numpy implementations in hevc_tpu/ops/{transform,quant,interp,
// intra_np}.py and hevc_tpu/core/refsamples.py (cross-checked by the
// decoder-conformance suite).
#pragma once
#include <cstdint>

namespace hevctpu {

// Sample (pel) type. The default build stores samples in int16 (internal
// bit depths up to 14, signed headroom included); compiling with
// -DHEVC_PEL32 widens every sample plane to int32 for 16-bit video — the
// same dual-build scheme as the reference's high-bit-depth target
// (TypeDef.h:698 `typedef Int Pel` under RExt__HIGH_BIT_DEPTH_SUPPORT,
// built by `make all_highbitdepth`). All intermediate arithmetic below is
// already int64-safe for 16-bit inputs, so only the plane storage changes.
#if defined(HEVC_PEL32)
using pel_t = int32_t;
#else
using pel_t = int16_t;
#endif

namespace dsp {

// n-point HEVC core transform matrix (row-major n*n), derived from the 33
// distinct spec coefficients via cosine-index folding (spec 8.6.4.2).
const int32_t* dct_matrix(int n);
const int32_t* dst4_matrix();

// residual[n*n] int32 -> coeff[n*n] int32 (horizontal stage first).
void fwd_xform(const int32_t* resi, int n, int bd, bool dst, int32_t* out);
// coeff[n*n] -> residual[n*n] (vertical stage first, 16-bit clamps).
void inv_xform(const int32_t* coef, int n, int bd, bool dst, int32_t* out);

// Quantizer scale tables (spec 8.6.3 levScale / HM TComRom g_quantScales,
// g_invQuantScales), indexed by qp % 6. Single authority for every user
// (dsp quant/dequant, the engine's RDPCM and zero-quant screens).
extern const int32_t kQuantScales[6];
extern const int32_t kInvQuantScales[6];

// forward quant (HM rounding 171/256 intra, 85/256 inter); returns count of
// nonzero levels. qp is the slice QP at 8-bit scale; QpBdOffset is applied
// inside (spec 8.6.1). `m` is the scaling matrix (n*n, 16 = flat) or null.
int quant(const int32_t* coef, int n, int qp, int bd, bool intra,
          int32_t* level, const int32_t* m = nullptr);
void dequant(const int32_t* level, int n, int qp, int bd, int32_t* coef,
             const int32_t* m = nullptr);
// default scaling matrix (spec Table 7-5/7-6, 8x8 upsampled to 16/32);
// null for 4x4 (flat by default)
const int32_t* default_scaling_matrix(int n, bool intra);

// Hadamard SATD between orig (int16, stride so) and pred (int32, stride n):
// 8x8 tiles for n>=8, 4x4 for n==4 (reference TComRdCost::xCalcHADs8x8).
int64_t satd(const pel_t* org, int so, const int32_t* pred, int sp, int n);
// SATD with early exit once the partial sum reaches `bound` (exact when
// the true value is below the bound; see dsp.cpp)
int64_t satd_bounded(const pel_t* org, int so, const int32_t* pred, int sp,
                     int n, int64_t bound);
int64_t satd_rect(const pel_t* org, int so, const int32_t* pred, int sp,
                  int w, int h);

// Motion compensation on a padded reference plane (int16, width rw, the
// unpadded origin at (pad, pad)). mv in luma quarter-pel; for chroma
// (is_luma=false) it acts at eighth-pel on chroma coordinates.
// raw14: return the 14-bit intermediate (for bi averaging).
void mc_block(const pel_t* ref, int rw, int pad, int x, int y, int w,
              int h, int fx, int fy, int bd, bool is_luma, bool raw14,
              int32_t* out);
void mc_predict(const pel_t* ref, int rw, int pad, int mvx, int mvy,
                int x0, int y0, int w, int h, int bd, bool is_luma,
                int32_t* out);
// explicit weighted uni-prediction (spec 8.5.3.3.4.3): applies
// ((raw14 * wgt + round) >> log2Wd) + off on the 14-bit intermediate,
// log2Wd = denom + 14 - bd
void mc_predict_wp(const pel_t* ref, int rw, int pad, int mvx, int mvy,
                   int x0, int y0, int w, int h, int bd, bool is_luma,
                   int wgt, int off, int denom, int32_t* out);
void mc_predict_bi(const pel_t* r0, const pel_t* r1, int rw, int pad,
                   int mv0x, int mv0y, int mv1x, int mv1y, int x0, int y0,
                   int w, int h, int bd, bool is_luma, int32_t* out);
// explicit weighted bi-prediction (spec 8.5.3.3.4.3 explicit case;
// reference TComWeightPrediction::addWeightBi):
// (raw0*w0 + raw1*w1 + ((o0+o1+1) << log2Wd)) >> (log2Wd + 1)
void mc_predict_bi_wp(const pel_t* r0, const pel_t* r1, int rw, int pad,
                      int mv0x, int mv0y, int mv1x, int mv1y, int x0,
                      int y0, int w, int h, int bd, bool is_luma,
                      int w0, int o0, int w1, int o1, int denom,
                      int32_t* out);

// Fused TB writeback: store quantized levels as int16, reconstruct
// rec = clip(pred + res (+ ccp)), and return the exact int64 SSE vs the
// original — split into per-row single-type loops so each vectorizes on
// the host ISA (the fused scalar form was ~50% of engine wall at 1080p).
// `ccp` (cross-component prediction term, stride tz) may be null.
int64_t tb_writeback(const int32_t* lev, int tz, int16_t* lv_out,
                     int lv_stride, const int32_t* pred, int pstride,
                     const int32_t* res, const int32_t* ccp,
                     const pel_t* org, int ostride, pel_t* rec,
                     int rstride, int maxv);
// Exact int64 SSE between an original (pel) block and an int32 predicted
// block already clipped to pel range — the no-residual SKIP trial cost.
int64_t sse_pred(const pel_t* org, int ostride, const int32_t* pred,
                 int pstride, int w, int h);

// Intra prediction from the combined reference vector f[4n+1]
// (f[0..2n-1] = p[-1][2n-1-i .. 0] bottom-up, f[2n] = corner,
// f[2n+1..4n] = p[0..2n-1][-1]); spec 8.4.4.2.4-6.
void intra_filter_refs(const int32_t* f, int n, int bd, bool strong,
                       int32_t* ff);
bool intra_strong_smoothing(const int32_t* f, int n, int bd);
bool intra_filter_flag(int mode, int n, bool smooth_like_luma);
void intra_predict(const int32_t* f, const int32_t* ff, int mode, int n,
                   int bd, bool is_luma, int32_t* out);

}  // namespace dsp
}  // namespace hevctpu
