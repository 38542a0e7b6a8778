// KITTI official-protocol AP matcher of mv3d_tf_tpu_torch, a copy of the
// JAX package's native/kitti_eval.cc.
//
// The reference shells out to a compiled evaluator the repo never
// shipped (lib/datasets/kitti_mv3d.py:392-401). The protocol lives in
// mv3d_tf_tpu_torch/data/kitti_eval.py (evaluate_ap_difficulty); this
// library is its C++ twin for the O(N*M) greedy-matching loop, which
// dominates host-side eval time on large validation sets. Semantics match
// the numpy loop (greedy by descending score, ignored-gt / min-height
// ignore rules, R40 interpolated AP); tests/test_torch_native.py holds
// them equal.
//
// Plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// pairwise IoU of two geometry rows.
// kind 0: 2D axis-aligned [x1,y1,x2,y2] with the KITTI +1 convention
// kind 1: 3D AABB [x1,y1,z1,x2,y2,z2]
inline double iou_row(const float* a, const float* b, int kind) {
  if (kind == 0) {
    double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]) + 1.0;
    double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]) + 1.0;
    if (iw <= 0.0 || ih <= 0.0) return 0.0;
    double inter = iw * ih;
    double area_a = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0);
    double area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0);
    double u = area_a + area_b - inter;
    return u > 1e-9 ? inter / u : inter / 1e-9;
  }
  double inter = 1.0, va = 1.0, vb = 1.0;
  for (int d = 0; d < 3; ++d) {
    double lo = std::max(a[d], b[d]);
    double hi = std::min(a[d + 3], b[d + 3]);
    inter *= std::max(hi - lo, 0.0);
    va *= std::max(static_cast<double>(a[d + 3]) - a[d], 0.0);
    vb *= std::max(static_cast<double>(b[d + 3]) - b[d], 0.0);
  }
  double u = va + vb - inter;
  return u > 1e-9 ? inter / u : inter / 1e-9;
}

struct Rec {
  float score;
  bool tp;
};

}  // namespace

extern "C" {

// Evaluate one (metric, difficulty) AP over concatenated frames.
//   dets:     sum(N_i) * dgeom floats     det_off: n_frames+1 longs
//   scores:   sum(N_i) floats             det_h:   sum(N_i) floats
//   gts:      sum(M_i) * dgeom floats     gt_off:  n_frames+1 longs
//   levels:   sum(M_i) ints (1..4)
//   iou_kind: 0 = 2D(+1 convention), 1 = 3D AABB (dgeom must be 4 / 6)
//   lvl_max:  1 easy / 2 moderate / 3 hard
// out[0] = AP (R40), out[1] = npos. Matches kitti_eval.py
// evaluate_ap_difficulty exactly (python sorts are stable; ties in
// score keep frame/order construction order here too).
void kitti_eval_ap(const float* dets, const int64_t* det_off,
                   const float* scores, const float* det_h,
                   const float* gts, const int64_t* gt_off,
                   const int32_t* levels, int64_t n_frames, int32_t dgeom,
                   int32_t iou_kind, float iou_thresh, float min_h,
                   int32_t lvl_max, double* out) {
  std::vector<Rec> records;
  int64_t npos = 0;
  std::vector<int64_t> order;
  std::vector<char> taken;

  for (int64_t f = 0; f < n_frames; ++f) {
    const int64_t d0 = det_off[f], d1 = det_off[f + 1];
    const int64_t g0 = gt_off[f], g1 = gt_off[f + 1];
    const int64_t nd = d1 - d0, ng = g1 - g0;
    for (int64_t j = 0; j < ng; ++j) {
      const int32_t lv = levels[g0 + j];
      if (lv >= 1 && lv <= lvl_max) ++npos;
    }
    if (nd == 0) continue;

    order.resize(nd);
    for (int64_t i = 0; i < nd; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       return scores[d0 + a] > scores[d0 + b];
                     });
    taken.assign(static_cast<size_t>(ng), 0);

    for (int64_t oi = 0; oi < nd; ++oi) {
      const int64_t d = order[oi];
      const float* drow = dets + (d0 + d) * dgeom;
      bool matched_valid = false, matched_ignored = false;
      if (ng > 0) {
        double best = -1.0;
        int64_t bestj = -1;
        double best_ign = -1.0;
        for (int64_t j = 0; j < ng; ++j) {
          const int32_t lv = levels[g0 + j];
          const bool valid = (lv >= 1 && lv <= lvl_max);
          const double ov = iou_row(drow, gts + (g0 + j) * dgeom,
                                    iou_kind);
          if (valid && !taken[j]) {
            if (ov > best) {  // strict >: first-max tie rule (argmax)
              best = ov;
              bestj = j;
            }
          }
          if (!valid && ov > best_ign) best_ign = ov;
        }
        if (bestj >= 0 && best >= iou_thresh) {
          taken[bestj] = 1;
          matched_valid = true;
        } else if (best_ign >= iou_thresh) {
          matched_ignored = true;
        }
      }
      if (matched_valid) {
        records.push_back({scores[d0 + d], true});
      } else if (matched_ignored || det_h[d0 + d] < min_h) {
        continue;  // ignored detection: neither TP nor FP
      } else {
        records.push_back({scores[d0 + d], false});
      }
    }
  }

  if (records.empty() || npos == 0) {
    out[0] = 0.0;
    out[1] = static_cast<double>(npos);
    return;
  }
  std::stable_sort(records.begin(), records.end(),
                   [](const Rec& a, const Rec& b) {
                     return a.score > b.score;
                   });
  const size_t n = records.size();
  std::vector<double> rec(n), prec(n);
  double tp = 0.0, fp = 0.0;
  for (size_t i = 0; i < n; ++i) {
    if (records[i].tp) ++tp; else ++fp;
    rec[i] = tp / static_cast<double>(npos);
    prec[i] = tp / std::max(tp + fp, 1e-9);
  }
  double total = 0.0;
  for (int t = 1; t <= 40; ++t) {
    const double thr = static_cast<double>(t) / 40.0;
    double best = 0.0;
    for (size_t i = 0; i < n; ++i) {
      if (rec[i] >= thr && prec[i] > best) best = prec[i];
    }
    total += best;
  }
  out[0] = total / 40.0;
  out[1] = static_cast<double>(npos);
}

}  // extern "C"
