// Greedy NMS on the host with ops/nms.nms_np's semantics, for the 2D
// detector's per-class step (solver.class_detections_2d), where a class
// can hold every one of a call's 1000 rois and the numpy loop spends some
// ten vector calls a kept box.
//
// The caller passes nms_np's own score order (numpy's argsort, reversed),
// so ties fall as they do there, and the float32 threshold that a float32
// overlap passes exactly when it passes nms_np's comparison. Each overlap
// is nms_np's float32 arithmetic in its order: the +1 widths, max(0, .),
// the suppressor's area first in the union, one IEEE division. x86-64's
// default target has no fused multiply-add, so no product is contracted
// into a sum. A box removes only boxes after it in the order: nms_np's
// marks on earlier ones change no decision, and a box removed twice is
// removed once.
//
// Plain C ABI for ctypes (utils/native.nms_np_native).

#include <cstdint>
#include <vector>

namespace {

// box a's sweep over the boxes after it, in score order; plain enough
// for the compiler to vectorize
void sweep(const float* __restrict x1, const float* __restrict y1,
           const float* __restrict x2, const float* __restrict y2,
           const float* __restrict area, uint8_t* __restrict removed,
           int64_t a, int64_t n, float thresh) {
  const float ax1 = x1[a], ay1 = y1[a], ax2 = x2[a], ay2 = y2[a];
  const float aarea = area[a];
  for (int64_t b = a + 1; b < n; ++b) {
    // np.maximum / np.minimum; a NaN coordinate makes its area and so the
    // overlap NaN whichever operand these return
    const float xx1 = ax1 > x1[b] ? ax1 : x1[b];
    const float yy1 = ay1 > y1[b] ? ay1 : y1[b];
    const float xx2 = ax2 < x2[b] ? ax2 : x2[b];
    const float yy2 = ay2 < y2[b] ? ay2 : y2[b];
    float w = xx2 - xx1 + 1.0f;
    float h = yy2 - yy1 + 1.0f;
    w = w < 0.0f ? 0.0f : w;
    h = h < 0.0f ? 0.0f : h;
    const float inter = w * h;
    const float ovr = inter / (aarea + area[b] - inter);
    removed[b] |= static_cast<uint8_t>(ovr >= thresh);
  }
}

}  // namespace

extern "C" int64_t nms_greedy_host(const float* dets, const int64_t* order,
                                   int64_t n, float thresh, int64_t* keep) {
  // the boxes in score order, one array a coordinate
  std::vector<float> x1(n), y1(n), x2(n), y2(n), area(n);
  for (int64_t a = 0; a < n; ++a) {
    const float* d = dets + 5 * order[a];
    x1[a] = d[0];
    y1[a] = d[1];
    x2[a] = d[2];
    y2[a] = d[3];
    area[a] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
  }
  std::vector<uint8_t> removed(n, 0);
  int64_t kept = 0;
  for (int64_t a = 0; a < n; ++a) {
    if (removed[a]) continue;
    keep[kept++] = order[a];
    sweep(x1.data(), y1.data(), x2.data(), y2.data(), area.data(),
          removed.data(), a, n, thresh);
  }
  return kept;
}
