"""The reduction of the program's spans (lib/spans.py) on synthetic events:
each idle gap goes to the innermost span at its midpoint, with gaps in no
span in a bucket of their own; launches count by host containment; device
operations join their launches by correlation id, not by time; the wall
times and counters come from the program's records."""

import types

import pytest

from benchmark.lib import spans as S

US = 1000                                # ns

# host: call [0, 100) us with children a [10, 40) (a.x [20, 30) inside)
# and b [50, 90); the host is in no span after 100
SPANS = [(0, 100 * US, "call"), (10 * US, 40 * US, "a"),
         (20 * US, 30 * US, "a.x"), (50 * US, 90 * US, "b")]


def _reduce(runtime, dev, stretch=(0, 120 * US), records=(), hand=()):
    return S.reduce(SPANS, runtime, dev, stretch, records, hand=hand)


def test_idle_gaps_go_to_the_innermost_span_at_their_midpoint():
    # device busy [0, 12), [18, 32), [36, 70), [80, 110): gaps [12, 18)
    # (midpoint 15: a), [32, 36) (34: a), [70, 80) (75: b), [110, 120)
    # (115: no span); none before the first operation
    dev = [(0, 12 * US, "k", 1), (18 * US, 32 * US, "k", 2),
           (36 * US, 70 * US, "k", 3), (80 * US, 110 * US, "k", 4)]
    r = _reduce([], dev)
    sp = r["spans"]
    assert r["window_ms"] == pytest.approx(0.12)
    assert r["busy_ms"] == pytest.approx(0.090)
    assert r["idle_pct"] == pytest.approx(100 * 30 / 120)
    assert sp["a"]["idle_self_pct"] == pytest.approx(100 * 10 / 120)
    assert sp["a.x"]["idle_self_pct"] == 0
    assert sp["b"]["idle_self_pct"] == pytest.approx(100 * 10 / 120)
    assert sp["call"]["idle_self_pct"] == 0
    assert r["no_span_idle_pct"] == pytest.approx(100 * 10 / 120)
    # a span's share holds its children's; the innermost shares and the
    # bucket add up to the stretch's
    assert sp["call"]["idle_pct"] == pytest.approx(100 * 20 / 120)
    assert (sum(s["idle_self_pct"] for s in sp.values())
            + r["no_span_idle_pct"]) == pytest.approx(r["idle_pct"])


def test_a_gap_inside_a_child_goes_to_the_child():
    # one gap [22, 28): midpoint 25 lies in a.x, inside a, inside call
    dev = [(0, 22 * US, "k", 1), (28 * US, 120 * US, "k", 2)]
    sp = _reduce([], dev)["spans"]
    assert sp["a.x"]["idle_self_pct"] == pytest.approx(100 * 6 / 120)
    assert sp["a"]["idle_self_pct"] == 0
    assert sp["a"]["idle_pct"] == sp["call"]["idle_pct"] == pytest.approx(
        100 * 6 / 120)


def test_stretch_before_the_first_operation_is_idle():
    dev = [(60 * US, 120 * US, "k", 1)]
    r = _reduce([], dev)
    # [0, 60): midpoint 30 is a.x's end, so a holds it
    assert r["spans"]["a"]["idle_self_pct"] == pytest.approx(50)
    assert r["idle_pct"] == pytest.approx(50)


def test_launches_count_by_host_containment():
    runtime = [(5 * US, 6 * US, "cudaLaunchKernel", 1),
               (25 * US, 26 * US, "cudaLaunchKernel", 2),
               (26 * US, 27 * US, "cudaMemcpyAsync", 3),
               (35 * US, 36 * US, "cudaMemsetAsync", 4),
               (60 * US, 61 * US, "cudaLaunchKernelExC", 5),
               (105 * US, 106 * US, "cudaLaunchKernel", 6),
               # not launches: a sync, a query
               (27 * US, 28 * US, "cudaStreamSynchronize", 7),
               (61 * US, 62 * US, "cudaStreamIsCapturing", 8)]
    sp = _reduce(runtime, [])["spans"]
    assert sp["call"]["launches"] == 5
    assert sp["a"]["launches"] == 3
    assert sp["a.x"]["launches"] == 2
    assert sp["b"]["launches"] == 1


def test_copies_join_their_launches_by_correlation_not_by_time():
    # the copy launched in a.x runs on the device at 60-70 us, while the
    # host is in b; the kernel launched in b ran at 22-24, inside a.x's
    # time: each goes to the span of its launch
    runtime = [(25 * US, 26 * US, "cudaMemcpyAsync", 11),
               (55 * US, 56 * US, "cudaLaunchKernel", 12)]
    dev = [(60 * US, 70 * US, "Memcpy HtoD (Pageable -> Device)", 11),
           (22 * US, 24 * US, "roi_pool_kernel<float>", 12),
           (80 * US, 81 * US, "Memcpy DtoH (Device -> Pageable)", 99)]
    r = _reduce(runtime, dev, hand=["roi_pool_kernel"])
    sp = r["spans"]
    assert sp["a.x"]["device_ms"] == pytest.approx(0.010)
    assert sp["a.x"]["htod_ms"] == pytest.approx(0.010)
    assert sp["b"]["device_ms"] == pytest.approx(0.002)
    assert sp["b"]["htod_ms"] == 0
    assert sp["b"]["hand_traced"] == 1 and sp["a.x"]["hand_traced"] == 0
    assert sp["call"]["device_ms"] == pytest.approx(0.012)
    # an operation no launch of the trace correlates with
    assert r["unlinked_device_ms"] == pytest.approx(0.001)


def _rec(name, id_, parent, start_us, end_us, **counts):
    return types.SimpleNamespace(name=name, id=id_, parent=parent,
                                 start_ns=start_us * US, end_ns=end_us * US,
                                 counts=counts)


def test_walls_and_counters_from_the_records():
    """Medians over the calls of each call's sums; a span's self time less
    its children's; counters over the roots."""
    calls = [
        [_rec("call.a", 2, 1, 10, 40, host_syncs=2, roi_pool_cuda=2),
         _rec("call", 1, None, 0, 100, host_syncs=3, roi_pool_cuda=2),
         _rec("asm", 3, None, 100, 110, host_syncs=6),
         _rec("asm", 4, None, 110, 130, host_syncs=6)],
        [_rec("call.a", 6, 5, 210, 250, host_syncs=2, roi_pool_cuda=2),
         _rec("call", 5, None, 200, 400, host_syncs=3, roi_pool_cuda=2),
         _rec("asm", 7, None, 400, 410, host_syncs=6),
         _rec("asm", 8, None, 410, 420, host_syncs=6)],
        [_rec("call.a", 10, 9, 510, 530, host_syncs=2, roi_pool_cuda=2),
         _rec("call", 9, None, 500, 550, host_syncs=3, roi_pool_cuda=2),
         _rec("asm", 11, None, 550, 560, host_syncs=6),
         _rec("asm", 12, None, 560, 570, host_syncs=6)]]
    w = S.walls(calls)
    sp = w["spans"]
    assert sp["call"]["wall_ms"] == pytest.approx(0.1)      # 100, 200, 50
    assert sp["call"]["self_ms"] == pytest.approx(0.07)     # 70, 160, 30
    assert sp["asm"]["n"] == 2
    assert sp["asm"]["wall_ms"] == pytest.approx(0.02)      # 30, 20, 20
    assert sp["call.a"]["counts"] == {"host_syncs": 2, "nms_rounds": 0}
    assert w["counts"] == {"host_syncs": 15, "nms_rounds": 0}
    assert w["roots_ms"] == pytest.approx(0.13)             # 130, 220, 70
    # the hand kernels' counters beside the trace's events
    r = S.reduce(SPANS, [], [], (0, 120 * US),
                 [_rec("a", 9, 8, 10, 40, host_syncs=1, roi_pool_cuda=2,
                       vgg_stem_cuda=1)])
    assert r["spans"]["a"]["hand_counted"] == 3
