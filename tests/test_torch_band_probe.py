"""tools/band_probe on the CPU at 200 input rows over two bands: every conv
layer from conv2_1 on of both views, the band rows' counts, and the bf16
results of the whole frame and of the bands within one bf16 ulp (of each
channel's largest value) of the float32 convolution of the same inputs."""

import json

import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch.parallel import mesh as PM  # noqa: E402
from mv3d_tf_tpu_torch.tools import band_probe  # noqa: E402


def test_band_probe_on_the_cpu(capsys):
    summary = band_probe.main(["--device", "cpu", "--rows", "200"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[-1] == summary
    recs = lines[:-1]
    assert summary["layers"] == len(recs) == 22
    assert [r["layer"] for r in recs[:11]] == [
        "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3", "conv4_1",
        "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3"]
    # 200 rows: feature bands [0, 12) and [12, 25) read input rows [0, 168)
    # and [24, 200); at conv2_1 (stride 2) rows [0, 84) and [12, 100), each
    # less its one cut-edge row
    assert [PM.band_slice(b, 200) for b in PM.row_bands(25, 2)] == [
        (0, 168), (24, 200)]
    assert recs[0]["rows"] == 83 + 87
    assert summary["within_one_ulp"]
    assert summary["max_band_vs_whole_ulps"] <= 1.0
