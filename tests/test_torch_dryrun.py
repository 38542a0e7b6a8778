"""The row bands of parallel/mesh.py (the halo derived from the trunk's
layer list, bands over odd heights and 2-4 ranks, each band's features
equal to the whole frame's rows within 1e-5) and a failing rank making
spawn raise. The dry run itself runs in tests/test_torch_parallel.py, on
the ranks that module starts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch.models import vgg  # noqa: E402
from mv3d_tf_tpu_torch.parallel import dryrun as D  # noqa: E402
from mv3d_tf_tpu_torch.parallel import mesh as M  # noqa: E402

HEIGHTS = (81, 88, 97, 384, 601, 33)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread in this worker while the module runs: its shapes
    are tiny, and under xdist's parallel workers the default thread pool
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trunk_geometry_from_the_layer_list():
    # conv5_3's row r sees input rows [8r - 66, 8r + 73] (140 rows): a halo
    # of 66, rounded up to the stride
    assert M.trunk_geometry() == (8, 72)
    # one pool, two convs before it and one after: rows [2r - 3, 2r + 4]
    short = (("a", 4, False), ("b", 4, True), ("c", 4, False))
    assert M.trunk_geometry(short) == (2, 4)
    assert M.trunk_geometry((("a", 4, False),)) == (1, 1)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_bands_cover_and_see_their_receptive_field(n):
    stride, halo = M.trunk_geometry()
    for h in HEIGHTS:
        rows = M.feature_rows(h)
        assert rows == h // 2 // 2 // 2
        bands = M.row_bands(rows, n)
        assert bands[0][0] == 0 and bands[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert all(b - a == rows // n for a, b in bands[:-1])
        for band in bands:
            start, stop = M.band_slice(band, h)
            assert start % stride == 0 and 0 <= start < stop <= h
            for r in range(*band):
                assert start == 0 or 8 * r - 66 >= start
                assert stop == h or 8 * r + 73 < stop
            if band[1] == rows:
                assert stop == h


def _narrow_trunk(seed, cin=3, width=4):
    """The 13-conv trunk at a narrow width (trunk_apply reads shapes from
    the weights)."""
    gen = torch.Generator().manual_seed(seed)
    params, c = {}, cin
    for name, _, _ in vgg.VGG_LAYERS:
        m = torch.nn.Conv2d(c, width, 3)
        with torch.no_grad():
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.5)
            m.bias.copy_(torch.randn(width, generator=gen) * 0.1)
        params[name] = m
        c = width
    return torch.nn.ModuleDict(params)


@pytest.mark.parametrize("h", [81, 97, 160])
def test_band_features_equal_the_whole_frame(h):
    params = _narrow_trunk(h)
    x = torch.rand((1, h, 24, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = vgg.trunk_apply(params, x)
        for n in (2, 3, 4):
            got = torch.cat([M.band_trunk(params, x, band) for band in
                             M.row_bands(M.feature_rows(h), n)], 1)
            assert got.shape == whole.shape
            torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)
    # a halo of 48 rows (< 66) changes the band's rows
    r0, r1 = M.row_bands(M.feature_rows(h), 2)[1]
    if 8 * r0 - 66 <= 0:       # the whole frame starts inside the halo
        return
    with torch.no_grad():
        y = vgg.trunk_apply(params, x[:, 8 * r0 - 48:])
    assert not torch.allclose(y[:, 6:6 + r1 - r0], whole[:, r0:r1],
                              rtol=1e-5, atol=1e-5)


def test_spawn_raises_when_a_rank_fails():
    """An empty spec has no seed: every rank raises, and spawn raises with
    the traceback of the rank it finds failed first."""
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed(.|\n)*"
                       "KeyError: 'seed'"):
        D.spawn(D.run_checks, 2, {}, backend="gloo", device="cpu",
                timeout=120)
