"""The generators repeat exactly for a seed and differ across seeds."""
import numpy as np
import pytest
import torch

from port_bench.harness import _template, inputs

MIX = {"pan_px": 4, "stereo_disparity_px": 6, "texture_blur_px": 2.0, "depth_m": [1.0, 4.0],
       "depth_blur_px": 24.0}


@pytest.mark.parametrize("stereo,rgbd", [(True, False), (False, True)])
def test_frames_repeat_for_a_seed_and_differ_across_seeds(stereo, rgbd):
    a = inputs.Frames(2 ** 31 + 7, 12, (64, 96), MIX, stereo, rgbd)
    b = inputs.Frames(2 ** 31 + 7, 12, (64, 96), MIX, stereo, rgbd)
    c = inputs.Frames(2 ** 31 + 8, 12, (64, 96), MIX, stereo, rgbd)
    for t in (0, 5, 11):
        assert np.array_equal(a.image(t), b.image(t))
        assert not np.array_equal(a.image(t), c.image(t))
    img = a.image(3)
    assert img.dtype == np.uint8 and img.shape == ((2, 64, 96, 3) if stereo else (64, 96, 3))
    if stereo:        # the right view is the left one 6 px further along the pan
        assert np.array_equal(img[1][:, :-6], img[0][:, 6:])
    assert np.array_equal(a.image(4)[..., :-4, :] if not stereo else a.image(4)[0][:, :-4],
                          (a.image(3)[..., 4:, :] if not stereo else a.image(3)[0][:, 4:]))
    if rgbd:
        d = a.depth_map(2)
        assert d.shape == (64, 96) and 1.0 <= d.min() and d.max() <= 4.0
        assert np.array_equal(d, b.depth_map(2)) and not np.array_equal(d, c.depth_map(2))
    else:
        assert a.depth_map(2) is None
    with pytest.raises(IndexError):
        a.image(12)


def test_weights_repeat_for_a_seed_differ_across_seeds_and_keep_the_bound():
    t = _template()
    a, b, c = (inputs.weights(s, "cpu", t) for s in (2 ** 31 + 3, 2 ** 31 + 3, 5))
    assert list(a) == list(t)
    for k in a:
        assert a[k].shape == t[k].shape and torch.equal(a[k], b[k])
    assert not torch.equal(a["update.gru.convq.weight"], c["update.gru.convq.weight"])
    w = a["fnet.conv1.weight"]      # fan_in 3 * 7 * 7
    assert float(w.abs().max()) <= 1.0 / (3 * 49) ** 0.5
    assert float(a["fnet.conv1.bias"].abs().max()) <= 1.0 / (3 * 49) ** 0.5
