"""The frozen traffic generator is seeded: one seed, the same frames."""
import numpy as np
import pytest

from shedbench_tiny import BENCH, tiny  # noqa: F401

import torch

from shedharness.inputs import make_inputs
from shedharness.render import render_clips
from yardstick.traffic import generate_scenario


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3 * 2**40])
def test_one_seed_gives_the_same_frames_twice(seed):
    a = generate_scenario(np.random.SeedSequence([seed, 1, 0]), num_frames=6,
                          height=18, width=32, vehicle_rate=0.12)
    b = generate_scenario(np.random.SeedSequence([seed, 1, 0]), num_frames=6,
                          height=18, width=32, vehicle_rate=0.12)
    assert np.array_equal(a.frames_rgb(), b.frames_rgb())
    assert a.frames_rgb().dtype == np.uint8


def test_every_seed_serves_the_same_clips_in_another_order():
    spec = tiny("shed_c128_t8")
    a, la = render_clips(spec.config, spec.traffic)
    b, lb = render_clips(spec.config, spec.traffic)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a[0], a[1])
    def first(s):      # the clip the seed deals to camera 0
        return np.random.default_rng(np.random.SeedSequence([s, 4])).permutation(2)[0]
    seeds = [next(s for s in range(50) if first(s) == k) for k in (0, 1)]
    p, q = (make_inputs(spec.config, spec.traffic, s, "cpu") for s in seeds)
    x, y = (torch.stack(i.pool).transpose(0, 1) for i in (p, q))
    assert not torch.equal(x, y)
    assert sorted(map(bytes, x.numpy())) == sorted(map(bytes, y.numpy()))


def test_worker_processes_render_the_same_library():
    spec = tiny("cascade_c128_t8")
    a, la = render_clips(spec.config, spec.traffic, workers=1)
    b, lb = render_clips(spec.config, spec.traffic, workers=2)
    assert a.dtype == b.dtype == np.uint8
    assert np.array_equal(a, b) and np.array_equal(la, lb)
