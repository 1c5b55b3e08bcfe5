"""The frozen generators give the port's bits at small sizes."""

import numpy as np
import pytest

import pb_tiny  # noqa: F401
import pb_scenes
from xmtpu_torch.pipeline import synthetic


@pytest.mark.parametrize("name,kw", [
    ("make_scene", dict(n_cameras=30, n_points=100, obs_per_camera=10,
                        noise=0.35, seed=1)),
    ("make_scene", dict(n_cameras=50, n_points=200, obs_per_camera=20,
                        noise=1e-3, seed=7)),
    ("make_scene_window", dict(n_cameras=64, n_points=256,
                               obs_per_camera=16, noise=1e-3, seed=3,
                               long_range=4)),
])
def test_frozen_generator_matches_the_port(name, kw):
    ours = pb_scenes.GENERATORS[name](**kw)
    port = getattr(synthetic, name)(**kw)
    for a, b in zip(ours, port):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


def test_seed_sequence_seeds_are_repeatable():
    seq = np.random.SeedSequence([2**31 + 99, 3])
    a = pb_scenes.make_scene(20, 60, 8, 0.1, seed=seq)
    b = pb_scenes.make_scene(20, 60, 8, 0.1,
                             seed=np.random.SeedSequence([2**31 + 99, 3]))
    assert np.array_equal(a.landmarks, b.landmarks)
