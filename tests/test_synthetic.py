"""The seeded frame-pair generator and the goldens made from it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpuflow import synthetic as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(388, 584), (97, 131), (40, 48)])
def test_seeded_pair_shapes_and_dtypes(shape):
    h, w = shape
    f0, f1, u, v = S.seeded_pair(w, h, 3)
    assert f0.shape == f1.shape == u.shape == v.shape == (h, w)
    assert f0.dtype == np.uint8 and f1.dtype == np.uint8
    assert u.dtype == np.float32 and v.dtype == np.float32
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_seeded_pair_is_deterministic_and_seeded():
    a = S.seeded_pair(131, 97, 7)
    b = S.seeded_pair(131, 97, 7)
    c = S.seeded_pair(131, 97, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_seeded_pair_digest_is_pinned():
    # The committed goldens were made from exactly these bytes.
    f0, f1, _, _ = S.seeded_pair(584, 388, 0)
    g = np.load(S.golden_path("default"))
    assert str(g["frames_sha256"]) == S.frames_digest(f0, f1)


def test_seeded_pair_is_textured():
    f0, f1, _, _ = S.seeded_pair(584, 388, 0)
    assert f0.std() > 40 and f1.std() > 40
    assert len(np.unique(f0)) > 200
    # Neighbouring pixels differ: there is texture to track everywhere.
    assert np.abs(np.diff(f0.astype(np.float32), axis=1)).mean() > 2.0


def test_true_flow_is_the_warp_fixed_point():
    """u = w(x + u): frame 1 sampled at x + u reproduces frame 0's texture
    (exact before quantization)."""
    w, h, seed = 131, 97, 5
    scene = S._Scene(w, h, seed)
    _, _, u, v = S.seeded_pair(w, h, seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    px, py = xs + u, ys + v
    wu, wv = scene.motion(px, py)
    f1_at = scene.texture(px - wu, py - wv)
    f0 = scene.texture(xs, ys)
    assert np.abs(f1_at - f0).max() < 1e-3
    mag = np.hypot(u, v)
    assert 0.3 < mag.mean() and mag.max() < 6.0


def test_seeded_batch_stacks_consecutive_seeds():
    F0, F1, U, V = S.seeded_batch(3, 48, 40, seed=10)
    assert F0.shape == (3, 40, 48) and U.shape == (3, 40, 48)
    np.testing.assert_array_equal(F0[2], S.seeded_pair(48, 40, 12)[0])


@pytest.mark.parametrize("name", ["default", "grey_small", "gradient_small",
                                  "log_small"])
def test_goldens_match_their_frames_and_schedule(name):
    f0, f1, _, _ = S.seeded_pair(584, 388, S.GOLDEN_SEED)
    sched = S.SMALL_SCHEDULE if name.endswith("_small") else None
    u, v = S.load_golden(name, f0, f1, sched)
    assert u.shape == (388, 584) and np.isfinite(u).all()


def test_load_golden_refuses_other_frames_or_schedule():
    f0, f1, _, _ = S.seeded_pair(584, 388, S.GOLDEN_SEED)
    with pytest.raises(ValueError, match="other frames"):
        S.load_golden("grey_small", f1, f0)
    wrong = dict(S.SMALL_SCHEDULE, outer_iterations_count=11)
    with pytest.raises(ValueError, match="schedule"):
        S.load_golden("grey_small", f0, f1, wrong)


def test_generator_bytes_do_not_depend_on_platform_math():
    # Only IEEE-exact operations: the frames come out the same when numpy
    # is asked to use float64 everywhere in a fresh process.
    code = ("from tpuflow.synthetic import seeded_pair, frames_digest;"
            "f0,f1,_,_=seeded_pair(131,97,2);print(frames_digest(f0,f1))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    f0, f1, _, _ = S.seeded_pair(131, 97, 2)
    assert out.stdout.strip() == S.frames_digest(f0, f1)
