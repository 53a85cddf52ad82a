"""Seeded synthetic frame pairs with a known flow.

One generator shared by ``chip_smoke.py``, ``bench.py``, the tools, the
examples and the tests, so every caller gates on the same input.

``seeded_pair(w, h, seed)`` returns two ``uint8`` frames and the true
forward flow. Frame 0 is multi-octave value noise: a seeded integer grid
per octave, interpolated with the C1 smoothstep. Frame 1 samples the same
continuous texture at ``p - w(p)``, where ``w`` is a smooth analytic
motion (translation, rotation and a central bump, a few pixels at most).
The true forward flow ``u(x)`` therefore solves ``u = w(x + u)``; it is
found by fixed-point iteration.

Only IEEE-exact float64 operations (+, -, *, /, floor) and PCG64 draws are
used, so the frames are bit-identical on every machine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# (grid spacing in pixels, amplitude) per octave, coarse to fine.
_OCTAVES = ((32.0, 1.0), (16.0, 0.55), (8.0, 0.3), (4.0, 0.18))
_AMP_TOTAL = sum(a for _, a in _OCTAVES)


def _smoothstep(t: np.ndarray) -> np.ndarray:
    return t * t * (3.0 - 2.0 * t)


def _value_noise(grid: np.ndarray, x: np.ndarray, y: np.ndarray,
                 spacing: float) -> np.ndarray:
    """Smoothstep-interpolated lattice noise at continuous (x, y)."""
    gx = x / spacing
    gy = y / spacing
    x0 = np.floor(gx)
    y0 = np.floor(gy)
    tx = _smoothstep(gx - x0)
    ty = _smoothstep(gy - y0)
    gh, gw = grid.shape
    # The lattice has a 2-cell margin on every side; wrap beyond it (only
    # reached by samples far outside the frame).
    xi = (x0.astype(np.int64) + 2) % (gw - 1)
    yi = (y0.astype(np.int64) + 2) % (gh - 1)
    g00 = grid[yi, xi]
    g01 = grid[yi, xi + 1]
    g10 = grid[yi + 1, xi]
    g11 = grid[yi + 1, xi + 1]
    top = g00 + (g01 - g00) * tx
    bot = g10 + (g11 - g10) * tx
    return top + (bot - top) * ty


class _Scene:
    """The continuous texture and motion for one (w, h, seed)."""

    def __init__(self, w: int, h: int, seed: int):
        rng = np.random.default_rng(seed)
        self.w, self.h = w, h
        self.grids = []
        for spacing, _ in _OCTAVES:
            gw = int(w // spacing) + 6
            gh = int(h // spacing) + 6
            # Integer lattice values in [0, 255], exact in float64.
            self.grids.append(
                rng.integers(0, 256, size=(gh, gw)).astype(np.float64))
        m = rng.integers(0, 1 << 16, size=5).astype(np.float64) / 65536.0
        self.tx = 0.8 + 0.8 * m[0]          # px
        self.ty = -(0.4 + 0.8 * m[1])       # px
        self.rot = 1.0 + 1.0 * m[2]         # px at the frame's half-extent
        self.bump_u = 0.6 + 0.8 * m[3]      # px at the centre
        self.bump_v = 0.3 + 0.5 * m[4]

    def texture(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        acc = np.zeros(np.broadcast(x, y).shape, np.float64)
        for grid, (spacing, amp) in zip(self.grids, _OCTAVES):
            acc += amp * _value_noise(grid, x, y, spacing)
        return acc / _AMP_TOTAL  # in [0, 255]

    def motion(self, x: np.ndarray, y: np.ndarray):
        s = float(max(self.w, self.h))
        xn = (x - 0.5 * self.w) / s
        yn = (y - 0.5 * self.h) / s
        bump = 1.0 / (1.0 + 16.0 * (xn * xn + yn * yn))
        wu = self.tx - 2.0 * self.rot * yn + self.bump_u * bump
        wv = self.ty + 2.0 * self.rot * xn + self.bump_v * bump
        return wu, wv


def _quantize(a: np.ndarray) -> np.ndarray:
    # Stretch the noise's compressed histogram, then round half up.
    b = (a - 127.5) * 2.2 + 127.5
    return np.clip(np.floor(b + 0.5), 0.0, 255.0).astype(np.uint8)


def seeded_pair(w: int, h: int, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(frame_0, frame_1, u_true, v_true): two (h, w) uint8 frames and the
    (h, w) float32 true forward flow from frame 0 to frame 1."""
    scene = _Scene(w, h, seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    f0 = _quantize(scene.texture(xs, ys))
    wu, wv = scene.motion(xs, ys)
    f1 = _quantize(scene.texture(xs - wu, ys - wv))
    # True forward flow: frame-0 pixel x lands at p = x + u with
    # p - w(p) = x, i.e. u = w(x + u).
    u, v = wu, wv
    for _ in range(8):
        u, v = scene.motion(xs + u, ys + v)
    return f0, f1, u.astype(np.float32), v.astype(np.float32)


def seeded_batch(n: int, w: int, h: int, seed: int = 0):
    """(F0, F1, U, V) stacks of ``n`` independent pairs, seeds seed..seed+n-1."""
    pairs = [seeded_pair(w, h, seed + i) for i in range(n)]
    return tuple(np.stack([p[k] for p in pairs]) for k in range(4))


# ---------------------------------------------------------------------------
# Committed oracle goldens of the seeded pair (tools/regen_oracle_golden.py)
# ---------------------------------------------------------------------------

# Reduced schedule of the per-constancy goldens: deep enough to exercise
# the pyramid, warp, medians and all sweep math, small enough that the
# NumPy oracle runs in seconds.
SMALL_SCHEDULE = dict(
    warp_levels_count=8, warp_scale_factor=0.7,
    outer_iterations_count=10, inner_iterations_count=5,
    equation_alpha=35.0, median_radius=5, gaussian_sigma=1.5,
)

GOLDEN_SHAPE = (388, 584)  # (h, w): the reference's default frame shape
GOLDEN_SEED = 0


def golden_path(name: str) -> str:
    """data/oracle_seeded_<name>.npz, name in {default, grey_small,
    gradient_small, log_small}."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, "data", f"oracle_seeded_{name}.npz")


def frames_digest(f0: np.ndarray, f1: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(f0.tobytes() + f1.tobytes()).hexdigest()


def load_golden(name: str, f0: np.ndarray, f1: np.ndarray,
                schedule: dict | None = None):
    """(u, v) of a committed golden, after checking it was made from these
    exact frames and (when given) this schedule."""
    g = np.load(golden_path(name), allow_pickle=False)
    if str(g["frames_sha256"]) != frames_digest(f0, f1):
        raise ValueError(f"golden {name} was made from other frames")
    if schedule is not None:
        want = sorted((k, repr(v)) for k, v in schedule.items())
        got = sorted((str(k), str(v)) for k, v in g["schedule"])
        if want != got:
            raise ValueError(f"golden {name} schedule {got} != {want}")
    return g["u"], g["v"]
