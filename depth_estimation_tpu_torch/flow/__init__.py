"""Dense flow solvers: Ce Liu's variational solver and the comparison
baseline built on it."""

from . import celiu  # noqa: F401


def get_optical_flow(im1, im2, **kw):
    """Dense-flow comparison baseline (the radial tester's OpenCV Farneback
    slot), served by the variational solver with fast parameters. ``kw``
    overrides them (``device`` included). Returns (vx, vy)."""
    params = dict(alpha=0.02, ratio=0.5, min_width=30,
                  n_outer=2, n_inner=1, n_sor=15)
    params.update(kw)
    vx, vy, _ = celiu.coarse2fine_flow(im1, im2, **params)
    return vx, vy
