from burn_raymarching.render.diff import render_diff  # noqa: F401
from burn_raymarching.render.gt import render_gt  # noqa: F401
