from burn_raymarching.ops.sdf import (  # noqa: F401
    sphere_sdf,
    smooth_min,
    soft_min,
    direct_sphere_dists,
    pairwise_sphere_dists,
    scene_sdf,
    scene_normal,
)
