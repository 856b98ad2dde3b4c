from burn_raymarching.models.scene import (  # noqa: F401
    SceneParams,
    activate,
    init_scene_params,
    scene_forward,
    pad_params,
)
