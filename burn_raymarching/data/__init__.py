from burn_raymarching.data.camera import create_camera_rays  # noqa: F401
from burn_raymarching.data.image_io import (  # noqa: F401
    load_image_as_array,
    save_array_as_image,
)
from burn_raymarching.data.dataset import RayDataset  # noqa: F401
