"""ctypes bindings for the native C++ host components (see native/*.cpp).

The shared library is built on demand with g++ and cached next to the
source; everything degrades gracefully to the NumPy implementations when a
toolchain is unavailable (``is_available()``).
"""

from burn_raymarching.native.lib import (  # noqa: F401
    camera_rays_native,
    is_available,
    prune_and_split_native,
)
