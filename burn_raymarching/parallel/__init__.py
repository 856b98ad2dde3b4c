from burn_raymarching.parallel.mesh import make_mesh  # noqa: F401
from burn_raymarching.parallel.train_step import (  # noqa: F401
    make_sharded_train_step,
)
