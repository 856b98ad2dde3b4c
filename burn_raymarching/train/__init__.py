from burn_raymarching.train.loss import compute_loss  # noqa: F401
from burn_raymarching.train.density import prune_and_split  # noqa: F401
