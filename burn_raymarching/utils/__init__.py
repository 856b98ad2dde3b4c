from burn_raymarching.utils.padding import bucket_size  # noqa: F401
