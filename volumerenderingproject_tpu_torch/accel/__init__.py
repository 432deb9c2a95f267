from .pyramid import MinMaxPyramid, build_pyramid, leaf_grid  # noqa: F401
