from . import dist_ba  # noqa: F401
