from .volume import Volume, make_volume  # noqa: F401
from .nifti import load_nifti, parse_header, NiftiHeader  # noqa: F401
from . import synthetic  # noqa: F401
from .vvi import VviProperties, load_vvi, parse_vvi  # noqa: F401
