from .camera import Camera, default_camera, reset_preset  # noqa: F401
from .materials import Material, MaterialId, get_material  # noqa: F401
from .transfer_function import (  # noqa: F401
    TransferFunction,
    default_transfer_function,
    from_pairs,
    from_text,
    to_text,
)
