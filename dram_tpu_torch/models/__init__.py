from .dc3d_at import DC3DATGeneric  # noqa: F401
from .unet3d import DC3D  # noqa: F401
