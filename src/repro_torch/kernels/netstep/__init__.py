from .ops import netstep  # noqa: F401
from .ref import netstep_ref  # noqa: F401
