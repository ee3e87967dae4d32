from . import trace  # noqa: F401
from .tracking import Tracker  # noqa: F401
