from .tracking import Tracker  # noqa: F401
