from .loop import Trainer  # noqa: F401
