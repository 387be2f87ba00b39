"""Runtime supervision of the port: the straggler monitor that
``serve.decode.generate`` feeds."""

from .supervisor import StragglerMonitor

__all__ = ["StragglerMonitor"]
