"""Runtime supervision of the port: the straggler monitor that
``serve.decode.generate`` feeds, and the drainable background worker of
the serving plan cache's refinement."""

from .supervisor import BackgroundWorker, StragglerMonitor

__all__ = ["BackgroundWorker", "StragglerMonitor"]
