"""Runtime supervision of the port: the train loop's restart supervisor,
the straggler monitor that the train loop and ``serve.decode.generate``
feed, the heartbeat, and the drainable background worker of the serving
plan cache's refinement; and the spans and counters that say which code
owns a step's time (:mod:`repro_torch.runtime.spans`)."""

from .supervisor import (BackgroundWorker, Heartbeat, RestartPolicy,
                         StragglerMonitor, Supervisor)

__all__ = ["BackgroundWorker", "Heartbeat", "RestartPolicy",
           "StragglerMonitor", "Supervisor"]
