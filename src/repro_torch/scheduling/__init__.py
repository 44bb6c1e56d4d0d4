"""Iteration-level scheduling layer (Engine -> Scheduler -> Allocator).

The engine executes :class:`IterationPlan`\\ s; a :class:`Scheduler` policy
composes them from slots/queue/allocator state. See ``base.py`` for the
interface and ``policies.py`` for the shipped policies
(``fcfs`` / ``sarathi`` / ``sjf``).
"""
from repro_torch.scheduling.base import (IterationPlan, PrefillChunk, Scheduler,
                                   SchedulerView, effective_state)
from repro_torch.scheduling.policies import (SCHEDULERS, FCFSScheduler,
                                       SarathiScheduler, SJFScheduler,
                                       make_scheduler)

__all__ = [
    "IterationPlan", "PrefillChunk", "Scheduler", "SchedulerView",
    "effective_state",
    "SCHEDULERS", "FCFSScheduler", "SarathiScheduler", "SJFScheduler",
    "make_scheduler",
]
