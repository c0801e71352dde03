"""Admission control: bounded queueing, load shedding, deadlines, drain.

Counterpart of dnet_tpu/admission/: `controller.AdmissionController` is the
serving path's front door, `reasons` declares the reject-reason and
deadline-stage label sets.  This ``__init__`` stays import-free, as the
reference's: the metrics registry's core registration imports ``reasons``,
and an eager ``controller`` import here would re-enter the registry through
its module-level `metric()` handles.
"""

__all__ = ["controller", "reasons"]
