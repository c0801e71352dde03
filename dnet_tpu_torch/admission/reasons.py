"""Admission reject reasons + deadline stages (leaf module, no imports).

Counterpart of dnet_tpu/admission/reasons.py, the same label sets.
`dnet_tpu_torch.obs` pre-touches one `dnet_admit_rejected_total{reason=}`
series per declared reason and one `dnet_deadline_exceeded_total{stage=}`
series per declared stage.  This lives apart from the controller so obs can import the enums without
pulling the controller (which itself imports obs) into a cycle.
"""

from __future__ import annotations

from typing import Tuple

# Why the admission controller refused a request (HTTP mapping in
# api/http.py: draining -> 503, everything else -> 429, all with
# Retry-After derived from the observed service rate).
REJECT_REASONS: Tuple[str, ...] = (
    "queue_full",     # wait queue at DNET_ADMIT_QUEUE_DEPTH
    "queue_timeout",  # queued longer than DNET_ADMIT_QUEUE_TIMEOUT_S
    "deadline",       # estimated wait exceeds the request deadline
    "draining",       # server is shutting down (SIGTERM drain window)
)

# Where an end-to-end deadline was found expired.  `shard_dequeue` is the
# whole point of riding deadlines in frame headers: the shard drops the
# frame before spending any compute on work nobody is waiting for.
DEADLINE_STAGES: Tuple[str, ...] = (
    "admission",      # expired while waiting in the admission queue
    "api_step",       # the decode loop noticed expiry between steps
    "shard_dequeue",  # shard dropped the frame at compute-queue pickup
    "lane_flush",     # expired lane member shed at batch-frame flush
)
