from .bptt import BPTT, BPTTState
from .lr_scheduler import transfer_schedule

ALGO_ALIASES = {"bptt": BPTT}

__all__ = ["BPTT", "BPTTState", "transfer_schedule", "ALGO_ALIASES"]
