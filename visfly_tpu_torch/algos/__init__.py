from .apg import APG, APGState
from .bptt import BPTT, BPTTState
from .lr_scheduler import transfer_schedule
from .ppo import PPO, PPOState
from .returns import compute_gae, compute_td_returns
from .sac import SAC, SACState
from .shac import SHAC, SHACState

ALGO_ALIASES = {
    "bptt": BPTT,
    "shac": SHAC,
    "ppo": PPO,
    "sac": SAC,
    "apg": APG,
}

__all__ = [
    "BPTT", "BPTTState",
    "SHAC", "SHACState",
    "PPO", "PPOState",
    "SAC", "SACState",
    "APG", "APGState",
    "compute_td_returns", "compute_gae",
    "transfer_schedule",
    "ALGO_ALIASES",
]
