"""Small value types shared across the package (counterpart of
``visfly_tpu/core/types.py``)."""
from __future__ import annotations

import enum
from typing import NamedTuple, Union

from torch import Tensor


class ActionType(enum.IntEnum):
    """Control modes."""

    THRUST = 0
    BODYRATE = 1
    VELOCITY = 2
    POSITION = 3


ACTION_TYPE_ALIAS = {
    "thrust": ActionType.THRUST,
    "bodyrate": ActionType.BODYRATE,
    "velocity": ActionType.VELOCITY,
    "position": ActionType.POSITION,
}


class Bound(NamedTuple):
    """Closed interval."""

    min: Union[float, Tensor]
    max: Union[float, Tensor]
