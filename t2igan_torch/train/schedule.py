"""The one-cycle cosine learning-rate schedule of the DAMSM optimizer
(``optax.cosine_onecycle_schedule``, which the JAX package uses).

It is not ``torch.optim.lr_scheduler.OneCycleLR``: that one ends its
warm-up at the float step ``pct_start * T - 1``, its last step is
``T - 1``, and it clamps differently.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_onecycle(transition_steps: int, peak: float,
                    pct_start: float = 0.3, div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``count -> lr``: ``peak / div_factor`` at step 0, rising to ``peak``
    at the integer step ``int(pct_start * T)``, falling to
    ``peak / (div_factor * final_div_factor)`` at ``T`` and staying there;
    between two boundaries ``end + (start - end) / 2 * (cos(pi * frac) +
    1)``.  The values are optax's, ``cumprod([peak / div_factor,
    div_factor, 1 / (div_factor * final_div_factor)])``, in float64.

    When ``int(pct_start * T)`` is 0 the warm-up is empty and the schedule
    starts at ``peak``.  optax returns NaN at every step there (its sum
    over the segments takes 0 * NaN from the empty one)."""
    if transition_steps <= 0:
        raise ValueError(f"transition_steps must be positive, got "
                         f"{transition_steps}")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    v0 = peak / div_factor
    v1 = v0 * div_factor
    values = (v0, v1, v1 * (1.0 / (div_factor * final_div_factor)))

    def schedule(count: int) -> float:
        if count < 0:
            raise ValueError(f"step count must be >= 0, got {count}")
        if count >= bounds[2]:
            return values[2]
        k = 0 if count < bounds[1] else 1
        frac = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
        start, end = values[k], values[k + 1]
        return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1)

    return schedule
