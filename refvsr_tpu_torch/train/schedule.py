"""Learning-rate schedules as plain functions of the optimizer step;
counterpart of ``refvsr_tpu/train/schedule.py`` (the reference's
trainers/lr_scheduler.py), stepped once per optimizer step from 0.

CosineAnnealingLR_Restart in closed form: step 0 gives lr_init; at step
s >= 1 with i the number of (restart + 1) values <= s,

    t   = s - start_i,  T = T_period[i]
    amp = base_i if t <= T else lr_init
    lr  = eta_min + (amp - eta_min) * (1 + cos(pi * t / T)) / 2

Past a segment's end the reference continues the cosine periodically and
rebuilds the amplitude from the UNWEIGHTED lr_init, not the restart-weighted
base; the quirk is kept."""

from __future__ import annotations

import math


def cosine_annealing_restart(lr_init: float, eta_min: float, period,
                             restarts=(), restart_weights=()):
    """General multi-restart cosine (lr_scheduler.py:51-91). `restarts` are
    the raw config values (the +1 offset is applied here); `period` is the
    T_period list (len(restarts) + 1 entries) or one value for every
    segment."""
    rs = [float(r) + 1.0 for r in restarts]
    ws = [float(w) for w in restart_weights] or [1.0] * len(rs)
    if len(rs) != len(ws):
        raise ValueError("restarts and their weights do not match "
                         f"({len(rs)} vs {len(ws)})")
    if isinstance(period, (list, tuple)):
        periods = [float(p) for p in period]
        if len(periods) != len(rs) + 1:
            raise ValueError(f"T_period needs len(restarts)+1 = "
                             f"{len(rs) + 1} entries, got {len(periods)}")
    else:
        periods = [float(period)] * (len(rs) + 1)
    if any(rs[i] >= rs[i + 1] for i in range(len(rs) - 1)):
        raise ValueError(f"restarts must be strictly increasing: {restarts}")
    starts = [0.0] + rs
    bases = [lr_init] + [lr_init * w for w in ws]

    def schedule(step) -> float:
        step = float(step)
        if step < 1.0:
            return float(lr_init)
        i = sum(step >= r for r in rs)
        t = step - starts[i]
        amp = bases[i] if t <= periods[i] else lr_init
        return eta_min + (amp - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t / periods[i]))

    return schedule


def lr_decay(lr_init: float, decay_period, decay_rate: float):
    """Step decay (lr_scheduler.py:93-120): lr_init * rate ** (number of
    periods passed)."""
    periods = [float(p) for p in decay_period]

    def schedule(step) -> float:
        return lr_init * decay_rate ** sum(float(step) > p for p in periods)

    return schedule


def from_config(config):
    if config.LRS == "CA":
        return cosine_annealing_restart(config.lr_init, config.lr_min,
                                        config.total_itr, restarts=[0],
                                        restart_weights=[1.0])
    if config.LRS == "LD":
        return lr_decay(config.lr_init, config.decay_period,
                        config.decay_rate)
    return lambda step: float(config.lr_init)
