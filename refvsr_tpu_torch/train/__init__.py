"""Training: the learning-rate schedules and the sliding-window trainer."""
