"""The semi-supervised train step, its state, schedules and random draws."""
