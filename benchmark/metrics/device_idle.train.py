"""device_idle.train: the share of the traced stretch in which no kernel or copy ran
on the device, in %."""

from benchmark.metrics.device_idle import read  # noqa: F401
