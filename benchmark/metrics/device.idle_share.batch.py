"""The device's idle share of the traced window: 100 x (1 - the union of
its kernels', copies' and sets' intervals / the window), in %."""

from benchmark.readers import idle_share as read  # noqa: F401
