"""All bases of all steps completed in the window, over the whole window's
wall (the last step closes the window), in GB/s."""

from benchmark.readers import window_gbps as read  # noqa: F401
