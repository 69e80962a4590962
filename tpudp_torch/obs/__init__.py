"""Observability for the port: so far the reference-format log lines."""

from tpudp_torch.obs.format import reference_window_lines  # noqa: F401
