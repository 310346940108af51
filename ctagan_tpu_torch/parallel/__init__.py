"""Whole-series inference of the port: ``volume`` (batched slice inference,
depth windows, spatial tiles) and ``serve`` (an SE0 series in, a synthetic
SE2 series out)."""
