"""Whole-series inference and the parallel plan of the port: ``volume``
(batched slice inference, depth windows, spatial tiles), ``serve`` (an SE0
series in, a synthetic SE2 series out), ``mesh`` (the plan a config asks
for; the data-parallel plan), ``fsdp`` (the fsdp plan's sharded state)
and ``dist`` (the process group its ranks join)."""
