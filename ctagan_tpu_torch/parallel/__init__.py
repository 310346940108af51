"""Whole-series inference and the parallel plan of the port: ``volume``
(batched slice inference, depth windows, spatial tiles), ``serve`` (an SE0
series in, a synthetic SE2 series out), ``mesh`` (the plan a config asks
for; the data-parallel plan), ``fsdp`` (the fsdp plan's sharded state),
``tensor`` (the tp plan's split residual pairs) and ``dist`` (the process
group its ranks join)."""
from ctagan_tpu_torch.parallel.tensor import (
    TpMesh,
    TpResidualBlock,
    copy_to_tp,
    infer_tensor_sharded,
    make_tp_mesh,
    reduce_from_tp,
    reg_param_rules,
    shard_module_tp,
    shard_state_tp,
    tp_param_rules,
)
