"""Whole-series inference and the parallel plan of the port: ``volume``
(batched slice inference, depth windows, spatial tiles), ``serve`` (an SE0
series in, a synthetic SE2 series out), ``mesh`` (the plan a config asks
for; the data-parallel plan), ``fsdp`` (the fsdp plan's sharded state),
``tensor`` (the tp plan's split residual pairs), ``spatial`` and ``halo``
(the sp plan's split rows: its training step's halo convs, its sharded
inference) and ``dist`` (the process group its ranks join)."""
from ctagan_tpu_torch.parallel.halo import infer_spatial_sharded
from ctagan_tpu_torch.parallel.spatial import (
    SpMesh,
    halo_conv,
    halo_resize,
    halo_rows,
    make_sp_mesh,
    shard_state_sp,
)
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
