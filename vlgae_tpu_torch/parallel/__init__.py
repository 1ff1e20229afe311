"""Data parallelism over processes (counterpart of vlgae_tpu/parallel):
one process per device under ``torchrun``, the batch split by rows, the
gradients summed, FSDP2 for ``trainer.fsdp``."""

from .mesh import (DataGroup, all_reduce_grads, data_parallel_mesh, fsdp_leaf_spec,
                   full_state_dict, gather_predictions, gather_rows, global_max, global_sum,
                   init_distributed, load_full_state_dict, log_softmax_across, merge_outputs,
                   pad_batch_to_devices, replicate, shard_batch, shard_params, sum_across,
                   sum_across_processes)

__all__ = [
    "DataGroup", "all_reduce_grads", "data_parallel_mesh", "fsdp_leaf_spec",
    "full_state_dict", "gather_predictions", "gather_rows", "global_max", "global_sum",
    "init_distributed", "load_full_state_dict", "log_softmax_across", "merge_outputs",
    "pad_batch_to_devices", "replicate", "shard_batch", "shard_params", "sum_across",
    "sum_across_processes",
]
