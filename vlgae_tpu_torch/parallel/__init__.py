"""Data and tensor parallelism over processes (counterpart of
vlgae_tpu/parallel): one process per device under ``torchrun``, the batch
split by rows, the gradients summed, FSDP2 for ``trainer.fsdp``, and the
model axis of ``trainer.model_parallel``."""

from .mesh import (DEFAULT_MODEL_RULES, DataGroup, ModelGroup, all_reduce_grads,
                   copy_to_model, data_parallel_mesh, fsdp_leaf_spec, full_state_dict,
                   gather_from_model, gather_predictions, gather_rows, global_max, global_sum,
                   init_distributed, load_full_state_dict, log_softmax_across, merge_outputs,
                   pad_batch_to_devices, param_spec, reduce_from_model, replicate,
                   shard_batch, shard_params, split_mesh, sum_across, sum_across_processes,
                   tensor_parallel)

__all__ = [
    "DEFAULT_MODEL_RULES", "DataGroup", "ModelGroup", "all_reduce_grads", "copy_to_model",
    "data_parallel_mesh", "fsdp_leaf_spec", "full_state_dict", "gather_from_model",
    "gather_predictions", "gather_rows", "global_max", "global_sum", "init_distributed",
    "load_full_state_dict", "log_softmax_across", "merge_outputs", "pad_batch_to_devices",
    "param_spec", "reduce_from_model", "replicate", "shard_batch", "shard_params",
    "split_mesh", "sum_across", "sum_across_processes", "tensor_parallel",
]
