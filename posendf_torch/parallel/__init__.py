from posendf_torch.parallel.halo import adjacent_difference_sharded, temporal_loss_sharded
from posendf_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_object,
    gather_rows,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
    shard_rows,
    sum_across,
)

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_rows", "shard_batch", "replicated",
           "all_reduce_sum", "all_reduce_mean", "gather_rows", "sum_across", "barrier",
           "broadcast_object", "adjacent_difference_sharded", "temporal_loss_sharded"]
