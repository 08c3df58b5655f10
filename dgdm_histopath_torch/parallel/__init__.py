"""The parallel tiers over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the mesh and its collectives, data parallelism
and the explicit-collective step, tensor parallelism over ``model``, expert
parallelism over ``expert``, node sharding with the (differentiable) halo
exchange and the model over node-sharded inputs, forward and training
(``sp_forward``, ``sp_pretrain_step``; the trainer's
``training_step(block, epoch, prepared=True, plan=plan)``), the GPipe
encoder over ``pipe``, and the multichip dry run."""

from .dryrun import dryrun_multichip
from .ep import EXPERT_AXIS, count_expert_sharded, ep_param_specs, ep_size, place_experts
from .halo import (
    HaloPlan,
    build_halo_plan,
    halo_fraction,
    halo_gather,
    permute_graph,
    sp_graph_conv,
    spatial_permutation,
    spatial_sort,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Axis,
    Mesh,
    all_gather,
    all_reduce,
    all_to_all,
    make_mesh,
    pad_batch_to_devices,
    replicate_tree,
    shard_batch,
)
from .pp import (
    PIPE_AXIS,
    make_pp_layers_fn,
    pipe_size,
    pp_bubble_fraction,
    pp_graph_encoder_apply,
    stack_layer_params,
    unstack_layer_params,
)
from .sp import (constrain_nodes, level_sizes, node_sharding, shard_graph_nodes, sp_forward,
                 sp_pretrain_step)
from .spmd_step import hierarchical_pmean, make_spmd_train_step
from .tp import describe_sharding, place_state_tp, shard_tree_like, tp_param_specs, tp_size

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Axis", "HaloPlan",
           "Mesh", "all_gather", "all_reduce", "all_to_all", "build_halo_plan",
           "constrain_nodes", "count_expert_sharded", "describe_sharding",
           "dryrun_multichip", "ep_param_specs", "ep_size", "halo_fraction",
           "halo_gather", "hierarchical_pmean", "level_sizes", "make_mesh",
           "make_pp_layers_fn", "make_spmd_train_step", "node_sharding",
           "pad_batch_to_devices", "permute_graph", "pipe_size", "place_experts",
           "place_state_tp", "pp_bubble_fraction", "pp_graph_encoder_apply",
           "replicate_tree", "shard_batch", "shard_graph_nodes", "shard_tree_like",
           "sp_forward", "sp_graph_conv", "sp_pretrain_step", "spatial_permutation",
           "spatial_sort",
           "stack_layer_params", "tp_param_specs", "tp_size", "unstack_layer_params"]
