"""The LM substrate's sharding layer on ``torch.distributed``: device meshes
with named axes and the divisibility-aware rules that turn parameter,
optimizer, batch and cache trees into DTensor placements."""
from repro_torch.distributed.meshutil import axis_sizes, dp_axes, make_mesh
from repro_torch.distributed.sharding import (
    batch_specs, cache_specs, param_specs, placements, shard_tree,
)
