from gpupathtracer_tpu_torch.parallel.mesh import (
    make_device_mesh, render_sample_mega_sharded, render_sample_sharded)
from gpupathtracer_tpu_torch.parallel.partition import (
    shard_partition, trace_closest_partitioned)

__all__ = ["make_device_mesh", "render_sample_sharded",
           "render_sample_mega_sharded",
           "shard_partition", "trace_closest_partitioned"]
